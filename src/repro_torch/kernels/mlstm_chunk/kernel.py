"""Chunked mLSTM / SSD readout in the head-major layout (the kernel).

Replaces the reference's ``repro.kernels.mlstm_chunk.kernel
.mlstm_chunk_bhsd`` (a Pallas call over ``_mlstm_kernel``).  One call of
the hand-written CUDA routine (``csrc/mlstm_chunk.cu``) computes, for every
head, the chunk-local decay-masked readout plus the readout of the f32
``[P, Pv]`` state carried from the chunks before, chunk by chunk, with
every product on the tensor cores at f32 accuracy (bf16 high and low
parts, three products each).  The state does not fit one SM at
xlstm-1.3b's widths (4.2 MB at P 1024, Pv 1025), so it is split by
columns across blocks, each keeping its [32, P] share in registers; the
routine runs four kernels in order (in-chunk cumsum, the operands split
once per chunk, masked score tiles, the column-tiled recurrence), counted
here as one launch, in a scratch buffer whose size the routine reports.
Inputs and output are float32; any S that is a multiple of ``chunk``, any
Pv, P up to 1024 and ``chunk`` up to what one block's shared memory holds
(624): the routine checks that and its grid limits itself and returns an
error, which the call raises.

Dispatch rule: a CUDA tensor launches the kernel (or the call raises); a
CPU tensor runs the plain version (:func:`~.ref.mlstm_ref`).  Either
raises on inputs that require grad: the kernel has no backward.  The
launch is the custom op ``torch.ops.repro_torch.mlstm_chunk_bhsd``: on
fake tensors (shapes only) it launches nothing and gives an empty
output, and ``torch.utils.flop_counter`` counts it by the formula of the
kernel's bound (:func:`flops`).
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from .._cuda import MLSTM, refuse_grad, stream_of
from .ref import mlstm_ref


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           ig: torch.Tensor, la: torch.Tensor, chunk: int) -> None:
    for name, x in (("k", k), ("v", v), ("ig", ig), ("la", la)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if q.dim() != 3 or tuple(k.shape) != tuple(q.shape) or v.dim() != 3 \
            or tuple(v.shape[:2]) != tuple(q.shape[:2]) \
            or tuple(ig.shape) != tuple(q.shape[:2]) \
            or tuple(la.shape) != tuple(q.shape[:2]):
        raise ValueError(
            f"q, k must be [BH, S, P], v [BH, S, Pv] and ig, la [BH, S], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}, "
            f"{tuple(ig.shape)}, {tuple(la.shape)}")
    S = q.shape[1]
    if chunk < 1 or S % chunk:
        raise ValueError(f"S = {S} must be a multiple of chunk = {chunk}")


def flops(BH: int, S: int, P: int, Pv: int, chunk: int) -> int:
    """FLOPs of one call, by the formula of the kernel's bound: per head,
    in every chunk the two masked products over the c(c+1)/2 pairs s <=
    t, c(c+1)(P + Pv); the carried state's readout 2cP Pv in chunks 1..
    and its update 2cP Pv in chunks ..nC-2."""
    nC = S // chunk
    return BH * (nC * chunk * (chunk + 1) * (P + Pv)
                 + 2 * max(nC - 1, 0) * 2 * chunk * P * Pv)


def mlstm_chunk_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     ig: torch.Tensor, la: torch.Tensor, *,
                     chunk: int = 128) -> torch.Tensor:
    """q, k: [BH, S, P]; v: [BH, S, Pv]; ig, la: [BH, S].  Returns
    [BH, S, Pv]: the chunked recurrence with its state carried across the
    S / chunk chunks of each row (float32 on the card)."""
    _check(q, k, v, ig, la, chunk)
    refuse_grad("chunked-mLSTM", (q, k, v, ig, la))
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no mLSTM kernel for device {q.device}")
    return _launch(q, k, v, ig, la, chunk)


@torch.library.custom_op("repro_torch::mlstm_chunk_bhsd", mutates_args=())
def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            ig: torch.Tensor, la: torch.Tensor, chunk: int) -> torch.Tensor:
    if q.device.type == "cpu":
        return mlstm_ref(q, k, v, ig, la)
    BH, S, P = q.shape
    Pv = v.shape[-1]
    tensors = (q, k, v, ig, la)
    if any(x.dtype != torch.float32 for x in tensors):
        raise ValueError(f"the kernel takes float32, got "
                         f"{[str(x.dtype) for x in tensors]}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("q, k, v, ig and la must be contiguous")
    out = torch.empty(BH, S, Pv, dtype=torch.float32, device=q.device)
    if BH and S and P and Pv:
        nbytes = ctypes.c_longlong()
        MLSTM.call("mlstm_chunk_workspace", BH, S, P, chunk,
                   ctypes.addressof(nbytes))
        scratch = torch.empty(nbytes.value, dtype=torch.uint8,
                              device=q.device)
        MLSTM.call("mlstm_chunk_fwd", q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), ig.data_ptr(), la.data_ptr(),
                   out.data_ptr(), scratch.data_ptr(), nbytes.value, BH, S,
                   P, Pv, chunk, stream_of(q))
        MLSTM.count()
    return out


@_launch.register_fake
def _(q, k, v, ig, la, chunk):
    return q.new_empty(q.shape[0], q.shape[1], v.shape[-1])


@register_flop_formula(torch.ops.repro_torch.mlstm_chunk_bhsd)
def _(q_shape, k_shape, v_shape, ig_shape, la_shape, chunk, *,
      out_shape=None, **kwargs):
    BH, S, P = q_shape
    return flops(BH, S, P, v_shape[-1], chunk)
