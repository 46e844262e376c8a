"""Causal GQA flash attention in the head-major layout (the kernel).

Replaces the reference's ``repro.kernels.flash_attention.kernel
.flash_attention_bhsd`` (a Pallas call over ``_fa_kernel``).  One launch of
a hand-written CUDA kernel (``csrc/flash_attention.cu``) computes, for
every query row of every head, softmax attention over the keys that the
causal and sliding-window masks keep, with an online softmax in f32: one
block per (head, 64-row query tile) loops over its kept key tiles.  Query
head ``bh`` reads K/V head ``bh // group_size`` in place.  Any S works
(the ragged edge is masked); hd is 32, 64, 128 or 256; inputs are float32
or bfloat16 and the output has the input dtype.

The dtype picks the route, and each launch is counted in
``FLASH.launches`` and under its route in ``FLASH.route_launches``:
bfloat16 runs both products on the tensor cores (``"tensor_core_bf16"``:
``mma.sync`` with bf16 operands and f32 accumulation, P rounded to bf16);
float32 runs them in exact f32 FMA (``"fma_f32"``).

Dispatch rule: a CUDA tensor launches the kernel (or the call raises); a
CPU tensor runs the plain version (:func:`~.ref.attention_ref`).  Either
raises on inputs that require grad: the kernel has no backward.  The
launch is the custom op ``torch.ops.repro_torch.flash_attention_bhsd``:
on fake tensors (shapes only) it launches nothing and gives an empty
output, and ``torch.utils.flop_counter`` counts it by the formula of the
kernel's bound (:func:`flops`), so a count does not change when the
kernel is redesigned.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from .._cuda import FLASH, refuse_grad, stream_of
from .ref import attention_ref

HEAD_DIMS = (32, 64, 128, 256)
# dtype -> (code of the C interface, route)
_DTYPES = {torch.float32: (0, "fma_f32"),
           torch.bfloat16: (1, "tensor_core_bf16")}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           group_size: int) -> None:
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype}, q is {q.dtype}")
    if q.dim() != 3 or k.dim() != 3 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"q must be [BH, S, hd] and k, v [BHkv, S, hd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    BH, S, hd = q.shape
    if group_size < 1 or tuple(k.shape) != (BH // group_size, S, hd) \
            or BH % group_size:
        raise ValueError(f"k, v must be [{BH} / {group_size}, {S}, {hd}], "
                         f"got {tuple(k.shape)}")


def kept_pairs(S: int, causal: bool = True, window: int = 0) -> int:
    """The (q, k) pairs of one head that the masks keep: row i keeps keys
    ``max(0, i - window + 1) ..`` up to i (causal) or S - 1."""
    hi = S * (S + 1) // 2 if causal else S * S
    cut = max(S - window, 0) if window > 0 else 0
    return hi - cut * (cut + 1) // 2


def flops(BH: int, S: int, hd: int, causal: bool = True,
          window: int = 0) -> int:
    """FLOPs of one call, by the formula of the kernel's bound: 4 hd per
    kept (q, k) pair (q.k and p.v)."""
    return 4 * BH * hd * kept_pairs(S, causal, window)


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0,
                         group_size: int = 1) -> torch.Tensor:
    """q: [BH, S, hd]; k, v: [BHkv, S, hd] with BH = BHkv * group_size.

    Returns [BH, S, hd] in q's dtype.  ``window`` > 0 keeps keys with
    ``k > q - window``; ``softcap`` > 0 applies ``softcap * tanh(s /
    softcap)`` to the scaled scores before masking; fully masked rows
    give 0.
    """
    _check(q, k, v, group_size)
    refuse_grad("flash-attention", (q, k, v))
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    return _launch(q, k, v, causal, window, softcap, group_size)


@torch.library.custom_op("repro_torch::flash_attention_bhsd",
                         mutates_args=())
def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, window: int, softcap: float,
            group_size: int) -> torch.Tensor:
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, group_size=group_size)
    BH, S, hd = q.shape
    if q.dtype not in _DTYPES:
        raise ValueError(f"the kernel takes float32 or bfloat16, got "
                         f"{q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"the kernel takes hd in {HEAD_DIMS}, got {hd}")
    if BH > 65535:
        raise ValueError(f"at most 65535 heads x batch per launch, got {BH}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("q, k and v must start on a 16-byte boundary")
    out = torch.empty_like(q)
    if BH and S:
        code, route = _DTYPES[q.dtype]
        FLASH.call("flash_attention_fwd", q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), out.data_ptr(), BH, S, hd, group_size,
                   int(bool(causal)), int(window), float(softcap), code,
                   stream_of(q))
        FLASH.count(route)
    return out


@_launch.register_fake
def _(q, k, v, causal, window, softcap, group_size):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bhsd)
def _(q_shape, k_shape, v_shape, causal, window, softcap, group_size, *,
      out_shape=None, **kwargs):
    BH, S, hd = q_shape
    return flops(BH, S, hd, causal, window)
