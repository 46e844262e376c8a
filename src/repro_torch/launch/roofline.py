"""Roofline terms of one counted dry-run cell, at H100 SXM figures.

The port of ``repro.launch.roofline``.  Per (arch x shape x mesh) cell the
three terms (seconds a step) are

    compute    = per-device FLOPs / PEAK_FLOPS
    memory     = per-device bytes accessed / HBM_BW
    collective = per-device collective bytes / LINK_BW

The constants are NVIDIA's H100 SXM data-sheet figures (H100 Tensor Core
GPU data sheet, SXM5 column), not measurements: 989 TFLOP/s dense bf16
on the tensor cores (1979 with 2:4 sparsity, which no kernel here uses),
3.35 TB/s of HBM3, 80 GB, and 900 GB/s of NVLink per card.  The 900 GB/s
counts both directions (18 links of 25 GB/s each way); a payload that
leaves one card moves at up to 450 GB/s.  The reference divides each
device's collective bytes (the result buffers of its collectives) by the
rate of one direction of its links, so the port divides by
``LINK_BW = 450e9``.

Where the reference reads XLA's compiled artifacts, the port counts the
run itself.  :class:`CostCounter` is a ``TorchDispatchMode`` that lets
DTensor desugar each op and sees the local ops of rank 0: it adds their
FLOPs (``torch.utils.flop_counter``'s formulas), the bytes each op reads
and writes (every tensor argument and result of a non-view op: eager
PyTorch, without XLA's fusion), and the result bytes of every collective
by kind (:func:`collective_bytes`).  The hand-written kernels are custom
ops (``torch.ops.repro_torch.*``): on fake tensors they launch nothing,
``flop_counter`` counts them by the formula of their bound, and the
counter keeps their share apart under ``kernels``.  The port runs every
layer and every
chunk, so nothing is counted once for many (the reference's scan-body
caveat and its depth :func:`extrapolate` do not arise; both are kept for
the record's arithmetic).  :func:`model_flops` keeps the 6·N·D convention
(6·N_active·D for MoE) plus the exact attention terms.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Iterable, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs.base import ArchConfig, ShapeCell

# H100 SXM data-sheet figures (per card)
PEAK_FLOPS = 989e12          # dense bf16, tensor cores
HBM_BW = 3.35e12             # B/s, HBM3
HBM_BYTES = 80e9             # bytes of HBM3
NVLINK_BW = 900e9            # B/s, both directions together
LINK_BW = NVLINK_BW / 2      # B/s leaving one card: what the term divides by

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def collective_kind(op_name: str):
    """The reference's kind name of a ``c10d_functional`` or ``c10d`` op
    (``all_gather_into_tensor`` -> ``all-gather``), or ``None`` for an op
    that is not a collective."""
    n = op_name.replace("_", "")
    for key, kind in (("allreduce", "all-reduce"),
                      ("allgather", "all-gather"),
                      ("reducescatter", "reduce-scatter"),
                      ("alltoall", "all-to-all"),
                      ("broadcast", "collective-permute"),
                      ("send", "collective-permute"),
                      ("recv", "collective-permute")):
        if key in n:
            return kind
    return None


def collective_bytes(records: Iterable[Tuple[str, float]]
                     ) -> Dict[str, float]:
    """Sum the per-device payload bytes of the collectives a run issued,
    by kind, plus ``"total"``: each record is (kind, bytes of the
    collective's result buffer on this device), as the reference counts
    the result buffer of each collective in the partitioned HLO."""
    out: Dict[str, float] = {}
    for kind, nbytes in records:
        out[kind] = out.get(kind, 0.0) + float(nbytes)
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


@dataclass
class CellCost:
    """Raw per-device costs of one counted run."""
    flops: float
    bytes_accessed: float
    coll_bytes: float
    coll_breakdown: Dict[str, float]
    temp_bytes: float = 0.0
    arg_bytes: float = 0.0


def _tensors(tree) -> List[torch.Tensor]:
    out = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_NO_TRAFFIC = {"empty", "empty_strided", "new_empty", "empty_like",
               "new_empty_strided", "_local_scalar_dense", "wait_tensor",
               "detach", "alias", "lift_fresh", "set_"}


class CostCounter(TorchDispatchMode):
    """Counts one run's per-device work (see the module docstring).

    ``weight`` multiplies what is counted (a loop that the dry run runs
    once for many steps sets it, :meth:`scaled`).  ``kernels`` holds, per
    hand-written kernel, its calls, FLOPs and bytes (a share of the
    totals); :meth:`cost` is the run as a :class:`CellCost`."""

    KERNEL_NAMESPACE = "repro_torch"

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.weight = 1.0
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: List[Tuple[str, float]] = []
        self.kernels: Dict[str, Dict[str, float]] = {}

    @contextlib.contextmanager
    def scaled(self, n: float):
        """Within the block, everything counts ``n`` times."""
        saved, self.weight = self.weight, self.weight * n
        try:
            yield
        finally:
            self.weight = saved

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # let DTensor desugar into local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        kind = collective_kind(name)
        if kind is not None:
            self.collectives.append(
                (kind, self.weight * sum(_nbytes(t) for t in _tensors(out))))
            return out
        packet = func._overloadpacket
        flops = moved = 0.0
        if packet in self.registry:
            flops = self.weight * float(
                self.registry[packet](*args, **kwargs, out_val=out))
        if not func.is_view and name not in _NO_TRAFFIC:
            moved = self.weight * (
                sum(_nbytes(t) for t in _tensors((args, kwargs)))
                + sum(_nbytes(t) for t in _tensors(out)))
        self.flops += flops
        self.bytes += moved
        if func.namespace == self.KERNEL_NAMESPACE:
            k = self.kernels.setdefault(name, {"calls": 0.0, "flops": 0.0,
                                               "bytes": 0.0})
            k["calls"] += self.weight
            k["flops"] += flops
            k["bytes"] += moved
        return out

    def cost(self) -> CellCost:
        coll = collective_bytes(self.collectives)
        return CellCost(flops=self.flops, bytes_accessed=self.bytes,
                        coll_bytes=coll["total"], coll_breakdown=coll)


def cost_of(counter: CostCounter, temp_bytes: float = 0.0,
            arg_bytes: float = 0.0) -> CellCost:
    """The reference's reading of a compiled executable, for the port's
    counted run: FLOPs, bytes accessed and collectives from ``counter``,
    and the memory figures the caller measured."""
    cost = counter.cost()
    cost.temp_bytes = float(temp_bytes)
    cost.arg_bytes = float(arg_bytes)
    return cost


def extrapolate(c1: CellCost, c2: CellCost, L1: int, L2: int,
                L) -> CellCost:
    """Linear depth extrapolation (the reference's, for runs that count a
    layer body once).  Per-layer deltas are clamped >= 0."""
    def ex(a, b):
        return a + (L - L1) / (L2 - L1) * max(b - a, 0.0)

    return CellCost(
        flops=ex(c1.flops, c2.flops),
        bytes_accessed=ex(c1.bytes_accessed, c2.bytes_accessed),
        coll_bytes=ex(c1.coll_bytes, c2.coll_bytes),
        coll_breakdown={k: ex(c1.coll_breakdown.get(k, 0.0),
                              c2.coll_breakdown.get(k, 0.0))
                        for k in set(c1.coll_breakdown) | set(c2.coll_breakdown)},
    )


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops: float            # cluster-wide (per-device x chips)
    useful_ratio: float         # MODEL_FLOPS / counted FLOPs
    roofline_fraction: float    # max-term share vs sum (intensity proxy)

    def row(self):
        return (f"{self.compute_s*1e3:9.2f} {self.memory_s*1e3:9.2f} "
                f"{self.collective_s*1e3:9.2f}  {self.dominant:10s} "
                f"{self.useful_ratio:6.2f}")


def roofline_terms(cost: CellCost, chips: int, model_flops: float) -> Roofline:
    compute = cost.flops / PEAK_FLOPS          # per-device flops / per-card peak
    memory = cost.bytes_accessed / HBM_BW
    coll = cost.coll_bytes / LINK_BW
    terms = {"compute": compute, "memory": memory, "collective": coll}
    dominant = max(terms, key=terms.get)
    hlo_cluster = cost.flops * chips
    useful = model_flops / hlo_cluster if hlo_cluster else 0.0
    total = compute + memory + coll
    frac = terms[dominant] / total if total else 0.0
    return Roofline(compute, memory, coll, dominant, model_flops,
                    hlo_cluster, useful, frac)


def chunk_scan_corrections(cfg: ArchConfig, cell: ShapeCell,
                           chips: int) -> Dict[str, float]:
    """The reference's analytic per-device corrections for inner chunk
    scans whose bodies XLA's cost analysis counts once (attention
    query-block scan, fused-CE chunk scan): the missing (nQ - 1)/nQ share
    of the scan's analytic FLOPs/bytes.  The port counts every chunk it
    runs, so the dry run adds none of this; it reads the port's own
    ``QCHUNK``, ``CE_CHUNK`` and ``padded_vocab``."""
    from ..models.attention import QCHUNK
    from ..models.common import padded_vocab
    from ..models.lm import CE_CHUNK
    S, B = cell.seq_len, cell.global_batch
    out = {"flops": 0.0, "bytes": 0.0}
    if cell.kind == "decode":
        return out                      # decode has no inner chunk scans
    hd = cfg.resolved_head_dim
    train = cell.kind == "train"
    fb = 3.0 if train else 1.0          # fwd+bwd multiplier
    remat = 2.0 if (train and cfg.remat) else 1.0   # chunk body checkpointed
    # attention scores+probs: 4 * H * hd * S^2/2 per example per layer (fwd)
    if S > QCHUNK and S % QCHUNK == 0 and cfg.family != "ssm":
        nq = S // QCHUNK
        layers = cfg.num_layers + (cfg.encoder_layers if cfg.family == "audio" else 0)
        attn = 4.0 * layers * cfg.num_heads * hd * (S * S / 2) * B
        attn = attn * (fb if not train else (fb + (remat - 1)))
        out["flops"] += attn / chips * (1 - 1.0 / nq)
        # score traffic (bf16 write+read) — an HBM upper bound
        out["bytes"] += (2 * 2 * layers * cfg.num_heads * (S * S / 2) * B
                         / chips * (1 - 1.0 / nq))
    # fused-CE chunk scan (train only)
    if train and S > CE_CHUNK and S % CE_CHUNK == 0:
        nce = S // CE_CHUNK
        Vp = padded_vocab(cfg.vocab_size)
        ce = 2.0 * B * S * cfg.d_model * Vp * (fb + (remat - 1))
        out["flops"] += ce / chips * (1 - 1.0 / nce)
        out["bytes"] += 2 * B * S * Vp * 4 / chips * (1 - 1.0 / nce)
    return out


# ------------------------------------------------------------- model FLOPs
def param_count(cfg: ArchConfig, active_only: bool = False) -> float:
    """Analytic parameter count (embedding excluded from the 6ND count)."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    attn = d * cfg.num_heads * hd * 2 + d * cfg.num_kv_heads * hd * 2
    if cfg.family == "moe":
        mo = cfg.moe
        e = mo.top_k if active_only else mo.num_experts
        ffn = 3 * d * mo.d_expert * e
        block = attn + ffn
        n = block * cfg.num_layers
    elif cfg.family == "ssm":
        xc = cfg.xlstm
        di = xc.mlstm_expand * d
        mlstm = d * 2 * di + 2 * di * di + di * 2 * cfg.num_heads + di * d
        slstm = 4 * d * d + d * d
        G = cfg.num_layers // xc.slstm_every
        M = xc.slstm_every - 1
        n = G * (M * mlstm + slstm)
    else:
        ffn = 3 * d * cfg.d_ff
        block = attn + ffn
        if cfg.family == "hybrid":
            ssm = cfg.ssm
            di = ssm.expand * d
            block += d * 2 * di + di * (2 * ssm.state_dim) + di * d
        n = block * cfg.num_layers
        if cfg.family == "audio":
            # encoder layers + decoder cross-attention
            n += cfg.encoder_layers * (attn + ffn) + cfg.num_layers * attn
    return float(n)


def model_flops(cfg: ArchConfig, cell: ShapeCell) -> float:
    """6·N·D (train) / 2·N·D (inference) + exact attention-score terms."""
    N = param_count(cfg, active_only=True)
    S = cell.seq_len
    B = cell.global_batch
    hd = cfg.resolved_head_dim
    if cell.kind == "train":
        tokens = B * S
        base = 6.0 * N * tokens
        attn_sc = 12.0 * cfg.num_layers * cfg.num_heads * hd * S * S / 2 * B
        return base + attn_sc
    if cell.kind == "prefill":
        tokens = B * S
        base = 2.0 * N * tokens
        attn_sc = 4.0 * cfg.num_layers * cfg.num_heads * hd * S * S / 2 * B
        return base + attn_sc
    # decode: one token, attention over the cache
    base = 2.0 * N * B
    attn_sc = 4.0 * cfg.num_layers * cfg.num_heads * hd * S * B
    if cfg.family == "ssm":
        attn_sc = 0.0
    return base + attn_sc
