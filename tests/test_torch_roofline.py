"""PyTorch port, ``launch/roofline.py`` against the reference's.

- For every (arch x shape) cell, the analytic parts equal the
  reference's at rtol 1e-12: ``param_count`` (all and active),
  ``model_flops`` and ``chunk_scan_corrections`` (at 256 chips), each
  config built from its own package and the corrections reading each
  package's own ``QCHUNK``, ``CE_CHUNK`` and ``padded_vocab``.
- ``extrapolate`` and ``roofline_terms`` equal the reference's on the same
  ``CellCost`` once the reference's TPU constants are swapped for the
  port's.
- The constants are NVIDIA's H100 SXM data-sheet figures; the collective
  term divides by one direction of NVLink (450 GB/s of the 900 counted
  both ways).
- ``collective_bytes`` and ``collective_kind`` keep the reference's kind
  names and ``"total"``; ``CostCounter`` counts a product's FLOPs and its
  bytes and scales a loop's work.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS, SHAPES as REF_SHAPES
from repro.configs import get_arch as ref_arch
from repro.launch import roofline as ref_roofline
from repro_torch.configs import ARCHS, SHAPES, get_arch
from repro_torch.launch import roofline

RTOL = 1e-12
CELLS = [(a, c.name) for a in sorted(ARCHS) for c in SHAPES]


def test_the_port_has_the_references_archs_and_cells():
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    assert [(c.name, c.seq_len, c.global_batch, c.kind) for c in SHAPES] \
        == [(c.name, c.seq_len, c.global_batch, c.kind) for c in REF_SHAPES]


@pytest.mark.parametrize("arch, shape", CELLS)
def test_analytic_counts_equal_the_references(arch, shape):
    cfg, rcfg = get_arch(arch), ref_arch(arch)
    cell = next(c for c in SHAPES if c.name == shape)
    rcell = next(c for c in REF_SHAPES if c.name == shape)
    for active in (False, True):
        np.testing.assert_allclose(
            roofline.param_count(cfg, active_only=active),
            ref_roofline.param_count(rcfg, active_only=active), rtol=RTOL)
    np.testing.assert_allclose(roofline.model_flops(cfg, cell),
                               ref_roofline.model_flops(rcfg, rcell),
                               rtol=RTOL)
    got = roofline.chunk_scan_corrections(cfg, cell, 256)
    want = ref_roofline.chunk_scan_corrections(rcfg, rcell, 256)
    assert set(got) == set(want) == {"flops", "bytes"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL)


def _costs():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(3):
        f, b, c = rng.uniform(1e9, 1e15, 3)
        out.append(dict(flops=f, bytes_accessed=b, coll_bytes=c,
                        coll_breakdown={"all-gather": c * 0.75,
                                        "all-reduce": c * 0.25,
                                        "total": c}))
    return out


def _fields(cost):
    return [cost.flops, cost.bytes_accessed, cost.coll_bytes]


@pytest.mark.parametrize("L1, L2, L", [(1, 2, 30), (2, 4, 26), (1, 2, 6.5)])
def test_extrapolate_equals_the_references(L1, L2, L):
    c1, c2 = _costs()[:2]
    got = roofline.extrapolate(roofline.CellCost(**c1),
                               roofline.CellCost(**c2), L1, L2, L)
    want = ref_roofline.extrapolate(ref_roofline.CellCost(**c1),
                                    ref_roofline.CellCost(**c2), L1, L2, L)
    np.testing.assert_allclose(_fields(got), _fields(want), rtol=RTOL)
    assert got.coll_breakdown == pytest.approx(want.coll_breakdown,
                                               rel=RTOL)


@pytest.mark.parametrize("i", range(3))
def test_roofline_terms_equal_the_references_with_the_port_constants(
        i, monkeypatch):
    monkeypatch.setattr(ref_roofline, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(ref_roofline, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(ref_roofline, "ICI_BW", roofline.LINK_BW)
    c = _costs()[i]
    got = roofline.roofline_terms(roofline.CellCost(**c), 256, 3e17)
    want = ref_roofline.roofline_terms(ref_roofline.CellCost(**c), 256, 3e17)
    assert dataclasses.asdict(got) == pytest.approx(
        dataclasses.asdict(want), rel=RTOL)
    assert got.dominant == want.dominant


def test_constants_are_the_h100_sxm_data_sheet():
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.HBM_BYTES == 80e9
    assert roofline.NVLINK_BW == 900e9
    assert roofline.LINK_BW == 450e9
    from repro_torch.launch import dryrun
    assert dryrun.HBM_PER_CHIP == roofline.HBM_BYTES
    assert "data sheet" in roofline.__doc__


@pytest.mark.parametrize("name, kind", [
    ("all_reduce", "all-reduce"), ("allreduce_", "all-reduce"),
    ("all_gather_into_tensor", "all-gather"), ("_allgather_base_",
                                               "all-gather"),
    ("reduce_scatter_tensor", "reduce-scatter"),
    ("all_to_all_single", "all-to-all"), ("alltoall_base_", "all-to-all"),
    ("broadcast", "collective-permute"), ("mm", None), ("wait_tensor", None)])
def test_collective_kinds_are_the_references(name, kind):
    assert roofline.collective_kind(name) == kind
    assert kind is None or kind in roofline.KINDS


def test_collective_bytes_sums_by_kind_with_a_total():
    got = roofline.collective_bytes([("all-gather", 10), ("all-reduce", 4),
                                     ("all-gather", 6)])
    assert got == {"all-gather": 16.0, "all-reduce": 4.0, "total": 20.0}
    assert roofline.collective_bytes([]) == {"total": 0}


def test_the_counter_counts_a_products_flops_and_bytes():
    a, b = torch.ones(64, 32), torch.ones(32, 16)
    with roofline.CostCounter() as counter:
        a @ b
        with counter.scaled(10):
            a @ b
        a.t()                                   # a view moves nothing
    assert counter.flops == 11 * 2 * 64 * 32 * 16
    assert counter.bytes == 11 * 4 * (64 * 32 + 32 * 16 + 64 * 16)
    cost = roofline.cost_of(counter, temp_bytes=5, arg_bytes=7)
    assert (cost.flops, cost.temp_bytes, cost.arg_bytes) == \
        (counter.flops, 5.0, 7.0)
    assert cost.coll_breakdown == {"total": 0}


def test_a_kernel_on_fake_tensors_reports_the_work_of_its_bound():
    # the kernels are custom ops: on fake tensors they launch nothing, and
    # the counter takes their FLOPs from the formulas of their bounds and
    # their bytes from their inputs and output, and keeps their share
    # apart under ``kernels``
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bhsd, kept_pairs)
    from repro_torch.kernels.mlstm_chunk.kernel import mlstm_chunk_bhsd

    BH, S, hd = 6, 256, 64
    with FakeTensorMode():
        q = torch.empty(BH, S, hd, dtype=torch.bfloat16)
        kv = torch.empty(BH // 3, S, hd, dtype=torch.bfloat16)
        m = [torch.empty(2, S, 32), torch.empty(2, S, 32),
             torch.empty(2, S, 33), torch.empty(2, S), torch.empty(2, S)]
        with roofline.CostCounter() as counter, \
                FlopCounterMode(display=False) as plain:
            out = flash_attention_bhsd(q, kv, kv, window=100, group_size=3)
            y = mlstm_chunk_bhsd(*m, chunk=64)
    assert tuple(out.shape) == (BH, S, hd) and tuple(y.shape) == (2, S, 33)
    fa = counter.kernels["flash_attention_bhsd"]
    assert fa["calls"] == 1
    assert fa["flops"] == 4 * BH * hd * kept_pairs(S, True, 100)
    assert fa["bytes"] == 2 * S * hd * (2 * BH + 2 * BH // 3)
    nC = S // 64
    mc = counter.kernels["mlstm_chunk_bhsd"]
    assert mc["flops"] == 2 * (nC * 64 * 65 * (32 + 33)
                               + 2 * (nC - 1) * 2 * 64 * 32 * 33)
    assert mc["bytes"] == 4 * 2 * S * (2 * 32 + 2 * 33 + 2)
    assert counter.cost().flops == fa["flops"] + mc["flops"]
    assert counter.cost().bytes_accessed == fa["bytes"] + mc["bytes"]
    # torch's own flop counter reads the same formulas
    assert plain.get_total_flops() == fa["flops"] + mc["flops"]
