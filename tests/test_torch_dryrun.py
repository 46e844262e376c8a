"""PyTorch port, the dry run (``launch/dryrun.py``) on a fake process group
of 256 ranks (16 x 16), with no card and no data.

- ``run_cell`` on smoke configs (one per family: dense, moe, vlm, ssm
  here; hybrid and the encoder-decoder in
  ``test_torch_dryrun_families.py``) for train_4k, prefill_32k and
  decode_32k, and on smollm-135m at full width (prefill_32k, through the
  CLI): every cell is ``"ok"``, and its record carries the reference's
  keys, ``memory.fits_16gb_hbm`` renamed ``fits_80gb_hbm``.
- Rank 0's per-device argument bytes (``memory.args_gb``: parameters,
  AdamW state, batch or cache) equal the reference's for the same specs:
  the reference's ``launch.specs.input_specs`` on an abstract 16 x 16 mesh
  (no devices), each leaf's shard shape taken as XLA pads an uneven
  split, ``ceil(dim / parts)`` per split dim.  DTensor gives rank 0 the
  same ``ceil(dim / parts)`` rows (the last ranks fewer or none), so the
  two agree exactly.
- The full-width record's counted FLOPs (``hlo_flops_cluster`` = rank 0's
  count x 256) sit within [1, 3] x the reference's analytic
  ``model_flops``: the port counts the head over the padded vocab (6ND
  leaves out the embedding), and rank 0 computes ceil(9 / 16) = 1 of
  smollm's 9 heads, where an even split would give it 9/16; the flash
  kernel counts the kept (q, k) pairs, which is the convention's S^2/2.
- The record feeds the port's ``perfsim.load_record``,
  ``spec_from_roofline`` and ``simulate_pipeline``.
- A long_500k cell of a full-attention arch is skipped with the
  reference's reason; a cell that raises is ``"FAILED"`` with its
  traceback; one cell on 2 x 16 x 16 (512 ranks) runs without roofline.
"""
import dataclasses
import math

import pytest

from repro_torch.configs import get_arch
from repro_torch.launch import dryrun

FAMILIES = {"dense": "smollm-135m", "moe": "granite-moe-3b-a800m",
            "vlm": "internvl2-1b", "ssm": "xlstm-1.3b"}
KINDS = ("train_4k", "prefill_32k", "decode_32k")

KEYS = {"arch", "shape", "mesh", "status", "chips", "compile_s", "memory",
        "raw_cost", "chunk_scan_correction", "roofline"}
MEMORY = {"temp_gb", "args_gb", "out_gb", "aliased_gb", "per_device_gb",
          "fits_80gb_hbm"}
RAW = {"flops", "bytes_accessed", "collective_bytes", "collectives"}
ROOF = {"compute_s", "memory_s", "collective_s", "dominant", "model_flops",
        "hlo_flops_cluster", "useful_ratio", "dominant_fraction",
        "collectives"}


def smoke_overrides(arch):
    s = get_arch(arch).smoke()
    return {f.name: getattr(s, f.name) for f in dataclasses.fields(s)
            if f.name != "name"}


def reference_args_bytes(arch, shape, smoke):
    """The reference's per-device bytes of the cell's arguments, from its
    own specs on an abstract 16 x 16 mesh; an uneven split padded to
    ceil(dim / parts), as XLA pads it."""
    import jax
    from jax.sharding import AbstractMesh, NamedSharding

    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import get_arch as ref_arch
    from repro.distrib import sharding as ref_sharding
    from repro.launch.specs import input_specs

    try:
        mesh = AbstractMesh((16, 16), ("data", "model"))
    except TypeError:                        # older JAX
        mesh = AbstractMesh((("data", 16), ("model", 16)))
    cfg = ref_arch(arch).smoke() if smoke else ref_arch(arch)
    cell = next(c for c in REF_SHAPES if c.name == shape)
    saved = ref_sharding._TP_DEGREE
    try:
        _, args, in_sh, _, _ = input_specs(cfg, cell, mesh)
    finally:
        ref_sharding.set_tp_degree(saved)
    leaves = jax.tree.leaves(args)
    shardings = jax.tree.leaves(
        in_sh, is_leaf=lambda x: isinstance(x, NamedSharding))
    assert len(leaves) == len(shardings)
    total = 0
    for leaf, sh in zip(leaves, shardings):
        n = leaf.dtype.itemsize
        spec = tuple(sh.spec) + (None,) * (leaf.ndim - len(sh.spec))
        for dim, entry in zip(leaf.shape, spec):
            axes = () if entry is None else (entry,) \
                if isinstance(entry, str) else tuple(entry)
            n *= math.ceil(dim / math.prod(mesh.shape[a] for a in axes))
        total += n
    return total


def check_record(rec, arch, shape):
    assert rec["status"] == "ok", rec.get("traceback", rec)
    assert KEYS <= set(rec)
    assert set(rec["memory"]) == MEMORY
    assert RAW <= set(rec["raw_cost"])
    assert ROOF <= set(rec["roofline"])
    assert "fits_16gb_hbm" not in rec["memory"]
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["chips"]) == \
        (arch, shape, "16x16", 256)
    mem = rec["memory"]
    assert mem["per_device_gb"] == pytest.approx(mem["args_gb"]
                                                 + mem["temp_gb"])
    assert mem["fits_80gb_hbm"] == (mem["per_device_gb"] <= 80.0)
    assert rec["raw_cost"]["flops"] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["chunk_scan_correction"] == {"flops": 0.0, "bytes": 0.0}
    coll = rec["raw_cost"]["collectives"]
    assert coll["total"] == pytest.approx(
        sum(v for k, v in coll.items() if k != "total"))


@pytest.fixture(scope="module")
def records():
    return {(a, s): dryrun.run_cell(a, s, False,
                                    cfg_overrides=smoke_overrides(a))
            for a in FAMILIES.values() for s in KINDS}


@pytest.mark.parametrize("shape", KINDS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_smoke_cells_run_on_the_fake_pod(records, family, shape):
    arch = FAMILIES[family]
    rec = records[(arch, shape)]
    check_record(rec, arch, shape)
    assert rec["memory"]["args_gb"] * 1e9 == pytest.approx(
        reference_args_bytes(arch, shape, smoke=True), rel=1e-12)


def test_the_kernels_and_the_slstm_loop_are_counted(records):
    # prefill: the flash kernel once per layer, the mLSTM kernel once per
    # mLSTM block; the sLSTM loop of the xlstm cells scaled to S steps
    smollm = records[("smollm-135m", "prefill_32k")]["kernels"]
    assert smollm["flash_attention_bhsd"]["calls"] == 2
    xl = records[("xlstm-1.3b", "prefill_32k")]
    assert xl["kernels"]["mlstm_chunk_bhsd"]["calls"] == 1
    assert xl["scaled_loops"]["slstm"]["steps"] == 32768
    train = records[("xlstm-1.3b", "train_4k")]
    assert train["scaled_loops"]["slstm"]["steps"] == 4096
    assert "flash_attention_bhsd" not in records[("smollm-135m",
                                                  "train_4k")]["kernels"]


@pytest.fixture(scope="module")
def full_width(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "smollm-135m", "--shape", "prefill_32k",
                     "--mesh", "pod", "--out", str(out)])
    assert done.value.code == 0
    return out


def test_full_width_smollm_on_the_fake_pod(full_width):
    from repro_torch.perfsim.stepmodel import load_record

    rec = load_record(str(full_width), "smollm-135m", "prefill_32k")
    check_record(rec, "smollm-135m", "prefill_32k")
    assert rec["memory"]["args_gb"] * 1e9 == pytest.approx(
        reference_args_bytes("smollm-135m", "prefill_32k", smoke=False),
        rel=1e-12)
    ratio = rec["roofline"]["hlo_flops_cluster"] / \
        rec["roofline"]["model_flops"]
    assert 1.0 <= ratio <= 3.0, ratio
    assert rec["kernels"]["flash_attention_bhsd"]["calls"] == 30


def test_a_record_feeds_the_pipeline_model(full_width):
    from repro_torch.perfsim.pipeline import simulate_pipeline
    from repro_torch.perfsim.stepmodel import load_record, spec_from_roofline

    rec = load_record(str(full_width), "smollm-135m", "prefill_32k")
    spec = spec_from_roofline(rec, stages=4, microbatches=8)
    result = simulate_pipeline(spec)
    assert result.step_ticks > 0 and not result.deadlock


def test_skipped_failed_and_multipod_cells():
    rec = dryrun.run_cell("smollm-135m", "long_500k", False)
    assert rec["status"] == "skipped" and "sub-quadratic" in rec["reason"]
    bad = dryrun.run_cell("smollm-135m", "decode_32k", False,
                          cfg_overrides={**smoke_overrides("smollm-135m"),
                                         "num_kv_heads": 3})
    assert bad["status"] == "FAILED" and "Error" in bad["error"] \
        and bad["traceback"]
    mp = dryrun.run_cell("smollm-135m", "decode_32k", True,
                         cfg_overrides=smoke_overrides("smollm-135m"))
    assert mp["status"] == "ok" and mp["chips"] == 512
    assert mp["mesh"] == "2x16x16" and "roofline" not in mp
    import torch.distributed as dist
    assert not dist.is_initialized()        # each cell ends its group
