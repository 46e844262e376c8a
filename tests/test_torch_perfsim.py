"""PyTorch port, ``perfsim`` (pipeline schedules as dataflow designs),
against the reference.

Each case of ``tests/test_perfsim.py`` runs on both packages from the same
spec, and the port must give the reference's answer exactly: step ticks,
bubble fraction, deadlock flag, outputs, every row of the buffer-depth DSE
and the RTL oracle's agreement (the simulator is integer host code, so
there is no tolerance).  ``stepmodel`` is held on a literal dry-run record.
"""
import dataclasses
import json

import pytest

from repro.core import classify as ref_classify
from repro.core import simulate as ref_simulate
from repro.core import simulate_rtl as ref_simulate_rtl
from repro.perfsim import pipeline as ref_pipeline
from repro.perfsim import stepmodel as ref_stepmodel
from repro_torch.core import classify, simulate, simulate_rtl
from repro_torch.perfsim import (TICK_US, PipelineSpec, buffer_depth_dse,
                                 build_pipeline_program, load_record,
                                 simulate_pipeline, spec_from_roofline)


def _both(**kw):
    """The same spec in each package."""
    return ref_pipeline.PipelineSpec(**kw), PipelineSpec(**kw)


def _same_run(ref, port):
    assert port.step_ticks == ref.step_ticks
    assert port.bubble_fraction == ref.bubble_fraction
    assert port.deadlock == ref.deadlock
    assert port.result.outputs == ref.result.outputs
    assert port.result.engine == ref.result.engine


def test_pipeline_program_matches_rtl_oracle():
    kw = dict(stages=4, microbatches=8, fwd_ticks=5, bwd_ticks=10,
              buffer_depth=2)
    rs, ts = _both(**kw)
    r1 = simulate(build_pipeline_program(ts))
    r2 = simulate_rtl(build_pipeline_program(ts))
    assert r1.cycles == r2.cycles
    assert r1.outputs == r2.outputs
    assert not r1.deadlock
    want = ref_simulate(ref_pipeline.build_pipeline_program(rs))
    assert (r1.cycles, r1.outputs) == (want.cycles, want.outputs)
    rtl = ref_simulate_rtl(ref_pipeline.build_pipeline_program(rs))
    assert (r2.cycles, r2.outputs) == (rtl.cycles, rtl.outputs)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_schedules_complete(schedule):
    rs, ts = _both(stages=4, microbatches=16, fwd_ticks=3, bwd_ticks=6,
                   schedule=schedule, dp_allreduce_ticks=20)
    out = simulate_pipeline(ts)
    assert not out.deadlock
    # lower bound: every microbatch's fwd+bwd through one stage
    assert out.step_ticks >= 16 * 9
    _same_run(ref_pipeline.simulate_pipeline(rs), out)
    # and the RTL engine behind engine="rtl"
    _same_run(ref_pipeline.simulate_pipeline(rs, engine="rtl"),
              simulate_pipeline(ts, engine="rtl"))


def test_1f1b_beats_gpipe_with_small_buffers():
    """1F1B's early backwards drain buffers: with tight activation queues it
    stalls less than GPipe (the reason 1F1B exists)."""
    kw = dict(stages=4, microbatches=16, fwd_ticks=5, bwd_ticks=10,
              buffer_depth=1)
    g = simulate_pipeline(PipelineSpec(schedule="gpipe", **kw))
    f = simulate_pipeline(PipelineSpec(schedule="1f1b", **kw))
    assert not g.deadlock and not f.deadlock
    assert f.step_ticks <= g.step_ticks
    _same_run(ref_pipeline.simulate_pipeline(
        ref_pipeline.PipelineSpec(schedule="gpipe", **kw)), g)
    _same_run(ref_pipeline.simulate_pipeline(
        ref_pipeline.PipelineSpec(schedule="1f1b", **kw)), f)


def test_more_microbatches_lower_bubble():
    base = dict(stages=4, fwd_ticks=5, bwd_ticks=10, buffer_depth=2)
    runs = {}
    for mb in (4, 32):
        rs, ts = _both(microbatches=mb, **base)
        runs[mb] = simulate_pipeline(ts)
        _same_run(ref_pipeline.simulate_pipeline(rs), runs[mb])
    assert runs[32].bubble_fraction < runs[4].bubble_fraction


def test_deeper_buffers_never_slower():
    base = dict(stages=4, microbatches=12, fwd_ticks=4, bwd_ticks=8,
                schedule="gpipe")
    prev = None
    for d in (1, 2, 4, 8):
        rs, ts = _both(buffer_depth=d, **base)
        r = simulate_pipeline(ts)
        _same_run(ref_pipeline.simulate_pipeline(rs), r)
        if prev is not None:
            assert r.step_ticks <= prev
        prev = r.step_ticks


def test_buffer_dse_incremental_matches_full():
    """Depth sweep via incremental re-sim must agree with full re-sims, and
    every row with the reference's."""
    kw = dict(stages=4, microbatches=8, fwd_ticks=5, bwd_ticks=10,
              schedule="gpipe", buffer_depth=1)
    rs, ts = _both(**kw)
    depths = [1, 2, 4, 16]
    sweep = buffer_depth_dse(ts, depths)
    want = ref_pipeline.buffer_depth_dse(rs, depths)
    assert [d for d, _, _ in sweep] == [d for d, _, _ in want] == depths
    for (depth, res, incr_s), (_, ref, ref_s) in zip(sweep, want):
        full = simulate_pipeline(dataclasses.replace(ts, buffer_depth=depth))
        assert res.step_ticks == full.step_ticks, depth
        assert (res.step_ticks, res.bubble_fraction, res.deadlock) == \
            (ref.step_ticks, ref.bubble_fraction, ref.deadlock), depth
        assert res.result.outputs == ref.result.outputs
        # the base row has no re-simulation time; an incremental row's sign
        # says whether it stayed incremental (+) or fell back (-)
        assert (incr_s is None) == (ref_s is None)
        if incr_s is not None:
            assert (incr_s >= 0) == (ref_s >= 0), depth


def test_pipeline_program_is_type_b():
    kw = dict(stages=3, microbatches=4, fwd_ticks=2, bwd_ticks=4)
    rs, ts = _both(**kw)
    c = classify(build_pipeline_program(ts),
                 simulate(build_pipeline_program(ts)))
    assert c.cyclic          # fwd/bwd queues form stage cycles
    want = ref_classify(ref_pipeline.build_pipeline_program(rs),
                        ref_simulate(ref_pipeline.build_pipeline_program(rs)))
    assert dataclasses.asdict(c) == dataclasses.asdict(want)


# ----------------------------------------------------------------- stepmodel
RECORD = {"roofline": {"compute_s": 0.042, "memory_s": 0.013,
                       "collective_s": 0.0075}}


@pytest.mark.parametrize("kw", [{}, dict(stages=4, microbatches=16,
                                         buffer_depth=1, schedule="gpipe")])
def test_spec_from_roofline_is_the_references(kw):
    got = spec_from_roofline(RECORD, **kw)
    want = ref_stepmodel.spec_from_roofline(RECORD, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert TICK_US == ref_stepmodel.TICK_US
    _same_run(ref_pipeline.simulate_pipeline(want), simulate_pipeline(got))


def test_load_record(tmp_path):
    assert load_record(str(tmp_path), "smollm-135m", "train_4k") is None
    assert ref_stepmodel.load_record(str(tmp_path), "smollm-135m",
                                     "train_4k") is None
    path = tmp_path / "smollm-135m__train_4k__sp.json"
    path.write_text(json.dumps(RECORD))
    assert load_record(str(tmp_path), "smollm-135m", "train_4k") == RECORD
    assert load_record(str(tmp_path), "smollm-135m", "train_4k",
                       mesh="mp") is None
