"""Distributed-schedule DSE with the OmniSim engine.

    PYTHONPATH=src python examples_torch/pipeline_perfsim.py [--records DIR]

The PyTorch port's copy of ``examples/pipeline_perfsim.py``, through
``repro_torch.perfsim``.  The paper's technique integrated into the
training framework: a pipeline-parallel step is a dataflow design (stages
= modules, activation queues = FIFOs).  OmniSim predicts step time for
GPipe vs 1F1B across microbatch counts and buffer depths, using
incremental re-simulation for the depth sweep.  If the dry run's record
of qwen2.5-14b train_4k exists under ``--records DIR`` (default
reports/dryrun, where ``python -m repro_torch.launch.dryrun`` writes it),
tick costs come from that record: the port's count of the compiled step,
priced at the H100 data sheet's figures (``launch/roofline.py``).
"""
import argparse
import dataclasses

from repro_torch.perfsim.pipeline import (PipelineSpec, buffer_depth_dse,
                                          simulate_pipeline)
from repro_torch.perfsim.stepmodel import load_record, spec_from_roofline


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--records", default="reports/dryrun",
                    help="directory of the dry run's JSON records")
    args = ap.parse_args(argv)
    rec = load_record(args.records, "qwen2.5-14b", "train_4k")
    if rec is not None and "roofline" in rec:
        spec = spec_from_roofline(rec, stages=8, microbatches=32)
        print(f"tick costs from qwen2.5-14b train_4k dry-run: "
              f"fwd={spec.fwd_ticks} bwd={spec.bwd_ticks} ticks/stage/mb\n")
    else:
        spec = PipelineSpec(stages=8, microbatches=32, fwd_ticks=40,
                            bwd_ticks=80)
        print("no dry-run records found; using synthetic tick costs\n")

    print(f"{'schedule':>9s} {'mb':>4s} {'depth':>6s} {'step(ticks)':>12s} "
          f"{'bubble':>8s}")
    for schedule in ("gpipe", "1f1b"):
        for mb in (8, 16, 32, 64):
            s = dataclasses.replace(spec, schedule=schedule, microbatches=mb)
            r = simulate_pipeline(s)
            print(f"{schedule:>9s} {mb:4d} {s.buffer_depth:6d} "
                  f"{r.step_ticks:12d} {r.bubble_fraction:7.1%}")

    print("\nbuffer-depth DSE via incremental re-simulation (gpipe, mb=32):")
    g = dataclasses.replace(spec, schedule="gpipe", microbatches=32,
                            buffer_depth=1)
    for depth, res, incr_s in buffer_depth_dse(g, [1, 2, 4, 8]):
        how = "" if incr_s is None else (
            f"  incr {abs(incr_s)*1e3:.2f} ms"
            + ("" if incr_s >= 0 else " (constraints broke -> full)"))
        print(f"  depth={depth:3d}  step={res.step_ticks:8d}  "
              f"bubble={res.bubble_fraction:6.1%}{how}")


if __name__ == "__main__":
    main()
