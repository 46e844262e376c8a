"""FIFO-sizing design-space exploration, served.

    PYTHONPATH=src python examples_torch/fifo_sizing_dse.py [--device cuda]
    PYTHONPATH=src python examples_torch/fifo_sizing_dse.py --device cpu

The PyTorch port's copy of ``examples/fifo_sizing_dse.py``, through
``repro_torch``.  Acts 2-4 solve their blocks on ``--device``: the
default ``cuda`` runs the hand-written sparse max-plus kernel
(``src/repro_torch/csrc/maxplus_sparse.cu``) and fails without a card;
``cpu`` runs its plain PyTorch version.  Every cycle count is the same on
both; the device is checked before act 1.

The paper's Table 6 workflow at design scale, in four acts:

  1. **One-at-a-time** ``resimulate`` — one depth vector per call (the
     paper's original flow), each point verified against a from-scratch
     simulation.
  2. **The sweep service** (``repro_torch.sweep``): submit whole candidate
     matrices against a warm compiled-graph cache.  Heterogeneous
     requests coalesce into shared solver blocks, duplicate depth
     vectors are solved once, results stream back per config, and small
     interactive queries jump the bulk queue via the priority lane.
  3. **Search drivers** (``repro_torch.sweep.search``) consuming the stream:
     random search and successive-halving FIFO-area minimization, both
     reporting the Pareto frontier of (total FIFO depth, latency) — the
     designer's actual decision surface.
  4. **The edit loop** (``repro_torch.delta``): edit one module's body and
     ``EditSession.update()`` — only the edited module is re-recorded;
     the other modules' traces, the compiled skeleton and the solved
     times are patched and verified, then sweeps of the *edited* design
     serve from the patched graph.

Every cycle count below is exact: reused configs come from the shared
batched fixpoint, diverging configs from automatic full re-simulation.
"""
import argparse
import time

import numpy as np

from repro_torch.core import resimulate, simulate
from repro_torch.designs.typea import skynet_like
from repro_torch.kernels._cuda import resolve_device
from repro_torch.sweep import SweepService, random_search, successive_halving


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the sweep service solves its blocks")
    args = ap.parse_args(argv)
    resolve_device(args.device)          # no card: fail before act 1
    base_prog = skynet_like(items=512, depth=12)
    t0 = time.perf_counter()
    base = simulate(base_prog)
    t_full = time.perf_counter() - t0
    print(f"initial run: cycles={base.cycles}  ({t_full*1e3:.0f} ms)\n")

    # ---- act 1: the paper's one-at-a-time incremental flow ----
    print(f"{'depths':>10s} {'cycles':>8s} {'method':>12s} {'time':>10s} "
          f"{'speedup':>8s}")
    n_chan = len(base.depths)
    for d in (1, 2, 4, 8, 16):
        new_depths = tuple([d] * n_chan)
        t0 = time.perf_counter()
        inc = resimulate(base, new_depths)
        dt = time.perf_counter() - t0
        method = "incremental" if inc.ok else "full-resim"
        # verify against a from-scratch simulation
        check = simulate(skynet_like(items=512, depth=12), depths=new_depths)
        assert check.cycles == inc.result.cycles, (d, check.cycles,
                                                   inc.result.cycles)
        print(f"{d:10d} {inc.result.cycles:8d} {method:>12s} "
              f"{dt*1e3:9.2f}ms {t_full/dt:7.1f}x")
    print("all points verified exact against full re-simulation\n")

    # ---- acts 2+3: the served sweep ----
    with SweepService(block=128, shards=2,
                      device=args.device) as svc:
        svc.warm(base)                       # adopt the base run (no re-sim)

        # a bulk random sweep and an interactive what-if, concurrently:
        # the 2-config query rides the priority lane past the bulk blocks
        rng = np.random.default_rng(0)
        D = rng.integers(2, 17, size=(512, n_chan))
        bulk = svc.submit(base, D, priority="bulk")
        probe = svc.submit(base, np.array([[4] * n_chan, [16] * n_chan]))
        t0 = time.perf_counter()
        po = probe.result()
        t_probe = time.perf_counter() - t0
        print(f"interactive probe (2 cfgs) answered in {t_probe*1e3:.1f} ms "
              f"while the bulk sweep runs: "
              f"depth-4 {int(po.cycles[0])} / depth-16 {int(po.cycles[1])} "
              f"cycles")
        out = bulk.result()
        best = int(np.argmin(np.where(out.cycles < 0, 1 << 60, out.cycles)))
        print(f"bulk sweep: {len(D)} configs ({out.n_unique} unique) in "
              f"{out.elapsed_s*1e3:.1f} ms, {out.n_reused} reused / "
              f"{out.n_fallback} full re-sims; best cycles="
              f"{int(out.cycles[best])}")

        # search drivers: FIFO-area minimization on a smaller instance
        prog = skynet_like(items=96, depth=8)
        ro = random_search(svc, prog, n=128, lo=1, hi=16, seed=1)
        sh = successive_halving(svc, prog, n0=32, rounds=3, eta=2,
                                lo=1, hi=16, seed=1)
        print(f"\nrandom search : {ro.summary()}")
        print(f"succ. halving : {sh.summary()}")
        print("\npareto frontier (total depth, cycles) from halving:")
        for dv, area, cyc in sh.pareto:
            print(f"  area={area:4d}  cycles={cyc:6d}")

        st = svc.stats()
        print(f"\nservice stats: cache hit rate "
              f"{st['cache']['hit_rate']:.2f}, "
              f"{st['scheduler']['blocks']} blocks, dedup "
              f"{st['scheduler']['dedup_ratio']:.2f}x, "
              f"{st['scheduler']['fallbacks']} fallback re-sims")

    # ---- act 4: the edit-and-resimulate loop (repro_torch.delta) ----
    from repro_torch.corpus import edit_pairs
    pair = edit_pairs(11, scale=60, kinds=("delay",))[0]
    with SweepService(device=args.device) as svc:
        sess = svc.edit_session(pair.base())
        n = len(sess.program.fifos)
        D = np.random.default_rng(2).integers(2, 9, size=(16, n))
        before = sess.sweep(D)
        t0 = time.perf_counter()
        outcome = sess.update(pair.edited())     # one module body edited
        dt = time.perf_counter() - t0
        after = sess.sweep(D)
        print(f"\nedit loop (60-module corpus design): update() -> "
              f"{outcome.mode}, {outcome.reused_modules}/"
              f"{outcome.total_modules} module traces reused "
              f"({outcome.reuse_fraction:.1%}) in {dt*1e3:.1f} ms")
        live = (before.cycles >= 0) & (after.cycles >= 0)
        print(f"re-swept {len(D)} configs of the edited design: "
              f"median cycles {int(np.median(before.cycles[live]))} -> "
              f"{int(np.median(after.cycles[live]))}")
        d = svc.stats()["cache"]
        print(f"delta tiers: {d['delta_hits']} patched, "
              f"{d['delta_rejects']} rejected to cold")


if __name__ == "__main__":
    main()
