#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

Usage, from the repository root on a machine with one CUDA card and the
CUDA toolkit::

    python3 chip_smoke.py

Phases, each printing its own line:

  1. environment: Python, torch and CUDA versions, the card's name and
     power limit (``nvidia-smi``), and the timed ``nvcc`` build of the
     four hand-written kernel sources from ``src/repro_torch/csrc`` (one
     ``nvcc`` per source, started together);
  2. the two max-plus kernels against their plain PyTorch versions on the
     card, on seeded synthetic inputs (kernel 1: random chains and edges
     exported with ``export_chain_flat``, K = 256; kernel 2: a random
     [4, 2048, 2048] int32 batch), bit for bit;
  3-6. the simulator's main path — simulate a design, compile its graph,
     re-solve it under a block of depth configs — through the entry points
     a user calls (``solve_block_status`` / ``resimulate_batch`` with
     ``backend="cuda"`` or ``"cuda_dense"``).  ``simulate`` takes
     compiled replay (``engine == "omnisim-trace"``, required) on every
     blocking design and the hybrid replay (``"omnisim-hybrid"``) on
     ``fig4_ex5``, as the reference does:
       3. ``skynet_like()`` at its defaults (102 452 nodes), K = 4096;
       4. ``matmul_stream()`` and ``merge_sort_staged(8)``, K = 1024;
       5. ``fig4_ex5()`` at K = 128 with the engine fallback, and the
          burst ping-pong whose shrunk rows form WAR cycles;
       6. ``merge_sort_staged()`` at K = 64 through the dense lane, and
          ``finalize_times`` on its simulation graph.
     Launch counts are zeroed just before and read just after these
     phases.  Their verdicts are then held against the plain versions on
     the card (all rows) and the port's exact host solver
     ``backend="numpy"`` (a prefix of rows);
  7. timings: the wall time of each main-path call (median of 3 after
     the counted run), each kernel's time beside its plain version's and
     its memory bound (for the sparse kernel also per round: the time
     over the rounds launched beside the bound over the rounds needed),
     the device's busy share over one ``matmul_stream`` solve, and peak
     device memory.  The bound counts the rounds (sweeps) the fixpoint
     needs, up to and including the first that changes nothing; the loop
     launches more, because the host reads the flag only every few
     rounds, and those are reported apart;
  8. the flash-attention kernel against its plain version on the card, on
     seeded inputs: (a) smollm-135m's attention, B 4, S 4096, 9 heads over
     3, hd 64, bf16, causal; (b) gemma2-2b's, B 1, S 8192, 8 heads over 4,
     hd 256, bf16, window 4096, softcap 50; (c) f32, ragged S = 1000,
     hd 32; (d) granite-moe-3b-a800m's, B 2, S 2048, 24 heads over 8;
     (e) hymba-1.5b's, 25 over 5, window 1024; (f) internvl2-1b's, S 2304
     (256 patches + 2048 tokens), 14 over 2; (d)-(f) hd 64, bf16,
     causal.  All but (c) must take the tensor-core route, (c) the f32
     FMA route (the wrapper's per-route launch counters);
  9-10. the LM serving path on smollm-135m at its published widths (30
     layers, d_model 576) with seeded random weights, through the entry
     points a user calls: the prefill step (``make_prefill_step``, B 4,
     S 4096, bf16), ``ServeEngine.generate`` (8 prompts of 32 tokens, 16
     new tokens) and ``ContinuousBatchingEngine.run`` (12 requests of 8
     tokens over 8 slots, 8 new tokens each).  Launch counts are zeroed
     just before and read just after these three calls: the flash kernel
     must have run once per layer (30), in the prefill, all on the
     tensor-core route.  Then:
       9. the prefill's last-position logits against the same step under
          ``plain_kernels()``, in bf16 and in float32 compute;
      10. the engines' outputs (shapes, lengths, all requests done), and
          the prefill step's logits against the decode path's after the
          same prompt, in float32 compute;
  11. timings: the flash kernel at shape (a) and at the reference's
     prefill_32k length (B 1, S 32 768), beside its plain version (at (a)
     only: its [BH, S, S] scores do not fit at 32k), one PyTorch call that
     computes the same function (``scaled_dot_product_attention`` with
     ``enable_gqa``: the yardstick, used nowhere in the port), its bound,
     its TFLOP/s and the route it took;
     the prefill step's wall time, decode tokens per second, and peak
     device memory;
  12. the chunked-mLSTM kernel against its plain version on the card, on
     seeded f32 inputs: (a) xlstm-1.3b's shape, B 4, S 2048, H 4, P 1024,
     Pv 1025, chunk 256; (b) the reference test's odd widths, P 64, Pv 65,
     chunk 32; (c) a single chunk (S 200 <= 256) at P 1024, Pv 1025; and
     (d) the reference's prefill_32k length, B 1, S 32 768, with a slowly
     decaying forget gate, so that the state is carried over many of the
     128 chunks, against the port's chunked plain scan
     (``models/xlstm.py::_ssd_scan_perhead``: the O(S^2) plain version
     does not fit there);
  13. the xlstm serving path on xlstm-1.3b at its published widths (48
     layers: 6 supergroups of 7 mLSTM blocks and one sLSTM block,
     d_model 2048, vocab 50 304) with seeded random weights (drawn on the
     card), through the entry points a user calls: the prefill step (B 4,
     S 2048, bf16), ``ServeEngine.generate`` (4 prompts of 128 tokens, 16
     new) and ``ContinuousBatchingEngine.run`` (6 requests of 32 tokens
     over 4 slots, 8 new each).  Launch counts are zeroed just before and
     read just after these three calls: the mLSTM kernel must have run
     once per mLSTM block (42), in the prefill.  Then the prefill's logits
     against ``plain_kernels()`` in bf16 and in float32, the prefill
     against the decode path in float32, and the engines' outputs;
  14. timings: the mLSTM kernel at (a) and at the reference's prefill_32k
     length (B 1, S 32 768) beside its bound (and its plain version at
     (a)); the xlstm prefill step's wall time and the sLSTM blocks' share
     of it, decode tokens per second, the device's busy share, and peak
     device memory;
  15. the sweep service on the card: ``repro_torch.sweep.SweepService``
     with ``backend="cuda"`` (its default), every design at its defaults,
     depth rows from phases 3-5:
       (a) two tenants at once on the service's background thread: a bulk
           tenant sweeps ``matmul_stream()`` (K 1024, submitted as a
           Program, so the cache builds it cold) and, while it runs, an
           interactive tenant ``fig4_ex5()`` (K 16, engine fallback);
           every row against a direct ``resimulate_batch(backend="cuda")``
           and a prefix against ``backend="numpy"``;
       (b) ``merge_sort_staged(8)``, K 1024, block 256, served serially,
           by two shard threads and by two ``spawn``-ed shard processes,
           each bit-identical to phase 4's direct solve;
       (c) ``skynet_like()``, K 4096, warmed from phase 3's base run, at
           block 128 and at block 4096, against phase 3's direct solve;
       (d) (a)'s bulk rows again in reverse order: all memo hits, no
           kernel launch;
       (e) (b)'s serial run under a ``FaultInjector(seed=0)``: one block's
           solve faults past the retry budget (its rows FAULTED, cycles
           -1), another's returns corrupt arrays once and is retried; all
           other rows exact.
     Kernel 1's launch count is zeroed just before and read just after
     each of (a)-(c) (process workers count in their own processes, read
     by probes sent to the pool).  Apart from (e), no row may be FAULTED,
     TIMED_OUT or CANCELLED and no shard may be retried.  Printed: each
     served sweep's wall time and configs/s, beside the direct
     ``solve_block_status`` on the same rows at the same block and at
     block = K; the cache's cold build; one profiled re-run's device time
     over the wall time; peak device memory in (c);
  16. initial simulation on the card's machine:
       (a) compiled replay against the port's generator engine on
           ``skynet_like()``, ``matmul_stream()``, ``merge_sort_staged(8)``
           and ``flowgnn_like(n_nodes=1024, layers=8)``: cycles, outputs,
           deadlock, graph size, node times as multisets, every FIFO
           table; both wall times (median of 3 after a warm run), the
           periodized trace's ``n_ops`` and ``n_stored``, the sweeps;
       (b) the trace-built graphs of phases 3 and 4 against the generator-
           built ones through kernel 1 (``solve_block_status``,
           ``backend="cuda"``, phases 3-4's rows): status, cycles and
           violated counts bit-identical, and against ``backend="numpy"``
           on a prefix; kernel 1's ms per solve and per round from each;
       (c) ``finalize_times`` (kernel 2) on ``merge_sort_staged()``'s
           ``TraceSimGraph``, equal to its own ``times()``;
       (d) the oracles on every design of ``designs/paper.py``, the small
           Type A designs of the reference's ``tests/test_trace.py`` and
           the two AXI designs: ``simulate`` against ``simulate_rtl``,
           ``LightningSim`` (it refuses every design but the Type A ones),
           C-sim against Table 3's values, ``classify``; and LightningSim's
           wall time against compiled replay's on the Type A designs at
           their defaults (the paper's Table 5, on this host).
     Kernel 1's and kernel 2's launch counts are zeroed just before and
     read just after (b) and (c);
  17. hybrid replay (NB/probe designs) on the card's machine, at the
     designs' defaults (``fig4_ex5()``, ``fig2_timer()``, ``branch()``,
     ``multicore()``, ``watchdog_pipe()``):
       (a) hybrid replay against the generator engine: cold (no cache),
           warm (a ``HybridCache`` after one run: whole-run replay) and
           ``periodize=False``, medians of 3 after a warm run; results,
           graph size, node times as multisets, FIFO tables and query
           counts equal; ``hybrid_info`` printed;
       (b) kernel 1 from hybrid-built against generator-built bases:
           ``fig4_ex5`` K 128 (phase 5's rows) and ``watchdog_pipe`` K
           1024 (depths 1-16): status, cycles, violated and rounds equal,
           and equal to ``backend="numpy"``; ms a round beside the bound;
       (c) ``finalize_times`` (kernel 2) on ``fig4_ex5``'s hybrid-built
           graph equals its ``times()``;
       (d) phase 5's ``fig4_ex5`` K 128 fallback block three ways: direct
           ``resimulate_batch`` (hybrid fallback, no cache),
           ``materialize_block`` with a fresh ``HybridCache`` (then again,
           warm), and the generator engine over the same rows; verdicts
           equal phase 5's; the hybrid attempts that abort (deadlocked
           rows) timed apart;
       (e) served: the ``HybridCache`` counters of phase 15 (a)'s
           service, and a fresh service sweeping ``fig4_ex5`` (submitted
           as a Program) twice, rows equal to the direct solve.
     Kernel 1's and kernel 2's launch counts are zeroed just before and
     read just after (b) and (c); the full GC passes inside each window
     are counted;
  18. the design corpus and edit sessions (``repro_torch.corpus``,
     ``repro_torch.delta``), at the reference's sizes:
       (a) ``check_conformance(..., device="cuda")`` on
           ``generate(2, scale=300)`` and ``generate(0, scale=1000)``:
           every engine path ``"ok"``, the ``"cuda"`` and ``"sweep"``
           paths on the card; then each path alone, timed less the
           generator-only call;
       (b) the reference's edit-session scenario
           (``benchmarks/tables.py::table_delta_resim``): the 7 pairs of
           ``edit_pairs(11, scale=300, spec=BLOCKING_SPEC.replace(
           items=IntRange(48, 96)))``, each through a fresh
           ``SweepService().edit_session(base).update(edited)``: the
           expected mode (``delay`` and ``retype`` patched, the rest
           cold), the served result equal to a cold ``simulate``; cold
           and update times as medians of 3, the ``delay`` speedup, the
           worst patched reuse and the reject rate;
       (c) the ``delay``-patched session's ``sweep`` of K 4096 rows (the
           edited depths plus ``default_rng(0).integers(0, 5)``) at the
           service's block of 128, against a direct ``resimulate_batch(
           backend="cuda")`` on a cold-built base (all rows) and
           ``backend="numpy"`` (64 rows); kernel 1 from the patched and
           the cold-built graph: ms, rounds, bound, peak memory.
     Kernel 1's launch count is zeroed just before and read just after
     each of (a)-(c); the full GC passes inside each window are counted;
  19. perfsim and the core remainder, host code on the card's machine:
     ``simulate_pipeline`` for ``gpipe`` and ``1f1b`` (4 stages, 16
     microbatches) against the RTL oracle (cycles and outputs equal),
     ``buffer_depth_dse`` over depths 1-8 (every row equal to a cold
     simulate), and ``longest_path_python`` against ``longest_path_numpy``
     on ``matmul_stream()``'s generator graph; wall times;
  20. minicpm-2b at its published widths (40 layers, d_model 2304, 36/36
     heads, hd 64, vocab 122 753) with seeded random weights (drawn on the
     card) and its int8 KV cache, through the entry points a user calls:
     the prefill step (B 2, S 2048, bf16), ``ServeEngine.generate`` (4
     prompts of 64 tokens, 16 new) and ``ContinuousBatchingEngine.run``
     (6 requests of 16 tokens over 4 slots, 8 new each).  Launch counts
     are zeroed just before and read just after these three calls: the
     flash kernel must have run once per layer (40), at group size 1, all
     on the tensor-core route.  Then (a) the prefill's logits against
     ``plain_kernels()`` in bf16 and in float32; (b) the engines' outputs,
     and int8 against bf16 decode on the same weights in float32 for 8
     steps, beside the reference's bound of 0.15 (printed, a finding if
     missed), and the two caches' bytes; (c) the prefill's time, decode
     tokens per second, the flash kernel at this shape beside its plain
     version, ``scaled_dot_product_attention`` and its bound, the busy
     share and peak memory;
  21. training: (a) smollm-135m at its published widths through
     ``repro_torch.launch.train``'s ``main`` (4 steps of B 8 x S 2048, a
     checkpoint every 2, into a temporary directory), then, with step 4's
     checkpoint removed, a second run that resumes from step 2: finite
     losses and grad norms, step 0's loss within 0.5 of ln(vocab), the
     resumed run's data state, losses and weights equal to the
     uninterrupted run's; no kernel of ours launched in the train steps
     (counts zeroed before each run); step time, tokens per second, busy
     share, peak memory; then a prefill on the trained weights, which
     must launch the flash kernel 30 times and agree with
     ``plain_kernels()``; (b) xlstm-1.3b at its published widths, 2 steps
     of ``make_train_step`` at B 1 x S 256: finite, no mLSTM launch, step
     time and peak memory; (c) one ``make_train_step`` at smollm-135m's
     smoke size in float32 on the card and on the CPU from the same
     weights and batch: loss, grad norm and weights within 1e-4.
     Before phase 19 the serving phases' weights and caches are released;
  22. the moe, hybrid, vlm and encoder-decoder families at their
     published widths and depths, with seeded random weights drawn on the
     card, each released before the next: (a) granite-moe-3b-a800m (40
     experts padded to 48, top-8), (b) hymba-1.5b (window 1024 on every
     layer, SSM heads 50 x 64, chunk 256), (c) internvl2-1b (256 stand-in
     patches), (d) seamless-m4t-medium (12 + 12 layers, 512 stand-in
     frames).  Each through the entry points a user calls: the prefill
     step (B 2 x S 2048, bf16), ``ServeEngine.generate`` (4 prompts of 64
     tokens, 16 new) and ``ContinuousBatchingEngine.run`` (6 requests of
     16 tokens over 4 slots, 8 new each); launch counts are zeroed just
     before and read just after these three calls: the flash kernel must
     have run once per (decoder) attention layer (32, 32, 24, 12), all on
     the tensor-core route, and no other kernel.  Then the prefill's
     logits against ``plain_kernels()`` in float32 (1e-3) and in bf16
     (0.1, or the plain lane's own bf16 error, its bf16 logits against its
     float32 ones, where that is larger);
     for granite both lanes record their expert routes, the token-layers
     whose expert sets differ are counted (in float32 each must be a
     near-tie, a gap under 1e-3, or follow an earlier flip in its
     sequence), and the plain lane is compared on the kernel lane's
     experts.  The prefill against the decode path in float32 (2 x 32
     tokens; 2e-2, hymba 3e-2: the reference's bounds; granite's decode on
     the prefill's experts; seamless in a direct loop with ``cache["enc"]
     = encode(frames)``, the engines keeping their zero ``enc`` as the
     reference's do); the engines' outputs; timings: the prefill's median,
     decode tokens/s, the busy share, peak memory, and the flash kernel
     at the family's shape beside its plain version,
     ``scaled_dot_product_attention`` (hymba's window as a boolean mask,
     with the SDPA backends that take it) and its bound.  (e) two
     ``make_train_step`` steps of hymba-1.5b at B 1 x S 2048 (remat):
     finite losses and grad norms, no kernel launched, step time, peak
     memory;
  23. expert parallelism on the card: an NCCL process group of world size
     1 (a TCP store on a free localhost port, set up and torn down in the
     phase) and the launcher's host mesh (1, 1) ``("data", "model")``.
     qwen3-moe-30b-a3b at its published widths (d_model 2048, 32/4 heads,
     hd 128, 128 experts, top-8, d_expert 768, vocab 151 936), its depth
     cut to fit one card (below): (a) the prefill step (B 2 x S 2048,
     bf16) with the mesh active (``moe_ep`` at capacity 1.25, over
     NCCL's all-to-all) and with none (``moe_dense``): launch counts are
     zeroed just before and read just after the ``moe_ep`` run, whose
     flash kernel must run once per layer, at group size 8 and hd 128, on
     the tensor-core route; wall times, busy shares, peak memory and the
     share of top-k choices dropped; for each layer, the choices dropped,
     the experts' loads against the capacity, and the share of its MoE
     input's direction that every token shares (the mean cosine between
     tokens); on layer 0's and the last layer's inputs at this shape,
     ``moe_ep`` at capacity 1.25 against ``moe_dense`` with the same keep
     mask (``keep=``: the choices ``moe_ep`` dropped weigh zero); on
     layer 0's input from a float32 prefill (B 1 x S 512), ``moe_ep`` at
     dropless capacity (E_pad / top_k) against ``moe_dense``; both within
     1e-5 in float32 and within twice the dense lane's own bf16 error in
     bf16; the flash kernel at this
     shape beside its plain version, ``scaled_dot_product_attention``
     (``enable_gqa``) and its bound; (b) ``ServeEngine`` and
     ``ContinuousBatchingEngine`` at phase 22's sizes, the mesh cleared as
     the serve launcher clears it (decode is ``moe_dense``): decode
     tokens/s; (c) two steps of ``launch.train`` (B 1 x S 2048, a
     checkpoint every step), then, with step 2's checkpoint removed, a run
     that resumes from step 1: ``moe_ep`` at n = 1, finite losses and
     grad norms, no kernel of ours in a train step, the resumed run equal
     to the uninterrupted one; (d) granite-moe-3b-a800m's MoE layer at
     full width through ``moe_ep`` (n = 1) and ``moe_dense`` on one B 2 x
     S 2048 bf16 input: CUDA-event times, the choices dropped at 1.25,
     and dropless agreement as in (a).
  24. the dry run and the executed placements: (a) ``python -m
     repro_torch.launch.dryrun --all --mesh pod --jobs N`` (every ARCHS x
     SHAPES cell on a fake 16 x 16 process group, N = cores worker
     processes) and two cells on 2 x 16 x 16, on the host after every
     timed phase (one thread each) and done within DRY_BUDGET_S: one
     line a cell (status, GB a device, fits 80 GB,
     the dominant term, counted over model FLOPs, collective bytes by
     kind); every applicable cell must be ``"ok"``; (b) the roofline of
     smollm-135m's prefill (B 4 x S 4096) and train step (B 8 x S 2048)
     at world 1 against phase 11's and phase 21 (a)'s measured times:
     measured over the dominant term; (c) on an NCCL group of one and the
     mesh (1, 1), smollm-135m with DTensor parameters
     (``distrib.sharding.device_put``): three train steps on bf16
     copies, as ``launch.train``, against the plain parameters' (step
     1's loss within 1e-5, the grad norms at steps 1 and 3 within 1e-3
     relative, the loss's move over the two updates within 1 %; a
     control lane on the rows reversed shows the step's rounding spread;
     step times beside each other and beside 21 (a)'s), and a prefill
     whose flash launches
     (counts zeroed just before, read just after) must be 30; (d) with
     four cards, qwen2.5-14b trained under FSDP over 'data' by
     ``torchrun --nproc_per_node 4 -m repro_torch.launch.train``; with
     one card it prints that it was skipped and why.  (c) and (d) run
     first, (a) and (b) last, with the card idle.
     The run's total time is printed last.

Float32 matrix products run in full float32 (``allow_tf32`` off), so the
float32 comparisons measure the kernels, not TF32.  The last two lines are
the card's name and power limit, then one JSON object ``{"ok": true,
"device": {...}}``; the line before them is the ``{"kernels": [...]}``
record.  Any failure exits non-zero and prints no result.  Depth rows,
tokens and attention inputs come from ``numpy.random.default_rng(0)``;
weights from ``torch.Generator().manual_seed(0)``.
"""
import concurrent.futures
import contextlib
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# H100 SXM data sheet: HBM3 at 3.35 TB/s; the max-plus kernels move int32
# bytes and use no tensor cores, so bytes bound them
HBM_BYTES_PER_S = 3.35e12
# H100 SXM data sheet: dense bf16 tensor-core rate; attention's bound is
# its FLOPs at this rate (or its bytes, where those take longer)
BF16_FLOPS_PER_S = 989e12
# H100 SXM data sheet: dense TF32 tensor-core rate; the f32 mLSTM
# recurrence's bound is its FLOPs at this rate (or its bytes)
TF32_FLOPS_PER_S = 495e12
# smollm-135m serving traffic of phases 9-11: 8 prompts of PROMPT10 tokens
# and GEN10 new; 12 requests of REQ10 tokens and REQ_GEN10 new over 8 slots
# (shortened from 128 + 32 and 32 + 16 to keep the whole run near 10 min)
PROMPT10, GEN10, REQ10, REQ_GEN10 = 32, 16, 8, 8
# phase 22: prefill B x S; ServeEngine prompts x (prompt + new); continuous
# batching requests x (prompt + new) over slots; hymba's train steps
PREFILL22, SERVE22, CB22 = (2, 2048), (4, 64, 16), (6, 16, 8, 4)
TRAIN22_STEPS, TRAIN22_SEQ = 2, 2048
# phase 23: qwen3-moe-30b-a3b's depth cut to fit one card's 80 GB: one
# layer is 0.623e9 f32 parameters (2.49 GB), the embedding and head
# another 2.49 GB; prefill and serving at 16 of 48 layers (~42 GB of
# weights); training holds weights, grads and two AdamW moments (16 bytes
# a parameter, and its checkpoints 12) at 1 layer; B x S of the prefill
# and of granite's MoE layer; the train steps' S; the float32 agreement's
# B x S
QWEN23_LAYERS, TRAIN23_LAYERS = 16, 1
PREFILL23, TRAIN23_SEQ, AGREE23 = (2, 2048), 2048, (1, 512)
# phase 24: the dry run runs on the host after every timed phase (one
# worker process a core beside the 2 x 16 x 16 subset and the world-1
# roofline, which end early; one thread each) and must be done within
# DRY_BUDGET_S; the
# 2 x 16 x 16 subset; (c)'s train step B x S (phase 21 (a)'s) and
# prefill B x S
DRY_BUDGET_S = 420
DRY_MULTIPOD = (("smollm-135m", "prefill_32k"),
                ("qwen3-moe-30b-a3b", "decode_32k"))
TRAIN24, PREFILL24 = (8, 2048), (4, 2048)
# serving timings (phases 11, 14, 20 (c)): runs after the counted run,
# which was their warm-up; one run keeps the whole script inside its
# time limit on a slow host
SERVE_REPS = 1
FAILURES = []


def log(msg):
    print(msg, flush=True)


def smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    try:
        yield
    except Exception:                     # noqa: BLE001 — report, go on
        FAILURES.append(name)
        log(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s")
        traceback.print_exc()
        sys.stdout.flush()
    else:
        log(f"[{name}] ok ({time.perf_counter() - t0:.1f} s)")


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def synthetic_chain_graph(rng, chains=16, fifos=6, lens=(50, 400)):
    """Seeded random chain graph in the shape the simulator exports: chains
    of ``lens[0] <= length < lens[1]`` nodes, every
    node gets a recorded commit time (increasing along its chain); FIFO
    writes and reads pair up in time order between two chains (RAW edge
    write -> read), and extra RAW edges run forward in time, so the graph
    without WAR edges is acyclic.  Regenerated WAR edges (read ``w-S-1``
    -> write ``w``) may run against the recorded times, so small depths
    can form cycles, as in real designs.  Returns ``(n, args)`` for
    ``export_chain_flat(*args, neg=...)``."""
    lens = rng.integers(*lens, size=chains)
    slices, off = [], 0
    for ln in lens:
        slices.append((off, off + int(ln)))
        off += int(ln)
    n = off
    when = np.concatenate([np.cumsum(rng.integers(1, 4, size=int(ln)))
                           for ln in lens])
    seq_w = rng.integers(0, 4, size=n)
    seq_w[[lo for lo, _ in slices]] = 0
    cw = np.concatenate([np.cumsum(seq_w[lo:hi]) for lo, hi in slices])
    c_seed = np.full(n, -(1 << 40), np.int64)
    c_seed[[lo for lo, _ in slices]] = 0
    pick = rng.choice(n, size=n // 20, replace=False)
    c_seed[pick] = rng.integers(0, 50, size=len(pick))
    used = np.zeros(n, bool)
    raw_dst, raw_src, w_cols, r_cols = [], [], [], []
    for _ in range(fifos):
        a, b = rng.choice(chains, size=2, replace=False)
        wc, rc = [], []
        cand = np.arange(*slices[b])
        for w in np.sort(rng.choice(np.arange(*slices[a]),
                                    int(lens[a]) // 3, replace=False)):
            if used[w]:
                continue
            later = cand[(when[cand] > when[w]) & ~used[cand]]
            if rc:
                later = later[later > rc[-1]]
            if not len(later):
                break
            r = int(later[min(int(rng.integers(0, 3)), len(later) - 1)])
            used[[w, r]] = True
            wc.append(int(w))
            rc.append(r)
        raw_dst += rc
        raw_src += wc
        w_cols.append(np.asarray(wc, np.int64))
        r_cols.append(np.asarray(rc, np.int64))
    for _ in range(n // 10):
        s_, d_ = rng.integers(0, n, size=2)
        if not used[d_] and when[s_] < when[d_] and \
                np.searchsorted([hi for _, hi in slices], s_, "right") != \
                np.searchsorted([hi for _, hi in slices], d_, "right"):
            used[d_] = True
            raw_dst.append(int(d_))
            raw_src.append(int(s_))
    raw_w = np.ones(len(raw_dst), np.int64)
    blocking = [np.ones(len(w), bool) for w in w_cols]
    bound = int(c_seed.max() + seq_w.sum() + raw_w.sum()
                + sum(len(w) for w in w_cols) + 1)
    return n, (slices, cw, c_seed, np.asarray(raw_dst, np.int64),
               np.asarray(raw_src, np.int64), raw_w, w_cols, r_cols,
               blocking, bound)


DRY_ROOFLINE = r"""
import json, sys
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeCell
from repro_torch.launch.dryrun import run_config
cfg = get_arch("smollm-135m")
out = {}
for key, cell in (("prefill", ShapeCell("prefill_b4_s4096", 4096, 4,
                                        "prefill")),
                  ("train", ShapeCell("train_b8_s2048", 2048, 8, "train"))):
    out[key] = run_config(cfg, cell)
json.dump(out, open(sys.argv[1], "w"), indent=1)
"""


def run_dry_runs(out):
    """Phase 24's host work, started together: the dry run of every (arch
    x shape) cell on the 16 x 16 pod (``--jobs``), the 2 x 16 x 16 subset,
    and the world-1 roofline of (b), each process with one thread.  Waits
    for them DRY_BUDGET_S in all and stops any still running then;
    returns (seconds, {name: exit code, None for one stopped})."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["OMP_NUM_THREADS"] = "1"
    jobs = os.cpu_count() or 4
    mod = [sys.executable, "-m", "repro_torch.launch.dryrun"]
    cmds = {"pod": mod + ["--all", "--mesh", "pod", "--jobs", str(jobs),
                          "--out", os.path.join(out, "pod")],
            "roofline_world1": [sys.executable, "-c", DRY_ROOFLINE,
                                os.path.join(out, "world1.json")]}
    for arch, shape in DRY_MULTIPOD:
        cmds[f"multipod {arch} {shape}"] = mod + [
            "--arch", arch, "--shape", shape, "--mesh", "multipod",
            "--out", os.path.join(out, "multipod")]
    shutil.rmtree(out, ignore_errors=True)        # no earlier run's records
    os.makedirs(out)
    t0 = time.perf_counter()
    procs, logs = {}, []
    try:
        for name, cmd in cmds.items():
            logs.append(open(os.path.join(out, name.replace(" ", "_")
                                          + ".log"), "w"))
            procs[name] = subprocess.Popen(cmd, cwd=ROOT, env=env,
                                           stdout=logs[-1],
                                           stderr=subprocess.STDOUT)
        for p in procs.values():
            try:
                p.wait(timeout=max(DRY_BUDGET_S
                                   - (time.perf_counter() - t0), 0.1))
            except subprocess.TimeoutExpired:
                break
        codes = {name: p.poll() for name, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    return time.perf_counter() - t0, codes


def worker_sparse_launches(pause):
    """(pid, kernel 1's launches) in a process-shard worker of phase 15,
    which imports this file as its main module (``spawn``); the pause lets
    each worker of the pool take one of the probes."""
    from repro_torch.kernels import _cuda

    time.sleep(pause)
    return os.getpid(), _cuda.SPARSE.launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to measure",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import (Emit, HybridCache, LightningSim, Program,
                                  Read, TraceSimGraph, TraceUnsupported,
                                  UnsupportedDesignError, Write, classify,
                                  compile_graph, csim, program_fingerprint,
                                  resimulate_batch, simulate, simulate_hybrid,
                                  simulate_rtl, solve_block_status)
    from repro_torch.core import dse
    from repro_torch.core.axi import axi_master_design, axi_prefetch_design
    from repro_torch.core.graph import export_chain_flat, longest_path_numpy
    from repro_torch.designs.dynamic import watchdog_pipe
    from repro_torch.designs.paper import PAPER_DESIGNS, fig4_ex5
    from repro_torch.designs.typea import (TYPEA_DESIGNS, flowgnn_like,
                                           matmul_stream, merge_sort_staged,
                                           skynet_like)
    from repro_torch.configs import get_arch
    from repro_torch.corpus import (BLOCKING_SPEC, EDIT_KINDS, ENGINE_PATHS,
                                    IntRange, check_conformance, edit_pairs,
                                    generate, result_record)
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.maxplus import kernel, ops, ref, sparse
    from repro_torch.kernels.mlstm_chunk import kernel as mc_kernel
    from repro_torch.kernels.mlstm_chunk import ops as mc_ops
    from repro_torch.kernels.mlstm_chunk import ref as mc_ref
    from repro_torch.models import api, lm
    from repro_torch.models.xlstm import MLSTM
    from repro_torch.models.xlstm import _ssd_scan_perhead as xscan
    from repro_torch.serve.engine import ContinuousBatchingEngine, ServeEngine
    from repro_torch.sweep import FaultInjector, SweepService
    from repro_torch.train.step import make_prefill_step

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = smi()
    # float32 products in full float32, so the float32 comparisons below
    # measure the kernels and not TF32 (which keeps ~3 decimal digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---------------------------------------------------------------- 1
    with phase("1 environment"):
        log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
            f"cuda {torch.version.cuda}  device "
            f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
        log(f"card: {card}")
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(_cuda.LIBS)) as ex:
            list(ex.map(lambda lib: lib.lib(), _cuda.LIBS))
        log(f"kernel build (nvcc, one per source, in parallel): "
            f"{time.perf_counter() - t0:.2f} s")
    if FAILURES:
        return 1

    def sync():
        torch.cuda.synchronize()

    def cuda_time(fn, reps, warm_up=True):
        """Median ms of ``reps`` runs of fn on CUDA events, after one
        warm-up run (``warm_up=False`` when fn has just run already)."""
        if warm_up:
            fn()
            sync()
        ms = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            sync()
            ms.append(a.elapsed_time(b))
        return statistics.median(ms)

    def device_busy(fn):
        """Kernel time of one fn() under torch.profiler (device clock; one
        stream, so kernels do not overlap) over the median time of fn()
        unprofiled on CUDA events, after a warm-up: the profiler's host
        overhead stretches the profiled run, not the unprofiled one."""
        from torch.profiler import ProfilerActivity, profile
        wall_ms = cuda_time(fn, 3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        # the raw device events: building the profiler's event tree takes
        # ~60 us an event on the host, minutes for a 175 000-kernel prefill
        cuda = torch.autograd.DeviceType.CUDA
        dev = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda and not e.is_user_annotation()]
        if not dev:
            return f"not measured (the profiler saw no device events; " \
                   f"unprofiled {wall_ms:.2f} ms)"
        busy_ms = sum(e.duration_ns() for e in dev) / 1e6
        by_name = {}
        for e in dev:
            # "void (anonymous namespace)::kernel<4>(int*, ...)" -> kernel
            name = e.name().replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0]
            name = name.removeprefix("void ").strip()[-48:]
            ms, n = by_name.get(name, (0.0, 0))
            by_name[name] = (ms + e.duration_ns() / 1e6, n + 1)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:3]
        return (f"{busy_ms:.2f} ms of kernels in {wall_ms:.2f} ms "
                f"unprofiled (median of 3; {100 * busy_ms / wall_ms:.1f} % "
                f"busy), {len(dev)} kernels; most time: " + ", ".join(
                    f"{name} {ms:.2f} ms ({n})" for name, (ms, n) in top))

    def same_solve(kern, plain):
        """Kernel and plain (times, converged) agree bit for bit: the
        converged mask, and the times of converged rows.  Returns the max
        absolute difference (0)."""
        (tk, ck), (tp, cp) = kern[:2], plain[:2]
        check(torch.equal(ck, cp), "converged masks differ")
        if not bool(ck.any()):
            return 0
        d = (tk[:, ck].long() - tp[:, cp].long()).abs().max()
        check(int(d) == 0, f"times differ by up to {int(d)}")
        return int(d)

    @contextlib.contextmanager
    def plain_kernels():
        """Route the device lanes through the plain PyTorch versions (on
        the same card) — the comparison, never the main path."""
        saved = (sparse.solve_chains, kernel.maxplus_sweep,
                 ops.maxplus_sweep, fa_ops.flash_attention_bhsd,
                 mc_ops.mlstm_chunk_bhsd)
        sparse.solve_chains = ref.solve_chains_ref
        kernel.maxplus_sweep = ops.maxplus_sweep = ref.maxplus_sweep_ref
        fa_ops.flash_attention_bhsd = fa_ref.attention_ref
        mc_ops.mlstm_chunk_bhsd = (
            lambda q, k, v, ig, la, chunk: mc_ref.mlstm_ref(q, k, v, ig, la))
        try:
            yield
        finally:
            (sparse.solve_chains, kernel.maxplus_sweep,
             ops.maxplus_sweep, fa_ops.flash_attention_bhsd,
             mc_ops.mlstm_chunk_bhsd) = saved

    def same_status(a, b, what):
        for x, y, f in zip(a[:3], b[:3], ("status", "cycles", "violated")):
            check(np.array_equal(x, y), f"{what}: {f} differs")

    def same_outcome(a, b, what):
        same_status((a.status, a.cycles, a.violated),
                    (b.status, b.cycles, b.violated), what)
        check(a.reasons == b.reasons, f"{what}: reasons differ")
        for ra, rb in zip(a.results, b.results):
            check((ra is None) == (rb is None), f"{what}: fallback differs")
            if ra is not None:
                check(ra.cycles == rb.cycles and ra.outputs == rb.outputs
                      and ra.deadlock == rb.deadlock,
                      f"{what}: fallback result differs")

    rng = np.random.default_rng(0)

    def attn_inputs(B, S, H, Hkv, hd, dtype):
        """Seeded q [B*H, S, hd], k and v [B*Hkv, S, hd] on the card."""
        return [torch.from_numpy(rng.standard_normal((B * h, S, hd),
                                                     dtype=np.float32))
                .to(dev, dtype) for h in (H, Hkv, Hkv)]

    def kept_pairs(S, causal, window):
        """(q, k) pairs the masks keep, per head."""
        qi = np.arange(S, dtype=np.int64)
        hi = qi + 1 if causal else np.full(S, S, np.int64)
        lo = np.maximum(0, qi - window + 1) if window > 0 else 0
        return int((hi - lo).sum())

    def attn_bound(B, S, H, Hkv, hd, dtype, causal=True, window=0):
        """(bound ms, bound_by): 4 hd FLOPs per kept pair (q.k and p.v) at
        the bf16 tensor-core rate, or q, k, v, o moved once at HBM rate."""
        flops = 4 * B * H * hd * kept_pairs(S, causal, window)
        nbytes = torch.tensor([], dtype=dtype).element_size() \
            * B * S * hd * (2 * H + 2 * Hkv)
        t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")

    # ------------------------------------------------ phases 19 - 21
    def late_phases():
        """Phases 19-21: perfsim and the core remainder (host), minicpm-2b
        served on the int8 KV cache, and training.  Returns what the
        kernel record takes from them."""
        import dataclasses
        import shutil
        import tempfile

        from repro_torch.core import longest_path_python
        from repro_torch.launch import train as train_launcher
        from repro_torch.optim.adamw import init_adamw
        from repro_torch.perfsim import (PipelineSpec, buffer_depth_dse,
                                         simulate_pipeline)
        from repro_torch.train.step import make_train_step

        late = {}
        log(f"device memory held before phases 19-21: "
            f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")

        # ----------------------------------------------------------- 19
        with phase("19 perfsim and the core remainder (host)"):
            for sched in ("gpipe", "1f1b"):
                spec = PipelineSpec(stages=4, microbatches=16, fwd_ticks=5,
                                    bwd_ticks=10, schedule=sched,
                                    dp_allreduce_ticks=20)
                t0 = time.perf_counter()
                om = simulate_pipeline(spec)
                s_om = time.perf_counter() - t0
                t0 = time.perf_counter()
                rtl = simulate_pipeline(spec, engine="rtl")
                s_rtl = time.perf_counter() - t0
                check(not om.deadlock and om.step_ticks == rtl.step_ticks
                      and om.result.outputs == rtl.result.outputs,
                      f"{sched}: simulate {om.step_ticks} ticks, RTL "
                      f"{rtl.step_ticks}, deadlock {om.deadlock}")
                log(f"  {sched}, 4 stages x 16 microbatches: "
                    f"{om.step_ticks} ticks (RTL oracle {rtl.step_ticks}, "
                    f"outputs equal), bubble {om.bubble_fraction:.4f}, "
                    f"engine {om.result.engine}; simulate {s_om:.4f} s, "
                    f"RTL oracle {s_rtl:.4f} s (host) [{card}]")
            spec = PipelineSpec(stages=4, microbatches=16, fwd_ticks=5,
                                bwd_ticks=10, schedule="gpipe",
                                buffer_depth=1)
            depths = list(range(1, 9))
            t0 = time.perf_counter()
            rows = buffer_depth_dse(spec, depths)
            s_dse = time.perf_counter() - t0
            t0 = time.perf_counter()
            cold = [simulate_pipeline(dataclasses.replace(
                spec, buffer_depth=d)) for d in depths]
            s_cold = time.perf_counter() - t0
            for (d, r, _), c in zip(rows, cold):
                check((r.step_ticks, r.bubble_fraction, r.deadlock,
                       r.result.outputs) == (c.step_ticks, c.bubble_fraction,
                                             c.deadlock, c.result.outputs),
                      f"buffer_depth_dse depth {d}: {r.step_ticks} ticks, "
                      f"cold simulate {c.step_ticks}")
            n_inc = sum(s >= 0 for _, _, s in rows[1:])
            log(f"  buffer_depth_dse gpipe, depths 1-8: ticks "
                f"{[r.step_ticks for _, r, _ in rows]}, every row equal to "
                f"a cold simulate; {n_inc} of {len(rows) - 1} re-solved "
                f"incrementally; the sweep {s_dse:.4f} s, 8 cold simulates "
                f"{s_cold:.4f} s (host) [{card}]")
            res = simulate(matmul_stream(), trace="never")
            csr = res.graph.graph.to_csr()
            t0 = time.perf_counter()
            t_py = longest_path_python(*csr)
            s_py = time.perf_counter() - t0
            t0 = time.perf_counter()
            t_np = longest_path_numpy(*csr)
            s_np = time.perf_counter() - t0
            check(np.array_equal(t_py, t_np) and
                  np.array_equal(t_py, res.graph.graph.times()),
                  "longest_path_python differs from longest_path_numpy")
            log(f"  longest_path_python on matmul_stream()'s generator "
                f"graph (n {len(t_py)}, E {len(csr[1])}): equal to "
                f"longest_path_numpy and the recorded times; "
                f"{s_py:.3f} s against {s_np:.3f} s (host) [{card}]")

        # ----------------------------------------------------------- 20
        mcfg = get_arch("minicpm-2b")
        mparams, m_out, m_err = None, {}, {}
        r20 = np.random.default_rng(20)
        with phase("minicpm main path: minicpm-2b prefill + serving on the "
                   "int8 KV cache (counted)"):
            t0 = time.perf_counter()
            mparams = api.init_params(torch.Generator(device=dev)
                                      .manual_seed(0), mcfg, device=dev)
            sync()
            log(f"  {mcfg.name}: "
                f"{sum(p.numel() for p in mparams.parameters())} "
                f"parameters, {mcfg.num_layers} layers, d_model "
                f"{mcfg.d_model}, heads {mcfg.num_heads}/"
                f"{mcfg.num_kv_heads}, hd {mcfg.resolved_head_dim}, vocab "
                f"{mcfg.vocab_size}, kv_quant {mcfg.kv_quant}, dtype "
                f"{mcfg.dtype} (init on the card "
                f"{time.perf_counter() - t0:.2f} s)")
            toks20 = torch.from_numpy(r20.integers(0, mcfg.vocab_size,
                                                   (2, 2048))).to(dev)
            prompts20 = r20.integers(0, mcfg.vocab_size, (4, 64))
            requests20 = [r20.integers(0, mcfg.vocab_size, 16)
                          for _ in range(6)]
            mprefill = make_prefill_step(mcfg)
            sync()
            for lib in _cuda.LIBS:
                lib.reset_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            m_out["prefill"] = mprefill(mparams, {"tokens": toks20})
            sync()
            m_out["prefill_s"] = time.perf_counter() - t0
            m_out["prefill_peak"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            m_out["generate"] = ServeEngine(mcfg, mparams, batch=4,
                                            max_len=128).generate(prompts20,
                                                                  16)
            sync()
            m_out["generate_s"] = time.perf_counter() - t0
            cb20 = ContinuousBatchingEngine(mcfg, mparams, batch=4,
                                            max_len=128)
            check(cb20.cache["k"].dtype == torch.int8 and
                  cb20.cache["k_scale"].dtype == torch.bfloat16,
                  "the serving cache is not int8 with bf16 scales")
            t0 = time.perf_counter()
            m_out["cb"] = cb20.run(requests20, 8)
            sync()
            m_out["cb_s"] = time.perf_counter() - t0
            m_out["serve_peak"] = torch.cuda.max_memory_allocated()
            del cb20
            m_launches = {lib.name: lib.launches for lib in _cuda.LIBS}
            m_routes = dict(_cuda.FLASH.route_launches)
            log(f"  prefill B=2 S=2048: {m_out['prefill_s']:.3f} s (first "
                f"call); generate 4x(64+16): {m_out['generate_s']:.3f} s; "
                f"continuous batching 6x(16+8) over 4 slots: "
                f"{m_out['cb_s']:.3f} s [{card}]")
            log(f"launches on the minicpm path: {m_launches}; flash routes "
                f"{m_routes}")
            check(m_launches["flash_attention"] == mcfg.num_layers,
                  f"flash kernel launched {m_launches['flash_attention']} "
                  f"times in one prefill, not once per layer "
                  f"({mcfg.num_layers})")
            check(m_routes["tensor_core_bf16"] == mcfg.num_layers,
                  f"the bf16 prefill took the tensor-core route "
                  f"{m_routes['tensor_core_bf16']} times, not "
                  f"{mcfg.num_layers}")
            late["minicpm_launches"] = m_launches["flash_attention"]
            late["minicpm_routes"] = m_routes

        if "cb" in m_out:
            with phase("20 (a) minicpm-2b prefill vs plain version (bf16 "
                       "and float32)"):
                got = m_out["prefill"].float()
                vp = mparams.embed.shape[0]
                check(tuple(got.shape) == (2, vp) and
                      bool(torch.isfinite(got).all()),
                      f"prefill logits not finite or of shape (2, {vp})")
                with plain_kernels():
                    want = mprefill(mparams, {"tokens": toks20}).float()
                # as phase 9: bf16 activations through 40 layers, each
                # attention output within one bf16 step: 0.1 absolute
                m_err["bf16"] = (got - want).abs().max().item()
                check(m_err["bf16"] <= 0.1, f"bf16 prefill logits differ "
                      f"by {m_err['bf16']:.3g} > 0.1")
                cfg32 = mcfg.replace(dtype="float32")
                p32 = make_prefill_step(cfg32)
                got32 = p32(mparams, {"tokens": toks20})
                with plain_kernels():
                    want32 = p32(mparams, {"tokens": toks20})
                # float32 throughout: summation order only, 1e-3 absolute
                m_err["f32"] = (got32 - want32).abs().max().item()
                check(m_err["f32"] <= 1e-3, f"f32 prefill logits differ "
                      f"by {m_err['f32']:.3g} > 1e-3")
                log(f"  bf16: max abs diff {m_err['bf16']:.3g} (max "
                    f"|logit| {want[:, :mcfg.vocab_size].abs().max().item():.3g}"
                    f"; argmax agree "
                    f"{bool(torch.equal(got.argmax(-1), want.argmax(-1)))})"
                    f"; float32: {m_err['f32']:.3g}")
                del got, want, got32, want32

            with phase("20 (b) serving outputs on the int8 cache; int8 vs "
                       "bf16 decode (float32)"):
                gen = m_out["generate"]
                check(gen.shape == (4, 16) and gen.min() >= 0
                      and gen.max() < mcfg.vocab_size, f"generate gave "
                      f"{gen.shape}, ids {gen.min()}..{gen.max()}")
                done = m_out["cb"]
                check(len(done) == 6 and all(len(t) == 8 for _, t in done)
                      and {s for s, _ in done} == set(range(4)),
                      f"continuous batching finished {len(done)} of 6, "
                      f"slots {[s for s, _ in done]}")
                cq = mcfg.replace(dtype="float32")
                c16 = cq.replace(kv_quant=False)
                caches = {c: api.init_cache(c, 2, 16, device=dev)
                          for c in (cq, c16)}
                check(caches[cq]["k"].dtype == torch.int8 and
                      caches[c16]["k"].dtype == torch.bfloat16,
                      "cache dtypes")
                worst = 0.0
                for t in range(8):
                    tok = torch.from_numpy(prompts20[:2, t:t + 1]).to(dev)
                    lq, _ = api.decode_step(mparams, tok, caches[cq], cq)
                    lb, _ = api.decode_step(mparams, tok, caches[c16], c16)
                    worst = max(worst, (lq - lb).abs().max().item())
                check(np.isfinite(worst), "int8 decode logits not finite")
                late["int8_vs_bf16"] = worst
                nbytes = {}
                for name, c in (("int8", mcfg), ("bf16", c16)):
                    cache = api.init_cache(c, 4, 4096, device="meta")
                    nbytes[name] = sum(a.numel() * a.element_size()
                                       for a in cache.values())
                late["cache_bytes"] = nbytes
                log(f"  generate {gen.shape}; continuous batching "
                    f"{len(done)} requests, slots {[s for s, _ in done]}; "
                    f"int8 against bf16 KV decode, float32 compute, 8 "
                    f"steps: max |logit diff| {worst:.4g} beside the "
                    f"reference's bound 0.15 "
                    f"({'inside' if worst < 0.15 else 'MISSED: a finding'})"
                    f"; cache at B 4 x T 4096: int8 "
                    f"{nbytes['int8'] / 2**30:.3f} GiB, bf16 "
                    f"{nbytes['bf16'] / 2**30:.3f} GiB "
                    f"({nbytes['int8'] / nbytes['bf16']:.3f}x)")

            with phase("20 (c) timings (minicpm-2b)"):
                pf_ms = cuda_time(lambda: mprefill(
                    mparams, {"tokens": toks20}), 3, warm_up=False)
                gen_ms = cuda_time(lambda: ServeEngine(
                    mcfg, mparams, batch=4, max_len=128).generate(
                        prompts20, 16), SERVE_REPS, warm_up=False)
                steps = 64 + 16 - 1
                B, S, H, Hkv, hd = 2, 2048, 36, 36, 64
                q, k, v = attn_inputs(B, S, H, Hkv, hd, torch.bfloat16)
                call = (lambda: fa_kernel.flash_attention_bhsd(
                    q, k, v, group_size=1))
                got = call()
                want = fa_ref.attention_ref(q, k, v, group_size=1)
                err = (got.float() - want.float()).abs().max().item()
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=2.0 ** -7, atol=1e-3)
                k_ms = cuda_time(call, 5)
                p_ms = cuda_time(lambda: fa_ref.attention_ref(
                    q, k, v, group_size=1), 2)
                # one head per K/V head: no enable_gqa
                lib_ms = cuda_time(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        q.view(B, H, S, hd), k.view(B, Hkv, S, hd),
                        v.view(B, Hkv, S, hd), is_causal=True), 5)
                bound_ms, bound_by = attn_bound(B, S, H, Hkv, hd,
                                                torch.bfloat16)
                late["flash_minicpm"] = {
                    "shape": f"minicpm-2b: B={B} S={S} H={H}/{Hkv} hd={hd} "
                             f"bf16 causal (group size 1)",
                    "route": "tensor_core_bf16", "ms": k_ms,
                    "plain_ms": p_ms, "library_ms": lib_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "max_abs_err": err,
                    "tflops": 4 * B * H * hd * kept_pairs(S, True, 0)
                    / (k_ms * 1e-3) / 1e12}
                del q, k, v, got, want
                log(f"  flash {late['flash_minicpm']} [{card}]")
                log(f"  prefill step minicpm-2b B=2 S=2048 bf16: median "
                    f"{pf_ms:.3f} ms of 3 (first "
                    f"{1e3 * m_out['prefill_s']:.3f} ms), peak device "
                    f"memory {m_out['prefill_peak'] / 2**30:.3f} GiB "
                    f"[{card}]")
                log(f"  ServeEngine.generate 4 x {steps} decode steps on the "
                    f"int8 cache: median {gen_ms:.3f} ms of {SERVE_REPS}, "
                    f"{4 * steps / (gen_ms / 1e3):.2f} decode tokens/s "
                    f"({4 * 16 / (gen_ms / 1e3):.2f} new tokens/s); "
                    f"continuous batching {m_out['cb_s']:.3f} s, "
                    f"{6 * 8 / m_out['cb_s']:.2f} new tokens/s (first run); "
                    f"peak device memory serving "
                    f"{m_out['serve_peak'] / 2**30:.3f} GiB [{card}]")
                log(f"  device busy, prefill step: "
                    f"{device_busy(lambda: mprefill(mparams, {'tokens': toks20}))}"
                    f" [{card}]")
        mparams = m_out = None
        gc.collect()
        torch.cuda.empty_cache()

        # ----------------------------------------------------------- 21
        scfg = get_arch("smollm-135m")
        r21 = np.random.default_rng(21)
        train_launches = {}
        with phase("21 (a) training smollm-135m at full width through "
                   "repro_torch.launch.train (counted)"):
            tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
            try:
                argv = ["--arch", "smollm-135m", "--steps", "4", "--batch",
                        "8", "--seq", "2048", "--ckpt-every", "2",
                        "--ckpt-dir", tmp, "--log-every", "1", "--device",
                        "cuda"]
                for lib in _cuda.LIBS:
                    lib.reset_counts()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                run1 = train_launcher.main(argv)
                sync()
                s_run1 = time.perf_counter() - t0
                peak1 = torch.cuda.max_memory_allocated()
                train_launches["run"] = {lib.name: lib.launches
                                         for lib in _cuda.LIBS}
                hist = run1["history"]
                check(all(np.isfinite(h["loss"]) and
                          np.isfinite(h["grad_norm"]) for h in hist),
                      f"a loss or grad norm is not finite: {hist}")
                ln_v = float(np.log(scfg.vocab_size))
                check(abs(hist[0]["loss"] - ln_v) < 0.5,
                      f"step 0's loss {hist[0]['loss']:.4f} is not within "
                      f"0.5 of ln(vocab) {ln_v:.4f}")
                # a crash after step 2's checkpoint: drop step 4's, resume
                ckdir = os.path.join(tmp, scfg.name)
                shutil.rmtree(os.path.join(ckdir, "step_000000000004"))
                check(os.listdir(ckdir) == ["step_000000000002"],
                      f"checkpoints {os.listdir(ckdir)}")
                for lib in _cuda.LIBS:
                    lib.reset_counts()
                run2 = train_launcher.main(argv)
                sync()
                train_launches["resume"] = {lib.name: lib.launches
                                            for lib in _cuda.LIBS}
                check(run2["start_step"] == 2 and
                      [h["step"] for h in run2["history"]] == [3, 4],
                      "the resumed run did not start from step 2")
                check(run2["data_state"] == run1["data_state"],
                      f"data state {run2['data_state']} after the resume, "
                      f"{run1['data_state']} uninterrupted")
                d_loss = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                             for a, b in zip(run2["history"], hist[2:]))
                d_par = max((a - b).abs().max().item() for a, b in zip(
                    run2["params"].parameters(),
                    run1["params"].parameters()))
                # same restored weights and batches; the card's atomic
                # sums (embedding backward) may order differently, at
                # lr <= 1.2e-5 in these warm-up steps
                check(d_loss <= 1e-5 and d_par <= 1e-5,
                      f"resumed run differs: loss {d_loss:.3g} relative, "
                      f"weights {d_par:.3g}")
                check(all(n == 0 for run in train_launches.values()
                          for n in run.values()),
                      f"a kernel of ours launched in the train steps: "
                      f"{train_launches}")
                secs = [h["seconds"] for h in hist]
                step_s = statistics.median(secs[1:])
                late["train_smollm"] = {"step_s": step_s,
                                        "tokens_per_s": 8 * 2048 / step_s,
                                        "peak_gib": peak1 / 2**30}
                log(f"  losses {[round(h['loss'], 4) for h in hist]} "
                    f"(ln vocab {ln_v:.4f}), grad norms "
                    f"{[round(h['grad_norm'], 4) for h in hist]}, lr "
                    f"{[h['lr'] for h in hist]}; resumed from step 2: "
                    f"losses {[round(h['loss'], 4) for h in run2['history']]}"
                    f", data state equal, loss diff {d_loss:.3g} relative, "
                    f"weights {d_par:.3g}")
                log(f"  launches in the train steps: {train_launches}")
                log(f"  step wall time {[round(s, 4) for s in secs]} s, "
                    f"median of the last 3 {step_s:.4f} s, "
                    f"{8 * 2048 / step_s:.0f} tokens/s (B 8 x S 2048, "
                    f"bf16, remat); run of 4 steps {s_run1:.2f} s in all; "
                    f"peak device memory {peak1 / 2**30:.3f} GiB [{card}]")
                params = run2["params"]
                step_fn = make_train_step(scfg, total_steps=4)
                tb = r21.integers(0, scfg.vocab_size, (8, 2048))
                batch = {"tokens": torch.from_numpy(tb).to(dev),
                         "targets": torch.from_numpy(
                             np.roll(tb, -1, 1)).to(dev)}
                opt = run2["opt_state"]
                log(f"  device busy, one train step: "
                    f"{device_busy(lambda: step_fn(params, opt, batch))} "
                    f"[{card}]")
                # the trained weights served: the kernel lane again
                toks = torch.from_numpy(r21.integers(
                    0, scfg.vocab_size, (2, 2048))).to(dev)
                pf = make_prefill_step(scfg)
                for lib in _cuda.LIBS:
                    lib.reset_counts()
                got = pf(params, {"tokens": toks})
                sync()
                late["after_training_launches"] = _cuda.FLASH.launches
                check(_cuda.FLASH.launches == scfg.num_layers and
                      _cuda.FLASH.route_launches["tensor_core_bf16"]
                      == scfg.num_layers, f"prefill after training: "
                      f"{_cuda.FLASH.launches} flash launches, routes "
                      f"{_cuda.FLASH.route_launches}")
                with plain_kernels():
                    want = pf(params, {"tokens": toks})
                err = (got.float() - want.float()).abs().max().item()
                check(err <= 0.1, f"prefill after training differs from "
                      f"the plain version by {err:.3g} > 0.1")
                log(f"  prefill B=2 S=2048 on the trained weights: "
                    f"{_cuda.FLASH.launches} flash launches (tensor-core "
                    f"route), max abs diff against plain_kernels() "
                    f"{err:.3g}")
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
        run1 = run2 = params = opt = None
        gc.collect()
        torch.cuda.empty_cache()

        with phase("21 (b) training xlstm-1.3b at full width, "
                   "make_train_step (counted)"):
            xc = get_arch("xlstm-1.3b")
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            xp = api.init_params(torch.Generator(device=dev).manual_seed(0),
                                 xc, device=dev)
            xo = init_adamw(xp)
            sync()
            s_init = time.perf_counter() - t0
            step_fn = make_train_step(xc)
            for lib in _cuda.LIBS:
                lib.reset_counts()
            secs, hist = [], []
            for _ in range(2):
                tb = r21.integers(0, xc.vocab_size, (1, 256))
                batch = {"tokens": torch.from_numpy(tb).to(dev),
                         "targets": torch.from_numpy(
                             np.roll(tb, -1, 1)).to(dev)}
                t0 = time.perf_counter()
                xp, xo, m = step_fn(xp, xo, batch)
                sync()
                secs.append(time.perf_counter() - t0)
                hist.append({k: float(v) for k, v in m.items()})
            peak = torch.cuda.max_memory_allocated()
            x_train = {lib.name: lib.launches for lib in _cuda.LIBS}
            train_launches["xlstm"] = x_train
            check(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
                      for h in hist), f"not finite: {hist}")
            check(all(n == 0 for n in x_train.values()),
                  f"a kernel of ours launched in the train steps: {x_train}")
            late["train_xlstm"] = {"step_s": secs, "peak_gib": peak / 2**30}
            log(f"  {sum(p.numel() for p in xp.parameters())} parameters "
                f"(init + AdamW state {s_init:.2f} s); B 1 x S 256: losses "
                f"{[round(h['loss'], 4) for h in hist]}, grad norms "
                f"{[round(h['grad_norm'], 4) for h in hist]}; launches "
                f"{x_train}; step wall time {[round(s, 3) for s in secs]} s "
                f"({256 / secs[-1]:.1f} tokens/s); peak device memory "
                f"{peak / 2**30:.3f} GiB [{card}]")
        xp = xo = None
        gc.collect()
        torch.cuda.empty_cache()

        with phase("21 (c) a train step on the card against the CPU "
                   "(smollm-135m smoke, float32)"):
            c = scfg.smoke()
            tb = r21.integers(0, c.vocab_size, (4, 128))
            out = []
            for d in (dev, torch.device("cpu")):
                p = api.init_params(0, c, device=d)
                o = init_adamw(p)
                o = o._replace(step=o.step + 150)
                batch = {"tokens": torch.from_numpy(tb).to(d),
                         "targets": torch.from_numpy(
                             np.roll(tb, -1, 1)).to(d)}
                p, o, m = make_train_step(c, cast_bf16=False)(p, o, batch)
                out.append(({k: float(v) for k, v in m.items()},
                            {n: t.detach().cpu()
                             for n, t in p.named_parameters()}))
            (mg, pg), (mc, pc) = out
            d_m = {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-30)
                   for k in ("loss", "grad_norm")}
            d_p = max((pg[n] - pc[n]).abs().max().item() for n in pc)
            check(max(d_m.values()) <= 1e-4 and d_p <= 1e-4,
                  f"card and CPU differ: {d_m}, weights {d_p:.3g}")
            log(f"  loss {mg['loss']:.6f} (CPU {mc['loss']:.6f}), grad norm "
                f"{mg['grad_norm']:.6f} (CPU {mc['grad_norm']:.6f}); "
                f"relative differences {d_m}, weights max abs {d_p:.3g} "
                f"(limit 1e-4)")
        late["train_launches"] = train_launches
        return late

    # ------------------------------------------------------------ phase 22
    def family_phases():
        """Phase 22: the moe, hybrid, vlm and encoder-decoder families at
        published widths, served ((a)-(d)), and one hymba train step
        ((e)).  Returns what the kernel record takes from them."""
        import warnings

        from torch.nn.attention import SDPBackend, sdpa_kernel

        from repro_torch.models import encdec
        from repro_torch.models import moe as moe_mod
        from repro_torch.models.frontends import synthetic_frontend
        from repro_torch.optim.adamw import init_adamw
        from repro_torch.train.step import make_train_step

        fam = {"launches": {}, "flash": [], "errors": {}}
        B, S = PREFILL22
        n_prompts, p_len, n_new = SERVE22
        n_req, r_len, r_new, slots = CB22
        route0 = moe_mod._route

        class Routes:
            """Stands in for ``moe._route`` in the comparisons (never on
            the counted run): records each call's experts and the gap
            between each token's k-th and (k+1)-th router logit, or, with
            ``replay(n, x)``, routes call n to the experts it gives, with
            this lane's own softmax weights over their logits."""

            def __init__(self, replay=None):
                self.idx, self.gap, self.replay, self.n = [], [], replay, 0

            def __call__(self, p, x, mo):
                logits = x.float() @ p.router.float()
                if self.replay is not None:
                    idx = self.replay(self.n, x)
                    self.n += 1
                    return torch.softmax(logits.gather(-1, idx.long()),
                                         -1), idx
                w, idx = route0(p, x, mo)
                top = torch.topk(logits[..., :mo.num_experts],
                                 mo.top_k + 1, dim=-1).values
                self.idx.append(idx.sort(-1).values)
                self.gap.append(top[..., -2] - top[..., -1])
                return w, idx

        @contextlib.contextmanager
        def routes(rec):
            moe_mod._route = rec
            try:
                yield rec
            finally:
                moe_mod._route = route0

        def flips(a, b, tie):
            """(token-layers whose expert sets differ between two runs of
            the same calls [B, S] per layer, those of them that nothing
            explains: a gap of at least ``tie`` in b's lane, and no flip
            in an earlier layer at this or an earlier position of the
            sequence, whose change attention would carry here)."""
            n = bad = 0
            seen = None
            for x, y, g in zip(a.idx, b.idx, b.gap):
                f = (x != y).any(-1)
                seen = torch.zeros_like(f) if seen is None else seen
                n += int(f.sum())
                bad += int((f & ~seen & (g >= tie)).sum())
                seen |= f.cumsum(-1) > 0
            return n, bad

        def lane(fn, moe_on, rec=None):
            if not moe_on:
                return fn(), None
            with routes(rec or Routes()) as r:
                return fn(), r

        def sdpa_call(q, k, v, Bq, H, Hkv, window):
            """One PyTorch call of the same function; a window takes a
            boolean mask, which not every SDPA backend accepts."""
            Sq, hd = q.shape[1:]
            kw = {"enable_gqa": H != Hkv}
            if window:
                i = torch.arange(Sq, device=q.device)
                kw["attn_mask"] = (i[None] <= i[:, None]) & \
                    (i[None] > i[:, None] - window)
            else:
                kw["is_causal"] = True
            args = (q.view(Bq, H, Sq, hd), k.view(Bq, Hkv, Sq, hd),
                    v.view(Bq, Hkv, Sq, hd))
            return (lambda: torch.nn.functional.scaled_dot_product_attention(
                *args, **kw)), args, kw

        def backends(args, kw):
            ok = []
            for b in (SDPBackend.FLASH_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION,
                      SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    try:
                        with sdpa_kernel([b]):
                            torch.nn.functional.scaled_dot_product_attention(
                                *args, **kw)
                        ok.append(b.name)
                    except RuntimeError:
                        pass
            return ok

        def family(tag, name):
            cfg = get_arch(name)
            moe_on = cfg.family == "moe"
            audio = cfg.family == "audio"
            n_attn = cfg.num_layers        # decoder layers for audio
            out, err = {}, {}
            with phase(f"22 ({tag}) {name} prefill + serving (counted)"):
                t0 = time.perf_counter()
                params = api.init_params(torch.Generator(device=dev)
                                         .manual_seed(0), cfg, device=dev)
                sync()
                out["params"] = params
                log(f"  {name} ({cfg.family}): "
                    f"{sum(p.numel() for p in params.parameters())} "
                    f"parameters, {cfg.num_layers} layers"
                    f"{f' + {cfg.encoder_layers} encoder' if audio else ''}"
                    f", d_model {cfg.d_model}, heads {cfg.num_heads}/"
                    f"{cfg.num_kv_heads}, hd {cfg.resolved_head_dim}, vocab "
                    f"{cfg.vocab_size}, window {cfg.sliding_window}, "
                    f"frontend {cfg.frontend_tokens}, dtype {cfg.dtype} "
                    f"(init on the card {time.perf_counter() - t0:.2f} s)")
                r = np.random.default_rng(22)
                batch = {"tokens": torch.from_numpy(r.integers(
                    0, cfg.vocab_size, (B, S))).to(dev)}
                fe = synthetic_frontend(cfg, B, 0, device=dev)
                if fe is not None:
                    batch["frontend"] = fe
                out["batch"] = batch
                prompts = r.integers(0, cfg.vocab_size, (n_prompts, p_len))
                requests = [r.integers(0, cfg.vocab_size, r_len)
                            for _ in range(n_req)]
                out["prompts"], out["requests"] = prompts, requests
                prefill = make_prefill_step(cfg)
                sync()
                for lib in _cuda.LIBS:
                    lib.reset_counts()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                out["prefill"] = prefill(params, batch)
                sync()
                out["prefill_s"] = time.perf_counter() - t0
                out["prefill_peak"] = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                out["generate"] = ServeEngine(
                    cfg, params, batch=n_prompts, max_len=128).generate(
                        prompts, n_new)
                sync()
                out["generate_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                cb = ContinuousBatchingEngine(cfg, params, batch=slots,
                                              max_len=128)
                out["cb"] = cb.run(requests, r_new)
                sync()
                out["cb_s"] = time.perf_counter() - t0
                out["serve_peak"] = torch.cuda.max_memory_allocated()
                if audio:
                    check(not cb.cache["enc"].any(), "the engine wrote enc")
                del cb
                launches = {lib.name: lib.launches for lib in _cuda.LIBS}
                routes_ = dict(_cuda.FLASH.route_launches)
                fam["launches"][name] = launches["flash_attention"]
                extra = f" + {cfg.frontend_tokens} frontend" \
                    if fe is not None else ""
                log(f"  prefill B={B} S={S}{extra}"
                    f": {out['prefill_s']:.3f} s (first call); generate "
                    f"{n_prompts}x({p_len}+{n_new}): {out['generate_s']:.3f}"
                    f" s; continuous batching {n_req}x({r_len}+{r_new}) "
                    f"over {slots} slots: {out['cb_s']:.3f} s [{card}]")
                log(f"launches on the {name} path: {launches}; flash routes "
                    f"{routes_}")
                check(launches["flash_attention"] == n_attn and
                      routes_["tensor_core_bf16"] == n_attn,
                      f"flash kernel launched {launches['flash_attention']}"
                      f" times ({routes_}) in one prefill, not once per "
                      f"attention layer ({n_attn}) on the tensor-core route")
                check(all(n == 0 for lib, n in launches.items()
                          if lib != "flash_attention"),
                      f"another kernel launched: {launches}")
            if "cb" not in out:
                return out
            params, batch = out["params"], out["batch"]

            with phase(f"22 ({tag}) {name}: prefill vs plain versions "
                       f"(bf16, float32) and vs decode (float32); serving "
                       f"outputs"):
                got = out["prefill"].float()
                vp = params.embed.shape[0]
                check(tuple(got.shape) == (B, vp) and
                      bool(torch.isfinite(got).all()),
                      f"prefill logits not finite or of shape ({B}, {vp})")
                # bf16: at most 0.1 (phase 9's limit), or the plain lane's
                # own bf16 error where that is larger: its bf16 logits
                # against its float32 ones (the same weights and tokens)
                plain = {}
                for dt_name, c in (("bf16", cfg),
                                   ("f32", cfg.replace(dtype="float32"))):
                    pf = make_prefill_step(c)
                    got, rk = lane(lambda: pf(params, batch), moe_on)
                    with plain_kernels():
                        want, rp = lane(lambda: pf(params, batch), moe_on)
                        plain[dt_name] = want.float()
                        note = ""
                        if moe_on:
                            free = want
                            # the plain lane on the kernel lane's experts
                            want, _ = lane(lambda: pf(params, batch), True,
                                           Routes(lambda n, x: rk.idx[n]))
                            n_flip, n_bad = flips(rk, rp, 1e-3)
                            spread = torch.cat([g.flatten() for g in
                                                rp.gap]).median().item()
                            err[f"{dt_name}_routes_differ"] = n_flip
                            err[f"{dt_name}_free"] = (
                                got.float() - free.float()).abs().max().item()
                            note = (f"; expert sets differ on {n_flip} of "
                                    f"{B * S * n_attn} token-layers "
                                    f"({n_bad} at a gap >= 1e-3 with no "
                                    f"earlier flip; median k-th gap "
                                    f"{spread:.3g}); free-routed max abs "
                                    f"diff {err[f'{dt_name}_free']:.3g}, "
                                    f"the plain lane on the kernel lane's "
                                    f"experts")
                            if dt_name == "f32":
                                check(n_bad == 0, f"float32: {n_bad} expert"
                                      f" flips not explained by a near-tie")
                    err[dt_name] = (got.float() - want.float()).abs().max() \
                        .item()
                    top = want.float()[:, :cfg.vocab_size].abs().max()
                    same = torch.equal(got.argmax(-1), want.argmax(-1))
                    log(f"  {dt_name}: max abs diff {err[dt_name]:.3g} "
                        f"(max |logit| {top.item():.3g}; argmax agree "
                        f"{same}){note}")
                    del got, want
                err["plain_bf16_vs_f32"] = (
                    plain["bf16"] - plain["f32"])[:, :cfg.vocab_size] \
                    .abs().max().item()
                tol16 = max(0.1, err["plain_bf16_vs_f32"])
                log(f"  limits: bf16 {tol16:.3g} (the plain lane's bf16 "
                    f"logits against its float32 ones: "
                    f"{err['plain_bf16_vs_f32']:.3g}), float32 1e-3")
                check(err["bf16"] <= tol16, f"bf16 prefill logits differ "
                      f"by {err['bf16']:.3g} > {tol16:.3g}")
                check(err["f32"] <= 1e-3, f"f32 prefill logits differ by "
                      f"{err['f32']:.3g} > 1e-3")
                # prefill against the decode path, float32
                c32 = cfg.replace(dtype="float32")
                prompt = torch.from_numpy(out["prompts"][:2, :32]).to(dev)
                pb = {"tokens": prompt}
                if audio:
                    pb["frontend"] = synthetic_frontend(c32, 2, 1, device=dev)
                full, rk = lane(lambda: make_prefill_step(c32)(params, pb),
                                moe_on)
                L = cfg.num_layers
                rec = Routes(lambda n, x: rk.idx[n % L][:, n // L:n // L + 1]
                             ) if moe_on else None
                with (routes(rec) if moe_on else contextlib.nullcontext()):
                    if audio:
                        cache = api.init_cache(c32, 2, 64, device=dev)
                        with torch.no_grad():
                            cache["enc"].copy_(encdec.encode(
                                params, pb["frontend"], c32))
                        for t in range(prompt.shape[1]):
                            step, cache = api.decode_step(
                                params, prompt[:, t:t + 1], cache, c32)
                        del cache
                    else:
                        step, _ = ServeEngine(c32, params, batch=2,
                                              max_len=64).prefill(
                                                  prompt.cpu().numpy())
                # the decode caches are bf16 (K/V, conv windows, enc); the
                # reference's own bounds for decode against forward:
                # 2e-2 dense, 3e-2 hybrid (tests/test_arch_smoke.py)
                tol = 3e-2 if cfg.family == "hybrid" else 2e-2
                err["decode"] = (full - step[:, 0]).abs().max().item()
                check(err["decode"] <= tol, f"prefill and decode logits "
                      f"differ by {err['decode']:.3g} > {tol}")
                gen, done = out["generate"], out["cb"]
                check(gen.shape == (n_prompts, n_new) and gen.min() >= 0
                      and gen.max() < cfg.vocab_size, f"generate gave "
                      f"{gen.shape}, ids {gen.min()}..{gen.max()}")
                check(len(done) == n_req and
                      all(len(t) == r_new for _, t in done) and
                      {s for s, _ in done} == set(range(slots)),
                      f"continuous batching finished {len(done)} of "
                      f"{n_req}, slots {[s for s, _ in done]}")
                log(f"  prefill vs decode (float32, 2 x 32"
                    f"{', enc = encode(frames) in bf16' if audio else ''}"
                    f"{', the prefill experts replayed' if moe_on else ''}"
                    f"): max abs diff {err['decode']:.3g} (limit {tol}, "
                    f"max |logit| "
                    f"{full[:, :cfg.vocab_size].abs().max().item():.3g}); "
                    f"generate "
                    f"{gen.shape}; continuous batching {len(done)} "
                    f"requests, slots {[s for s, _ in done]}"
                    + ("; the engines decode against zero enc" if audio
                       else ""))
                fam["errors"][name] = err
                del full, step

            with phase(f"22 ({tag}) {name}: timings"):
                prefill = make_prefill_step(cfg)
                pf_ms = cuda_time(lambda: prefill(params, batch), 3,
                                  warm_up=False)
                steps = p_len + n_new - 1
                gen_ms = cuda_time(lambda: ServeEngine(
                    cfg, params, batch=n_prompts, max_len=128).generate(
                        out["prompts"], n_new), 1, warm_up=False)
                busy = device_busy(lambda: prefill(params, batch))
                H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, \
                    cfg.resolved_head_dim
                Sa = S + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
                w = cfg.sliding_window
                q, k, v = attn_inputs(B, Sa, H, Hkv, hd, torch.bfloat16)
                call = (lambda: fa_kernel.flash_attention_bhsd(
                    q, k, v, window=w, group_size=H // Hkv))
                kern = call()
                want = fa_ref.attention_ref(q, k, v, window=w,
                                            group_size=H // Hkv)
                k_err = (kern.float() - want.float()).abs().max().item()
                torch.testing.assert_close(kern.float(), want.float(),
                                           rtol=2.0 ** -7, atol=1e-3)
                lib, args, kw = sdpa_call(q, k, v, B, H, Hkv, w)
                vs_lib = (kern.float() - lib().float().reshape(
                    B * H, Sa, hd)).abs().max().item()
                k_ms = cuda_time(call, 5)
                p_ms = cuda_time(lambda: fa_ref.attention_ref(
                    q, k, v, window=w, group_size=H // Hkv), 2)
                lib_ms = cuda_time(lib, 5)
                bound_ms, bound_by = attn_bound(B, Sa, H, Hkv, hd,
                                                torch.bfloat16, window=w)
                fam["flash"].append({
                    "shape": f"{name}: B={B} S={Sa} H={H}/{Hkv} hd={hd} "
                             f"bf16 causal window={w} (group size "
                             f"{H // Hkv})",
                    "route": "tensor_core_bf16", "ms": k_ms,
                    "plain_ms": p_ms, "library_ms": lib_ms,
                    "library": f"scaled_dot_product_attention(enable_gqa="
                               f"{kw['enable_gqa']}, "
                               f"{'bool attn_mask' if w else 'is_causal'}); "
                               f"backends that take it: {backends(args, kw)}",
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "max_abs_err": k_err, "max_abs_vs_library": vs_lib,
                    "launches": fam["launches"][name],
                    "tflops": 4 * B * H * hd * kept_pairs(Sa, True, w)
                    / (k_ms * 1e-3) / 1e12})
                del q, k, v, kern, want, args, kw, lib
                log(f"  flash {fam['flash'][-1]} [{card}]")
                log(f"  prefill step {name} B={B} S={S} bf16: median "
                    f"{pf_ms:.3f} ms of 3 (first "
                    f"{1e3 * out['prefill_s']:.3f} ms), peak device memory "
                    f"{out['prefill_peak'] / 2**30:.3f} GiB [{card}]")
                log(f"  ServeEngine.generate {n_prompts} x {steps} decode "
                    f"steps: {gen_ms:.3f} ms, "
                    f"{n_prompts * steps / (gen_ms / 1e3):.2f} decode "
                    f"tokens/s; continuous batching {out['cb_s']:.3f} s, "
                    f"{n_req * r_new / out['cb_s']:.2f} new tokens/s (first "
                    f"run); peak device memory serving "
                    f"{out['serve_peak'] / 2**30:.3f} GiB [{card}]")
                log(f"  device busy, prefill step: {busy} [{card}]")
            return out

        for tag, name in (("a", "granite-moe-3b-a800m"), ("b", "hymba-1.5b"),
                          ("c", "internvl2-1b"),
                          ("d", "seamless-m4t-medium")):
            family(tag, name)
            gc.collect()
            torch.cuda.empty_cache()

        with phase("22 (e) training hymba-1.5b at full width, "
                   "make_train_step (counted)"):
            hc = get_arch("hymba-1.5b")
            r = np.random.default_rng(23)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            hp = api.init_params(torch.Generator(device=dev).manual_seed(0),
                                 hc, device=dev)
            ho = init_adamw(hp)
            sync()
            s_init = time.perf_counter() - t0
            step_fn = make_train_step(hc)
            for lib in _cuda.LIBS:
                lib.reset_counts()
            secs, hist = [], []
            for _ in range(TRAIN22_STEPS):
                tb = r.integers(0, hc.vocab_size, (1, TRAIN22_SEQ))
                tbatch = {"tokens": torch.from_numpy(tb).to(dev),
                          "targets": torch.from_numpy(
                              np.roll(tb, -1, 1)).to(dev)}
                t0 = time.perf_counter()
                hp, ho, m = step_fn(hp, ho, tbatch)
                sync()
                secs.append(time.perf_counter() - t0)
                hist.append({k: float(v) for k, v in m.items()})
            peak = torch.cuda.max_memory_allocated()
            h_train = {lib.name: lib.launches for lib in _cuda.LIBS}
            fam["train_launches"] = h_train
            check(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
                      for h in hist), f"not finite: {hist}")
            ln_v = float(np.log(hc.vocab_size))
            check(abs(hist[0]["loss"] - ln_v) < 0.5, f"step 0's loss "
                  f"{hist[0]['loss']:.4f} is not within 0.5 of ln(vocab) "
                  f"{ln_v:.4f}")
            check(all(n == 0 for n in h_train.values()),
                  f"a kernel of ours launched in the train steps: {h_train}")
            fam["train_hymba"] = {"step_s": secs, "peak_gib": peak / 2**30}
            log(f"  {sum(p.numel() for p in hp.parameters())} parameters "
                f"(init + AdamW state {s_init:.2f} s); B 1 x S "
                f"{TRAIN22_SEQ}, remat {hc.remat}, SSD chunk "
                f"{hc.ssm.chunk}: losses "
                f"{[round(h['loss'], 4) for h in hist]} (ln vocab "
                f"{ln_v:.4f}), grad norms "
                f"{[round(h['grad_norm'], 4) for h in hist]}; launches "
                f"{h_train}; step wall time {[round(s, 3) for s in secs]} s "
                f"({TRAIN22_SEQ / secs[-1]:.1f} tokens/s); peak device "
                f"memory {peak / 2**30:.3f} GiB [{card}]")
        hp = ho = None
        gc.collect()
        torch.cuda.empty_cache()
        return fam

    # ------------------------------------------------------------ phase 23
    def ep_phases():
        """Phase 23: expert parallelism over an NCCL group of world size 1
        with qwen3-moe-30b-a3b at published widths ((a)-(c)) and
        granite-moe-3b-a800m's MoE layer ((d)).  Returns what the kernel
        record takes from them."""
        import shutil
        import tempfile

        import torch.distributed as dist

        from repro_torch.distrib.sharding import mesh_axes, set_active_mesh
        from repro_torch.launch import train as train_launcher
        from repro_torch.launch.mesh import init_process_group, make_host_mesh
        from repro_torch.models import moe as moe_mod

        ep = {}
        B, S = PREFILL23
        n_prompts, p_len, n_new = SERVE22
        n_req, r_len, r_new, slots = CB22
        bf16 = torch.bfloat16

        def meshed(m, fn):
            set_active_mesh(m)
            try:
                return fn()
            finally:
                set_active_mesh(None)

        def agree(layer, x, cfg, mesh, cf=None):
            """moe_ep at capacity ``cf`` (default dropless: E_pad / top_k)
            against moe_dense with moe_ep's keep mask, on one input in
            float32 (a bf16 ``x`` widened) and in bf16: (f32 max abs diff,
            its limit, bf16 max abs diff, its limit, share dropped)."""
            E, K = layer.router.shape[-1], cfg.moe.top_k
            cf = E / K if cf is None else cf
            x32, x16 = x.float(), x.to(bf16)
            with torch.no_grad():
                with moe_mod.count_drops() as d:
                    e32 = moe_mod.moe_ep(layer, x32, cfg, mesh,
                                         capacity_factor=cf)
                    e16 = moe_mod.moe_ep(layer, x16, cfg, mesh,
                                         capacity_factor=cf)
                k32, k16 = d["keep"]
                d32 = moe_mod.moe_dense(layer, x32, cfg, keep=k32.to(dev))
                d16 = moe_mod.moe_dense(layer, x16, cfg, keep=k16.to(dev))
            if cf * K >= E:
                check(d["dropped"] == 0, f"{d['dropped']} choices dropped "
                      f"at capacity {cf}")
            err32 = (e32 - d32).abs().max().item()
            lim32 = 1e-5 * max(1.0, d32.abs().max().item())
            own = (d16.float() - d32).abs().max().item()
            err16 = (e16.float() - d16.float()).abs().max().item()
            check(err32 <= lim32, f"float32: moe_ep and moe_dense differ "
                  f"by {err32:.3g} > {lim32:.3g}")
            check(err16 <= 2 * own, f"bf16: moe_ep and moe_dense differ "
                  f"by {err16:.3g} > twice the dense lane's own bf16 error "
                  f"{own:.3g}")
            return err32, lim32, err16, 2 * own, d["dropped"] / d["choices"]

        def shared_direction(h):
            """|mean over a sequence's tokens of h / |h||^2, averaged over
            the sequences: the mean cosine between two tokens' MoE inputs
            in one sequence (1/S for orthogonal tokens, 1 when they all
            point one way)."""
            u = torch.nn.functional.normalize(h.float(), dim=-1)
            return float(u.mean(1).square().sum(-1).mean())

        with phase("23 setup: NCCL process group of world size 1, the "
                   "host mesh"):
            t0 = time.perf_counter()
            check(init_process_group(dev), "a process group was running")
            check(dist.get_backend() == "nccl" and
                  dist.get_world_size() == 1,
                  f"backend {dist.get_backend()}, world "
                  f"{dist.get_world_size()}")
            mesh = make_host_mesh()
            check(mesh_axes(mesh) == {"data": 1, "model": 1},
                  f"mesh {mesh_axes(mesh)}")
            log(f"  {mesh} ({time.perf_counter() - t0:.2f} s)")
        if not dist.is_initialized():
            return ep
        qcfg = get_arch("qwen3-moe-30b-a3b").replace(
            num_layers=QWEN23_LAYERS)
        K = qcfg.moe.top_k
        try:
            qp = None
            with phase(f"23 (a) qwen3-moe-30b-a3b ({QWEN23_LAYERS} of 48 "
                       f"layers) prefill through moe_ep on NCCL and "
                       f"through moe_dense (counted)"):
                t0 = time.perf_counter()
                qp = api.init_params(torch.Generator(device=dev)
                                     .manual_seed(0), qcfg, device=dev)
                sync()
                log(f"  qwen3-moe-30b-a3b: "
                    f"{sum(p.numel() for p in qp.parameters())} parameters"
                    f", {QWEN23_LAYERS} of 48 layers, d_model "
                    f"{qcfg.d_model}, heads {qcfg.num_heads}/"
                    f"{qcfg.num_kv_heads}, hd {qcfg.resolved_head_dim}, "
                    f"{qcfg.moe.num_experts} experts top-{K}, d_expert "
                    f"{qcfg.moe.d_expert}, vocab {qcfg.vocab_size} (init "
                    f"on the card {time.perf_counter() - t0:.2f} s)")
                r = np.random.default_rng(23)
                batch = {"tokens": torch.from_numpy(r.integers(
                    0, qcfg.vocab_size, (B, S))).to(dev)}
                prefill = make_prefill_step(qcfg)
                sync()
                for lib in _cuda.LIBS:
                    lib.reset_counts()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                with moe_mod.count_drops() as drops:
                    got_ep = meshed(mesh, lambda: prefill(qp, batch))
                    sync()
                s_ep = time.perf_counter() - t0
                peak_ep = torch.cuda.max_memory_allocated()
                launches = {lib.name: lib.launches for lib in _cuda.LIBS}
                routes_ = dict(_cuda.FLASH.route_launches)
                ep["launches"] = launches["flash_attention"]
                log(f"launches on the qwen3-moe-30b-a3b moe_ep prefill: "
                    f"{launches}; flash routes {routes_}")
                check(launches["flash_attention"] == QWEN23_LAYERS and
                      routes_["tensor_core_bf16"] == QWEN23_LAYERS,
                      f"flash kernel launched {launches['flash_attention']}"
                      f" times ({routes_}), not once per layer "
                      f"({QWEN23_LAYERS}) on the tensor-core route")
                check(all(n == 0 for lib, n in launches.items()
                          if lib != "flash_attention"),
                      f"another kernel launched: {launches}")
                want_choices = QWEN23_LAYERS * B * S * K
                check(drops["choices"] == want_choices,
                      f"moe_ep routed {drops['choices']} choices, not "
                      f"{want_choices}: it did not take every MoE layer")
                ep["dropped"] = drops["dropped"] / drops["choices"]
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                got_dn = prefill(qp, batch)
                sync()
                s_dn = time.perf_counter() - t0
                peak_dn = torch.cuda.max_memory_allocated()
                vp = qp.embed.shape[0]
                for what, got in (("moe_ep", got_ep), ("moe_dense", got_dn)):
                    check(tuple(got.shape) == (B, vp) and
                          bool(torch.isfinite(got.float()).all()),
                          f"{what} prefill logits not finite or not of "
                          f"shape ({B}, {vp})")
                same = torch.equal(got_ep.argmax(-1), got_dn.argmax(-1))
                d_ep_dn = (got_ep.float() - got_dn.float()).abs().max()
                log(f"  prefill B={B} S={S} bf16, first calls: moe_ep "
                    f"{s_ep:.3f} s, peak {peak_ep / 2**30:.3f} GiB; "
                    f"moe_dense {s_dn:.3f} s, peak {peak_dn / 2**30:.3f} "
                    f"GiB; top-{K} choices dropped at capacity 1.25: "
                    f"{drops['dropped']} of {drops['choices']} "
                    f"({100 * ep['dropped']:.3f} %); the two lanes' "
                    f"last-position logits differ by {d_ep_dn.item():.3g} "
                    f"(argmax agree {same}) [{card}]")
                ep_ms = cuda_time(lambda: meshed(
                    mesh, lambda: prefill(qp, batch)), 3)
                dn_ms = cuda_time(lambda: prefill(qp, batch), 3)
                busy_ep = device_busy(lambda: meshed(
                    mesh, lambda: prefill(qp, batch)))
                busy_dn = device_busy(lambda: prefill(qp, batch))
                ep["prefill_ms"] = {"moe_ep": ep_ms, "moe_dense": dn_ms}
                log(f"  prefill step median of 3: moe_ep {ep_ms:.3f} ms, "
                    f"moe_dense {dn_ms:.3f} ms ({dn_ms / ep_ms:.2f}x, with "
                    f"{100 * ep['dropped']:.1f} % of moe_ep's top-{K} "
                    f"choices dropped at capacity 1.25) [{card}]")
                log(f"  device busy, moe_ep prefill: {busy_ep} [{card}]")
                log(f"  device busy, moe_dense prefill: {busy_dn} [{card}]")
                del got_ep, got_dn

            with phase("23 (a) routing by layer: drops, expert loads, the "
                       "MoE inputs' shared direction; moe_ep at capacity "
                       "1.25 against moe_dense on its keep mask"):
                seen, moe0 = [], lm.moe

                def record(p, h, cfg, mesh=None):
                    seen.append((shared_direction(h), h.detach().clone()
                                 if len(seen) in (0, QWEN23_LAYERS - 1)
                                 else None))
                    return moe0(p, h, cfg, mesh=mesh)

                lm.moe = record
                try:
                    with moe_mod.count_drops() as rd:
                        meshed(mesh, lambda: prefill(qp, batch))
                finally:
                    lm.moe = moe0
                E_pad = qp.layers[0].moe.router.shape[-1]
                C = max(4, -(-int(1.25 * K * B * S / E_pad) // 4) * 4)
                rows = []
                for i, ((cos, _), keep, load) in enumerate(zip(
                        seen, rd["keep"], rd["load"])):
                    rows.append({
                        "layer": i, "dropped": float((~keep).float().mean()),
                        "load_max": int(load.max()),
                        "experts_over_C": int((load > C).sum()),
                        "experts_idle": int((load == 0).sum()),
                        "top_loads": sorted(load.tolist())[::-1][:4],
                        "shared_direction": cos})
                    log(f"  layer {i:2d}: dropped "
                        f"{100 * rows[-1]['dropped']:6.2f} %, load max "
                        f"{rows[-1]['load_max']} (mean {B * S * K // E_pad},"
                        f" C {C}), experts over C "
                        f"{rows[-1]['experts_over_C']}, idle "
                        f"{rows[-1]['experts_idle']}, top loads "
                        f"{rows[-1]['top_loads']}; shared direction of the "
                        f"MoE input {cos:.4f}")
                check(len(rows) == QWEN23_LAYERS and
                      abs(sum(r["dropped"] for r in rows) / len(rows)
                          - ep["dropped"]) < 1e-3,
                      "the recorded prefill's drops differ from (a)'s")
                ep["layers"] = rows
                # the control: layer 0's router on iid inputs of the shape
                xr = torch.from_numpy(np.random.default_rng(27)
                                      .standard_normal((B, S, qcfg.d_model),
                                                       dtype=np.float32)
                                      ).to(dev, bf16)
                with torch.no_grad(), moe_mod.count_drops() as iid:
                    moe_mod.moe_ep(qp.layers[0].moe, xr, qcfg, mesh)
                ep["dropped_iid"] = iid["dropped"] / iid["choices"]
                log(f"  layer 0 on iid normal inputs of the same shape "
                    f"(shared direction {shared_direction(xr):.4f}): "
                    f"dropped {100 * ep['dropped_iid']:.2f} %, load max "
                    f"{int(iid['load'][0].max())}")
                del xr
                for i in (0, QWEN23_LAYERS - 1):
                    err32, lim32, err16, lim16, dr = agree(
                        qp.layers[i].moe, seen[i][1], qcfg, mesh, 1.25)
                    log(f"  layer {i}'s MoE input (B={B} S={S} bf16) at "
                        f"capacity 1.25, {100 * dr:.2f} % dropped: moe_ep "
                        f"against moe_dense on its keep mask, float32 "
                        f"{err32:.3g} (limit {lim32:.3g}), bf16 "
                        f"{err16:.3g} (limit {lim16:.3g})")
                del seen

            with phase("23 (a) moe_ep against moe_dense at dropless "
                       "capacity on layer 0's input (float32, bf16); flash "
                       "at group size 8, hd 128"):
                q32 = qcfg.replace(dtype="float32")
                Ba, Sa = AGREE23
                toks = torch.from_numpy(np.random.default_rng(24).integers(
                    0, qcfg.vocab_size, (Ba, Sa))).to(dev)
                seen = []
                moe0 = lm.moe

                def record(p, h, cfg, mesh=None):
                    if not seen:
                        seen.append(h.detach().clone())
                    return moe0(p, h, cfg, mesh=mesh)

                lm.moe = record
                try:
                    meshed(mesh, lambda: make_prefill_step(q32)(
                        qp, {"tokens": toks}))
                finally:
                    lm.moe = moe0
                err32, lim32, err16, lim16, _ = agree(qp.layers[0].moe,
                                                      seen[0], q32, mesh)
                ep["agree"] = {"f32": err32, "bf16": err16}
                log(f"  layer 0's MoE input from a float32 prefill (B={Ba} "
                    f"S={Sa}), capacity E_pad / top_k = "
                    f"{qcfg.moe.num_experts // K} (no drop): float32 max "
                    f"abs diff {err32:.3g} (limit {lim32:.3g}); bf16 "
                    f"{err16:.3g} (limit {lim16:.3g}: twice the dense "
                    f"lane's own bf16 error)")
                H, Hkv, hd = qcfg.num_heads, qcfg.num_kv_heads, \
                    qcfg.resolved_head_dim
                q, k, v = attn_inputs(B, S, H, Hkv, hd, bf16)
                call = (lambda: fa_kernel.flash_attention_bhsd(
                    q, k, v, group_size=H // Hkv))
                kern = call()
                want = fa_ref.attention_ref(q, k, v, group_size=H // Hkv)
                k_err = (kern.float() - want.float()).abs().max().item()
                torch.testing.assert_close(kern.float(), want.float(),
                                           rtol=2.0 ** -7, atol=1e-3)
                args = (q.view(B, H, S, hd), k.view(B, Hkv, S, hd),
                        v.view(B, Hkv, S, hd))

                def lib():
                    return torch.nn.functional.scaled_dot_product_attention(
                        *args, is_causal=True, enable_gqa=True)

                vs_lib = (kern.float() - lib().float().reshape(
                    B * H, S, hd)).abs().max().item()
                k_ms = cuda_time(call, 5)
                p_ms = cuda_time(lambda: fa_ref.attention_ref(
                    q, k, v, group_size=H // Hkv), 2)
                lib_ms = cuda_time(lib, 5)
                bound_ms, bound_by = attn_bound(B, S, H, Hkv, hd, bf16)
                ep["flash"] = {
                    "shape": f"qwen3-moe-30b-a3b: B={B} S={S} H={H}/{Hkv} "
                             f"hd={hd} bf16 causal (group size {H // Hkv})",
                    "route": "tensor_core_bf16", "ms": k_ms,
                    "plain_ms": p_ms, "library_ms": lib_ms,
                    "library": "scaled_dot_product_attention(enable_gqa="
                               "True, is_causal)",
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "max_abs_err": k_err, "max_abs_vs_library": vs_lib,
                    "launches": ep["launches"],
                    "tflops": 4 * B * H * hd * kept_pairs(S, True, 0)
                    / (k_ms * 1e-3) / 1e12}
                del q, k, v, kern, want, args
                log(f"  flash {ep['flash']} [{card}]")

            with phase("23 (b) qwen3-moe-30b-a3b serving (decode: "
                       "moe_dense)"):
                check(qp is not None, "no weights from (a)")
                r = np.random.default_rng(25)
                prompts = r.integers(0, qcfg.vocab_size, (n_prompts, p_len))
                requests = [r.integers(0, qcfg.vocab_size, r_len)
                            for _ in range(n_req)]
                set_active_mesh(None)       # as launch.serve: dense MoE
                torch.cuda.reset_peak_memory_stats()
                gen = ServeEngine(qcfg, qp, batch=n_prompts,
                                  max_len=128).generate(prompts, n_new)
                sync()
                t0 = time.perf_counter()
                ServeEngine(qcfg, qp, batch=n_prompts, max_len=128) \
                    .generate(prompts, n_new)
                sync()
                s_gen = time.perf_counter() - t0
                t0 = time.perf_counter()
                done = ContinuousBatchingEngine(
                    qcfg, qp, batch=slots, max_len=128).run(requests, r_new)
                sync()
                s_cb = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated()
                check(gen.shape == (n_prompts, n_new) and gen.min() >= 0
                      and gen.max() < qcfg.vocab_size,
                      f"generate gave {gen.shape}")
                check(len(done) == n_req and
                      all(len(t) == r_new for _, t in done),
                      f"continuous batching finished {len(done)} of {n_req}")
                steps = p_len + n_new - 1
                ep["decode_tokens_per_s"] = n_prompts * steps / s_gen
                log(f"  ServeEngine.generate {n_prompts} x {steps} decode "
                    f"steps: {s_gen:.3f} s (second run), "
                    f"{ep['decode_tokens_per_s']:.2f} decode tokens/s; "
                    f"continuous batching {n_req}x({r_len}+{r_new}) over "
                    f"{slots} slots {s_cb:.3f} s, "
                    f"{n_req * r_new / s_cb:.2f} new tokens/s; peak device "
                    f"memory {peak / 2**30:.3f} GiB [{card}]")
            qp = None
            gc.collect()
            torch.cuda.empty_cache()

            with phase(f"23 (c) training qwen3-moe-30b-a3b at full width "
                       f"({TRAIN23_LAYERS} layer) through "
                       f"repro_torch.launch.train, moe_ep at n = 1 "
                       f"(counted)"):
                tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt23_")
                get0 = train_launcher.get_arch
                train_launcher.get_arch = lambda name: get0(name).replace(
                    num_layers=TRAIN23_LAYERS)
                try:
                    argv = ["--arch", "qwen3-moe-30b-a3b", "--steps", "2",
                            "--batch", "1", "--seq", str(TRAIN23_SEQ),
                            "--ckpt-every", "1", "--ckpt-dir", tmp,
                            "--log-every", "1", "--device", "cuda"]
                    for lib in _cuda.LIBS:
                        lib.reset_counts()
                    torch.cuda.reset_peak_memory_stats()
                    t0 = time.perf_counter()
                    with moe_mod.count_drops() as tdrops:
                        run1 = train_launcher.main(argv)
                    sync()
                    s_run1 = time.perf_counter() - t0
                    peak = torch.cuda.max_memory_allocated()
                    t_launch = {lib.name: lib.launches for lib in _cuda.LIBS}
                    hist = run1["history"]
                    check(all(np.isfinite(h["loss"]) and
                              np.isfinite(h["grad_norm"]) for h in hist),
                          f"a loss or grad norm is not finite: {hist}")
                    ln_v = float(np.log(qcfg.vocab_size))
                    check(abs(hist[0]["loss"] - ln_v) < 0.5,
                          f"step 0's loss {hist[0]['loss']:.4f} is not "
                          f"within 0.5 of ln(vocab) {ln_v:.4f}")
                    check(len(tdrops["keep"]) > 0,
                          "moe_ep did not run in the train steps")
                    ckdir = os.path.join(tmp, qcfg.name)
                    shutil.rmtree(os.path.join(ckdir, "step_000000000002"))
                    t0 = time.perf_counter()
                    run2 = train_launcher.main(argv)
                    sync()
                    s_run2 = time.perf_counter() - t0
                    t_launch2 = {lib.name: lib.launches
                                 for lib in _cuda.LIBS}
                    ep["train_launches"] = t_launch2
                    check(run2["start_step"] == 1 and
                          [h["step"] for h in run2["history"]] == [2],
                          "the resumed run did not start from step 1")
                    d_loss = abs(run2["history"][0]["loss"] -
                                 hist[1]["loss"]) / abs(hist[1]["loss"])
                    d_par = max((a - b).abs().max().item() for a, b in zip(
                        run2["params"].parameters(),
                        run1["params"].parameters()))
                    check(d_loss <= 1e-5 and d_par <= 1e-5,
                          f"resumed run differs: loss {d_loss:.3g} "
                          f"relative, weights {d_par:.3g}")
                    check(all(n == 0 for n in t_launch2.values()),
                          f"a kernel of ours launched in the train steps: "
                          f"{t_launch2}")
                    secs = [h["seconds"] for h in hist]
                    ep["train"] = {"step_s": secs, "peak_gib": peak / 2**30}
                    n_par = sum(p.numel() for p in run1["params"].parameters())
                    log(f"  {n_par} parameters ({TRAIN23_LAYERS} layer), "
                        f"B 1 x S {TRAIN23_SEQ}, remat {qcfg.remat}: losses "
                        f"{[round(h['loss'], 4) for h in hist]} (ln vocab "
                        f"{ln_v:.4f}), grad norms "
                        f"{[round(h['grad_norm'], 4) for h in hist]}; "
                        f"moe_ep calls {len(tdrops['keep'])}, choices "
                        f"dropped {tdrops['dropped']} of "
                        f"{tdrops['choices']}; resumed from step 1: loss "
                        f"diff {d_loss:.3g} relative, weights {d_par:.3g}; "
                        f"launches {t_launch} then {t_launch2}")
                    log(f"  step wall time {[round(x, 3) for x in secs]} s "
                        f"({TRAIN23_SEQ / secs[-1]:.1f} tokens/s); runs "
                        f"{s_run1:.2f} s and {s_run2:.2f} s with their "
                        f"init and checkpoints; peak device memory "
                        f"{peak / 2**30:.3f} GiB [{card}]")
                finally:
                    train_launcher.get_arch = get0
                    shutil.rmtree(tmp, ignore_errors=True)
                    run1 = run2 = None
                    gc.collect()
                    torch.cuda.empty_cache()

            with phase("23 (d) granite-moe-3b-a800m's MoE layer at full "
                       "width: moe_ep (n = 1) and moe_dense"):
                gcfg = get_arch("granite-moe-3b-a800m")
                layer = moe_mod.MoE(gcfg, device=dev).reset_parameters(
                    torch.Generator(device=dev).manual_seed(0))
                x = torch.from_numpy(np.random.default_rng(26)
                                     .standard_normal(
                                         (B, S, gcfg.d_model),
                                         dtype=np.float32)).to(dev)
                xb = x.to(bf16)
                with torch.no_grad():
                    with moe_mod.count_drops() as gd:
                        moe_mod.moe_ep(layer, xb, gcfg, mesh)
                    g_ep = cuda_time(lambda: moe_mod.moe_ep(
                        layer, xb, gcfg, mesh), 5)
                    g_dn = cuda_time(lambda: moe_mod.moe_dense(
                        layer, xb, gcfg), 5)
                    b_ep = device_busy(lambda: moe_mod.moe_ep(
                        layer, xb, gcfg, mesh))
                    b_dn = device_busy(lambda: moe_mod.moe_dense(
                        layer, xb, gcfg))
                err32, lim32, err16, lim16, _ = agree(layer, x, gcfg, mesh)
                ep["granite"] = {"moe_ep_ms": g_ep, "moe_dense_ms": g_dn,
                                 "dropped": gd["dropped"] / gd["choices"]}
                log(f"  device busy, granite moe_ep layer: {b_ep} [{card}]")
                log(f"  device busy, granite moe_dense layer: {b_dn} "
                    f"[{card}]")
                log(f"  granite MoE layer B={B} S={S} bf16 "
                    f"({gcfg.moe.num_experts} experts padded to "
                    f"{layer.router.shape[-1]}, top-{gcfg.moe.top_k}): "
                    f"moe_ep {g_ep:.3f} ms, moe_dense {g_dn:.3f} ms "
                    f"({g_dn / g_ep:.2f}x), medians of 5 on CUDA events; "
                    f"choices dropped at 1.25: {gd['dropped']} of "
                    f"{gd['choices']}; dropless against moe_dense: float32 "
                    f"{err32:.3g} (limit {lim32:.3g}), bf16 {err16:.3g} "
                    f"(limit {lim16:.3g}) [{card}]")
                del layer, x, xb
        finally:
            set_active_mesh(None)
            dist.destroy_process_group()
            gc.collect()
            torch.cuda.empty_cache()
        return ep

    # ------------------------------------------------------------ 24
    def dry_phases():
        """Phase 24: (c) a smollm-135m train step and prefill on DTensor
        parameters over an NCCL group of one, (d) four-card FSDP training
        when the machine has four cards, then, with the card idle, the
        host work: (a) the dry run's records, (b) the world-1 roofline
        against this card's measured times.  Returns what the kernel
        record takes from it."""
        import copy

        import torch.distributed as dist

        from repro_torch.distrib.sharding import (batch_spec, device_put,
                                                  param_specs, placements,
                                                  set_active_mesh,
                                                  shardings_for)
        from repro_torch.launch.mesh import init_process_group, make_host_mesh
        from repro_torch.optim.adamw import init_adamw
        from repro_torch.train.step import make_train_step

        out = {}
        with phase("24 (c) smollm-135m on DTensor parameters over an NCCL "
                   "group of one: a train step and a prefill (counted)"):
            check(init_process_group(dev), "a process group was running")
            try:
                mesh = make_host_mesh()
                set_active_mesh(mesh)
                scfg = get_arch("smollm-135m")
                plain = api.init_params(torch.Generator(device=dev)
                                        .manual_seed(0), scfg, device=dev)
                sharded = device_put(copy.deepcopy(plain), shardings_for(
                    mesh, param_specs(plain)))
                check(all(type(p.data).__name__ == "DTensor"
                          for p in sharded.parameters()),
                      "a parameter is not a DTensor")
                B, S = TRAIN24
                g = np.random.default_rng(24)
                toks = torch.from_numpy(g.integers(
                    0, scfg.vocab_size, (B, S + 1)).astype(np.int32)).to(dev)
                batch = {"tokens": toks[:, :-1].contiguous(),
                         "targets": toks[:, 1:].contiguous()}

                def dt(t):
                    from torch.distributed.tensor import DTensor
                    return DTensor.from_local(
                        t, mesh, placements(mesh, batch_spec(mesh, t.dim())))

                dbatch = {k: dt(v) for k, v in batch.items()}

                def three_steps(step, lanes):
                    """Three steps of each lane (name, params, batch) from
                    fresh AdamW states: [(loss, grad norm)] a step, and
                    the median time of steps 2 and 3."""
                    seen, secs = {}, {}
                    for name, params, b in lanes:
                        opt = init_adamw(params)
                        seen[name], t = [], []
                        for i in range(3):
                            sync()
                            t0 = time.perf_counter()
                            # params and the moments change in place; the
                            # state returned holds the next step count
                            _, opt, m = step(params, opt, b)
                            seen[name].append((float(m["loss"]),
                                               float(m["grad_norm"])))
                            sync()
                            if i:
                                t.append(time.perf_counter() - t0)
                        secs[name] = statistics.median(t)
                    return seen, secs

                # bf16 copies of the weights, as launch.train, at a peak lr
                # at which steps 2 and 3 (lr 1e-4 and 2e-4 in the warm-up;
                # step 1's is 0) move the loss.  A third lane, the plain
                # parameters on the batch's rows reversed (the same step
                # in exact arithmetic), shows the rounding spread of the
                # step at this width: the lanes cannot agree closer.
                ctrl = copy.deepcopy(plain)
                got, times = three_steps(
                    make_train_step(scfg, total_steps=10, peak_lr=1e-2),
                    (("plain", plain, batch), ("dtensor", sharded, dbatch),
                     ("control", ctrl, {k: v.flip(0).contiguous()
                                        for k, v in batch.items()})))
                del ctrl

                def diffs(lane):
                    """|lane - plain|: step 1's loss, the grad norms at
                    steps 1 and 3 over the plain lane's, and the move of
                    the loss over the two updates over the plain lane's
                    move."""
                    (l1, g1), _, (l3, g3) = got[lane]
                    (p1, h1), _, (p3, h3) = got["plain"]
                    return (abs(l1 - p1), abs(g1 - h1) / h1,
                            abs(g3 - h3) / h3,
                            abs((l3 - l1) - (p3 - p1)) / abs(p3 - p1))

                (p1, _), _, (p3, _) = got["plain"]
                check(p1 - p3 >= 1e-2, f"two updates moved the loss by "
                      f"{p1 - p3:.3g} only")
                d_dt, d_ctrl = diffs("dtensor"), diffs("control")
                for v, lim, what in zip(d_dt, (1e-5, 1e-3, 1e-3, 1e-2), (
                        "step 1's loss", "step 1's grad norm (relative)",
                        "step 3's grad norm (relative)",
                        "the loss's move over two updates (relative)")):
                    check(v <= lim, f"DTensor against plain: {what} "
                          f"differs by {v:.3g} (limit {lim:g})")
                log(f"  train step B={B} S={S} (bf16 copies), three steps: "
                    f"plain loss {p1:.6f} -> {p3:.6f}; DTensor against "
                    f"plain: step 1's loss {d_dt[0]:.3g} (limit 1e-5), grad "
                    f"norm at steps 1 and 3 {d_dt[1]:.3g}, {d_dt[2]:.3g} "
                    f"relative (limit 1e-3), the loss's move "
                    f"{d_dt[3]:.3g} relative (limit 1e-2); the control lane "
                    f"(rows reversed) against plain: {d_ctrl[0]:.3g}, "
                    f"{d_ctrl[1]:.3g}, {d_ctrl[2]:.3g}, {d_ctrl[3]:.3g}; "
                    f"step time plain {times['plain']:.3f} s, DTensor "
                    f"{times['dtensor']:.3f} s (medians of steps 2 and 3), "
                    f"phase 21 (a)'s launch.train step "
                    f"{late.get('train_smollm', {}).get('step_s', 0):.3f} s "
                    f"[{card}]")
                del sharded, plain
                gc.collect()
                torch.cuda.empty_cache()
                plain = api.init_params(torch.Generator(device=dev)
                                        .manual_seed(1), scfg, device=dev)
                sharded = device_put(copy.deepcopy(plain), shardings_for(
                    mesh, param_specs(plain)))
                pb = {"tokens": toks[:PREFILL24[0], :PREFILL24[1]]
                      .contiguous()}
                pf24 = make_prefill_step(scfg)
                with torch.no_grad():
                    want = pf24(plain, pb).float()
                    for lib in _cuda.LIBS:
                        lib.reset_counts()
                    got = pf24(sharded, {"tokens": dt(pb["tokens"])})
                    sync()
                    launches = {lib.name: lib.launches for lib in _cuda.LIBS}
                    got = got.full_tensor().float()
                err = (got - want).abs().max().item()
                check(launches["flash_attention"] == scfg.num_layers,
                      f"flash launched {launches['flash_attention']} times, "
                      f"not {scfg.num_layers}")
                check(sum(launches.values()) == scfg.num_layers,
                      f"other kernels launched: {launches}")
                check(err <= 1e-2, f"DTensor prefill logits differ by "
                      f"{err:.3g}")
                out["launches"] = launches["flash_attention"]
                out["dtensor_step_s"] = times["dtensor"]
                log(f"  prefill B={PREFILL24[0]} S={PREFILL24[1]} on DTensor "
                    f"parameters: flash "
                    f"launched {launches['flash_attention']} times; last "
                    f"logits against the plain parameters' max abs "
                    f"{err:.3g} [{card}]")
            finally:
                set_active_mesh(None)
                dist.destroy_process_group()
                gc.collect()
                torch.cuda.empty_cache()
        with phase("24 (d) qwen2.5-14b under FSDP over 'data' on four "
                   "cards"):
            if torch.cuda.device_count() < 4:
                log(f"  skipped: {torch.cuda.device_count()} card(s) here; "
                    f"qwen2.5-14b's parameters and AdamW state (14.7e9 x 16 "
                    f"bytes, 236 GB) need four 80 GB cards")
            else:
                import tempfile
                with tempfile.TemporaryDirectory() as tmp:
                    cmd = [sys.executable, "-m", "torch.distributed.run",
                           "--standalone", "--nproc_per_node", "4", "-m",
                           "repro_torch.launch.train", "--arch",
                           "qwen2.5-14b", "--steps", "2", "--batch", "4",
                           "--seq", "512", "--ckpt-every", "100",
                           "--ckpt-dir", tmp, "--log-every", "1"]
                    env = dict(os.environ)
                    env["PYTHONPATH"] = os.path.join(ROOT, "src")
                    r = subprocess.run(cmd, cwd=ROOT, env=env, text=True,
                                       capture_output=True, timeout=900)
                    log(r.stdout[-3000:])
                    check(r.returncode == 0, f"torchrun exited "
                          f"{r.returncode}: {r.stderr[-3000:]}")
        dry_out = os.path.join(ROOT, "reports", "chip_smoke_dryrun")
        with phase(f"24 (a) the dry run: every ARCHS x SHAPES cell on the "
                   f"fake 16 x 16 pod, {len(DRY_MULTIPOD)} on 2 x 16 x 16 "
                   f"(budget {DRY_BUDGET_S} s)"):
            took, codes = run_dry_runs(dry_out)
            log(f"  dry run done in {took:.1f} s (output in {dry_out})")
            for name, code in codes.items():
                check(code == 0, f"{name} "
                      + ("passed the budget" if code is None else
                         f"exited {code}")
                      + f": see {dry_out}/{name.replace(' ', '_')}.log")
            ok = skipped = 0
            for mesh in ("pod", "multipod"):
                d = os.path.join(dry_out, mesh)
                for fn in sorted(os.listdir(d)):
                    with open(os.path.join(d, fn)) as f:
                        rec = json.load(f)
                    if rec["status"] == "skipped":
                        skipped += 1
                        continue
                    check(rec["status"] == "ok", f"{fn}: {rec['status']} "
                          f"{rec.get('error')}")
                    ok += 1
                    mem, roof = rec["memory"], rec.get("roofline", {})
                    coll = {k: f"{v / 1e9:.3f}" for k, v in
                            rec["raw_cost"]["collectives"].items()}
                    mf = roof.get("model_flops")
                    ratio = (f"{roof['hlo_flops_cluster'] / mf:.3f}"
                             if mf else "-")
                    log(f"  {fn[:-5]:48s} {rec['status']} "
                        f"{mem['per_device_gb']:.3f} GB/device fits_80gb_hbm"
                        f"={mem['fits_80gb_hbm']} dominant="
                        f"{roof.get('dominant', '-')} counted/model FLOPs="
                        f"{ratio} collectives GB={coll} "
                        f"({rec['compile_s']} s)")
            check(ok == 32 + len(DRY_MULTIPOD) and skipped == 8,
                  f"{ok} cells ok, {skipped} skipped")
            out["dry_s"] = took
        with phase("24 (b) the roofline at world 1 against this card's "
                   "times (smollm-135m)"):
            with open(os.path.join(dry_out, "world1.json")) as f:
                w1 = json.load(f)
            measured = {"prefill": pf_ms / 1e3,
                        "train": late.get("train_smollm", {}).get("step_s")}
            for key, what in (("prefill", "prefill B 4 x S 4096 (phase 11)"),
                              ("train", "train step B 8 x S 2048 (phase 21 "
                                        "(a))")):
                rec = w1[key]
                check(rec["status"] == "ok", f"{key}: {rec.get('error')}")
                roof = rec["roofline"]
                dom = roof[roof["dominant"] + "_s"]
                got = measured[key]
                check(got is not None, f"no measured time for {key}")
                log(f"  {what}: measured {1e3 * got:.3f} ms; roofline "
                    f"compute {1e3 * roof['compute_s']:.3f} ms, memory "
                    f"{1e3 * roof['memory_s']:.3f} ms, collective "
                    f"{1e3 * roof['collective_s']:.3f} ms; dominant "
                    f"{roof['dominant']}: measured / dominant = "
                    f"{got / dom:.3f} [{card}]")
                out[key + "_over_dominant"] = got / dom
        return out

    # ---------------------------------------------------------------- 2
    with phase("2 kernels vs plain versions (synthetic inputs)"):
        # kernel 1: seeded random chains and edges, exported like a real
        # graph (see synthetic_chain_graph)
        n, args = synthetic_chain_graph(rng)
        arr = sparse.to_device(export_chain_flat(*args, neg=sparse.NEG), dev)
        D2 = torch.from_numpy(rng.integers(1, 9, size=(256, 6))
                              .astype(np.int32)).to(dev)
        got = sparse.solve_chains(arr, D2)
        want = ref.solve_chains_ref(arr, D2)
        same_solve(got, want)
        check(want[2] <= got[2] < want[2] + _cuda.CHECK_CAP,
              f"kernel launched {got[2]} rounds, plain needed {want[2]}")
        log(f"  kernel 1: n={n} E={arr.raw_dst.shape[0]} K=256 rounds={got[2]} "
            f"converged={int(got[1].sum())}/256, equal to plain")
        # kernel 2: one sweep on a random batch
        A2 = rng.integers(-8, 8, size=(4, 2048, 2048)).astype(np.int32)
        A2[rng.random(A2.shape) < 0.5] = kernel.NEG
        t2 = rng.integers(-99, 99, size=(4, 2048)).astype(np.int32)
        b2 = rng.integers(-99, 99, size=2048).astype(np.int32)
        A2, t2, b2 = (torch.from_numpy(x).to(dev) for x in (A2, t2, b2))
        s_k = kernel.maxplus_sweep(A2, t2, b2)
        s_p = ref.maxplus_sweep_ref(A2, t2, b2)
        check(torch.equal(s_k, s_p), "dense sweep differs from plain")
        log("  kernel 2: [4, 2048, 2048] sweep equal to plain")

    # ------------------------------------------------ main path (3 - 6)
    designs = {}
    design_fns = {"skynet": skynet_like, "matmul": matmul_stream,
                "msort8": lambda: merge_sort_staged(8), "fig4_ex5": fig4_ex5,
                "msort6": merge_sort_staged}
    # the initial simulation each design takes, as in the reference: the
    # blocking designs compiled replay; fig4_ex5 the hybrid replay
    want_engine = {"skynet": "omnisim-trace", "matmul": "omnisim-trace",
                   "msort8": "omnisim-trace", "fig4_ex5": "omnisim-hybrid",
                   "msort6": "omnisim-trace"}
    for lib in _cuda.LIBS:
        lib.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with phase("main path: simulate + compile"):
        for key, build in design_fns.items():
            t0 = time.perf_counter()
            res = simulate(build())
            g = compile_graph(res.graph)
            designs[key] = (res, g)
            log(f"  {key}: engine {res.engine} n={g.n} fifos={len(g.fifos)} "
                f"cycles={res.cycles} ({time.perf_counter() - t0:.2f} s)")
            check(res.engine == want_engine[key], f"{key}: engine "
                  f"{res.engine}, want {want_engine[key]}")

    def pingpong():
        prog = Program("burst_pingpong", declared_type="A")
        cmd = prog.fifo("cmd", 8)
        resp = prog.fifo("resp", 8)

        @prog.module("ctrl")
        def ctrl():
            for i in range(8):
                yield Write(cmd, i)
            tot = 0
            for _ in range(8):
                tot += (yield Read(resp))
            yield Emit("sum", tot)

        @prog.module("proc")
        def proc():
            for _ in range(8):
                v = yield Read(cmd)
                yield Write(resp, 2 * v)

        return prog

    if FAILURES:
        return 1

    def rows(key, K, hi):
        return rng.integers(1, hi + 1, size=(K, len(designs[key][0].depths)))

    Dm = {"skynet": rows("skynet", 4096, 16),
          "matmul": rows("matmul", 1024, 8),
          "msort8": rows("msort8", 1024, 8),
          "fig4_ex5": rows("fig4_ex5", 128, 8),
          "pingpong": np.array([(1, 1), (2, 2), (1, 8), (8, 1), (4, 4),
                                (8, 8)]),
          "msort6": rows("msort6", 64, 8)}
    pp_res = simulate(pingpong())

    def run3():
        return solve_block_status(designs["skynet"][1], Dm["skynet"],
                                  backend="cuda", device=dev)

    def run4m():
        return solve_block_status(designs["matmul"][1], Dm["matmul"],
                                  backend="cuda", device=dev)

    def run4s():
        return solve_block_status(designs["msort8"][1], Dm["msort8"],
                                  backend="cuda", device=dev)

    def run5f():
        return resimulate_batch(designs["fig4_ex5"][0], Dm["fig4_ex5"],
                                backend="cuda", device=dev)

    def run5p():
        return resimulate_batch(pp_res, Dm["pingpong"], backend="cuda",
                                device=dev)

    def run6d():
        return resimulate_batch(designs["msort6"][0], Dm["msort6"],
                                backend="cuda_dense", device=dev)

    def run6f():
        return ops.finalize_times(designs["msort6"][0].graph.graph,
                                  device=dev)

    calls = {"3 skynet_like K=4096": run3,
             "4 matmul_stream K=1024": run4m,
             "4 merge_sort_staged(8) K=1024": run4s,
             "5 fig4_ex5 K=128 fallback": run5f,
             "5 burst_pingpong K=6": run5p,
             "6 merge_sort_staged() K=64 dense": run6d,
             "6 finalize_times merge_sort_staged()": run6f}
    out, first_s = {}, {}
    with phase("main path: device re-solves (counted)"):
        for name, fn in calls.items():
            t0 = time.perf_counter()
            out[name] = fn()
            sync()
            first_s[name] = time.perf_counter() - t0
            log(f"  {name}: {first_s[name]:.3f} s")
    launches = {lib.name: lib.launches for lib in _cuda.LIBS}
    peak_bytes = torch.cuda.max_memory_allocated()
    log(f"launches on the main path: {launches}")
    if FAILURES or len(out) != len(calls):
        return 1

    with phase("3 skynet_like K=4096 vs plain (all rows) and numpy (64)"):
        g, D = designs["skynet"][1], Dm["skynet"]
        st = out["3 skynet_like K=4096"]
        with plain_kernels():
            same_status(st, solve_block_status(g, D, backend="cuda",
                                               device=dev), "plain")
        same_status([x[:64] for x in st[:3]],
                    solve_block_status(g, D[:64], backend="numpy"), "numpy")
        log(f"  status counts {np.bincount(st[0], minlength=4).tolist()} "
            f"cycles {sorted(set(st[1].tolist()))[:6]}")

    with phase("4 matmul_stream / merge_sort_staged(8) K=1024 vs plain "
               "and numpy"):
        for key, name, n_np in (("matmul", "4 matmul_stream K=1024", 16),
                                ("msort8", "4 merge_sort_staged(8) K=1024",
                                 64)):
            g, D = designs[key][1], Dm[key]
            st = out[name]
            with plain_kernels():
                same_status(st, solve_block_status(g, D, backend="cuda",
                                                   device=dev), key)
            same_status([x[:n_np] for x in st[:3]],
                        solve_block_status(g, D[:n_np], backend="numpy"),
                        key + " numpy")
            log(f"  {key}: rounds {st[3]}, status counts "
                f"{np.bincount(st[0], minlength=4).tolist()}, "
                f"{len(set(st[1].tolist()))} distinct cycle counts")

    with phase("5 verdicts + fallback vs numpy"):
        o = out["5 fig4_ex5 K=128 fallback"]
        check(int((o.status == dse.VIOLATED).sum()) > 0, "no VIOLATED rows")
        same_outcome(o, resimulate_batch(designs["fig4_ex5"][0],
                                         Dm["fig4_ex5"], backend="numpy"),
                     "fig4_ex5")
        check(pp_res.engine == "omnisim-trace",
              f"ping-pong base run took {pp_res.engine}")
        p = out["5 burst_pingpong K=6"]
        check(p.status[:2].tolist() == [dse.CYCLE] * 2,
              f"ping-pong rows 0-1 not CYCLE: {p.status}")
        same_outcome(p, resimulate_batch(pp_res, Dm["pingpong"],
                                         backend="numpy"), "pingpong")
        log(f"  fig4_ex5 status counts "
            f"{np.bincount(o.status, minlength=4).tolist()}; ping-pong "
            f"(base run {pp_res.engine}) {p.status.tolist()}")

    with phase("6 dense lane vs numpy; finalize_times vs numpy"):
        o = out["6 merge_sort_staged() K=64 dense"]
        same_outcome(o, resimulate_batch(designs["msort6"][0], Dm["msort6"],
                                         backend="numpy"), "msort6 dense")
        sg = designs["msort6"][0].graph.graph
        want = longest_path_numpy(*sg.to_csr())
        check(np.array_equal(out["6 finalize_times merge_sort_staged()"]
                             .cpu().numpy(), want), "finalize_times differs")
        log(f"  status counts {np.bincount(o.status, minlength=4).tolist()}")

    with phase("launch counts"):
        for name in ("maxplus_sparse", "maxplus_dense"):
            check(launches[name] > 0, f"kernel {name} was not launched on "
                  f"the simulator's main path")

    # ---------------------------------------------------------------- 7
    kernels = []
    walls7 = {}
    with phase("7 timings"):
        for name, fn in calls.items():
            walls = walls7[name] = []
            for _ in range(3):
                t0 = time.perf_counter()
                fn()
                sync()
                walls.append(time.perf_counter() - t0)
            log(f"  wall {name}: median {statistics.median(walls):.4f} s "
                f"(first {first_s[name]:.4f} s) [{card}]")
        log(f"  peak device memory on the main path: "
            f"{peak_bytes / 2**30:.3f} GiB [{card}]")

        # kernel 1 at the shapes of phases 3 and 4
        by_shape = []
        k1_rows = {}
        for key, K_label in (("matmul", "matmul_stream K=1024"),
                             ("msort8", "merge_sort_staged(8) K=1024"),
                             ("skynet", "skynet_like K=4096")):
            g, D = designs[key][1], Dm[key]
            ba = dse._batch_arrays(g)
            Da = D[~(D < ba.fifo_need[None, :]).any(axis=1)]
            arr = dse._sparse_arrays(ba, dev)
            Dt = torch.from_numpy(np.minimum(Da, 1 << 30).astype(np.int32)
                                  ).to(dev)
            res = {}
            k_ms = cuda_time(lambda: res.__setitem__(
                "k", sparse.solve_chains(arr, Dt)), 3)
            # one run of the plain version, no warm-up (it takes up to
            # ~35 s a call here)
            p_ms = cuda_time(lambda: res.__setitem__(
                "p", ref.solve_chains_ref(arr, Dt)), 1, warm_up=False)
            err = same_solve(res["k"], res["p"])
            # the plain version stops at the first round that changes
            # nothing; the kernel's loop launches more (flag read per batch)
            rounds, launched, K = res["p"][2], res["k"][2], Dt.shape[0]
            check(rounds <= launched < rounds + _cuda.CHECK_CAP,
                  f"kernel launched {launched} rounds, plain needed {rounds}")
            E, m = arr.raw_dst.shape[0], arr.war_dst.shape[0]
            bytes_ = 4 * K * (2 * g.n + 2 * (E + m)) * rounds
            bound_ms = bytes_ / HBM_BYTES_PER_S * 1e3
            by_shape.append({
                "shape": f"{K_label} (n={g.n}, E={E}, m={m}, K={K}, "
                         f"{arr.seg_lo.shape[0]} segments of <= "
                         f"{int((arr.seg_hi - arr.seg_lo).max())} nodes)",
                "rounds": rounds, "launched": launched, "ms": k_ms,
                "plain_ms": p_ms, "bound_ms": bound_ms,
                "us_per_round": 1e3 * k_ms / launched,
                "bound_us_per_round": 1e3 * bound_ms / rounds,
                "max_abs_err": err})
            k1_rows[key] = by_shape[-1]
            log(f"  kernel 1 {by_shape[-1]} [{card}]")
            if key == "matmul":
                log(f"  device busy, one matmul_stream solve: "
                    f"{device_busy(lambda: sparse.solve_chains(arr, Dt))} "
                    f"[{card}]")
        top = by_shape[0]
        kernels.append({
            "name": "maxplus_sparse_fixpoint", "route": "cuda",
            "source": "src/repro_torch/csrc/maxplus_sparse.cu",
            "replaces": "src/repro/kernels/maxplus/sparse.py:140",
            "launches": launches["maxplus_sparse"],
            "max_abs_err": max(s["max_abs_err"] for s in by_shape),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "shape": top["shape"],
            "design": "segmented chain pass: (segment, 4 configs) threads "
                      "in two launches, then an (edge, 4 configs) cross "
                      "pass; int4 loads",
            "rounds": top["rounds"], "launched": top["launched"],
            "by_shape": by_shape})

        # kernel 2 at the shape of phase 6, and the synthetic batch
        by_shape = []
        g6, D6 = designs["msort6"][1], Dm["msort6"]
        n6 = g6.n
        A6, b6 = dse._dense_skeleton(g6, dev)
        AK = dse._dense_adjacency(g6, A6, D6)
        res = {}
        k_ms = cuda_time(lambda: res.__setitem__(
            "k", ops.longest_path(AK, b6)), 3)
        with plain_kernels():
            p_ms = cuda_time(lambda: res.__setitem__(
                "p", ops.longest_path(AK, b6)), 1)
        check(torch.equal(res["k"], res["p"]), "dense fixpoint differs")
        # sweeps the loop launched, by the kernel's counter
        before = _cuda.DENSE.launches
        ops.longest_path(AK, b6)
        sync()
        launched = _cuda.DENSE.launches - before
        # sweeps the fixpoint needs: up to and including the first that
        # changes nothing, with the flag read after every sweep
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        t6 = b6.expand(AK.shape[:-1]).contiguous()
        for sweeps in range(1, n6 + 1):
            t6 = kernel.maxplus_sweep(AK, t6, b6, flag)
            if not int(flag.item()):
                break
        check(torch.equal(t6, res["k"]), "stepped dense fixpoint differs")
        K6 = len(D6)
        sweep_bytes = 4 * (K6 * n6 * n6 + 2 * K6 * n6 + n6)
        by_shape.append({
            "shape": f"merge_sort_staged() K=64 fixpoint (N={n6})",
            "sweeps": sweeps, "launched": launched, "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": sweep_bytes * sweeps / HBM_BYTES_PER_S * 1e3,
            "max_abs_err": int((res["k"].long() - res["p"].long()).abs()
                               .max())})
        log(f"  kernel 2 {by_shape[-1]} [{card}]")
        s_ms = cuda_time(lambda: kernel.maxplus_sweep(A2, t2, b2), 10)
        sp_ms = cuda_time(lambda: ref.maxplus_sweep_ref(A2, t2, b2), 3)
        by_shape.append({
            "shape": "random [4, 2048, 2048] one sweep", "sweeps": 1,
            "launched": 1, "ms": s_ms, "plain_ms": sp_ms,
            "bound_ms": 4 * (4 * 2048 * 2048 + 2 * 4 * 2048 + 2048)
            / HBM_BYTES_PER_S * 1e3, "max_abs_err": 0})
        log(f"  kernel 2 {by_shape[-1]} [{card}]")
        top = by_shape[0]
        kernels.append({
            "name": "maxplus_dense_sweep", "route": "cuda",
            "source": "src/repro_torch/csrc/maxplus_dense.cu",
            "replaces": "src/repro/kernels/maxplus/kernel.py:58",
            "launches": launches["maxplus_dense"],
            "max_abs_err": max(s["max_abs_err"] for s in by_shape),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "shape": top["shape"],
            "design": "one warp per output row, t staged in shared memory",
            "sweeps": top["sweeps"], "launched": top["launched"],
            "by_shape": by_shape})

    # ---------------------------------------------------------------- 8
    # (name, B, S, H, Hkv, hd, dtype, window, softcap, rtol, atol)
    # bf16 (the tensor-core route): the kernel rounds P to bf16 before P.V,
    # which perturbs each weight by at most 2^-9 relative and moves a row
    # over n keys by ~2^-9 / sqrt(n / e) of its v rows' spread: ~3e-5 at
    # 4 096 keys, ~1e-4 at 256.  Below 256 keys a row, and on the tiles
    # that cross a mask bound, it splits P into bf16 high and low parts
    # (~2^-17).  Kernel and plain version both round the f32 result to
    # bf16 once, so an output may land on the neighbouring bf16 value: one
    # bf16 step, 2^-7 relative, or 1e-3 absolute near 0.
    # f32 (the FMA route): the two sum in another order: 2e-5.
    shapes8 = [
        ("a smollm-135m", 4, 4096, 9, 3, 64, torch.bfloat16, 0, 0.0,
         2.0 ** -7, 1e-3),
        ("b gemma2-2b", 1, 8192, 8, 4, 256, torch.bfloat16, 4096, 50.0,
         2.0 ** -7, 1e-3),
        ("c f32 ragged", 2, 1000, 6, 2, 32, torch.float32, 0, 0.0,
         2e-5, 2e-5),
        ("d granite-moe-3b-a800m", 2, 2048, 24, 8, 64, torch.bfloat16, 0,
         0.0, 2.0 ** -7, 1e-3),
        ("e hymba-1.5b", 2, 2048, 25, 5, 64, torch.bfloat16, 1024, 0.0,
         2.0 ** -7, 1e-3),
        ("f internvl2-1b", 2, 2304, 14, 2, 64, torch.bfloat16, 0, 0.0,
         2.0 ** -7, 1e-3),
    ]
    flash_err = {}
    with phase("8 flash kernel vs plain version (seeded inputs)"):
        for name, B, S, H, Hkv, hd, dt, w, cap, rtol, atol in shapes8:
            q, k, v = attn_inputs(B, S, H, Hkv, hd, dt)
            route = ("tensor_core_bf16" if dt == torch.bfloat16
                     else "fma_f32")
            before = dict(_cuda.FLASH.route_launches)
            got = fa_kernel.flash_attention_bhsd(
                q, k, v, window=w, softcap=cap, group_size=H // Hkv)
            sync()
            check(_cuda.FLASH.route_launches == {
                r: n + (r == route) for r, n in before.items()},
                f"({name}) did not take the {route} route: "
                f"{before} -> {_cuda.FLASH.route_launches}")
            want = fa_ref.attention_ref(q, k, v, window=w, softcap=cap,
                                        group_size=H // Hkv)
            err = (got.float() - want.float()).abs().max().item()
            flash_err[name] = err
            torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                       atol=atol)
            log(f"  ({name}) B={B} S={S} H={H}/{Hkv} hd={hd} {dt} "
                f"window={w} softcap={cap}, {route} route: max abs err "
                f"{err:.3g} (rtol {rtol:.3g}, atol {atol:.3g})")
            del q, k, v, got, want

    # ------------------------------------------- LM main path (9 - 10)
    cfg = get_arch("smollm-135m")
    lm_out = {}
    with phase("LM main path: smollm-135m prefill + serving (counted)"):
        t0 = time.perf_counter()
        params = api.init_params(0, cfg, device=dev)
        log(f"  {cfg.name}: {sum(p.numel() for p in params.parameters())} "
            f"parameters, {cfg.num_layers} layers, d_model {cfg.d_model}, "
            f"heads {cfg.num_heads}/{cfg.num_kv_heads}, dtype {cfg.dtype} "
            f"(init {time.perf_counter() - t0:.2f} s)")
        toks9 = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                              (4, 4096))).to(dev)
        prompts10 = rng.integers(0, cfg.vocab_size, (8, PROMPT10))
        requests10 = [rng.integers(0, cfg.vocab_size, REQ10)
                      for _ in range(12)]
        prefill = make_prefill_step(cfg)
        sync()
        for lib in _cuda.LIBS:
            lib.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        lm_out["prefill"] = prefill(params, {"tokens": toks9})
        sync()
        lm_out["prefill_s"] = time.perf_counter() - t0
        lm_out["prefill_peak"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        lm_out["generate"] = ServeEngine(cfg, params, batch=8,
                                         max_len=256).generate(prompts10,
                                                               GEN10)
        sync()
        lm_out["generate_s"] = time.perf_counter() - t0
        cb = ContinuousBatchingEngine(cfg, params, batch=8, max_len=512)
        t0 = time.perf_counter()
        lm_out["cb"] = cb.run(requests10, REQ_GEN10)
        sync()
        lm_out["cb_s"] = time.perf_counter() - t0
        lm_out["serve_peak"] = torch.cuda.max_memory_allocated()
        lm_launches = {lib.name: lib.launches for lib in _cuda.LIBS}
        lm_routes = dict(_cuda.FLASH.route_launches)
        log(f"  prefill B=4 S=4096: {lm_out['prefill_s']:.3f} s (first "
            f"call); generate 8x({PROMPT10}+{GEN10}): "
            f"{lm_out['generate_s']:.3f} s; continuous batching "
            f"12x({REQ10}+{REQ_GEN10}) over 8 slots: "
            f"{lm_out['cb_s']:.3f} s")
        log(f"launches on the LM path: {lm_launches}; flash routes "
            f"{lm_routes}")
        check(lm_launches["flash_attention"] == cfg.num_layers,
              f"flash kernel launched {lm_launches['flash_attention']} "
              f"times in one prefill, not once per layer "
              f"({cfg.num_layers})")
        check(lm_routes["tensor_core_bf16"] == cfg.num_layers,
              f"the bf16 prefill took the tensor-core route "
              f"{lm_routes['tensor_core_bf16']} times, not "
              f"{cfg.num_layers}")

    lm_err = {}
    if "prefill" in lm_out:
        with phase("9 prefill step vs plain version (bf16 and float32)"):
            got = lm_out["prefill"].float()
            vp = params.embed.shape[0]
            check(tuple(got.shape) == (4, vp) and
                  bool(torch.isfinite(got).all()), f"prefill logits not "
                  f"finite or of shape (4, {vp})")
            with plain_kernels():
                want = prefill(params, {"tokens": toks9}).float()
            # bf16 activations through 30 layers: each layer's attention
            # output may round to a neighbouring bf16 value (one step,
            # 2^-7 relative), and the residual stream carries it on; a
            # 30-layer, d_model-192 rehearsal on the CPU differed by 1.6e-2
            # on logits of magnitude ~1.  Allowed: 0.1 absolute.
            lm_err["bf16"] = (got - want).abs().max().item()
            check(lm_err["bf16"] <= 0.1, f"bf16 prefill logits differ by "
                  f"{lm_err['bf16']:.3g} > 0.1")
            log(f"  bf16: max abs diff {lm_err['bf16']:.3g} (max |logit| "
                f"{want.abs().max().item():.3g}; argmax agree "
                f"{bool(torch.equal(got.argmax(-1), want.argmax(-1)))})")
            cfg32 = cfg.replace(dtype="float32")
            prefill32 = make_prefill_step(cfg32)
            got32 = prefill32(params, {"tokens": toks9})
            with plain_kernels():
                want32 = prefill32(params, {"tokens": toks9})
            # float32 throughout: summation order only, 1e-3 absolute
            lm_err["f32"] = (got32 - want32).abs().max().item()
            check(lm_err["f32"] <= 1e-3, f"f32 prefill logits differ by "
                  f"{lm_err['f32']:.3g} > 1e-3")
            log(f"  float32: max abs diff {lm_err['f32']:.3g}")
            del got, want, got32, want32

        with phase("10 serving outputs; prefill vs decode (float32)"):
            gen = lm_out["generate"]
            check(gen.shape == (8, GEN10) and gen.min() >= 0
                  and gen.max() < cfg.vocab_size, f"generate gave "
                  f"{gen.shape}, ids {gen.min()}..{gen.max()}")
            done = lm_out["cb"]
            check(len(done) == 12 and all(len(t) == REQ_GEN10
                                          for _, t in done),
                  f"continuous batching finished {len(done)} of 12 "
                  f"requests, lengths {[len(t) for _, t in done]}")
            check({s for s, _ in done} == set(range(8)),
                  "not every slot served a request")
            # the decode path keeps K/V in bf16 (as the reference does);
            # the reference's own test_decode_matches_forward_dense holds
            # the two to 2e-2, and so does this, at 30 layers
            cfg32 = cfg.replace(dtype="float32")
            prompt = prompts10[:2]
            full = make_prefill_step(cfg32)(
                params, {"tokens": torch.from_numpy(prompt).to(dev)})
            step, _ = ServeEngine(cfg32, params, batch=2,
                                  max_len=128).prefill(prompt)
            lm_err["decode"] = (full - step[:, 0]).abs().max().item()
            check(lm_err["decode"] <= 2e-2, f"prefill and decode logits "
                  f"differ by {lm_err['decode']:.3g} > 2e-2")
            log(f"  generate {gen.shape}; continuous batching "
                f"{len(done)} requests, slots "
                f"{[s for s, _ in done]}; prefill vs decode max abs diff "
                f"{lm_err['decode']:.3g} (max |logit| "
                f"{full.abs().max().item():.3g})")

    # --------------------------------------------------------------- 11
    def sdpa(q, k, v, B, H, Hkv):
        """The yardstick: one PyTorch call on the same tensors."""
        S, hd = q.shape[1:]
        return torch.nn.functional.scaled_dot_product_attention(
            q.view(B, H, S, hd), k.view(B, Hkv, S, hd),
            v.view(B, Hkv, S, hd), is_causal=True, enable_gqa=True)

    def decode5():
        """Five decode steps of 8 sequences, as ServeEngine runs them."""
        cache = api.init_cache(cfg, 8, 256, device=dev)
        tok = torch.zeros(8, 1, dtype=torch.int32, device=dev)
        for _ in range(5):
            _, cache = api.decode_step(params, tok, cache, cfg)

    with phase("11 timings"):
        by_shape = []
        for label, B, S, plain_fits in (("a smollm-135m", 4, 4096, True),
                                        ("prefill_32k", 1, 32768, False)):
            H, Hkv, hd, dt = 9, 3, 64, torch.bfloat16
            q, k, v = attn_inputs(B, S, H, Hkv, hd, dt)
            call = (lambda: fa_kernel.flash_attention_bhsd(
                q, k, v, group_size=H // Hkv))
            k_ms = cuda_time(call, 5 if plain_fits else 3)
            lib_ms = cuda_time(lambda: sdpa(q, k, v, B, H, Hkv), 5)
            vs_lib = (call().float() - sdpa(q, k, v, B, H, Hkv).float()
                      .view(B * H, S, hd)).abs().max().item()
            p_ms = err = None
            if plain_fits:
                p_ms = cuda_time(lambda: fa_ref.attention_ref(
                    q, k, v, group_size=H // Hkv), 2)
                err = flash_err["a smollm-135m"]
            bound_ms, bound_by = attn_bound(B, S, H, Hkv, hd, dt)
            by_shape.append({
                "shape": f"{label}: B={B} S={S} H={H}/{Hkv} hd={hd} bf16 "
                         f"causal", "route": "tensor_core_bf16",
                "ms": k_ms, "plain_ms": p_ms,
                "library_ms": lib_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "max_abs_err": err,
                "max_abs_vs_library": vs_lib,
                "tflops": 4 * B * H * hd * kept_pairs(S, True, 0)
                / (k_ms * 1e-3) / 1e12})
            log(f"  flash {by_shape[-1]} [{card}]")
            del q, k, v
        # the counted runs of phase 9-10 were the warm-up of each call
        pf = make_prefill_step(cfg)
        pf_ms = cuda_time(lambda: pf(params, {"tokens": toks9}), 3,
                          warm_up=False)
        gen_ms = cuda_time(lambda: ServeEngine(
            cfg, params, batch=8, max_len=256).generate(prompts10, GEN10),
            SERVE_REPS, warm_up=False)
        cb_ms = cuda_time(lambda: ContinuousBatchingEngine(
            cfg, params, batch=8, max_len=512).run(requests10, REQ_GEN10),
            SERVE_REPS, warm_up=False)
        steps = PROMPT10 + GEN10 - 1   # decode steps of generate()
        log(f"  prefill step smollm-135m B=4 S=4096 bf16: median "
            f"{pf_ms:.3f} ms of 3 (first {1e3 * lm_out['prefill_s']:.3f} "
            f"ms), peak device memory "
            f"{lm_out['prefill_peak'] / 2**30:.3f} GiB [{card}]")
        log(f"  ServeEngine.generate 8 x {steps} decode steps: median "
            f"{gen_ms:.3f} ms of {SERVE_REPS} (first "
            f"{1e3 * lm_out['generate_s']:.3f} "
            f"ms), {8 * steps / (gen_ms / 1e3):.2f} decode tokens/s "
            f"({8 * GEN10 / (gen_ms / 1e3):.2f} new tokens/s) [{card}]")
        log(f"  continuous batching 12 requests: median {cb_ms:.3f} ms of "
            f"{SERVE_REPS} "
            f"(first {1e3 * lm_out['cb_s']:.3f} ms), "
            f"{12 * REQ_GEN10 / (cb_ms / 1e3):.2f} new tokens/s; peak device "
            f"memory serving {lm_out['serve_peak'] / 2**30:.3f} GiB "
            f"[{card}]")
        for name, fn in (("prefill step", lambda: pf(
                params, {"tokens": toks9})), ("5 decode steps", decode5)):
            log(f"  device busy, {name}: {device_busy(fn)} [{card}]")
        top = by_shape[0]
        kernels.append({
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:104",
            "launches": lm_launches["flash_attention"],
            "max_abs_err": max(flash_err.values()),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"], "shape": top["shape"],
            "design": "tensor-core mma.sync bf16 (FA2 schedule, cp.async "
                      "double buffer); f32 inputs: f32 FMA",
            "routes": lm_routes,
            "by_shape": by_shape, "prefill_logits_err": lm_err})

    # --------------------------------------------------------------- 12
    def mlstm_inputs(BH, S, P, Pv, gate_bias=1.0):
        """Seeded f32 q [BH, S, P] (scaled by 1/sqrt(P), as the model
        scales it), k [BH, S, P], v [BH, S, Pv], ig (a sigmoid) and la (a
        log-sigmoid, <= 0, of a normal plus ``gate_bias``) [BH, S], on the
        card.  Bias 1 keeps exp(-100) of the state over a chunk of 256;
        bias 8 keeps ~exp(-0.09), as a forget gate that remembers."""
        q = rng.standard_normal((BH, S, P), dtype=np.float32) / np.sqrt(P)
        k = rng.standard_normal((BH, S, P), dtype=np.float32)
        v = rng.standard_normal((BH, S, Pv), dtype=np.float32)
        g = rng.standard_normal((2, BH, S), dtype=np.float32)
        ig = 1 / (1 + np.exp(-g[0]))
        la = -np.logaddexp(0, -(g[1] + gate_bias))
        return [torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
                for x in (q, k, v, ig, la)]

    def mlstm_bound(BH, S, P, Pv, chunk):
        """(bound ms, bound_by, FLOPs): the FLOPs the readout needs at the
        TF32 tensor-core rate, or q, k, v, ig, la read and y written once
        at HBM rate, whichever is longer.  Per head: in every chunk the two
        masked products over the c(c+1)/2 pairs s <= t, c(c+1)(P + Pv);
        the carried state's readout 2cP Pv in chunks 1.. (chunk 0 reads a
        zero state) and its update 2cP Pv in chunks ..nC-2 (the state
        after the last chunk is not returned)."""
        nC = S // chunk
        flops = BH * (nC * chunk * (chunk + 1) * (P + Pv)
                      + 2 * (nC - 1) * 2 * chunk * P * Pv)
        nbytes = 4 * BH * S * (2 * P + 2 * Pv + 2)
        t_ops, t_bytes = flops / TF32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes", flops)

    # (name, B, S, H, P, Pv, chunk).  f32 throughout: the chunked kernel and
    # the direct O(S^2) plain version sum in another order, so the
    # reference's own 2e-4, relative to the readout's largest |y|.
    shapes12 = [("a xlstm-1.3b", 4, 2048, 4, 1024, 1025, 256),
                ("b odd widths", 2, 256, 3, 64, 65, 32),
                ("c one chunk", 2, 200, 4, 1024, 1025, 200)]
    mlstm_err = {}
    with phase("12 mlstm kernel vs plain version (seeded inputs)"):
        for name, B, S, H, P, Pv, chunk in shapes12:
            xs = mlstm_inputs(B * H, S, P, Pv)
            got = mc_kernel.mlstm_chunk_bhsd(*xs, chunk=chunk)
            sync()
            want = mc_ref.mlstm_ref(*xs)
            scale = max(1.0, want.abs().max().item())
            err = (got - want).abs().max().item()
            mlstm_err[name] = err
            check(bool(torch.isfinite(got).all()) and err <= 2e-4 * scale,
                  f"mlstm ({name}): max abs err {err:.3g} > 2e-4 x {scale:.3g}")
            log(f"  ({name}) B={B} S={S} H={H} P={P} Pv={Pv} chunk={chunk} "
                f"f32: max abs err {err:.3g} (max |y| {scale:.3g}, allowed "
                f"{2e-4 * scale:.3g})")
            del xs, got, want
        # (d) prefill_32k, the state carried over 128 chunks.  The plain
        # reference is the chunked scan (the O(S^2) version would need a
        # [4, 32768, 32768] score tensor): f32 with TF32 off, summing in
        # another order than the kernel, whose products carry the bf16
        # split's ~2^-16 relative error; the same 2e-4 x max |y|.  The
        # readout grows to |y| ~ 100 where the state is kept
        B, S, H, P, Pv, chunk = 1, 32768, 4, 1024, 1025, 256
        name = "d prefill_32k, slow decay"
        xs = mlstm_inputs(B * H, S, P, Pv, gate_bias=8.0)
        got = mc_kernel.mlstm_chunk_bhsd(*xs, chunk=chunk)
        sync()

        def bshd(x):
            return x.reshape(B, H, S, -1).transpose(1, 2)

        want = xscan(*(bshd(x) for x in xs[:3]), bshd(xs[3])[..., 0],
                     bshd(xs[4])[..., 0], chunk=chunk)
        want = want.transpose(1, 2).reshape(B * H, S, Pv)
        scale = max(1.0, want.abs().max().item())
        err = (got - want).abs().max().item()
        mlstm_err[name] = err
        check(bool(torch.isfinite(got).all()) and err <= 2e-4 * scale,
              f"mlstm ({name}): max abs err {err:.3g} > 2e-4 x {scale:.3g}")
        log(f"  ({name}) B={B} S={S} H={H} P={P} Pv={Pv} chunk={chunk} "
            f"f32, gate bias 8, vs the chunked scan: max abs err {err:.3g} "
            f"(max |y| {scale:.3g}, allowed {2e-4 * scale:.3g})")
        del xs, got, want

    # ------------------------------------------ xlstm main path (13)
    xcfg = get_arch("xlstm-1.3b")
    x_out = {}
    with phase("xlstm main path: xlstm-1.3b prefill + serving (counted)"):
        # the weights are drawn on the card (a CUDA generator): drawing
        # 2.7e9 numbers from a CPU generator is set-up time of its own,
        # timed below on one block
        t0 = time.perf_counter()
        xparams = api.init_params(torch.Generator(device=dev).manual_seed(0), xcfg,
                                  device=dev)
        sync()
        x_out["init_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        MLSTM(xcfg, device=dev).reset_parameters(
            torch.Generator().manual_seed(0))
        sync()
        x_out["cpu_block_s"] = time.perf_counter() - t0
        G, M = lm.xlstm_groups(xcfg)
        n_params = sum(p.numel() for p in xparams.parameters())
        log(f"  {xcfg.name}: {n_params} parameters ({4 * n_params / 1e9:.2f} "
            f"GB f32), {G} supergroups of {M} mLSTM + 1 sLSTM blocks, "
            f"d_model {xcfg.d_model}, heads {xcfg.num_heads}, mLSTM P "
            f"{xcfg.xlstm.mlstm_expand * xcfg.d_model // xcfg.num_heads}, "
            f"chunk {xcfg.xlstm.chunk}, dtype {xcfg.dtype}; init on the card "
            f"{x_out['init_s']:.2f} s (one mLSTM block from a CPU generator: "
            f"{x_out['cpu_block_s']:.2f} s)")
        toks13 = torch.from_numpy(rng.integers(0, xcfg.vocab_size,
                                               (4, 2048))).to(dev)
        prompts13 = rng.integers(0, xcfg.vocab_size, (4, 128))
        requests13 = [rng.integers(0, xcfg.vocab_size, 32) for _ in range(6)]
        xprefill = make_prefill_step(xcfg)
        sync()
        for lib in _cuda.LIBS:
            lib.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        x_out["prefill"] = xprefill(xparams, {"tokens": toks13})
        sync()
        x_out["prefill_s"] = time.perf_counter() - t0
        x_out["prefill_peak"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        x_out["generate"] = ServeEngine(xcfg, xparams, batch=4,
                                        max_len=256).generate(prompts13, 16)
        sync()
        x_out["generate_s"] = time.perf_counter() - t0
        cb = ContinuousBatchingEngine(xcfg, xparams, batch=4, max_len=64)
        t0 = time.perf_counter()
        x_out["cb"] = cb.run(requests13, 8)
        sync()
        x_out["cb_s"] = time.perf_counter() - t0
        x_out["serve_peak"] = torch.cuda.max_memory_allocated()
        x_launches = {lib.name: lib.launches for lib in _cuda.LIBS}
        log(f"  prefill B=4 S=2048: {x_out['prefill_s']:.3f} s (first call);"
            f" generate 4x(128+16): {x_out['generate_s']:.3f} s; continuous "
            f"batching 6x(32+8) over 4 slots: {x_out['cb_s']:.3f} s")
        log(f"launches on the xlstm path: {x_launches}")
        check(x_launches["mlstm_chunk"] == G * M,
              f"mlstm kernel launched {x_launches['mlstm_chunk']} times in "
              f"one prefill, not once per mLSTM block ({G * M})")

    x_err = {}
    if "prefill" in x_out:
        with phase("13 xlstm prefill vs plain (bf16, float32); prefill vs "
                   "decode; serving outputs"):
            got = x_out["prefill"].float()
            vp = xparams.embed.shape[0]
            check(tuple(got.shape) == (4, vp) and
                  bool(torch.isfinite(got).all()), f"prefill logits not "
                  f"finite or of shape (4, {vp})")
            with plain_kernels():
                want = xprefill(xparams, {"tokens": toks13}).float()
            # bf16 activations through 48 blocks: the kernel and its plain
            # version agree to ~1e-6 in f32, but each block rounds its
            # output to bf16, where a value near a rounding midpoint goes
            # either way (one step, 2^-7 relative), and the residual
            # stream carries it on: the 30-layer smollm-135m of phase 9
            # differs by 0.027 in bf16 against its plain version.  Allowed:
            # 0.1 absolute, and the same argmax in every row.
            x_err["bf16"] = (got - want).abs().max().item()
            same_argmax = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
            V = xcfg.vocab_size        # columns past it are masked, -1e30
            log(f"  bf16: max abs diff {x_err['bf16']:.3g} (max |logit| "
                f"{want[:, :V].abs().max().item():.3g}); argmax agree "
                f"{same_argmax}")
            check(x_err["bf16"] <= 0.1 and same_argmax,
                  f"bf16 prefill logits differ by {x_err['bf16']:.3g} "
                  f"(<= 0.1) or in argmax")
            xcfg32 = xcfg.replace(dtype="float32")
            xprefill32 = make_prefill_step(xcfg32)
            got32 = xprefill32(xparams, {"tokens": toks13})
            with plain_kernels():
                want32 = xprefill32(xparams, {"tokens": toks13})
            # float32 throughout: summation order only, 1e-3 absolute
            x_err["f32"] = (got32 - want32).abs().max().item()
            check(x_err["f32"] <= 1e-3, f"f32 prefill logits differ by "
                  f"{x_err['f32']:.3g} > 1e-3")
            log(f"  float32: max abs diff {x_err['f32']:.3g}")
            del got, want, got32, want32
            # the decode path rounds the conv window through bf16 (the
            # reference's cache), the prefill does not.  The reference's own
            # test_decode_matches_forward_ssm allows 3e-2 at its smoke size;
            # at full width on an H100 80GB HBM3 (700 W) the two differed by
            # 1.3e-5 to 1.4e-5 in f32, so 1e-3 here: a decode-path fault of
            # that size fails
            prompt = prompts13[:2, :64]
            full = xprefill32(xparams,
                              {"tokens": torch.from_numpy(prompt).to(dev)})
            step, _ = ServeEngine(xcfg32, xparams, batch=2,
                                  max_len=64).prefill(prompt)
            x_err["decode"] = (full - step[:, 0]).abs().max().item()
            check(x_err["decode"] <= 1e-3, f"prefill and decode logits "
                  f"differ by {x_err['decode']:.3g} > 1e-3")
            gen = x_out["generate"]
            check(gen.shape == (4, 16) and gen.min() >= 0
                  and gen.max() < xcfg.vocab_size, f"generate gave "
                  f"{gen.shape}, ids {gen.min()}..{gen.max()}")
            done = x_out["cb"]
            check(len(done) == 6 and all(len(t) == 8 for _, t in done),
                  f"continuous batching finished {len(done)} of 6 requests, "
                  f"lengths {[len(t) for _, t in done]}")
            check({s for s, _ in done} == set(range(4)),
                  "not every slot served a request")
            log(f"  prefill vs decode (64 tokens, float32) max abs diff "
                f"{x_err['decode']:.3g} (max |logit| "
                f"{full[:, :V].abs().max().item():.3g}); generate "
                f"{gen.shape}; "
                f"continuous batching {len(done)} requests, slots "
                f"{[s for s, _ in done]}")

    # --------------------------------------------------------------- 14
    def xdecode5():
        """Five decode steps of 4 sequences, as ServeEngine runs them."""
        cache = api.init_cache(xcfg, 4, 256, device=dev)
        tok = torch.zeros(4, 1, dtype=torch.int32, device=dev)
        for _ in range(5):
            _, cache = api.decode_step(xparams, tok, cache, xcfg)

    with phase("14 timings (xlstm)"):
        by_shape = []
        for label, B, S in (("a xlstm-1.3b", 4, 2048),
                            ("prefill_32k", 1, 32768)):
            H, P, Pv, chunk = 4, 1024, 1025, 256
            xs = mlstm_inputs(B * H, S, P, Pv)
            k_ms = cuda_time(lambda: mc_kernel.mlstm_chunk_bhsd(
                *xs, chunk=chunk), 5 if B > 1 else 3)
            p_ms = err = None
            if label.startswith("a"):
                p_ms = cuda_time(lambda: mc_ref.mlstm_ref(*xs), 3)
                err = mlstm_err["a xlstm-1.3b"]
            bound_ms, bound_by, flops = mlstm_bound(B * H, S, P, Pv, chunk)
            by_shape.append({
                "shape": f"{label}: B={B} S={S} H={H} P={P} Pv={Pv} "
                         f"chunk={chunk} f32", "ms": k_ms, "plain_ms": p_ms,
                "library_ms": None, "bound_ms": bound_ms,
                "bound_by": bound_by, "max_abs_err": err,
                "tflops": flops / (k_ms * 1e-3) / 1e12})
            log(f"  mlstm {by_shape[-1]} [{card}]")
            del xs
        # the counted run of phase 13 was the warm-up of each call
        xp_ms = cuda_time(lambda: xprefill(xparams, {"tokens": toks13}), 3,
                          warm_up=False)
        # the sLSTM blocks' share: one prefill with every sLSTM block timed
        # between two syncs (host clock; the syncs cost the pipeline a few
        # ms, so the share is of that run's own wall time)
        s_ms, plain_slstm = [], lm.slstm_forward

        def timed_slstm(*a):
            sync()
            t = time.perf_counter()
            out = plain_slstm(*a)
            sync()
            s_ms.append(1e3 * (time.perf_counter() - t))
            return out

        lm.slstm_forward = timed_slstm
        try:
            t0 = time.perf_counter()
            xprefill(xparams, {"tokens": toks13})
            sync()
            split_ms = 1e3 * (time.perf_counter() - t0)
        finally:
            lm.slstm_forward = plain_slstm
        xgen_ms = cuda_time(lambda: ServeEngine(
            xcfg, xparams, batch=4, max_len=256).generate(prompts13, 16),
            SERVE_REPS, warm_up=False)
        xcb_ms = cuda_time(lambda: ContinuousBatchingEngine(
            xcfg, xparams, batch=4, max_len=64).run(requests13, 8),
            SERVE_REPS, warm_up=False)
        steps = 128 + 16 - 1           # decode steps of generate()
        mlstm_ms = x_launches["mlstm_chunk"] * by_shape[0]["ms"]
        log(f"  prefill step xlstm-1.3b B=4 S=2048 bf16: median {xp_ms:.3f} "
            f"ms of 3 (first {1e3 * x_out['prefill_s']:.3f} ms), peak device "
            f"memory {x_out['prefill_peak'] / 2**30:.3f} GiB [{card}]")
        log(f"  of one prefill ({split_ms:.3f} ms with the sLSTM blocks "
            f"synced): {len(s_ms)} sLSTM blocks {sum(s_ms):.3f} ms "
            f"({100 * sum(s_ms) / split_ms:.1f} %); the mLSTM kernel "
            f"{x_launches['mlstm_chunk']} x {by_shape[0]['ms']:.3f} ms = "
            f"{mlstm_ms:.3f} ms ({100 * mlstm_ms / xp_ms:.1f} % of the "
            f"median step) [{card}]")
        log(f"  ServeEngine.generate 4 x {steps} decode steps: median "
            f"{xgen_ms:.3f} ms of {SERVE_REPS} (first "
            f"{1e3 * x_out['generate_s']:.3f} "
            f"ms), {4 * steps / (xgen_ms / 1e3):.2f} decode tokens/s "
            f"({4 * 16 / (xgen_ms / 1e3):.2f} new tokens/s) [{card}]")
        log(f"  continuous batching 6 requests: median {xcb_ms:.3f} ms of "
            f"{SERVE_REPS} "
            f"(first {1e3 * x_out['cb_s']:.3f} ms), "
            f"{6 * 8 / (xcb_ms / 1e3):.2f} new tokens/s; peak device "
            f"memory serving {x_out['serve_peak'] / 2**30:.3f} GiB [{card}]")
        for name, fn in (("xlstm prefill step", lambda: xprefill(
                xparams, {"tokens": toks13})), ("xlstm 5 decode steps",
                                                xdecode5)):
            log(f"  device busy, {name}: {device_busy(fn)} [{card}]")
        top = by_shape[0]
        kernels.append({
            "name": "mlstm_chunk", "route": "cuda",
            "source": "src/repro_torch/csrc/mlstm_chunk.cu",
            "replaces": "src/repro/kernels/mlstm_chunk/kernel.py:78",
            "launches": x_launches["mlstm_chunk"],
            "max_abs_err": max(mlstm_err.values()),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": None, "shape": top["shape"],
            "design": "tensor-core mma.sync, f32 operands split into bf16 "
                      "high/low parts (3 products), f32 state tile per "
                      "(head, 32 columns) in the warps' registers, operands "
                      "split once per (head, chunk) and streamed by "
                      "cp.async",
            "by_shape": by_shape, "prefill_logits_err": x_err})

    # --------------------------------------------------------------- 15
    def busy_of(fn, wall_s):
        """Device time (kernels and copies) of one fn() under
        torch.profiler over ``wall_s``, the wall time of the counted run,
        as text, with the device events' count and the longest kind.  A
        profiling session loses its first ~10 device events (on the H100,
        9-13 of kernel 1's launches went missing from each session, and
        all of a 3-round solve's), so 64 spin kernels go first; they are
        left out of the sum, and the ones lost are reported."""
        from torch.profiler import ProfilerActivity, profile
        spins = 64
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(spins):
                torch.cuda._sleep(100)
            sync()
            fn()
            sync()
        cuda = torch.autograd.DeviceType.CUDA
        by_name, seen_spins = {}, 0
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != cuda or e.is_user_annotation():
                continue
            name = e.name().replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0]
            name = name.removeprefix("void ").strip()[-40:]
            if name.endswith("spin_kernel"):
                seen_spins += 1
                continue
            ms, n = by_name.get(name, (0.0, 0))
            by_name[name] = (ms + e.duration_ns() / 1e6, n + 1)
        if not by_name:
            return "device time not measured (no device events)"
        k_ms = sum(ms for ms, _ in by_name.values())
        top, (top_ms, top_n) = max(by_name.items(), key=lambda kv: kv[1][0])
        return (f"device time {k_ms:.2f} ms of one profiled run "
                f"({sum(n for _, n in by_name.values())} events, "
                f"{spins - seen_spins} of {spins} leading spin kernels "
                f"lost; most: {top} {top_ms:.2f} ms x{top_n}) / wall "
                f"{1e3 * wall_s:.2f} ms = {100 * k_ms / (1e3 * wall_s):.1f} %")

    def direct_s(g, D, block):
        """Host wall s of one direct solve_block_status on the card."""
        t0 = time.perf_counter()
        solve_block_status(g, D, backend="cuda", device=dev, block=block)
        sync()
        return time.perf_counter() - t0

    def clean(o, st, what):
        """No service-level terminal row and no retry in a fault-free
        run."""
        bad = np.isin(o.status, (dse.FAULTED, dse.TIMED_OUT, dse.CANCELLED))
        check(not bad.any(), f"{what}: {int(bad.sum())} FAULTED/TIMED_OUT/"
              f"CANCELLED rows")
        check(st["retries"] == 0 and st["faulted_rows"] == 0
              and st["timed_out_rows"] == 0, f"{what}: retries or faulted "
              f"rows in a fault-free run: {st}")

    def served(base, D, block, mode="serial", shards=1, injector=None):
        """One served sweep of D against the warm base run: a fresh
        service (so nothing is memoized), manual mode; returns (outcome,
        scheduler stats, wall s, service)."""
        svc = SweepService(backend="cuda", device=dev, block=block,
                           shards=shards, mode=mode, autostart=False,
                           injector=injector)
        svc.warm(base)
        t0 = time.perf_counter()
        o = svc.sweep(base, D)
        sync()
        return o, svc.stats()["scheduler"], time.perf_counter() - t0, svc

    def two_tenants(bulk_design, svc):
        """(a)'s traffic on svc's background thread: the bulk tenant's
        matmul_stream K 1024, then, while it runs, the interactive
        tenant's fig4_ex5 K 16 (engine fallback)."""
        t0 = time.perf_counter()
        hb = svc.submit(bulk_design, Da, tenant="bulk")
        t1 = time.perf_counter()
        hi = svc.submit(designs["fig4_ex5"][0], Di, tenant="interactive")
        oi = hi.result(timeout=600)
        t_i = time.perf_counter() - t1
        ob = hb.result(timeout=600)
        sync()
        return ob, oi, time.perf_counter() - t0, t_i

    # full (generation 2) garbage collections, by host clock: one pass
    # over the objects the earlier phases leave takes on the order of a
    # second, and lands in whichever timed window triggers it
    full_gc = []

    def on_gc(stage, info):
        if info["generation"] == 2:
            if stage == "start":
                full_gc.append([time.perf_counter(), None])
            elif full_gc:
                full_gc[-1][1] = time.perf_counter()

    def full_gc_since(t0):
        """(count, seconds) of the full collections started after t0."""
        spans = [b - a for a, b in full_gc if a >= t0 and b is not None]
        return len(spans), sum(spans)

    def hyb_counters(c):
        return {k: getattr(c, k) for k in (
            "hits", "misses", "switches", "divergences", "full_hits",
            "full_misses", "full_rejects")}

    gc.callbacks.append(on_gc)
    Da, Di = Dm["matmul"], Dm["fig4_ex5"][:16]
    service_launches = {}
    served_hybrid = {}
    with phase("15 sweep service on the card (SweepService, "
               "backend='cuda')"):
        # (a) two tenants at once, the background thread on
        svc_a = SweepService(backend="cuda", device=dev, autostart=True)
        for lib in _cuda.LIBS:
            lib.reset_counts()
        t_a = time.perf_counter()
        ob, oi, wall_b, wall_i = two_tenants(matmul_stream(), svc_a)
        gc_a = full_gc_since(t_a)
        st = svc_a.stats()["scheduler"]
        service_launches["a"] = _cuda.SPARSE.launches
        check(service_launches["a"] > 0, "(a): kernel 1 not launched")
        clean(ob, st, "(a) bulk")
        clean(oi, st, "(a) interactive")
        check(st["blocks_interactive"] >= 1, "(a): no interactive block")
        entry = svc_a.cache.lookup(program_fingerprint(matmul_stream()))
        check(entry is not None, "(a): the bulk design is not in the cache")
        want_b = resimulate_batch(designs["matmul"][0], Da, backend="cuda",
                                  device=dev)
        t_d = time.perf_counter()
        want_i = resimulate_batch(designs["fig4_ex5"][0], Di,
                                  backend="cuda", device=dev)
        gc_d = full_gc_since(t_d)
        same_outcome(ob, want_b, "(a) bulk vs direct resimulate_batch")
        same_outcome(oi, want_i, "(a) interactive vs direct "
                     "resimulate_batch")
        same_outcome(oi, resimulate_batch(designs["fig4_ex5"][0], Di,
                                          backend="numpy"),
                     "(a) interactive vs numpy")
        same_status([x[:16] for x in (ob.status, ob.cycles, ob.violated)],
                    solve_block_status(designs["matmul"][1], Da[:16],
                                       backend="numpy"), "(a) bulk vs numpy")
        check(int((oi.status == dse.VIOLATED).sum()) > 0 and st["fallbacks"]
              > 0, "(a): the interactive rows took no engine fallback")
        g_m = designs["matmul"][1]
        log(f"  (a) bulk matmul_stream K=1024 block 128 (submitted as a "
            f"Program: cold build {entry.build_s:.3f} s in the caller): "
            f"{wall_b:.3f} s, {len(Da) / wall_b:.1f} configs/s "
            f"({len(Da) / (wall_b - entry.build_s):.1f} without the "
            f"build); direct solve_block_status at block 128 "
            f"{direct_s(g_m, Da, 128):.3f} s, at block 1024 "
            f"{direct_s(g_m, Da, len(Da)):.3f} s; kernel 1 launches "
            f"{service_launches['a']}; full GC passes in (a): {gc_a[0]}, "
            f"{gc_a[1]:.3f} s [{card}]")
        log(f"  (a) interactive fig4_ex5 K=16 beside it: {wall_i:.3f} s "
            f"from its submit, {len(Di) / wall_i:.1f} configs/s, "
            f"{int((oi.status == dse.VIOLATED).sum())} rows VIOLATED "
            f"(engine fallback); direct resimulate_batch "
            f"{want_i.elapsed_s:.3f} s (full GC passes in it: {gc_d[0]}, "
            f"{gc_d[1]:.3f} s); scheduler {st} [{card}]")
        gc.callbacks.remove(on_gc)
        # (d) the bulk rows again, reversed: all from the memo
        before = dict(st)
        _cuda.SPARSE.reset_counts()
        t0 = time.perf_counter()
        od = svc_a.submit(designs["matmul"][0], Da[::-1],
                          tenant="bulk").result(timeout=600)
        wall_d = time.perf_counter() - t0
        st = svc_a.stats()["scheduler"]
        # the service's shared HybridCache after (a) and (d), for 17 (e)
        served_hybrid["a"] = (hyb_counters(svc_a.cache.hybrid),
                              svc_a.stats()["cache"]["full_runs"])
        svc_a.close()
        memo = st["memo_hits"] - before["memo_hits"]
        solved = st["rows_unique"] - before["rows_unique"]
        check(memo == solved, f"(d): {solved - memo} rows were solved again")
        if len(np.unique(Da, axis=0)) == len(Da):
            check(memo == len(Da), f"(d): {memo} memo hits for {len(Da)} rows")
        check(_cuda.SPARSE.launches == 0, f"(d): kernel 1 launched "
              f"{_cuda.SPARSE.launches} times on memo hits")
        clean(od, st, "(d)")
        same_status((od.status, od.cycles, od.violated),
                    [x[::-1] for x in (ob.status, ob.cycles, ob.violated)],
                    "(d) reversed repeat")
        check(od.reasons == ob.reasons[::-1], "(d): reasons differ")
        log(f"  (d) (a)'s bulk rows again, reversed: {wall_d:.3f} s, "
            f"{memo} memo hits of {len(Da)} rows, kernel 1 launches 0 "
            f"[{card}]")
        svc_p = SweepService(backend="cuda", device=dev, autostart=True)
        svc_p.warm(entry.result)
        svc_p.warm(designs["fig4_ex5"][0])
        log(f"  (a) again on a fresh warm service: " + busy_of(
            lambda: two_tenants(entry.result, svc_p), wall_b - entry.build_s)
            + f" [{card}]")
        svc_p.close()

        # (b) shards: serial, two threads, two spawned processes
        base_s, g_s = designs["msort8"]
        Db = Dm["msort8"]
        want = out["4 merge_sort_staged(8) K=1024"]
        reasons = {}
        for mode, shards in (("serial", 1), ("thread", 2), ("process", 2)):
            _cuda.SPARSE.reset_counts()
            o, st, wall, svc = served(base_s, Db, 256, mode, shards)
            launches = {"this process": _cuda.SPARSE.launches}
            if mode == "process":
                check(svc.scheduler._pool._mp_context.get_start_method()
                      == "spawn", "(b): the process pool does not spawn")
                probes = [svc.scheduler._pool.submit(worker_sparse_launches,
                                                     0.2) for _ in range(8)]
                launches.update(f.result(timeout=300) for f in probes)
                check(sum(launches.values()) > 0,
                      f"(b) process: kernel 1 not launched: {launches}")
            else:
                check(launches["this process"] > 0,
                      f"(b) {mode}: kernel 1 not launched")
            svc.close()
            service_launches[f"b {mode}"] = launches
            clean(o, st, f"(b) {mode}")
            same_status((o.status, o.cycles, o.violated), want,
                        f"(b) {mode} vs direct")
            reasons[mode] = o.reasons
            log(f"  (b) merge_sort_staged(8) K=1024 block 256 {mode} x"
                f"{shards}: {wall:.3f} s, {len(Db) / wall:.1f} configs/s; "
                f"kernel 1 launches {launches} [{card}]")
            if mode == "serial":
                wall_serial = wall
        check(reasons["serial"] == reasons["thread"] == reasons["process"],
              "(b): reasons differ between modes")
        log(f"  (b) direct solve_block_status at block 256 "
            f"{direct_s(g_s, Db, 256):.3f} s, at block 1024 "
            f"{direct_s(g_s, Db, len(Db)):.3f} s; serial served again: "
            + busy_of(lambda: served(base_s, Db, 256)[3].close(),
                      wall_serial) + f" [{card}]")

        # (c) size: skynet_like K 4096 at block 128 and 4096
        base_k, g_k = designs["skynet"]
        Dc = Dm["skynet"]
        for blk in (128, 4096):
            _cuda.SPARSE.reset_counts()
            sync()
            alloc0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            o, st, wall, svc = served(base_k, Dc, blk)
            peak = torch.cuda.max_memory_allocated() - alloc0
            svc.close()
            service_launches[f"c block {blk}"] = _cuda.SPARSE.launches
            check(_cuda.SPARSE.launches > 0, f"(c) block {blk}: kernel 1 "
                  f"not launched")
            clean(o, st, f"(c) block {blk}")
            same_status((o.status, o.cycles, o.violated),
                        out["3 skynet_like K=4096"], f"(c) block {blk}")
            log(f"  (c) skynet_like K=4096 block {blk}: {wall:.3f} s, "
                f"{len(Dc) / wall:.1f} configs/s; {st['blocks']} blocks, "
                f"kernel 1 launches {_cuda.SPARSE.launches}; peak device "
                f"memory {peak / 2**30:.3f} GiB above the "
                f"{alloc0 / 2**30:.3f} GiB held before; direct "
                f"solve_block_status at block {blk} "
                f"{direct_s(g_k, Dc, blk):.4f} s, at block 4096 "
                f"{direct_s(g_k, Dc, len(Dc)):.4f} s; served again: "
                + busy_of(lambda: served(base_k, Dc, blk)[3].close(), wall)
                + f" [{card}]")

        # (e) injected faults on (b)'s serial run: block 0's solve faults
        # on all 3 attempts of the default retry policy; block 1's first
        # attempt returns corrupt arrays and its retry succeeds
        inj = FaultInjector(seed=0).arm("shard.fault", at=[0, 1, 2]) \
            .arm("shard.corrupt", at=[3])
        o, st, wall, svc = served(base_s, Db, 256, injector=inj)
        svc.close()
        check((o.status[:256] == dse.FAULTED).all()
              and (o.cycles[:256] == -1).all(),
              "(e): block 0's rows are not FAULTED with cycles -1")
        same_status((o.status[256:], o.cycles[256:], o.violated[256:]),
                    [x[256:] for x in want[:3]], "(e) other blocks")
        check(st["retries"] == 3, f"(e): {st['retries']} retries, want 3")
        check(st["faulted_rows"] == len(np.unique(Db[:256], axis=0)),
              f"(e): {st['faulted_rows']} faulted rows")
        log(f"  (e) injected faults: {int((o.status == dse.FAULTED).sum())} "
            f"rows FAULTED (block 0), the other {len(Db) - 256} exact; "
            f"retries {st['retries']}, injector {inj.stats()}, quarantine "
            f"{svc.quarantine.stats()} [{card}]")
    # --------------------------------------------------------------- 16
    def wall(fn):
        """(median host s of 3 runs of fn after one warm run, last
        result)."""
        res = fn()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            res = fn()
            walls.append(time.perf_counter() - t0)
        return statistics.median(walls), res

    def same_sim(a, b, what):
        """Compiled replay equals the generator engine: results, graph
        size, node times as multisets (the two number nodes differently)
        and every FIFO table's sorted times and leftover values."""
        check((a.cycles, a.outputs, a.deadlock, a.depths)
              == (b.cycles, b.outputs, b.deadlock, b.depths),
              f"{what}: results differ")
        check((a.stats.nodes, a.stats.edges) == (b.stats.nodes,
                                                 b.stats.edges),
              f"{what}: graph size differs")
        check(np.array_equal(np.sort(a.graph.graph.times()),
                             np.sort(b.graph.graph.times())),
              f"{what}: node times differ")
        for ta, tb in zip(a.graph.fifos, b.graph.fifos):
            for f in ("write_times", "read_times"):
                check(np.array_equal(np.sort(getattr(ta, f)),
                                     np.sort(getattr(tb, f))),
                      f"{what}: FIFO {ta.name} {f} differ")
            check(list(ta.values) == list(tb.values),
                  f"{what}: FIFO {ta.name} leftovers differ")

    with phase("16 (a) compiled replay vs the generator engine"):
        for key, build in (("skynet_like()", skynet_like),
                           ("matmul_stream()", matmul_stream),
                           ("merge_sort_staged(8)",
                            lambda: merge_sort_staged(8)),
                           ("flowgnn_like(n_nodes=1024, layers=8)",
                            lambda: flowgnn_like(n_nodes=1024, layers=8))):
            s_tr, r_tr = wall(lambda: simulate(build()))
            s_gen, r_gen = wall(lambda: simulate(build(), trace="never"))
            check(r_tr.engine == "omnisim-trace" and r_gen.engine
                  == "omnisim", f"{key}: engines {r_tr.engine}, "
                  f"{r_gen.engine}")
            same_sim(r_tr, r_gen, key)
            rec = r_tr.graph._trace
            log(f"  {key}: compiled replay {s_tr:.4f} s, generator engine "
                f"{s_gen:.4f} s (medians of 3 after a warm run), "
                f"{s_gen / s_tr:.2f}x; {r_tr.stats.nodes} nodes, n_ops "
                f"{rec.n_ops} stored as {rec.n_stored} rows after "
                f"periodization, {r_tr.stats.quiescence_rounds} sweeps "
                f"(quiescence_rounds; the generator engine's "
                f"{r_gen.stats.quiescence_rounds}), cycles {r_tr.cycles} "
                f"[{card}]")

    trace_launches = {}
    with phase("16 (b) trace-built graphs through kernel 1"):
        for key, name, n_np in (("skynet", "3 skynet_like K=4096", 64),
                                ("matmul", "4 matmul_stream K=1024", 8),
                                ("msort8", "4 merge_sort_staged(8) K=1024",
                                 64)):
            g_tr, D = designs[key][1], Dm[key]
            base_gen = simulate(design_fns[key](), trace="never")
            g_gen = compile_graph(base_gen.graph)
            check(g_tr.n == g_gen.n, f"{key}: node counts differ")
            _cuda.SPARSE.reset_counts()
            st_tr = solve_block_status(g_tr, D, backend="cuda", device=dev)
            st_gen = solve_block_status(g_gen, D, backend="cuda",
                                        device=dev)
            sync()
            trace_launches[key] = _cuda.SPARSE.launches
            check(trace_launches[key] > 0, f"{key}: kernel 1 not launched")
            same_status(st_tr, st_gen, f"{key} trace vs generator graph")
            same_status(st_tr, out[name], f"{key} vs phase 3/4")
            same_status([x[:n_np] for x in st_tr[:3]],
                        solve_block_status(g_gen, D[:n_np],
                                           backend="numpy"),
                        f"{key} vs numpy")
            check(st_tr[3] == st_gen[3], f"{key}: rounds launched differ: "
                  f"{st_tr[3]} vs {st_gen[3]}")
            row = k1_rows[key]
            per = {}
            for src, g in (("trace", g_tr), ("generator", g_gen)):
                ba = dse._batch_arrays(g)
                Da = D[~(D < ba.fifo_need[None, :]).any(axis=1)]
                arr = dse._sparse_arrays(ba, dev)
                Dt = torch.from_numpy(np.minimum(Da, 1 << 30)
                                      .astype(np.int32)).to(dev)
                got = {}
                ms = cuda_time(lambda: got.__setitem__(
                    "k", sparse.solve_chains(arr, Dt)), 3)
                per[src] = (ms, got["k"][2])
            (ms_t, l_t), (ms_g, l_g) = per["trace"], per["generator"]
            check(l_t == l_g, f"{key}: kernel rounds differ {l_t} vs {l_g}")
            log(f"  {key}: kernel 1 per solve {ms_t:.3f} ms from the trace-"
                f"built graph, {ms_g:.3f} ms from the generator-built "
                f"({ms_t / ms_g:.3f}x); per round {1e3 * ms_t / l_t:.2f} "
                f"against {1e3 * ms_g / l_g:.2f} us ({l_t} rounds "
                f"launched, {row['rounds']} needed); bound "
                f"{row['bound_ms']:.3f} ms, "
                f"{row['bound_us_per_round']:.2f} us a round (phase 7); "
                f"status, cycles, violated bit-identical; kernel 1 "
                f"launches {trace_launches[key]} [{card}]")

    trace_dense = {}
    with phase("16 (c) the trace graph through kernel 2"):
        sg = designs["msort6"][0].graph.graph
        check(isinstance(sg, TraceSimGraph), f"merge_sort_staged() graph "
              f"is {type(sg).__name__}")
        _cuda.DENSE.reset_counts()
        ft = ops.finalize_times(sg, device=dev)
        sync()
        trace_dense["launches"] = _cuda.DENSE.launches
        check(trace_dense["launches"] > 0, "kernel 2 not launched")
        check(np.array_equal(ft.cpu().numpy(), sg.times()),
              "finalize_times differs from the trace graph's times()")
        trace_dense["ms"] = cuda_time(
            lambda: ops.finalize_times(sg, device=dev), 3)
        log(f"  merge_sort_staged(): finalize_times on the TraceSimGraph "
            f"(n={sg.n_nodes}) equals its times(); kernel 2 launches "
            f"{trace_dense['launches']}; {trace_dense['ms']:.3f} ms a call "
            f"(CUDA events around the call, host CSR and densify "
            f"included) [{card}]")

    typea_small = {
        "producer_consumer": lambda: TYPEA_DESIGNS["producer_consumer"](
            n=48),
        "fir_filter": lambda: TYPEA_DESIGNS["fir_filter"](n=64),
        "window_conv": lambda: TYPEA_DESIGNS["window_conv"](rows=12,
                                                            cols=12),
        "matmul_stream": lambda: TYPEA_DESIGNS["matmul_stream"](m=6, k=6,
                                                                n=6),
        "sqrt_pipe": lambda: TYPEA_DESIGNS["sqrt_pipe"](n=48),
        "parallel_loops": lambda: TYPEA_DESIGNS["parallel_loops"](n=48),
        "nested_loops": lambda: TYPEA_DESIGNS["nested_loops"](outer=8,
                                                              inner=8),
        "accumulators": lambda: TYPEA_DESIGNS["accumulators"](n=48),
        "vector_add_stream": lambda: TYPEA_DESIGNS["vector_add_stream"](
            n=96),
        "merge_sort_staged": lambda: TYPEA_DESIGNS["merge_sort_staged"](
            log_n=5),
        "huffman_pipe": lambda: TYPEA_DESIGNS["huffman_pipe"](n=64),
        "flowgnn_like": lambda: TYPEA_DESIGNS["flowgnn_like"](n_nodes=32),
        "skynet_like": lambda: TYPEA_DESIGNS["skynet_like"](items=48,
                                                            depth=6),
        "latency_pipe": lambda: TYPEA_DESIGNS["latency_pipe"](items=24,
                                                              ii=16),
    }
    with phase("16 (d) the oracles: RTL, LightningSim, C-sim, taxonomy"):
        cases = {**{f"paper/{k}": v for k, v in PAPER_DESIGNS.items()},
                 **{f"typea/{k}": v for k, v in typea_small.items()},
                 "axi/axi_master_design": axi_master_design,
                 "axi/axi_prefetch_design": axi_prefetch_design}
        kinds = {}
        for key, build in sorted(cases.items()):
            sim, rtl = simulate(build()), simulate_rtl(build())
            check(sim.deadlock == rtl.deadlock, f"{key}: deadlock verdicts "
                  f"differ from the RTL oracle")
            if not sim.deadlock:
                check(sim.outputs == rtl.outputs and sim.cycles
                      == rtl.cycles, f"{key}: differs from the RTL oracle")
            try:
                ls = LightningSim(build()).run()
            except UnsupportedDesignError:
                ls = None
            # the reference's LightningSim refuses every design but the
            # Type A ones (cyclic or non-blocking: tests/test_designs.py,
            # tests/test_axi.py)
            check((ls is None) == (not key.startswith("typea/")),
                  f"{key}: LightningSim {'refused' if ls is None else 'ran'}")
            if ls is not None:
                check(ls.outputs == sim.outputs and ls.cycles == sim.cycles,
                      f"{key}: LightningSim differs")
            c = classify(build(), sim)
            kinds[key] = c.dtype
            if key.startswith("typea/"):
                check(c.dtype == "A" and sim.engine == "omnisim-trace",
                      f"{key}: {c}, engine {sim.engine}")
        check(kinds["paper/multicore"] == "C" and kinds["paper/fig4_ex3"]
              == "B" and kinds["axi/axi_master_design"] == "B"
              and kinds["axi/axi_prefetch_design"] == "C",
              f"classifications differ from the reference tests': {kinds}")
        # Table 3 (tests/test_designs.py:37-66): the simulator's pinned
        # outputs, and C-sim's crashes and wrong results
        P = PAPER_DESIGNS
        check(simulate(P["fig4_ex2"]()).outputs["sum_out"] == 2051325
              and simulate(P["fig4_ex3"]()).outputs["sum"] == 4098600
              and simulate(P["deadlock"]()).deadlock, "Table 3 outputs")
        r = simulate(P["fig2_timer"]())
        check(r.outputs["timer_cycles"] == 6075
              and r.outputs["sink_sum"] == 2051325, "Table 3 timer")
        for name in ("fig4_ex2", "fig4_ex4a_d", "fig4_ex4b_d"):
            check(csim(P[name]()).outputs.get("__crash__")
                  == "@E Simulation failed: SIGSEGV.", f"csim {name}")
        r = csim(P["fig4_ex3"]())
        check(r.outputs["sum"] == 0 and sum(
            "read while empty" in w for w in r.outputs["__warnings__"])
            == 2025 and any("leftover" in w
                            for w in r.outputs["__warnings__"]),
            "csim fig4_ex3")
        check(csim(P["fig4_ex4a"]()).outputs["sum_out"] == 2051325
              and csim(P["fig4_ex4b"]()).outputs == {"sum_out": 2051325,
                                                     "Dropped": 0}
              and csim(P["fig2_timer"]()).outputs["timer_cycles"] == 0,
              "csim Table 3 values")
        log(f"  {len(cases)} designs: simulate equals simulate_rtl "
            f"(cycles, outputs, deadlock), LightningSim refuses the "
            f"{sum(not k.startswith('typea/') for k in cases)} non-Type-A "
            f"ones, C-sim gives Table 3's values; types {kinds}")
        # the analogue of the paper's Table 5 on this host: LightningSim
        # (two phases, interpreted) against compiled replay, Type A
        # designs at their defaults
        rows5 = []
        for name, build in sorted(TYPEA_DESIGNS.items()):
            s_ls, ls = wall(lambda: LightningSim(build()).run())
            s_tr, tr = wall(lambda: simulate(build()))
            check(ls.cycles == tr.cycles and ls.outputs == tr.outputs,
                  f"{name}: LightningSim differs at its defaults")
            rows5.append(f"{name} {s_ls * 1e3:.2f}/{s_tr * 1e3:.2f} ms "
                         f"({s_ls / s_tr:.1f}x)")
        log(f"  LightningSim / compiled replay, medians of 3 after a warm "
            f"run: {'; '.join(rows5)} [{card}]")

    # --------------------------------------------------------------- 17
    def gc_note(t0):
        n_gc, s_gc = full_gc_since(t0)
        return f"full GC passes in the window: {n_gc}, {s_gc:.3f} s"

    def kernel1_alone(g, D):
        """Kernel 1 alone on g's device arrays over the rows of D that can
        commit, held against its plain version: (CUDA-event ms a solve,
        rounds launched, rounds the fixpoint needs, bound ms, max abs
        err, E, m, K)."""
        ba = dse._batch_arrays(g)
        Dc = D[~(D < ba.fifo_need[None, :]).any(axis=1)]
        arr = dse._sparse_arrays(ba, dev)
        Dt = torch.from_numpy(np.minimum(Dc, 1 << 30)
                              .astype(np.int32)).to(dev)
        got = {}
        ms = cuda_time(lambda: got.__setitem__(
            "k", sparse.solve_chains(arr, Dt)), 3)
        plain = ref.solve_chains_ref(arr, Dt)
        err = same_solve(got["k"], plain)
        E, m = arr.raw_dst.shape[0], arr.war_dst.shape[0]
        rounds, K = plain[2], Dt.shape[0]
        bound_ms = (4 * K * (2 * g.n + 2 * (E + m)) * rounds
                    / HBM_BYTES_PER_S * 1e3)
        return ms, got["k"][2], rounds, bound_ms, err, E, m, K

    def same_queries(a, b, what):
        check((a.stats.queries, a.stats.queries_forced_false,
               a.stats.skipped_probes, len(a.constraints))
              == (b.stats.queries, b.stats.queries_forced_false,
                  b.stats.skipped_probes, len(b.constraints)),
              f"{what}: query counts differ")

    hybrid_designs = {"fig4_ex5()": fig4_ex5,
                      "fig2_timer()": PAPER_DESIGNS["fig2_timer"],
                      "branch()": PAPER_DESIGNS["branch"],
                      "multicore()": PAPER_DESIGNS["multicore"],
                      "watchdog_pipe()": watchdog_pipe}
    gc.callbacks.append(on_gc)
    with phase("17 (a) hybrid replay vs the generator engine"):
        for key, build in hybrid_designs.items():
            t_w = time.perf_counter()
            s_c, r_c = wall(lambda: simulate(build()))
            hc = HybridCache()
            simulate(build(), hybrid_cache=hc)
            s_w, r_w = wall(lambda: simulate(build(), hybrid_cache=hc))
            s_n, r_n = wall(lambda: simulate(build(), periodize=False))
            s_g, r_g = wall(lambda: simulate(build(), trace="never"))
            check(r_g.engine == "omnisim" and {r.engine for r in
                                               (r_c, r_w, r_n)}
                  == {"omnisim-hybrid"}, f"{key}: engines {r_c.engine}, "
                  f"{r_w.engine}, {r_n.engine}, {r_g.engine}")
            for r, what in ((r_c, "cold"), (r_w, "warm"),
                            (r_n, "periodize=False")):
                same_sim(r, r_g, f"{key} {what}")
                same_queries(r, r_g, f"{key} {what}")
            info = r_c.graph._hybrid
            check(hc.full_hits == 4 and hc.full_rejects == 0
                  and r_w.graph._hybrid["cache_bulk_rows"] == info["ops"],
                  f"{key}: warm runs not replayed whole: {hyb_counters(hc)}")
            check(r_n.stats.queries_periodized == 0, f"{key}: periodized "
                  f"with periodize=False")
            log(f"  {key}: hybrid cold {s_c:.4f} s, warm {s_w:.4f} s, "
                f"periodize=False {s_n:.4f} s, generator engine {s_g:.4f} s "
                f"(medians of 3 after a warm run): {s_g / s_c:.2f}x cold, "
                f"{s_g / s_w:.2f}x warm; {r_c.stats.nodes} nodes, cycles "
                f"{r_c.cycles}; hybrid_info {info}; queries_periodized "
                f"{r_c.stats.queries_periodized}; {gc_note(t_w)} [{card}]")

    hybrid_launches, k1_hybrid = {}, {}
    with phase("17 (b) hybrid-built bases through kernel 1"):
        wd_base = simulate(watchdog_pipe())
        D_wd = np.random.default_rng(0).integers(
            1, 17, size=(1024, len(wd_base.depths)))
        o5 = out["5 fig4_ex5 K=128 fallback"]
        for key, base_h, build, D, n_np in (
                ("fig4_ex5", designs["fig4_ex5"][0], fig4_ex5,
                 Dm["fig4_ex5"], 128),
                ("watchdog_pipe", wd_base, watchdog_pipe, D_wd, 64)):
            check(base_h.engine == "omnisim-hybrid",
                  f"{key}: base run took {base_h.engine}")
            base_g = simulate(build(), trace="never")
            g_h, g_g = compile_graph(base_h.graph), compile_graph(base_g.graph)
            check(g_h.n == g_g.n, f"{key}: node counts differ")
            _cuda.SPARSE.reset_counts()
            st_h = solve_block_status(g_h, D, backend="cuda", device=dev)
            st_g = solve_block_status(g_g, D, backend="cuda", device=dev)
            sync()
            hybrid_launches[key] = _cuda.SPARSE.launches
            check(hybrid_launches[key] > 0, f"{key}: kernel 1 not launched")
            same_status(st_h, st_g, f"{key} hybrid vs generator graph")
            same_status([x[:n_np] for x in st_h[:3]],
                        solve_block_status(g_g, D[:n_np], backend="numpy"),
                        f"{key} vs numpy")
            check(st_h[3] == st_g[3], f"{key}: rounds launched differ: "
                  f"{st_h[3]} vs {st_g[3]}")
            if key == "fig4_ex5":
                check(np.array_equal(st_h[0], o5.status)
                      and np.array_equal(st_h[2], o5.violated),
                      "fig4_ex5: verdicts differ from phase 5's")
            per = {src: kernel1_alone(g, D)
                   for src, g in (("hybrid", g_h), ("generator", g_g))}
            (ms_h, l_h, need, bnd, err, E, m, K) = per["hybrid"]
            ms_g, l_g = per["generator"][:2]
            check(l_h == l_g and need == per["generator"][2],
                  f"{key}: kernel rounds differ {l_h} vs {l_g}")
            k1_hybrid[key] = {"ms": ms_h, "bound_ms": bnd, "max_abs_err": err}
            log(f"  {key} (n={g_h.n}, E={E}, m={m}, K={K} rows that can "
                f"commit): kernel 1 per solve {ms_h:.3f} ms from the hybrid-"
                f"built graph, {ms_g:.3f} ms from the generator-built "
                f"({ms_h / ms_g:.3f}x); per round {1e3 * ms_h / l_h:.2f} "
                f"against {1e3 * ms_g / l_g:.2f} us ({l_h} rounds launched, "
                f"{need} needed); bound {bnd:.4f} ms, "
                f"{1e3 * bnd / need:.2f} us a round; status, cycles, "
                f"violated bit-identical; kernel 1 launches "
                f"{hybrid_launches[key]} [{card}]")

    hybrid_dense = {}
    with phase("17 (c) the hybrid graph through kernel 2"):
        sg = designs["fig4_ex5"][0].graph.graph
        check(isinstance(sg, TraceSimGraph), f"fig4_ex5 graph is "
              f"{type(sg).__name__}")
        _cuda.DENSE.reset_counts()
        ft = ops.finalize_times(sg, device=dev)
        sync()
        hybrid_dense["launches"] = _cuda.DENSE.launches
        check(hybrid_dense["launches"] > 0, "kernel 2 not launched")
        check(np.array_equal(ft.cpu().numpy(), sg.times()),
              "finalize_times differs from the hybrid graph's times()")
        hybrid_dense["ms"] = cuda_time(
            lambda: ops.finalize_times(sg, device=dev), 1)
        log(f"  fig4_ex5(): finalize_times on the hybrid-built "
            f"TraceSimGraph (n={sg.n_nodes}) equals its times(); kernel 2 "
            f"launches {hybrid_dense['launches']}; {hybrid_dense['ms']:.1f} "
            f"ms a call (CUDA events around the call, host CSR and densify "
            f"included) [{card}]")

    with phase("17 (d) fig4_ex5 K=128 fallback block, three ways"):
        base_h, D = designs["fig4_ex5"][0], Dm["fig4_ex5"]
        o5 = out["5 fig4_ex5 K=128 fallback"]
        t_w = time.perf_counter()
        t0 = time.perf_counter()
        o_dir = resimulate_batch(base_h, D, backend="cuda", device=dev)
        s_dir = time.perf_counter() - t0
        same_outcome(o_dir, o5, "direct resimulate_batch vs phase 5")
        Du, inv = np.unique(D, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        st_u = solve_block_status(compile_graph(base_h.graph), Du,
                                  backend="cuda", device=dev)
        sync()
        fb = np.isin(st_u[0], list(dse.FALLBACK_STATUSES))
        hc = HybridCache()
        s_mb = []
        for _ in range(2):            # cold HybridCache, then warm
            cyc = st_u[1].copy()
            t0 = time.perf_counter()
            res_u, _reasons = dse.materialize_block(
                base_h, Du, st_u[0], cyc, st_u[2], np.ones(len(Du), bool),
                hybrid_cache=hc)
            s_mb.append(time.perf_counter() - t0)
            for k, u in enumerate(inv):
                ra, rb = res_u[u], o5.results[k]
                check(ra.cycles == rb.cycles and ra.outputs == rb.outputs
                      and ra.deadlock == rb.deadlock,
                      f"materialize_block row {k} differs from phase 5")
        counters_mb = hyb_counters(hc)
        t0 = time.perf_counter()
        gen_u = {}
        for u in np.flatnonzero(fb):
            gen_u[u] = simulate(fig4_ex5(), depths=tuple(int(x)
                                                          for x in Du[u]),
                                trace="never")
        s_gen = time.perf_counter() - t0
        for u, r in gen_u.items():
            rb = o5.results[int(np.flatnonzero(inv == u)[0])]
            check(r.cycles == rb.cycles and r.outputs == rb.outputs
                  and r.deadlock == rb.deadlock,
                  f"generator fallback of unique row {u} differs")
        engines = {}
        for u in np.flatnonzero(fb):
            e = res_u[u].engine
            engines[e] = engines.get(e, 0) + 1
        # the rows whose hybrid attempt aborts (deadlock): the attempt
        # alone, before the generator engine takes over
        aborted = [u for u in np.flatnonzero(fb)
                   if res_u[u].engine == "omnisim"]
        s_abort = []
        for u in aborted:
            t0 = time.perf_counter()
            try:
                simulate_hybrid(fig4_ex5().with_depths(
                    tuple(int(x) for x in Du[u])))
            except TraceUnsupported:
                pass
            else:
                check(False, f"unique row {u}: the hybrid did not abort")
            s_abort.append(time.perf_counter() - t0)
        w7 = statistics.median(walls7["5 fig4_ex5 K=128 fallback"])
        log(f"  fig4_ex5 K={len(D)} ({len(Du)} unique rows, {int(fb.sum())} "
            f"fall back: engines {engines}): direct resimulate_batch "
            f"(hybrid fallback, no cache) {s_dir:.3f} s (phase 7's median "
            f"of the same call {w7:.3f} s); "
            f"materialize_block with a fresh HybridCache {s_mb[0]:.3f} s, "
            f"again with it warm {s_mb[1]:.3f} s (counters {counters_mb}); "
            f"generator engine over the same {len(gen_u)} rows "
            f"{s_gen:.3f} s ({s_gen / max(s_mb[0], 1e-9):.2f}x the cold "
            f"block); aborted hybrid attempts {len(aborted)}, "
            f"{1e3 * sum(s_abort):.2f} ms in all "
            f"({1e3 * max(s_abort, default=0.0):.2f} ms the longest); "
            f"{gc_note(t_w)} [{card}]")

    with phase("17 (e) served fig4_ex5 with the service's HybridCache"):
        cnt_a, full_a = served_hybrid.get("a", ({}, None))
        log(f"  phase 15 (a)'s service (interactive fig4_ex5 K=16 as a "
            f"SimResult, no cold build): HybridCache {cnt_a}, "
            f"full_runs {full_a} [{card}]")
        want = resimulate_batch(designs["fig4_ex5"][0], Di, backend="cuda",
                                device=dev)
        t_w = time.perf_counter()
        svc = SweepService(backend="cuda", device=dev, autostart=False)
        walls_e = []
        for _ in range(2):
            t0 = time.perf_counter()
            o = svc.sweep(fig4_ex5(), Di)
            sync()
            walls_e.append(time.perf_counter() - t0)
            same_outcome(o, want, "(e) served vs direct resimulate_batch")
        cnt_e = hyb_counters(svc.cache.hybrid)
        full_e = svc.stats()["cache"]["full_runs"]
        fallbacks = svc.stats()["scheduler"]["fallbacks"]
        svc.close()
        check(full_e == 1, f"(e): full_runs {full_e}, want 1")
        check(cnt_e["full_hits"] >= fallbacks // 2, f"(e): the repeat "
              f"sweep's fallbacks did not replay: {cnt_e}")
        log(f"  (e) fresh service, fig4_ex5 K={len(Di)} submitted as a "
            f"Program twice: {walls_e[0]:.3f} s (cold build and "
            f"{fallbacks // 2} hybrid fallbacks), then {walls_e[1]:.3f} s "
            f"(whole-run replays); HybridCache {cnt_e}, full_runs {full_e}; "
            f"rows equal to the direct solve; {gc_note(t_w)} [{card}]")
    gc.callbacks.remove(on_gc)

    # --------------------------------------------------------------- 18
    gc.callbacks.append(on_gc)
    delta_launches, k1_delta = {}, {}
    with phase("18 (a) corpus conformance on the card"):
        for seed, scale in ((2, 300), (0, 1000)):
            c = generate(seed, scale=scale)
            t_w = time.perf_counter()
            _cuda.SPARSE.reset_counts()
            t0 = time.perf_counter()
            rep = check_conformance(c.builder, name=c.name, device="cuda")
            sync()
            s_all = time.perf_counter() - t0
            launches = _cuda.SPARSE.launches
            check(tuple(sorted(rep.paths)) == tuple(sorted(ENGINE_PATHS))
                  and all(v == "ok" for v in rep.paths.values()),
                  f"{c.name}: {rep.paths}")
            check(launches > 0, f"{c.name}: kernel 1 not launched")
            delta_launches[f"conformance {c.name}"] = launches
            # each path alone: its call less the generator-only call
            t0 = time.perf_counter()
            check_conformance(c.builder, name=c.name, device="cuda",
                              paths=())
            s_gen = time.perf_counter() - t0
            per = {"generator": s_gen}
            for path in ENGINE_PATHS[1:]:
                t0 = time.perf_counter()
                r = check_conformance(c.builder, name=c.name, device="cuda",
                                      paths=(path,))
                sync()
                per[path] = time.perf_counter() - t0 - s_gen
                check(r.paths[path] == "ok", f"{c.name} {path} alone: "
                      f"{r.paths[path]}")
            res = simulate(c.builder())
            log(f"  {c.name}: {c.meta['modules']} modules, "
                f"{c.meta['fifos']} FIFOs, engine {res.engine} "
                f"({res.stats.nodes} nodes, cycles {res.cycles}); all "
                f"{len(rep.paths)} paths ok in {s_all:.3f} s (kernel 1 "
                f"launches {launches}); each path alone, less the "
                f"generator: " + ", ".join(f"{k} {v:.3f} s"
                                           for k, v in per.items())
                + f"; {gc_note(t_w)} [{card}]")

    pairs18 = {}
    with phase("18 (b) edit sessions at full width (7 edit pairs)"):
        spec = BLOCKING_SPEC.replace(items=IntRange(48, 96))
        pairs18 = {p.kind: p for p in edit_pairs(11, scale=300, spec=spec)}
        check(tuple(pairs18) == EDIT_KINDS, f"kinds {tuple(pairs18)}")
        simulate(pairs18["delay"].base())          # untimed warm-up
        t_w = time.perf_counter()
        _cuda.SPARSE.reset_counts()
        seen = {}
        for kind, p in pairs18.items():
            s_cold, s_upd = [], []
            for _ in range(3):
                t0 = time.perf_counter()
                cold = simulate(p.edited())
                s_cold.append(time.perf_counter() - t0)
                svc = SweepService()
                try:
                    sess = svc.edit_session(p.base())
                    edited = p.edited()
                    t0 = time.perf_counter()
                    eo = sess.update(edited)
                    s_upd.append(time.perf_counter() - t0)
                    check(eo.mode == p.expect, f"{kind}: served {eo.mode}, "
                          f"want {p.expect} ({eo.reason})")
                    check(result_record(sess.entry.result)
                          == result_record(cold), f"{kind}: served result "
                          f"differs from a cold simulate")
                finally:
                    svc.close()
            seen[kind] = (eo, statistics.median(s_cold),
                          statistics.median(s_upd))
            log(f"  {kind}: {eo.mode}, reuse {eo.reuse_fraction:.4f} "
                f"({eo.reused_modules} of {eo.total_modules} modules), "
                f"reason {eo.reason!r}; cold simulate "
                f"{seen[kind][1]:.4f} s ({cold.engine}, {cold.stats.nodes} "
                f"nodes, {len(cold.depths)} FIFOs, cycles {cold.cycles}), "
                f"update {seen[kind][2]:.4f} s (medians of 3) [{card}]")
        delta_launches["edit sessions"] = _cuda.SPARSE.launches
        patched = [eo for eo, _, _ in seen.values() if eo.mode == "patched"]
        rejects = sum(eo.mode != "patched" for eo, _, _ in seen.values())
        _, c_d, u_d = seen["delay"]
        log(f"  delay speedup (cold simulate over update) {c_d / u_d:.2f}x; "
            f"worst patched reuse "
            f"{min(eo.reuse_fraction for eo in patched):.4f}; reject rate "
            f"{rejects / len(seen):.4f} ({rejects}/{len(seen)}); "
            f"{gc_note(t_w)} [{card}]")

    with phase("18 (c) the patched design through kernel 1"):
        p = pairs18["delay"]
        svc = SweepService()
        try:
            sess = svc.edit_session(p.base())
            check(sess.update(p.edited()).mode == "patched",
                  "delay not patched")
            d0 = np.asarray(sess.program.depths(), np.int64)
            D18 = d0[None, :] + np.random.default_rng(0).integers(
                0, 5, size=(4096, len(d0)))
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated() / 2**30
            _cuda.SPARSE.reset_counts()
            t_w = time.perf_counter()
            t0 = time.perf_counter()
            o_srv = sess.sweep(D18)
            sync()
            s_srv = time.perf_counter() - t0
            delta_launches["served sweep"] = _cuda.SPARSE.launches
            g_p = sess.entry.graph
        finally:
            svc.close()
        check(delta_launches["served sweep"] > 0, "kernel 1 not launched")
        check(bool((o_srv.status == dse.REUSED).all()),
              "a row of growing depths did not stay live")
        cold = simulate(p.edited())
        g_c = compile_graph(cold.graph)
        check(g_c.n == g_p.n, f"node counts differ: {g_c.n} vs {g_p.n}")
        t0 = time.perf_counter()
        o_dir = resimulate_batch(cold, D18, backend="cuda", device=dev)
        sync()
        s_dir = time.perf_counter() - t0
        same_outcome(o_srv, o_dir, "served (patched) vs direct (cold)")
        peak_path = torch.cuda.max_memory_allocated() / 2**30 - held
        o_np = resimulate_batch(cold, D18[:64], backend="numpy")
        same_status((o_srv.status[:64], o_srv.cycles[:64],
                     o_srv.violated[:64]),
                    (o_np.status, o_np.cycles, o_np.violated),
                    "served vs numpy (64 rows)")
        per = {src: kernel1_alone(g, D18)
               for src, g in (("patched", g_p), ("cold", g_c))}
        peak = torch.cuda.max_memory_allocated() / 2**30 - held
        (ms_p, l_p, need, bnd, err, E, m, K) = per["patched"]
        ms_c, l_c, need_c = per["cold"][:3]
        check(l_p == l_c and need == need_c,
              f"kernel rounds differ: {l_p}/{need} vs {l_c}/{need_c}")
        k1_delta.update(shape=f"delay-patched corpus design (n={g_p.n}, "
                        f"E={E}, m={m}, K={K})", ms=ms_p, bound_ms=bnd,
                        rounds=need, launched=l_p, max_abs_err=err)
        log(f"  delay-patched design (n={g_p.n}, E={E}, m={m}, K={K}, "
            f"{len(d0)} FIFOs): served {s_srv:.3f} s at block 128 "
            f"({K / s_srv:.0f} configs/s; kernel 1 launches "
            f"{delta_launches['served sweep']}), direct resimulate_batch "
            f"on the cold-built base {s_dir:.3f} s; rows bit-identical, "
            f"and to numpy on 64; kernel 1 per solve {ms_p:.3f} ms from "
            f"the patched graph, {ms_c:.3f} ms from the cold-built "
            f"({ms_p / ms_c:.3f}x); {l_p} rounds launched, {need} needed; "
            f"bound {bnd:.4f} ms, {1e3 * bnd / need:.2f} us a round, "
            f"{1e3 * ms_p / l_p:.2f} us a launched round; peak device "
            f"memory above the {held:.3f} GiB held before: "
            f"{peak_path:.3f} GiB over the served and direct calls, "
            f"{peak:.3f} GiB with the plain versions' [n, K] arrays; "
            f"{gc_note(t_w)} [{card}]")
    gc.callbacks.remove(on_gc)

    # the serving phases' weights and caches are not needed past here
    params = xparams = cb = None
    gc.collect()
    torch.cuda.empty_cache()
    late = late_phases()
    train_launches = late.get("train_launches", {})
    fam = family_phases()
    train_launches["hymba"] = fam.get("train_launches", {})
    eps = ep_phases()
    train_launches["qwen3"] = eps.get("train_launches", {})
    dry = dry_phases()

    for k in kernels:
        if k["name"] == "maxplus_sparse_fixpoint":
            k["launches_service"] = service_launches
            k["launches_trace_resolves"] = trace_launches
            k["launches_hybrid_resolves"] = hybrid_launches
            k["hybrid_resolves"] = k1_hybrid
            k["launches_delta"] = delta_launches
            k["delta_resolve"] = k1_delta
        if k["name"] == "maxplus_dense_sweep":
            k["launches_trace_finalize"] = trace_dense.get("launches")
            k["launches_hybrid_finalize"] = hybrid_dense.get("launches")
        if k["name"] == "flash_attention":
            k["launches_minicpm_prefill"] = late.get("minicpm_launches")
            k["routes_minicpm_prefill"] = late.get("minicpm_routes")
            k["launches_prefill_after_training"] = late.get(
                "after_training_launches")
            k["launches_train_steps"] = {
                run: n.get("flash_attention")
                for run, n in train_launches.items()}
            if "flash_minicpm" in late:
                k["by_shape"].append(late["flash_minicpm"])
            k["launches_phase22_prefill"] = fam["launches"]
            k["by_shape"].extend(fam["flash"])
            k["phase22_logits_err"] = fam["errors"]
            k["launches_phase23_prefill"] = eps.get("launches")
            if "flash" in eps:
                k["by_shape"].append(eps["flash"])
            k["launches_phase24_dtensor_prefill"] = dry.get("launches")
        if k["name"] == "mlstm_chunk":
            k["launches_train_steps"] = {
                run: n.get("mlstm_chunk")
                for run, n in train_launches.items()}

    if FAILURES:
        log(f"FAILED phases: {FAILURES}")
        return 1
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:                     # noqa: BLE001 — fail loudly
        traceback.print_exc()
        code = 1
    sys.exit(code)
