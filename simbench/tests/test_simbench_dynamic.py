"""The plain reference's general path (non-blocking accesses, probes,
delays, data) against the port's final answers, at small sizes."""
import numpy as np
import pytest

from simbench.reference.simulate import (DEADLOCK, LIVELOCK, REUSED, Design,
                                         _run_events, simulate)

# (design module, function, small parameters, lowest depth): a depth of 0
# makes a polling design spin (no answer from the port), so those draw
# from 1; the rest take 0, where blocking accesses deadlock
CASES = [("paper", "fig4_ex2", {"n": 40}, 1),
         ("paper", "fig4_ex3", {"n": 40}, 0),
         ("paper", "fig4_ex4a", {"n": 40}, 0),
         ("paper", "fig4_ex4a_d", {"n": 40}, 1),
         ("paper", "fig4_ex4b", {"n": 40}, 0),
         ("paper", "fig4_ex4b_d", {"n": 40}, 1),
         ("paper", "fig4_ex5", {"n": 40}, 0),
         ("paper", "fig2_timer", {"n": 40}, 1),
         ("paper", "deadlock", {"n": 40}, 0),
         ("paper", "branch", {"prog_len": 96, "stride": 8}, 0),
         ("paper", "multicore", {"cores": 3, "prog_len": 24, "stride": 4}, 0),
         ("typea", "flowgnn_like", {"n_nodes": 24, "layers": 2}, 0),
         ("typea", "high_latency_pipe",
          {"items": 20, "stages": 3, "ii": 9}, 0),
         ("dynamic", "watchdog_pipe",
          {"items": 40, "stages": 2, "depth": 4, "poll_gap": 8}, 1)]
ROWS = 40


def _port(module, fn, params):
    import importlib
    return getattr(importlib.import_module(f"repro_torch.designs.{module}"),
                   fn)(**params)


def _answer(status, cycles):
    return {REUSED: cycles, DEADLOCK: "deadlock", LIVELOCK: "spins"}[status]


def test_every_paper_design_has_a_case():
    from repro_torch.designs.paper import PAPER_DESIGNS
    assert set(PAPER_DESIGNS) <= {fn for _m, fn, _p, _lo in CASES}


@pytest.mark.parametrize("module,fn,params,lo", CASES,
                         ids=[c[1] for c in CASES])
def test_reference_gives_the_ports_final_answer(module, fn, params, lo):
    from repro_torch.core import simulate as port_simulate

    d = Design(fn, params)
    prog = _port(module, fn, params)
    assert d.fifos == tuple(f.name for f in prog.fifos)
    assert d.default_depths == prog.depths()
    # the counts come from the run at the default depths, event for event
    # the port's base graph (whose deadlocked modules have no end event)
    base = port_simulate(prog)
    assert d.n_nodes == len(base.graph.graph.nodes)
    rng = np.random.default_rng([len(d.fifos), lo, 31])
    D = rng.integers(lo, 6, size=(ROWS, len(d.fifos)))
    D[0] = d.default_depths
    want, got = [], []
    for row in D:
        r = port_simulate(_port(module, fn, params),
                          depths=tuple(int(x) for x in row))
        want.append("deadlock" if r.deadlock else r.cycles)
        got.append(_answer(*simulate(d, row)))
    assert got == want
    if lo == 0 and fn not in ("fig4_ex4a", "fig4_ex4b"):
        assert "deadlock" in want          # rows with a FIFO of depth 0


def test_a_fifo_of_depth_0_deadlocks_fig4_ex5():
    d = Design("fig4_ex5", {"n": 40})
    assert simulate(d, [0, 3])[0] == DEADLOCK
    assert simulate(d, [3, 0])[0] == DEADLOCK
    assert simulate(d, [1, 1])[0] == REUSED


def test_a_design_that_spins_has_no_answer_on_either_side():
    # the timer polls a done signal that a write of depth 0 never sends:
    # the port gives up at its step budget, the reference at its op budget
    from repro_torch.core import simulate as port_simulate

    d = Design("fig2_timer", {"n": 40})
    assert simulate(d, [4, 0], max_ops=20_000) == (LIVELOCK, -1)
    with pytest.raises(RuntimeError, match="livelock"):
        port_simulate(_port("paper", "fig2_timer", {"n": 40}),
                      depths=(4, 0), max_steps=20_000)
    # the budget counts ops, not cycles: a row with a long latency is slow,
    # not a livelock
    slow = Design("high_latency_pipe", {"items": 4, "stages": 2,
                                        "ii": 10 ** 7})
    status, cycles = simulate(slow, [2, 2, 2], max_ops=200)
    assert status == REUSED and cycles > 3 * 10 ** 7


@pytest.mark.parametrize("params", [{"m": 4, "k": 4, "n": 4},
                                    {"m": 16, "k": 16, "n": 16}])
def test_both_paths_agree_on_a_blocking_copy(params):
    d = Design("matmul_stream", params)
    assert d.static
    rng = np.random.default_rng(7)
    D = np.concatenate([rng.integers(1, 9, size=(24, 3)), [[0, 1, 1]]])
    for row in D:
        S = [int(x) for x in row]
        for half in (False, True):
            log = _run_events(d, S, half, 10 ** 8)
            assert (log.status, log.cycles) == simulate(
                d, S, "float16" if half else "int")


def test_a_copy_with_nonblocking_ops_needs_its_default_depths(tmp_path):
    (tmp_path / "nodepths.py").write_text(
        "def fifos():\n    return ('a',)\n\n\n"
        "def modules():\n"
        "    def p():\n        yield 'wnb', 'a', 1\n\n"
        "    def c():\n        yield 'rnb', 'a'\n\n"
        "    return [p, c]\n")
    with pytest.raises(ValueError, match="depths"):
        Design("nodepths", {}, tmp_path)


def test_float16_rounds_the_commit_times_of_the_general_path():
    d = Design("fig4_ex5", {"n": 1100})
    exact = simulate(d, [2, 2])
    half = simulate(d, [2, 2], dtype="float16")
    assert exact[0] == half[0] == REUSED
    assert exact[1] > 2048 and half[1] != exact[1]


def test_a_body_that_only_waits_spins_too(tmp_path):
    (tmp_path / "idle.py").write_text(
        "def fifos():\n    return ('a',)\n\n\n"
        "def depths():\n    return (1,)\n\n\n"
        "def modules():\n"
        "    def p():\n        yield 'w', 'a'\n\n"
        "    def c():\n        yield 'r', 'a'\n\n"
        "    return [p, c]\n")
    d = Design("idle", {}, tmp_path)
    assert simulate(d, [1]) == (REUSED, 3)
    assert simulate(d, [0]) == (DEADLOCK, -1)
    # waits, and nothing else, once the item it polls for is missing
    (tmp_path / "spin.py").write_text(
        "def fifos():\n    return ('a',)\n\n\n"
        "def depths():\n    return (1,)\n\n\n"
        "def modules():\n"
        "    def p():\n        yield 'w', 'a'\n\n"
        "    def c():\n"
        "        yield 'd', 1\n"
        "        ok, _ = yield 'rnb', 'a'\n"
        "        while not ok:\n            yield 'd', 1\n\n"
        "    return [p, c]\n")
    d = Design("spin", {}, tmp_path)
    assert simulate(d, [1]) == (REUSED, 3)
    assert simulate(d, [0], max_ops=1000) == (LIVELOCK, -1)
