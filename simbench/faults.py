"""Faults planted under the timed path, to show that the output check sees
them: each is a function ``plant(patch)`` that breaks the port through
``patch(owner, name, value)`` (``setattr``, or pytest's
``monkeypatch.setattr``). Used by ``tests/test_simbench_control.py`` on the
CPU and by ``tools/control.py --fault`` on the card at a cell's own size.
``FAULTS`` can touch every cell; ``FALLBACK_FAULTS`` only the rows that the
solver cannot reuse, which a cell has where its design has non-blocking
accesses or its rows deadlock.
"""
from __future__ import annotations

import numpy as np


def state_unchanged(patch) -> None:
    """Kernel 1 returns its seed state: no round runs."""
    import torch
    from repro_torch.kernels.maxplus import sparse

    def solve(arr, depth):
        K = depth.shape[0]
        c = arr.c_seed[:, None].expand(arr.n, K).clone()
        return c, torch.ones(K, dtype=torch.bool, device=depth.device), 1
    patch(sparse, "solve_chains", solve)


def half_batch(patch) -> None:
    """A block solves its first half only and answers the rest with the
    mean of the half it solved."""
    from repro_torch.core import dse
    from repro_torch.sweep import scheduler
    real = dse.solve_block_status

    def solve(cache, D, *a, **kw):
        D = np.asarray(D)
        h = max(len(D) // 2, 1)
        st, cy, vi, r = real(cache, D[:h], *a, **kw)
        rest = len(D) - h
        return (np.concatenate([st, np.zeros(rest, st.dtype)]),
                np.concatenate([cy, np.full(rest, int(cy.mean()))]),
                np.concatenate([vi, np.zeros(rest, vi.dtype)]), r)
    patch(dse, "solve_block_status", solve)
    patch(scheduler, "solve_block_status", solve)


def answer_altered(patch) -> None:
    """Kernel 1's time of the last event of the last module is one cycle
    late, in every row."""
    from repro_torch.kernels.maxplus import sparse
    real = sparse.solve_chains

    def solve(arr, depth):
        t, conv, rounds = real(arr, depth)
        t = t.clone()
        t[-1] += 1
        return t, conv, rounds
    patch(sparse, "solve_chains", solve)


def fallback_skipped(patch) -> None:
    """Rows the solver cannot reuse (deadlock, WAR cycle, violated) come
    back with its verdict alone, without the full re-simulation."""
    from repro_torch.core import dse
    from repro_torch.sweep import scheduler
    real = dse.materialize_block

    def materialize(result, Du, status_u, cycles_u, violated_u,
                    fallback_mask, *a, **kw):
        return real(result, Du, status_u, cycles_u, violated_u,
                    np.zeros_like(fallback_mask), *a, **kw)
    patch(dse, "materialize_block", materialize)
    patch(scheduler, "materialize_block", materialize)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered}
FALLBACK_FAULTS = {"fallback_skipped": fallback_skipped}
