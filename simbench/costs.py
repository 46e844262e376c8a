"""What kernel 1 (the sparse max-plus fixpoint) has to move, counted from
the design's own sizes, never from the rounds a solve launches.

A solve of K depth rows over a design of n events, E reads and W writes on
F FIFOs (every access blocking) needs, read once: per event its chain weight
and seed contribution; per read its RAW edge (source, destination, weight)
and its column in its FIFO's read table; per write its WAR entry
(destination, sequence number, FIFO); per FIFO and per module two bounds;
and the K x F depth rows. It writes once the K x n int32 times. Counted once
per solver block, as the graph is read again by every block. For a design
with non-blocking accesses the sizes are those of its run at its default
depths (``reference.simulate.Design``), the graph that the program
re-solves.
"""
from __future__ import annotations

INT32 = 4
# the kernels of kernel 1, by the names the device trace gives them
KERNEL1 = ("segment_max_kernel", "segment_walk_kernel", "cross_pass_kernel")


def kernel1_bytes(design, rows: int, blocks: int) -> int:
    n, E, W = design.n_nodes, design.n_reads, design.n_writes
    F, M = len(design.fifos), len(design.codes)
    graph = INT32 * (2 * n + 4 * E + 3 * W + 2 * F + 2 * M)
    per_row = INT32 * (F + n)
    return blocks * graph + rows * per_row
