"""Frozen copies of the benchmarked designs, one module per design function.

Each module gives ``fifos(**params)`` (names in declaration order, which is
the order of a depth row's columns) and ``modules(**params)``: the module bodies as
generator functions that yield ``("r", fifo)`` or ``("w", fifo)``, in the
declaration order of the original design.
"""
