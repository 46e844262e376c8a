"""The plain reference of the benchmark: an event-level simulation of a
FIFO dataflow design (blocking and non-blocking accesses, probes, delays)
under given FIFO depths, in plain Python.

It imports nothing of the program under test. It reads its own frozen copy
of each design (``reference/designs/<design>.py``) and works the final
answer of every depth row (a cycle count, or a deadlock) out again from the
cost model alone.
"""
