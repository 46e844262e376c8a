"""The plain reference of the benchmark: an event-level simulation of a
blocking-FIFO dataflow design under given FIFO depths, in plain Python.

It imports nothing of the program under test. It reads its own frozen copy
of each design (``reference/designs/<design>.py``) and works the cycle count
of every depth row out again from the cost model alone.
"""
