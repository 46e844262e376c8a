"""simbench: the benchmark of the PyTorch and CUDA port of OmniSim.

One run measures one cell of ``BENCHMARK.json`` (a design configuration
under a traffic mix) on the card; see ``simbench/run.py``.
"""
