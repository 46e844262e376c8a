"""Fault tolerance and distribution (the PyTorch port of ``repro.distrib``):
checkpoints, elastic scaling, and the sharding rules over a
``DeviceMesh``."""
