"""Fault-tolerance substrate on one device: checkpoints and the host parts
of elastic scaling (the PyTorch port of ``repro.distrib``; its sharding
and mesh construction have no one-card meaning and are not ported)."""
