"""Optimizer, schedules and gradient compression: the PyTorch port of
``repro.optim``, as plain functions on trees of tensors."""
