"""Serving steps of the port (``step``); the training step comes later."""
