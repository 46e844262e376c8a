"""Serving engines of the port (``engine``)."""
