"""Data pipeline (the PyTorch port's copy of ``repro.data``)."""
