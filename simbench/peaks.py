"""Published peaks of the cards the benchmark runs on, by the name that
``torch.cuda.get_device_name()`` gives: NVIDIA's H100 SXM data sheet, at
the full 700 W power limit. Only what a metric reads is listed.
"""
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}
