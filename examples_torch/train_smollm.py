"""End-to-end training driver: a ~reduced smollm for a few hundred steps with
checkpoint/restart (kill it mid-run and re-launch: it resumes exactly).

    PYTHONPATH=src python examples_torch/train_smollm.py --steps 300
    PYTHONPATH=src python examples_torch/train_smollm.py --steps 2 --device cpu

The PyTorch port's copy of ``examples/train_smollm.py``: it spawns
``python -m repro_torch.launch.train`` with the reference's flags, on the
card by default (``--device cuda``, which fails without one; ``--device
cpu`` runs the plain versions on the host).  The full-scale path is
``python -m repro_torch.launch.train --arch smollm-135m``.

Unlike the reference's copy, which stops with a ``ShardingTypeError`` at
the embedding gather once its launcher installs the host mesh (jax 0.9),
this one trains.
"""
import argparse
import subprocess
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           "--arch", "smollm-135m", "--smoke",
           "--steps", str(args.steps), "--batch", "8", "--seq", "128",
           "--ckpt-every", "100", "--log-every", "20",
           "--device", args.device]
    raise SystemExit(subprocess.call(cmd))


if __name__ == "__main__":
    main()
