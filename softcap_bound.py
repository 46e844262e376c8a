#!/usr/bin/env python3
"""How close the flash kernel's softcap lane comes to its plain version, and
whether the comparison can see the cap.

Usage, from the repository root on a machine with one CUDA card and the
CUDA toolkit::

    python3 softcap_bound.py

At gemma2-2b's attention shape (B 1, S 8192, 8/4 heads, hd 256, bf16,
softcap 50, window 4096 and global) the script draws q, k and v from a
standard normal (numpy ``default_rng(seed)``, seeds 0-3), scales q by 1,
10 and 25 (scores of standard deviation 1, 10, 25: only the last two
reach the cap) and prints, for each case, the kernel's max abs error
from the plain version and its worst ratio to two bounds:

- ``assert_close``'s bf16 test, ``1e-3 + 2^-7 |plain|``;
- that test plus the kernel's rounding of P to bf16 before P.V,
  ``2^-8 sum_k p_k |v_k| / l`` a row (the plain version's attention of
  ``|v|``): where a few keys carry a row its output can be a small
  difference of large values, and the rounding of P scales with them.

The control is the kernel with softcap 0 on the same inputs: its error and
worst ratio to each bound, and the share of elements outside the second.
A bound that the control passes cannot see the cap.
"""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
SEEDS = 4


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("softcap_bound: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref as fr

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    B, S, H, Hkv, hd, cap = 1, 8192, 8, 4, 256, 50.0
    g = H // Hkv
    for seed in range(SEEDS):
        rng = np.random.default_rng(seed)
        q0, k, v = [torch.from_numpy(rng.standard_normal(
            (B * h, S, hd), dtype=np.float32)).to(dev, torch.bfloat16)
            for h in (H, Hkv, Hkv)]
        for scale in (1.0, 10.0, 25.0):
            q = q0 * scale
            for w in (4096, 0):
                kw = dict(window=w, group_size=g)
                want = fr.attention_ref(q, k, v, softcap=cap, **kw).float()
                spread = fr.attention_ref(q, k, v.abs(), softcap=cap,
                                          **kw).float()
                old = 1e-3 + 2.0 ** -7 * want.abs()
                new = old + 2.0 ** -8 * spread
                for lane, c in (("kernel", cap), ("softcap off", 0.0)):
                    got = fk.flash_attention_bhsd(q, k, v, softcap=c,
                                                  **kw).float()
                    d = (got - want).abs()
                    print(f"seed {seed} q x{scale:g} window {w} {lane}: "
                          f"max abs err {d.max().item():.4g}, worst / "
                          f"assert_close's {(d / old).max().item():.3f}, "
                          f"worst / with P's rounding "
                          f"{(d / new).max().item():.3f}, outside it "
                          f"{(d > new).float().mean().item():.4f}",
                          flush=True)
                    del got, d
                del want, spread, old, new
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
