"""Serving launcher: batched generation with the decode engine.

``python -m repro_torch.launch.serve --arch smollm-135m`` (any name of
``configs.ARCHS``: dense, moe, hybrid, vlm, audio and xlstm) serves the
model at its published widths with seeded random weights on the card
(the port of the reference's ``repro.launch.serve``, with ``--device``):
it prefills a batch of random prompts through the full-sequence prefill
step (on the card, the flash-attention kernel or the chunked-mLSTM
kernel), then generates greedily with ``ServeEngine`` and prints tokens
per second.  The weights are drawn from ``--seed`` on the serving device.
``--smoke`` takes the reduced config; ``--device cpu`` runs the kernels'
plain versions.

The prefill of a vlm or audio config takes seeded stand-in frontend
embeddings (``models.frontends.synthetic_frontend``: internvl2's patches,
seamless's frames).  The engine, as the reference's launcher runs it,
gets no frontend: it serves text only, and the encoder-decoder decodes
against its cache's zeroed encoder states.  As the reference's, it
clears the active mesh: serving runs the dense MoE.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_arch
from ..distrib.sharding import set_active_mesh
from ..kernels._cuda import resolve_device
from ..models import api
from ..models.frontends import synthetic_frontend
from ..serve.engine import ServeEngine
from ..train.step import make_prefill_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=24)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    device = resolve_device(args.device)
    set_active_mesh(None)        # host demo: serving stays dense
    # drawn on the serving device: a CPU generator takes longer to draw
    # xlstm-1.3b's 2.7e9 weights than the serving run itself (PERF.md)
    params = api.init_params(torch.Generator(device=device)
                             .manual_seed(args.seed), cfg, device=device)
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, size=(args.batch, args.prompt_len))

    batch = {"tokens": torch.from_numpy(prompts).to(device)}
    frontend = synthetic_frontend(cfg, args.batch, args.seed, device=device)
    if frontend is not None:
        batch["frontend"] = frontend
    t0 = time.time()
    last = make_prefill_step(cfg)(params, batch)
    _sync(device)
    print(f"prefill {args.batch}x{args.prompt_len} tokens in "
          f"{time.time() - t0:.2f}s; last-position logits "
          f"{tuple(last.shape)}")

    engine = ServeEngine(cfg, params, batch=args.batch, max_len=args.max_len)
    t0 = time.time()
    out = engine.generate(prompts, gen_len=args.gen_len)
    _sync(device)
    dt = time.time() - t0
    toks = args.batch * args.gen_len
    print(f"generated {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s batch={args.batch}) on {device}")
    print("sample continuation token ids:", out[0, :12].tolist())


if __name__ == "__main__":
    main()
