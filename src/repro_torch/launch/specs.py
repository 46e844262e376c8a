"""Shape-only stand-ins + shardings for every (arch x shape) cell.

The port of ``repro.launch.specs``.  ``input_specs`` returns (fn, args,
in_shardings, out_shardings, donate_argnums) for the cell's entry point:
train_4k builds ``train_step``; prefill_32k ``prefill_step``; decode_32k
/ long_500k ``decode_step`` (one new token against a full KV/state cache
of the cell's seq_len), never train_step.

No memory is allocated: parameters, AdamW state, batches and caches are
built on ``device="meta"`` with no initializer run (the counterpart of
``jax.eval_shape``), so a full-width model costs nothing.  Shardings are
the port's specs and DTensor placements
(``distrib.sharding.NamedSharding``) on the given mesh; the parameters'
are keyed by the port's per-layer names.  ``device=`` builds the same
structures elsewhere: the dry run builds them on the CPU under a
``FakeTensorMode`` (shapes, no data) and distributes each argument under
its sharding with ``distrib.sharding.device_put``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs.base import ArchConfig, ShapeCell
from ..distrib.sharding import (NamedSharding, P, batch_spec, cache_spec,
                                dp_axes, param_specs, set_tp_degree,
                                shardings_for)
from ..models import api
from ..models.encdec import EncDec
from ..models.lm import LM
from ..optim.adamw import init_adamw
from ..train.step import make_decode_step, make_prefill_step, make_train_step

META = torch.device("meta")


def params_struct(cfg: ArchConfig, device=META):
    return (EncDec if cfg.family == "audio" else LM)(cfg, device=device)


def opt_struct(params):
    return init_adamw(params)


def batch_struct(cfg: ArchConfig, cell: ShapeCell, with_targets: bool,
                 device=META):
    B, S = cell.global_batch, cell.seq_len
    S_tok = S - cfg.frontend_tokens if cfg.family == "vlm" else S
    batch = {"tokens": torch.zeros((B, S_tok), dtype=torch.int32,
                                   device=device)}
    if with_targets:
        batch["targets"] = torch.zeros((B, S_tok), dtype=torch.int32,
                                       device=device)
    if cfg.frontend_tokens:
        batch["frontend"] = torch.zeros(
            (B, cfg.frontend_tokens, cfg.d_model), dtype=torch.float32,
            device=device)
    return batch


def batch_shardings(mesh, batch: Dict[str, torch.Tensor]):
    return {k: NamedSharding(mesh, batch_spec(mesh, v.ndim,
                                              batch_size=v.shape[0]))
            for k, v in batch.items()}


def _cache_specs(tree, mesh, batch_one: bool, path: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        return {k: _cache_specs(v, mesh, batch_one, path + (k,))
                for k, v in tree.items()}
    return cache_spec(mesh, path, tree.ndim, batch_one=batch_one)


def cache_struct_and_sharding(cfg: ArchConfig, cell: ShapeCell, mesh,
                              device=META):
    B = cell.global_batch
    struct = api.init_cache(cfg, B, max_len=cell.seq_len, device=device)
    specs = _cache_specs(struct, mesh, batch_one=B == 1)
    return struct, shardings_for(mesh, specs)


def input_specs(cfg: ArchConfig, cell: ShapeCell, mesh, device=META
                ) -> Tuple[Any, ...]:
    """Returns (fn, args, in_shardings, out_shardings, donate_argnums);
    ``args`` on ``device`` (default ``"meta"``)."""
    # pure-DP policy applies to training cells; serving keeps TP so the
    # KV cache / vocab stay sharded over 'model'.
    tp = getattr(cfg, "tp_degree", 16)
    set_tp_degree(1 if (tp == 1 and cell.kind == "train") else 16)
    pstruct = params_struct(cfg, device)
    psh = shardings_for(mesh, param_specs(pstruct))
    repl = NamedSharding(mesh, P())

    if cell.kind == "train":
        fn = make_train_step(cfg)
        ostruct = opt_struct(pstruct)
        osh = shardings_for(mesh, param_specs(ostruct))
        batch = batch_struct(cfg, cell, with_targets=True, device=device)
        bsh = batch_shardings(mesh, batch)
        metrics_sh = {"loss": repl, "grad_norm": repl, "lr": repl}
        # params and AdamW state are updated in place
        return (fn, (pstruct, ostruct, batch), (psh, osh, bsh),
                (psh, osh, metrics_sh), (0, 1))

    if cell.kind == "prefill":
        fn = make_prefill_step(cfg)
        batch = batch_struct(cfg, cell, with_targets=False, device=device)
        bsh = batch_shardings(mesh, batch)
        vocab_axis = None if getattr(cfg, "tp_degree", 16) == 1 else "model"
        out_sh = NamedSharding(mesh, P(dp_axes(mesh) or None, vocab_axis))
        return fn, (pstruct, batch), (psh, bsh), out_sh, ()

    # decode: one new token against a seq_len-deep cache
    fn = make_decode_step(cfg)
    B = cell.global_batch
    tokens = torch.zeros((B, 1), dtype=torch.int32, device=device)
    tok_sh = NamedSharding(mesh, batch_spec(mesh, 2, shard_batch=B > 1,
                                            batch_size=B))
    cstruct, csh = cache_struct_and_sharding(cfg, cell, mesh, device)
    # the cache is updated in place
    return (fn, (pstruct, tokens, cstruct), (psh, tok_sh, csh),
            (tok_sh, csh), (2,))
