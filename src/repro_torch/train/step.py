"""Train-step and serve-step factories: the port of the reference's
``repro.train.step``.

``make_train_step`` builds the update: loss -> grad -> global-norm clip ->
AdamW -> new params, as the reference's does.  Under an active mesh
(``distrib.sharding.set_active_mesh``; ``launch.train`` installs one) each
data-parallel rank holds its shard of the global batch, and the gradients
and the loss are averaged over the DP group before compression and the
clip (:func:`reduce_gradients`), so every rank takes the step the global
batch gives.  The loss runs the models'
training lane (plain torch under autograd; the hand-written kernels have
no backward); under ``cast_bf16`` it runs on bf16 copies of the f32
parameters (``models.common.cast_params``), so the gradients come back to
the f32 masters in f32.  The learning rate is the schedule at the step
counter *before* the update (the first update of a fresh state has lr 0
during warm-up), and the update overwrites the module's parameters and
the AdamW moments in place, leaf by leaf (``optim.adamw.adamw_update_``),
as the reference's launcher donates both.

On DTensor parameters and batches (``distrib.sharding.device_put``, as
``launch.train`` and ``launch.dryrun`` place them) the same steps run
sharded: DTensor reduces the gradients over the DP axes and the TP
splits, :func:`constrain_like_params` brings each gradient to its
parameter's placements, the global-norm clip sums every shard once, and
the update runs in place on each rank's shards.  The metrics come back as
plain tensors.

``make_prefill_step`` runs the whole prompt through the full-sequence
forward (on the card: the flash-attention kernel once per attention
layer, decoder layers for the encoder-decoder; the chunked-mLSTM kernel
once per mLSTM block for xlstm) and returns the last position's logits;
``make_decode_step`` takes one greedy token.

A batch's ``frontend`` (the vlm family's patch embeddings, the audio
family's frames) may come as numpy, as ``data.pipeline`` makes it: both
steps move it to the parameters' device as a tensor.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..distrib.sharding import (active_mesh, constrain, dp_axes, full,
                                is_dtensor, mesh_axes, param_specs,
                                placements, replicated_context)
from ..models import api
from ..models.common import cast_params
from ..models.convert import by_reference_leaf
from ..optim.adamw import (AdamWState, adamw_update_, clip_by_global_norm,
                           init_adamw)
from ..optim.compression import compress, decompress, init_residuals
from ..optim.schedules import cosine_schedule, wsd_schedule


def constrain_like_params(tree, params=None):
    """The reference pins grads and moments to the parameter shardings of
    its active mesh: a tree of DTensors (keyed by parameter name) is
    redistributed to the placements of the parameter of the same name in
    ``params`` (or, without it, of :func:`param_specs`); a partial sum
    over the DP axes is reduced into its shards here.  A tree of plain
    tensors comes back unchanged (as the reference's does with no
    mesh)."""
    if not any(is_dtensor(g) for g in tree.values()):
        return tree
    if params is None:
        specs = param_specs(tree)
        return {n: g.redistribute(g.device_mesh, placements(
            g.device_mesh, specs[n])) for n, g in tree.items()}
    return {n: g.redistribute(g.device_mesh, params[n].placements)
            for n, g in tree.items()}


def reduce_gradients(grads: Dict[str, torch.Tensor], loss: torch.Tensor,
                     mesh) -> torch.Tensor:
    """Average ``grads`` (in place) and ``loss`` over the mesh's DP axes;
    returns the loss.  Nothing happens on a mesh of one DP rank or with no
    mesh.  The MoE sums its own replicated weights' gradients over 'model'
    in its backward (``models.moe``).  DTensor gradients are left alone:
    DTensor has reduced them already, or holds them as partial sums that
    :func:`constrain_like_params` reduces, so none is reduced twice; the
    loss then comes back whole."""
    if any(is_dtensor(g) for g in grads.values()):
        return full(loss.detach())
    if mesh is None:
        return loss
    import torch.distributed as dist

    sizes = mesh_axes(mesh)
    dp = [a for a in dp_axes(mesh) if sizes[a] > 1]
    if not dp:
        return loss
    n = 1
    for a in dp:
        n *= sizes[a]
    loss = loss.detach().clone()
    for t in list(grads.values()) + [loss]:
        for a in dp:
            dist.all_reduce(t, group=mesh.get_group(a))
        t.div_(n)
    return loss


def lr_for(cfg: ArchConfig, step, total_steps: int = 10_000,
           peak_lr: float = 3e-4) -> torch.Tensor:
    if cfg.name.startswith("minicpm"):
        # MiniCPM trains with WSD (arXiv:2404.06395)
        return wsd_schedule(step, peak_lr=peak_lr, warmup_steps=100,
                            stable_steps=int(total_steps * 0.8),
                            decay_steps=int(total_steps * 0.1))
    return cosine_schedule(step, peak_lr=peak_lr, warmup_steps=100,
                           total_steps=total_steps)


def _frontend(batch: Dict[str, Any], device: torch.device
              ) -> Optional[torch.Tensor]:
    """``batch["frontend"]`` (numpy or a tensor) as a tensor on
    ``device``, or ``None``."""
    fe = batch.get("frontend")
    if fe is None:
        return None
    if isinstance(fe, np.ndarray):
        fe = torch.from_numpy(fe)
    return fe.to(device)


def _compress_roundtrip(grads: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """Error-feedback int8 within the step (residual from zero), as the
    reference applies it, with one scale per leaf of the *reference's*
    tree: the per-layer grads it stacks ([L, ...], [G, M, ...]) share one
    scale, so the numbers are the reference's."""
    groups = by_reference_leaf(grads)
    stacked = {k: torch.stack([grads[n] for n in names])
               for k, names in groups.items()}
    q, scales, _ = compress(stacked, init_residuals(stacked))
    deq = decompress(q, scales)
    return {n: deq[k][i] for k, names in groups.items()
            for i, n in enumerate(names)}


def make_train_step(cfg: ArchConfig, total_steps: int = 10_000,
                    peak_lr: float = 3e-4, max_grad_norm: float = 1.0,
                    cast_bf16: bool = True,
                    grad_compression: bool = False) -> Callable:
    def train_step(params, opt_state: AdamWState, batch: Dict[str, Any]):
        """params: an ``lm.LM`` or ``encdec.EncDec`` and opt_state its
        AdamW state (both updated in place; returned); batch: ``tokens``
        and ``targets`` [B, S] integer tensors on its device, and
        ``frontend`` [B, F, d] for vlm and audio.
        Returns (params, opt_state, metrics) with 0-dim tensors ``loss``,
        ``grad_norm`` and ``lr``."""
        named = dict(params.named_parameters())
        with replicated_context(*named.values()):
            return _train_step(params, named, opt_state, batch)

    def _train_step(params, named, opt_state, batch):
        with torch.enable_grad():
            # bf16 copies made once at step entry, f32 masters kept for
            # the optimizer (the reference's cast_bf16)
            p = cast_params(params, torch.bfloat16) if cast_bf16 \
                else params
            loss_val = api.loss_fn(p, batch["tokens"], batch["targets"],
                                   cfg, _frontend(batch, params.device))
            grads = dict(zip(named, torch.autograd.grad(
                loss_val, list(named.values()))))
            del p
        loss_val = reduce_gradients(grads, loss_val, active_mesh())
        if grad_compression:
            grads = _compress_roundtrip(grads)
        grads = constrain_like_params(grads, named)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        lr = lr_for(cfg, opt_state.step, total_steps, peak_lr)
        opt_state = adamw_update_(grads, opt_state, named, lr)
        metrics = {"loss": full(loss_val.detach()), "grad_norm": full(gnorm),
                   "lr": full(lr)}
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig) -> Callable:
    def prefill_step(params, batch: Dict[str, Any]) -> torch.Tensor:
        with replicated_context(batch["tokens"]):
            logits = api.forward(params, batch["tokens"], cfg,
                                 _frontend(batch, params.device))
            # serving returns only the last position's logits
            return logits[:, -1, :]

    return prefill_step


def make_decode_step(cfg: ArchConfig) -> Callable:
    def decode_step(params, tokens, cache):
        with replicated_context(tokens):
            logits, cache = api.decode_step(params, tokens, cache, cfg)
            # the vocab whole on each rank for the argmax (a no-op on
            # plain tensors)
            last = constrain(logits[:, -1, :], "dp", None)
            next_token = torch.argmax(last, dim=-1)[:, None]
            return next_token.to(torch.int32), cache

    return decode_step


def init_train_state(key, cfg: ArchConfig, *, device="cuda"):
    params = api.init_params(key, cfg, device=device)
    return params, init_adamw(params)
