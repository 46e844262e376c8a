"""Mixture-of-Experts layer: top-k routing with two execution strategies.

The port of the reference's ``repro.models.moe``.

``impl="dense"`` (:func:`moe_dense`): masked dense compute, every padded
   expert on every token, weighted by the routing weights, with the
   reference's einsums and casts (E/K times the active FLOPs).

``impl="ep"`` (:func:`moe_ep`): expert parallelism over the mesh's
   'model' axis.  Each rank routes its token shard, fills a send buffer of
   per-expert capacity slots, exchanges expert blocks with an all-to-all
   over the 'model' process group, runs only its own experts over the
   tokens routed to them (three batched products), and sends the results
   back with the reverse all-to-all for the weighted combine: the
   reference's ``shard_map`` body step by step, on
   ``torch.distributed`` collectives that carry gradients.  A rank holds
   only its own experts' weights (``MoE(experts=)``,
   :func:`local_experts`), or all of them (then it uses its slice, and the
   slice's gradient is summed over 'model' into the whole stack's).

:func:`moe` is the reference's ``moe``: it takes the whole input,
replicated over 'model', and dispatches as the reference does: ``moe_ep``
iff ``impl == "ep"`` and a mesh is given, else ``moe_dense``.  On the EP
path it hands ``moe_ep`` this rank's sequence chunk and gathers the output
over 'model' (the layout change the reference's ``shard_map`` makes), and
adds the shared MLP on the whole input, outside, as the reference does.
The language model passes the active mesh in the full-sequence forward
and none in decode, so serving decodes densely, as in the reference.
Plain torch: the reference has no Pallas kernel here.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
from torch import nn

from ..configs.base import ArchConfig, MoEConfig
from ..distrib.sharding import is_dtensor, mesh_axes, on_local
from .common import dense_init, silu, weight
from .mlp import MLP, mlp


def padded_experts(mo: MoEConfig, expert_shards: int = 16) -> int:
    """Experts padded up to a multiple of the expert-shard count, as the
    reference pads them (granite: 40 -> 48; a smoke config: 8 -> 16).  The
    padding experts are never routed to, but their weights exist and
    enter :func:`moe_dense`'s products."""
    E = mo.num_experts
    return -(-E // expert_shards) * expert_shards


class MoE(nn.Module):
    """``router`` [d, E] and stacked expert weights ``w_gate``, ``w_up``
    [E, d, f] and ``w_down`` [E, f, d] (E padded), plus the ``shared``
    MLP when the config has shared experts.  ``experts=(lo, hi)`` holds
    only experts ``lo .. hi - 1`` (an expert-parallel rank's own); the
    router stays whole."""

    def __init__(self, cfg: ArchConfig, expert_shards: int = 16, *,
                 device=None, experts: Optional[Tuple[int, int]] = None):
        super().__init__()
        mo = cfg.moe
        d, f = cfg.d_model, mo.d_expert
        E = padded_experts(mo, expert_shards)
        self.experts = (0, E) if experts is None else tuple(experts)
        n = self.experts[1] - self.experts[0]
        self.router = weight((d, E), device)
        self.w_gate = weight((n, d, f), device)
        self.w_up = weight((n, d, f), device)
        self.w_down = weight((n, f, d), device)
        if mo.num_shared_experts:
            self.shared = MLP(d, mo.d_shared or mo.d_expert, device=device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> "MoE":
        """``init_moe``'s initializers: each expert's matrices uniform in
        ``1/sqrt(fan_in)``, as the router's.  Every padded expert is drawn
        in order, so a rank holding a slice has the whole layer's values
        for its experts."""
        E = self.router.shape[-1]
        lo, hi = self.experts
        self.router.copy_(dense_init(gen, *self.router.shape))
        for w in (self.w_gate, self.w_up, self.w_down):
            for e in range(E):
                v = dense_init(gen, *w.shape[1:])
                if lo <= e < hi:
                    w[e - lo].copy_(v)
        if hasattr(self, "shared"):
            self.shared.reset_parameters(gen)
        return self


def local_experts(cfg: ArchConfig, mesh, expert_axis: str = "model",
                  expert_shards: int = 16) -> Optional[Tuple[int, int]]:
    """The experts this rank holds under expert parallelism over
    ``expert_axis`` of ``mesh`` (a ``DeviceMesh``): ``(lo, hi)``, or
    ``None`` (all) with no mesh, no MoE, or an axis of one rank."""
    if mesh is None or cfg.moe is None:
        return None
    n = mesh_axes(mesh)[expert_axis]
    if n == 1:
        return None
    E_local = padded_experts(cfg.moe, expert_shards) // n
    r = mesh.get_local_rank(expert_axis)
    return r * E_local, (r + 1) * E_local


def _route(p: MoE, x: torch.Tensor, mo: MoEConfig):
    """Returns (weights [B,S,K] f32 normalised, idx [B,S,K] int32): f32
    router logits, the padding experts at -1e30, top-k in descending
    order, and a softmax over the k values."""
    logits = x.float() @ p.router.float()
    E = p.router.shape[-1]
    if E > mo.num_experts:      # padding experts can never be routed to
        pad = torch.arange(E, device=x.device) >= mo.num_experts
        logits = logits.masked_fill(pad, -1e30)
    weights, idx = torch.topk(logits, mo.top_k, dim=-1)
    return torch.softmax(weights, dim=-1), idx.to(torch.int32)


def moe_dense(p: MoE, x: torch.Tensor, cfg: ArchConfig,
              keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked dense MoE: out = sum_e gate_e(x) * FFN_e(x), every (padded)
    expert on every token, as the reference computes it (E/K times the
    active FLOPs).  The combine weights [B,S,E] hold each token's routing
    weight at its k experts (the reference's one-hot contraction: the k
    indices are distinct, so each entry is one weight or 0) and scale the
    hidden activations before the down projection.  ``keep`` ([B*S*K]
    bool, token-major as :func:`count_drops` records it) weighs the
    choices it marks false at zero: :func:`moe_ep`'s drops at a capacity,
    replayed on the plain lane."""
    mo = cfg.moe
    E = p.router.shape[-1]
    weights, idx = _route(p, x, mo)
    if keep is not None:
        weights = weights * keep.reshape(weights.shape)
    combine = torch.zeros(*idx.shape[:-1], E, dtype=torch.float32,
                          device=x.device)
    combine = combine.scatter(-1, idx.long(), weights).to(x.dtype)
    h = torch.einsum("bsd,edf->bsef", x, p.w_gate.to(x.dtype))
    u = torch.einsum("bsd,edf->bsef", x, p.w_up.to(x.dtype))
    h = silu(h) * u
    h = h * combine[..., None]
    out = torch.einsum("bsef,efd->bsd", h, p.w_down.to(x.dtype))
    if cfg.moe.num_shared_experts:
        out = out + mlp(p.shared, x)
    return out


# --------------------------------------------------------------------- EP path
_DROPS: Optional[list] = None


@contextlib.contextmanager
def count_drops():
    """Within the block, every :func:`moe_ep` call on this rank records its
    keep mask over its ``T * top_k`` choices (token-major, as the
    reference flattens them) and its experts' loads (choices routed to
    each padded expert, before the capacity).  The yielded dict is filled
    on exit: ``dropped`` and ``choices`` summed over the calls, and
    ``keep`` and ``load``, per call in call order (on the host)."""
    global _DROPS
    saved, _DROPS = _DROPS, []
    out = {}
    try:
        yield out
    finally:
        calls, _DROPS = _DROPS, saved
        out["keep"] = [k.cpu() for k, _ in calls]
        out["load"] = [n.cpu() for _, n in calls]
        out["choices"] = sum(m.numel() for m in out["keep"])
        out["dropped"] = sum(int((~m).sum()) for m in out["keep"])


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Dim 0 in equal blocks: peer j receives block j of every rank (in
    rank order); the gradient goes back by the same exchange."""
    import torch.distributed._functional_collectives as fc

    return fc.all_to_all_single_autograd(x.contiguous(), None, None, group)


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``x`` of every rank of ``group`` concatenated along ``dim``."""
    import torch.distributed._functional_collectives as fc

    # concatenates the ranks' tensors along dim 0, in rank order (named
    # all_gather_single from torch 2.13 on)
    gather = getattr(fc, "all_gather_single", None) or fc.all_gather_tensor
    g = gather(x.movedim(dim, 0).contiguous(), 0, group)
    if hasattr(g, "wait"):                  # an AsyncCollectiveTensor
        g = g.wait()
    return g.movedim(0, dim)


class _SeqSplit(torch.autograd.Function):
    """Forward: this rank's chunk of dim 1 of a tensor replicated over the
    group.  Backward: every rank's chunk gradient, gathered (the replicated
    input's gradient is the sum over chunks, each nonzero on its own)."""

    @staticmethod
    def forward(ctx, x, group, rank, n):
        ctx.group = group
        s = x.shape[1] // n
        return x[:, rank * s:(rank + 1) * s].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, 1, ctx.group), None, None, None


class _SeqGather(torch.autograd.Function):
    """Forward: every rank's chunk, gathered along dim 1 (the result is
    replicated over the group).  Backward: this rank's chunk of the
    gradient, which every rank holds whole; not a sum over ranks."""

    @staticmethod
    def forward(ctx, x, group, rank, n):
        ctx.rank, ctx.s = rank, x.shape[1]
        return _gather(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        r, s = ctx.rank, ctx.s
        return g[:, r * s:(r + 1) * s].contiguous(), None, None, None


class _SumGrad(torch.autograd.Function):
    """Identity forward; backward sums the gradient over the group.  The
    router is replicated while each rank routes only its own tokens, so
    its whole gradient is the sum of the ranks' parts."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        torch.distributed.all_reduce(g, group=ctx.group)
        return g, None


def seq_split(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """[B, S, ...] replicated over ``axis`` -> this rank's [B, S / n, ...]
    sequence chunk (the reference's ``shard_map`` in-spec over the
    sequence).  ``S % n != 0`` raises."""
    n = mesh_axes(mesh)[axis]
    if x.shape[1] % n:
        raise ValueError(f"sequence of {x.shape[1]} does not split over "
                         f"{n} ranks of the mesh axis {axis!r}")
    return _SeqSplit.apply(x, mesh.get_group(axis),
                           mesh.get_local_rank(axis), n)


def seq_gather(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """The inverse of :func:`seq_split`: the chunks of every rank of
    ``axis`` along dim 1, replicated."""
    n = mesh_axes(mesh)[axis]
    return _SeqGather.apply(x, mesh.get_group(axis),
                            mesh.get_local_rank(axis), n)


def _expert_weights(p: MoE, E_local: int, r: int, group):
    """This rank's expert weights: ``p``'s own if it holds ``E_local``
    experts, else its slice of all of them.  A whole stack is replicated
    over the group while each rank runs only its slice, so its gradient is
    summed over the group (each rank's part is nonzero on its slice
    alone), as the router's is."""
    ws = (p.w_gate, p.w_up, p.w_down)
    if p.w_gate.shape[0] == E_local:
        return ws
    if p.w_gate.shape[0] != p.router.shape[-1]:
        raise ValueError(f"the layer holds {p.w_gate.shape[0]} experts: "
                         f"neither this rank's {E_local} nor all "
                         f"{p.router.shape[-1]}")
    return tuple(_SumGrad.apply(w, group)[r * E_local:(r + 1) * E_local]
                 for w in ws)


def moe_ep(p: MoE, x: torch.Tensor, cfg: ArchConfig, mesh,
           expert_axis: str = "model", capacity_factor: float = 1.25,
           sum_replicated_grads: bool = True) -> torch.Tensor:
    """Expert-parallel MoE with PER-EXPERT capacity buffers.

    ``x`` is this rank's token shard [b, s_loc, D]: batch over the DP
    axes, sequence over ``expert_axis`` (the reference's ``token_spec``);
    the experts are split over ``expert_axis`` (n ranks, E_local = E_pad /
    n each).  Per rank, as the reference's ``local_fn``:

      1. f32 router logits (padding experts at -1e30), top-k, softmax;
         capacity ``C = max(4, ceil4(int(capacity_factor * top_k * T /
         E_pad)))`` for its ``T = b * s_loc`` tokens; each choice's rank
         within its expert from a stable sort; a send buffer [E_pad, C, D]
         holding each kept choice's token in its slot;
      2. an all-to-all over ``expert_axis``: each rank receives, from every
         peer, the blocks of its own experts, [n, E_local, C, D];
      3. per-expert batched products over the peer-major [E_local, n C, D];
      4. the reverse all-to-all and the f32 weighted combine.

    Dropless up to ``capacity_factor``; a choice past its expert's
    capacity contributes zero.  The shared MLP is not added here:
    :func:`moe` adds it on the whole input.  Runs under autograd: the
    all-to-alls carry gradients, and the gradients of the replicated
    router and of a whole expert stack are summed over ``expert_axis``
    (unless ``sum_replicated_grads`` is false: on DTensor parameters the
    caller's layout sums them, ``distrib.sharding.on_local``).
    """
    mo = cfg.moe
    n = mesh_axes(mesh)[expert_axis]
    E_pad = p.router.shape[-1]
    E_local = E_pad // n
    if E_local * n != E_pad:
        raise ValueError(f"{E_pad} experts do not split over {n} ranks")
    group = mesh.get_group(expert_axis)
    w_gate, w_up, w_down = _expert_weights(
        p, E_local, mesh.get_local_rank(expert_axis), group)
    router = _SumGrad.apply(p.router, group) \
        if n > 1 and sum_replicated_grads else p.router

    b, s_loc, D = x.shape
    T, K = b * s_loc, mo.top_k
    xt = x.reshape(T, D)
    logits = xt.float() @ router.float()
    if E_pad > mo.num_experts:
        pad = torch.arange(E_pad, device=x.device) >= mo.num_experts
        logits = logits.masked_fill(pad, -1e30)
    weights, idx = torch.topk(logits, K, dim=-1)              # [T, K]
    weights = torch.softmax(weights, dim=-1)
    # per-expert capacity
    C = int(capacity_factor * K * T / E_pad)
    C = max(4, -(-C // 4) * 4)
    flat_e = idx.reshape(-1).long()                           # [T*K]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # each expert's first position in the sorted order: the exclusive
    # cumsum of its count (bincount's, with no host sync)
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(E_pad, device=x.device))
    pos = torch.arange(T * K, device=x.device)
    rank = torch.empty_like(pos)
    rank[order] = pos - seg_start[sorted_e]
    keep = rank < C
    if _DROPS is not None:
        load = torch.diff(seg_start, append=seg_start.new_full((1,), T * K))
        _DROPS.append((keep.detach(), load))
    e_sel = torch.where(keep, flat_e, 0)
    r_sel = torch.where(keep, rank, C - 1)
    tok_of = torch.arange(T, device=x.device).repeat_interleave(K)
    # The reference adds each choice into its slot, a dropped one as zeros
    # into slot (0, C-1).  Kept choices own distinct slots, so writing
    # them alone gives the same buffer (up to the sign of a zero); the
    # dropped ones go to a spare row past the buffer instead of piling
    # onto one slot, which an accumulating scatter would serialise.
    dest = torch.where(keep, flat_e * C + rank, E_pad * C)
    send = torch.zeros(E_pad * C + 1, D, dtype=x.dtype, device=x.device) \
        .index_put((dest,), xt.index_select(0, tok_of))[:E_pad * C] \
        .view(E_pad, C, D)
    # exchange expert blocks: rank j receives block j from every peer
    recv = _all_to_all(send, group)
    # [n * E_local, C, D] -> [E_local, n*C, D] (peer-major slots)
    recv = recv.reshape(n, E_local, C, D).transpose(0, 1) \
        .reshape(E_local, n * C, D)
    h = torch.bmm(recv, w_gate.to(recv.dtype))
    u = torch.bmm(recv, w_up.to(recv.dtype))
    y = torch.bmm(silu(h) * u, w_down.to(recv.dtype))
    y = y.reshape(E_local, n, C, D).transpose(0, 1).reshape(E_pad, C, D)
    back = _all_to_all(y, group)
    flat = back.reshape(E_pad * C, D)                         # [E*C, D]
    # index_select: its backward adds with atomics, where an indexing's
    # sorts and serialises the dropped choices' reads of slot (0, C-1)
    per_k = torch.where(keep[:, None],
                        flat.index_select(0, e_sel * C + r_sel), 0)
    per_k = per_k.reshape(T, K, D).float()
    # the f32 weighted combine, sum_k w[t, k] * per_k[t, k], as one bmm
    out = torch.bmm(weights[:, None, :], per_k)[:, 0].to(x.dtype)
    return out.reshape(b, s_loc, D)


def _moe_ep_dtensor(p: MoE, x: torch.Tensor, cfg: ArchConfig, mesh
                    ) -> torch.Tensor:
    """:func:`moe_ep` on DTensors: ``x`` [B, S, D] redistributed to the
    token shards (batch over the DP axes, sequence over 'model'), the
    router whole and each expert stack split over 'model' (this rank's
    experts, gathered over 'data' where FSDP splits them).  The router's and the experts'
    gradients come back as partial sums that DTensor reduces into their
    own layouts (``on_local``), so ``moe_ep`` sums none itself.  The
    output comes back in ``x``'s layout."""
    import types

    def local(xl, router, w_gate, w_up, w_down):
        q = types.SimpleNamespace(router=router, w_gate=w_gate, w_up=w_up,
                                  w_down=w_down)
        return moe_ep(q, xl, cfg, mesh, sum_replicated_grads=False)

    tokens = ("dp", "model", None)
    experts = ("model", None, None)
    return on_local(local, (x, p.router, p.w_gate, p.w_up, p.w_down),
                    (tokens, (None, None), experts, experts, experts),
                    tokens, x.shape, out_like=x)


def moe(p: MoE, x: torch.Tensor, cfg: ArchConfig, mesh=None
        ) -> torch.Tensor:
    """The reference's dispatcher: :func:`moe_ep` iff ``impl == "ep"``
    and a mesh is given, else :func:`moe_dense`.  ``x`` is the whole
    [B, S, D] input, replicated over 'model'; with n > 1 ranks there,
    ``moe_ep`` takes this rank's sequence chunk and its output is gathered
    over 'model' (``S % n != 0`` raises).  The shared MLP runs on the
    whole input, outside ``moe_ep``, as in the reference."""
    if cfg.moe.impl != "ep" or mesh is None:
        return moe_dense(p, x, cfg)
    if is_dtensor(x):
        out = _moe_ep_dtensor(p, x, cfg, mesh)
    elif mesh_axes(mesh)["model"] == 1:
        out = moe_ep(p, x, cfg, mesh)
    else:
        out = seq_gather(moe_ep(p, seq_split(x, mesh), cfg, mesh), mesh)
    if cfg.moe.num_shared_experts:
        out = out + mlp(p.shared, x)
    return out
