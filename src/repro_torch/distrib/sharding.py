"""Sharding rules: parameter and activation partition specs.

The port of ``repro.distrib.sharding``.  Path-based rules map every
parameter to a :class:`PartitionSpec` over the production mesh axes
('pod', 'data', 'model'): one entry per tensor dim, each ``None`` (not
sharded), an axis name, or a tuple of names (sharded over their product,
major first).  The rules are the reference's, for its *stacked* leaves
([L, ...], or [G, M, ...] for the mLSTM) padded with leading ``None``s;
the port's parameters are per layer, so its spec is the reference's with
the stack axes dropped.  The size-adaptive FSDP threshold compares the
size of the whole stacked leaf (:func:`models.convert.by_reference_leaf`
gives the group), as the reference's does.

Policy (the reference's baseline):
  * tensor-parallel over 'model': attention heads / FFN hidden / vocab
  * experts sharded over 'model' (expert parallelism for MoE weights)
  * data-parallel batch over ('pod', 'data'), params replicated across pods
  * optimizer state mirrors param specs (ZeRO-style sharded moments)

The rules read only a mesh's axis names and sizes (:func:`mesh_axes`), so a
``torch.distributed.device_mesh.DeviceMesh`` (``mesh_dim_names``) and a
record of names and sizes (:class:`MeshShape`, or anything with
``axis_names`` and a ``shape`` mapping) both serve: the rules are checked
at 16x16 and 2x16x16 without 256 processes.  :func:`shardings_for` turns
specs into DTensor placements on a ``DeviceMesh``: per mesh dim,
``Shard(d)`` for the tensor dim ``d`` its axis shards, else
``Replicate()``.

What runs: :func:`device_put` (the reference's ``jax.device_put`` of a
tree under :func:`shardings_for`) turns a module's parameters, or an
``AdamWState``, into DTensors, so a rank holds only its shard: the
tensor-parallel 'model' placements and the FSDP 'data' placements
execute.  The models then run on DTensors: DTensor's own ops for the
projections, norms and the head, :func:`constrain` at the reference's
points, and :func:`on_local` where a function is per head (attention,
the mLSTM and SSD scans, the sLSTM loop: each rank runs its own heads on
plain tensors) or does its own collectives (``models.moe.moe_ep``).
Plain tensors that the models make (positions, masks) count as
replicated (:func:`replicated_context`).  ``launch.train`` distributes
the parameters and AdamW state; ``launch.dryrun`` runs every cell so on
a fake process group.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None``, an axis name, or a tuple of
    axis names.  Entries are canonical, as JAX's: a tuple of one name is
    that name, an empty one ``None``, a list a tuple."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_canonical(e) for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def _canonical(entry):
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return None if not entry else entry[0] if len(entry) == 1 else entry
    return entry


P = PartitionSpec


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, with no devices or processes behind
    it: what the rules read."""
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]


def mesh_shape(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> MeshShape:
    return MeshShape(tuple(axes), dict(zip(axes, shape)))


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size, in the mesh's order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                          # a DeviceMesh
        return dict(zip(names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def _base_spec(path: Tuple[str, ...], ndim: int) -> P:
    """Spec for the *unstacked* parameter at this path.

    Every large matrix is 2D-sharded: the tensor-parallel dim over 'model'
    and the other dim over 'data' (FSDP / ZeRO-3).  Optimizer moments
    inherit the same specs.
    """
    name = path[-1]
    in_moe = "moe" in path
    in_ssm = "ssm" in path or "mlstm" in path
    if name == "embed":
        return P("model", "data")
    if name == "lm_head":
        return P("data", "model")
    if name in ("wq", "wk", "wv"):
        return P("data", "model")
    if name == "wo":
        return P("model", "data")
    if name in ("bq", "bk", "bv"):
        return P("model")
    if in_moe and name in ("w_gate", "w_up"):
        return P("model", "data", None)        # experts over 'model', FSDP d
    if in_moe and name == "w_down":
        return P("model", None, "data")
    if in_moe and name == "router":
        return P("data", None)
    if name in ("w_gate", "w_up"):
        return P("data", "model")
    if name == "w_down":
        return P("model", "data")
    if in_ssm and name == "w_in":
        return P("data", "model")
    if in_ssm and name == "conv_w":
        return P(None, "model")
    if in_ssm and name == "w_bc":
        return P("model", "data")
    if in_ssm and name == "w_dt":
        return P("model", None)          # H may be < 16
    if in_ssm and name in ("w_q", "w_k"):
        return P("model", "data")
    if in_ssm and name == "d_skip":
        return P("model")
    if in_ssm and name == "w_out":
        return P("model", "data")
    if name == "w_if":
        return P("model", None)          # 2H may be < 16
    if name in ("w_gates",):                   # sLSTM input gates
        return P("data", "model")
    if name in ("r_gates",):
        return P(None, None, "model")
    if name == "w_out":
        return P("model", "data")
    return P()                                  # norms, biases: replicated


def param_spec(path: Tuple[str, ...], ndim: int) -> P:
    spec = _base_spec(path, ndim)
    pad = ndim - len(spec)
    if pad > 0:
        spec = P(*([None] * pad), *spec)
    elif pad < 0:
        # parameter is lower-rank than the rule (e.g. smoke configs): strip
        spec = P(*list(spec)[-ndim:]) if ndim else P()
    return spec


def _path_names(name: str) -> Tuple[str, ...]:
    """A dotted parameter name as a path: ``layers.3.moe.w_up`` ->
    ``("layers", "3", "moe", "w_up")``."""
    return tuple(name.split("."))


FSDP_MIN_ELEMS = 4_000_000     # below this, replicating over 'data' is
                               # cheaper than per-layer weight all-gathers


def _leaf_spec(path: Tuple[str, ...], ndim: int, size: int,
               fsdp_min_elems: int) -> P:
    spec = param_spec(path, ndim)
    if _TP_DEGREE == 1:
        spec = _strip_model(spec)
    if size and size < fsdp_min_elems and "data" in spec:
        spec = P(*[None if a == "data" else a for a in spec])
    return spec


def param_specs(params, fsdp_min_elems: int = FSDP_MIN_ELEMS) -> Any:
    """Specs matching ``params``: ``{name: spec}`` for a module (its
    ``named_parameters()``) or a mapping by parameter name (grads, AdamW
    moments); an ``AdamWState`` field by field (its ``step`` replicated).
    Works on ``device="meta"`` structures.

    Size-adaptive FSDP: a parameter whose *stacked* reference leaf (the
    group :func:`models.convert.by_reference_leaf` gives, times one
    member's size) is below ``fsdp_min_elems`` drops the 'data' axis.
    """
    from ..models.convert import by_reference_leaf

    if isinstance(params, tuple) and hasattr(params, "_fields"):
        return type(params)(*(
            _leaf_spec((f,), v.ndim, v.numel(), fsdp_min_elems)
            if isinstance(v, torch.Tensor) else param_specs(v, fsdp_min_elems)
            for f, v in zip(params._fields, params)))
    named = dict(params.named_parameters()) if isinstance(params, nn.Module) \
        else dict(params)
    size = {n: len(group) * named[n].numel()
            for group in by_reference_leaf(named).values() for n in group}
    return {n: _leaf_spec(_path_names(n), t.ndim, size[n], fsdp_min_elems)
            for n, t in named.items()}


_TP_DEGREE = 16


def set_tp_degree(d: int) -> None:
    """Per-arch parallelism policy: tp=1 folds the mesh 'model' axis into
    the data-parallel axes and strips 'model' from every param spec."""
    global _TP_DEGREE
    _TP_DEGREE = d


def tp_degree() -> int:
    return _TP_DEGREE


def _strip_model(spec: P) -> P:
    return P(*[None if a == "model" else a for a in spec])


def dp_axes(mesh) -> Tuple[str, ...]:
    names = tuple(mesh_axes(mesh))
    axes = [a for a in ("pod", "data") if a in names]
    if _TP_DEGREE == 1 and "model" in names:
        axes.append("model")
    return tuple(axes)


def batch_spec(mesh, ndim: int, shard_batch: bool = True,
               batch_size: int = 0) -> P:
    """Tokens/targets [B, S] or frontend [B, F, D]: batch over DP axes.

    Greedy: use the longest DP-axis prefix whose product divides the batch
    (pure-DP folds 'model' into DP, which can exceed small serving batches).
    """
    dp = dp_axes(mesh)
    if batch_size:
        sizes = mesh_axes(mesh)
        chosen = []
        prod = 1
        for a in dp:
            n = sizes[a]
            if batch_size % (prod * n) == 0:
                chosen.append(a)
                prod *= n
        dp = tuple(chosen)
    lead = dp if shard_batch and dp else None
    return P(lead, *([None] * (ndim - 1)))


def cache_spec(mesh, path: Tuple[str, ...], ndim: int,
               batch_one: bool = False) -> P:
    """Decode-cache leaves (the port's cache keeps the reference's stacked
    layout, so these are the reference's specs as they are).

    KV caches [L, B, T, Hkv, hd]: batch over DP axes; for batch=1 long-context
    cells the *sequence* axis is sharded over 'data' instead.  SSM/xLSTM
    state tensors shard over batch when possible, else replicate.
    """
    name = path[-1]
    dp = dp_axes(mesh)
    if _TP_DEGREE == 1:
        if name in ("k", "v") and ndim == 5:
            if batch_one:
                return P(None, None, "data", None, None)
            return P(None, dp, None, None, None)
    if name in ("k", "v") and ndim == 5:
        # [L, B, T, Hkv, hd]: batch over DP; head_dim over 'model'
        if batch_one:
            return P(None, None, "data", None, "model")
        return P(None, dp, None, None, "model")
    if name in ("k_scale", "v_scale") and ndim == 4:
        if batch_one:
            return P(None, None, "data", None)
        return P(None, dp, None, None)
    if name == "enc" and ndim == 3:
        return P(dp if not batch_one else None, None, None)
    if name == "pos":
        return P()
    # recurrent-state tensors: batch axis follows the stacked-layer axes —
    # [L, B, ...] for lm/hybrid caches, [G, M, B, ...] for mLSTM, [G, B, ...]
    # for sLSTM.
    if not batch_one and ndim >= 3:
        b_axis = 2 if "mlstm" in path else 1
        spec = [None] * ndim
        spec[b_axis] = dp
        return P(*spec)
    return P(*([None] * ndim))


# ------------------------------------------------------------ placements
def _placement_types():
    from torch.distributed.tensor import Replicate, Shard

    return Replicate, Shard


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``torch.distributed.tensor.DTensor`` (without
    importing torch.distributed for a plain tensor)."""
    if isinstance(x, torch.Tensor) and type(x) is not torch.Tensor \
            and type(x) is not nn.Parameter:
        from torch.distributed.tensor import DTensor

        return isinstance(x, DTensor)
    if isinstance(x, nn.Parameter):
        from torch.distributed.tensor import DTensor

        return isinstance(x.data, DTensor)
    return False


def placements(mesh, spec: P) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` for the tensor dim ``d`` whose entry names that axis
    (alone or in a tuple: ``("pod", "data")`` shards one dim on both),
    else ``Replicate()``."""
    Replicate, Shard = _placement_types()
    out = []
    for a in mesh_axes(mesh):
        dims = [d for d, e in enumerate(spec)
                if e == a or (isinstance(e, tuple) and a in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


class NamedSharding(NamedTuple):
    """A spec on a mesh; :attr:`placements` are its DTensor placements."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def _map_specs(fn, tree):
    if isinstance(tree, PartitionSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_specs(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_specs(fn, v) for v in tree)
    raise TypeError(f"not a spec tree: {type(tree).__name__}")


def shardings_for(mesh, specs) -> Any:
    return _map_specs(lambda s: NamedSharding(mesh, s), specs)


def local_slice(mesh, entry, length: int) -> slice:
    """This rank's part of a tensor dim of ``length`` whose spec entry is
    ``entry`` (``None``, an axis, or a tuple of axes, major first) on a
    ``DeviceMesh``."""
    axes = () if entry is None else (entry,) if isinstance(entry, str) \
        else tuple(entry)
    sizes = mesh_axes(mesh)
    index, parts = 0, 1
    for a in axes:
        index = index * sizes[a] + mesh.get_local_rank(a)
        parts *= sizes[a]
    if length % parts:
        raise ValueError(f"dim of {length} does not split over {axes} "
                         f"({parts} parts)")
    n = length // parts
    return slice(index * n, (index + 1) * n)


def local_shape_and_offset(shape, mesh, pl) -> Tuple[list, list]:
    """This rank's shard of a tensor of ``shape`` under placements ``pl``
    on ``mesh``: (its shape, the global index of its first element), by
    DTensor's rule (each split in mesh-dim order, ``ceil(n / parts)`` per
    rank, the last ranks fewer or none)."""
    shape, offset = list(shape), [0] * len(shape)
    for i, p in enumerate(pl):
        if p.is_shard():
            d, n = p.dim, mesh.size(i)
            chunk = -(-shape[d] // n)
            start = min(mesh.get_local_rank(i) * chunk, shape[d])
            size = max(0, min(shape[d], start + chunk) - start)
            offset[d] += start
            shape[d] = size
    return shape, offset


def _distribute(t: torch.Tensor, sh: NamedSharding) -> torch.Tensor:
    """``t`` (the whole tensor, the same on every rank) as a DTensor under
    ``sh``: each rank keeps its own shard, cut locally with no
    communication."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    d = distribute_tensor(t.detach(), sh.mesh, sh.placements,
                          src_data_rank=None)
    # a shard may be a view of the whole tensor: copy it, so the whole one
    # can be freed
    return DTensor.from_local(d.to_local().clone(), sh.mesh, sh.placements,
                              run_check=False, shape=d.shape,
                              stride=d.stride())


def device_put(tree, shardings):
    """The reference's ``jax.device_put(tree, shardings)``: every tensor
    of ``tree`` becomes a DTensor under its ``NamedSharding`` (from
    :func:`shardings_for`), so a rank holds only its shard.  A module's
    parameters are replaced in place (``shardings`` keyed by parameter
    name, as :func:`param_specs` gives them) and the module is returned;
    an ``AdamWState`` or a dict is rebuilt leaf by leaf.  Every leaf takes
    its placements as they are: nothing is left replicated that its spec
    shards.  A shard that does not divide evenly is DTensor's: the first
    ranks hold ``ceil(n / parts)`` rows and the last ones fewer, or
    none."""
    if isinstance(tree, nn.Module):
        for name, p in list(tree.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            mod = tree.get_submodule(owner) if owner else tree
            setattr(mod, leaf, nn.Parameter(_distribute(p, shardings[name]),
                                            requires_grad=p.requires_grad))
        return tree
    if isinstance(tree, torch.Tensor):
        return _distribute(tree, shardings)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(device_put(v, s)
                            for v, s in zip(tree, shardings)))
    if isinstance(tree, dict):
        return {k: device_put(v, shardings[k]) for k, v in tree.items()}
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def full(x):
    """A DTensor's whole value as a plain tensor (a gather); anything else
    as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def replicated_context(*tensors):
    """DTensor's ``implicit_replication`` when any of ``tensors`` is a
    DTensor, else nothing: under it, the plain tensors a model makes
    (positions, masks, a schedule's learning rate) count as replicated on
    the DTensors' mesh."""
    if any(is_dtensor(t) for t in tensors):
        from torch.distributed.tensor.experimental import \
            implicit_replication

        return implicit_replication()
    return contextlib.nullcontext()


def _entry_axes(mesh, entry) -> Tuple[str, ...]:
    if entry == "dp":
        return dp_axes(mesh)
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_placements(mesh, dims: Sequence) -> tuple:
    """Placements for a tensor whose dim ``d`` is split over the axes of
    ``dims[d]`` (``None``, an axis, a tuple of axes, or ``"dp"`` for the
    active DP axes): :func:`placements` of that spec.  An axis of one rank
    is left replicated; under pure DP (``tp_degree() == 1``) 'model' is a
    DP axis, so an entry ``"model"`` splits nothing, as in
    :func:`constrain`."""
    sizes = mesh_axes(mesh)
    spec = []
    for e in dims:
        if e == "model" and _TP_DEGREE == 1:
            e = None
        axes = tuple(a for a in _entry_axes(mesh, e) if sizes[a] > 1)
        spec.append(axes or None)
    return placements(mesh, P(*spec))


def on_local(fn: Callable, args: Sequence, dims: Sequence[Sequence],
             out_dims: Sequence, out_shape: Sequence[int],
             out_partial: Sequence[str] = (), out_like=None):
    """``fn`` on each rank's shards: the SPMD body of a function that is
    local to a layout (per head, per token).

    ``args`` are DTensors (a plain tensor or anything else is passed as it
    is); each is redistributed so that its dim ``d`` is split over
    ``dims[i][d]`` (see :func:`local_placements`) and handed to ``fn`` as
    its local tensor.  ``fn`` returns this rank's part of a tensor of
    ``out_shape`` split as ``out_dims`` (and a partial sum over the axes of
    ``out_partial``), returned as a DTensor, redistributed to the layout
    of the DTensor ``out_like`` if one is given.  Under autograd an argument
    that its layout leaves replicated over an axis that splits the output
    gets its gradient as a partial sum over that axis (each rank used it
    for its own part only: a replicated weight, a head-shared input);
    every other gradient comes back in the argument's layout.  Nothing is
    gathered but what the layouts need: a dim split over an axis stays
    split."""
    from torch.distributed.tensor import DTensor, Partial

    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    out_pl = list(local_placements(mesh, out_dims))
    for i, a in enumerate(mesh_axes(mesh)):
        if a in out_partial and mesh_axes(mesh)[a] > 1:
            out_pl[i] = Partial()
    splits = [not p.is_replicate() for p in out_pl]
    local = []
    for a, d in zip(args, dims):
        if not is_dtensor(a):
            local.append(a)
            continue
        pl = local_placements(mesh, d)
        gp = tuple(Partial() if p.is_replicate() and split else p
                   for p, split in zip(pl, splits))
        local.append(a.redistribute(mesh, pl).to_local(grad_placements=gp))
    out = fn(*local).contiguous()
    shape = tuple(int(n) for n in out_shape)
    stride, step = [], 1
    for n in reversed(shape):           # contiguous strides of the shape
        stride.insert(0, step)
        step *= max(n, 1)
    out = DTensor.from_local(out, mesh, tuple(out_pl), run_check=False,
                             shape=shape, stride=tuple(stride))
    if out_like is not None:
        out = out.redistribute(mesh, out_like.placements)
    return out


def reshape(x: torch.Tensor, *shape: int) -> torch.Tensor:
    """``x.reshape(*shape)``; on a DTensor whose split dim the reshape
    cuts unevenly (a feature dim of H * hd over 16 ranks into H heads with
    H % 16 != 0, or back), or whose split dims it merges (batch and
    sequence into rows), those dims are first gathered over their axes,
    as XLA's partitioner does for such a reshape; every other split
    stays.  The backward reshapes the gradient back by the same rule."""
    if not is_dtensor(x):
        return x.reshape(*shape)
    return _Reshape.apply(x, shape)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x [..., K] and w [K, F]; on DTensors, the weight
    gathered over its FSDP axes first (:func:`gather_fsdp`) and the
    product taken on x's rows [N, K] (:func:`reshape`), so that neither
    the forward nor the backward flattens two split dims into one."""
    if not is_dtensor(x):
        return x @ w
    w = gather_fsdp(w)
    if x.dim() == 2:
        return x @ w
    lead = x.shape[:-1]
    return reshape(reshape(x, -1, x.shape[-1]) @ w, *lead, w.shape[-1])


def embedding(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` as the embedding lookup; a DTensor table is gathered
    over the FSDP axes only: DTensor looks rows up in a table split over
    'model' on each rank's own rows (a masked partial sum, reduced where
    it is used).  Plain and DTensor tables take the same op, so their
    gradients sum the tokens' rows in the same order (on the card
    ``table[ids]``'s backward sums them otherwise)."""
    import torch.nn.functional as F

    return F.embedding(ids, gather_fsdp(table))


FSDP_AXES = ("pod", "data")


def gather_fsdp(w: torch.Tensor) -> torch.Tensor:
    """A DTensor weight whole over the FSDP axes ('pod', 'data') and
    still split over 'model': what a layer uses, ZeRO-3's all-gather
    before the use (its backward reduce-scatters the gradient into the
    shards).  A plain tensor as it is."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate

    names = w.device_mesh.mesh_dim_names
    pl = tuple(Replicate() if n in FSDP_AXES else p
               for n, p in zip(names, w.placements))
    return w if pl == tuple(w.placements) else \
        w.redistribute(w.device_mesh, pl)


class _Reshape(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = tuple(x.shape)
        return _reshape_dtensor(x, shape)

    @staticmethod
    def backward(ctx, g):
        return _reshape_dtensor(g, ctx.shape), None


def _reshape_dtensor(x, shape):
    """The placements a reshape keeps: a split dim before or after the
    reshaped region stays split; inside it, only the region's first dim,
    and only when its split divides the new first dim (a split of one dim
    into several) or the old one (a merge of several into one)."""
    from torch.distributed.tensor import Replicate

    old = tuple(x.shape)
    new = list(shape)
    if -1 in new:
        i = new.index(-1)
        rest = 1
        for j, n in enumerate(new):
            rest *= n if j != i else 1
        new[i] = x.numel() // rest if rest else 0
    k = 0
    while k < min(len(old), len(new)) and old[k] == new[k]:
        k += 1
    tail = 0
    while tail < min(len(old), len(new)) - k \
            and old[-1 - tail] == new[-1 - tail]:
        tail += 1
    end = len(old) - tail                 # the region is old[k:end]
    parts: Dict[int, int] = {}
    for p, n in zip(x.placements, x.device_mesh.shape):
        if p.is_shard():
            parts[p.dim] = parts.get(p.dim, 1) * n
    keep = []
    for p in x.placements:
        d = p.dim if p.is_shard() else None
        if d is None or d < k or d >= end:
            ok = True
        elif d != k:
            ok = False
        elif end - k == 1:                # one dim split into several
            ok = new[k] % parts[d] == 0
        else:                             # several merged into one
            ok = len(new) - tail - k == 1 and old[k] % parts[d] == 0
        keep.append(p if ok else Replicate())
    if tuple(keep) != tuple(x.placements):
        x = x.redistribute(x.device_mesh, keep)
    # DTensor reshapes the local shard with a view: give it dense rows
    local = x.to_local()
    if not local.is_contiguous():
        from torch.distributed.tensor import DTensor

        x = DTensor.from_local(local.contiguous(), x.device_mesh,
                               x.placements, run_check=False, shape=x.shape,
                               stride=x.stride())
    return x.reshape(*new)


def pointwise(fn: Callable, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for an elementwise ``fn`` that DTensor has no rule for
    (``logsigmoid``): on a DTensor, ``fn`` of each rank's shard in the
    same layout (a partial sum is reduced first)."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import DTensor, Replicate

    pl = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    x = x.redistribute(x.device_mesh, pl)
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, pl,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


HEAD_DIMS = ("dp", None, "model", None)      # [B, S, H, .]: batch, heads


def heads_split(mesh) -> int:
    """Ranks that split the heads: the 'model' axis, unless pure DP
    (``tp_degree() == 1``) has folded it into the batch."""
    return 1 if _TP_DEGREE == 1 else mesh_axes(mesh).get("model", 1)


def gqa_on_local(core: Callable, q, k, v):
    """``core(q, k, v, group_size)`` on each rank's own heads: q [B, S, H,
    hd] and k, v [B, Sk, Hkv, hd] (DTensors) with the batch over the DP
    axes and the heads over 'model', the sequence whole.  When the Hkv
    key/value heads do not split evenly over 'model', each query head
    takes its own copy of its key/value head first (group size 1), so
    that every rank's query heads find theirs locally; a rank then holds
    ``ceil(H / n)`` heads or fewer, the last ranks none.  Returns the
    output [B, S, H, hd] as a DTensor in the same layout."""
    H = q.shape[2]
    B, Sk, Hkv, hd = k.shape
    G = H // Hkv
    n = heads_split(q.device_mesh)
    if n > 1 and Hkv % n:
        k, v = (x[:, :, :, None].expand(B, Sk, Hkv, G, hd)
                .reshape(B, Sk, H, hd) for x in (k, v))
        G = 1
    return on_local(lambda a, b, c: core(a, b, c, G), (q, k, v),
                    (HEAD_DIMS,) * 3, HEAD_DIMS, q.shape)


# -------------------------------------------------------------- active mesh
# Launchers (train) register the mesh here so model code can place
# activations and take the expert-parallel MoE; tests and serving leave it
# unset, and every constraint is a no-op.
_ACTIVE_MESH: Optional[Any] = None


def set_active_mesh(mesh) -> None:
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def active_mesh():
    return _ACTIVE_MESH


def constrain(x, *axes):
    """Redistribute ``x`` to the spec if a mesh is active and ``x`` is a
    DTensor; a plain tensor comes back unchanged.

    ``axes`` entries: "dp" expands to the active DP axes; "model" as-is;
    None for unsharded dims.
    """
    mesh = _ACTIVE_MESH
    if mesh is None:
        return x
    spec = []
    for a in axes:
        if a == "dp":
            dp = dp_axes(mesh)
            spec.append(dp if dp else None)
        elif a == "model" and _TP_DEGREE == 1:
            spec.append(None)        # pure DP: 'model' already inside dp
        else:
            spec.append(a)
    if not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, placements(x.device_mesh, P(*spec)))
