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

What runs: the data-parallel batch (``launch.train`` shards the global
batch by :func:`batch_spec` and averages gradients over the DP group) and
the expert split over 'model' (``models.moe.moe_ep``).  The
tensor-parallel 'model' placements of the dense weights and the FSDP
'data' placements are specs only, held against the reference's: the
dense layers run replicated over 'model', so the numbers are the same and
only memory and compute differ.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

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
    try:
        from torch.distributed.tensor import Replicate, Shard
    except ImportError:                     # torch < 2.4
        from torch.distributed._tensor import Replicate, Shard
    return Replicate, Shard


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
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:                     # torch < 2.4
        from torch.distributed._tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, placements(mesh, P(*spec)))
