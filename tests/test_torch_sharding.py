"""PyTorch port, the sharding rules, the meshes and the cell structures
against the reference (``repro.distrib.sharding``, ``repro.launch.specs``).

- ``param_specs`` for every config of ``ARCHS`` at full width, on
  shape-only structures (``jax.eval_shape`` for the reference,
  ``device="meta"`` for the port), at tp 16 and tp 1: the port's spec of
  each per-layer parameter equals the reference's spec of its stacked
  leaf with the stack axes dropped.
- ``dp_axes``, ``batch_spec`` and ``cache_spec`` on records of the
  16x16 and 2x16x16 production meshes' names and sizes (no devices), for
  every cache leaf of every config, with and without ``batch_one``.
- ``input_specs`` for every applicable cell of smollm-135m (dense, tp 1
  in training) and qwen3-moe-30b-a3b (moe) on a real (1, 1) mesh in each
  package (a one-process gloo group in the port): every sharding's spec,
  the donated arguments, and the structures' shapes.
- The port's DTensor placements, ``constrain``, and the mesh constructors on
  one process.

Every comparison is exact: the rules are the same functions of names,
ranks and sizes.  The module-level tp degree of both packages is
restored after each test that sets it.
"""
import types

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.distrib import sharding as ref_sh
from repro.launch import specs as ref_specs
from repro_torch.configs import ARCHS, SHAPES, shape_applicable
from repro_torch.distrib import sharding as sh
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import specs
from repro_torch.models.convert import reference_leaf

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(autouse=True)
def restore_tp():
    yield
    ref_sh.set_tp_degree(16)
    sh.set_tp_degree(16)
    sh.set_active_mesh(None)


@pytest.fixture(scope="module")
def structs():
    """(reference shape struct, port meta module) for every config."""
    return {name: (ref_specs.params_struct(REF_ARCHS[name]),
                   specs.params_struct(cfg))
            for name, cfg in ARCHS.items()}


@pytest.fixture(scope="module")
def group():
    """A one-process gloo group for the port's real (1, 1) mesh."""
    started = mesh_mod.init_process_group("cpu")
    yield
    if started:
        dist.destroy_process_group()


def test_mesh_constructors_need_a_process_group():
    if dist.is_initialized():
        pytest.skip("a process group is running in this process")
    with pytest.raises(RuntimeError, match="no process group"):
        mesh_mod.make_host_mesh()


def _at(tree, dotted):
    for part in dotted.split("."):
        tree = tree[part]
    return tree


def _padded(spec, ndim):
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def _same_param_specs(ref_tree, ref_struct, port_specs, port_named):
    """Each port parameter's spec is its reference leaf's, stack axes
    dropped; the port's parameters cover every reference leaf."""
    ref_leaves = {".".join(str(getattr(k, "key", k)) for k in path)
                  for path, _ in jax.tree_util.tree_flatten_with_path(
                      ref_struct)[0]}
    seen = set()
    for name, t in port_named.items():
        key = reference_leaf(name)
        seen.add(key)
        want = _padded(_at(ref_tree, key), _at(ref_struct, key).ndim)
        got = _padded(port_specs[name], t.ndim)
        assert got == want[len(want) - t.ndim:], (name, got, want)
        assert all(a is None for a in want[:len(want) - t.ndim]), name
    assert seen == ref_leaves


@pytest.mark.parametrize("tp", [16, 1])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_param_specs_are_the_references(structs, name, tp):
    ref_sh.set_tp_degree(tp)
    sh.set_tp_degree(tp)
    ref_struct, module = structs[name]
    named = dict(module.named_parameters())
    assert all(t.device.type == "meta" for t in named.values())
    _same_param_specs(ref_sh.param_specs(ref_struct), ref_struct,
                      sh.param_specs(module), named)


def test_the_fsdp_threshold_reads_the_stacked_leaf(structs):
    """granite's attention ``wk`` is 1 536 x 512 = 786 432 elements a
    layer, below the 4e6 threshold, but 32 layers stack to 25.2e6: the
    reference keeps 'data', and so must the port."""
    _, module = structs["granite-moe-3b-a800m"]
    wk = dict(module.named_parameters())["layers.0.attn.wk"]
    assert wk.numel() < sh.FSDP_MIN_ELEMS < 32 * wk.numel()
    assert sh.param_specs(module)["layers.0.attn.wk"] == ("data", "model")
    alone = sh.param_specs({"layers.0.attn.wk": wk})["layers.0.attn.wk"]
    assert alone == (None, "model")


@pytest.mark.parametrize("tp", [16, 1])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_and_dp_specs_are_the_references(mesh_name, tp):
    shape, axes = MESHES[mesh_name]
    duck = types.SimpleNamespace(axis_names=axes,
                                 shape=dict(zip(axes, shape)))
    ref_sh.set_tp_degree(tp)
    sh.set_tp_degree(tp)
    for m in (duck, sh.mesh_shape(shape, axes)):
        assert sh.dp_axes(m) == ref_sh.dp_axes(duck)
        for ndim in (2, 3):
            for shard in (True, False):
                for B in (0, 1, 2, 16, 32, 48, 128, 256, 512, 1024):
                    want = ref_sh.batch_spec(duck, ndim, shard, B)
                    got = sh.batch_spec(m, ndim, shard, B)
                    assert tuple(got) == tuple(want), (ndim, shard, B)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("tp", [16, 1])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_cache_specs_are_the_references(mesh_name, tp):
    shape, axes = MESHES[mesh_name]
    duck = types.SimpleNamespace(axis_names=axes,
                                 shape=dict(zip(axes, shape)))
    ref_sh.set_tp_degree(tp)
    sh.set_tp_degree(tp)
    n = 0
    for name, cfg in ARCHS.items():
        cache = specs.api.init_cache(cfg, 2, 64, device="meta")
        for path, leaf in _leaves(cache):
            for one in (False, True):
                want = ref_sh.cache_spec(duck, path, leaf.ndim, one)
                got = sh.cache_spec(duck, path, leaf.ndim, one)
                assert tuple(got) == tuple(want), (name, path, one)
                n += 1
    assert n > 50


def _same_shardings(ref, got):
    """Two trees of shardings (nested dicts or tuples) with equal specs."""
    if isinstance(got, sh.NamedSharding):
        assert tuple(got.spec) == tuple(ref.spec), (got.spec, ref.spec)
        return
    if isinstance(got, dict):
        assert set(got) == set(ref)
        for k in got:
            _same_shardings(ref[k], got[k])
        return
    assert len(got) == len(ref)
    for a, b in zip(ref, got):
        _same_shardings(a, b)


def _cells(name):
    cfg = ARCHS[name]
    return [c.name for c in SHAPES if shape_applicable(cfg, c)[0]]


@pytest.mark.parametrize("name,cell", [
    (n, c) for n in ("smollm-135m", "qwen3-moe-30b-a3b") for c in _cells(n)])
def test_input_specs_are_the_references(group, name, cell):
    cfg, rcfg = ARCHS[name], REF_ARCHS[name]
    tcell = next(c for c in SHAPES if c.name == cell)
    rcell = next(c for c in REF_SHAPES if c.name == cell)
    rmesh = jax.make_mesh((1, 1), ("data", "model"))
    tmesh = mesh_mod.make_host_mesh()
    r_fn, r_args, r_in, r_out, r_don = ref_specs.input_specs(rcfg, rcell,
                                                             rmesh)
    r_tp = ref_sh.tp_degree()
    t_fn, t_args, t_in, t_out, t_don = specs.input_specs(cfg, tcell, tmesh)
    assert sh.tp_degree() == r_tp and callable(t_fn)
    assert t_don == r_don and len(t_args) == len(r_args)
    assert len(t_in) == len(r_in)
    named = dict(t_args[0].named_parameters())
    # parameters: stack axes dropped, leaf by leaf
    _same_param_specs(jax.tree.map(lambda s: s.spec, r_in[0]), r_args[0],
                      {n: s.spec for n, s in t_in[0].items()}, named)
    for n, s in t_in[0].items():
        assert s.placements == sh.placements(tmesh, s.spec)
    if tcell.kind == "train":
        r_opt, t_opt = r_in[1], t_in[1]
        assert tuple(t_opt.step.spec) == tuple(r_opt.step.spec)
        for f in ("mu", "nu"):
            _same_param_specs(
                jax.tree.map(lambda s: s.spec, getattr(r_opt, f)),
                getattr(r_args[1], f),
                {n: s.spec for n, s in getattr(t_opt, f).items()}, named)
        _same_shardings(r_out[2], t_out[2])
        for k, v in t_args[2].items():
            assert tuple(v.shape) == r_args[2][k].shape
    if tcell.kind == "prefill":
        _same_shardings(r_in[1], t_in[1])
        _same_shardings(r_out, t_out)
        for k, v in t_args[1].items():
            assert tuple(v.shape) == r_args[1][k].shape
    if tcell.kind == "decode":
        _same_shardings(r_in[1], t_in[1])
        _same_shardings(r_in[2], t_in[2])
        _same_shardings(r_out, t_out)
        for path, leaf in _leaves(t_args[2]):
            ref_leaf = _at(r_args[2], ".".join(path))
            assert tuple(leaf.shape) == ref_leaf.shape, path
            assert leaf.device.type == "meta"


def test_placements_shard_each_named_dim():
    from torch.distributed.tensor import Replicate, Shard

    m3 = sh.mesh_shape((2, 16, 16), ("pod", "data", "model"))
    assert sh.placements(m3, sh.P(("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert sh.placements(m3, sh.P(None, "data")) == (
        Replicate(), Shard(1), Replicate())
    assert sh.placements(m3, sh.P()) == (Replicate(),) * 3
    tree = sh.shardings_for(m3, {"a": sh.P("model"), "b": {"c": sh.P()}})
    assert tree["a"].placements == (Replicate(), Replicate(), Shard(0))
    assert tree["b"]["c"].spec == ()


def test_partition_spec_copies_whole():
    import copy
    import pickle

    s = sh.P(None, ("pod", "data"), "model")
    assert copy.deepcopy(s) == s and pickle.loads(pickle.dumps(s)) == s
    assert tuple(s) == tuple(JP(None, ("pod", "data"), "model"))


def test_constrain_redistributes_a_dtensor_and_no_other(group):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    x = torch.arange(12.0).reshape(3, 4)
    assert sh.constrain(x, "dp", None) is x          # no mesh: no-op
    mesh = mesh_mod.make_host_mesh()
    sh.set_active_mesh(mesh)
    assert sh.constrain(x, "dp", None) is x          # a plain tensor
    dt = distribute_tensor(x, mesh, (Replicate(), Replicate()))
    got = sh.constrain(dt, "dp", "model")
    assert tuple(got.placements) == (Shard(0), Shard(1))
    assert torch.equal(got.full_tensor(), x)


def test_host_mesh_is_one_by_one_on_one_process(group):
    m = mesh_mod.make_host_mesh()
    assert sh.mesh_axes(m) == {"data": 1, "model": 1}
    assert m.get_local_rank("model") == 0
    with pytest.raises(RuntimeError, match="needs 256 processes"):
        mesh_mod.make_production_mesh()
    with pytest.raises(RuntimeError, match="needs 512 processes"):
        mesh_mod.make_production_mesh(multi_pod=True)

