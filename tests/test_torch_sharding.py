"""The port's sharding rules (``repro_torch.train.sharding``) against the
reference's rule functions, which are pure functions of a mesh's axis
names and sizes: the eight checks of ``tests/test_sharding.py`` on the
port, then every leaf of ``param_pspecs``, ``moment_pspecs`` and
``cache_pspecs``, and ``batch_pspec``, compared with the reference's for
all ten architectures on four fake meshes, with ``tensor_parallel`` as
configured and forced off; the per-layer specs the port's parameters
take; ``pspec_utils._resolve``; and the DTensor placements the specs
become on a real ``DeviceMesh``."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as RefP

from repro.configs import get_config as ref_get_config
from repro.models import pspec_utils as ref_pu
from repro.models.transformer import param_shapes as ref_param_shapes
from repro.serve.engine import init_decode_cache as ref_init_cache
from repro.train import sharding as ref_shd
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import pspec_utils as pu
from repro_torch.models.pspec_utils import P
from repro_torch.serve import engine as port_engine
from repro_torch.train import sharding as shd


class FakeMesh:
    """Just axis names + sizes — what the rule functions consume."""

    def __init__(self, shape: dict):
        self._shape = dict(shape)

    @property
    def axis_names(self):
        return tuple(self._shape)

    @property
    def shape(self):
        return self._shape


MESH = FakeMesh({"data": 16, "model": 16})
MESH3 = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = {"16x16": MESH, "2x16x16": MESH3,
          "7x7": FakeMesh({"data": 7, "model": 7}),
          "4x2": FakeMesh({"data": 4, "model": 2})}


def _port_cache(cfg, batch, context, monkeypatch):
    """The port's DecodeCache with every field on the meta device (the
    port's own shapes, nothing allocated)."""
    monkeypatch.setattr(port_engine, "resolve_device",
                        lambda d=None: torch.device("meta"))
    return port_engine.init_decode_cache(cfg, batch, context)


def _leaves(tree):
    """A tree's leaves in jax.tree.leaves' order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _ref_spec_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, RefP))


# -- the eight checks of tests/test_sharding.py, on the port ----------------

def test_param_pspec_rank_matches():
    for arch in ("qwen3-8b", "mixtral-8x7b", "mamba2-370m",
                 "recurrentgemma-2b", "hubert-xlarge"):
        cfg = get_config(arch)
        shapes = shd.param_shapes(cfg)
        specs = shd.param_pspecs(cfg, MESH, shapes)
        flat_s, flat_p = _leaves(shapes), _leaves(specs)
        assert len(flat_s) == len(flat_p)
        for s, p in zip(flat_s, flat_p):
            assert isinstance(p, P)
            assert len(p) <= len(s.shape), (arch, s.shape, p)


def test_indivisible_dims_degrade_to_replication():
    cfg = get_config("qwen3-8b")
    mesh7 = FakeMesh({"data": 7, "model": 7})
    spec = shd.param_pspecs(cfg, mesh7, shd.param_shapes(cfg))["embed"]
    assert spec == P(None, None)


def test_moe_expert_specs():
    cfg = get_config("mixtral-8x7b")
    specs = shd.param_pspecs(cfg, MESH, shd.param_shapes(cfg))
    assert specs["blocks"]["w_gate"] == P(None, None, "data", "model")
    assert specs["blocks"]["w_down"] == P(None, None, "model", "data")


def test_moment_specs_add_pod_axis():
    cfg = get_config("grok-1-314b")
    shapes = shd.param_shapes(cfg)
    m = shd.moment_pspecs(cfg, MESH3, shapes)
    assert m["blocks"]["wq"][0] == "pod"
    m2 = shd.moment_pspecs(cfg, MESH, shapes)
    p2 = shd.param_pspecs(cfg, MESH, shapes)
    assert m2["blocks"]["wq"] == p2["blocks"]["wq"]


def test_batch_pspec_divisibility():
    assert shd.batch_pspec(MESH3, 256, 2) == P(("pod", "data"), None)
    assert shd.batch_pspec(MESH3, 1, 2) == P(None, None)
    assert shd.batch_pspec(MESH, 8, 1) == P(None)
    # the scalar form, as the reference spells it
    assert shd.batch_pspec(FakeMesh({"data": 2, "model": 2}), 8, 2) == \
        P("data", None) != P(("data",), None)


def test_cache_pspecs_seq_sharded_when_kv_small(monkeypatch):
    cfg = get_config("qwen3-8b")
    specs = shd.cache_pspecs(cfg, MESH, _port_cache(cfg, 128, 32768,
                                                   monkeypatch)._replace(
        length=torch.empty((), device="meta")))
    assert specs.kv_k == P(None, "data", "model", None, None)


def test_cache_pspecs_head_sharded_when_divisible(monkeypatch):
    cfg = get_config("hubert-xlarge").with_(is_encoder=False)
    cache = _port_cache(cfg, 128, 1024, monkeypatch)
    specs = shd.cache_pspecs(cfg, MESH, cache._replace(
        length=torch.empty((), device="meta")))
    assert specs.kv_k == P(None, "data", None, "model", None)


def test_cache_pspecs_ssm(monkeypatch):
    cfg = get_config("mamba2-370m")
    cache = _port_cache(cfg, 128, 32768, monkeypatch)
    specs = shd.cache_pspecs(cfg, MESH, cache._replace(
        length=torch.empty((), device="meta")))
    assert specs.ssm_state == P(None, "data", "model", None, None)


# -- every leaf against the reference ----------------------------------------

def _cfgs(arch, tp):
    ref_cfg, cfg = ref_get_config(arch), get_config(arch)
    if tp == "off":
        ref_cfg = ref_cfg.with_(tensor_parallel=False)
        cfg = cfg.with_(tensor_parallel=False)
    return ref_cfg, cfg


@pytest.mark.parametrize("tp", ["configured", "off"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_moment_specs_equal_reference(arch, mesh, tp):
    ref_cfg, cfg = _cfgs(arch, tp)
    m = MESHES[mesh]
    ref_shapes, shapes = ref_param_shapes(ref_cfg), shd.param_shapes(cfg)
    assert [tuple(s.shape) for s in jax.tree.leaves(ref_shapes)] == \
        [tuple(s.shape) for s in _leaves(shapes)]
    for fn in ("param_pspecs", "moment_pspecs"):
        want = _ref_spec_leaves(getattr(ref_shd, fn)(ref_cfg, m, ref_shapes))
        got = _leaves(getattr(shd, fn)(cfg, m, shapes))
        assert [tuple(s) for s in got] == [tuple(s) for s in want], fn
    want = _ref_spec_leaves(ref_shd.param_pspecs(ref_cfg, m, ref_shapes,
                                                 decode=True))
    got = _leaves(shd.param_pspecs(cfg, m, shapes, decode=True))
    assert [tuple(s) for s in got] == [tuple(s) for s in want]


def _ref_layers_tree(ref_cfg, shapes):
    """The port's per-layer tree as the reference's unrolled ``layers``
    layout, in jax shape structs."""
    def conv(t):
        return jax.ShapeDtypeStruct(tuple(t.shape), np.float32)
    tree = {k: conv(v) for k, v in shapes.items() if k != "layers"}
    tree["layers"] = [{k: conv(v) for k, v in layer.items()}
                      for layer in shapes["layers"]]
    return tree


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_per_layer_specs_are_the_stacked_ones_without_the_layer_axis(
        arch, mesh):
    """Each of the port's parameters (``blocks.{i}.{name}``) takes the
    reference's stacked spec without its leading layer axis; its moments
    take the reference's rule on the per-layer tree (the same as the
    stacked moment spec's tail wherever 'pod' did not land on the layer
    axis)."""
    ref_cfg, cfg = _cfgs(arch, "configured")
    m = MESHES[mesh]
    ref_shapes = ref_param_shapes(ref_cfg)
    stacked = ref_shd.param_pspecs(ref_cfg, m, ref_shapes)
    stacked_m = ref_shd.moment_pspecs(ref_cfg, m, ref_shapes)
    flat = shd.flat_param_pspecs(cfg, m)
    flat_m = shd.flat_moment_pspecs(cfg, m)
    layers = shd.param_shapes(cfg, "layers")
    assert set(flat) == set(flat_m)
    for k in flat:
        if not k.startswith("blocks."):
            assert tuple(flat[k]) == tuple(stacked[k])
            assert tuple(flat_m[k]) == tuple(stacked_m[k])
    layout = shd.reference_layout(cfg)
    n_groups, _ = shd.hybrid_grouping(cfg)
    plen = len(cfg.block_pattern) or 1
    for i in range(cfg.n_layers):
        for name in layers["layers"][i]:
            got, got_m = flat[f"blocks.{i}.{name}"], \
                flat_m[f"blocks.{i}.{name}"]
            if layout == "blocks":
                s, sm = stacked["blocks"][name], stacked_m["blocks"][name]
            elif layout == "groups" and i < n_groups * plen:
                s = stacked["groups"][i % plen][name]
                sm = stacked_m["groups"][i % plen][name]
            else:
                j = i - n_groups * plen if layout == "groups" else i
                key = "tail" if layout == "groups" else "layers"
                s, sm = stacked[key][j][name], stacked_m[key][j][name]
                assert tuple(got) == tuple(s) and tuple(got_m) == tuple(sm)
                continue
            assert tuple(got) == tuple(s)[1:]
            if tuple(sm)[0] != "pod":
                assert tuple(got_m) == tuple(sm)[1:]
    # the moments of the per-layer tree are the reference rule's
    want = _ref_spec_leaves(ref_shd.moment_pspecs(
        ref_cfg, m, _ref_layers_tree(ref_cfg, layers)))
    got = _leaves(shd.moment_pspecs(cfg, m, layers))
    assert [tuple(s) for s in got] == [tuple(s) for s in want]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_pspec_equals_reference(mesh):
    m = MESHES[mesh]
    for batch in (1, 2, 3, 4, 7, 8, 14, 16, 32, 49, 64, 256, 512):
        for ndim in (1, 2, 3):
            for include_model in (False, True):
                want = ref_shd.batch_pspec(m, batch, ndim, include_model)
                got = shd.batch_pspec(m, batch, ndim, include_model)
                assert tuple(got) == tuple(want), (batch, ndim)
    for include_model in (False, True):
        assert shd.dp_axes(m, include_model) == \
            ref_shd.dp_axes(m, include_model)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_reference(arch, mesh, monkeypatch):
    ref_cfg, cfg = _cfgs(arch, "configured")
    if cfg.is_encoder:
        ref_cfg = ref_cfg.with_(is_encoder=False)
        cfg = cfg.with_(is_encoder=False)
    m = MESHES[mesh]
    for batch, context in ((128, 32768), (1, 4096)):
        ref_cache = jax.eval_shape(
            lambda: ref_init_cache(ref_cfg, batch, context))
        cache = _port_cache(cfg, batch, context, monkeypatch)
        want = ref_shd.cache_pspecs(ref_cfg, m, ref_cache)._asdict()
        got = shd.cache_pspecs(cfg, m, cache._replace(
            length=torch.empty((), device="meta")))._asdict()
        assert set(got) == set(want)
        for k in want:
            if want[k] is None:
                assert got[k] is None, k
            else:
                assert tuple(got[k]) == tuple(want[k]), k


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_resolve_equals_reference(mesh):
    m = MESHES[mesh]
    for dp in (("pod", "data"), ("pod", "data", "model"), ("data",)):
        with ref_pu.activation_sharding(m, dp), \
                pu.activation_sharding(m, dp):
            for axis in ("dp", "model", "data", "pod", None):
                for dim in (1, 2, 4, 7, 8, 14, 16, 32, 49, 96, 512, 4096):
                    assert pu._resolve(axis, dim, m) == \
                        ref_pu._resolve(axis, dim, m), (axis, dim, dp)
            assert pu.active_mesh() is m and pu.dp_axes() == dp
    assert pu.active_mesh() is None


def test_constrain_is_a_no_op_without_a_mesh_and_on_plain_tensors():
    x = torch.arange(24.).reshape(2, 3, 4)
    assert pu.constrain(x, "dp", None, None) is x
    with pu.activation_sharding(FakeMesh({"data": 2, "model": 1})):
        assert pu.resolve_spec(x, "dp", "model", None) == \
            P(("data",), "model", None)
        assert pu.constrain(x, "dp", None, None) is x
        with pytest.raises(ValueError, match="rank"):
            pu.constrain(x, "dp", None)


def test_placements_on_a_device_mesh():
    """Specs become DTensor placements mesh dim by mesh dim, and the
    port's parameter names all get one (a one-rank gloo group)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch.mesh import free_port
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1, 1),
                                mesh_dim_names=("pod", "data", "model"))
        assert pu.placements(mesh, P(("pod", "data"), None)) == \
            (Shard(0), Shard(0), Replicate())
        assert pu.placements(mesh, P(None, "model")) == \
            (Replicate(), Replicate(), Shard(1))
        cfg = get_config("qwen3-8b", smoke=True)
        pl = shd.param_placements(cfg, mesh)
        assert pl["blocks.0.wq"] == (Replicate(), Shard(0), Shard(1))
        assert pl["embed"] == (Replicate(), Shard(1), Shard(0))
        assert shd.moment_placements(cfg, mesh)["blocks.1.attn_norm"] == \
            (Shard(0), Replicate(), Replicate())
        # a batch is sharded only over axes of more than one rank
        assert shd.batch_placements(mesh, 8, 2) == (Replicate(),) * 3
        cache = port_engine.init_decode_cache(cfg, 2, 16, device="cpu")
        cp = shd.cache_placements(cfg, mesh, cache)
        assert cp.kv_k == (Replicate(), Replicate(), Shard(3))
        assert cp.length == (Replicate(),) * 3 and cp.ssm_state is None
    finally:
        dist.destroy_process_group()


def test_meshes_need_their_process_group():
    """A mesh spans the process group: none without one; the production
    meshes need exactly 256 or 512 ranks, the host mesh a model size that
    divides the group."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import (free_port, make_host_mesh,
                                         make_production_mesh)
    with pytest.raises(RuntimeError, match="initialize"):
        make_host_mesh(device="cpu")
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="needs 256 ranks"):
            make_production_mesh(device="cpu")
        with pytest.raises(RuntimeError, match="needs 512 ranks"):
            make_production_mesh(multi_pod=True, device="cpu")
        with pytest.raises(ValueError, match="does not divide"):
            make_host_mesh(model=2, device="cpu")
        mesh = make_host_mesh(device="cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1)
    finally:
        dist.destroy_process_group()
