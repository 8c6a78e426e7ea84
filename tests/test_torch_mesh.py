"""The port's meshes, placement, partition rules and collectives against the
JAX package's (``tests/test_mesh.py``).

What needs no world runs in the test process: a mesh built without
``torch.distributed`` is rank 0's view of it (its shape, coordinates and
blocks). What does needs one: a gloo world of 4 processes
(``parallel.launch.start_world``) started with the module, in which
the ranks build meshes, cut the JAX package's params into blocks and
gather them back, and run each collective forward and backward.
The worlds of the test files take turns: each holds a lock in the test
session's temporary directory while it runs, so that test workers side
by side never run two at once.
"""

import concurrent.futures
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from rlinf_tpu.data import io_struct as jio
from rlinf_tpu.models.llm import model as JM
from rlinf_tpu.models.llm.config import LLMConfig as JConfig
from rlinf_tpu.parallel import mesh as jmesh
from rlinf_tpu.parallel import sharding as jsharding
from rlinf_tpu_torch.data import io_struct as tio
from rlinf_tpu_torch.models.llm import model as TM
from rlinf_tpu_torch.models.llm.config import LLMConfig as TConfig
from rlinf_tpu_torch.models.llm.convert import params_from_numpy
from rlinf_tpu_torch.parallel import (
    AxisNames, ComponentPlacement, MeshConfig, PlacementMode, make_mesh,
    match_partition_rules, shard_pytree,
)
from rlinf_tpu_torch.parallel import sharding as tsharding
from rlinf_tpu_torch.parallel.distributed import choose_backend
from rlinf_tpu_torch.parallel.launch import start_world


def _cfgs():
    jcfg = dataclasses.replace(JConfig.tiny(), tie_word_embeddings=False, qkv_bias=True)
    return jcfg, TConfig(**dataclasses.asdict(jcfg))


def _jax_params(jcfg):
    return jax.tree_util.tree_map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))


def _spec(p) -> tuple:
    """A JAX PartitionSpec as the port's tuple."""
    return tuple(p)


WORLD_MESH = MeshConfig(data=1, fsdp=2, tensor=2)


@pytest.fixture(scope="module", autouse=True)
def world(tmp_path_factory):
    """One gloo world of 4: mesh facts, a shard/gather round trip of the
    JAX params, and the collectives; started with the module's first test,
    ``world()`` waits for it."""
    jcfg, tcfg = _cfgs()
    items = [
        ("mesh_facts", dict(mesh_cfg=WORLD_MESH)),
        ("shard_roundtrip", dict(mesh_cfg=WORLD_MESH, cfg=tcfg, params=_jax_params(jcfg))),
        ("collectives", dict()),
    ]
    from rlinf_tpu_torch.parallel import worlds

    pending = start_world(worlds.jobs, 4, (items, "cpu"), device="cpu",
                          workdir=str(tmp_path_factory.mktemp("mesh_world")),
                          lock=str(tmp_path_factory.getbasetemp().parent / "worlds.lock"))
    yield functools.cache(pending.result)
    concurrent.futures.wait([pending])


def test_mesh_config_resolve():
    for tc, jc in ((MeshConfig, jmesh.MeshConfig),):
        assert dataclasses.asdict(tc(data=-1, tensor=2).resolve(8)) == \
            dataclasses.asdict(jc(data=-1, tensor=2).resolve(8))
        with pytest.raises(ValueError):
            tc(data=3, tensor=2).resolve(8)
        with pytest.raises(ValueError):
            tc(data=-1, tensor=-1).resolve(8)
    from rlinf_tpu_torch import config as tconfig

    assert tconfig.MeshConfig is MeshConfig


def test_make_mesh_axes(devices):
    """Shape, axis order and each rank's coordinate are the JAX mesh's
    (device i of the JAX mesh is rank i)."""
    for cfg in (MeshConfig(data=-1, tensor=2), MeshConfig(data=2, fsdp=2, tensor=2)):
        tm = make_mesh(cfg, ranks=range(8), device_type="cpu")
        jm = jmesh.make_mesh(jmesh.MeshConfig(**dataclasses.asdict(cfg)))
        assert tm.shape == dict(jm.shape) and tuple(tm.shape) == tuple(jm.axis_names)
        assert set(tm.shape) == set(AxisNames.ALL)
        ids = np.vectorize(lambda d: d.id)(jm.devices)
        for r in range(8):
            pos = tuple(int(x) for x in np.argwhere(ids == r)[0])
            assert tuple(tm.coordinate(r).values()) == pos
        assert tm.get_group(AxisNames.TENSOR) is None          # no world: no groups


def test_component_placement_modes():
    kw = dict(world_size=8)
    collocated = ComponentPlacement(components={"actor": "0-7", "rollout": "0-7"}, **kw)
    assert collocated.mode == PlacementMode.COLLOCATED
    disagg = ComponentPlacement(components={"actor": "0-3", "rollout": "4-7"}, **kw)
    assert disagg.mode == PlacementMode.DISAGGREGATED
    assert disagg.device_indices("rollout") == [4, 5, 6, 7]
    hybrid = ComponentPlacement(components={"actor": "all", "rollout": "4-7"}, **kw)
    assert hybrid.mode == PlacementMode.HYBRID
    assert hybrid.device_indices("actor") == list(range(8))
    assert hybrid.pairwise_overlap("actor", "rollout") == (False, True)
    assert ComponentPlacement(components={"a": [0, 2], "b": "1,3"}, **kw).mode == \
        PlacementMode.DISAGGREGATED
    for spec in ("0-3", "0,2,4", [1, 5], 6):
        assert jmesh._parse_range(spec) == __import__(
            "rlinf_tpu_torch.parallel.mesh", fromlist=["_parse_range"])._parse_range(spec, 8)


def test_component_submesh():
    placement = ComponentPlacement(
        components={"actor": "0-3", "rollout": "4-7"},
        mesh_configs={"actor": MeshConfig(data=-1, tensor=2)}, world_size=8)
    actor = placement.mesh("actor")
    assert actor.size() == 4 and actor.shape[AxisNames.TENSOR] == 2
    assert actor.ranks == [0, 1, 2, 3] and placement.mesh("rollout").ranks == [4, 5, 6, 7]


def test_placement_bad_indices():
    with pytest.raises(ValueError):
        ComponentPlacement(components={"actor": "0-15"}, world_size=8)


def test_match_partition_rules_on_the_model_table(devices):
    """The real rule table: the same spec for every leaf as the JAX
    package's, and rank 0's block shapes are the JAX arrays' first
    addressable shards on the same mesh (data=2, fsdp=2, tensor=2)."""
    jcfg, tcfg = _cfgs()
    jp = _jax_params(jcfg)
    tp = params_from_numpy(jp, tcfg, device="cpu")
    assert [(p, _spec(s)) for p, s in TM.partition_rules()] == \
        [(p, _spec(s)) for p, s in JM.partition_rules()]
    tspecs = dict(tsharding.flatten_with_paths(match_partition_rules(TM.partition_rules(), tp)))
    jspecs = jsharding.match_partition_rules(JM.partition_rules(), jp)
    for (path, leaf), jspec in zip(jsharding._flatten_with_paths(jp),
                                   jax.tree_util.tree_leaves(
                                       jspecs, is_leaf=lambda x: isinstance(x, JP))):
        assert tspecs[path] == _spec(jspec), path
    cfg = MeshConfig(data=2, fsdp=2, tensor=2)
    tm = make_mesh(cfg, ranks=range(8), device_type="cpu")
    jm = jmesh.make_mesh(jmesh.MeshConfig(**dataclasses.asdict(cfg)))
    jsh = jsharding.shard_pytree(jax.tree_util.tree_map(jnp.asarray, jp), jspecs, jm)
    tsh = shard_pytree(tp, match_partition_rules(TM.partition_rules(), tp), tm)
    for (path, jleaf), (_, tleaf) in zip(jsharding._flatten_with_paths(jsh),
                                         tsharding.flatten_with_paths(tsh)):
        shard0 = next(s for s in jleaf.addressable_shards if s.device.id == 0)
        assert tuple(tleaf.shape) == shard0.data.shape, path
        np.testing.assert_array_equal(tleaf.numpy(), np.asarray(shard0.data))


def test_valid_spec_for_matches_jax(devices):
    """Dims that the axes do not divide stay whole, on every rule of the
    table, at shapes that do and do not divide."""
    cfg = MeshConfig(data=1, fsdp=2, tensor=4, expert=1)
    tm = make_mesh(cfg, ranks=range(8), device_type="cpu")
    jm = jmesh.make_mesh(jmesh.MeshConfig(**dataclasses.asdict(cfg)))
    for _, spec in TM.partition_rules():
        for shape in ((6, 9, 12, 5), (4, 8, 16, 32), (3, 5, 7, 8), (2, 4, 6, 8)):
            leaf = np.zeros(shape[:max(len(spec), 1)])
            assert tsharding._valid_spec_for(leaf, spec, tm) == \
                _spec(jsharding._valid_spec_for(leaf, JP(*spec), jm)), (spec, shape)


def test_unmatched_param_raises():
    with pytest.raises(ValueError, match="No partition rule"):
        match_partition_rules([], {"w": torch.zeros(4, 4)})
    assert match_partition_rules([], {"s": torch.zeros(())}) == {"s": ()}


def test_indivisible_dim_falls_back_to_replicated():
    mesh = make_mesh(MeshConfig(data=-1, tensor=2), ranks=range(8), device_type="cpu")
    params = {"w": torch.zeros(9, 9), "v": torch.arange(16.0).reshape(2, 8)}
    specs = match_partition_rules([(r"w", (None, AxisNames.TENSOR)),
                                   (r"v", (None, AxisNames.TENSOR))], params)
    sharded = shard_pytree(params, specs, mesh)
    assert sharded["w"].shape == (9, 9)
    assert torch.equal(sharded["v"], params["v"][:, :4])


def test_split_for_dp_matches_jax():
    r = np.random.default_rng(0)
    arrs = dict(input_ids=r.integers(0, 9, (8, 5)).astype(np.int32),
                attention_mask=r.random((8, 5)) > 0.2, target_ids=r.integers(0, 9, (8, 5)),
                loss_mask=r.random((8, 5)) > 0.5,
                old_logprobs=r.normal(size=(8, 5)).astype(np.float32),
                advantages=r.normal(size=(8, 5)).astype(np.float32))
    got = tio.split_for_dp(tio.TrainBatch(**arrs), 4)
    want = jio.split_for_dp(jio.TrainBatch(**arrs), 4)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for k, v in g.to_dict().items():
            np.testing.assert_array_equal(v, w.to_dict()[k])


def test_backend_choice():
    assert choose_backend("cuda", 4, 4) == "nccl"
    assert choose_backend("cuda", 4, 1) == "gloo"        # ranks share one card
    assert choose_backend("cpu", 2, 0) == "gloo"


def test_backend_choice_is_per_node(monkeypatch):
    """Two nodes of 8 GPUs, a world of 16: each rank has a card of its own,
    so NCCL, and rank 11 (the fourth of its node) sits on cuda:3."""
    from rlinf_tpu_torch.parallel import distributed as D

    assert choose_backend("cuda", 8, 8) == "nccl"
    assert choose_backend("cuda", 9, 8) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setattr(D.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(D.dist, "init_process_group", lambda *a, **k: seen.update(a=a, k=k))
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    seen = {}
    info = D.initialize_distributed("tcp://localhost:1", 16, 11, verbose=False)
    assert info["backend"] == "nccl" and info["device"] == torch.device("cuda", 3)
    assert seen["a"] == ("nccl",) and seen["k"]["device_id"] == torch.device("cuda", 3)


def test_world_mesh_groups(world):
    """Every rank's coordinate is the JAX mesh's, each axis's group sums
    the ranks along it, and the batch block is the rank's data x fsdp
    index."""
    facts = [r[0] for r in world()]
    jm = jmesh.make_mesh(jmesh.MeshConfig(**dataclasses.asdict(WORLD_MESH)),
                         devices=jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for rank, f in enumerate(facts):
        pos = tuple(int(x) for x in np.argwhere(ids == rank)[0])
        assert tuple(f["coord"].values()) == pos
        fs, tp = f["coord"]["fsdp"], f["coord"]["tensor"]
        assert f["sums"]["tensor"] == sum(2 * fs + t for t in range(2))
        assert f["sums"]["fsdp"] == sum(2 * x + tp for x in range(2))
        assert f["sums"]["data"] == rank                    # an axis of one: no group
        assert f["sums"][str(AxisNames.BATCH)] == f["sums"]["fsdp"]
        assert f["rows"] == (4 * fs, 4 * fs + 4)


def test_world_shard_gather_roundtrip(world, devices):
    """Blocks of the JAX params on each rank have the JAX shards' shapes
    and values; gathered back they are the params, bitwise."""
    jcfg, _ = _cfgs()
    jp = _jax_params(jcfg)
    jm = jmesh.make_mesh(jmesh.MeshConfig(**dataclasses.asdict(WORLD_MESH)),
                         devices=jax.devices()[:4])
    jsh = jsharding.shard_pytree(jax.tree_util.tree_map(jnp.asarray, jp),
                                 jsharding.match_partition_rules(JM.partition_rules(), jp), jm)
    for rank, r in enumerate(world()):
        got = r[1]
        for path, jleaf in jsharding._flatten_with_paths(jsh):
            shard = next(s for s in jleaf.addressable_shards if s.device.id == rank)
            assert got["shapes"][path] == shard.data.shape, (rank, path)
        for (path, want), (_, back) in zip(tsharding.flatten_with_paths(jp),
                                           tsharding.flatten_with_paths(got["back"])):
            np.testing.assert_array_equal(back, want.astype(np.float32), err_msg=path)


def test_world_collectives_forward_and_backward(world):
    """all_gather (both backwards), reduce_scatter, copy_to and all_reduce
    over the tensor group: each rank's values and gradients are the
    analytic ones (rank r holds x = r + [0, 1, 2, 3])."""
    for rank, r in enumerate(world()):
        c = r[2]
        lo = (rank // 2) * 2
        mates = [lo, lo + 1]
        xs = {m: m + np.arange(4.0) for m in mates}
        np.testing.assert_array_equal(c["gather"], np.concatenate([xs[m] for m in mates]))
        # loss = sum(w * gathered) with w = 1..8: reduce_scatter sums the
        # two ranks' identical w, split keeps one
        w = np.arange(1.0, 9.0)
        idx = rank - lo
        np.testing.assert_array_equal(c["gather_grad_rs"], 2 * w[4 * idx:4 * idx + 4])
        np.testing.assert_array_equal(c["gather_grad_split"], w[4 * idx:4 * idx + 4])
        # reduce_scatter of [x, x]: the sum over the group, this rank's half
        np.testing.assert_array_equal(c["reduce_scatter"], sum(xs[m] for m in mates))
        np.testing.assert_array_equal(c["all_reduce"], sum(xs[m] for m in mates))
        np.testing.assert_array_equal(c["all_reduce_grad"], np.ones(4))
        np.testing.assert_array_equal(c["copy_to_grad"], 2 * np.ones(4))
        assert c["max"] == max(mates) + 3.0


def test_global_device_put_and_logical_axes_match_jax(devices):
    """``global_device_put`` gives a rank its block of the batch rows
    (rank 0's view of a data=2 x fsdp=2 mesh: the first quarter, as JAX's
    device 0 shard); ``host_local_to_global`` keeps a rank's rows as they
    are; ``logical_to_mesh_axes`` maps names as the JAX package's;
    ``with_sharding_constraint`` returns its input."""
    from rlinf_tpu.parallel import distributed as jdist
    from rlinf_tpu_torch.parallel import distributed as tdist

    x = np.arange(32.0, dtype=np.float32).reshape(8, 4)
    cfg = MeshConfig(data=2, fsdp=2, tensor=2)
    tm = make_mesh(cfg, ranks=range(8), device_type="cpu")
    jm = jmesh.make_mesh(jmesh.MeshConfig(**dataclasses.asdict(cfg)))
    jx = jdist.global_device_put(x, jm, JP(AxisNames.BATCH, None))
    shard0 = next(s for s in jx.addressable_shards if s.device.id == 0)
    got = tdist.global_device_put(x, tm, (AxisNames.BATCH, None), device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(shard0.data))
    assert tdist.shard_rows_for_process(8, tm) == slice(0, 2)
    local = tdist.host_local_to_global({"a": x[:2]}, tm, device="cpu")
    np.testing.assert_array_equal(local["a"].numpy(), x[:2])
    mapping = {"batch": AxisNames.BATCH, "vocab": AxisNames.TENSOR, "embed": None}
    for names in (("batch", None, "vocab"), ("embed", "vocab")):
        assert tsharding.logical_to_mesh_axes(names, mapping) == \
            _spec(jsharding.logical_to_mesh_axes(names, mapping))
    t = torch.ones(2)
    assert tsharding.with_sharding_constraint(t, (AxisNames.TENSOR,)) is t
    assert tdist.process_info() == {"process_index": 0, "process_count": 1,
                                    "local_device_count": 1, "global_device_count": 1}
