"""The port's weight syncers against the JAX package's
(``tests/test_weight_sync.py``).

The delta codecs run in the test process against the JAX package's on the
same deltas. The syncers run in one gloo world of 4 processes, started
once for the module: the actor on ranks {0, 1} and the rollout on {2, 3},
each a tensor=2 mesh (the JAX tests' learner and rollout submeshes), with
the JAX tests' params and rules; each rollout rank returns the whole
weights it assembled after every sync.
The worlds of the test files take turns: each holds a lock in the test
session's temporary directory while it runs, so that test workers side
by side never run two at once.
"""

import concurrent.futures
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlinf_tpu.parallel import ComponentPlacement as JPlacement
from rlinf_tpu.parallel import MeshConfig as JMeshConfig
from rlinf_tpu.parallel.weight_sync import PatchWeightSyncer as JPatch
from rlinf_tpu_torch.parallel import worlds
from rlinf_tpu_torch.parallel import weight_sync as W
from rlinf_tpu_torch.parallel.launch import start_world
from rlinf_tpu_torch.parallel.mesh import MeshConfig

TP2 = MeshConfig(data=-1, tensor=2)


def _params(seed):
    r = np.random.default_rng(seed)
    return {"w1": r.normal(size=(16, 32)).astype(np.float32),
            "w2": r.normal(size=(32, 16)).astype(np.float32),
            "scale": r.normal(size=(16,)).astype(np.float32)}


def _normal_updates(params, n, scale=0.01):
    return [{k: (scale * np.random.default_rng(step).normal(size=v.shape)).astype(np.float32)
             for k, v in params.items()} for step in range(n)]


def _sin_updates(params, n):
    return [{k: np.full(v.shape, 0.005 * np.sin(float(step + 1)), np.float32)
             for k, v in params.items()} for step in range(n)]


def _topk_updates(params):
    one = {k: (0.05 * np.random.default_rng(9).normal(size=v.shape)).astype(np.float32)
           for k, v in params.items()}
    zero = {k: np.zeros_like(v) for k, v in params.items()}
    return [one] + [zero] * 11


CASES = {   # name -> (kind, params seed, updates, syncer kwargs)
    "full": ("full", 0, [], {}),
    "bucket": ("bucket", 1, "normal3", {"bucket_bytes": 1024}),
    "patch": ("patch", 2, "normal10", {"quantize": True}),
    "patch_sin": ("patch", 3, "sin20", {"quantize": True}),
    "topk": ("patch", 4, "topk", {"compression": "topk", "topk_ratio": 0.25}),
    "bf16": ("full", 4, [], {"dtype": torch.bfloat16}),
}


def _updates(spec, params):
    if spec == "normal3":
        return _normal_updates(params, 3)
    if spec == "normal10":
        return _normal_updates(params, 10)
    if spec == "sin20":
        return _sin_updates(params, 20)
    if spec == "topk":
        return _topk_updates(params)
    return spec


def _sources(params, updates):
    """The actor's whole weights after each sync."""
    out, cur = [], {k: v.copy() for k, v in params.items()}
    out.append({k: v.copy() for k, v in cur.items()})
    for u in updates:
        cur = {k: cur[k] + u[k] for k in cur}
        out.append({k: v.copy() for k, v in cur.items()})
    return out


@pytest.fixture(scope="module", autouse=True)
def world(tmp_path_factory):
    """The syncers' world, started with the module's first test;
    ``world()`` waits for it."""
    items = []
    for kind, seed, upd, kw in CASES.values():
        p = _params(seed)
        items.append(("weight_syncs", dict(kind=kind, actor_cfg=TP2, rollout_cfg=TP2, params=p,
                                           updates=_updates(upd, p), syncer_kwargs=kw)))
    pending = start_world(worlds.jobs, 4, (items, "cpu"), device="cpu",
                          workdir=str(tmp_path_factory.mktemp("sync_world")),
                          lock=str(tmp_path_factory.getbasetemp().parent / "worlds.lock"))

    @functools.cache
    def result():
        out = pending.result()
        return {name: [r[i] for r in out] for i, name in enumerate(CASES)}

    yield result
    concurrent.futures.wait([pending])


def _rollout(ranks):
    got = [r for r in ranks if r["role"] == "rollout"]
    assert len(got) == 2 and all(r["role"] == "actor" for r in ranks[:2])
    return got


def _max_err(a, b):
    return max(float(np.abs(a[k].astype(np.float32) - b[k]).max()) for k in b)


@pytest.fixture(scope="module")
def jax_patch(devices):
    placement = JPlacement(components={"learner": "0-3", "rollout": "4-7"},
                           mesh_configs={"rollout": JMeshConfig(data=-1, tensor=2)})
    return lambda **kw: JPatch(placement.mesh("rollout"), [(r".*", jax.sharding.PartitionSpec())],
                               **kw)


@pytest.mark.parametrize("block_size, n", [(256, 1000), (128, 4 * 512), (64, 37)])
def test_int8_codec_matches_jax_per_block(jax_patch, block_size, n):
    """The per-block int8 codec on the same deltas: q, the scales and the
    decoded delta equal the JAX package's."""
    delta = np.random.default_rng(n).normal(size=(n,)).astype(np.float32)
    delta[3] = 40.0                                   # an outlier in block 0
    jq, js = jax_patch(block_size=block_size)._encode_int8(jnp.asarray(delta))
    q, s = W.encode_int8(torch.as_tensor(delta), block_size)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(W.decode_int8(q, s, (n,)).numpy(),
                                  np.asarray(JPatch._decode_int8(jq, js, (n,))))


def test_topk_codec_matches_jax(jax_patch):
    delta = np.random.default_rng(7).normal(size=(40, 25)).astype(np.float32)
    jv, ji = jax_patch(compression="topk", topk_ratio=0.1)._encode_topk(jnp.asarray(delta))
    v, i = W.encode_topk(torch.as_tensor(delta), 0.1)
    assert sorted(i.tolist()) == sorted(np.asarray(ji).tolist())
    np.testing.assert_array_equal(W.decode_topk(v, i, delta.shape).numpy(),
                                  np.asarray(JPatch._decode_topk(jv, ji, delta.shape)))


def test_full_sync_across_meshes(world):
    """The whole weights arrive bitwise; each rollout rank keeps its
    tensor=2 block of w1 (16, 16); version 1 on every rank."""
    for r in _rollout(world()["full"]):
        full = r["got"][0]["full"]
        for k, v in _params(0).items():
            np.testing.assert_array_equal(full[k], v)
        assert r["got"][0]["blocks"]["w1"] == (16, 16)
        assert r["got"][0]["blocks"]["w2"] == (16, 16)
        assert r["got"][0]["blocks"]["scale"] == (16,)
    assert all(r["versions"] == [1] for r in world()["full"])


def test_bucket_sync_equivalent(world):
    """Buckets of 1 KB: after every sync the rollout ranks hold the
    actor's weights bitwise; every rank counts the same versions and bytes."""
    p = _params(1)
    want = _sources(p, _updates("normal3", p))
    for r in _rollout(world()["bucket"]):
        for got, w in zip(r["got"], want):
            for k in w:
                np.testing.assert_array_equal(got["full"][k], w[k])
    assert all(r["versions"] == [1, 2, 3, 4] for r in world()["bucket"])
    assert len({tuple(r["bytes"]) for r in world()["bucket"]}) == 1


def test_patch_sync_tracks_updates(world):
    """The first sync is exact; ten int8 patches of small updates stay
    within 5e-4 of the source and send under a third of the full bytes;
    version 11."""
    p = _params(2)
    want = _sources(p, _updates("normal10", p))
    for r in _rollout(world()["patch"]):
        for k in p:
            np.testing.assert_array_equal(r["got"][0]["full"][k], p[k])
        assert _max_err(r["got"][-1]["full"], want[-1]) < 5e-4
    full_bytes = world()["patch"][0]["bytes"][0]
    assert all(b < full_bytes / 3 for b in world()["patch"][0]["bytes"][1:])
    assert world()["patch"][0]["versions"][-1] == 11


def test_patch_sync_error_does_not_accumulate(world):
    p = _params(3)
    want = _sources(p, _updates("sin20", p))
    for r in _rollout(world()["patch_sin"]):
        errs = [_max_err(g["full"], w) for g, w in zip(r["got"][1:], want[1:])]
        assert errs[-1] < 1e-3
        assert errs[-1] < 10 * max(errs[2], 1e-6)


def test_patch_sync_topk_error_feedback(world):
    """One update, then syncs with no change at the source: each top-k
    round ships more of the outstanding delta (error feedback)."""
    p = _params(4)
    want = _sources(p, _updates("topk", p))
    full_bytes = world()["topk"][0]["bytes"][0]
    assert all(b < full_bytes for b in world()["topk"][0]["bytes"][1:])
    for r in _rollout(world()["topk"]):
        errs = [_max_err(g["full"], w) for g, w in zip(r["got"][1:], want[1:])]
        assert errs[-1] < errs[0] / 4
        assert errs[-1] < 5e-3


def test_dtype_conversion(world):
    for r in _rollout(world()["bf16"]):
        full = r["got"][0]["full"]
        for k, v in _params(4).items():
            np.testing.assert_array_equal(
                full[k], torch.as_tensor(v).to(torch.bfloat16).float().numpy())
    assert world()["bf16"][0]["bytes"][0] == sum(v.size for v in _params(4).values()) * 2


def test_registry():
    with pytest.raises(KeyError):
        W.make_weight_syncer("bogus", None, None)


def test_int8_blockwise_beats_per_tensor_outlier():
    """Per-block scales keep the small drift where one coordinate jumps."""
    delta = torch.full((4, 512), 1e-3)
    delta[0, 0] = 100.0
    got = W.decode_int8(*W.encode_int8(delta, 128), delta.shape)
    assert float(got[0, 0]) == pytest.approx(100.0, rel=1e-2)
    assert abs(float(got[3, 400]) - 1e-3) < 2e-4
