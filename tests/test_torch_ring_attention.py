"""The port's ring attention over the context axis against the JAX
package's (``tests/test_ring_attention.py``).

The port runs in one gloo world of 4 CPU processes (``parallel.launch``),
started once for the module; its ranks run every case
(``parallel/worlds.py``) while the test process computes the JAX side on
the 8 virtual CPU devices. A context group of 2 runs as two meshes side by
side ({0, 1} and {2, 3}); of 4, as one. Each case runs the ring shift in
both of its forms: point to point (gloo on CPU tensors) and built from the
zero-padded all-reduce (as on CUDA tensors of a gloo group, forced here by
replacing ``collectives._emulated``). Inputs are f32; the right padding
includes a row with no valid key at all, which ends as the mean of the
values it visited in both packages.
The worlds of the test files take turns: each holds a lock in the test
session's temporary directory while it runs.
"""

import concurrent.futures
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from rlinf_tpu.ops.ring_attention import ring_attention as jring
from rlinf_tpu.parallel import mesh as jmesh
from rlinf_tpu_torch.ops.attention import causal_attention
from rlinf_tpu_torch.parallel import worlds
from rlinf_tpu_torch.parallel.launch import start_world
from rlinf_tpu_torch.parallel.mesh import MeshConfig, make_mesh, use_mesh

B, S, H, K, D = 3, 32, 4, 2, 8
CASES = [(cp, form) for cp in (2, 4) for form in ("p2p", "emulated")]


def _inputs():
    r = np.random.default_rng(0)
    q = r.normal(size=(B, S, H, D)).astype(np.float32)
    k = r.normal(size=(B, S, K, D)).astype(np.float32)
    v = r.normal(size=(B, S, K, D)).astype(np.float32)
    lens = np.array([S, S - 11, 0])                 # whole, right-padded, no valid key
    mask = np.arange(S)[None, :] < lens[:, None]
    positions = np.maximum(np.cumsum(mask, 1) - 1, 0).astype(np.int32)
    weight = r.normal(size=(B, S, H, D)).astype(np.float32)
    return dict(q=q, k=k, v=v, positions=positions, mask=mask, weight=weight)


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    items = [("ring_case", dict(cp=cp, emulated=form == "emulated", **inputs))
             for cp, form in CASES]
    items += [("ring_shift_case", dict(emulated=False)), ("ring_shift_case", dict(emulated=True))]
    pending = start_world(worlds.jobs, 4, (items, "cpu"), device="cpu",
                          workdir=str(tmp_path_factory.mktemp("ring_world")),
                          lock=str(tmp_path_factory.getbasetemp().parent / "worlds.lock"))
    names = [f"cp{cp}_{form}" for cp, form in CASES] + ["shift_p2p", "shift_emulated"]

    @functools.cache
    def result():
        return [dict(zip(names, r)) for r in pending.result()]

    yield result
    concurrent.futures.wait([pending])


@functools.cache
def _jax_side(cp):
    """JAX's ring_attention on a data=1 x context=cp mesh: the output and
    the gradients of sum(out * weight)."""
    x = _inputs()
    jm = jmesh.make_mesh(jmesh.MeshConfig(data=1, context=cp), devices=jax.devices()[:cp])
    seq = NamedSharding(jm, JP(None, "context"))
    put = lambda a: jax.device_put(jnp.asarray(a), seq)
    pos, mask, w = put(x["positions"]), put(x["mask"]), jnp.asarray(x["weight"])

    def loss(q, k, v):
        out = jring(q, k, v, mesh=jm, axis="context", positions=pos, kv_valid_mask=mask)
        return jnp.sum(out * w), out

    with jax.set_mesh(jm):
        (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
            put(x["q"]), put(x["k"]), put(x["v"]))
    return {"out": np.asarray(out), "dq": np.asarray(grads[0]), "dk": np.asarray(grads[1]),
            "dv": np.asarray(grads[2])}


@pytest.mark.parametrize("cp, form", CASES)
def test_ring_attention_matches_jax(world, devices, cp, form):
    """The forward over a context group of 2 and of 4, every row (the
    right-padded one and the row with no valid key included), within 1e-5
    of JAX's ring on the same mesh; every rank holds the same output."""
    want = _jax_side(cp)["out"]
    ranks = world()
    for r in ranks:
        np.testing.assert_allclose(r[f"cp{cp}_{form}"]["out"], want, atol=1e-5, rtol=0)
    # the row with no valid key: the mean of the values it visited
    v = _inputs()["v"]
    np.testing.assert_allclose(want[2], np.repeat(v[2].mean(0), H // K, axis=0)[None]
                               .repeat(S, 0), atol=1e-5)


@pytest.mark.parametrize("cp, form", CASES)
def test_ring_attention_grads_match_jax(world, devices, cp, form):
    """The gradients of q, k and v (each key's gradient back on the rank
    that holds it, through the shifts the other way) within 1e-4 of JAX's
    on the same mesh; the shifts a call: cp - 1 forward and as many
    backward, one tensor (K and V together) a hop."""
    want = _jax_side(cp)
    ranks = world()
    for r in ranks:
        got = r[f"cp{cp}_{form}"]
        for name in ("dq", "dk", "dv"):
            np.testing.assert_allclose(got[name], want[name], atol=1e-4, rtol=0, err_msg=name)
        assert got["counts"]["ring_shift"] == 2 * (cp - 1)


@pytest.mark.parametrize("form", ["p2p", "emulated"])
def test_ring_shift_forward_and_backward(world, form):
    """One hop over a group of 4: rank r receives rank r-1's block, and the
    gradient of the block it sent comes back from rank r+1 (whose loss
    weight is r+2), in both forms of the shift."""
    ranks = world()
    for r, res in enumerate(ranks):
        got = res[f"shift_{form}"]
        np.testing.assert_array_equal(got["y"], (r - 1) % 4 + np.arange(3.0))
        np.testing.assert_array_equal(got["dx"], np.full(3, (r + 1) % 4 + 1.0))


def test_ring_takes_the_plain_path_at_context_1():
    """``impl="ring"`` without a mesh, and on a mesh whose context axis is
    1, is the plain attention, as in the JAX package."""
    x = _inputs()
    q, k, v = (torch.as_tensor(x[n]) for n in ("q", "k", "v"))
    kw = dict(positions_q=torch.as_tensor(x["positions"]),
              positions_kv=torch.as_tensor(x["positions"]),
              kv_valid_mask=torch.as_tensor(x["mask"]))
    plain = causal_attention(q, k, v, impl="xla", **kw)
    assert torch.equal(causal_attention(q, k, v, impl="ring", **kw), plain)
    with use_mesh(make_mesh(MeshConfig(data=2), ranks=[0, 1], device_type="cpu")):
        assert torch.equal(causal_attention(q, k, v, impl="ring", **kw), plain)
