"""The expert axis and MoE under the context axis in the port's parallel
layer, against the JAX package on meshes of the same shapes.

* ``ops.moe.moe_layer_dropless_ep`` (the batch and the experts split over
  an expert group of 4, the pairs exchanged by ``collectives.all_to_all``)
  against the JAX package's ``shard_map`` on 4 devices: the forward, the
  auxiliary loss and every gradient, with the sized exchange (point to
  point, and built from all-reduce as on CUDA tensors of a gloo group) and
  with the all-gather emulation (``FORCE_RAGGED`` True and False). JAX's
  ragged branch has no CPU kernel (XLA:CPU refuses ``ragged-all-to-all``),
  so both are held to JAX's emulation, which equals its unsharded layer.
* The sharded train step and ``ReasoningRunner(mesh=)`` of an MoE model at
  fsdp=2 x expert=2 (capacity and dropless) and at expert=2 x context=2
  (ring attention), and ``rescale`` from the expert mesh to data=4.
* The static engine's sharded MoE rollout with a capacity that drops
  tokens (``moe_capacity_factor`` 0.5) at data=4 and data=2 x expert=2:
  each decode step's capacity counts every rank's rows, as the JAX
  engine's one program.

The port runs in one gloo world of 4 CPU processes (``parallel.launch``),
started once for the module, whose ranks run every case
(``parallel/worlds.py``) while the test process computes the JAX side on
the 8 virtual CPU devices, from one JAX init. Everything is f32. The worlds
of the test files take turns, at most two at once, through locks in the
test session's temporary directory.
"""

import concurrent.futures
import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rlinf_tpu import config as jconfig
from rlinf_tpu.data import io_struct as jio
from rlinf_tpu.data.datasets import PromptDataset as JDataset
from rlinf_tpu.data.datasets import PromptExample as JExample
from rlinf_tpu.data.tokenizers import ByteTokenizer as JTokenizer
from rlinf_tpu.models.llm import model as JM
from rlinf_tpu.models.llm.config import LLMConfig as JConfig
from rlinf_tpu.models.llm.sampler import SamplingParams as JSampling
from rlinf_tpu.ops import moe as JMOE
from rlinf_tpu.parallel import mesh as jmesh
from rlinf_tpu.rollout.engine import RolloutEngine as JEngine
from rlinf_tpu.runners.reasoning_runner import ReasoningRunner as JRunner
from rlinf_tpu.training import learner as JL
from rlinf_tpu.training import train_state as JS
from rlinf_tpu_torch.models.llm import model as TM
from rlinf_tpu_torch.models.llm.config import LLMConfig as TConfig
from rlinf_tpu_torch.ops import moe as TMOE
from rlinf_tpu_torch.parallel import worlds
from rlinf_tpu_torch.parallel.launch import start_world
from rlinf_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from rlinf_tpu_torch.parallel.sharding import flatten_with_paths
from rlinf_tpu_torch.training import learner as TL
from rlinf_tpu_torch.training import train_state as TS

from test_torch_mesh_e2e import PERM, RUNNER_OV, YAML, _batch, _rollout_arrays

EP_FSDP = MeshConfig(data=1, fsdp=2, expert=2)
CP_EP = MeshConfig(data=1, expert=2, context=2)
DATA4 = MeshConfig(data=4)
DATA_EP = MeshConfig(data=2, expert=2)
OPT = dict(lr=1e-3, eps=1e-3, weight_decay=0.01, clip_grad=0.5)
LOSS = dict(entropy_bonus=1e-2, kl_beta=0.05, logprob_chunk_size=16)
MOE_OV = ["model.num_experts=4", "model.num_experts_per_token=2"]
# the expert-axis runner takes the token budget: microbatches of 1 or 2 rows
# (rows of 30-41 tokens), padded to the batch axes (fsdp=2, then data=4
# after the rescale) with rows that hold no token
EP_RUNNER_OV = [o for o in RUNNER_OV if not o.startswith("loss.max_tokens_per_mb")] + [
    "loss.max_tokens_per_mb=64"] + MOE_OV
CP_RUNNER_OV = RUNNER_OV + MOE_OV + ["attn_impl=ring"]
TRAIN_CASES = {"capacity_fsdp2_expert2": ("capacity", EP_FSDP, "xla"),
               "dropless_fsdp2_expert2": ("dropless", EP_FSDP, "xla"),
               "capacity_expert2_context2": ("capacity", CP_EP, "ring")}
EP_CASES = {"p2p": dict(ragged=True), "allreduce": dict(ragged=True, emulated=True),
            "allgather": dict(ragged=False)}
ROLLOUT_MESHES = {"data4": DATA4, "data2_expert2": DATA_EP}
PROMPTS = [list(np.random.default_rng(5).integers(1, 256, n))
           for n in (3, 9, 14, 5, 11, 7, 2, 12)]
N_NEW = 6


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _moe(impl, capacity_factor=1.5):
    jcfg = dataclasses.replace(JConfig.tiny(), tie_word_embeddings=False, num_experts=4,
                               num_experts_per_token=2, moe_impl=impl,
                               moe_capacity_factor=capacity_factor)
    return jcfg, TConfig(**dataclasses.asdict(jcfg))


def _ep_inputs():
    moe = JMOE.MoEConfig(num_experts=8, num_experts_per_token=2)
    params = _np_tree(JMOE.init_moe_params(jax.random.PRNGKey(0), 16, 32, moe, jnp.float32))
    x = np.random.default_rng(1).normal(size=(8, 4, 16)).astype(np.float32)
    return moe, params, x


@pytest.fixture(scope="module")
def setup():
    rcfg = jconfig.load_config(YAML, EP_RUNNER_OV)
    moe = {impl: _moe(impl) for impl in ("capacity", "dropless")}
    drop = _moe("capacity", capacity_factor=0.5)
    return dict(
        moe={impl: (j, t, _np_tree(JM.init_params(j, jax.random.PRNGKey(3))))
             for impl, (j, t) in moe.items()},
        drop=(*drop, _np_tree(JM.init_params(drop[0], jax.random.PRNGKey(8)))),
        rparams=_np_tree(JM.init_params(rcfg.model, jax.random.PRNGKey(1))),
        batches=[_batch(moe["capacity"][1], seed=0)],
        rollouts=[_rollout_arrays(s) for s in (0, 1)],
        ep=_ep_inputs())


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("expert_ckpt"))


@pytest.fixture(scope="module")
def world(setup, ckpt_dir, tmp_path_factory):
    s = setup
    items, names = [], []

    def add(name, fn, **kw):
        items.append((fn, kw))
        names.append(name)

    jmoe, params, x = s["ep"]
    tmoe = TMOE.MoEConfig(**dataclasses.asdict(jmoe))
    for name, kw in EP_CASES.items():
        add(f"ep_{name}", "dropless_ep_case", moe=tmoe, params=params, x=x, **kw)
    for name, (impl, mesh, attn) in TRAIN_CASES.items():
        _, mt, mparams = s["moe"][impl]
        add(name, "train_steps", mesh_cfg=mesh, cfg=mt, params=mparams, batches=s["batches"],
            opt_cfg=TS.OptimizerConfig(**OPT), loss_cfg=TL.PolicyLossConfig(**LOSS),
            num_microbatches=2, attn_impl=attn)
    _, dt, dparams = s["drop"]
    for name, mesh in ROLLOUT_MESHES.items():
        add(f"rollout_{name}", "greedy_rollout", mesh_cfg=mesh, cfg=dt, params=dparams,
            prompts=PROMPTS, max_new_tokens=N_NEW)
    add("runner_ep", "runner_steps", mesh_cfg=EP_FSDP, yaml=YAML, overrides=EP_RUNNER_OV,
        params=s["rparams"], rollouts=s["rollouts"][:1], perm=PERM, reward="odd_rule_reward",
        ckpt_dir=ckpt_dir, rescale_to=DATA4, rollouts_after=s["rollouts"][1:])
    add("runner_cp", "runner_steps", mesh_cfg=CP_EP, yaml=YAML, overrides=CP_RUNNER_OV,
        params=s["rparams"], rollouts=s["rollouts"][:1], perm=PERM, reward="odd_rule_reward")
    pending = start_world(worlds.jobs, 4, (items, "cpu"), device="cpu",
                          workdir=str(tmp_path_factory.mktemp("expert_world")),
                          lock=str(tmp_path_factory.getbasetemp().parent / "worlds.lock"))

    @functools.cache
    def result():
        return [dict(zip(names, r)) for r in pending.result()]

    yield result
    concurrent.futures.wait([pending])


def _jax_mesh(cfg: MeshConfig, n: int):
    return jmesh.make_mesh(jmesh.MeshConfig(**dataclasses.asdict(cfg)), devices=jax.devices()[:n])


def _jax_ep(setup):
    """JAX's expert-parallel dropless layer on 4 devices (its all-gather
    branch, the one XLA:CPU runs), and the gradients of sum(out**2) + aux."""
    from jax.sharding import Mesh

    moe, params, x = setup["ep"]
    mesh = Mesh(np.array(jax.devices()[:4]), ("expert",))
    p, xj = jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x)

    def loss(p, x):
        out, aux = JMOE.moe_layer_dropless_ep(p, x, moe, mesh)
        return jnp.sum(out ** 2) + aux, (out, aux)

    (_, (out, aux)), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                           has_aux=True))(p, xj)
    ref, aux_ref, _ = JMOE.moe_layer_dropless(p, xj, moe)
    return {"out": np.asarray(out), "aux": float(aux), "dx": np.asarray(gx),
            **{f"d_{k}": np.asarray(v) for k, v in gp.items()},
            "unsharded": np.asarray(ref), "aux_unsharded": float(aux_ref)}


def _jax_train(cfg, params, batches, mesh_cfg, attn):
    jm = _jax_mesh(mesh_cfg, 4)
    tx = JS.make_optimizer(JS.OptimizerConfig(**OPT))
    p = jax.tree_util.tree_map(jnp.asarray, params)
    with jax.set_mesh(jm):
        state = JS.create_train_state(lambda rng: p, tx, jax.random.PRNGKey(0), mesh=jm,
                                      partition_rules=JM.partition_rules())
        step = JL.make_policy_train_step(cfg, JL.PolicyLossConfig(**LOSS), tx,
                                         num_microbatches=2, remat=False, attn_impl=attn,
                                         mesh=jm)
        losses, norms = [], []
        for b in batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(m["actor/loss"]))
            norms.append(float(m["actor/grad_norm"]))
    return losses, norms, _np_tree(state.params)


def _jax_rollout(setup, mesh_cfg):
    jcfg, _, params = setup["drop"]
    jeng = JEngine(jcfg, JSampling(max_new_tokens=N_NEW, greedy=True, eos_token_id=-1),
                   prompt_bucket=8)
    jm = _jax_mesh(mesh_cfg, 4)
    with jax.set_mesh(jm):
        return jeng.rollout(jax.tree_util.tree_map(jnp.asarray, params),
                            jio.RolloutRequest(prompt_ids=PROMPTS), jax.random.PRNGKey(0),
                            mesh=jm)


def _jax_runner(setup, overrides, mesh_cfg, rollouts, rescale_to=None, rollouts_after=()):
    jcfg = jconfig.load_config(YAML, overrides)
    params = jax.tree_util.tree_map(jnp.asarray, setup["rparams"])
    jm = _jax_mesh(mesh_cfg, 4)
    data = JDataset([JExample(f"q{i}", "a") for i in range(8)])
    with pytest.MonkeyPatch.context() as mp, jax.set_mesh(jm):
        mp.setattr(jax.random, "permutation", lambda key, n: jnp.asarray(PERM[:n]))
        jr = JRunner(jcfg, JTokenizer(), data, mesh=jm, init_params_override=lambda rng: params,
                     reward_fn=worlds.odd_rule_reward)
        jms = [jr._train_on_result(jio.RolloutResult(**copy.deepcopy(a))) for a in rollouts]
        after = []
        if rescale_to is not None:
            new = _jax_mesh(rescale_to, 4)
            jr.rescale(new)
            with jax.set_mesh(new):
                after = [jr._train_on_result(jio.RolloutResult(**copy.deepcopy(a)))
                         for a in rollouts_after]
        return jms, _np_tree(jr.state.params), after


@pytest.fixture(scope="module")
def jax_side(setup, world, devices):
    s = setup
    return {
        "ep": _jax_ep(s),
        "train": {name: _jax_train(s["moe"][impl][0], s["moe"][impl][2], s["batches"], mesh,
                                   attn)
                  for name, (impl, mesh, attn) in TRAIN_CASES.items()},
        "rollout": {name: _jax_rollout(s, mesh) for name, mesh in ROLLOUT_MESHES.items()},
        "runner_ep": _jax_runner(s, EP_RUNNER_OV, EP_FSDP, s["rollouts"][:1],
                                 rescale_to=DATA4, rollouts_after=s["rollouts"][1:]),
        "runner_cp": _jax_runner(s, CP_RUNNER_OV, CP_EP, s["rollouts"][:1]),
    }


def _close_tree(got, want, atol):
    got, want = dict(flatten_with_paths(got)), dict(flatten_with_paths(want))
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=atol, err_msg=path)


def _close_actor(got, want):
    actor = sorted(k for k in want if k.startswith("actor/"))
    assert actor == sorted(k for k in got if k.startswith("actor/"))
    for k in actor:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-4, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# moe_layer_dropless_ep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(EP_CASES))
def test_dropless_ep_matches_jax(jax_side, world, case):
    """``moe_layer_dropless_ep`` at ep=4 (8 experts top-2, 2 rows of 4
    tokens a rank) with the exchange point to point, built from all-reduce
    and by all-gather: the output within 2e-5 of JAX's expert-parallel layer
    (which equals its unsharded one), the auxiliary loss 1e-5 relative, and
    the gradients of x, the router and every expert leaf within 1e-4; the
    router's gradient whole and equal on every rank, and the exchange the
    one the case names."""
    want = jax_side["ep"]
    np.testing.assert_allclose(want["out"], want["unsharded"], atol=2e-5)
    ranks = world()
    for r in ranks:
        got = r[f"ep_{case}"]
        np.testing.assert_allclose(got["out"], want["out"], atol=2e-5, rtol=0)
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-5)
        np.testing.assert_allclose(got["aux"], want["aux_unsharded"], rtol=1e-5)
        for k in ("dx", "d_router", "d_gate", "d_up", "d_down"):
            np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=0, err_msg=k)
        np.testing.assert_array_equal(got["d_router"], ranks[0][f"ep_{case}"]["d_router"])
        counts = got["counts"]
        if case == "allgather":
            assert counts.get("all_to_all", 0) == 0 and counts["all_gather"] >= 4
        else:
            # five exchanges: x and the expert ids out, the results back,
            # then the gradients of the results and of x
            assert counts["all_to_all"] == 5
            if case == "allreduce":
                assert counts["all_reduce"] >= 10


def test_dropless_ep_on_one_rank_is_the_dropless_layer():
    """Without a world the expert group is one rank: the layer is
    ``moe_layer_dropless`` on the whole batch (the same output, aux and
    router gradient)."""
    import torch

    moe, params, x = _ep_inputs()
    tmoe = TMOE.MoEConfig(**dataclasses.asdict(moe))
    mesh = make_mesh(MeshConfig(data=1), device_type="cpu")
    p = {k: torch.as_tensor(v).requires_grad_(True) for k, v in params.items()}
    out, aux = TMOE.moe_layer_dropless_ep(p, torch.as_tensor(x), tmoe, mesh)
    ref, aux_ref, _ = TMOE.moe_layer_dropless(p, torch.as_tensor(x), tmoe)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), atol=1e-6)
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=1e-6)
    with pytest.raises(ValueError, match="this rank's block"):     # 8 experts given
        TMOE.moe_layer_dropless_ep(p, torch.as_tensor(x), dataclasses.replace(
            tmoe, num_experts=16), mesh)


# ---------------------------------------------------------------------------
# The sharded step and the runner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_moe_train_step_on_an_expert_mesh_matches_jax(jax_side, world, name):
    """One MoE train step (2 microbatches, 4 experts top-2) at fsdp=2 x
    expert=2 with the capacity and the dropless dispatch (each rank
    computes its 2 experts on every row of its batch block, the output
    all-reduced over the expert group) and at expert=2 x context=2 under
    ring attention (capacity, slots and aux counted over the whole [B, T]
    grid): the loss within 1e-5 relative, the grad norm 1e-4, the params
    1e-5 of JAX's on the same mesh; every rank the same loss and norm."""
    losses, norms, jparams = jax_side["train"][name]
    ranks = world()
    for r in ranks:
        assert r[name]["losses"] == ranks[0][name]["losses"]
        assert r[name]["grad_norms"] == ranks[0][name]["grad_norms"]
    got = ranks[0][name]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got["grad_norms"], norms, rtol=1e-4)
    _close_tree(got["params"], jparams, 1e-5)


@pytest.mark.parametrize("name", ["runner_ep", "runner_cp"])
def test_moe_runner_on_an_expert_mesh_matches_jax(jax_side, world, name):
    """``ReasoningRunner(mesh=)`` of an MoE model (4 experts top-2, the
    recompute on, 2 minibatches, one permutation injected on both sides) at
    fsdp=2 x expert=2 with the token budget (``max_tokens_per_mb=64``:
    microbatches of 1 or 2 rows, padded to the batch axes with rows that
    hold no MoE token), then ``rescale`` to data=4 (no expert axis) and one more
    step; and one step at expert=2 x context=2 with ring attention: every
    ``actor/*`` metric within 1e-4 relative (1e-6 absolute) of the JAX
    runner's on the same meshes, the params within 1e-5, bitwise equal
    losses on every rank."""
    jms, jparams, jafter = jax_side[name]
    ranks = world()
    for r in ranks:
        assert [m["actor/loss"] for m in r[name]["metrics"]] == \
            [m["actor/loss"] for m in ranks[0][name]["metrics"]]
    got = ranks[0][name]
    for tm, jm in zip(got["metrics"], jms):
        _close_actor(tm, jm)
    if name == "runner_ep":
        assert all(m["actor/num_dyn_microbatches"] >= 2 for m in got["metrics"])
        assert got["rescaled_shapes"]["blocks/moe_gate"][1] == 4      # whole on data=4
        for tm, jm in zip(got["metrics_after"], jafter):
            _close_actor(tm, jm)
        _close_tree(got["params_after"], jparams, 1e-5)
    else:
        _close_tree(got["params"], jparams, 1e-5)


def test_expert_mesh_checkpoint_restores_on_one_device(setup, world, ckpt_dir):
    """The MoE runner's checkpoint saved at fsdp=2 x expert=2 after its
    first step (each rank holding half the experts of a quarter of D)
    restores on one device (no mesh, no world) in the single-card layout,
    bitwise equal to the sharded params gathered; the step after the
    rescale to data=4 saved its own."""
    from rlinf_tpu_torch import config as tconfig
    from rlinf_tpu_torch.models.llm.convert import params_from_numpy
    from rlinf_tpu_torch.training import train_state as TS
    from rlinf_tpu_torch.utils.checkpoint import CheckpointManager

    ranks = world()
    cfg = tconfig.load_config(YAML, EP_RUNNER_OV)
    template = TS.create_train_state(
        lambda: params_from_numpy(setup["rparams"], cfg.model, device="cpu"),
        TS.make_optimizer(cfg.optimizer))
    mgr = CheckpointManager(ckpt_dir)
    assert mgr.latest_step() == 2
    for step, want in ((1, ranks[0]["runner_ep"]["params"]),
                       (2, ranks[0]["runner_ep"]["params_after"])):
        state, _, got_step = mgr.restore(template, step=step)
        assert got_step == step
        assert state.params["blocks"]["moe_gate"].shape[1] == 4
        for (path, t), (_, w) in zip(flatten_with_paths(state.params), flatten_with_paths(want)):
            np.testing.assert_array_equal(t.numpy(), w, err_msg=path)


# ---------------------------------------------------------------------------
# The rollout (ROADMAP.md §C.5)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(ROLLOUT_MESHES))
def test_sharded_moe_rollout_counts_the_whole_batch(jax_side, world, mesh, setup):
    """The static engine's ``rollout(mesh=)`` of an MoE model whose capacity
    drops tokens (``moe_capacity_factor`` 0.5, 8 prompts) at data=4 (each
    rank generates 2 rows) and at data=2 x expert=2: greedy tokens equal to
    the JAX engine's on the same mesh, the behaviour logprobs within 1e-4,
    every rank the same tokens. Without the whole-batch count each rank's
    capacity would take its block's tokens only, and the tokens differ."""
    jres = jax_side["rollout"][mesh]
    ranks = world()
    for r in ranks:
        got = r[f"rollout_{mesh}"]
        np.testing.assert_array_equal(got["ids"], np.asarray(jres.response_ids))
        np.testing.assert_allclose(got["lps"], np.asarray(jres.response_logprobs), atol=1e-4)
    # the capacity does drop in this batch (the case would not tell
    # otherwise): layer 0's router on the prompts' embeddings already drops
    import torch

    jcfg, tcfg, params = setup["drop"]
    full = TM.shard_params_from_numpy(params, tcfg, None, device="cpu")
    h = TM.embed_tokens(full, tcfg, torch.as_tensor(np.asarray(jres.prompt_ids)))
    layer0 = {k[4:]: v[0] for k, v in full["blocks"].items() if k.startswith("moe_")}
    assert float(TMOE.capacity_overflow_frac(layer0, h, tcfg.moe_config)) > 0


# ---------------------------------------------------------------------------
# Checks of the mesh
# ---------------------------------------------------------------------------

def test_check_mesh_takes_the_expert_and_context_axes():
    """``check_mesh`` no longer refuses ``mesh.expert > 1`` or an MoE model
    under ``mesh.context > 1``; it keeps the JAX config's checks: the model
    must have experts, and the expert axis must divide them."""
    _, moe = _moe("capacity")
    dense = TConfig(**dataclasses.asdict(JConfig.tiny()))
    TM.check_mesh(moe, make_mesh(EP_FSDP, ranks=range(4), device_type="cpu"))
    TM.check_mesh(moe, make_mesh(CP_EP, ranks=range(4), device_type="cpu"))
    with pytest.raises(ValueError, match="no experts"):
        TM.check_mesh(dense, make_mesh(EP_FSDP, ranks=range(4), device_type="cpu"))
    with pytest.raises(ValueError, match="not divisible by mesh.expert"):
        TM.check_mesh(dataclasses.replace(moe, num_experts=6),
                      make_mesh(MeshConfig(data=1, expert=4), ranks=range(4),
                                device_type="cpu"))
