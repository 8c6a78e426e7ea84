"""Context parallelism in the port's training and rollout paths against the
JAX package's (``tests/test_cp_training.py``).

``attn_impl="ring"`` on a mesh with a context axis splits the sequence over
it: ``forward_hidden`` takes whole rows and runs every layer on the rank's
chunk, the train step's loss and its aggregation take the chunk too, the
recompute gathers the chunks, and the rollout's ring prefill gathers each
layer's K/V before every context rank decodes the same tokens.

The port runs in one gloo world of 4 CPU processes (``parallel.launch``),
started once for the module, whose ranks run every case
(``parallel/worlds.py``) while the test process computes the JAX side on
the 8 virtual CPU devices, on meshes of the same shapes, from one JAX init
(``shard_params_from_numpy`` cuts the port's blocks). Everything is f32.
The worlds of the test files take turns: each holds a lock in the test
session's temporary directory while it runs.
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
from rlinf_tpu.parallel import mesh as jmesh
from rlinf_tpu.rollout.engine import RolloutEngine as JEngine
from rlinf_tpu.runners.reasoning_runner import ReasoningRunner as JRunner
from rlinf_tpu.training import learner as JL
from rlinf_tpu.training import train_state as JS
from rlinf_tpu_torch.models.llm.config import LLMConfig as TConfig
from rlinf_tpu_torch.parallel import worlds
from rlinf_tpu_torch.parallel.launch import start_world
from rlinf_tpu_torch.parallel.mesh import MeshConfig
from rlinf_tpu_torch.parallel.sharding import flatten_with_paths
from rlinf_tpu_torch.training import learner as TL
from rlinf_tpu_torch.training import train_state as TS

from test_torch_mesh_e2e import PERM, _rollout_arrays

YAML = "examples/reasoning/config/grpo_demo_tiny.yaml"
CP4 = MeshConfig(data=1, context=4)
CP2 = MeshConfig(data=1, context=2)
CP2_TP2 = MeshConfig(data=1, context=2, tensor=2)
RUNNER_OV = ["runner.rollout_batch_size=2", "algorithm.recompute_logprobs=true",
             "loss.max_tokens_per_mb=0", "runner.num_mini_batches=2", "runner.log_dir=null",
             "optimizer.eps=1e-3", "attn_impl=ring"]
OPT = dict(lr=1e-3, eps=1e-3, weight_decay=0.01, clip_grad=0.5)
LOSS = dict(entropy_bonus=1e-2, kl_beta=0.05, logprob_chunk_size=64)
T_FWD, T_TRAIN, N_NEW = 2048, 256, 5


def _long_cfgs():
    """The JAX test's model: 2 layers of 32, 2 heads over 1 kv head."""
    jcfg = JConfig(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2,
                   num_heads=2, num_kv_heads=1, max_seq_len=4096, dtype="float32",
                   qkv_bias=False, rope_theta=1e4)
    return jcfg, TConfig(**dataclasses.asdict(jcfg))


def _small_cfgs():
    jcfg = dataclasses.replace(JConfig.tiny(), tie_word_embeddings=False)
    return jcfg, TConfig(**dataclasses.asdict(jcfg))


def _fwd_inputs():
    r = np.random.default_rng(0)
    ids = r.integers(0, 128, (2, T_FWD)).astype(np.int32)
    mask = np.ones((2, T_FWD), bool)
    mask[0, T_FWD - 173:] = False                   # right padding
    return ids, mask


def _train_batch(vocab):
    r = np.random.default_rng(1)
    B, T = 2, T_TRAIN
    attn = np.ones((B, T), bool)
    attn[1, T - 37:] = False
    loss_mask = attn & (r.random((B, T)) > 0.3)
    return {
        "input_ids": np.where(attn, r.integers(0, vocab, (B, T)), 0).astype(np.int32),
        "target_ids": r.integers(0, vocab, (B, T)).astype(np.int32),
        "attention_mask": attn, "loss_mask": loss_mask,
        "old_logprobs": np.where(loss_mask, -np.log(vocab) + r.normal(size=(B, T)) * .1,
                                 0).astype(np.float32),
        "advantages": (r.normal(size=(B, T)) * loss_mask).astype(np.float32),
        "ref_logprobs": np.where(loss_mask, -np.log(vocab), 0).astype(np.float32),
    }


PROMPTS = [list(np.random.default_rng(5).integers(1, 256, n)) for n in (3, 9, 14, 5)]


@pytest.fixture(scope="module")
def setup():
    ljcfg, ltcfg = _long_cfgs()
    sjcfg, stcfg = _small_cfgs()
    rcfg = jconfig.load_config(YAML, RUNNER_OV)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return dict(
        long=(ljcfg, ltcfg, np_tree(JM.init_params(ljcfg, jax.random.PRNGKey(0)))),
        small=(sjcfg, stcfg, np_tree(JM.init_params(sjcfg, jax.random.PRNGKey(2)))),
        rparams=np_tree(JM.init_params(rcfg.model, jax.random.PRNGKey(1))),
        rollouts=[_rollout_arrays(s) for s in (0, 1)])


@pytest.fixture(scope="module")
def world(setup, tmp_path_factory):
    s = setup
    _, ltcfg, lparams = s["long"]
    _, stcfg, sparams = s["small"]
    ids, mask = _fwd_inputs()
    items = [
        ("ring_forward", dict(mesh_cfg=CP4, cfg=ltcfg, params=lparams, ids=ids, mask=mask)),
        ("train_steps", dict(mesh_cfg=CP4, cfg=ltcfg, params=lparams,
                             batches=[_train_batch(ltcfg.vocab_size)],
                             opt_cfg=TS.OptimizerConfig(**OPT),
                             loss_cfg=TL.PolicyLossConfig(**LOSS), attn_impl="ring",
                             remat=True)),
        ("greedy_rollout", dict(mesh_cfg=CP2, size=2, cfg=stcfg, params=sparams,
                                prompts=PROMPTS, max_new_tokens=N_NEW,
                                engine_kw={"attn_impl": "ring"})),
        ("runner_steps", dict(mesh_cfg=CP2_TP2, yaml=YAML, overrides=RUNNER_OV,
                              params=s["rparams"], rollouts=s["rollouts"], perm=PERM,
                              reward="odd_rule_reward")),
    ]
    pending = start_world(worlds.jobs, 4, (items, "cpu"), device="cpu",
                          workdir=str(tmp_path_factory.mktemp("cp_world")),
                          lock=str(tmp_path_factory.getbasetemp().parent / "worlds.lock"))
    names = ["forward", "train", "greedy", "runner"]

    @functools.cache
    def result():
        return [dict(zip(names, r)) for r in pending.result()]

    yield result
    concurrent.futures.wait([pending])


def _jax_mesh(cfg: MeshConfig, n: int):
    return jmesh.make_mesh(jmesh.MeshConfig(**dataclasses.asdict(cfg)), devices=jax.devices()[:n])


@pytest.fixture(scope="module")
def jax_side(setup, world, devices):
    """The JAX package's side of every case, computed while the world
    runs."""
    ljcfg, _, lparams = setup["long"]
    sjcfg, _, sparams = setup["small"]
    out = {}
    ids, mask = _fwd_inputs()
    lp = jax.tree_util.tree_map(jnp.asarray, lparams)
    jm = _jax_mesh(CP4, 4)
    with jax.set_mesh(jm):
        out["forward"] = np.asarray(jax.jit(lambda p, i, m: JM.forward_hidden(
            p, ljcfg, i, attention_mask=m, attn_impl="ring")[0])(
                lp, jnp.asarray(ids), jnp.asarray(mask)))
    out["forward_xla"] = np.asarray(jax.jit(lambda p, i, m: JM.forward_hidden(
        p, ljcfg, i, attention_mask=m, attn_impl="xla")[0])(
            lp, jnp.asarray(ids), jnp.asarray(mask)))

    tx = JS.make_optimizer(JS.OptimizerConfig(**OPT))
    with jax.set_mesh(jm):
        state = JS.create_train_state(lambda rng: lp, tx, jax.random.PRNGKey(0), mesh=jm,
                                      partition_rules=JM.partition_rules())
        step = JL.make_policy_train_step(ljcfg, JL.PolicyLossConfig(**LOSS), tx,
                                         attn_impl="ring", mesh=jm)
        state, m = step(state, {k: jnp.asarray(v) for k, v in
                                _train_batch(ljcfg.vocab_size).items()})
        out["train"] = (float(m["actor/loss"]), float(m["actor/grad_norm"]),
                        jax.tree_util.tree_map(np.asarray, state.params))

    jeng = JEngine(sjcfg, JSampling(max_new_tokens=N_NEW, greedy=True, eos_token_id=-1),
                   prompt_bucket=8, attn_impl="ring")
    jm2 = _jax_mesh(CP2, 2)
    with jax.set_mesh(jm2):
        out["greedy"] = jeng.rollout(jax.tree_util.tree_map(jnp.asarray, sparams),
                                     jio.RolloutRequest(prompt_ids=PROMPTS),
                                     jax.random.PRNGKey(0), mesh=jm2)

    jcfg = jconfig.load_config(YAML, RUNNER_OV)
    params = jax.tree_util.tree_map(jnp.asarray, setup["rparams"])
    jm4 = _jax_mesh(CP2_TP2, 4)
    data = JDataset([JExample(f"q{i}", "a") for i in range(8)])
    with pytest.MonkeyPatch.context() as mp, jax.set_mesh(jm4):
        mp.setattr(jax.random, "permutation", lambda key, n: jnp.asarray(PERM[:n]))
        jr = JRunner(jcfg, JTokenizer(), data, mesh=jm4, init_params_override=lambda rng: params,
                     reward_fn=worlds.odd_rule_reward)
        jms = [jr._train_on_result(jio.RolloutResult(**copy.deepcopy(a)))
               for a in setup["rollouts"]]
        out["runner"] = (jms, jax.tree_util.tree_map(np.asarray, jr.state.params))
    return out


def test_forward_hidden_ring_matches_jax_long_context(jax_side, world):
    """``forward_hidden(attn_impl="ring")`` at T=2048 over context=4 (a
    right-padded row: the positions come from the whole row), each rank
    holding a [B, 512, D] chunk, gathered whole: within 2e-5 of JAX's ring
    on the same mesh, and of the plain attention's forward."""
    ranks = world()
    for r in ranks:
        got = r["forward"]
        assert got["chunk"] == (2, T_FWD // 4, 32)
        np.testing.assert_allclose(got["hidden"], jax_side["forward"], atol=2e-5, rtol=0)
        np.testing.assert_allclose(got["hidden"], jax_side["forward_xla"], atol=2e-5, rtol=0)


def test_ring_train_step_matches_jax(jax_side, world):
    """One ``make_policy_train_step(attn_impl="ring", remat=True)`` on
    data=1 x context=4 (T=256, a right-padded row, entropy and KL terms,
    adamw with a clip): the loss within 1e-5 relative, the grad norm 1e-4,
    the updated params 1e-5 of JAX's on the same mesh; every rank bitwise
    equal (remat replays the ring's shifts in the backward)."""
    loss, norm, jparams = jax_side["train"]
    ranks = world()
    for r in ranks:
        assert r["train"]["losses"] == ranks[0]["train"]["losses"]
        assert r["train"]["grad_norms"] == ranks[0]["train"]["grad_norms"]
    got = ranks[0]["train"]
    np.testing.assert_allclose(got["losses"][0], loss, rtol=1e-5)
    np.testing.assert_allclose(got["grad_norms"][0], norm, rtol=1e-4)
    for (path, t), (_, j) in zip(flatten_with_paths(got["params"]), flatten_with_paths(jparams)):
        np.testing.assert_allclose(t, j, atol=1e-5, err_msg=path)


def test_ring_prefill_and_greedy_rollout_match_jax(jax_side, world):
    """The static engine with ``attn_impl="ring"`` on context=2: the ring
    prefill, then each layer's K/V gathered and the decode on every context
    rank: greedy tokens equal to JAX's on a context mesh, the behaviour
    logprobs within 1e-4, and the context ranks' tokens bitwise equal."""
    jres = jax_side["greedy"]
    ranks = world()
    for r in ranks:
        np.testing.assert_array_equal(r["greedy"]["ids"], np.asarray(jres.response_ids))
        np.testing.assert_array_equal(r["greedy"]["ids"], ranks[0]["greedy"]["ids"])
        np.testing.assert_allclose(r["greedy"]["lps"], np.asarray(jres.response_logprobs),
                                   atol=1e-4)


def test_ring_runner_steps_match_jax(jax_side, world):
    """Two ``_train_on_result`` calls of ``ReasoningRunner(mesh=)`` with
    ``attn_impl=ring`` on data=1 x context=2 x tensor=2 (the recompute on,
    2 minibatches, one permutation injected on both sides) against the JAX
    runner on the same mesh: every ``actor/*`` metric within 1e-4 relative
    (1e-6 absolute), the params within 1e-5; bitwise equal losses on every
    rank."""
    jms, jparams = jax_side["runner"]
    ranks = world()
    for r in ranks:
        assert [m["actor/loss"] for m in r["runner"]["metrics"]] == \
            [m["actor/loss"] for m in ranks[0]["runner"]["metrics"]]
    got = ranks[0]["runner"]
    for tm, jmet in zip(got["metrics"], jms):
        actor = sorted(k for k in jmet if k.startswith("actor/"))
        assert actor == sorted(k for k in tm if k.startswith("actor/"))
        for k in actor:
            np.testing.assert_allclose(tm[k], float(jmet[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    for (path, t), (_, j) in zip(flatten_with_paths(got["params"]), flatten_with_paths(jparams)):
        np.testing.assert_allclose(t, j, atol=1e-5, err_msg=path)
