"""The port's sharded training, logprobs, rollout, runner, rescale and
checkpoints against the JAX package on meshes of the same shapes
(``tests/test_mesh_e2e.py``).

The JAX side runs in the test process on the 8 virtual CPU devices; the
port runs in one gloo world of 4 processes (``parallel.launch``), started
once for the module, whose ranks run every check (``parallel/worlds.py``)
while the test process computes the JAX side (``jax_side``):
meshes of 2 ranks run side by side on ranks {0, 1} and {2, 3}. Both sides
start from one JAX init (``shard_params_from_numpy`` cuts the port's
blocks). Everything is f32; the port's all-reduces add in another order
than XLA's partitioner, so values agree to rounding, within the
tolerances stated per test.
The worlds of the test files take turns: each holds a lock in the test
session's temporary directory while it runs, so that test workers side
by side never run two at once.
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
from rlinf_tpu.models.llm.quant import quantize_params as jquantize
from rlinf_tpu.models.llm.sampler import SamplingParams as JSampling
from rlinf_tpu.ops.logprobs import vocab_parallel_logprobs_and_entropy as jvocab_parallel
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
from rlinf_tpu_torch.utils.checkpoint import CheckpointManager

YAML = "examples/reasoning/config/grpo_demo_tiny.yaml"
# the runner tests' settings without the token budget (no mesh takes it
# yet); adam's eps at 1e-3, as the train-step tests take it: an entry whose
# gradient is rounding noise on both sides (the all-reduces add in another
# order than XLA) would otherwise move by up to 2 lr
RUNNER_OV = ["runner.rollout_batch_size=2", "algorithm.recompute_logprobs=true",
             "loss.max_tokens_per_mb=0", "runner.num_mini_batches=2", "runner.log_dir=null",
             "optimizer.eps=1e-3"]
TRAIN_MESHES = {                       # name -> (mesh, ranks a mesh)
    "data2": (MeshConfig(data=2), 2),
    "tensor2": (MeshConfig(data=1, tensor=2), 2),
    "fsdp2_tensor2": (MeshConfig(data=1, fsdp=2, tensor=2), 4),
}
FSDP_TP = MeshConfig(data=1, fsdp=2, tensor=2)
OPT = dict(lr=1e-3, eps=1e-3, weight_decay=0.01, clip_grad=0.5)
LOSS = dict(entropy_bonus=1e-2, kl_beta=0.05, logprob_chunk_size=16)
N_NEW = 6


def _cfgs():
    jcfg = dataclasses.replace(JConfig.tiny(), tie_word_embeddings=False, qkv_bias=True)
    return jcfg, TConfig(**dataclasses.asdict(jcfg))


def _batch(cfg, B=8, T=16, seed=0):
    r = np.random.default_rng(seed)
    lens = r.integers(T // 2, T + 1, B)
    attn = np.arange(T)[None, :] < lens[:, None]
    loss_mask = attn & (r.random((B, T)) > 0.3)
    return {
        "input_ids": np.where(attn, r.integers(0, cfg.vocab_size, (B, T)), 0).astype(np.int32),
        "target_ids": r.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
        "attention_mask": attn, "loss_mask": loss_mask,
        "old_logprobs": np.where(loss_mask, -np.log(cfg.vocab_size) + r.normal(size=(B, T)) * .1,
                                 0).astype(np.float32),
        "advantages": (r.normal(size=(B, T)) * loss_mask).astype(np.float32),
        "ref_logprobs": np.where(loss_mask, -np.log(cfg.vocab_size), 0).astype(np.float32),
    }


def _examples(n=8):
    return [(f"Compute {i} + {i + 3}. Final answer: ", str(2 * i + 3)) for i in range(n)]


def _rollout_arrays(seed):
    """2 prompts x 8 rows in the engines' layout (left-padded prompts,
    right-padded responses of 1-12 tokens, behaviour logprobs)."""
    r = np.random.default_rng(seed)
    tok = JTokenizer()
    prompts = [tok.encode(p) for p, _ in _examples(2)]
    B, P, N = 16, 64, 12
    prompt_ids = np.zeros((B, P), np.int32)
    prompt_mask = np.zeros((B, P), bool)
    for i in range(B):
        p = prompts[i // 8]
        prompt_ids[i, P - len(p):] = p
        prompt_mask[i, P - len(p):] = True
    lens = r.integers(1, N + 1, B)
    response_mask = np.arange(N)[None, :] < lens[:, None]
    response_ids = np.where(response_mask, r.integers(2, 258, (B, N)), 0).astype(np.int32)
    lps = np.where(response_mask, r.uniform(-6.0, -0.1, (B, N)), 0).astype(np.float32)
    answers = [a for _, a in _examples(2) for _ in range(8)]
    return dict(prompt_ids=prompt_ids, prompt_mask=prompt_mask, response_ids=response_ids,
                response_mask=response_mask, response_logprobs=lps, answers=answers)


PERM = np.random.default_rng(3).permutation(16)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    params = jax.tree_util.tree_map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    rcfg = jconfig.load_config(YAML, RUNNER_OV)
    rparams = jax.tree_util.tree_map(
        np.asarray, JM.init_params(rcfg.model, jax.random.PRNGKey(1)))
    batches = [_batch(tcfg, seed=0)]
    prompts = [list(np.random.default_rng(5).integers(1, tcfg.vocab_size, n)) for n in
               (3, 9, 14, 5)]
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, rparams=rparams, batches=batches,
                prompts=prompts, rollouts=[_rollout_arrays(s) for s in (0, 1)])


@pytest.fixture(scope="module")
def world(setup, tmp_path_factory):
    """Every port-side check, in one world of 4, started in the background:
    ``world()`` waits for it and returns (the ranks' results, the
    checkpoint directory)."""
    s = setup
    tcfg = s["tcfg"]
    ckpt = str(tmp_path_factory.mktemp("mesh_ckpt"))
    items = [("train_steps", dict(mesh_cfg=m, size=n, cfg=tcfg, params=s["params"],
                                  batches=s["batches"], opt_cfg=TS.OptimizerConfig(**OPT),
                                  loss_cfg=TL.PolicyLossConfig(**LOSS), num_microbatches=2))
             for m, n in TRAIN_MESHES.values()]
    items += [
        ("logprobs", dict(mesh_cfg=FSDP_TP, cfg=tcfg, params=s["params"],
                          batch=s["batches"][0])),
        ("greedy_rollout", dict(mesh_cfg=MeshConfig(data=2), size=2, cfg=tcfg,
                                params=s["params"], prompts=s["prompts"],
                                max_new_tokens=N_NEW)),
        ("quantized_blocks", dict(mesh_cfg=MeshConfig(data=1, tensor=2), size=2, cfg=tcfg,
                                  params=s["params"])),
        ("runner_steps", dict(mesh_cfg=FSDP_TP, yaml=YAML, overrides=RUNNER_OV,
                              params=s["rparams"], rollouts=s["rollouts"], perm=PERM,
                              reward="odd_rule_reward", ckpt_dir=ckpt, pipelined_steps=2,
                              rescale_to=MeshConfig(data=4))),
    ]
    pending = start_world(worlds.jobs, 4, (items, "cpu"), device="cpu",
                          workdir=str(tmp_path_factory.mktemp("e2e_world")),
                          lock=str(tmp_path_factory.getbasetemp().parent / "worlds.lock"))
    names = [*TRAIN_MESHES, "logprobs", "greedy", "quant", "runner"]

    @functools.cache
    def result():
        return [dict(zip(names, r)) for r in pending.result()], ckpt

    yield result
    concurrent.futures.wait([pending])


def _jax_mesh(cfg: MeshConfig, n: int):
    return jmesh.make_mesh(jmesh.MeshConfig(**dataclasses.asdict(cfg)), devices=jax.devices()[:n])


def _jax_train(setup, mesh_cfg, n):
    jcfg = setup["jcfg"]
    jm = _jax_mesh(mesh_cfg, n)
    tx = JS.make_optimizer(JS.OptimizerConfig(**OPT))
    params = jax.tree_util.tree_map(jnp.asarray, setup["params"])
    with jax.set_mesh(jm):
        state = JS.create_train_state(lambda rng: params, tx, jax.random.PRNGKey(0), mesh=jm,
                                      partition_rules=JM.partition_rules())
        step = JL.make_policy_train_step(jcfg, JL.PolicyLossConfig(**LOSS), tx,
                                         num_microbatches=2, remat=False, attn_impl="xla",
                                         mesh=jm)
        losses, norms = [], []
        for b in setup["batches"]:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(m["actor/loss"]))
            norms.append(float(m["actor/grad_norm"]))
    return losses, norms, jax.tree_util.tree_map(np.asarray, state.params)


def _jax_logprobs(setup):
    jcfg, b = setup["jcfg"], setup["batches"][0]
    params = jax.tree_util.tree_map(jnp.asarray, setup["params"])
    jlp, jent = JL.make_logprob_fn(jcfg, chunk_size=16, attn_impl="xla")(
        params, {k: jnp.asarray(v) for k, v in b.items()})
    hidden, _ = JM.forward_hidden(params, jcfg, jnp.asarray(b["input_ids"]),
                                  attention_mask=jnp.asarray(b["attention_mask"]))
    jm = _jax_mesh(FSDP_TP, 4)
    with jax.set_mesh(jm):
        vlp, vent = jvocab_parallel(hidden, params["lm_head"], jnp.asarray(b["target_ids"]),
                                    mesh=jm, vocab_axis="tensor")
    return {k: np.asarray(v) for k, v in dict(lp=jlp, ent=jent, vlp=vlp, vent=vent).items()}


def _jax_greedy(setup):
    jm = _jax_mesh(MeshConfig(data=2), 2)
    jeng = JEngine(setup["jcfg"], JSampling(max_new_tokens=N_NEW, greedy=True, eos_token_id=-1),
                   prompt_bucket=8)
    params = jax.tree_util.tree_map(jnp.asarray, setup["params"])
    with jax.set_mesh(jm):
        return jeng.rollout(params, jio.RolloutRequest(prompt_ids=setup["prompts"]),
                            jax.random.PRNGKey(0), mesh=jm)


def _jax_runner(setup):
    jcfg = jconfig.load_config(YAML, RUNNER_OV)
    params = jax.tree_util.tree_map(jnp.asarray, setup["rparams"])
    jm = _jax_mesh(FSDP_TP, 4)
    data = JDataset([JExample(f"q{i}", "a") for i in range(8)])
    with pytest.MonkeyPatch.context() as mp, jax.set_mesh(jm):
        mp.setattr(jax.random, "permutation", lambda key, n: jnp.asarray(PERM[:n]))
        jr = JRunner(jcfg, JTokenizer(), data, mesh=jm, init_params_override=lambda rng: params,
                     reward_fn=worlds.odd_rule_reward)
        jms = [jr._train_on_result(jio.RolloutResult(**copy.deepcopy(a)))
               for a in setup["rollouts"]]
        return jms, jax.tree_util.tree_map(np.asarray, jr.state.params)


@pytest.fixture(scope="module")
def jax_side(setup, world, devices):
    """The JAX package's side of every check, computed while the world
    runs."""
    return {
        "train": {name: _jax_train(setup, *TRAIN_MESHES[name]) for name in TRAIN_MESHES},
        "logprobs": _jax_logprobs(setup),
        "greedy": _jax_greedy(setup),
        "quant": jquantize(jax.tree_util.tree_map(jnp.asarray, setup["params"]), fuse=False),
        "runner": _jax_runner(setup),
    }


@pytest.mark.parametrize("name", list(TRAIN_MESHES))
def test_train_step_matches_jax_on_the_mesh(jax_side, world, name):
    """One sharded train step (2 microbatches, entropy and KL terms, adamw
    with a clip that binds) at data=2, tensor=2 and fsdp=2 x tensor=2: the
    loss within 1e-5 relative, the grad norm 1e-4, the updated params
    1e-5, against the JAX step on the same mesh; every rank reports the
    same loss and grad norm, bitwise."""
    losses, norms, jparams = jax_side["train"][name]
    ranks, _ = world()
    for r in ranks:
        assert r[name]["losses"] == ranks[0][name]["losses"]
        assert r[name]["grad_norms"] == ranks[0][name]["grad_norms"]
    got = ranks[0][name]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got["grad_norms"], norms, rtol=1e-4)
    for (path, t), (_, j) in zip(flatten_with_paths(got["params"]),
                                 flatten_with_paths(jparams)):
        np.testing.assert_allclose(t, j, atol=1e-5, err_msg=path)


def test_logprobs_and_vocab_parallel_match_jax(jax_side, world):
    """``make_logprob_fn(mesh=)`` on fsdp=2 x tensor=2 against the JAX
    recompute, and ``vocab_parallel_logprobs_and_entropy`` over the
    tensor axis against the JAX package's on the same mesh: within 1e-5."""
    want = jax_side["logprobs"]
    ranks, _ = world()
    for r in ranks:
        got = r["logprobs"]
        for k in ("lp", "ent", "vlp", "vent"):
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)


def test_greedy_sharded_rollout_matches_jax(jax_side, world):
    """The static engine's greedy tokens at data=2 (2 prompts a rank,
    gathered to both) equal the JAX engine's on a data=2 mesh; the
    behaviour logprobs within 1e-4."""
    jres = jax_side["greedy"]
    ranks, _ = world()
    for r in ranks:
        np.testing.assert_array_equal(r["greedy"]["ids"], np.asarray(jres.response_ids))
        np.testing.assert_allclose(r["greedy"]["lps"], np.asarray(jres.response_logprobs),
                                   atol=1e-4)


def test_int8_blocks_of_a_tensor_shard_match_jax(jax_side, world):
    """int8 decode weights of a tensor=2 shard: the column-parallel blocks
    and the row-parallel ``wo``/``down`` (whose absmax is reduced over the
    tensor group) equal the JAX package's int8 weights and scales,
    sliced, bitwise."""
    jq = jax_side["quant"]
    ranks, _ = world()
    for r in ranks:
        got = r["quant"]
        t = got["tensor_index"]
        for k, (q, s) in got["blocks"].items():
            jw = jq["blocks"][k]
            jqv, jsv = np.asarray(jw.q), np.asarray(jw.scale)
            if k in ("wo", "down"):                  # rows split: scales whole
                n = q.shape[-2]
                jqv = jqv[..., t * n:(t + 1) * n, :]
            else:                                    # columns split
                n = q.shape[-1]
                jqv, jsv = jqv[..., t * n:(t + 1) * n], jsv[..., t * n:(t + 1) * n]
            np.testing.assert_array_equal(q, jqv, err_msg=k)
            np.testing.assert_array_equal(s, jsv, err_msg=k)


def test_runner_steps_on_the_mesh_match_jax(jax_side, world):
    """Two ``_train_on_result`` calls of ``ReasoningRunner(mesh=)`` at
    fsdp=2 x tensor=2 (the recompute on, 2 minibatches, the same
    permutation injected on both sides) against the JAX runner on the same
    mesh: every ``actor/*`` metric within 1e-4 relative (1e-6 absolute),
    the rollout metrics equal, the params within 1e-5; bitwise equal
    losses on every rank."""
    jms, jparams = jax_side["runner"]
    ranks, _ = world()
    for r in ranks:
        assert [m["actor/loss"] for m in r["runner"]["metrics"]] == \
            [m["actor/loss"] for m in ranks[0]["runner"]["metrics"]]
    got = ranks[0]["runner"]
    for tm, jmet in zip(got["metrics"], jms):
        actor = sorted(k for k in jmet if k.startswith("actor/"))
        assert actor == sorted(k for k in tm if k.startswith("actor/"))
        for k in actor:
            np.testing.assert_allclose(tm[k], float(jmet[k]), rtol=1e-4, atol=1e-6, err_msg=k)
        for k in ("rollout/reward_mean", "rollout/advantage_std"):
            np.testing.assert_allclose(tm[k], float(jmet[k]), rtol=1e-6)
    for (path, t), (_, j) in zip(flatten_with_paths(got["params"]), flatten_with_paths(jparams)):
        np.testing.assert_allclose(t, j, atol=1e-5, err_msg=path)


def test_run_pipelined_on_the_mesh(world):
    """``run_pipelined`` under a mesh (the rollout of batch N+1 and the
    update on N in turn, from the params before the update), after the
    rescale to data=4: two steps of the static engine's sharded rollout
    and the update, the same finite losses on every rank."""
    ranks, _ = world()
    hist = ranks[0]["runner"]["pipelined"]
    assert len(hist) == 2 and all(np.isfinite(h["actor/loss"]) for h in hist)
    assert all(h["time/rollout"] > 0 for h in hist)
    for r in ranks:
        assert [h["actor/loss"] for h in r["runner"]["pipelined"]] == \
            [h["actor/loss"] for h in hist]


def test_rescale_to_data4_keeps_params_bitwise(world):
    """``rescale`` from fsdp=2 x tensor=2 to data=4: every rank then holds
    whole leaves, equal bitwise to the sharded params gathered (the
    optimizer's moments too)."""
    ranks, _ = world()
    for r in ranks:
        run = r["runner"]
        for (path, a), (_, b) in zip(flatten_with_paths(run["params"]),
                                     flatten_with_paths(run["rescaled"])):
            np.testing.assert_array_equal(a, b, err_msg=path)
            assert run["rescaled_shapes"][path] == a.shape
        assert all(np.isfinite(v).all() for _, v in flatten_with_paths(run["rescaled_mu"]))


def test_sharded_checkpoint_restores_on_one_device(setup, world):
    """The runner's checkpoint, saved at fsdp=2 x tensor=2 after 2 steps,
    restores on one device (no mesh, no world) in the single-card layout,
    bitwise equal to the sharded params gathered."""
    from rlinf_tpu_torch import config as tconfig
    from rlinf_tpu_torch.models.llm.convert import params_from_numpy

    ranks, ckpt = world()
    cfg = tconfig.load_config(YAML, RUNNER_OV)
    tx = TS.make_optimizer(cfg.optimizer)
    template = TS.create_train_state(
        lambda: params_from_numpy(setup["rparams"], cfg.model, device="cpu"), tx)
    state, extra, step = CheckpointManager(ckpt).restore(template)
    assert step == 2 and "dataloader" in extra
    for (path, t), (_, want) in zip(flatten_with_paths(state.params),
                                    flatten_with_paths(ranks[0]["runner"]["params"])):
        np.testing.assert_array_equal(t.numpy(), want, err_msg=path)
