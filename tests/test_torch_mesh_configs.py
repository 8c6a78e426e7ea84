"""The mesh configurations the port's parallel layer first refused, against
the JAX package on meshes of the same shapes: ``SFTRunner(mesh=)``, the
continuous and paged engines under a mesh, LoRA and the token-budget
microbatches in ``ReasoningRunner(mesh=)``, adafactor on sharded leaves,
MoE (capacity and dropless) under tensor and fsdp sharding, and
``rescale`` with LoRA or a separate critic.

The port runs in one gloo world of 4 CPU processes (``parallel.launch``),
started once for the module, whose ranks run every case
(``parallel/worlds.py``) while the test process computes the JAX side on
the 8 virtual CPU devices; meshes of 2 ranks run side by side on {0, 1}
and {2, 3}. Both sides start from one JAX init. Everything is f32, at the
tolerances of ``tests/test_torch_mesh_e2e.py``.
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
from rlinf_tpu.models.llm import lora as JLORA
from rlinf_tpu.models.llm import model as JM
from rlinf_tpu.models.llm import value_head as JV
from rlinf_tpu.models.llm.config import LLMConfig as JConfig
from rlinf_tpu.models.llm.sampler import SamplingParams as JSampling
from rlinf_tpu.parallel import mesh as jmesh
from rlinf_tpu.rollout.continuous_engine import ContinuousBatchingEngine as JContinuous
from rlinf_tpu.rollout.paged_engine import PagedContinuousEngine as JPaged
from rlinf_tpu.runners.reasoning_runner import ReasoningRunner as JRunner
from rlinf_tpu.runners.sft_runner import SFTRunner as JSFTRunner
from rlinf_tpu.training import learner as JL
from rlinf_tpu.training import train_state as JS
from rlinf_tpu_torch import config as tconfig
from rlinf_tpu_torch.data.datasets import PromptDataset, PromptExample
from rlinf_tpu_torch.data.tokenizers import ByteTokenizer
from rlinf_tpu_torch.models.llm.config import LLMConfig as TConfig
from rlinf_tpu_torch.parallel import worlds
from rlinf_tpu_torch.parallel.launch import start_world
from rlinf_tpu_torch.parallel.mesh import MeshConfig
from rlinf_tpu_torch.parallel.sharding import flatten_with_paths
from rlinf_tpu_torch.runners.reasoning_runner import ReasoningRunner
from rlinf_tpu_torch.training import learner as TL
from rlinf_tpu_torch.training import train_state as TS

from test_torch_mesh_e2e import PERM, RUNNER_OV, YAML, _batch, _rollout_arrays

FSDP_TP = MeshConfig(data=1, fsdp=2, tensor=2)
DATA4 = MeshConfig(data=4)
TWO = {"data2": MeshConfig(data=2), "tensor2": MeshConfig(data=1, tensor=2)}
OPT = dict(lr=1e-3, eps=1e-3, weight_decay=0.01, clip_grad=0.5)
LOSS = dict(entropy_bonus=1e-2, kl_beta=0.05, logprob_chunk_size=16)
ENGINES = {"continuous": dict(num_slots=4, decode_chunk=3, max_seq_len=48),
           "paged": dict(num_slots=4, decode_chunk=3, max_seq_len=48, page_size=8)}
ENGINE_CASES = [(e, m) for e in ENGINES for m in TWO]
MOE_CASES = {"capacity_tensor2": ("capacity", "tensor2"),
             "capacity_fsdp2_tensor2": ("capacity", "fsdp2_tensor2"),
             "dropless_fsdp2_tensor2": ("dropless", "fsdp2_tensor2")}
MESHES = {**TWO, "fsdp2_tensor2": FSDP_TP}
SIZES = {"data2": 2, "tensor2": 2, "fsdp2_tensor2": 4}
N_NEW = 7
SFT_OV = ["runner.log_dir=null", "runner.rollout_batch_size=4", "optimizer.warmup_steps=0",
          "optimizer.lr=1e-3", "optimizer.eps=1e-3"]
LORA_OV = RUNNER_OV + ["lora.enabled=true", "lora.rank=4"]
BUDGET_OV = [o for o in RUNNER_OV if not o.startswith("loss.max_tokens_per_mb")] + [
    "loss.max_tokens_per_mb=160"]
CRITIC_OV = RUNNER_OV + ["algorithm.adv_type=gae", "algorithm.critic=separate"]
PROMPTS = [list(np.random.default_rng(5).integers(1, 256, n)) for n in (3, 9, 14, 5, 11)]


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _examples(n=8):
    return [(f"Compute {i} + {i + 3}. Final answer: ", str(2 * i + 3)) for i in range(n)]


def _tiny():
    jcfg = dataclasses.replace(JConfig.tiny(), tie_word_embeddings=False, qkv_bias=True)
    return jcfg, TConfig(**dataclasses.asdict(jcfg))


def _factored():
    """Widths whose leaves adafactor factors (the two largest dims >= 128)."""
    jcfg = dataclasses.replace(JConfig.tiny(), hidden_size=128, intermediate_size=256,
                               tie_word_embeddings=False)
    return jcfg, TConfig(**dataclasses.asdict(jcfg))


def _moe(impl):
    jcfg = dataclasses.replace(JConfig.tiny(), tie_word_embeddings=False, num_experts=4,
                               num_experts_per_token=2, moe_impl=impl)
    return jcfg, TConfig(**dataclasses.asdict(jcfg))


def _adapters(jcfg, lcfg, seed):
    """JAX-initialised adapters with ``b`` drawn non-zero too."""
    lp = JLORA.init_lora_params(jcfg, lcfg, jax.random.PRNGKey(seed))
    r = np.random.default_rng(seed)
    return _np_tree(jax.tree_util.tree_map(
        lambda x: x if np.asarray(x).any() else
        jnp.asarray(r.normal(size=x.shape) * 0.05, x.dtype), lp))


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _tiny()
    rcfg = jconfig.load_config(YAML, RUNNER_OV)
    lcfg = jconfig.load_config(YAML, LORA_OV)
    fj, ft = _factored()
    moe = {impl: _moe(impl) for impl in ("capacity", "dropless")}
    return dict(
        jcfg=jcfg, tcfg=tcfg, params=_np_tree(JM.init_params(jcfg, jax.random.PRNGKey(0))),
        rparams=_np_tree(JM.init_params(rcfg.model, jax.random.PRNGKey(1))),
        sparams=_np_tree(JM.init_params(jconfig.load_config(YAML, SFT_OV).model,
                                        jax.random.PRNGKey(4))),
        adapters=_adapters(lcfg.model, lcfg.lora, 5),
        critic=_np_tree(JV.add_value_head(JM.init_params(rcfg.model, jax.random.PRNGKey(6)),
                                          rcfg.model, jax.random.PRNGKey(7))),
        factored=(fj, ft, _np_tree(JM.init_params(fj, jax.random.PRNGKey(2)))),
        moe={impl: (j, t, _np_tree(JM.init_params(j, jax.random.PRNGKey(3))))
             for impl, (j, t) in moe.items()},
        batches=[_batch(tcfg, seed=0), _batch(tcfg, seed=1)],
        rollouts=[_rollout_arrays(s) for s in (0, 1)])


@pytest.fixture(scope="module")
def world(setup, tmp_path_factory):
    s = setup
    fj, ft, fparams = s["factored"]
    items, names = [], []

    def add(name, fn, **kw):
        items.append((fn, kw))
        names.append(name)

    add("sft", "sft_steps", mesh_cfg=FSDP_TP, yaml=YAML, overrides=SFT_OV, params=s["sparams"],
        examples=_examples(), steps=2)
    for engine, mesh in ENGINE_CASES:
        add(f"{engine}_{mesh}", "greedy_rollout", mesh_cfg=TWO[mesh], size=2, cfg=s["tcfg"],
            params=s["params"], prompts=PROMPTS, max_new_tokens=N_NEW, engine=engine,
            engine_kw=ENGINES[engine])
    add("lora", "runner_steps", mesh_cfg=FSDP_TP, yaml=YAML, overrides=LORA_OV,
        params=s["rparams"], rollouts=s["rollouts"], perm=PERM, reward="odd_rule_reward",
        adapters=s["adapters"])
    add("budget", "runner_steps", mesh_cfg=FSDP_TP, yaml=YAML, overrides=BUDGET_OV,
        params=s["rparams"], rollouts=s["rollouts"], perm=PERM, reward="odd_rule_reward")
    add("adafactor", "train_steps", mesh_cfg=FSDP_TP, cfg=ft, params=fparams,
        batches=s["batches"], opt_cfg=TS.OptimizerConfig(name="adafactor", **OPT),
        loss_cfg=TL.PolicyLossConfig(**LOSS))
    for name, (impl, mesh) in MOE_CASES.items():
        _, mt, mparams = s["moe"][impl]
        add(name, "train_steps", mesh_cfg=MESHES[mesh], size=SIZES[mesh], cfg=mt,
            params=mparams, batches=s["batches"][:1], opt_cfg=TS.OptimizerConfig(**OPT),
            loss_cfg=TL.PolicyLossConfig(**LOSS), num_microbatches=2)
    add("critic_rescale", "runner_steps", mesh_cfg=DATA4, yaml=YAML, overrides=CRITIC_OV,
        params=s["rparams"], rollouts=s["rollouts"][:1], perm=PERM, reward="odd_rule_reward",
        critic_params=s["critic"], rescale_to=FSDP_TP, rollouts_after=s["rollouts"][1:])
    pending = start_world(worlds.jobs, 4, (items, "cpu"), device="cpu",
                          workdir=str(tmp_path_factory.mktemp("configs_world")),
                          lock=str(tmp_path_factory.getbasetemp().parent / "worlds.lock"))

    @functools.cache
    def result():
        return [dict(zip(names, r)) for r in pending.result()]

    yield result
    concurrent.futures.wait([pending])


def _jax_mesh(cfg: MeshConfig, n: int):
    return jmesh.make_mesh(jmesh.MeshConfig(**dataclasses.asdict(cfg)), devices=jax.devices()[:n])


def _jax_runner(setup, overrides, mesh_cfg, rollouts, *, adapters=None, critic=None,
                rescale_to=None, rollouts_after=()):
    jcfg = jconfig.load_config(YAML, overrides)
    params = jax.tree_util.tree_map(jnp.asarray, setup["rparams"])
    jm = _jax_mesh(mesh_cfg, 4)
    data = JDataset([JExample(f"q{i}", "a") for i in range(8)])
    with pytest.MonkeyPatch.context() as mp, jax.set_mesh(jm):
        mp.setattr(jax.random, "permutation", lambda key, n: jnp.asarray(PERM[:n]))
        jr = JRunner(jcfg, JTokenizer(), data, mesh=jm, init_params_override=lambda rng: params,
                     reward_fn=worlds.odd_rule_reward)
        if adapters is not None:
            jl = jax.tree_util.tree_map(jnp.asarray, adapters)
            jr.state = JS.TrainState(jr.state.step, jl, jr.tx.init(jl))
        if critic is not None:
            from rlinf_tpu.models.llm.value_head import value_partition_rules

            cp = jax.tree_util.tree_map(jnp.asarray, critic)
            jr.critic_state = JS.create_train_state(
                lambda rng: cp, jr.critic_tx, jax.random.PRNGKey(0), mesh=jm,
                partition_rules=value_partition_rules() + JM.partition_rules())
        jms = [jr._train_on_result(jio.RolloutResult(**copy.deepcopy(a))) for a in rollouts]
        after = []
        if rescale_to is not None:
            new = _jax_mesh(rescale_to, 4)
            jr.rescale(new)
            with jax.set_mesh(new):
                after = [jr._train_on_result(jio.RolloutResult(**copy.deepcopy(a)))
                         for a in rollouts_after]
        return jms, _np_tree(jr.state.params), after


def _jax_train(cfg, params, batches, mesh_cfg, n, opt, num_microbatches=1):
    jm = _jax_mesh(mesh_cfg, n)
    tx = JS.make_optimizer(JS.OptimizerConfig(**opt))
    p = jax.tree_util.tree_map(jnp.asarray, params)
    with jax.set_mesh(jm):
        state = JS.create_train_state(lambda rng: p, tx, jax.random.PRNGKey(0), mesh=jm,
                                      partition_rules=JM.partition_rules())
        step = JL.make_policy_train_step(cfg, JL.PolicyLossConfig(**LOSS), tx,
                                         num_microbatches=num_microbatches, remat=False,
                                         attn_impl="xla", mesh=jm)
        losses, norms = [], []
        for b in batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(m["actor/loss"]))
            norms.append(float(m["actor/grad_norm"]))
    return losses, norms, _np_tree(state.params)


def _jax_engine(setup, engine, mesh):
    kind = {"continuous": JContinuous, "paged": JPaged}[engine]
    jeng = kind(setup["jcfg"], JSampling(max_new_tokens=N_NEW, greedy=True, eos_token_id=-1),
                prompt_bucket=8, **ENGINES[engine])
    jm = _jax_mesh(TWO[mesh], 2)
    params = jax.tree_util.tree_map(jnp.asarray, setup["params"])
    with jax.set_mesh(jm):
        return jeng.rollout(params, jio.RolloutRequest(prompt_ids=PROMPTS),
                            jax.random.PRNGKey(0), mesh=jm)


def _jax_sft(setup):
    jcfg = jconfig.load_config(YAML, SFT_OV)
    params = jax.tree_util.tree_map(jnp.asarray, setup["sparams"])
    jm = _jax_mesh(FSDP_TP, 4)
    with jax.set_mesh(jm):
        jr = JSFTRunner(jcfg, JTokenizer(), JDataset([JExample(p, a) for p, a in _examples()]),
                        init_params_override=lambda rng: params, mesh=jm)
        ms = [jr.run_step() for _ in range(2)]
    return ms, _np_tree(jr.state.params)


@pytest.fixture(scope="module")
def jax_side(setup, world, devices):
    s = setup
    fj, _, fparams = s["factored"]
    return {
        "sft": _jax_sft(s),
        "engines": {(e, m): _jax_engine(s, e, m) for e, m in ENGINE_CASES},
        "lora": _jax_runner(s, LORA_OV, FSDP_TP, s["rollouts"], adapters=s["adapters"]),
        "budget": _jax_runner(s, BUDGET_OV, FSDP_TP, s["rollouts"]),
        "adafactor": _jax_train(fj, fparams, s["batches"], FSDP_TP, 4,
                                dict(name="adafactor", **OPT)),
        "moe": {name: _jax_train(s["moe"][impl][0], s["moe"][impl][2], s["batches"][:1],
                                 MESHES[mesh], SIZES[mesh], OPT, num_microbatches=2)
                for name, (impl, mesh) in MOE_CASES.items()},
        "critic_rescale": _jax_runner(s, CRITIC_OV, DATA4, s["rollouts"][:1],
                                      critic=s["critic"], rescale_to=FSDP_TP,
                                      rollouts_after=s["rollouts"][1:]),
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


def _same_on_every_rank(ranks, name, key="metrics"):
    first = [m["actor/loss"] for m in ranks[0][name][key]]
    for r in ranks:
        assert [m["actor/loss"] for m in r[name][key]] == first


def test_sft_runner_on_the_mesh_matches_jax(jax_side, world):
    """Two ``run_step`` calls of ``SFTRunner(mesh=)`` at fsdp=2 x tensor=2
    against the JAX runner on the same mesh from one init: every sft/*
    metric within 1e-5 relative, the params within 1e-5, every rank the
    same metrics bitwise."""
    jms, jparams = jax_side["sft"]
    ranks = world()
    for r in ranks:
        assert [m["sft/loss"] for m in r["sft"]["metrics"]] == \
            [m["sft/loss"] for m in ranks[0]["sft"]["metrics"]]
    got = ranks[0]["sft"]
    for tm, jm in zip(got["metrics"], jms):
        assert set(tm) == set(jm)
        for k in jm:
            if k.startswith("sft/"):
                np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-7, err_msg=k)
    _close_tree(got["params"], jparams, 1e-5)


@pytest.mark.parametrize("engine, mesh", ENGINE_CASES)
def test_slot_pool_engine_on_a_mesh_matches_jax(jax_side, world, engine, mesh):
    """The continuous and paged engines' ``rollout(mesh=)`` at data=2 and
    at tensor=2 (the pool whole on every rank, the model over the rank's
    blocks; 5 requests in 4 slots, so that a slot is refilled): greedy
    tokens equal to the JAX engine's under the same mesh, the behaviour
    logprobs within 1e-4, every rank the same tokens."""
    jres = jax_side["engines"][(engine, mesh)]
    ranks = world()
    for r in ranks:
        got = r[f"{engine}_{mesh}"]
        np.testing.assert_array_equal(got["ids"], np.asarray(jres.response_ids))
        np.testing.assert_allclose(got["lps"], np.asarray(jres.response_logprobs), atol=1e-4)


@pytest.mark.parametrize("name", ["lora", "budget"])
def test_lora_and_token_budget_runner_on_the_mesh_match_jax(jax_side, world, name):
    """Two ``_train_on_result`` calls of ``ReasoningRunner(mesh=)`` at
    fsdp=2 x tensor=2, with LoRA (base params sharded, the JAX runner's
    adapters whole on every rank, merged per rank on its blocks) and with
    the token budget (``max_tokens_per_mb=160``: microbatches of any number
    of rows, padded to the batch axes): every ``actor/*`` metric within
    1e-4 relative (1e-6 absolute), the trained tree within 1e-5, bitwise
    equal losses on every rank."""
    jms, jparams, _ = jax_side[name]
    ranks = world()
    _same_on_every_rank(ranks, name)
    got = ranks[0][name]
    for tm, jm in zip(got["metrics"], jms):
        _close_actor(tm, jm)
    if name == "budget":
        assert all(m["actor/num_dyn_microbatches"] >= 2 for m in got["metrics"])
    _close_tree(got["params"], jparams, 1e-5)


def test_adafactor_on_sharded_leaves_matches_jax(jax_side, world):
    """Two adafactor train steps at fsdp=2 x tensor=2 on widths whose
    leaves factor (the row and column statistics reduced over the ranks
    that hold each row and column, the block-RMS clip and the parameter
    scale over whole leaves): the losses within 1e-5 relative, the grad
    norms 1e-4, the params 1e-5 of JAX's adafactor on the same mesh."""
    losses, norms, jparams = jax_side["adafactor"]
    ranks = world()
    for r in ranks:
        assert r["adafactor"]["losses"] == ranks[0]["adafactor"]["losses"]
    got = ranks[0]["adafactor"]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got["grad_norms"], norms, rtol=1e-4)
    _close_tree(got["params"], jparams, 1e-5)
    assert got["opt_state"]["v_row"]["blocks"]["wq"].shape == (2, 128)


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_under_tensor_and_fsdp_matches_jax(jax_side, world, name):
    """One MoE train step (2 microbatches, 4 experts top-2) with the
    capacity dispatch at tensor=2 and at fsdp=2 x tensor=2, and the
    dropless one at fsdp=2 x tensor=2 (the router whole on every tensor
    rank, each expert's columns split, one all-reduce after ``down``):
    the loss within 1e-5 relative, the grad norm 1e-4, the params 1e-5 of
    JAX's on the same mesh."""
    losses, norms, jparams = jax_side["moe"][name]
    ranks = world()
    got = ranks[0][name]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got["grad_norms"], norms, rtol=1e-4)
    _close_tree(got["params"], jparams, 1e-5)


@pytest.mark.parametrize("case", ["lora", "separate_critic"])
def test_jax_rescale_with_lora_or_a_separate_critic(devices, jax_side, case):
    """The JAX runner's ``rescale`` (data=4 -> fsdp=2 x tensor=2 on the same
    devices) and one more step. With LoRA it replaces the LoRA step by a
    full-parameter train step over the adapter tree, which fails
    (KeyError 'embed'): the port keeps its refusal (ROADMAP.md §C.4). With
    a separate critic it re-shards the actor and leaves the critic and the
    steps as they were; the step after it equals, within 1e-5, the step of
    a runner that never rescaled: the port follows it."""
    s = {"rparams": _np_tree(JM.init_params(jconfig.load_config(YAML, RUNNER_OV).model,
                                            jax.random.PRNGKey(1)))}
    rollouts = [_rollout_arrays(0), _rollout_arrays(1)]
    if case == "lora":
        lcfg = jconfig.load_config(YAML, LORA_OV)
        with pytest.raises(KeyError, match="embed"):
            _jax_runner(s, LORA_OV, DATA4, rollouts[:1],
                        adapters=_adapters(lcfg.model, lcfg.lora, 5), rescale_to=FSDP_TP,
                        rollouts_after=rollouts[1:])
        return
    rcfg = jconfig.load_config(YAML, RUNNER_OV)
    critic = _np_tree(JV.add_value_head(JM.init_params(rcfg.model, jax.random.PRNGKey(6)),
                                        rcfg.model, jax.random.PRNGKey(7)))
    # the rescaled run is the module's (the same params, critic and rollouts)
    _, p_resc, after = jax_side["critic_rescale"]
    ms, p_plain, _ = _jax_runner(s, CRITIC_OV, DATA4, rollouts, critic=critic)
    for k in after[0]:
        if k.startswith(("actor/", "critic/")):
            np.testing.assert_allclose(after[0][k], ms[1][k], rtol=1e-5, atol=1e-7, err_msg=k)
    _close_tree(p_resc, p_plain, 1e-5)


def test_rescale_with_a_separate_critic_matches_jax(jax_side, world):
    """The port's ``rescale`` with a separate critic (data=4 -> fsdp=2 x
    tensor=2; the actor re-sharded, the critic left on the old mesh, as
    the JAX runner leaves it): the step before and the step after within
    1e-4 relative (1e-6 absolute) of the JAX runner's, ``critic/*``
    included, the actor's params 1e-5; the same losses on every rank."""
    jms, _, jafter = jax_side["critic_rescale"]
    ranks = world()
    _same_on_every_rank(ranks, "critic_rescale", "metrics_after")
    got = ranks[0]["critic_rescale"]
    for tm, jm in zip(got["metrics"] + got["metrics_after"], list(jms) + list(jafter)):
        _close_actor(tm, jm)
        # the clip ratio counts |prev + clip(v - prev) - prev| > clip, true
        # only where the sum rounds: it is rounding noise in both packages
        for k in (k for k in jm if k.startswith("critic/") and k != "critic/value_clip_ratio"):
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    assert got["rescaled_shapes"]["blocks/wq"][-1] == got["params"]["blocks"]["wq"].shape[-1] // 2


def test_rescale_with_lora_still_raises():
    """The port keeps refusing ``rescale`` with LoRA, saying why: the JAX
    runner's rescale trains the wrong tree there (the case above)."""
    cfg = tconfig.load_config(YAML, LORA_OV)
    r = ReasoningRunner(cfg, ByteTokenizer(), PromptDataset([PromptExample("q", "a")] * 2),
                        device="cpu")
    with pytest.raises(NotImplementedError, match="reasoning_runner.py:259-286"):
        r.rescale(None)
