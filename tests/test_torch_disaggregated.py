"""The port's disaggregated runner (``tests/test_disaggregated.py``).

The refusals run in the test process. The runs go in one gloo world of 4
processes, started once for the module: the actor on ranks {0, 1} and the
rollout on {2, 3}, each a data=2 mesh, at the JAX tests' model (vocab 258,
D=32, 2 layers, f32) with the decoupled PPO loss. The rollout ranks
generate batch N+1 while the actor ranks train on batch N; every sync is
checked (the rollout ranks' whole weights against the actor's). One run
is held against the JAX package's runner on the same placement (actor on
devices 0-1, rollout on 2-3, in the test process): the same weights, the
same rollouts handed out in turn with the same version stamps, and the
same permutation.
The worlds of the test files take turns: each holds a lock in the test
session's temporary directory while it runs, so that test workers side
by side never run two at once.
"""

import concurrent.futures
import copy
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
from rlinf_tpu.parallel.mesh import ComponentPlacement as JPlacement
from rlinf_tpu.runners import reasoning_runner as JRR
from rlinf_tpu.runners.disaggregated_runner import DisaggregatedReasoningRunner as JDisagg
from rlinf_tpu_torch import config as tconfig
from rlinf_tpu_torch.data.datasets import PromptDataset, PromptExample
from rlinf_tpu_torch.data.tokenizers import ByteTokenizer
from rlinf_tpu_torch.parallel import ComponentPlacement, PlacementMode
from rlinf_tpu_torch.parallel import worlds
from rlinf_tpu_torch.parallel.launch import start_world
from rlinf_tpu_torch.parallel.mesh import MeshConfig
from rlinf_tpu_torch.parallel.sharding import flatten_with_paths
from rlinf_tpu_torch.runners.disaggregated_runner import DisaggregatedReasoningRunner

YAML = "examples/reasoning/config/grpo_demo_tiny.yaml"
#: the JAX tests' configuration (tests/test_disaggregated.py _cfg)
OVERRIDES = [
    "model.hidden_size=32", "model.intermediate_size=64", "model.num_heads=2",
    "model.num_kv_heads=2", "model.max_seq_len=128", "sampling.max_new_tokens=8",
    "optimizer.lr=5e-3", "optimizer.clip_grad=1.0", "loss.loss_type=decoupled",
    "algorithm.group_size=8", "runner.rollout_batch_size=8", "runner.log_dir=null",
]
STEPS = 24
DATA2 = MeshConfig(data=-1)
#: the comparison with the JAX runner: 2 prompts x 8, the recompute on, and
#: adam's eps at 1e-3 as in the mesh runner test (an entry whose gradient
#: is rounding noise on both sides would otherwise move by up to 2 lr)
CMP_OV = [*OVERRIDES, "runner.rollout_batch_size=2", "algorithm.recompute_logprobs=true",
          "optimizer.eps=1e-3"]
CMP_STEPS = 3
PERM = np.random.default_rng(3).permutation(16)


def _rollout_arrays(seed):
    """2 prompts x 8 rows in the engines' layout (left-padded prompts,
    right-padded responses of 1-8 tokens, behaviour logprobs)."""
    r = np.random.default_rng(seed)
    tok = JTokenizer()
    prompts = [tok.encode(f"q{i}") for i in range(2)]
    B, P, N = 16, 8, 8
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
    return dict(prompt_ids=prompt_ids, prompt_mask=prompt_mask, response_ids=response_ids,
                response_mask=response_mask, response_logprobs=lps, answers=["a"] * B)


@pytest.fixture(scope="module")
def compared():
    """The JAX-layout weights and the rollouts both runners are given."""
    cfg = jconfig.load_config(YAML, CMP_OV)
    params = jax.tree_util.tree_map(np.asarray, JM.init_params(cfg.model, jax.random.PRNGKey(2)))
    return params, [_rollout_arrays(s) for s in range(CMP_STEPS)]


def _dataset():
    return PromptDataset([PromptExample(f"question {i}:", "unused") for i in range(32)])


@pytest.fixture(scope="module", autouse=True)
def world(compared, tmp_path_factory):
    """The runs' world, started with the module's first test; ``world()``
    waits for it."""
    params, rollouts = compared
    items = [
        ("disaggregated_run", dict(yaml=YAML, overrides=OVERRIDES, steps=STEPS, syncer=syncer,
                                   actor_cfg=DATA2, rollout_cfg=DATA2))
        for syncer in ("bucket", "patch")
    ]
    items.append(("disaggregated_run", dict(yaml=YAML, overrides=OVERRIDES, steps=8,
                                            sync_interval=4, actor_cfg=DATA2,
                                            rollout_cfg=DATA2)))
    items.append(("disaggregated_steps", dict(yaml=YAML, overrides=CMP_OV, params=params,
                                              rollouts=rollouts, perm=PERM, actor_cfg=DATA2,
                                              rollout_cfg=DATA2)))
    pending = start_world(worlds.jobs, 4, (items, "cpu"), device="cpu",
                          workdir=str(tmp_path_factory.mktemp("disagg_world")),
                          lock=str(tmp_path_factory.getbasetemp().parent / "worlds.lock"))

    @functools.cache
    def result():
        out = pending.result()
        return {"bucket": [r[0] for r in out], "patch": [r[1] for r in out],
                "interval4": [r[2] for r in out], "compared": [r[3] for r in out]}

    yield result
    concurrent.futures.wait([pending])


def _placement(actor, rollout):
    return ComponentPlacement(components={"actor": actor, "rollout": rollout}, world_size=4)


def test_rejects_collocated_placement():
    p = _placement("0-3", "0-3")
    assert p.mode == PlacementMode.COLLOCATED
    with pytest.raises(ValueError, match="DISAGGREGATED"):
        DisaggregatedReasoningRunner(tconfig.load_config(YAML, OVERRIDES), ByteTokenizer(),
                                     _dataset(), placement=p, device="cpu")


def test_rejects_plain_ppo_loss():
    cfg = tconfig.load_config(YAML, [*OVERRIDES, "loss.loss_type=ppo"])
    with pytest.raises(ValueError, match="decoupled"):
        DisaggregatedReasoningRunner(cfg, ByteTokenizer(), _dataset(),
                                     placement=_placement("0-1", "2-3"), device="cpu")


def test_disaggregated_steps_match_jax(compared, world, devices, monkeypatch):
    """Three steps of the port's runner against the JAX package's on the
    same placement, from the same weights, with the same rollouts handed
    out in turn (stamped with the version they would have been generated
    at: 0, 0, 1) and the same permutation: every ``actor/*`` metric within
    1e-4 relative (1e-6 absolute), the rewards, version lags and param
    versions equal, the rollout's whole weights after each sync (the
    initial one first) within 1e-5 of the JAX rollout params, and the same
    history on every rank."""
    params, rollouts = compared
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    monkeypatch.setattr(JRR, "init_params", lambda cfg, rng: jparams)
    monkeypatch.setattr(jax.random, "permutation", lambda key, n: jnp.asarray(PERM[:n]))
    placement = JPlacement(components={"actor": "0-1", "rollout": "2-3"})
    jr = JDisagg(jconfig.load_config(YAML, CMP_OV), JTokenizer(),
                 JDataset([JExample(f"q{i}", "a") for i in range(8)]), placement=placement,
                 reward_fn=worlds.odd_rule_reward)
    calls, synced = [], [jax.tree_util.tree_map(np.asarray, jr.rollout_params)]

    def injected():
        k = len(calls)
        calls.append(k)
        res = jio.RolloutResult(**copy.deepcopy(rollouts[k]))
        res.version = max(k - 1, 0)          # generated while step k-1 trained
        return res

    sync = jr._sync_weights

    def recorded():
        sync()
        synced.append(jax.tree_util.tree_map(np.asarray, jr.rollout_params))

    jr._disagg_rollout = injected
    jr._sync_weights = recorded
    jhist = jr.run(max_steps=CMP_STEPS)

    ranks = world()["compared"]
    hist = ranks[0]["history"]
    for r in ranks:
        assert [h["actor/loss"] for h in r["history"]] == [h["actor/loss"] for h in hist]
    assert len(hist) == len(jhist) == CMP_STEPS
    for tm, jm in zip(hist, jhist):
        actor = sorted(k for k in jm if k.startswith("actor/"))
        assert actor == sorted(k for k in tm if k.startswith("actor/"))
        for k in actor:
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-4, atol=1e-6, err_msg=k)
        for k in ("rollout/reward_mean", "disagg/version_lag", "disagg/param_version"):
            assert tm[k] == float(jm[k]), k
    assert [h["disagg/version_lag"] for h in hist] == [0.0, 1.0, 1.0]
    got = ranks[2]["synced"]
    assert len(got) == len(synced) == CMP_STEPS + 1
    for g, j in zip(got, synced):
        g, j = dict(flatten_with_paths(g)), dict(flatten_with_paths(j))
        assert sorted(g) == sorted(j)
        for path, t in g.items():
            np.testing.assert_allclose(t, np.asarray(j[path]), atol=1e-5, err_msg=path)


@pytest.mark.parametrize("syncer", ["bucket", "patch"])
def test_disaggregated_learns(world, syncer):
    """A sync a step (version 24 after 24 steps), the rollout one version
    behind the actor from step 2 on, every rank with the actor's history,
    the rollout's weights equal to the actor's after every bucket sync
    (within 1e-3 for the int8 patches), and the reward learned."""
    ranks = world()[syncer]
    assert [r["is_actor"] for r in ranks] == [True, True, False, False]
    hist = ranks[0]["history"]
    for r in ranks:
        assert r["param_version"] == STEPS
        assert [h["actor/loss"] for h in r["history"]] == [h["actor/loss"] for h in hist]
    lags = [h["disagg/version_lag"] for h in hist]
    assert lags[0] == 0.0 and all(lag == 1.0 for lag in lags[1:])
    diffs = [h["disagg/sync_max_abs"] for h in hist]
    assert max(diffs) == 0.0 if syncer == "bucket" else max(diffs) < 1e-3
    assert all(h["disagg/sync_bytes"] > 0 for h in hist)
    first = np.mean([h["rollout/reward_mean"] for h in hist[:5]])
    last = np.mean([h["rollout/reward_mean"] for h in hist[-5:]])
    assert last > first + 0.05, f"no learning: {first:.4f} -> {last:.4f}"


def test_sync_interval_batches_syncs(world):
    """sync_interval=4 over 8 steps: 2 syncs, a lag of at most 2."""
    for r in world()["interval4"]:
        assert r["param_version"] == 2
        hist = r["history"]
        assert max(h["disagg/version_lag"] for h in hist) <= 2.0
        assert [h["disagg/param_version"] for h in hist] == [0, 0, 0, 1, 1, 1, 1, 2]
