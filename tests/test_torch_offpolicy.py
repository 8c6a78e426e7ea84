"""The port's off-policy embodied path against the JAX package's, on the
CPU: ``MLPSACPolicy``, one SAC step (``make_sac_train_step``) with its
Polyak targets, the async SAC and async PPO runners (``tests/test_sac_async.py``'s
learning checks at its sizes and thresholds), the async PPO step and batch
against the JAX runner's, the rollout thread's snapshots, and
``main_sac_async``.

Both packages start from one init (the port's, with N(0, 0.05) noise on
every leaf; its tree held to JAX's init by ``jax.eval_shape``). Draws
differ (threefry against a torch ``Generator``), so the deterministic
paths are held value for value on the JAX draws handed to the port
(``noise=``), and the port's own draws by the logprob JAX gives them.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlinf_tpu.envs import toy as jtoy
from rlinf_tpu.models.embodiment import mlp_policy as jmlp
from rlinf_tpu.models.embodiment import sac_policy as jsac
from rlinf_tpu.runners import async_ppo_runner as jppo
from rlinf_tpu.training import sac_learner as jsac_learner
from rlinf_tpu.training import train_state as JS
from rlinf_tpu_torch.envs.toy import BanditEnv, PointReachEnv
from rlinf_tpu_torch.models.embodiment import MLPGaussianPolicy
from rlinf_tpu_torch.models.embodiment.sac_policy import MLPSACPolicy
from rlinf_tpu_torch.runners import async_ppo_runner as tppo
from rlinf_tpu_torch.runners.async_embodied_runner import AsyncEmbodiedRunner, AsyncRunnerConfig
from rlinf_tpu_torch.training import train_state as TS
from rlinf_tpu_torch.training.sac_learner import SACConfig, make_sac_train_step

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
#: the optimizer of the step comparisons: eps 1e-3 keeps Adam's first step
#: m / (sqrt(v) + eps) away from sign(g), which rounding can flip for tiny g
OPT = dict(lr=1e-3, eps=1e-3, clip_grad=0.0, weight_decay=0.0)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, what, **tol):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **(tol or TOL))


def _close_tree(got, want, what, **tol):
    g = jax.tree_util.tree_leaves(jax.tree_util.tree_map(_np, got))
    w = jax.tree_util.tree_leaves(jax.tree_util.tree_map(_np, want))
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        _close(a, b, f"{what} leaf {i}", **tol)


def _shared_params(tp, jp, seed):
    """(the port's params, JAX's): ``tp.init`` from ``seed`` + N(0, 0.05)
    noise on every leaf, its tree first held to the shapes and dtypes of
    JAX's init."""
    base = jax.tree_util.tree_map(
        lambda a: a.numpy(), tp.init(torch.Generator().manual_seed(seed), device="cpu"))
    want = jax.eval_shape(jp.init, jax.random.PRNGKey(seed))
    desc = lambda t: jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)), t)
    assert desc(base) == desc(want)
    r = np.random.default_rng(seed)
    noisy = jax.tree_util.tree_map(
        lambda a: (a + r.normal(0, 0.05, a.shape)).astype(a.dtype), base)
    return tp.params_from_numpy(noisy, device="cpu"), jax.tree_util.tree_map(jnp.asarray, noisy)


# ---------------------------------------------------------------------------
# the SAC policy and step
# ---------------------------------------------------------------------------

def _sac_pair(obs_dim=3, action_dim=2, hidden=(32, 32), seed=0):
    tp = MLPSACPolicy(obs_dim, action_dim, hidden)
    jp = jsac.MLPSACPolicy(obs_dim, action_dim, hidden)
    return (tp, jp, *_shared_params(tp, jp, seed))


def test_sac_policy_matches_jax():
    """default_forward (logprobs, entropy; 1e-5), the deterministic action,
    the sampled action on JAX's noise (action and logprob, 1e-5), twin Q
    and twin targets (1e-5); the port's own samples stay in [-1, 1] and
    their logprobs hold under JAX's default_forward (1e-3, JAX's test's
    bar: arctanh near +-1)."""
    tp, jp, tparams, jparams = _sac_pair()
    r = np.random.default_rng(1)
    obs = {"states": r.normal(size=(16, 3)).astype(np.float32)}
    acts = np.tanh(r.normal(size=(16, 2))).astype(np.float32)
    tobs = {"states": torch.as_tensor(obs["states"])}
    jobs = {"states": jnp.asarray(obs["states"])}
    t_fwd = tp.default_forward(tparams, tobs, torch.as_tensor(acts))
    j_fwd = jp.default_forward(jparams, jobs, jnp.asarray(acts))
    for k in ("logprobs", "entropy"):
        _close(t_fwd[k], j_fwd[k], k)
    for det in (True, False):
        key = jax.random.PRNGKey(2)
        ja, jlp = jp.sample_action(jparams, key, jobs, deterministic=det)
        noise = torch.as_tensor(np.array(jax.random.normal(key, (16, 2), jnp.float32)))
        ta, tlp = tp.sample_action(tparams, None, tobs, deterministic=det, noise=noise)
        _close(ta, ja, f"action det={det}")
        _close(tlp, jlp, f"logprob det={det}")
    for target in (False, True):
        for got, want in zip(tp.q_values(tparams, tobs, torch.as_tensor(acts), target=target),
                             jp.q_values(jparams, jobs, jnp.asarray(acts), target=target)):
            _close(got, want, f"q target={target}")
    out = tp.predict_action_batch(tparams, torch.Generator().manual_seed(3), tobs)
    assert out.values is None and float(out.actions.abs().max()) <= 1.0
    j_lp = jp.default_forward(jparams, jobs, jnp.asarray(_np(out.actions)))["logprobs"]
    _close(out.logprobs, j_lp, "own samples' logprobs", atol=1e-3, rtol=1e-3)


def _sac_batch(N=32, seed=0):
    r = np.random.default_rng(seed)
    return {
        "obs/states": r.normal(size=(N, 3)).astype(np.float32),
        "next_obs/states": r.normal(size=(N, 3)).astype(np.float32),
        "actions": np.tanh(r.normal(size=(N, 2))).astype(np.float32),
        "rewards": r.normal(size=(N,)).astype(np.float32),
        "dones": (r.uniform(size=(N,)) < 0.25).astype(np.float32),
    }


def _jax_step_noise(key, shape):
    """The two N(0, 1) draws of the JAX SAC step, as it splits its key."""
    rng, k_next = jax.random.split(key)
    rng, k_act = jax.random.split(rng)
    return tuple(torch.as_tensor(np.array(jax.random.normal(k, shape, jnp.float32)))
                 for k in (k_next, k_act))


@pytest.mark.parametrize("learn_alpha", [True, False], ids=["learn_alpha", "fixed_alpha"])
def test_sac_train_step_matches_jax(learn_alpha):
    """Two SAC steps on JAX's noise from one init: every param (live,
    Polyak targets at tau 0.01, log_alpha) within 1e-5 and every metric
    within 1e-5 relative (1e-6 absolute) of JAX's; the critics and the
    targets moved."""
    tp, jp, tparams, jparams = _sac_pair()
    sac = dict(tau=0.01, gamma=0.9, learn_alpha=learn_alpha)
    jtx = JS.make_optimizer(JS.OptimizerConfig(**OPT))
    jstate = JS.create_train_state(lambda rng: jparams, jtx, jax.random.PRNGKey(0))
    jstep = jsac_learner.make_sac_train_step(jp, jsac_learner.SACConfig(**sac), jtx)
    ttx = TS.make_optimizer(TS.OptimizerConfig(**OPT))
    tstate = TS.create_train_state(lambda: tparams, ttx)
    tstep = make_sac_train_step(tp, SACConfig(**sac), ttx, device="cpu")
    before = [_np(tstate.params[k][0]["w"]).copy() for k in ("q1", "q1_target")]
    for i in range(2):
        batch = _sac_batch(seed=i)
        key = jax.random.PRNGKey(10 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        tstate, tm = tstep(tstate, batch, None, noise=_jax_step_noise(key, (32, 2)))
        assert sorted(tm) == sorted(jm)
        for k in jm:
            _close(tm[k], jm[k], k, rtol=1e-5, atol=1e-6)
    _close_tree(tstate.params, jstate.params, "params")
    for k, w0 in zip(("q1", "q1_target"), before):
        assert np.abs(_np(tstate.params[k][0]["w"]) - w0).max() > 0, k


# ---------------------------------------------------------------------------
# the async runners
# ---------------------------------------------------------------------------

def test_async_sac_learns_bandit():
    """The async actor-learner drives the 1-step bandit reward toward 0
    (JAX's test: > -0.1 for the deterministic policy on 256 envs)."""
    policy = MLPSACPolicy(obs_dim=2, action_dim=2, hidden_sizes=(64, 64))
    runner = AsyncEmbodiedRunner(
        AsyncRunnerConfig(total_train_steps=450, rollout_chunk_steps=4, train_batch_size=128,
                          warmup_transitions=256, weight_sync_interval=5,
                          updates_per_chunk=4.0, replay_capacity=200, seed=0,
                          log_interval=100),
        envs=[BanditEnv(num_envs=32, seed=0)], policy=policy,
        sac=SACConfig(gamma=0.0, learn_alpha=True), device="cpu")
    runner.run()
    assert runner.param_version > 0
    assert runner.buffer.total_transitions > 0
    out = runner.evaluate(BanditEnv(num_envs=64, seed=123), num_steps=4)
    assert isinstance(out, dict)
    obs = BanditEnv(num_envs=256, seed=7).reset()
    a = _np(policy.predict_action_batch(runner.state.params, None,
                                        {"states": torch.as_tensor(obs["states"])},
                                        deterministic=True).actions)
    reward = -np.sum((a - obs["states"]) ** 2, axis=-1).mean()
    assert reward > -0.1, f"SAC failed to learn bandit: {reward:.4f}"


def _ppo_runner(steps=40, seed=0):
    return tppo.AsyncPPORunner(
        tppo.AsyncPPOConfig(total_train_steps=steps, rollout_chunk_steps=16, num_epochs=2,
                            num_mini_batches=4, gamma=0.9, weight_sync_interval=1, seed=seed,
                            log_interval=20),
        envs=[PointReachEnv(num_envs=64, seed=0, max_episode_steps=16)],
        policy=MLPGaussianPolicy(obs_dim=4, action_dim=2, init_logstd=-0.5),
        optimizer=TS.OptimizerConfig(lr=3e-3, clip_grad=1.0), device="cpu")


def test_async_ppo_learns_point_reach():
    """Async decoupled PPO raises success_once (JAX's bar: the last 5
    steps' mean above max(2 x the first 5's, 0.3)) with a version lag of
    at least 1 after the first step."""
    hist = _ppo_runner().run(max_steps=40)
    early = np.mean([h.get("env/success_once", 0.0) for h in hist[:5]])
    late = np.mean([h.get("env/success_once", 0.0) for h in hist[-5:]])
    assert late > max(2 * early, 0.3), f"async PPO: {early:.3f} -> {late:.3f}"
    assert all(h["async/version_lag"] >= 1.0 for h in hist[1:])


def test_async_ppo_batch_and_step_match_jax():
    """One trajectory through both runners' ``_chunk_to_batch`` (GAE,
    versions; 1e-5) and one decoupled-PPO step of each on that batch from
    one init at version lag 2: the loss, every metric (1e-5 relative,
    1e-6 absolute) and the params (1e-5)."""
    cfg = dict(total_train_steps=1, rollout_chunk_steps=4, gamma=0.9, seed=0)
    mk = dict(obs_dim=4, action_dim=2, init_logstd=-0.5)
    tpol, jpol = MLPGaussianPolicy(**mk), jmlp.MLPGaussianPolicy(**mk)
    tparams, jparams = _shared_params(tpol, jpol, 4)
    jr = jppo.AsyncPPORunner(jppo.AsyncPPOConfig(**cfg),
                             [jtoy.PointReachEnv(num_envs=8, seed=0)], jpol,
                             optimizer=JS.OptimizerConfig(**OPT))
    tr = tppo.AsyncPPORunner(tppo.AsyncPPOConfig(**cfg), [PointReachEnv(num_envs=8, seed=0)],
                             tpol, optimizer=TS.OptimizerConfig(**OPT), device="cpu")
    jr.state = JS.create_train_state(lambda rng: jparams, jr.tx, jax.random.PRNGKey(0))
    tr.state = TS.create_train_state(lambda: tparams, tr.tx)
    traj = tr.loop.interact(tparams, torch.Generator().manual_seed(0), 4)
    jb = jr._chunk_to_batch(traj, 1)
    tb = tr._chunk_to_batch(traj, 1)
    assert sorted(tb) == sorted(jb)
    for k in jb:
        _close(tb[k], jb[k], k)
    jr.state, jm = jr.train_step(jr.state, jb, 3.0)
    tr.state, tm = tr.train_step(tr.state, tb, 3.0)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        _close(tm[k], jm[k], k, rtol=1e-5, atol=1e-6)
    _close_tree(tr.state.params, jr.state.params, "params")


def _chip_smoke():
    """chip_smoke.py as a module: the snapshot recorder it runs on the card."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.parametrize("kind", ["sac", "ppo"])
def test_rollout_thread_acts_on_published_snapshots(kind):
    """Every chunk the rollout thread produced was made from a tree equal,
    bitwise, before and after its env loop ran, to the one published at the
    chunk's version stamp, while the learner updated its own params in
    place; chunks of several versions were seen."""
    if kind == "sac":
        runner = AsyncEmbodiedRunner(
            AsyncRunnerConfig(total_train_steps=40, rollout_chunk_steps=4, train_batch_size=64,
                              warmup_transitions=128, weight_sync_interval=2,
                              updates_per_chunk=4.0, replay_capacity=50, seed=1,
                              log_interval=100),
            envs=[BanditEnv(num_envs=16, seed=1)],
            policy=MLPSACPolicy(obs_dim=2, action_dim=2, hidden_sizes=(16, 16)),
            device="cpu")
        stamp = lambda chunk: int(chunk["versions"][0])
    else:
        runner = _ppo_runner(steps=8, seed=1)
        stamp = lambda item: item[1]
    cs = _chip_smoke()
    published, used = cs.snapshot_recorder(runner, stamp)
    runner.run()
    report = cs.snapshot_report(published, used)
    assert report["ok"], report
    assert report["chunks_checked"] >= 2 and report["versions_seen"] >= 2, report
    live = torch.cat([t.flatten() for t in TS.tree_leaves(runner.state.params)])
    assert not torch.equal(live, published[0])


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_dead_rollout_thread_raises_in_the_learner():
    """An env that fails in the rollout thread stops the learner with
    "rollout thread died", its exception the cause."""
    env = BanditEnv(num_envs=8, seed=0)

    def broken(actions):
        raise ValueError("env failure")

    env.step = broken
    runner = AsyncEmbodiedRunner(
        AsyncRunnerConfig(total_train_steps=5, warmup_transitions=64, seed=0),
        envs=[env], policy=MLPSACPolicy(obs_dim=2, action_dim=2, hidden_sizes=(8,)),
        device="cpu")
    with pytest.raises(RuntimeError, match="rollout thread died") as e:
        runner.run()
    assert isinstance(e.value.__cause__, ValueError)


def test_main_sac_async_runs_on_the_cpu(tmp_path):
    """``main_sac_async.main`` at a small size: the learner's metrics are
    finite, its eval is keyed eval/..., and it logs to its log_dir; without
    a card the default device raises."""
    from rlinf_tpu_torch import main_sac_async

    res = main_sac_async.main(
        "cpu", env="point_reach", num_envs=8, steps=12, log_dir=str(tmp_path),
        runner_cfg=AsyncRunnerConfig(rollout_chunk_steps=4, train_batch_size=32,
                                     warmup_transitions=64, weight_sync_interval=4,
                                     log_interval=6),
        policy_kw=dict(hidden_sizes=(16, 16)))
    assert res["runner"].global_step == 12
    assert all(np.isfinite(v) for v in res["metrics"].values())
    assert res["eval"] and all(k.startswith("eval/") for k in res["eval"])
    assert (tmp_path / "metrics.jsonl").exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main_sac_async.main(steps=1, log_dir=None)
