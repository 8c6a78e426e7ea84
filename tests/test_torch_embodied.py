"""The port's embodied PPO stack against the JAX package's, on the CPU at
the JAX tests' sizes (``tests/test_e2e_embodied.py``, ``tests/test_eval_runners.py``,
``tests/test_wrappers_and_dynamic_grpo.py``): the env registry and the toy
envs, the wrappers and the replay buffer, the CNN policy, the stage
pipelined ``EnvLoop``, one embodied train step, one runner step (with and
without the OPD teacher term), checkpoint resume, the episodic eval, the
learning checks and ``main_embodied_ppo``.

One init (the port's, its tree held to the shapes and dtypes of JAX's
init by ``jax.eval_shape``) feeds both packages, the port's side through
``policy.params_from_numpy``.
The envs are numpy in both packages, so seeded envs agree bit for bit. The
policies are f32 on both sides and agree to summation-order rounding; each
test states its tolerance. Sampled draws differ (threefry against a torch
``Generator``), so sampled actions are held by their logprob under the
other package's ``default_forward``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlinf_tpu.data import replay_buffer as jreplay
from rlinf_tpu.envs import get_env_cls as jget_env_cls
from rlinf_tpu.envs import toy as jtoy
from rlinf_tpu.envs import wrappers as jwrappers
from rlinf_tpu.models.embodiment import CNNGaussianPolicy as JCNN
from rlinf_tpu.models.embodiment import MLPGaussianPolicy as JMLP
from rlinf_tpu.rollout.env_loop import EnvLoop as JEnvLoop
from rlinf_tpu.runners import embodied_runner as jrunner_mod
from rlinf_tpu.runners.eval_runner import evaluate_embodied_episodes as jevaluate
from rlinf_tpu.training import embodied_learner as jlearner
from rlinf_tpu.training.train_state import OptimizerConfig as JOptConfig
from rlinf_tpu.training.train_state import create_train_state as jcreate_train_state
from rlinf_tpu.training.train_state import make_optimizer as jmake_optimizer
from rlinf_tpu_torch import main_embodied_ppo
from rlinf_tpu_torch.data import replay_buffer as treplay
from rlinf_tpu_torch.envs import get_env_cls
from rlinf_tpu_torch.envs import toy as ttoy
from rlinf_tpu_torch.envs import wrappers as twrappers
from rlinf_tpu_torch.models.embodiment import CNNGaussianPolicy, MLPGaussianPolicy
from rlinf_tpu_torch.rollout.env_loop import EnvLoop
from rlinf_tpu_torch.runners.embodied_runner import EmbodiedRunner, EmbodiedRunnerConfig
from rlinf_tpu_torch.runners.eval_runner import evaluate_embodied_episodes
from rlinf_tpu_torch.training.embodied_learner import (
    EmbodiedLossConfig,
    make_embodied_train_step,
)
from rlinf_tpu_torch.training.train_state import (
    OptimizerConfig,
    create_train_state,
    make_optimizer,
)
from rlinf_tpu_torch.utils.checkpoint import flatten

torch.set_num_threads(2)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _assert_trees_close(got, want, **tol):
    fg, fw = flatten(got), flatten(_numpy_tree(want))
    assert fg.keys() == fw.keys()
    for k in fg:
        np.testing.assert_allclose(_np(fg[k]), _np(fw[k]), err_msg=k, **tol)


def _shared_params(tp, jp, seed, noise=0.0):
    """(the port's params, JAX's params as numpy): ``tp.init`` from ``seed``
    (plus N(0, ``noise``) on every leaf), after checking that its tree has
    the keys, shapes and dtypes of JAX's init."""
    base = jax.tree_util.tree_map(
        lambda a: a.numpy(), tp.init(torch.Generator().manual_seed(seed), device="cpu"))
    want = jax.eval_shape(jp.init, jax.random.PRNGKey(seed))
    desc = lambda t: jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)), t)
    assert desc(base) == desc(want)
    r = np.random.default_rng(seed)
    base = jax.tree_util.tree_map(
        lambda a: (a + r.normal(0, noise, a.shape)).astype(a.dtype) if noise else a, base)
    return tp.params_from_numpy(base, device="cpu"), base


def _jobs(obs):
    return {k: jnp.asarray(v) for k, v in obs.items()}


def _tobs(obs):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in obs.items()}


# ---------------------------------------------------------------------------
# envs, wrappers, replay buffer
# ---------------------------------------------------------------------------

def test_env_registry():
    assert get_env_cls("point_reach") is ttoy.PointReachEnv
    assert get_env_cls("image_reach") is ttoy.ImageReachEnv
    assert get_env_cls("bandit") is ttoy.BanditEnv
    # the JAX registry also holds whatever adapters another test imported in
    # this process: the messages share their form, each over its own names
    from rlinf_tpu.envs import _ENV_REGISTRY as jnames
    from rlinf_tpu_torch.envs import _ENV_REGISTRY as tnames

    for fn, names in ((get_env_cls, tnames), (jget_env_cls, jnames)):
        with pytest.raises(KeyError) as e:
            fn("nope")
        assert e.value.args[0] == f"Unknown env 'nope'; have {sorted(names)}"
    assert {"point_reach", "image_reach", "bandit"} <= set(jnames)


def test_point_reach_env_contract():
    """The JAX test's contract: every env ends an episode within
    max_episode_steps; auto-reset keeps the obs shape."""
    env = ttoy.PointReachEnv(num_envs=8, seed=0, max_episode_steps=5)
    obs = env.reset()
    assert obs["states"].shape == (8, 4)
    for _ in range(5):
        out = env.step(np.zeros((8, 2), np.float32))
    m = env.metrics()
    assert m["env/num_episodes"] >= 8
    assert out.obs["states"].shape == (8, 4)


def _env_pair(name, **kw):
    return getattr(ttoy, name)(**kw), getattr(jtoy, name)(**kw)


@pytest.mark.parametrize("name,kw", [
    ("PointReachEnv", dict(num_envs=6, seed=3, max_episode_steps=4)),
    ("ImageReachEnv", dict(num_envs=3, seed=1, size=36, max_episode_steps=3)),
    ("BanditEnv", dict(num_envs=5, seed=2, action_dim=3)),
])
def test_seeded_envs_match_bitwise(name, kw):
    """Seeded envs driven by the same actions give equal obs, rewards,
    dones, final obs and metrics, bit for bit."""
    t_env, j_env = _env_pair(name, **kw)
    a_dim = t_env.action_dim
    assert (t_env.obs_spec, a_dim, t_env.max_episode_steps) == (
        j_env.obs_spec, j_env.action_dim, j_env.max_episode_steps)
    to, jo = t_env.reset(), j_env.reset()
    for k in jo:
        np.testing.assert_array_equal(to[k], jo[k])
    rng = np.random.default_rng(0)
    for _ in range(7):
        a = rng.uniform(-1.2, 1.2, (t_env.num_envs, a_dim)).astype(np.float32)
        t_out, j_out = t_env.step(a), j_env.step(a)
        for f in ("reward", "done", "terminated"):
            np.testing.assert_array_equal(getattr(t_out, f), getattr(j_out, f), err_msg=f)
        for k in j_out.obs:
            np.testing.assert_array_equal(t_out.obs[k], j_out.obs[k], err_msg=k)
            np.testing.assert_array_equal(t_out.info["final_obs"][k],
                                          j_out.info["final_obs"][k], err_msg=k)
    assert t_env.metrics() == j_env.metrics()


def test_action_chunk_wrapper_matches_jax():
    """K chunk steps a wrapper step: summed rewards, OR'd dones, the last
    obs, the chunked action dim and episode length, as in the JAX package."""
    t_env = twrappers.ActionChunkWrapper(ttoy.PointReachEnv(4, seed=5, max_episode_steps=6), 3)
    j_env = jwrappers.ActionChunkWrapper(jtoy.PointReachEnv(4, seed=5, max_episode_steps=6), 3)
    assert (t_env.action_dim, t_env.inner_action_dim, t_env.max_episode_steps) == (6, 2, 2)
    np.testing.assert_array_equal(t_env.reset()["states"], j_env.reset()["states"])
    rng = np.random.default_rng(1)
    for _ in range(4):
        a = rng.uniform(-1, 1, (4, 6)).astype(np.float32)
        t_out, j_out = t_env.step(a), j_env.step(a)
        for f in ("reward", "done", "terminated"):
            np.testing.assert_array_equal(getattr(t_out, f), getattr(j_out, f), err_msg=f)
        np.testing.assert_array_equal(t_out.obs["states"], j_out.obs["states"])
    assert t_env.metrics() == j_env.metrics()


def test_collect_episodes_into_the_replay_buffer(tmp_path):
    """Both packages' CollectEpisodeWrapper write the same episodes; loaded
    into each package's ReplayBuffer they give the same items and the same
    seeded transition samples; the buffer persists and restores."""
    got = {}
    for tag, wr, toy, rb in (("t", twrappers, ttoy, treplay), ("j", jwrappers, jtoy, jreplay)):
        d = tmp_path / tag
        env = wr.CollectEpisodeWrapper(toy.PointReachEnv(num_envs=4, seed=0,
                                                         max_episode_steps=3), str(d))
        env.reset()
        for _ in range(7):
            env.step(np.random.default_rng(0).uniform(-1, 1, (4, 2)).astype(np.float32))
        m = env.metrics()
        assert m["collect/episodes_written"] >= 4
        buf = rb.ReplayBuffer(capacity=100, directory=str(tmp_path / f"{tag}_buf"), seed=3,
                              flush_async=False)
        n = wr.CollectEpisodeWrapper.load_episodes_to_buffer(str(d), buf)
        assert n == int(m["collect/episodes_written"])
        buf.flush()
        got[tag] = (sorted(p.name for p in d.iterdir()), buf.sample_transitions(8),
                    [it.data for it in buf.sample(3)], rb.ReplayBuffer.restore(
                        str(tmp_path / f"{tag}_buf"), seed=3).sample_transitions(5))
    (tn, tb, ti, tr), (jn, jb, ji, jr) = got["t"], got["j"]
    assert tn == jn
    assert tb["obs/states"].shape == (8, 4) and tb["next_obs/states"].shape == (8, 4)
    assert tb["actions"].shape == (8, 2)
    for a, b in ((tb, jb), (tr, jr), *zip(ti, ji)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_record_video_wrapper_writes_env0_episodes(tmp_path):
    """Env 0's frames are written once an episode every ``record_every``,
    up to ``max_videos``, in both packages alike."""
    got = []
    for tag, wr, toy in (("t", twrappers, ttoy), ("j", jwrappers, jtoy)):
        d = tmp_path / tag
        env = wr.RecordVideoWrapper(toy.ImageReachEnv(num_envs=2, seed=0, size=16,
                                                      max_episode_steps=3),
                                    str(d), record_every=2, max_videos=2)
        env.reset()
        for _ in range(12):
            env.step(np.zeros((2, 2), np.float32))
        got.append((env.metrics()["video/videos_written"],
                    sorted(p.stem for p in d.iterdir())))
    assert got[0] == got[1]
    assert got[0][0] == 2.0 and got[0][1] == ["episode_000000", "episode_000002"]


# ---------------------------------------------------------------------------
# the CNN policy
# ---------------------------------------------------------------------------

def _cnn_pair(seed=0):
    kw = dict(image_shape=(36, 36, 3), action_dim=4, proprio_dim=5, hidden_size=32,
              init_logstd=-0.3)
    jp, tp = JCNN(**kw), CNNGaussianPolicy(**kw)
    # noise on every leaf so the zero biases and the head scales are exercised
    tparams, jparams = _shared_params(tp, jp, seed, noise=0.05)
    return tp, tparams, jp, jax.tree_util.tree_map(jnp.asarray, jparams)


def _cnn_obs(B=3, uint8=True, seed=0):
    r = np.random.default_rng(seed)
    img = r.integers(0, 256, (B, 36, 36, 3)).astype(np.uint8)
    return {"images": img if uint8 else img.astype(np.float32) / 255.0,
            "states": r.normal(size=(B, 5)).astype(np.float32)}


def test_cnn_policy_shapes_and_init():
    """The JAX test's shapes; the init's tree matches the JAX package's
    leaf for leaf in shape and dtype; too small an image is refused."""
    tp = CNNGaussianPolicy(image_shape=(36, 36, 3), action_dim=4, proprio_dim=5)
    params, _ = _shared_params(tp, JCNN(image_shape=(36, 36, 3), action_dim=4, proprio_dim=5),
                               0)
    obs = {"images": torch.zeros((2, 36, 36, 3), dtype=torch.uint8),
           "states": torch.zeros((2, 5))}
    out = tp.predict_action_batch(params, torch.Generator().manual_seed(1), obs)
    assert out.actions.shape == (2, 4) and out.values.shape == (2,)
    with pytest.raises(ValueError, match="minimum input is 36x36"):
        CNNGaussianPolicy(image_shape=(32, 32, 3), action_dim=2)


@pytest.mark.parametrize("uint8", [True, False])
def test_cnn_policy_matches_jax(uint8):
    """default_forward, value and the deterministic action against JAX's
    (f32, rtol 1e-4 / atol 1e-5); sampled actions' logprobs against JAX's
    default_forward on them (atol 1e-4)."""
    tp, tparams, jp, jparams = _cnn_pair()
    obs = _cnn_obs(uint8=uint8)
    actions = np.random.default_rng(4).normal(size=(3, 4)).astype(np.float32)
    t_fwd = tp.default_forward(tparams, _tobs(obs), torch.as_tensor(actions))
    j_fwd = jp.default_forward(jparams, _jobs(obs), jnp.asarray(actions))
    for k in ("logprobs", "entropy", "values"):
        np.testing.assert_allclose(_np(t_fwd[k]), _np(j_fwd[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(_np(tp.value(tparams, _tobs(obs))),
                               _np(jp.value(jparams, _jobs(obs))), rtol=1e-4, atol=1e-5)
    t_det = tp.predict_action_batch(tparams, None, _tobs(obs), deterministic=True)
    j_det = jp.predict_action_batch(jparams, jax.random.PRNGKey(0), _jobs(obs),
                                    deterministic=True)
    for f in ("actions", "logprobs", "values"):
        np.testing.assert_allclose(_np(getattr(t_det, f)), _np(getattr(j_det, f)),
                                   rtol=1e-4, atol=1e-5, err_msg=f)
    t_s = tp.predict_action_batch(tparams, torch.Generator().manual_seed(2), _tobs(obs))
    j_lp = jp.default_forward(jparams, _jobs(obs), jnp.asarray(_np(t_s.actions)))["logprobs"]
    np.testing.assert_allclose(_np(t_s.logprobs), _np(j_lp), atol=1e-4)
    assert not np.allclose(_np(t_s.actions), _np(t_det.actions))


# ---------------------------------------------------------------------------
# the env loop
# ---------------------------------------------------------------------------

def _mlp_pair(seed=0, obs_dim=4, action_dim=2, **kw):
    jp = JMLP(obs_dim=obs_dim, action_dim=action_dim, **kw)
    tp = MLPGaussianPolicy(obs_dim=obs_dim, action_dim=action_dim, **kw)
    tparams, jparams = _shared_params(tp, jp, seed)
    return tp, tparams, jp, jparams


def _assert_trajectories_close(t, j, tol):
    assert t.obs.keys() == j.obs.keys()
    for k in j.obs:
        np.testing.assert_allclose(t.obs[k], j.obs[k], err_msg=f"obs/{k}", **tol)
    for f in ("actions", "rewards", "values", "logprobs"):
        np.testing.assert_allclose(getattr(t, f), getattr(j, f), err_msg=f, **tol)
        assert getattr(t, f).dtype == getattr(j, f).dtype, f
    np.testing.assert_array_equal(t.dones, j.dones)


def test_env_loop_two_stages_deterministic_matches_jax():
    """Two stages of PointReach under the deterministic MLP policy, two
    interact calls (the second starts from the first's last obs and done):
    the merged trajectory equals JAX's field by field (dones exactly, the
    rest within atol 1e-5), and so do the env metrics."""
    tp, tparams, jp, jparams = _mlp_pair(init_logstd=-0.5)
    jparams = jax.tree_util.tree_map(jnp.asarray, jparams)
    mk = lambda toy: [toy.PointReachEnv(5, seed=s, max_episode_steps=4) for s in (0, 1)]
    t_loop, j_loop = EnvLoop(mk(ttoy), tp, device="cpu"), JEnvLoop(mk(jtoy), jp)
    for _ in range(2):
        t = t_loop.interact(tparams, torch.Generator().manual_seed(0), 6, deterministic=True)
        j = j_loop.interact(jparams, jax.random.PRNGKey(0), 6, deterministic=True)
        assert t.actions.shape == (6, 10, 2) and t.dones.shape == (7, 10)
        _assert_trajectories_close(t, j, dict(atol=1e-5, rtol=0))
        tf, jf = t.flatten(), j.flatten()
        assert tf.keys() == jf.keys()
    assert t_loop.env_metrics() == pytest.approx(j_loop.env_metrics(), abs=1e-5)
    assert t_loop.num_envs == 10


def test_env_loop_sampled_logprobs_hold_under_jax():
    """A sampled interact: each step's actions are drawn from the port's
    generator; their recorded logprobs equal JAX's default_forward of the
    recorded obs and actions, and the values its value (atol 1e-5)."""
    tp, tparams, jp, jparams = _mlp_pair(seed=2, init_logstd=-0.5)
    loop = EnvLoop([ttoy.PointReachEnv(4, seed=s) for s in (3, 4)], tp, device="cpu")
    traj = loop.interact(tparams, torch.Generator().manual_seed(5), 5)
    flat = traj.flatten()
    fwd = jp.default_forward(jparams, {"states": jnp.asarray(flat["obs/states"])},
                             jnp.asarray(flat["actions"]))
    np.testing.assert_allclose(flat["logprobs"], _np(fwd["logprobs"]), atol=1e-5)
    np.testing.assert_allclose(flat["values"], _np(fwd["values"]), atol=1e-5)
    again = EnvLoop([ttoy.PointReachEnv(4, seed=s) for s in (3, 4)], tp, device="cpu")
    np.testing.assert_array_equal(
        again.interact(tparams, torch.Generator().manual_seed(5), 5).actions, traj.actions)


# ---------------------------------------------------------------------------
# the learner
# ---------------------------------------------------------------------------

def _rl_batch(N=16, obs_dim=4, A=2, seed=0, sft=False):
    r = np.random.default_rng(seed)
    b = {
        "obs/states": r.normal(size=(N, obs_dim)).astype(np.float32),
        "actions": r.normal(size=(N, A)).astype(np.float32),
        "old_logprobs": r.normal(-1.0, 0.3, (N, A)).astype(np.float32),
        "advantages": r.normal(size=(N,)).astype(np.float32),
        "returns": r.normal(size=(N,)).astype(np.float32),
        "prev_values": r.normal(size=(N,)).astype(np.float32),
    }
    if sft:
        b["sft_obs/states"] = r.normal(size=(N // 2, obs_dim)).astype(np.float32)
        b["sft_actions"] = r.normal(size=(N // 2, A)).astype(np.float32)
    return b


@pytest.mark.parametrize("sft_coef", [0.0, 0.5])
def test_embodied_train_step_matches_jax(sft_coef):
    """Two embodied train steps (entropy bonus, dual clip, value clip, and
    with ``sft_coef`` the BC mix on demo rows) from the same params on the
    same batches: params within 1e-5 and metrics within rtol 1e-4 of JAX's."""
    tp, tparams, jp, jparams = _mlp_pair(seed=1, init_logstd=-0.5)
    loss = dict(entropy_bonus=0.01, clip_ratio_c=3.0, value_clip=0.1, huber_delta=1.0,
                sft_coef=sft_coef)
    opt = dict(lr=3e-3, clip_grad=0.5)
    ttx, jtx = make_optimizer(OptimizerConfig(**opt)), jmake_optimizer(JOptConfig(**opt))
    t_step = make_embodied_train_step(tp, EmbodiedLossConfig(**loss), ttx, device="cpu")
    j_step = jlearner.make_embodied_train_step(jp, jlearner.EmbodiedLossConfig(**loss), jtx)
    t_state = create_train_state(lambda: tparams, ttx)
    j_state = jcreate_train_state(lambda _: jax.tree_util.tree_map(jnp.asarray, jparams),
                                  jtx, jax.random.PRNGKey(0))
    for i in range(2):
        batch = _rl_batch(seed=i, sft=sft_coef > 0)
        t_state, t_m = t_step(t_state, batch)
        j_state, j_m = j_step(j_state, {k: jnp.asarray(v) for k, v in batch.items()})
        assert t_m.keys() == j_m.keys()
        assert ("actor/sft_nll" in t_m) == (sft_coef > 0)
        for k in j_m:
            np.testing.assert_allclose(float(t_m[k]), float(j_m[k]), rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    assert t_state.step == 2
    _assert_trees_close(t_state.params, j_state.params, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

class _AnalyticTeacher:
    """The JAX test's OPD teacher: mean = 0.7 * obs (its first action-dim
    entries), logstd -1, in torch or in JAX."""

    def __init__(self, torch_side):
        self.torch_side = torch_side

    def default_forward(self, params, obs, actions):
        from rlinf_tpu.models.embodiment import mlp_policy as jm
        from rlinf_tpu_torch.models.embodiment import mlp_policy as tm

        if self.torch_side:
            mean = 0.7 * obs["states"][:, :actions.shape[-1]].float()
            logstd = torch.full_like(mean, -1.0)
            return {"logprobs": tm.gaussian_logprob(mean, logstd, actions)}
        mean = 0.7 * obs["states"][:, :actions.shape[-1]].astype(jnp.float32)
        logstd = jnp.full_like(mean, -1.0)
        return {"logprobs": jm.gaussian_logprob(mean, logstd, actions)}


@pytest.mark.parametrize("opd", [False, True])
def test_runner_step_matches_jax(opd, monkeypatch):
    """One EmbodiedRunner.run_step of each package from the same params, on
    the same trajectory (a sampled JAX interact of 2 stages, handed to both
    runners' loops) and the same minibatch permutations (JAX's, handed to
    the port's ``torch.randperm``): GAE, the OPD reverse-KL term, 2 epochs
    x 2 minibatches. Params within 1e-5 and the step's metrics within rtol
    1e-4 of JAX's."""
    tp, tparams, jp, jparams = _mlp_pair(seed=3, init_logstd=-0.5)
    cfg = dict(num_chunk_steps=6, num_epochs=2, num_mini_batches=2, gamma=0.9,
               gae_lambda=0.95, max_steps=1, seed=0)
    opt = dict(lr=3e-3, clip_grad=1.0)
    extra_j = dict(teacher=(_AnalyticTeacher(False), {}), opd_coef=0.5) if opd else {}
    extra_t = dict(teacher=(_AnalyticTeacher(True), {}), opd_coef=0.5) if opd else {}
    mk = lambda toy: [toy.PointReachEnv(4, seed=s, max_episode_steps=4) for s in (0, 1)]
    jr = jrunner_mod.EmbodiedRunner(jrunner_mod.EmbodiedRunnerConfig(**cfg), mk(jtoy), jp,
                                    optimizer=JOptConfig(**opt), **extra_j)
    jr.state = jr.state._replace(params=jax.tree_util.tree_map(jnp.asarray, jparams))
    tr = EmbodiedRunner(EmbodiedRunnerConfig(**cfg), mk(ttoy), tp,
                        optimizer=OptimizerConfig(**opt), device="cpu", **extra_t)
    tr.state = create_train_state(lambda: tparams, tr.tx)

    traj = JEnvLoop(mk(jtoy), jp).interact(jr.state.params, jax.random.PRNGKey(9), 6)
    monkeypatch.setattr(jr.loop, "interact", lambda *a, **k: traj)
    monkeypatch.setattr(tr.loop, "interact", lambda *a, **k: traj)
    perms, jperm = [], jax.random.permutation

    def recording(key, n):
        p = jperm(key, n)
        perms.append(np.asarray(p))
        return p

    monkeypatch.setattr(jax.random, "permutation", recording)
    j_out = jr.run_step()
    assert len(perms) == 2
    handed = list(perms)
    monkeypatch.setattr(torch, "randperm",
                        lambda n, generator=None: torch.from_numpy(handed.pop(0).copy()))
    t_out = tr.run_step()
    assert not handed
    keys = {k for k in j_out if not k.startswith(("time/", "perf/"))}
    assert keys == {k for k in t_out if not k.startswith(("time/", "perf/"))}
    for k in sorted(keys):
        np.testing.assert_allclose(t_out[k], j_out[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert {"time/rollout", "time/training", "time/step", "perf/env_steps_per_s"} <= set(t_out)
    _assert_trees_close(tr.state.params, jr.state.params, atol=1e-5, rtol=0)


def test_runner_checkpoint_resume(tmp_path):
    """Saved every step, a new runner on the same directory resumes at the
    last step with the params and optimizer state bit for bit, and goes on
    from there."""
    tp = MLPGaussianPolicy(obs_dim=4, action_dim=2, init_logstd=-0.5)
    cfg = EmbodiedRunnerConfig(num_chunk_steps=4, num_epochs=1, num_mini_batches=2,
                               max_steps=2, checkpoint_dir=str(tmp_path), save_interval=1)
    envs = lambda: [ttoy.PointReachEnv(8, seed=0, max_episode_steps=4)]
    r1 = EmbodiedRunner(cfg, envs(), tp, device="cpu")
    hist = r1.run()
    assert len(hist) == 2 and r1.global_step == 2
    r2 = EmbodiedRunner(cfg, envs(), tp, device="cpu")
    assert r2.global_step == 2 and r2.state.step == r1.state.step == 4  # 2 minibatches a step
    a, b = flatten(r2.state), flatten(r1.state)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k
    assert r2.run(max_steps=3)[0]["rollout/env_steps"] == 32.0


def test_runner_eval_is_deterministic():
    """``eval_interval`` runs a deterministic eval epoch on the eval envs
    (the JAX test's setting); two runners from one seed report equal eval
    metrics."""
    outs = []
    for _ in range(2):
        cfg = EmbodiedRunnerConfig(num_chunk_steps=4, num_epochs=1, num_mini_batches=1,
                                   max_steps=1, eval_interval=1, eval_steps=8)
        r = EmbodiedRunner(cfg, [ttoy.PointReachEnv(num_envs=16, seed=0)],
                           MLPGaussianPolicy(obs_dim=4, action_dim=2),
                           eval_envs=[ttoy.PointReachEnv(num_envs=16, seed=100,
                                                         max_episode_steps=4)],
                           device="cpu")
        out = r.run_step()
        outs.append({k: v for k, v in out.items() if k.startswith("eval/")})
    assert outs[0] and outs[0] == outs[1]


def test_evaluate_embodied_episodes_matches_jax():
    """The JAX test's episodic eval (MLP, 8 PointReach envs, 64 steps) on
    the same params: every metric equal to JAX's within 1e-5."""
    tp, tparams, jp, jparams = _mlp_pair(seed=0)
    t = evaluate_embodied_episodes([ttoy.PointReachEnv(num_envs=8, seed=0)], tp, tparams,
                                   num_steps=64, seed=0, device="cpu")
    j = jevaluate([jtoy.PointReachEnv(num_envs=8, seed=0)], jp,
                  jax.tree_util.tree_map(jnp.asarray, jparams), num_steps=64, seed=0)
    assert t["episodes"] > 0 and t["episode_len_mean"] > 0
    assert t.keys() == j.keys()
    assert t == pytest.approx(j, abs=1e-5)


# ---------------------------------------------------------------------------
# learning checks (tests/test_e2e_embodied.py's, at their sizes)
# ---------------------------------------------------------------------------

def test_ppo_learns_bandit():
    cfg = EmbodiedRunnerConfig(num_chunk_steps=8, num_epochs=2, num_mini_batches=4,
                               gamma=0.99, gae_lambda=0.95, max_steps=40, seed=0)
    runner = EmbodiedRunner(cfg, [ttoy.BanditEnv(num_envs=64, seed=0)],
                            MLPGaussianPolicy(obs_dim=2, action_dim=2, init_logstd=-0.5),
                            optimizer=OptimizerConfig(lr=3e-3, clip_grad=1.0), device="cpu")
    hist = runner.run(max_steps=30)
    first = np.mean([h["rollout/reward_mean"] for h in hist[:3]])
    last = np.mean([h["rollout/reward_mean"] for h in hist[-3:]])
    assert last > first + 0.05, f"no learning {first:.4f} -> {last:.4f}"
    assert last > -0.4, f"final reward too low: {last:.4f}"


def test_ppo_learns_point_reach_and_success_rises():
    cfg = EmbodiedRunnerConfig(num_chunk_steps=16, num_epochs=2, num_mini_batches=4,
                               gamma=0.9, gae_lambda=0.95, max_steps=40, seed=0)
    runner = EmbodiedRunner(cfg, [ttoy.PointReachEnv(num_envs=64, seed=0,
                                                     max_episode_steps=16)],
                            MLPGaussianPolicy(obs_dim=4, action_dim=2, init_logstd=-0.5),
                            optimizer=OptimizerConfig(lr=3e-3, clip_grad=1.0), device="cpu")
    hist = runner.run(max_steps=40)
    early = np.mean([h.get("env/success_once", 0.0) for h in hist[:5]])
    late = np.mean([h.get("env/success_once", 0.0) for h in hist[-5:]])
    assert late > max(2 * early, 0.3), f"success_once {early:.3f} -> {late:.3f}"


def test_opd_distillation_pulls_student_to_teacher():
    """The JAX test's OPD check: zero env reward, the reverse-KL advantage
    pulls the student's deterministic actions toward the teacher's."""

    class ZeroRewardBandit(ttoy.BanditEnv):
        def step(self, actions):
            out = super().step(actions)
            out.reward[:] = 0.0
            return out

    student = MLPGaussianPolicy(obs_dim=2, action_dim=2, init_logstd=-0.5)
    cfg = EmbodiedRunnerConfig(num_chunk_steps=8, num_epochs=2, num_mini_batches=2,
                               gamma=0.0, normalize_advantages=False, max_steps=40, seed=1)
    runner = EmbodiedRunner(cfg, [ZeroRewardBandit(num_envs=64, seed=0)], student,
                            optimizer=OptimizerConfig(lr=3e-3, clip_grad=1.0),
                            teacher=(_AnalyticTeacher(True), {}), opd_coef=1.0, device="cpu")
    obs = {"states": torch.as_tensor(np.random.default_rng(3).normal(size=(64, 2)),
                                     dtype=torch.float32)}

    def gap():
        s_act = student.predict_action_batch(runner.state.params, None, obs,
                                             deterministic=True).actions
        return float((0.7 * obs["states"] - s_act).abs().mean())

    before = gap()
    runner.run(max_steps=30)
    after = gap()
    assert after < before * 0.7, f"OPD did not distill: {before:.3f} -> {after:.3f}"


def test_main_embodied_ppo_on_the_cpu(tmp_path):
    """The entry point at the example's settings but 64 envs and 2 steps:
    both stages feed the rollout, metrics are logged."""
    res = main_embodied_ppo.main("cpu", num_envs=64, stages=2, steps=2, log_dir=str(tmp_path))
    hist, runner = res["history"], res["runner"]
    assert len(hist) == 2 and len(runner.loop.envs) == 2
    assert hist[-1]["rollout/env_steps"] == 32 * 64
    assert all(np.isfinite(h["actor/loss"]) for h in hist)
    assert (tmp_path / "metrics.jsonl").exists()
    args = main_embodied_ppo.parse_args([])
    assert (args.device, args.num_envs, args.stages, args.steps) == ("cuda", 256, 2, 200)


# ---------------------------------------------------------------------------
# the port's rules on the new modules
# ---------------------------------------------------------------------------

EMBODIED_MODULES = (
    "envs/__init__.py", "envs/base.py", "envs/toy.py", "envs/wrappers.py",
    "data/embodied_io_struct.py", "data/replay_buffer.py", "rollout/env_loop.py",
    "models/embodiment/cnn_policy.py", "models/embodiment/vla_policy.py",
    "models/embodiment/openvla.py", "training/embodied_learner.py",
    "runners/embodied_runner.py", "main_embodied_ppo.py")


@pytest.mark.parametrize("rel", EMBODIED_MODULES)
def test_embodied_modules_are_held_by_the_rules(rel):
    """Each module of the slice exists, is among the files the port's rules
    walk, imports no JAX, nothing of the JAX package and no HF package, and
    its public ``device`` parameters default to the card."""
    import test_torch_port_rules as rules

    path = rules.PORT / rel
    assert path in rules.FILES
    rules.test_no_jax_or_reference_imports(path)
    rules.test_no_hf_package_imports(path)
    rules.test_public_device_parameters_default_to_the_card(path)


def test_embodied_entry_points_take_the_card_by_default(monkeypatch):
    """Without a card, the entry point, the runner, the loop, the eval, the
    train step and the policies' inits and weight converters raise unless
    the caller asks for the CPU."""
    from rlinf_tpu_torch.models.embodiment.openvla import OpenVLAPolicy
    from rlinf_tpu_torch.models.embodiment.vla_policy import VLAPolicy

    assert main_embodied_ppo.parse_args([]).device == "cuda"
    assert main_embodied_ppo.parse_args(["--device", "cpu"]).device == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mlp = MLPGaussianPolicy(obs_dim=4, action_dim=2)
    env = lambda: [ttoy.PointReachEnv(2)]
    g = torch.Generator()
    calls = [
        lambda: main_embodied_ppo.main(num_envs=4, steps=1, log_dir=None),
        lambda: EmbodiedRunner(EmbodiedRunnerConfig(), env(), mlp),
        lambda: EnvLoop(env(), mlp),
        lambda: evaluate_embodied_episodes(env(), mlp, {}),
        lambda: make_embodied_train_step(mlp, EmbodiedLossConfig(), None),
        lambda: CNNGaussianPolicy((36, 36, 3), 2).init(g),
        lambda: VLAPolicy(image_size=32).init(g),
        lambda: OpenVLAPolicy().init(g),
        lambda: mlp.params_from_numpy({"w": np.zeros(2, np.float32)}),
        lambda: OpenVLAPolicy().params_from_numpy({"vlm": {}}),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
