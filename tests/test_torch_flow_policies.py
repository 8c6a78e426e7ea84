"""The port's flow families against the JAX package's, on the CPU at tiny
sizes: ``flow_utils`` on shared draws, ``FlowMatchingPolicy``,
``Pi0Policy`` (pi0 and pi0.5, with and without instruction tokens, padded
masks), ``GR00TPolicy`` (with and without text, 1 and 4 embodiments), the
RECAP and STEAM critics (``tests/test_value_critics.py``'s cases), one NFT
step for each loss form, the VLA checkpoint import (both tower namings, a
checkpoint written by the JAX package, a torch ``.bin``), ``get_model``
for every registered name and flow-SDE PPO learning point-reach
(``tests/test_vla_flow_policies.py``'s check).

One init (the port's, with N(0, 0.05) noise on every leaf; its tree held
to the shapes and dtypes of JAX's init by ``jax.eval_shape``) feeds both
packages. Draws differ (threefry against a torch ``Generator``): JAX's
draws are remade from its keys as its functions split them and handed to
the port (``x0``, ``t``, ``eps``, ``draws``), so that the values can be
held; the chain logprobs of the port's own samples are held under JAX's
recompute. Every JAX side runs under ``jax.jit`` (eager JAX costs seconds
a call), one function a case. Everything is f32; each test states its
tolerance.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlinf_tpu.models.embodiment import flow_policy as jflow
from rlinf_tpu.models.embodiment import flow_utils as jfu
from rlinf_tpu.models.embodiment import gr00t as jgr00t
from rlinf_tpu.models.embodiment import hf_import as jhf
from rlinf_tpu.models.embodiment import openpi as jpi
from rlinf_tpu.models.embodiment import openvla as jopenvla
from rlinf_tpu.models.embodiment import value_critic as jvc
from rlinf_tpu.models.embodiment import vit as jvit
from rlinf_tpu.models.llm.config import LLMConfig as JLLMConfig
from rlinf_tpu.training import nft_learner as jnft
from rlinf_tpu.training import train_state as JS
from rlinf_tpu_torch.models.embodiment import flow_policy as tflow
from rlinf_tpu_torch.models.embodiment import flow_utils as tfu
from rlinf_tpu_torch.models.embodiment import gr00t as tgr00t
from rlinf_tpu_torch.models.embodiment import hf_import as thf
from rlinf_tpu_torch.models.embodiment import openpi as tpi
from rlinf_tpu_torch.models.embodiment import openvla as topenvla
from rlinf_tpu_torch.models.embodiment import value_critic as tvc
from rlinf_tpu_torch.models.embodiment import vit as tvit
from rlinf_tpu_torch.models.llm.config import LLMConfig
from rlinf_tpu_torch.training import nft_learner as tnft
from rlinf_tpu_torch.training import train_state as TS

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _t(x):
    return torch.as_tensor(np.array(x))


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


def _flat(tree, prefix=""):
    """{path: leaf} of nested dicts and lists."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        return {p: leaf for k, v in items for p, leaf in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_sde_draws(key, shape, steps):
    k_init, k_steps = jax.random.split(key)
    x0 = jax.random.normal(k_init, shape, jnp.float32)
    eps = jnp.stack([jax.random.normal(k, shape, jnp.float32)
                     for k in jax.random.split(k_steps, steps)])
    return x0, eps


def _sde_draws(key, shape, steps):
    """(x0, eps [steps, *shape]) as ``flow_utils.sample_sde`` draws them
    (one compile a shape: eager draws compile an op each)."""
    return tuple(_t(a) for a in _jax_sde_draws(key, shape, steps))


# ---------------------------------------------------------------------------
# flow_utils
# ---------------------------------------------------------------------------

def _linear_velocity(w, b):
    """The same velocity field in both packages: tanh(x W + t b)."""
    jv = lambda x, t: jnp.tanh(x @ jnp.asarray(w) + t.reshape((-1,) + (1,) * (x.ndim - 1))
                               * jnp.asarray(b))
    tv = lambda x, t: torch.tanh(x @ _t(w) + t.reshape((-1,) + (1,) * (x.ndim - 1)) * _t(b))
    return jv, tv


def test_flow_utils_match_jax_on_shared_draws():
    """time_embed (5e-4: XLA's f32 exp); flow_matching_loss with and without a mask,
    sample_ode and sample_sde (chain, x1, per-step logprobs) on JAX's draws
    (1e-5); chain_logprobs of JAX's chain equal to JAX's recompute and to
    its sampled logprobs (1e-4); the port's own chain's logprobs held under
    JAX's recompute (1e-4); chain_entropy_like (1e-6); remat gives the same
    logprobs and gradients (1e-6)."""
    r = np.random.default_rng(0)
    B, K, A, S, sigma = 4, 3, 2, 5, 0.7
    w = r.normal(0, 0.5, (A, A)).astype(np.float32)
    b = r.normal(0, 0.5, (A,)).astype(np.float32)
    jv, tv = _linear_velocity(w, b)
    t = r.uniform(size=(B,)).astype(np.float32)
    target = r.normal(size=(B, K, A)).astype(np.float32)
    mask = (r.uniform(size=(B, K, 1)) < 0.7).astype(np.float32)
    key = jax.random.PRNGKey(1)
    shape = (B, K, A)
    own = tfu.sample_sde(tv, torch.Generator().manual_seed(2), shape, steps=S,
                         noise_scale=sigma, device="cpu")

    @jax.jit
    def jax_side(t, target, mask, own_chain):      # one compile
        chain = jfu.sample_sde(jv, key, shape, steps=S, noise_scale=sigma)
        lp = jfu.chain_logprobs(jv, chain.chain, noise_scale=sigma)
        return dict(
            embed=jfu.time_embed(t, 16),
            loss=[jfu.flow_matching_loss(jv, key, target, mask=m) for m in (None, mask)],
            ode=jfu.sample_ode(jv, key, shape, steps=S), chain=chain, lp=lp,
            own_lp=jfu.chain_logprobs(jv, own_chain, noise_scale=sigma),
            entropy=jfu.chain_entropy_like(lp, K * A, S, sigma))

    want = jax_side(jnp.asarray(t), jnp.asarray(target), jnp.asarray(mask),
                    jnp.asarray(_np(own.chain)))
    # XLA's f32 exp of the frequencies is off by up to 6 ulp (1.8e-4 at 373)
    # against torch's, which moves the angle t x freq by as much
    _close(tfu.time_embed(_t(t), 16), want["embed"], "time_embed", rtol=0, atol=5e-4)

    k_noise, k_t = jax.random.split(key)
    x0 = _t(jax.random.normal(k_noise, target.shape, jnp.float32))
    tt = _t(jax.random.uniform(k_t, (B,), jnp.float32))
    for m, jloss in zip((None, mask), want["loss"]):
        got = tfu.flow_matching_loss(tv, None, _t(target), mask=None if m is None else _t(m),
                                     x0=x0, t=tt)
        _close(got, jloss, f"flow_matching_loss mask={m is not None}", rtol=1e-5, atol=1e-5)

    got = tfu.sample_ode(tv, None, shape, steps=S, x0=_t(jax.random.normal(key, shape)),
                         device="cpu")
    _close(got, want["ode"], "sample_ode", rtol=1e-5, atol=1e-5)

    jchain = want["chain"]
    x0, eps = _sde_draws(key, shape, S)
    tchain = tfu.sample_sde(tv, None, shape, steps=S, noise_scale=sigma, x0=x0, eps=eps,
                            device="cpu")
    for f in ("actions", "chain", "logprobs"):
        _close(getattr(tchain, f), getattr(jchain, f), f"sample_sde {f}", rtol=1e-5, atol=1e-5)

    tlp = tfu.chain_logprobs(tv, _t(jchain.chain), noise_scale=sigma)
    _close(tlp, want["lp"], "chain_logprobs of JAX's chain")
    _close(tlp, jchain.logprobs, "recompute = sampled")
    _close(own.logprobs, want["own_lp"], "own chain under JAX's recompute")
    _close(tfu.chain_entropy_like(tlp, K * A, S, sigma), want["entropy"], "entropy",
           rtol=1e-6, atol=1e-6)

    wt = _t(w).requires_grad_(True)
    grads = []
    for remat in (False, True):
        fn = lambda x, t: torch.tanh(x @ wt + t.reshape(-1, 1, 1) * _t(b))
        lp = tfu.chain_logprobs(fn, _t(jchain.chain), noise_scale=sigma, remat=remat)
        grads.append((lp.detach(), torch.autograd.grad(lp.sum(), wt)[0]))
    for a, c in zip(*grads):
        _close(a, c, "remat", rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the MLP flow policy
# ---------------------------------------------------------------------------

FLOW = dict(obs_dim=3, action_dim=2, hidden_sizes=(32, 32), num_flow_steps=4,
            sde_noise_scale=0.6)


def test_flow_matching_policy_matches_jax():
    """velocity, value, default_forward on a JAX chain (logprobs, entropy,
    values), sample_ode from a shared x0, the sampled chain on JAX's
    draws, flow_matching_loss on JAX's draws (1e-5), and env_actions."""
    tp, jp = tflow.FlowMatchingPolicy(**FLOW), jflow.FlowMatchingPolicy(**FLOW)
    tparams, jparams = _shared_params(tp, jp, 0)
    r = np.random.default_rng(1)
    obs = {"states": r.normal(size=(5, 3)).astype(np.float32)}
    tobs, jobs = {"states": _t(obs["states"])}, {"states": jnp.asarray(obs["states"])}
    x = r.normal(size=(5, 2)).astype(np.float32)
    t = r.uniform(size=(5,)).astype(np.float32)
    tol = dict(rtol=1e-5, atol=1e-5)
    key = jax.random.PRNGKey(2)

    @jax.jit
    def jax_side(p, o, x, t):       # one compile
        out = jp.predict_action_batch(p, key, o)
        return dict(velocity=jp.velocity(p, x, t, o), value=jp.value(p, o), out=out,
                    fwd=jp.default_forward(p, o, out.actions), env=jp.env_actions(out.actions),
                    ode=jp.sample_ode(p, key, o), loss=jp.flow_matching_loss(p, key, o, x))

    want = jax_side(jparams, jobs, jnp.asarray(x), jnp.asarray(t))
    _close(tp.velocity(tparams, _t(x), _t(t), tobs), want["velocity"], "velocity", **tol)
    _close(tp.value(tparams, tobs), want["value"], "value", **tol)
    jout = want["out"]
    x0, eps = _sde_draws(key, (5, 2), 4)
    tchain = tp.sample_sde(tparams, None, tobs, x0=x0, eps=eps)
    _close(tchain.chain.reshape(5, -1), jout.actions, "chain on JAX's draws", **tol)
    _close(tchain.logprobs, jout.logprobs, "sampled logprobs", **tol)
    t_fwd = tp.default_forward(tparams, tobs, _t(jout.actions))
    for k in ("logprobs", "entropy", "values"):
        _close(t_fwd[k], want["fwd"][k], k, **tol)
    _close(tp.env_actions(_t(jout.actions)), want["env"], "env_actions", **tol)
    _close(tp.sample_ode(tparams, None, tobs, x0=_t(jax.random.normal(key, (5, 2)))),
           want["ode"], "sample_ode", **tol)
    k_noise, k_t = jax.random.split(key)
    _close(tp.flow_matching_loss(tparams, None, tobs, _t(x),
                                 x0=_t(jax.random.normal(k_noise, (5, 2))),
                                 t=_t(jax.random.uniform(k_t, (5,)))),
           want["loss"], "flow loss", **tol)
    det = tp.predict_action_batch(tparams, torch.Generator().manual_seed(0), tobs,
                                  deterministic=True)
    assert det.actions.shape == (5, 2) and det.logprobs.shape == (5, 1)


# ---------------------------------------------------------------------------
# pi0 / pi0.5
# ---------------------------------------------------------------------------

LLM = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
           num_kv_heads=2, max_seq_len=64, dtype="float32")
TOWER = dict(image_size=32, patch_size=16, hidden=32, layers=1, heads=2)
PI0 = dict(action_dim=2, action_chunk=3, state_dim=3, expert_hidden=32, expert_ffn=48,
           time_embed_dim=16, num_flow_steps=3, sde_noise_scale=0.6, state_bins=8)


def _pi_obs(text: str, B=2, seed=0):
    r = np.random.default_rng(seed)
    obs = {"images": r.uniform(size=(B, 32, 32, 3)).astype(np.float32),
           "states": r.uniform(-1.2, 1.2, size=(B, 3)).astype(np.float32)}
    if text != "none":
        obs["instruction_ids"] = r.integers(0, LLM["vocab_size"], (B, 4)).astype(np.int32)
        mask = np.ones((B, 4), bool)
        if text == "padded":
            mask[0, :2] = False
        obs["instruction_mask"] = mask
    return obs


def _pi_side(p, params, obs, chain, x0, x_t, t):
    """Everything a case holds, from one policy (either package)."""
    pk, pv, pvalid, plen, pooled = p.encode_prefix(params, obs)
    fn, _ = p._velocity_fn(params, obs)
    fwd = p.default_forward(params, obs, chain)
    return dict(pk=pk, pv=pv, pvalid=pvalid, plen=plen, pooled=pooled, velocity=fn(x_t, t),
                value=p.value(params, obs), lp=fwd["logprobs"], ent=fwd["entropy"],
                values=fwd["values"], env=p.env_actions(chain))


@pytest.mark.parametrize("case", ["pi0_none", "pi0_padded", "pi05_full", "pi05_padded"])
def test_pi0_matches_jax(case):
    """encode_prefix (the trunk's K/V, the valid mask, the prefix length,
    the pooled state), the expert's velocity, value, default_forward on a
    chain JAX sampled (logprobs, entropy, values), env_actions, sample_ode
    from a shared x0 and the sampled chain on JAX's draws, against JAX's
    (1e-4). pi0.5 takes the state into the prefix as bins and conditions
    the expert on time; a padded instruction takes the reference's
    positions quirk in both packages alike."""
    variant, text = case.split("_")
    cfg = dict(PI0, discrete_state=variant == "pi05")
    jp = jpi.Pi0Policy(jpi.Pi0Config(**cfg), JLLMConfig(**LLM), jvit.ViTConfig(**TOWER))
    tp = tpi.Pi0Policy(tpi.Pi0Config(**cfg), LLMConfig(**LLM), tvit.ViTConfig(**TOWER))
    tparams, jparams = _shared_params(tp, jp, 1)
    obs = _pi_obs(text)
    tobs = {k: _t(v) for k, v in obs.items()}
    jobs = {k: jnp.asarray(v) for k, v in obs.items()}
    key = jax.random.PRNGKey(3)
    shape = (2, PI0["action_chunk"], PI0["action_dim"])
    r = np.random.default_rng(4)
    x_t = r.normal(size=shape).astype(np.float32)
    t = r.uniform(size=(2,)).astype(np.float32)

    @jax.jit
    def jax_side(p, o, x, tt):      # one compile a case
        out = jp.predict_action_batch(p, key, o)
        return (out, _pi_side(jp, p, o, out.actions, x, x, tt), jp.sample_ode(p, key, o),
                jax.random.normal(key, shape, jnp.float32))

    jout, want, jode, x0 = jax_side(jparams, jobs, jnp.asarray(x_t), jnp.asarray(t))
    got = _pi_side(tp, tparams, tobs, _t(jout.actions), _t(x0), _t(x_t), _t(t))
    for k in want:
        _close(got[k], want[k], k)
    _close(tp.sample_ode(tparams, None, tobs, x0=_t(x0)), jode, "sample_ode")
    x0s, eps = _sde_draws(key, shape, PI0["num_flow_steps"])
    tout = tp.predict_action_batch(tparams, None, tobs, x0=x0s, eps=eps)
    for f in ("actions", "logprobs", "values"):
        _close(getattr(tout, f), getattr(jout, f), f"sampled {f}")


def test_pi0_own_chain_holds_under_jax_and_trains():
    """The port's own sampled chain: its logprobs hold under JAX's
    default_forward (1e-4); one EmbodiedLearner step with remat equals one
    without (params within 1e-6)."""
    from rlinf_tpu_torch.training.embodied_learner import (
        EmbodiedLossConfig,
        make_embodied_train_step,
    )

    jp = jpi.Pi0Policy(jpi.Pi0Config(**PI0), JLLMConfig(**LLM), jvit.ViTConfig(**TOWER))
    tparams, jparams = _shared_params(
        tpi.Pi0Policy(tpi.Pi0Config(**PI0), LLMConfig(**LLM), tvit.ViTConfig(**TOWER)), jp, 2)
    obs = _pi_obs("full", B=3, seed=1)
    tobs = {k: _t(v) for k, v in obs.items()}
    steps = {}
    for remat in (False, True):
        tp = tpi.Pi0Policy(tpi.Pi0Config(**PI0), LLMConfig(**LLM), tvit.ViTConfig(**TOWER),
                           remat=remat)
        out = tp.predict_action_batch(tparams, torch.Generator().manual_seed(5), tobs)
        if not remat:
            j_lp = jax.jit(jp.default_forward)(jparams, {k: jnp.asarray(v) for k, v in
                                                        obs.items()},
                                               jnp.asarray(_np(out.actions)))["logprobs"]
            _close(out.logprobs, j_lp, "own chain")
        tx = TS.make_optimizer(TS.OptimizerConfig(lr=1e-3, clip_grad=1.0))
        params = TS.tree_map(torch.clone, tparams)
        state = TS.create_train_state(lambda: params, tx)
        step = make_embodied_train_step(tp, EmbodiedLossConfig(), tx, device="cpu")
        batch = {**{f"obs/{k}": v for k, v in tobs.items()}, "actions": out.actions,
                 "old_logprobs": out.logprobs - 0.01, "advantages": torch.tensor([1., -1., .5]),
                 "returns": torch.zeros(3), "prev_values": out.values}
        steps[remat] = step(state, batch)[0].params
    _close_tree(steps[True], steps[False], "remat step", rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# GR00T
# ---------------------------------------------------------------------------

GR00T = dict(action_dim=2, action_chunk=3, state_dim=3, hidden=32, layers=2, heads=4,
             time_embed_dim=16, num_flow_steps=3, sde_noise_scale=0.6)


def _gr00t_side(p, params, obs, chain, x_t, t):
    cond, pooled = p.encode_backbone(params, obs)
    fn, _ = p._velocity_fn(params, obs)
    fwd = p.default_forward(params, obs, chain)
    return dict(cond=cond, pooled=pooled, velocity=fn(x_t, t), value=p.value(params, obs),
                lp=fwd["logprobs"], ent=fwd["entropy"], values=fwd["values"])


@pytest.mark.parametrize("text,embodiments", [(0, 1), (16, 4)], ids=["vision_1emb",
                                                                     "text_4emb"])
def test_gr00t_matches_jax(text, embodiments):
    """encode_backbone (tokens, pooled), the DiT velocity, value,
    default_forward on a chain JAX sampled, the deterministic (ODE) action
    from a shared x0 and the sampled chain on JAX's draws, against JAX's
    (1e-4), with and
    without instruction tokens, with 1 and 4 embodiments (embodiment ids
    given, or absent: 0)."""
    cfg = dict(GR00T, text_vocab=text, num_embodiments=embodiments)
    jp = jgr00t.GR00TPolicy(jgr00t.GR00TConfig(**cfg), jvit.ViTConfig(**TOWER))
    tp = tgr00t.GR00TPolicy(tgr00t.GR00TConfig(**cfg), tvit.ViTConfig(**TOWER))
    tparams, jparams = _shared_params(tp, jp, 3)
    r = np.random.default_rng(6)
    obs = {"images": r.uniform(size=(3, 32, 32, 3)).astype(np.float32),
           "states": r.normal(size=(3, 3)).astype(np.float32)}
    if text:
        obs["instruction_ids"] = r.integers(0, text, (3, 5)).astype(np.int32)
    if embodiments > 1:
        obs["embodiment_id"] = np.array([0, 3, 1], np.int32)
    tobs = {k: _t(v) for k, v in obs.items()}
    jobs = {k: jnp.asarray(v) for k, v in obs.items()}
    key = jax.random.PRNGKey(7)
    shape = (3, GR00T["action_chunk"], GR00T["action_dim"])
    x_t = r.normal(size=shape).astype(np.float32)
    t = r.uniform(size=(3,)).astype(np.float32)

    @jax.jit
    def jax_side(p, o, x, tt):      # one compile a case
        out = jp.predict_action_batch(p, key, o)
        return (out, _gr00t_side(jp, p, o, out.actions, x, tt),
                jp.predict_action_batch(p, key, o, deterministic=True))

    jout, want, jdet = jax_side(jparams, jobs, jnp.asarray(x_t), jnp.asarray(t))
    got = _gr00t_side(tp, tparams, tobs, _t(jout.actions), _t(x_t), _t(t))
    for k in want:
        _close(got[k], want[k], k)
    x0 = jax.random.normal(key, shape, jnp.float32)
    tdet = tp.predict_action_batch(tparams, None, tobs, deterministic=True, x0=_t(x0))
    for f in ("actions", "logprobs", "values"):
        _close(getattr(tdet, f), getattr(jdet, f), f"deterministic {f}")
    x0s, eps = _sde_draws(key, shape, GR00T["num_flow_steps"])
    tout = tp.predict_action_batch(tparams, None, tobs, x0=x0s, eps=eps)
    for f in ("actions", "logprobs", "values"):
        _close(getattr(tout, f), getattr(jout, f), f"sampled {f}")


# ---------------------------------------------------------------------------
# the value critics
# ---------------------------------------------------------------------------

def test_categorical_value_loss_matches_jax():
    """The Dirac two-bin projection loss and its metrics against JAX's on
    random logits and targets on atoms, between atoms and out of range
    (1e-6); the atoms equal."""
    r = np.random.default_rng(0)
    logits = r.normal(size=(8, 11)).astype(np.float32)
    atoms = np.asarray(jvc.value_atoms(11, -1.0, 0.0))
    targets = np.array([atoms[0], atoms[5], atoms[10], -0.33, -0.77, 0.4, -1.6, -0.05],
                       np.float32)
    tl, tm = tvc.categorical_value_loss(_t(logits), _t(targets), v_min=-1.0, v_max=0.0)
    jl, jm = jvc.categorical_value_loss(jnp.asarray(logits), jnp.asarray(targets),
                                        v_min=-1.0, v_max=0.0)
    _close(tl, jl, "loss", rtol=1e-6, atol=1e-6)
    for k in jm:
        _close(tm[k], jm[k], k, rtol=1e-6, atol=1e-6)
    _close(tvc.value_atoms(11, -1.0, 0.0, device="cpu"), atoms, "atoms", rtol=1e-6, atol=1e-6)


def _recap_pair(seed):
    vcfg = dict(num_bins=16, expert_hidden=32, expert_ffn=48)
    jp = jvc.ValueCriticPolicy(jvc.ValueCriticConfig(**vcfg), JLLMConfig(**LLM),
                               jvit.ViTConfig(**TOWER))
    tp = tvc.ValueCriticPolicy(tvc.ValueCriticConfig(**vcfg), LLMConfig(**LLM),
                               tvit.ViTConfig(**TOWER))
    return tp, jp, *_shared_params(tp, jp, seed)


def test_recap_critic_matches_jax_and_learns():
    """value_logits, predict_value and the loss with its metrics against
    JAX's on a padded instruction (1e-4); then 60 adam steps of the port's
    (lr 3e-3, b2 0.999) drop the loss below 0.7 x its first value and bring
    every predicted value within 0.25 of its target (JAX's test)."""
    tp, jp, tparams, jparams = _recap_pair(0)
    obs = _pi_obs("padded", B=4)
    targets = np.array([-0.8, -0.6, -0.4, -0.2], np.float32)
    tobs = {k: _t(v) for k, v in obs.items()}
    jobs = {k: jnp.asarray(v) for k, v in obs.items()}
    want = jax.jit(lambda p, o, y: (jp.value_logits(p, o), jp.predict_value(p, o),
                                    jp.loss(p, o, y)))(jparams, jobs, jnp.asarray(targets))
    got = (tp.value_logits(tparams, tobs), tp.predict_value(tparams, tobs),
           tp.loss(tparams, tobs, _t(targets)))
    _close(got[0], want[0], "value_logits")
    _close(got[1], want[1], "predict_value")
    _close(got[2][0], want[2][0], "loss")
    for k in want[2][1]:
        _close(got[2][1][k], want[2][1][k], k)

    from rlinf_tpu_torch.training.learner import _grads

    tx = TS.make_optimizer(TS.OptimizerConfig(lr=3e-3, beta2=0.999, clip_grad=0.0))
    state = TS.create_train_state(lambda: tparams, tx)
    losses = []
    for _ in range(60):
        grads, loss, _ = _grads(state.params, lambda p: tp.loss(p, tobs, _t(targets)))
        updates, opt = tx.update(grads, state.opt_state, state.params)
        TS.apply_updates(state.params, updates)
        state = TS.TrainState(state.step + 1, state.params, opt)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.7, losses[::20]
    v = _np(tp.predict_value(state.params, tobs))
    assert np.abs(v - targets).max() < 0.25


def _frames(B=16, seed=0):
    r = np.random.default_rng(seed)
    t_a = r.random((B,)).astype(np.float32)
    strides = np.where(r.random(B) > 0.5, 3, -3).astype(np.int32)
    t_b = t_a + 0.1 * strides
    fa = np.tile(t_a[:, None, None, None], (1, 32, 32, 3)).astype(np.float32)
    fb = np.tile(t_b[:, None, None, None], (1, 32, 32, 3)).astype(np.float32)
    return fa, fb, strides


def test_steam_critic_matches_jax_and_learns():
    """stride_logits [E, B, nb] (the ensemble as one batched product per
    layer), the loss and its accuracy, progress_score and
    ensemble_disagreement against JAX's vmapped heads (1e-5), at 4 bins
    and 3 members; stride_to_bin equal at 4 and 2 bins; odd bin counts
    refused; then 80 adam steps of the port's binary 3-member critic learn
    the direction (accuracy > 0.9, progress > 0.8 forward and < 0.2
    backward: JAX's test)."""
    cfg = dict(num_bins=4, ensemble_size=3, feature_dim=32, max_stride=8)
    jc, tc = jvc.SteamCritic(jvc.SteamConfig(**cfg)), tvc.SteamCritic(tvc.SteamConfig(**cfg))
    tparams, jparams = _shared_params(tc, jc, 0)
    fa, fb, strides = _frames()
    strides = strides * np.array([1, 2, 3, 1] * 4, np.int32) // 3 + np.sign(strides)
    args_j = (jnp.asarray(fa), jnp.asarray(fb))
    args_t = (_t(fa), _t(fb))
    want = jax.jit(lambda p, a, b, s: (jc.stride_logits(p, a, b), jc.loss(p, a, b, s),
                                       jc.progress_score(p, a, b),
                                       jc.ensemble_disagreement(p, a, b)))(
        jparams, *args_j, jnp.asarray(strides))
    got = (tc.stride_logits(tparams, *args_t), tc.loss(tparams, *args_t, _t(strides)),
           tc.progress_score(tparams, *args_t), tc.ensemble_disagreement(tparams, *args_t))
    tol = dict(rtol=1e-5, atol=1e-5)
    _close(got[0], want[0], "stride_logits", **tol)
    _close(got[1][0], want[1][0], "loss", **tol)
    _close(got[1][1]["critic/stride_acc"], want[1][1]["critic/stride_acc"], "acc", **tol)
    _close(got[2], want[2], "progress", **tol)
    _close(got[3], want[3], "disagreement", **tol)
    s = np.array([-8, -5, -4, -1, 1, 4, 5, 8], np.int32)
    np.testing.assert_array_equal(_np(tc.stride_to_bin(_t(s))),
                                  np.asarray(jc.stride_to_bin(jnp.asarray(s))))
    two = tvc.SteamCritic(tvc.SteamConfig(num_bins=2))
    np.testing.assert_array_equal(_np(two.stride_to_bin(_t(np.array([-3, 2])))), [0, 1])
    with pytest.raises(ValueError):
        tvc.SteamConfig(num_bins=3)

    from rlinf_tpu_torch.training.learner import _grads

    crit = tvc.SteamCritic(tvc.SteamConfig(num_bins=2, ensemble_size=3))
    fa, fb, strides = _frames()
    args_t, st = (_t(fa), _t(fb)), _t(strides)
    params = crit.init(torch.Generator().manual_seed(0), device="cpu")
    tx = TS.make_optimizer(TS.OptimizerConfig(lr=1e-2, beta2=0.999, clip_grad=0.0))
    state = TS.create_train_state(lambda: params, tx)
    for _ in range(80):
        grads, _, m = _grads(state.params, lambda p: crit.loss(p, *args_t, st))
        updates, opt = tx.update(grads, state.opt_state, state.params)
        TS.apply_updates(state.params, updates)
        state = TS.TrainState(state.step + 1, state.params, opt)
    assert float(crit.loss(state.params, *args_t, st)[1]["critic/stride_acc"]) > 0.9
    prog = _np(crit.progress_score(state.params, *args_t))
    fwd = strides > 0
    assert prog[fwd].mean() > 0.8 and prog[~fwd].mean() < 0.2
    d = _np(crit.ensemble_disagreement(state.params, *args_t))
    assert d.shape == (16,) and np.isfinite(d).all()


# ---------------------------------------------------------------------------
# NFT
# ---------------------------------------------------------------------------

NFT_FLOW = dict(obs_dim=2, action_dim=2, hidden_sizes=(32, 32), num_flow_steps=8,
                sde_noise_scale=0.7)


@pytest.mark.parametrize("form", ["dpo_adaptive", "mse_constant"])
def test_nft_step_matches_jax(form):
    """Two NFT steps on JAX's draws (its step indices and noise) from one
    init with a lagged rollout model (tau 0.5 after step 1), the
    advantages mapped from [-1, 1] (adv_type "gae") and negatives weighted
    0.3: every metric (1e-5 relative, 1e-6 absolute), the params and the
    rollout params (1e-5) against JAX's; nft_tau_at's anneal equal."""
    loss_form, weight_mode = form.split("_")
    cfg = dict(loss_form=loss_form, weight_mode=weight_mode, weight_scale=(1.0, 0.3),
               adv_type="gae", max_drift=0.05, tau=(1.0, 0.1, 1, 3))
    tp, jp = tflow.FlowMatchingPolicy(**NFT_FLOW), jflow.FlowMatchingPolicy(**NFT_FLOW)
    tparams, jparams = _shared_params(tp, jp, 5)
    opt = dict(lr=1e-2, eps=1e-3, clip_grad=0.0)
    jtx, ttx = JS.make_optimizer(JS.OptimizerConfig(**opt)), \
        TS.make_optimizer(TS.OptimizerConfig(**opt))
    jstate = jnft.NFTTrainState(jnp.zeros((), jnp.int32), jparams, jtx.init(jparams),
                                jax.tree_util.tree_map(jnp.copy, jparams))
    tstate = tnft.NFTTrainState(0, tparams, ttx.init(tparams), TS.tree_map(torch.clone, tparams))
    jstep = jnft.make_nft_train_step(jp, jnft.NFTConfig(**cfg), jtx)
    tstep = tnft.make_nft_train_step(tp, tnft.NFTConfig(**cfg), ttx, device="cpu")
    r = np.random.default_rng(6)
    for rnd in range(2):
        tau = tnft.nft_tau_at(tnft.NFTConfig(**cfg), rnd + 2)
        assert tau == jnft.nft_tau_at(jnft.NFTConfig(**cfg), rnd + 2)
        if rnd:
            jstate = jnft.soft_update_rollout(jstate, tau)
            tstate = tnft.soft_update_rollout(tstate, tau)
        batch = {"obs/states": r.uniform(-1, 1, (64, 2)).astype(np.float32),
                 "actions": r.normal(size=(64, 2)).astype(np.float32),
                 "advantages": r.uniform(-1, 1, (64,)).astype(np.float32),
                 "loss_mask": (r.uniform(size=(64,)) < 0.9).astype(np.float32)}
        key = jax.random.PRNGKey(20 + rnd)
        k_step, k_noise = jax.random.split(key)
        draws = (_t(jax.random.randint(k_step, (64,), 0, 8)),
                 _t(jax.random.normal(k_noise, (64, 2), jnp.float32)))
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        tstate, tm = tstep(tstate, batch, None, draws=draws)
        assert sorted(tm) == sorted(jm)
        for k in jm:
            _close(tm[k], jm[k], k, rtol=1e-5, atol=1e-6)
    _close_tree(tstate.params, jstate.params, "params", rtol=1e-5, atol=1e-5)
    _close_tree(tstate.rollout_params, jstate.rollout_params, "rollout params",
                rtol=1e-5, atol=1e-5)
    assert tstate.step == 2


def test_nft_tau_and_init():
    """nft_tau_at's scalar and anneal as JAX's; init_nft_state's rollout
    model is a copy, and a soft update at tau < 1 leaves it between the
    old copy and the trained params."""
    for tau in ((0.3,), (1.0, 0.1, 10, 20)):
        for s in (0, 10, 15, 20, 30):
            assert tnft.nft_tau_at(tnft.NFTConfig(tau=tau), s) == pytest.approx(
                jnft.nft_tau_at(jnft.NFTConfig(tau=tau), s))
    tp = tflow.FlowMatchingPolicy(obs_dim=2, action_dim=2, hidden_sizes=(16,))
    tx = TS.make_optimizer(TS.OptimizerConfig(lr=1e-2, clip_grad=0.0))
    state = tnft.init_nft_state(tp, torch.Generator().manual_seed(0), tx, device="cpu")
    leaves = lambda t: TS.tree_leaves(t)
    assert all(torch.equal(a, b) and a.data_ptr() != b.data_ptr()
               for a, b in zip(leaves(state.params), leaves(state.rollout_params)))
    old = [t.clone() for t in leaves(state.rollout_params)]
    step = tnft.make_nft_train_step(tp, tnft.NFTConfig(tau=(0.5,)), tx, device="cpu")
    obs = np.random.default_rng(0).uniform(-1, 1, (32, 2)).astype(np.float32)
    batch = {"obs/states": obs, "actions": obs, "advantages": np.ones(32, np.float32),
             "loss_mask": np.ones(32, np.float32)}
    state, _ = step(state, batch, torch.Generator().manual_seed(1))
    state = tnft.soft_update_rollout(state, 0.5)
    for p, r_, o in zip(leaves(state.params), leaves(state.rollout_params), old):
        torch.testing.assert_close(r_, 0.5 * p + 0.5 * o)
    assert any(not torch.equal(p, r_) for p, r_ in zip(leaves(state.params),
                                                       leaves(state.rollout_params)))


# ---------------------------------------------------------------------------
# the VLA checkpoint import
# ---------------------------------------------------------------------------

VLA_LLM = dict(vocab_size=96, hidden_size=32, intermediate_size=64, num_layers=2,
               num_heads=4, num_kv_heads=2, max_seq_len=64, dtype="float32")
TIMM = dict(image_size=32, patch_size=16, hidden=32, layers=2, heads=2, timm_style=True,
            cls_token=True)
TIMM2 = dict(image_size=32, patch_size=16, hidden=24, layers=1, heads=2, timm_style=True)


def _vla_pair(fused: bool, seed: int = 0):
    cfg = dict(action_dim=3, action_bins=16)
    jp = jopenvla.OpenVLAPolicy(jopenvla.OpenVLAConfig(**cfg), JLLMConfig(**VLA_LLM),
                                jvit.ViTConfig(**TIMM) if fused else None,
                                jvit.ViTConfig(**TIMM2) if fused else None)
    tp = topenvla.OpenVLAPolicy(topenvla.OpenVLAConfig(**cfg), LLMConfig(**VLA_LLM),
                                tvit.ViTConfig(**TIMM) if fused else None,
                                tvit.ViTConfig(**TIMM2) if fused else None)
    return tp, jp, *_shared_params(tp, jp, seed)


@pytest.mark.parametrize("fused", [False, True], ids=["repo_naming", "timm_fused"])
def test_vla_state_dict_round_trip_and_jax_checkpoint(fused, tmp_path):
    """Both namings: the port's export equals JAX's key for key (1e-6) and
    imports back to the same tree bitwise; a checkpoint directory written
    by JAX's ``save_checkpoint_dir`` reads through the port's
    ``read_checkpoint_dir`` to the tree JAX reads (1e-6), and
    ``load_vla_pretrained`` merges it over a fresh init (the value head
    present) with default_forward equal to the source tree's (1e-5)."""
    tp, jp, tparams, jparams = _vla_pair(fused)
    sd = thf.vla_params_to_state_dict(tparams, tp)
    jsd = jhf.vla_params_to_state_dict(jparams, jp)
    assert sorted(sd) == sorted(jsd)
    for k in jsd:
        _close(sd[k], jsd[k], k, rtol=1e-6, atol=1e-6)
    back = _flat(thf.vla_params_from_state_dict(sd, tp, device="cpu"))
    want = {k: v for k, v in _flat(tparams).items() if not k.startswith("/value_head")}
    assert sorted(back) == sorted(want)
    assert all(torch.equal(back[k], want[k]) for k in want)

    jhf.save_checkpoint_dir(jsd, str(tmp_path / "ckpt"))
    got = thf.vla_params_from_state_dict(thf.read_checkpoint_dir(str(tmp_path / "ckpt")), tp,
                                         device="cpu")
    want = jhf.vla_params_from_state_dict(jhf.read_checkpoint_dir(str(tmp_path / "ckpt")), jp)
    for section in want:
        _close_tree(got[section], want[section], section, rtol=1e-6, atol=1e-6)
    loaded = thf.load_vla_pretrained(str(tmp_path / "ckpt"), tp, device="cpu")
    assert "value_head" in loaded
    obs = {"images": _t(np.random.default_rng(0).uniform(size=(2, 32, 32, 3)).astype(np.float32)),
           "instruction_ids": torch.zeros((2, 4), dtype=torch.int32)}
    acts = torch.zeros((2, 3))
    _close(tp.default_forward(loaded, obs, acts)["logprobs"],
           tp.default_forward(tparams, obs, acts)["logprobs"], "reloaded",
           rtol=1e-5, atol=1e-5)


def test_vla_torch_bin_and_timm_refusal(tmp_path):
    """A torch ``pytorch_model.bin`` reads back equal; the port's own
    ``save_checkpoint_dir`` reads back equal; a timm-named checkpoint is
    refused by a policy whose tower is not ``timm_style``, in the words
    of JAX's refusal."""
    tp, _, tparams, _ = _vla_pair(False)
    sd = thf.vla_params_to_state_dict(tparams, tp)
    torch.save(sd, tmp_path / "pytorch_model.bin")
    back = thf.read_checkpoint_dir(str(tmp_path))
    assert sorted(back) == sorted(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    thf.save_checkpoint_dir(sd, str(tmp_path / "st"))
    back = thf.read_checkpoint_dir(str(tmp_path / "st"))
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    fused, jfused, fparams, jfparams = _vla_pair(True)
    timm_sd = thf.vla_params_to_state_dict(fparams, fused)
    msgs = []
    for mod, pol, s in ((thf, tp, timm_sd),
                        (jhf, jopenvla.OpenVLAPolicy(jopenvla.OpenVLAConfig(
                            action_dim=3, action_bins=16), JLLMConfig(**VLA_LLM)),
                         jhf.vla_params_to_state_dict(jfparams, jfused))):
        with pytest.raises(ValueError, match="timm_style") as e:
            mod.vla_params_from_state_dict(s, pol, **({"device": "cpu"} if mod is thf else {}))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# the registry and flow-SDE PPO
# ---------------------------------------------------------------------------

def test_get_model_for_every_registered_name():
    """Both embodied registries hold the same names; each of the port's
    factories gives the class of JAX's, with the same config (dataclass
    fields or attributes), at the defaults and with a keyword override.
    (Other tests may register models of their own in the same process: the
    names are those the two ``registry`` modules register.)"""
    from rlinf_tpu import models as jmodels
    from rlinf_tpu.models import get_model as jget
    from rlinf_tpu_torch import models as tmodels
    from rlinf_tpu_torch.models import get_model as tget

    import rlinf_tpu.models.embodiment  # noqa: F401  (registers JAX's families)
    import rlinf_tpu_torch.models.embodiment  # noqa: F401

    def names(mod, registry):
        return sorted(n for n, f in mod._MODEL_REGISTRY.items() if f.__module__ == registry)

    tnames = names(tmodels, "rlinf_tpu_torch.models.embodiment.registry")
    assert tnames == names(jmodels, "rlinf_tpu.models.embodiment.registry")
    assert len(tnames) == 16
    small = {"mlp_policy": dict(obs_dim=3, action_dim=2), "sac_policy": dict(obs_dim=3,
                                                                             action_dim=2),
             "flow_policy": dict(obs_dim=3, action_dim=2),
             "cnn_policy": dict(image_shape=(36, 36, 3), action_dim=2)}

    def desc(m):
        cfg = getattr(m, "cfg", None)
        if dataclasses.is_dataclass(cfg):
            cfg = dataclasses.asdict(cfg)
        return type(m).__name__, cfg, getattr(m, "action_dim", None)

    for name in tnames:
        kw = small.get(name, {})
        assert desc(tget(name, **kw)) == desc(jget(name, **kw)), name
    assert desc(tget("openpi_pi05", action_dim=4)) == desc(jget("openpi_pi05", action_dim=4))
    assert tget("openpi_pi05").cfg.discrete_state and tget("starvla").cfg.num_embodiments == 1


def test_flow_sde_ppo_learns_point_reach():
    """The piRL recipe through the port's EmbodiedRunner: flow-SDE chains
    ride in ``actions``, chain_logprobs give the ratio, GAE over the env's
    rewards; success rises by more than 0.1 over 30 steps (JAX's test's
    settings and bar)."""
    from rlinf_tpu_torch.envs.toy import PointReachEnv
    from rlinf_tpu_torch.runners.embodied_runner import EmbodiedRunner, EmbodiedRunnerConfig

    env = PointReachEnv(num_envs=64, seed=0, max_episode_steps=12, goal_radius=0.35, dt=0.3)
    policy = tflow.FlowMatchingPolicy(obs_dim=4, action_dim=2, hidden_sizes=(64, 64),
                                      num_flow_steps=4, sde_noise_scale=0.7)
    cfg = EmbodiedRunnerConfig(num_chunk_steps=12, num_epochs=2, num_mini_batches=4, gamma=0.9,
                               gae_lambda=0.95, max_steps=30, seed=0)
    runner = EmbodiedRunner(cfg, [env], policy,
                            optimizer=TS.OptimizerConfig(lr=3e-3, clip_grad=1.0), device="cpu")
    succ = [h.get("env/success_once", 0.0) for h in runner.run(max_steps=30)]
    first, last = np.mean(succ[:5]), np.mean(succ[-5:])
    assert last > first + 0.1, f"flow-SDE PPO not learning: {first} -> {last}"


def test_runner_draws_pi0_from_its_init_generator():
    """``Pi0Policy.init`` draws every leaf, the trunk too, from the
    generator it is given (one seed, one tree; another seed, another
    trunk), and ``EmbodiedRunner`` inits from ``init_generator`` where one
    is given, else from a CPU generator seeded ``cfg.seed`` (bitwise)."""
    from rlinf_tpu_torch.envs.toy import ImageReachEnv
    from rlinf_tpu_torch.envs.wrappers import ActionChunkWrapper
    from rlinf_tpu_torch.runners.embodied_runner import EmbodiedRunner, EmbodiedRunnerConfig

    cfg = dict(PI0, state_dim=4)
    tp = tpi.Pi0Policy(tpi.Pi0Config(**cfg), LLMConfig(**LLM), tvit.ViTConfig(**TOWER))
    init = lambda seed: tp.init(torch.Generator().manual_seed(seed), device="cpu")
    leaves = lambda tree: [_np(t) for t in TS.tree_leaves(tree)]
    same = lambda a, b: all(np.array_equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    assert same(init(3), init(3))
    assert not any(np.array_equal(x, y) for x, y in zip(leaves(init(3)["vlm"]),
                                                        leaves(init(4)["vlm"])) if x.std() > 0)

    def runner(**kw):
        env = ActionChunkWrapper(ImageReachEnv(2, seed=0, size=32), PI0["action_chunk"])
        return EmbodiedRunner(EmbodiedRunnerConfig(seed=5), [env], tp, device="cpu", **kw)

    assert same(runner().state.params, init(5))
    assert same(runner(init_generator=torch.Generator().manual_seed(3)).state.params, init(3))
