"""The port's training batch, advantage estimators and actor losses against
the JAX package, on the CPU.

Every input is drawn with numpy from a seed and handed to both sides.
``build_train_batch`` must agree exactly. The estimators and losses run in
fp32 on both sides and agree within 1e-6 (relative and absolute; only the
order of summation differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rlinf_tpu.algorithms as jalg
from rlinf_tpu.algorithms import losses as jlosses
from rlinf_tpu.algorithms import utils as jutils
from rlinf_tpu.data.io_struct import RolloutResult as JResult
from rlinf_tpu.data.io_struct import build_train_batch as j_build
import rlinf_tpu_torch.algorithms as talg
from rlinf_tpu_torch.algorithms import losses as tlosses
from rlinf_tpu_torch.algorithms import utils as tutils
from rlinf_tpu_torch.data.io_struct import RolloutResult as TResult
from rlinf_tpu_torch.data.io_struct import build_train_batch as t_build

TOL = dict(rtol=1e-6, atol=1e-6)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def _rollout(seed, B=6, P=9, N=7):
    r = np.random.default_rng(seed)
    plen = r.integers(1, P + 1, B)
    rlen = r.integers(0, N + 1, B)
    rlen[0] = N
    prompt_mask = np.arange(P)[None, :] >= (P - plen)[:, None]
    response_mask = np.arange(N)[None, :] < rlen[:, None]
    fields = dict(
        prompt_ids=np.where(prompt_mask, r.integers(1, 50, (B, P)), 0).astype(np.int32),
        prompt_mask=prompt_mask,
        response_ids=np.where(response_mask, r.integers(1, 50, (B, N)), 0).astype(np.int32),
        response_mask=response_mask,
        response_logprobs=np.where(response_mask, -r.random((B, N)), 0).astype(np.float32),
    )
    return fields, r.normal(size=(B, N)).astype(np.float32)


@pytest.mark.parametrize("seq_bucket,max_len", [(8, None), (128, None), (8, 12)])
def test_build_train_batch_exact(seq_bucket, max_len):
    fields, adv = _rollout(0)
    got = t_build(TResult(**fields), adv, pad_id=0, seq_bucket=seq_bucket, max_len=max_len)
    want = j_build(JResult(**fields), adv, pad_id=0, seq_bucket=seq_bucket, max_len=max_len)
    for k, v in want.to_dict().items():
        assert got.to_dict()[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got.to_dict()[k], v, err_msg=k)
    assert got.num_valid_tokens == want.num_valid_tokens


def _grouped(seed, G=4, n=3, L=5):
    r = np.random.default_rng(seed)
    rewards = r.integers(0, 2, G * n).astype(np.float32)
    rewards[:G] = 1.0                                   # one group with zero spread
    mask = r.random((L, G * n)) > 0.3
    return rewards, mask, G


def test_grpo_advantages():
    rewards, mask, G = _grouped(1)
    got, _ = talg.get_advantage_fn("grpo")(rewards=_t(rewards), loss_mask=_t(mask), group_size=G)
    want, _ = jalg.get_advantage_fn("grpo")(
        rewards=jnp.asarray(rewards), loss_mask=jnp.asarray(mask), group_size=G)
    _close(got, want)


@pytest.mark.parametrize("baseline,kl_beta", [(False, 0.0), (True, 0.1)])
def test_reinpp_advantages(baseline, kl_beta):
    rewards, mask, G = _grouped(2)
    mask[:, 1] = False                                   # an empty response
    r = np.random.default_rng(3)
    lp = r.normal(size=mask.shape).astype(np.float32)
    ref = r.normal(size=mask.shape).astype(np.float32)
    kw = dict(group_size=G, use_reinpp_baseline=baseline, kl_beta=kl_beta)
    got, _ = talg.get_advantage_fn("reinpp")(rewards=_t(rewards), loss_mask=_t(mask),
                                             logprob=_t(lp), ref_logprob=_t(ref), **kw)
    want, _ = jalg.get_advantage_fn("reinpp")(
        rewards=jnp.asarray(rewards), loss_mask=jnp.asarray(mask), logprob=jnp.asarray(lp),
        ref_logprob=jnp.asarray(ref), **kw)
    _close(got, want)


@pytest.mark.parametrize("critic", [False, True])
def test_gae_advantages(critic):
    r = np.random.default_rng(4)
    T, B = 6, 3
    rewards = r.normal(size=(T, B)).astype(np.float32)
    values = r.normal(size=(T + 1, B)).astype(np.float32) if critic else None
    dones = r.random((T + 1, B)) > 0.8
    mask = r.random((T, B)) > 0.2
    kw = dict(gamma=0.9, gae_lambda=0.95, normalize_returns=True)
    got = talg.get_advantage_fn("gae")(
        rewards=_t(rewards), values=None if values is None else _t(values), dones=_t(dones),
        loss_mask=_t(mask), **kw)
    want = jalg.get_advantage_fn("gae")(
        rewards=jnp.asarray(rewards), values=None if values is None else jnp.asarray(values),
        dones=jnp.asarray(dones), loss_mask=jnp.asarray(mask), **kw)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("normalize", [False, True])
def test_raw_advantages(normalize):
    rewards, mask, _ = _grouped(5)
    got, _ = talg.get_advantage_fn("raw")(rewards=_t(rewards), loss_mask=_t(mask),
                                          normalize_advantages=normalize)
    want, _ = jalg.get_advantage_fn("raw")(rewards=jnp.asarray(rewards),
                                           loss_mask=jnp.asarray(mask),
                                           normalize_advantages=normalize)
    _close(got, want)


def test_opd_advantages():
    r = np.random.default_rng(6)
    prev = r.normal(size=(5, 8)).astype(np.float32)
    teacher = r.normal(size=(5, 8)).astype(np.float32)
    mask = np.ones((4, 2), bool)
    got, _ = talg.get_advantage_fn("opd")(prev_logprobs=_t(prev), teacher_logprobs=_t(teacher),
                                          loss_mask=_t(mask), num_action_chunks=2)
    want, _ = jalg.get_advantage_fn("opd")(
        prev_logprobs=jnp.asarray(prev), teacher_logprobs=jnp.asarray(teacher),
        loss_mask=jnp.asarray(mask), num_action_chunks=2)
    _close(got, want)


@pytest.mark.parametrize("mode", ["turn", "trajectory"])
def test_grpo_dynamic_advantages(mode):
    r = np.random.default_rng(7)
    idx_to_traj = [0, 0, 1, 2, 2, 2, 3, 4, 5, 5, 6, 7]
    rewards = r.normal(size=len(idx_to_traj)).astype(np.float32)
    mask = r.random((5, len(idx_to_traj))) > 0.3
    kw = dict(group_size=4, idx_to_traj=idx_to_traj, advantage_mode=mode)
    got, _ = talg.get_advantage_fn("grpo_dynamic")(rewards=_t(rewards), loss_mask=_t(mask), **kw)
    want, _ = jalg.get_advantage_fn("grpo_dynamic")(
        rewards=jnp.asarray(rewards), loss_mask=jnp.asarray(mask), **kw)
    _close(got, want)


@pytest.mark.parametrize("kind", ["k1", "abs", "k2", "low_var_kl"])
def test_kl_penalty_and_helpers(kind):
    r = np.random.default_rng(8)
    a = (r.normal(size=(4, 6)) * 3).astype(np.float32)
    b = (r.normal(size=(4, 6)) * 3).astype(np.float32)
    m = r.random((4, 6)) > 0.5
    _close(tutils.kl_penalty(_t(a), _t(b), kind), jutils.kl_penalty(jnp.asarray(a), jnp.asarray(b), kind))
    _close(tutils.safe_normalize(_t(a), _t(m)), jutils.safe_normalize(jnp.asarray(a), jnp.asarray(m)))
    _close(tutils.masked_mean(_t(a), _t(m)), jutils.masked_mean(jnp.asarray(a), jnp.asarray(m)))
    for agg in ("token-mean", "seq-mean-token-sum", "seq-mean-token-mean"):
        _close(tutils.get_loss_agg_func(agg)(_t(a), _t(m)),
               jutils.get_loss_agg_func(agg)(jnp.asarray(a), jnp.asarray(m)))


def _loss_inputs(seed, B=4, T=10):
    r = np.random.default_rng(seed)
    return dict(
        logprobs=(r.normal(size=(B, T)) * 0.3 - 1).astype(np.float32),
        old_logprobs=(r.normal(size=(B, T)) * 0.3 - 1).astype(np.float32),
        advantages=(r.normal(size=(B, T)) * 2).astype(np.float32),
        loss_mask=r.random((B, T)) > 0.3,
    )


def _compare_loss(tfn, jfn, inputs, **kw):
    tin = {k: _t(v) for k, v in inputs.items()}
    tin["logprobs"].requires_grad_(True)
    tloss, tm = tfn(**tin, **kw)
    tloss.backward()

    def jloss(lp):
        return jfn(**{**{k: jnp.asarray(v) for k, v in inputs.items()}, "logprobs": lp}, **kw)

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(inputs["logprobs"]))
    _close(tloss, jl)
    _close(tin["logprobs"].grad, jg)
    assert set(tm) == set(jm)
    for k in jm:
        _close(tm[k], jm[k])


@pytest.mark.parametrize("kw", [
    {},
    {"clip_ratio_c": 3.0},
    {"clip_log_ratio_min": -0.2, "clip_log_ratio_max": 0.2},
    {"max_episode_steps": 10, "loss_mask_sum": "rows"},
])
def test_ppo_actor_loss(kw):
    inputs = _loss_inputs(9)
    kw = dict(kw)
    if kw.get("loss_mask_sum") == "rows":
        kw.pop("loss_mask_sum")
        inputs["loss_mask_sum"] = inputs["loss_mask"].sum(-1, keepdims=True).astype(np.float32)
    _compare_loss(tlosses.compute_ppo_actor_loss, jlosses.compute_ppo_actor_loss, inputs,
                  clip_ratio_low=0.2, clip_ratio_high=0.28, **kw)


@pytest.mark.parametrize("case", ["old", "versions", "proximal_dual_threshold"])
def test_decoupled_ppo_actor_loss(case):
    inputs = _loss_inputs(10)
    kw = dict(clip_ratio_low=0.2, clip_ratio_high=0.2)
    r = np.random.default_rng(11)
    if case == "versions":
        inputs["versions"] = np.array([[3], [4], [-1], [2]], np.int32)
        kw["current_version"] = 5.0
    elif case == "proximal_dual_threshold":
        inputs["proximal_logprobs"] = (r.normal(size=(4, 10)) * 0.3 - 1).astype(np.float32)
        kw.update(clip_ratio_c=3.0, behave_weight_threshold=1.5)
    _compare_loss(tlosses.compute_decoupled_ppo_actor_loss,
                  jlosses.compute_decoupled_ppo_actor_loss, inputs, **kw)


def test_registries_name_the_same_estimators_and_losses():
    for name in ("gae", "grpo", "reinpp", "opd", "raw", "grpo_dynamic"):
        assert talg.get_advantage_fn(name).__name__ == jalg.get_advantage_fn(name).__name__
    inputs = {k: _t(v) for k, v in _loss_inputs(12).items()}
    for name in ("actor", "ppo_actor", "decoupled_actor"):
        loss, _ = talg.get_policy_loss_fn(name)(clip_ratio_low=0.2, clip_ratio_high=0.2, **inputs)
        assert torch.isfinite(loss)
    with pytest.raises(KeyError):
        talg.get_policy_loss_fn("critic")
    with pytest.raises(ValueError):
        tlosses.compute_ppo_actor_loss(clip_ratio_low=0.2, clip_ratio_high=0.2,
                                       clip_ratio_c=0.5, **inputs)
