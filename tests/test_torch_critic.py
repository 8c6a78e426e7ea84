"""The port's PPO-critic slice against the JAX package, on the CPU: the
value head, the clipped-value critic loss, the actor-critic, decoupled
actor-critic and OPD losses, one separate-critic step and one shared-head
actor-critic step.

One JAX init feeds both sides through ``params_from_numpy``; batches and
loss inputs are drawn with numpy from a seed. Tolerances are stated per
test: fp32 on both sides, so the two agree to summation-order rounding
(losses 1e-6, a step's loss and metrics 1e-5, params 1e-6). A bf16 trunk
rounds its intermediates at other places in the two frameworks, so its
values agree to a few bf16 steps of the hidden states (3e-3); the f32 head
on the same hidden states agrees to 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rlinf_tpu.algorithms as jalg
from rlinf_tpu.algorithms import losses as jlosses
from rlinf_tpu.models.llm import model as JM
from rlinf_tpu.models.llm import value_head as JV
from rlinf_tpu.models.llm.config import LLMConfig as JConfig
from rlinf_tpu.training import critic as JC
from rlinf_tpu.training import learner as JL
from rlinf_tpu.training import train_state as JS
import rlinf_tpu_torch.algorithms as talg
from rlinf_tpu_torch.algorithms import losses as tlosses
from rlinf_tpu_torch.models.llm import value_head as TV
from rlinf_tpu_torch.models.llm.config import LLMConfig as TConfig
from rlinf_tpu_torch.models.llm.convert import params_from_numpy, tensor_from_numpy
from rlinf_tpu_torch.training import critic as TC
from rlinf_tpu_torch.training import learner as TL
from rlinf_tpu_torch.training import train_state as TS

torch.set_num_threads(2)

TOL = dict(rtol=1e-6, atol=1e-6)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _configs(dtype="float32"):
    jcfg = dataclasses.replace(JConfig.tiny(), dtype=dtype)
    return jcfg, TConfig(**dataclasses.asdict(jcfg))


def _assert_trees_close(got, want, **tol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_trees_close(got[k], want[k], **tol)
    else:
        np.testing.assert_allclose(_np(got), _np(want), **tol)


def _batch(cfg, B=4, T=16, seed=0):
    """Right-padded rows with the critic's returns and previous values."""
    r = np.random.default_rng(seed)
    lens = r.integers(T // 2, T + 1, B)
    lens[0] = T
    attn = np.arange(T)[None, :] < lens[:, None]
    loss_mask = attn & (r.random((B, T)) > 0.3)
    return {
        "input_ids": np.where(attn, r.integers(0, cfg.vocab_size, (B, T)), 0).astype(np.int32),
        "target_ids": r.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
        "attention_mask": attn,
        "loss_mask": loss_mask,
        "old_logprobs": np.where(loss_mask, -np.log(cfg.vocab_size) + r.normal(size=(B, T)) * 0.1,
                                 0).astype(np.float32),
        "advantages": (r.normal(size=(B, T)) * loss_mask).astype(np.float32),
        "returns": (r.normal(size=(B, T)) * loss_mask).astype(np.float32),
        "prev_values": (r.normal(size=(B, T)) * 0.05 * loss_mask).astype(np.float32),
    }


# --- value head -------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_values_matches_jax(dtype):
    """A JAX trunk with ``add_value_head``, converted: the port's f32
    values equal JAX's (fp32 1e-5, bf16 3e-3), the head on JAX's own hidden
    states equals JAX's einsum (1e-6), and ``params_from_numpy`` carries
    the f32 [D, 1] head across unchanged."""
    jcfg, tcfg = _configs(dtype)
    jp = JV.add_value_head(JM.init_params(jcfg, jax.random.PRNGKey(0)), jcfg,
                           jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    assert tp["value_head"].dtype == torch.float32 and tuple(tp["value_head"].shape) == (64, 1)
    np.testing.assert_array_equal(_np(tp["value_head"]), np.asarray(jp["value_head"]))
    b = _batch(tcfg, seed=1)
    jv = JV.forward_values(jp, jcfg, jnp.asarray(b["input_ids"]), jnp.asarray(b["attention_mask"]))
    tv = TV.forward_values(tp, tcfg, _t(b["input_ids"]), _t(b["attention_mask"]))
    assert tv.dtype == torch.float32 and tv.shape == (4, 16)
    valid = b["attention_mask"]
    tol = 1e-5 if dtype == "float32" else 3e-3
    np.testing.assert_allclose(_np(tv) * valid, _np(jv) * valid, rtol=tol, atol=tol)
    jh, _ = JM.forward_hidden(jp, jcfg, jnp.asarray(b["input_ids"]),
                              attention_mask=jnp.asarray(b["attention_mask"]))
    got = TV.values_from_hidden(tp, tensor_from_numpy(np.asarray(jh), device="cpu"))
    want = jnp.einsum("bsd,do->bso", jh, jp["value_head"], preferred_element_type=jnp.float32)
    np.testing.assert_allclose(_np(got), _np(want[..., 0]), rtol=1e-6, atol=1e-6)


def test_init_value_head_is_small_f32_and_seeded():
    _, tcfg = _configs()
    a = TV.init_value_head(tcfg, 3, device="cpu")
    b = TV.init_value_head(tcfg, 3, device="cpu")
    assert a.dtype == torch.float32 and tuple(a.shape) == (tcfg.hidden_size, 1)
    assert torch.equal(a, b) and 0 < a.abs().max() < 0.06
    p = TV.add_value_head({"x": torch.zeros(1)}, tcfg, 3, device="cpu")
    assert set(p) == {"x", "value_head"} and torch.equal(p["value_head"], a)


# --- losses -----------------------------------------------------------------------

def _loss_inputs(seed, B=4, N=10):
    r = np.random.default_rng(seed)
    mask = r.random((B, N)) > 0.25
    mask[0, 0] = True
    return {
        "logprobs": (r.normal(size=(B, N)) * 0.3 - 1).astype(np.float32),
        "old_logprobs": (r.normal(size=(B, N)) * 0.3 - 1).astype(np.float32),
        "advantages": r.normal(size=(B, N)).astype(np.float32),
        "loss_mask": mask,
        "values": (r.normal(size=(B, N)) * 0.5).astype(np.float32),
        "returns": r.normal(size=(B, N)).astype(np.float32),
        "prev_values": (r.normal(size=(B, N)) * 0.5).astype(np.float32),
    }


def _compare(tfn, jfn, inputs, grad_key, **kw):
    """Loss, metrics and the gradient of ``grad_key`` within TOL."""
    tin = {k: _t(v) for k, v in inputs.items()}
    tin[grad_key] = tin[grad_key].clone().requires_grad_(True)
    tloss, tm = tfn(**tin, **kw)
    tloss.backward()

    def jloss(x):
        return jfn(**{**{k: jnp.asarray(v) for k, v in inputs.items()}, grad_key: x}, **kw)

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(inputs[grad_key]))
    np.testing.assert_allclose(_np(tloss), _np(jl), **TOL)
    np.testing.assert_allclose(_np(tin[grad_key].grad), _np(jg), **TOL)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(_np(tm[k]), _np(jm[k]), **TOL, err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(value_clip=0.2, huber_delta=10.0),
    dict(value_clip=0.05, huber_delta=0.5),
    dict(value_clip=0.2, huber_delta=1.0, max_episode_steps=8, loss_mask_sum="rows"),
])
def test_ppo_critic_loss(kw):
    """Clipped-value huber loss (both huber branches and clipping active),
    its clip ratio and explained variance, and d loss / d values."""
    inputs = _loss_inputs(20)
    kw = dict(kw)
    if kw.get("loss_mask_sum") == "rows":
        inputs["loss_mask_sum"] = inputs["loss_mask"].sum(-1, keepdims=True).astype(np.float32)
        kw.pop("loss_mask_sum")
    _compare(tlosses.compute_ppo_critic_loss, jlosses.compute_ppo_critic_loss, inputs, "values",
             **kw)


@pytest.mark.parametrize("name", ["actor_critic", "decoupled_actor_critic"])
@pytest.mark.parametrize("grad_key", ["logprobs", "values"])
def test_actor_critic_registry_losses(name, grad_key):
    """The registered actor + critic losses, through each registry."""
    inputs = _loss_inputs(21)
    if name == "decoupled_actor_critic":
        inputs["proximal_logprobs"] = (inputs["old_logprobs"] + 0.05).astype(np.float32)
    _compare(talg.get_policy_loss_fn(name), jalg.get_policy_loss_fn(name), inputs, grad_key,
             clip_ratio_low=0.2, clip_ratio_high=0.28, value_clip=0.1, huber_delta=1.0)


@pytest.mark.parametrize("rows", [False, True])
def test_opd_loss(rows):
    """OPD: -logprob x detached reward, with a per-row mask and the
    loss-mask-ratio aggregation."""
    inputs = {k: v for k, v in _loss_inputs(22).items() if k in ("logprobs", "advantages",
                                                                  "loss_mask")}
    kw = {}
    if rows:
        inputs["loss_mask_sum"] = inputs["loss_mask"].sum(-1).astype(np.float32)
        kw["max_episode_steps"] = 12
    _compare(talg.get_policy_loss_fn("opd"), jalg.get_policy_loss_fn("opd"), inputs, "logprobs",
             **kw)


def test_registries_name_the_critic_losses():
    for name in ("actor_critic", "decoupled_actor_critic", "opd"):
        assert talg.get_policy_loss_fn(name).__name__ == jalg.get_policy_loss_fn(name).__name__


# --- steps ------------------------------------------------------------------------

OPT = dict(lr=1e-3, eps=1e-3, weight_decay=0.01)


@pytest.mark.parametrize("remat,impl", [(True, "xla"), (False, "pallas")])
def test_critic_train_step_matches_jax(remat, impl):
    """One separate-critic step at LLMConfig.tiny, fp32, adamw (eps 1e-3,
    as the policy-step test takes it): the critic's metrics within 1e-5
    (grad norm 1e-4 relative) and its params after the update within 1e-6;
    the value fn's values within 1e-5."""
    jcfg, tcfg = _configs()
    jp = JC.init_critic_params(jcfg, jax.random.PRNGKey(5))
    p0 = jax.tree_util.tree_map(np.array, jp)
    tp = params_from_numpy(p0, tcfg, device="cpu")
    batch = _batch(tcfg, seed=6)
    ccfg = dict(value_clip=0.1, huber_delta=1.0)

    jv = JC.make_critic_value_fn(jcfg)(jp, jnp.asarray(batch["input_ids"]),
                                       jnp.asarray(batch["attention_mask"]))
    tv = TC.make_critic_value_fn(tcfg, attn_impl=impl, device="cpu")(
        tp, batch["input_ids"], batch["attention_mask"])
    valid = batch["attention_mask"]
    np.testing.assert_allclose(_np(tv) * valid, _np(jv) * valid, atol=1e-5)

    jtx = JS.make_optimizer(JS.OptimizerConfig(**OPT))
    jstep = JC.make_critic_train_step(jcfg, JC.CriticConfig(**ccfg), jtx, remat=remat)
    jstate, jm = jstep(JS.TrainState(jnp.zeros((), jnp.int32), jp, jtx.init(jp)),
                       {k: jnp.asarray(v) for k, v in batch.items()})
    ttx = TS.make_optimizer(TS.OptimizerConfig(**OPT))
    tstep = TC.make_critic_train_step(tcfg, TC.CriticConfig(**ccfg), ttx, remat=remat,
                                      attn_impl=impl, device="cpu")
    tstate, tm = tstep(TS.TrainState(0, tp, ttx.init(tp)), batch)
    assert tstate.step == 1 and set(tm) == set(jm)
    for k in jm:
        rtol = 1e-4 if k == "critic/grad_norm" else 1e-5
        np.testing.assert_allclose(_np(tm[k]), _np(jm[k]), rtol=rtol, atol=1e-5, err_msg=k)
    assert _np(jm["critic/grad_norm"]) > 0
    _assert_trees_close(tstate.params, jstate.params, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("value_coef,impl", [(1.0, "xla"), (0.5, "pallas")])
def test_actor_critic_train_step_matches_jax(value_coef, impl):
    """One shared-head actor-critic step at LLMConfig.tiny, fp32, with an
    entropy bonus: loss and every metric within 1e-5 (grad norm 1e-4
    relative), params (the value head included) within 1e-6."""
    jcfg, tcfg = _configs()
    jp = JV.add_value_head(JM.init_params(jcfg, jax.random.PRNGKey(7)), jcfg,
                           jax.random.PRNGKey(8))
    p0 = jax.tree_util.tree_map(np.array, jp)
    tp = params_from_numpy(p0, tcfg, device="cpu")
    batch = _batch(tcfg, seed=9)
    loss_cfg = dict(entropy_bonus=1e-2, logprob_chunk_size=8)
    kw = dict(value_clip=0.1, huber_delta=1.0, value_coef=value_coef)

    jtx = JS.make_optimizer(JS.OptimizerConfig(**OPT))
    jstep = JL.make_actor_critic_train_step(jcfg, JL.PolicyLossConfig(**loss_cfg), jtx,
                                            remat=True, **kw)
    jstate, jm = jstep(JS.TrainState(jnp.zeros((), jnp.int32), jp, jtx.init(jp)),
                       {k: jnp.asarray(v) for k, v in batch.items()})
    ttx = TS.make_optimizer(TS.OptimizerConfig(**OPT))
    tstep = TL.make_actor_critic_train_step(tcfg, TL.PolicyLossConfig(**loss_cfg), ttx,
                                            remat=True, attn_impl=impl, device="cpu", **kw)
    tstate, tm = tstep(TS.TrainState(0, tp, ttx.init(tp)), batch)
    assert tstate.step == 1 and set(tm) == set(jm)
    assert any(k.startswith("critic/") for k in tm)
    for k in jm:
        rtol = 1e-4 if k == "actor/grad_norm" else 1e-5
        np.testing.assert_allclose(_np(tm[k]), _np(jm[k]), rtol=rtol, atol=1e-5, err_msg=k)
    _assert_trees_close(tstate.params, jstate.params, rtol=1e-6, atol=1e-6)
    assert not np.allclose(_np(tstate.params["value_head"]), p0["value_head"])


def test_critic_steps_need_a_card_unless_asked_for_cpu(monkeypatch):
    _, tcfg = _configs()
    tx = TS.make_optimizer(TS.OptimizerConfig())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: TC.make_critic_train_step(tcfg, TC.CriticConfig(), tx),
                 lambda: TC.make_critic_value_fn(tcfg),
                 lambda: TL.make_actor_critic_train_step(tcfg, TL.PolicyLossConfig(), tx),
                 lambda: TC.init_critic_params(tcfg, 0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_a_params_dict_with_a_value_head_goes_through_the_serving_and_checkpoint_paths(tmp_path):
    """The shared head's params (a ``value_head`` leaf beside the trunk):
    ``quantize_params`` and the megakernel's packing leave the head alone
    and decode as without it; ``CheckpointManager`` saves and restores it
    bitwise."""
    from rlinf_tpu_torch.models.llm import model as TM
    from rlinf_tpu_torch.models.llm.quant import quantize_params
    from rlinf_tpu_torch.ops.cuda import decode_megakernel as TMK
    from rlinf_tpu_torch.utils.checkpoint import CheckpointManager

    _, tcfg = _configs()
    base = TM.init_params(tcfg, 3, device="cpu")
    params = TV.add_value_head(base, tcfg, 4, device="cpu")
    q = quantize_params(params)
    assert torch.equal(q["value_head"], params["value_head"])
    assert set(q) - {"value_head"} == set(quantize_params(base))
    plan, mw = TMK.pack_decode_weights(q, tcfg)
    plan0, mw0 = TMK.pack_decode_weights(quantize_params(base), tcfg)
    assert plan == plan0 and torch.equal(mw.stream, mw0.stream)
    ck = CheckpointManager(str(tmp_path / "ck"))
    state = TS.create_train_state(lambda: params, TS.make_optimizer(TS.OptimizerConfig()))
    ck.save(1, state)
    got, _, step = ck.restore(TS.create_train_state(
        lambda: TV.add_value_head(TM.init_params(tcfg, 5, device="cpu"), tcfg, 6, device="cpu"),
        TS.make_optimizer(TS.OptimizerConfig())))
    assert step == 1 and torch.equal(got.params["value_head"], params["value_head"])
