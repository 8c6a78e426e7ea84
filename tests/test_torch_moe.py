"""The port's MoE layer (``ops/moe.py``) and the MoE model family (the MoE
blocks of ``forward_hidden``, the decode step, ``microbatch_loss_with_moe``,
a runner step through ``main_grpo``) against the JAX package, on the CPU.

Inputs come from numpy seeds; one JAX init feeds both sides through
``params_from_numpy``. f32 on both sides, with the JAX matmuls at "highest"
precision: the layer's outputs and aux loss agree within 1e-5, gradients
within 1e-5, a tiny model's hidden states within 1e-4 and its logits within
2e-4 (a few layers of summation-order noise).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlinf_tpu.models.llm import model as JM
from rlinf_tpu.models.llm.config import LLMConfig as JConfig
from rlinf_tpu.ops import moe as JMoE
from rlinf_tpu.training import learner as JL
from rlinf_tpu_torch import main_grpo
from rlinf_tpu_torch.models.llm import model as TM
from rlinf_tpu_torch.models.llm.config import LLMConfig as TConfig
from rlinf_tpu_torch.models.llm.convert import params_from_numpy
from rlinf_tpu_torch.models.llm.quant import QTensor, quantize_params
from rlinf_tpu_torch.ops import moe as TMoE
from rlinf_tpu_torch.ops.cuda import decode_megakernel as TMK
from rlinf_tpu_torch.ops.cuda.geometry import check_kernel_geometry
from rlinf_tpu_torch.training import learner as TL

torch.set_num_threads(2)

D, F, E, K = 32, 48, 8, 2


def _moe_params(seed=0):
    r = np.random.default_rng(seed)
    return {
        "router": (r.standard_normal((D, E)) * 0.5).astype(np.float32),
        "gate": (r.standard_normal((E, D, F)) * 0.1).astype(np.float32),
        "up": (r.standard_normal((E, D, F)) * 0.1).astype(np.float32),
        "down": (r.standard_normal((E, F, D)) * 0.1).astype(np.float32),
    }


def _cfgs(cf, impl):
    kw = dict(num_experts=E, num_experts_per_token=K, capacity_factor=cf, aux_loss_coef=0.01,
              impl=impl)
    return JMoE.MoEConfig(**kw), TMoE.MoEConfig(**kw)


def _x(B=3, S=11, seed=1):
    return np.random.default_rng(seed).standard_normal((B, S, D)).astype(np.float32)


def _jax(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _torch(p, grad=False):
    return {k: torch.from_numpy(v.copy()).requires_grad_(grad) for k, v in p.items()}


# capacity factors: 2.0 keeps every routing (with this seed), 0.5 drops many
LAYER_CASES = [("capacity", 2.0), ("capacity", 0.5), ("dropless", 1.0)]


@pytest.mark.parametrize("impl,cf", LAYER_CASES)
def test_moe_layer_and_overflow_match_jax(impl, cf):
    jm, tm = _cfgs(cf, impl)
    p, x = _moe_params(), _x()
    with jax.default_matmul_precision("highest"):
        jo, ja = JMoE.moe_layer(_jax(p), jnp.asarray(x), jm)
        jof = JMoE.capacity_overflow_frac(_jax(p), jnp.asarray(x), jm)
    to, ta = TMoE.moe_layer(_torch(p), torch.from_numpy(x), tm)
    tof = TMoE.capacity_overflow_frac(_torch(p), torch.from_numpy(x), tm)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)
    np.testing.assert_allclose(float(tof), float(jof), atol=1e-7)
    if impl == "capacity" and cf == 0.5:
        assert float(tof) > 0.2          # the case drops tokens
    if impl == "capacity" and cf == 2.0:
        assert float(tof) == 0.0


def test_capacity_without_drops_equals_dropless():
    """Where capacity drops nothing, the two dispatches compute the same
    outputs and aux loss (in both packages)."""
    p, x = _moe_params(), _x()
    tc, td = _cfgs(2.0, "capacity")[1], _cfgs(2.0, "dropless")[1]
    assert float(TMoE.capacity_overflow_frac(_torch(p), torch.from_numpy(x), tc)) == 0.0
    oc, ac = TMoE.moe_layer(_torch(p), torch.from_numpy(x), tc)
    od, ad = TMoE.moe_layer(_torch(p), torch.from_numpy(x), td)
    np.testing.assert_allclose(oc.numpy(), od.numpy(), atol=1e-6)
    np.testing.assert_allclose(float(ac), float(ad), rtol=1e-6)


def test_dropless_metrics_match_jax():
    jm, tm = _cfgs(1.0, "dropless")
    p, x = _moe_params(2), _x(seed=3)
    with jax.default_matmul_precision("highest"):
        _, _, jmet = JMoE.moe_layer_dropless(_jax(p), jnp.asarray(x), jm)
    _, _, tmet = TMoE.moe_layer_dropless(_torch(p), torch.from_numpy(x), tm)
    assert set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("impl,cf", LAYER_CASES)
def test_moe_gradients_to_every_leaf_match_jax(impl, cf):
    """d/d(params, x) of sum(out * cotangent) + aux, against jax.grad."""
    jm, tm = _cfgs(cf, impl)
    p, x = _moe_params(4), _x(seed=5)
    ct = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)

    def jloss(params, xx):
        out, aux = JMoE.moe_layer(params, xx, jm)
        return jnp.sum(out * ct) + aux

    with jax.default_matmul_precision("highest"):
        jg, jgx = jax.grad(jloss, argnums=(0, 1))(_jax(p), jnp.asarray(x))
    tp = _torch(p, grad=True)
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = TMoE.moe_layer(tp, tx, tm)
    ((out * torch.from_numpy(ct)).sum() + aux).backward()
    for k in p:
        assert np.abs(np.asarray(jg[k])).max() > 0, k
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]), atol=1e-5, err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=1e-5)


def test_bf16_layer_close_to_jax():
    """bf16 activations and weights, f32 router: within 2e-2 of JAX's
    output (bf16 steps of the expert products) and 1e-4 in the aux loss."""
    jm, tm = _cfgs(0.75, "capacity")
    p, x = _moe_params(7), _x(seed=8)
    pb = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    jo, ja = JMoE.moe_layer(pb, jnp.asarray(x, jnp.bfloat16), jm)
    to, ta = TMoE.moe_layer({k: torch.from_numpy(v).bfloat16() for k, v in p.items()},
                            torch.from_numpy(x).bfloat16(), tm)
    assert to.dtype == torch.bfloat16
    np.testing.assert_allclose(to.float().numpy(), np.asarray(jo, np.float32), atol=2e-2)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-4)


def test_top_k_ties_go_to_the_lower_expert():
    """Equal router probabilities: the lower expert index wins, as in
    ``lax.top_k``."""
    _, tm = _cfgs(2.0, "capacity")
    p = _torch(_moe_params())
    p["router"] = torch.zeros(D, E)
    _, topk_probs, topk_idx = TMoE._route(p, torch.ones(5, D), tm)
    assert topk_idx.tolist() == [[0, 1]] * 5
    assert torch.equal(topk_probs, torch.full((5, 2), 0.5))


def test_init_moe_params_seeded_on_the_cpu():
    _, tm = _cfgs(1.5, "capacity")
    a = TMoE.init_moe_params(3, D, F, tm, torch.float32, device="cpu")
    b = TMoE.init_moe_params(3, D, F, tm, torch.float32, device="cpu")
    assert {k: tuple(v.shape) for k, v in a.items()} == {
        "router": (D, E), "gate": (E, D, F), "up": (E, D, F), "down": (E, F, D)}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert 0.015 < float(a["gate"].std()) < 0.025


# ---------------------------------------------------------------------------
# The MoE model family
# ---------------------------------------------------------------------------

def _model_cfgs(impl="capacity", cf=1.0, **kw):
    jcfg = dataclasses.replace(JConfig.tiny(), num_experts=4, num_experts_per_token=2,
                               intermediate_size=48, moe_capacity_factor=cf, moe_impl=impl,
                               qk_norm=True, qkv_bias=False, **kw)
    return jcfg, TConfig(**dataclasses.asdict(jcfg))


def _model_params(jcfg, tcfg, seed=0):
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.array, jp), tcfg, device="cpu")


def test_moe_config_and_init_leaves_match_jax():
    jcfg, tcfg = _model_cfgs("dropless", 1.25)
    assert dataclasses.asdict(tcfg.moe_config) == dataclasses.asdict(jcfg.moe_config)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TM.init_params(tcfg, 0, device="cpu")
    shapes = lambda tree: {k: tuple(v.shape) for k, v in tree["blocks"].items()}
    assert shapes(tp) == shapes(jp)


@pytest.mark.parametrize("impl,cf", [("capacity", 1.0), ("capacity", 0.25), ("dropless", 1.0)])
def test_forward_hidden_with_aux_matches_jax(impl, cf):
    jcfg, tcfg = _model_cfgs(impl, cf)
    jp, tp = _model_params(jcfg, tcfg)
    r = np.random.default_rng(1)
    ids = r.integers(0, tcfg.vocab_size, (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), bool)
    mask[1, :3] = False
    with jax.default_matmul_precision("highest"):
        jh, _, jaux = JM.forward_hidden(jp, jcfg, jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                                        return_aux=True)
    th, _, taux = TM.forward_hidden(tp, tcfg, torch.from_numpy(ids),
                                    attention_mask=torch.from_numpy(mask), return_aux=True)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    assert float(taux) > 0


def test_decode_step_drops_at_the_batch_capacity_as_jax():
    """One packed decode step of a 2-layer MoE model: N = B tokens, so
    capacity = round(B*k/E*cf) = 1 slot an expert at B=3 and cf=0.5, and
    tokens drop as in JAX."""
    jcfg, tcfg = _model_cfgs("capacity", 0.5)
    jp, tp = _model_params(jcfg, tcfg, seed=2)
    r = np.random.default_rng(3)
    B, P = 3, 6
    ids = r.integers(0, tcfg.vocab_size, (B, P)).astype(np.int32)
    mask = np.ones((B, P), bool)
    _, jcache = JM.prefill(jp, jcfg, jnp.asarray(ids), jnp.asarray(mask), P + 2)
    jlayers = JM.packed_cache_from_stacked(jcache)
    tlayers = tuple((torch.from_numpy(np.array(k)), torch.from_numpy(np.array(v)))
                    for k, v in jlayers)
    tok = np.array([5, 9, 1], np.int32)
    plen = np.full((B,), P, np.int32)
    starts = np.zeros((B,), np.int32)
    lengths = np.full((B,), P + 1, np.int32)
    with jax.default_matmul_precision("highest"):
        jh, _ = JM.decode_step_packed(jp, jcfg, jnp.asarray(tok), jlayers, P, jnp.asarray(plen),
                                      jnp.asarray(starts), jnp.asarray(lengths), attn_impl="xla")
    th, _ = TM.decode_step_packed(tp, tcfg, torch.from_numpy(tok), tlayers, P,
                                  torch.from_numpy(plen), torch.from_numpy(starts),
                                  torch.from_numpy(lengths), attn_impl="pallas")
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4)
    assert TMoE.capacity_of(B, tcfg.moe_config) == 1


def test_microbatch_loss_with_moe_matches_jax():
    """The PPO loss plus ``aux * local / global`` and ``actor/moe_aux_loss``
    on one microbatch that holds half of the global valid tokens."""
    jcfg, tcfg = _model_cfgs("capacity", 0.5)
    jp, tp = _model_params(jcfg, tcfg, seed=4)
    r = np.random.default_rng(5)
    B, T = 2, 10
    attn = np.ones((B, T), bool)
    loss_mask = r.random((B, T)) > 0.3
    mb = {
        "input_ids": r.integers(0, tcfg.vocab_size, (B, T)).astype(np.int32),
        "target_ids": r.integers(0, tcfg.vocab_size, (B, T)).astype(np.int32),
        "attention_mask": attn, "loss_mask": loss_mask,
        "old_logprobs": np.where(loss_mask, -5.5 + r.normal(size=(B, T)) * 0.1, 0).astype(np.float32),
        "advantages": (r.normal(size=(B, T)) * loss_mask).astype(np.float32),
    }
    gv = float(loss_mask.sum() * 2)
    cfg = dict(entropy_bonus=1e-2, logprob_chunk_size=8)
    with jax.default_matmul_precision("highest"):
        jl, jmet = JL.microbatch_loss_with_moe(
            jp, jcfg, JL.PolicyLossConfig(**cfg), {k: jnp.asarray(v) for k, v in mb.items()},
            jnp.float32(gv), attn_impl="xla", remat=False)
    tl, tmet = TL.microbatch_loss_with_moe(
        tp, tcfg, TL.PolicyLossConfig(**cfg), {k: torch.from_numpy(v) for k, v in mb.items()},
        torch.tensor(gv), attn_impl="xla", remat=True)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-7)
    assert set(tmet) == set(jmet) and "actor/moe_aux_loss" in tmet
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5, atol=1e-7, err_msg=k)


def test_quantize_keeps_expert_leaves_and_the_megakernel_refuses_moe():
    _, tcfg = _model_cfgs()
    tp = TM.init_params(tcfg, 0, device="cpu")
    q = quantize_params(tp)
    for k in ("moe_router", "moe_gate", "moe_up", "moe_down"):
        assert q["blocks"][k] is tp["blocks"][k]
    assert isinstance(q["blocks"]["wqkv"], QTensor) and "wgu" not in q["blocks"]
    with pytest.raises(ValueError, match="dense-MLP only"):
        TMK.make_plan(tcfg)
    with pytest.raises(ValueError, match="dense-MLP only"):
        check_kernel_geometry(tcfg, "mega")


YAML = "examples/reasoning/config/grpo_demo_tiny.yaml"


@pytest.mark.parametrize("impl", ["capacity", "dropless"])
def test_moe_runner_step_through_main_grpo(tmp_path, impl):
    """One whole GRPO step of a tiny MoE model through ``main_grpo`` on the
    CPU: finite metrics, among them ``actor/moe_aux_loss`` > 0."""
    history = main_grpo.main([
        "--config", YAML, "--device", "cpu", "runner.max_steps=1", "runner.rollout_batch_size=2",
        "model.num_experts=4", "model.num_experts_per_token=2", f"model.moe_impl={impl}",
        "model.qk_norm=true", "model.qkv_bias=false", f"runner.log_dir={tmp_path}"])
    (m,) = history
    assert all(np.isfinite(v) for v in m.values())
    assert m["actor/moe_aux_loss"] > 0
    row = json.loads((tmp_path / "metrics.jsonl").read_text().splitlines()[0])
    assert row["actor/moe_aux_loss"] == pytest.approx(m["actor/moe_aux_loss"])
