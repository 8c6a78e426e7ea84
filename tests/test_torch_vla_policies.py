"""The port's VLA policies against the JAX package's, on the CPU at the JAX
tests' tiny sizes (``tests/test_vla_families.py``): the OFT-style
``VLAPolicy`` and ``OpenVLAPolicy`` with one tower and with two fused
towers, with and without instruction tokens (a padded instruction mask
too), and the int8 ``QTensor`` bin slice.

One init (the port's, with N(0, 0.05) noise on every leaf so that zero
biases, the class tokens and the norms are exercised; its tree held to the
shapes and dtypes of JAX's init by ``jax.eval_shape``) feeds both packages,
the port's side through ``policy.params_from_numpy``. Both sides are f32, so they agree to
summation-order rounding: every test states its tolerance. Deterministic
paths (the Gaussian means, OpenVLA's argmax bins) are held value for value;
sampled ones (threefry against a torch ``Generator``) by the logprob of the
drawn action under JAX's ``default_forward`` and by frequencies.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlinf_tpu.models.embodiment import openvla as jopenvla
from rlinf_tpu.models.embodiment import vla_policy as jvla
from rlinf_tpu.models.embodiment import vit as jvit
from rlinf_tpu.models.llm import quant as jquant
from rlinf_tpu.models.llm.config import LLMConfig as JLLMConfig
from rlinf_tpu_torch.models.embodiment import openvla as topenvla
from rlinf_tpu_torch.models.embodiment import vla_policy as tvla
from rlinf_tpu_torch.models.embodiment import vit as tvit
from rlinf_tpu_torch.models.llm.config import LLMConfig

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _shared_params(tp, jp, seed):
    """(the port's params, JAX's params): ``tp.init`` from ``seed`` plus
    N(0, 0.05) noise on every leaf, after checking that its tree has the
    keys, shapes and dtypes of JAX's init."""
    base = jax.tree_util.tree_map(
        lambda a: a.numpy(), tp.init(torch.Generator().manual_seed(seed), device="cpu"))
    want = jax.eval_shape(jp.init, jax.random.PRNGKey(seed))
    desc = lambda t: jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)), t)
    assert desc(base) == desc(want)
    r = np.random.default_rng(seed)
    noisy = jax.tree_util.tree_map(
        lambda a: (a + r.normal(0, 0.05, a.shape)).astype(a.dtype), base)
    return tp.params_from_numpy(noisy, device="cpu"), jax.tree_util.tree_map(jnp.asarray, noisy)


def _jobs(obs):
    return {k: jnp.asarray(v) for k, v in obs.items()}


def _tobs(obs):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in obs.items()}


class _Jitted:
    """A JAX policy's functions under ``jax.jit`` (eager JAX costs seconds a
    call at these sizes); the deterministic predict takes no key."""

    def __init__(self, jp):
        self.default_forward = jax.jit(jp.default_forward)
        self.value = jax.jit(jp.value)
        det = jax.jit(functools.partial(jp.predict_action_batch, deterministic=True))
        self.predict_det = lambda params, obs: det(params, jax.random.PRNGKey(0), obs)


def _close(got, want, what, **tol):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **(tol or TOL))


# ---------------------------------------------------------------------------
# the OFT-style VLA
# ---------------------------------------------------------------------------

VLA = dict(image_size=32, patch_size=8, action_dim=2, action_chunk=3, proprio_dim=2,
           hidden=32, trunk_layers=2, vit_layers=1, heads=4, init_logstd=-0.5)


def _vla_pair():
    jp, tp = jvla.VLAPolicy(**VLA), tvla.VLAPolicy(**VLA)
    tparams, jparams = _shared_params(tp, jp, 0)
    return tp, tparams, jp, jparams


def _vla_obs(B=3, seed=0):
    r = np.random.default_rng(seed)
    return {"images": r.uniform(size=(B, 32, 32, 3)).astype(np.float32),
            "states": r.normal(size=(B, 2)).astype(np.float32)}


def test_vla_policy_matches_jax():
    """default_forward (flat and [B, K, A] actions), value and the
    deterministic chunk against JAX's (rtol/atol 1e-4); sampled chunks' logprobs hold under JAX's
    default_forward (atol 1e-4) and their noise is N(0, 1) (mean within
    0.1, std within 0.1 of 1 over 600 draws)."""
    tp, tparams, jp, jparams = _vla_pair()
    jf = _Jitted(jp)
    obs = _vla_obs()
    acts = np.random.default_rng(1).normal(size=(3, 6)).astype(np.float32)
    for a in (acts, acts.reshape(3, 3, 2)):
        t_fwd = tp.default_forward(tparams, _tobs(obs), torch.as_tensor(a))
        j_fwd = jf.default_forward(jparams, _jobs(obs), jnp.asarray(a))
        for k in ("logprobs", "entropy", "values"):
            _close(t_fwd[k], j_fwd[k], k)
    _close(tp.value(tparams, _tobs(obs)), jf.value(jparams, _jobs(obs)), "value")
    t_det = tp.predict_action_batch(tparams, None, _tobs(obs), deterministic=True)
    j_det = jf.predict_det(jparams, _jobs(obs))
    for f in ("actions", "logprobs", "values"):
        _close(getattr(t_det, f), getattr(j_det, f), f)
    many = {k: np.repeat(v, 100, axis=0) for k, v in obs.items()}
    t_s = tp.predict_action_batch(tparams, torch.Generator().manual_seed(3), _tobs(many))
    j_lp = jf.default_forward(jparams, _jobs(many), jnp.asarray(_np(t_s.actions)))["logprobs"]
    _close(t_s.logprobs, j_lp, "sampled logprobs", atol=1e-4)
    z = (_np(t_s.actions) - np.repeat(_np(t_det.actions), 100, axis=0)) / np.exp(-0.5)
    assert abs(z.mean()) < 0.1 and abs(z.std() - 1.0) < 0.1


# ---------------------------------------------------------------------------
# OpenVLA
# ---------------------------------------------------------------------------

LLM = dict(vocab_size=96, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
           num_kv_heads=2, max_seq_len=64, dtype="float32")
TOWER = dict(image_size=32, patch_size=16, hidden=32, layers=1, heads=2, timm_style=True,
             cls_token=True)
#: the second tower of the fused backbone: another width, the same patch grid
TOWER2 = dict(image_size=32, patch_size=16, hidden=48, layers=1, heads=4, timm_style=True,
              cls_token=True)
BINS = 16


def _openvla_pair(fused: bool, untied: bool = False, seed: int = 0):
    cfg = dict(action_dim=3, action_bins=BINS)
    llm = dict(LLM, tie_word_embeddings=not untied)
    jp = jopenvla.OpenVLAPolicy(
        jopenvla.OpenVLAConfig(**cfg), JLLMConfig(**llm), jvit.ViTConfig(**TOWER),
        jvit.ViTConfig(**TOWER2) if fused else None)
    tp = topenvla.OpenVLAPolicy(
        topenvla.OpenVLAConfig(**cfg), LLMConfig(**llm), tvit.ViTConfig(**TOWER),
        tvit.ViTConfig(**TOWER2) if fused else None)
    tparams, jparams = _shared_params(tp, jp, seed)
    return tp, tparams, jp, jparams


def _openvla_obs(text: str, B=2, seed=0):
    r = np.random.default_rng(seed)
    obs = {"images": r.uniform(size=(B, 32, 32, 3)).astype(np.float32)}
    if text != "none":
        # instruction ids below the bin slice, as the JAX test keeps them
        obs["instruction_ids"] = r.integers(0, LLM["vocab_size"] - BINS, (B, 4)).astype(np.int32)
        mask = np.ones((B, 4), bool)
        if text == "padded":
            mask[0, :2] = False
        obs["instruction_mask"] = mask
    return obs


@pytest.mark.parametrize("text", ["none", "full", "padded"])
@pytest.mark.parametrize("fused", [False, True], ids=["one_tower", "fused_towers"])
def test_openvla_matches_jax(fused, text):
    """default_forward on random bins, value, and the deterministic
    prefill + cached bin decode against JAX's: logprobs, entropy and
    values within 1e-4, greedy bins equal. A padded instruction mask takes
    the reference's positions quirk in both packages alike."""
    tp, tparams, jp, jparams = _openvla_pair(fused)
    jf = _Jitted(jp)
    obs = _openvla_obs(text)
    bins = np.random.default_rng(2).integers(0, BINS, (2, 3)).astype(np.float32)
    t_fwd = tp.default_forward(tparams, _tobs(obs), torch.as_tensor(bins))
    j_fwd = jf.default_forward(jparams, _jobs(obs), jnp.asarray(bins))
    for k in ("logprobs", "entropy", "values"):
        _close(t_fwd[k], j_fwd[k], k)
    _close(tp.value(tparams, _tobs(obs)), jf.value(jparams, _jobs(obs)), "value")
    t_det = tp.predict_action_batch(tparams, None, _tobs(obs), deterministic=True)
    j_det = jf.predict_det(jparams, _jobs(obs))
    np.testing.assert_array_equal(_np(t_det.actions), _np(j_det.actions))
    _close(t_det.logprobs, j_det.logprobs, "greedy logprobs")
    _close(t_det.values, j_det.values, "values")
    if text != "padded":
        # greedy bins teacher-forced: their logprobs are the decode's (the
        # KV-cached decode and the full forward agree), as
        # tests/test_vla_families.py holds in JAX
        tf = tp.default_forward(tparams, _tobs(obs), t_det.actions)["logprobs"]
        _close(tf, t_det.logprobs, "teacher-forced greedy")


@pytest.mark.parametrize("fused", [False, True], ids=["one_tower", "fused_towers"])
def test_openvla_sampled_bins_hold_under_jax(fused):
    """Bins sampled from the port's generator (Gumbel-max over the bin
    slice): their logprobs equal JAX's default_forward of them (atol 1e-4),
    and over 512 rows of one observation the first bin's frequencies are
    within 0.08 (total variation) of JAX's probabilities."""
    tp, tparams, jp, jparams = _openvla_pair(fused, seed=1)
    obs = {k: np.repeat(v[:1], 512, axis=0) for k, v in _openvla_obs("full").items()}
    out = tp.predict_action_batch(tparams, torch.Generator().manual_seed(4), _tobs(obs))
    bins = _np(out.actions)
    assert bins.shape == (512, 3) and ((bins >= 0) & (bins < BINS)).all()
    assert out.values.shape == (512,)
    j_lp = jax.jit(jp.default_forward)(jparams, _jobs(obs), jnp.asarray(bins))["logprobs"]
    _close(out.logprobs, j_lp, "sampled logprobs", atol=1e-4)

    def first_bin(params, o):
        embeds, valid = jp._prefix(params, o)
        h, _ = jopenvla.forward_hidden(params["vlm"], jp.vlm_cfg, None, inputs_embeds=embeds,
                                       attention_mask=valid)
        return jp._bin_logprobs(h[:, -1], params)

    one = _jobs({k: v[:1] for k, v in obs.items()})
    p0 = np.exp(_np(jax.jit(first_bin)(jparams, one))[0])
    freq = np.bincount(bins[:, 0].astype(int), minlength=BINS) / len(bins)
    assert 0.5 * np.abs(freq - p0).sum() < 0.08


def test_openvla_int8_bin_slice_matches_jax():
    """The int8 trunk (``quantize_params`` of an untied decoder): the
    dequantized bin slice's logprobs and the deterministic decode on the
    quantized tree against JAX's (1e-4; greedy bins equal)."""
    tp, _, jp, jparams = _openvla_pair(False, untied=True, seed=2)
    jq = dict(jparams, vlm=jquant.quantize_params(jparams["vlm"]))
    tq = tp.params_from_numpy(jax.tree_util.tree_map(np.asarray, jq), device="cpu")
    assert type(tq["vlm"]["lm_head"]).__name__ == "QTensor"
    h = np.random.default_rng(5).normal(size=(4, LLM["hidden_size"])).astype(np.float32)
    _close(tp._bin_logprobs(torch.as_tensor(h), tq), jp._bin_logprobs(jnp.asarray(h), jq),
           "int8 bin logprobs")
    obs = _openvla_obs("full")
    t_det = tp.predict_action_batch(tq, None, _tobs(obs), deterministic=True)
    j_det = _Jitted(jp).predict_det(jq, _jobs(obs))
    np.testing.assert_array_equal(_np(t_det.actions), _np(j_det.actions))
    _close(t_det.logprobs, j_det.logprobs, "int8 greedy logprobs")


def test_openvla_env_actions_and_init():
    """Bin centers and the (low, high) de-normalization equal JAX's bit
    for bit; the fused init's tree has JAX's keys, shapes and dtypes; a tower
    pair with different grids and too small a vocabulary are refused."""
    kw = dict(action_dim=2, action_bins=4, action_low=(0.0, -2.0), action_high=(1.0, 2.0))
    acts = np.array([[0.0, 3.0], [1.0, 2.0]], np.float32)
    for extra in ({}, kw):
        cfg = dict(dict(action_dim=2, action_bins=4), **extra)
        t = topenvla.OpenVLAPolicy(topenvla.OpenVLAConfig(**cfg)).env_actions(
            torch.as_tensor(acts))
        j = jopenvla.OpenVLAPolicy(jopenvla.OpenVLAConfig(**cfg)).env_actions(jnp.asarray(acts))
        np.testing.assert_array_equal(_np(t), _np(j))
    _openvla_pair(True)  # the init's tree against JAX's
    with pytest.raises(ValueError, match="same patch grid"):
        topenvla.OpenVLAPolicy(vit2_cfg=tvit.ViTConfig(image_size=32, patch_size=8, hidden=16,
                                                       layers=1, heads=2))
    with pytest.raises(ValueError, match="must exceed"):
        topenvla.OpenVLAPolicy(topenvla.OpenVLAConfig(action_bins=512))
