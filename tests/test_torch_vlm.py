"""The port's VLM reasoning stack against the JAX package's, on the CPU at
the JAX tests' tiny sizes (``tests/test_e2e_vlm_reasoning.py``: a 2-layer
f32 decoder of width 48 over the byte vocabulary, a 1-layer ViT of width 32
on 32x32 images): the ViT, the MLP policy helpers, ``forward_hidden`` with
``inputs_embeds`` and ``mask_positions``, the unpacked KV-cache decode steps
(writes at the last slot and past the end included), the VLM's forward and
greedy generate on a left-padded batch, one GRPO train step fed the JAX
runner's batch, two SFT steps, the VQA dataset, the colour task's learning,
a resume and ``main_vlm_grpo``.

One JAX init feeds both packages through ``vlm_params_from_numpy`` (or
``params_from_numpy`` for the decoder alone). Both sides are f32, so they
agree to summation-order rounding; each test states its tolerance.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlinf_tpu import config as jconfig
from rlinf_tpu.data import datasets as jdata
from rlinf_tpu.data.tokenizers import ByteTokenizer as JTokenizer
from rlinf_tpu.models.embodiment import mlp_policy as jmlp
from rlinf_tpu.models.embodiment import vit as jvit
from rlinf_tpu.models.llm import model as JM
from rlinf_tpu.models.llm.config import LLMConfig as JLLMConfig
from rlinf_tpu.models.llm.sampler import SamplingParams as JSamplingParams
from rlinf_tpu.models.vlm import VLMReasoningModel as JVLM
from rlinf_tpu.runners.vlm_reasoning_runner import VLMReasoningRunner as JRunner
from rlinf_tpu.runners.vlm_sft_runner import VLMSFTRunner as JSFTRunner
from rlinf_tpu.training.learner import PolicyLossConfig as JLossConfig
from rlinf_tpu.training.train_state import OptimizerConfig as JOptConfig
from rlinf_tpu_torch import config as tconfig
from rlinf_tpu_torch import main_vlm_grpo
from rlinf_tpu_torch.data import datasets as tdata
from rlinf_tpu_torch.data.tokenizers import ByteTokenizer
from rlinf_tpu_torch.models.embodiment import mlp_policy as tmlp
from rlinf_tpu_torch.models.embodiment import vit as tvit
from rlinf_tpu_torch.models.llm import model as TM
from rlinf_tpu_torch.models.llm.config import LLMConfig
from rlinf_tpu_torch.models.llm.convert import params_from_numpy, tensor_from_numpy
from rlinf_tpu_torch.models.llm.sampler import SamplingParams
from rlinf_tpu_torch.models.vlm import VLMReasoningModel, vlm_params_from_numpy
from rlinf_tpu_torch.runners import VLMReasoningRunner
from rlinf_tpu_torch.runners.vlm_sft_runner import VLMSFTRunner
from rlinf_tpu_torch.training.learner import PolicyLossConfig
from rlinf_tpu_torch.training.train_state import OptimizerConfig
from rlinf_tpu_torch.utils.checkpoint import flatten

torch.set_num_threads(2)

COLORS = {"r": (1.0, 0.1, 0.1), "g": (0.1, 1.0, 0.1), "b": (0.1, 0.1, 1.0)}
#: the JAX tests' decoder (tests/test_e2e_vlm_reasoning.py)
LLM = dict(vocab_size=258, hidden_size=48, intermediate_size=96, num_layers=2, num_heads=2,
           num_kv_heads=2, max_seq_len=128, dtype="float32")
VIT = dict(image_size=32, patch_size=16, hidden=32, layers=1, heads=2)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _t(a):
    return tensor_from_numpy(np.asarray(a), device="cpu")


def _assert_trees_close(got, want, **tol):
    fg, fw = flatten(got), flatten(jax.tree_util.tree_map(np.asarray, want))
    assert fg.keys() == fw.keys()
    for k in fg:
        np.testing.assert_allclose(_np(fg[k]), _np(fw[k]), err_msg=k, **tol)


def _perturbed(tree, seed):
    """``tree`` (numpy leaves) plus N(0, 0.1) noise on every leaf, so that the
    zero-initialised biases, class token and norms are exercised."""
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + r.normal(0, 0.1, np.shape(a))).astype(np.float32), tree)


def _color_dataset(pkg, n=48, seed=0):
    """The JAX test's colour task, as ``pkg``'s VQA dataset."""
    rng = np.random.default_rng(seed)
    examples = []
    for i in range(n):
        c = list(COLORS)[i % 3]
        img = np.ones((32, 32, 3), np.float32) * np.asarray(COLORS[c])
        img += rng.normal(0, 0.05, img.shape).astype(np.float32)
        examples.append(pkg.VQAExample(image=np.clip(img, 0, 1), question="what color?",
                                       answers=[c]))
    return pkg.VQADataset(examples)


def _color_char_reward(texts, answer_lists):
    """The JAX test's reward: fraction of generated chars equal to the image's
    colour letter."""
    return [sum(c == ans[0] for c in t) / max(len(t), 1) for t, ans in zip(texts, answer_lists)]


def _odd_reward(texts, answers):
    """1.0 where more than half of a text's characters have an odd code
    point: mixed on random text, so the advantages are not all zero."""
    return [float(sum(ord(c) % 2 for c in t) * 2 > len(t)) for t in texts]


def _cfgs(max_steps=50, lr=4e-3, rollout_batch_size=6, new_tokens=4, **runner):
    """The JAX test's TrainerConfig, in both packages."""
    out = []
    for c, llm, sp, opt, loss in (
            (jconfig, JLLMConfig, JSamplingParams, JOptConfig, JLossConfig),
            (tconfig, LLMConfig, SamplingParams, OptimizerConfig, PolicyLossConfig)):
        out.append(c.TrainerConfig(
            model=llm(**LLM),
            sampling=sp(max_new_tokens=new_tokens, temperature=1.0, eos_token_id=-1,
                        pad_token_id=0),
            optimizer=opt(lr=lr, clip_grad=1.0),
            loss=loss(clip_ratio_low=0.2, clip_ratio_high=0.2, entropy_bonus=0.001),
            algorithm=c.AlgorithmConfig(adv_type="grpo", group_size=8),
            runner=c.RunnerConfig(rollout_batch_size=rollout_batch_size, max_steps=max_steps,
                                  seed=0, task_type="reasoning", **runner),
            data=c.DataConfig(max_prompt_len=16),
        ))
    return out


def _models():
    return (JVLM(vlm_cfg=JLLMConfig(**LLM), vit_cfg=jvit.ViTConfig(**VIT)),
            VLMReasoningModel(vlm_cfg=LLMConfig(**LLM), vit_cfg=tvit.ViTConfig(**VIT)))


def _vlm_params(jmodel, seed=0):
    """One JAX init, as numpy (``jparams``) and as the port's tensors."""
    jparams = jax.device_get(jmodel.init(jax.random.PRNGKey(seed)))
    return jparams, vlm_params_from_numpy(jparams, LLMConfig(**LLM), device="cpu")


def _left_padded_batch(seed=0, B=4):
    """Images, and the questions "what color?" / "hue?" left-padded to one
    width (rows of different prompt lengths)."""
    r = np.random.default_rng(seed)
    images = r.uniform(0, 1, (B, 32, 32, 3)).astype(np.float32)
    tok = JTokenizer()
    qs = [tok.encode("what color?" if i % 2 else "hue?") for i in range(B)]
    W = max(map(len, qs))
    ids = np.zeros((B, W), np.int32)
    mask = np.zeros((B, W), bool)
    for i, q in enumerate(qs):
        ids[i, W - len(q):] = q
        mask[i, W - len(q):] = True
    return images, ids, mask


# ---------------------------------------------------------------------------
# models/embodiment
# ---------------------------------------------------------------------------

VIT_CASES = {
    "default": (dict(image_size=32, patch_size=8, hidden=32, layers=2, heads=4), np.float32),
    "timm_cls": (dict(image_size=32, patch_size=8, hidden=32, layers=2, heads=4,
                      timm_style=True, cls_token=True), np.float32),
    "uint8": (dict(image_size=32, patch_size=8, hidden=32, layers=2, heads=4), np.uint8),
}


@pytest.mark.parametrize("case", list(VIT_CASES))
def test_vit_encode_matches_jax(case):
    """vit_encode on the same (perturbed) params and images: f32, atol 1e-5;
    the tanh GELU of the default tower, the erf GELU, LayerNorm's biased
    variance and the class token of the timm-style one, uint8 input."""
    kw, dtype = VIT_CASES[case]
    jc, tc = jvit.ViTConfig(**kw), tvit.ViTConfig(**kw)
    params = _perturbed(jax.device_get(jvit.init_vit(jc, jax.random.PRNGKey(1))), 2)
    r = np.random.default_rng(3)
    images = (r.integers(0, 256, (3, 32, 32, 3)).astype(np.uint8) if dtype == np.uint8
              else r.uniform(0, 1, (3, 32, 32, 3)).astype(np.float32))
    want = np.asarray(jax.jit(lambda p, x: jvit.vit_encode(p, jc, x))(params, images))
    tparams = jax.tree_util.tree_map(_t, params)
    got = tvit.vit_encode(tparams, tc, torch.as_tensor(images))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (3, tc.num_tokens, 32)
    np.testing.assert_allclose(_np(got), want, atol=1e-5)
    # remat is the same function
    np.testing.assert_allclose(_np(tvit.vit_encode(tparams, tc, torch.as_tensor(images),
                                                   remat=True)), want, atol=1e-5)
    # the port's init: the JAX tree's keys, shapes and dtypes
    tinit = tvit.init_vit(tc, torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in flatten(tinit).items()} == {
        k: tuple(np.shape(v)) for k, v in flatten(params).items()}


def test_mlp_helpers_match_jax():
    """_mlp_init's shapes and ranges, _mlp_apply with tanh and with GELU's
    tanh approximation, gaussian_logprob and gaussian_entropy: atol 1e-6."""
    sizes = (5, 16, 8, 3)
    jl = jax.device_get(jmlp._mlp_init(jax.random.PRNGKey(0), sizes))
    tl = tmlp._mlp_init(torch.Generator().manual_seed(0), sizes, device="cpu")
    assert [{k: tuple(v.shape) for k, v in layer.items()} for layer in tl] == [
        {k: np.shape(v) for k, v in layer.items()} for layer in jl]
    for i, layer in enumerate(tl):
        scale = sizes[i] ** -0.5 * (0.01 if i == len(tl) - 1 else 1.0)
        assert float(layer["w"].abs().max()) <= scale and not layer["b"].any()
    x = np.random.default_rng(1).normal(size=(7, 5)).astype(np.float32)
    layers = _perturbed(jl, 4)
    tlayers = jax.tree_util.tree_map(_t, layers)
    for jact, tact in ((jax.nn.tanh, torch.tanh),
                       (jax.nn.gelu, lambda h: torch.nn.functional.gelu(h, approximate="tanh"))):
        np.testing.assert_allclose(
            _np(tmlp._mlp_apply(tlayers, torch.as_tensor(x), activation=tact)),
            np.asarray(jmlp._mlp_apply(layers, jnp.asarray(x), activation=jact)), atol=1e-6)
    r = np.random.default_rng(2)
    mean, logstd, act = (r.normal(size=(4, 3)).astype(np.float32) for _ in range(3))
    np.testing.assert_allclose(
        _np(tmlp.gaussian_logprob(*map(torch.as_tensor, (mean, logstd, act)))),
        np.asarray(jmlp.gaussian_logprob(mean, logstd, act)), atol=1e-6)
    np.testing.assert_allclose(_np(tmlp.gaussian_entropy(torch.as_tensor(logstd))),
                               np.asarray(jmlp.gaussian_entropy(logstd)), atol=1e-6)


def test_mlp_gaussian_policy_forward_matches_jax():
    """MLPGaussianPolicy on the same params: default_forward (logprobs,
    entropy, values), value and the deterministic action, atol 1e-5; the
    sampled action is the mean plus std times the generator's noise."""
    kw = dict(obs_dim=6, action_dim=3, hidden_sizes=(16, 16), init_logstd=-0.5)
    jp_, tp_ = jmlp.MLPGaussianPolicy(**kw), tmlp.MLPGaussianPolicy(**kw)
    params = _perturbed(jax.device_get(jp_.init(jax.random.PRNGKey(0))), 5)
    tparams = jax.tree_util.tree_map(_t, params)
    r = np.random.default_rng(6)
    obs = {"states": r.normal(size=(5, 6)).astype(np.float32)}
    actions = r.normal(size=(5, 3)).astype(np.float32)
    tobs = {k: torch.as_tensor(v) for k, v in obs.items()}
    want = jp_.default_forward(params, obs, actions)
    got = tp_.default_forward(tparams, tobs, torch.as_tensor(actions))
    assert set(got) == set(want) == {"logprobs", "entropy", "values"}
    for k in want:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), atol=1e-5, err_msg=k)
    det_j = jp_.predict_action_batch(params, jax.random.PRNGKey(0), obs, deterministic=True)
    det_t = tp_.predict_action_batch(tparams, torch.Generator(), tobs, deterministic=True)
    for a, b in zip(det_t, det_j):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-5)
    g = torch.Generator().manual_seed(7)
    noise = torch.randn((5, 3), generator=torch.Generator().manual_seed(7))
    drawn = tp_.predict_action_batch(tparams, g, tobs)
    torch.testing.assert_close(drawn.actions, det_t.actions + tparams["actor_logstd"].exp() * noise)
    torch.testing.assert_close(drawn.logprobs, tmlp.gaussian_logprob(
        det_t.actions, tparams["actor_logstd"].expand(5, 3), drawn.actions))
    # the port's init: the JAX tree's structure and shapes
    tinit = tp_.init(torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in flatten(tinit).items()} == {
        k: tuple(np.shape(v)) for k, v in flatten(params).items()}


# ---------------------------------------------------------------------------
# models/llm: inputs_embeds, mask_positions and the unpacked decode path
# ---------------------------------------------------------------------------

JCFG = JLLMConfig(**LLM)
#: the JAX functions under one jit each (one compile, not one an op)
_jforward_hidden = jax.jit(lambda p, emb, mask, mp: JM.forward_hidden(
    p, JCFG, None, attention_mask=mask, inputs_embeds=emb, return_kv=True, mask_positions=mp))
_jdecode_step = jax.jit(lambda p, tok, k, v, i, pos, valid: JM.decode_step(
    p, JCFG, tok, JM.KVCache(k, v), i, pos, valid))
_jdecode_ragged = jax.jit(lambda p, tok, k, v, wp, pos, valid: (
    JM.decode_step_ragged(p, JCFG, tok, JM.KVCache(k, v), wp, pos, valid),
    JM.decode_step_layered(p, JCFG, tok, JM.layered_cache_from_stacked(JM.KVCache(k, v)),
                           wp, pos, valid)))


@functools.lru_cache(maxsize=None)
def _llm():
    jcfg, tcfg = JCFG, LLMConfig(**LLM)
    jp = jax.device_get(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, jp, params_from_numpy(jp, tcfg, device="cpu")


def test_forward_hidden_with_inputs_embeds_and_mask_positions_matches_jax():
    """forward_hidden from spliced embeddings on a left-padded batch, with
    and without block-causal mask positions: hidden states and kv, atol
    1e-5."""
    jcfg, tcfg, jp, tp = _llm()
    r = np.random.default_rng(0)
    B, S = 3, 10
    emb = r.normal(size=(B, S, LLM["hidden_size"])).astype(np.float32)
    mask = np.arange(S)[None] >= np.array([0, 2, 5])[:, None]
    # prefix-LM: the first 6 positions share mask position 0 (bidirectional)
    mpos = np.maximum(np.cumsum(mask, axis=1) - 6, 0).astype(np.int32)
    for mp in (None, mpos):
        jh, jkv = _jforward_hidden(jp, emb, mask, mp)
        th, tkv = TM.forward_hidden(tp, tcfg, None, attention_mask=torch.as_tensor(mask),
                                    inputs_embeds=torch.as_tensor(emb), return_kv=True,
                                    mask_positions=None if mp is None else torch.as_tensor(mp))
        np.testing.assert_allclose(_np(th), np.asarray(jh), atol=1e-5)
        np.testing.assert_allclose(_np(tkv.k), np.asarray(jkv.k), atol=1e-5)
        np.testing.assert_allclose(_np(tkv.v), np.asarray(jkv.v), atol=1e-5)
    ids = r.integers(2, 258, (B, S)).astype(np.int32)
    np.testing.assert_allclose(
        _np(TM.forward_logits(tp, tcfg, torch.as_tensor(ids), attention_mask=torch.as_tensor(mask))),
        np.asarray(jax.jit(lambda p, i, m: JM.forward_logits(p, jcfg, i, attention_mask=m))(
            jp, ids, mask)),
        atol=1e-4)


def _decode_case(seed, B=4, S=12):
    """A filled random cache, tokens, positions and a valid mask."""
    r = np.random.default_rng(seed)
    shape = (LLM["num_layers"], B, S, LLM["num_kv_heads"], LLM["hidden_size"] // LLM["num_heads"])
    k, v = (r.normal(size=shape).astype(np.float32) for _ in range(2))
    tok = r.integers(2, 258, B).astype(np.int32)
    pos = r.integers(3, 20, B).astype(np.int32)
    valid = r.uniform(size=(B, S)) < 0.7
    valid[:, 0] = True
    return k, v, tok, pos, valid


def test_init_kv_cache_matches_jax():
    jcfg, tcfg = JLLMConfig(**LLM), LLMConfig(**LLM)
    want = JM.init_kv_cache(jcfg, 3, 9)
    got = TM.init_kv_cache(tcfg, 3, 9, device="cpu")
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32 and not g.any()


@pytest.mark.parametrize("cache_index", [5, 11, 12, 15, -1, -20])
def test_decode_step_matches_jax(cache_index):
    """decode_step writing slot ``cache_index`` of 12: inside, the last slot,
    past the end (``lax.dynamic_update_slice`` clamps it onto the last slot),
    negative; hidden and the whole cache after the write, atol 1e-5."""
    jcfg, tcfg, jp, tp = _llm()
    k, v, tok, pos, valid = _decode_case(cache_index % 7)
    jh, jc = _jdecode_step(jp, tok, k, v, jnp.int32(cache_index), pos, valid)
    for index in (cache_index, torch.tensor(cache_index)):
        cache = TM.KVCache(torch.as_tensor(k.copy()), torch.as_tensor(v.copy()))
        th, tc = TM.decode_step(tp, tcfg, torch.as_tensor(tok), cache, index,
                                torch.as_tensor(pos), torch.as_tensor(valid))
        assert tc.k is cache.k          # written in place
        np.testing.assert_allclose(_np(th), np.asarray(jh), atol=1e-5)
        np.testing.assert_allclose(_np(tc.k), np.asarray(jc.k), atol=1e-5)
        np.testing.assert_allclose(_np(tc.v), np.asarray(jc.v), atol=1e-5)


def test_decode_step_ragged_and_layered_match_jax():
    """Per-row write slots inside, at the last slot, past the end and
    negative (``.at[rows, pos].set`` wraps a negative slot once and drops a
    row still outside the cache): decode_step_ragged on the stacked cache
    and decode_step_layered on its per-layer views, hidden and caches atol
    1e-5."""
    jcfg, tcfg, jp, tp = _llm()
    k, v, tok, pos, valid = _decode_case(1, B=6)
    wp = np.array([3, 11, 12, 40, -1, -13], np.int32)
    (jh, jc), (jhl, jl) = _jdecode_ragged(jp, tok, k, v, wp, pos, valid)
    targs = (torch.as_tensor(wp), torch.as_tensor(pos), torch.as_tensor(valid))
    th, tc = TM.decode_step_ragged(tp, tcfg, torch.as_tensor(tok),
                                   TM.KVCache(torch.as_tensor(k.copy()), torch.as_tensor(v.copy())),
                                   *targs)
    stacked = TM.KVCache(torch.as_tensor(k.copy()), torch.as_tensor(v.copy()))
    layers = TM.layered_cache_from_stacked(stacked)
    thl, tl = TM.decode_step_layered(tp, tcfg, torch.as_tensor(tok), layers, *targs)
    for got, want in ((th, jh), (thl, jhl), (tc.k, jc.k), (tc.v, jc.v),
                      (stacked.k, jc.k), (stacked.v, jc.v)):
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)
    assert len(tl) == len(jl) == LLM["num_layers"]
    for (gk, gv), (wk, wv) in zip(tl, jl):
        np.testing.assert_allclose(_np(gk), np.asarray(wk), atol=1e-5)
        np.testing.assert_allclose(_np(gv), np.asarray(wv), atol=1e-5)
    # the dropped rows' cache is untouched
    np.testing.assert_array_equal(_np(tc.k[:, 3]), k[:, 3])
    np.testing.assert_array_equal(_np(tc.k[:, 5]), k[:, 5])


# ---------------------------------------------------------------------------
# models/vlm
# ---------------------------------------------------------------------------

def test_vlm_forward_matches_jax_on_a_left_padded_batch():
    """VLMReasoningModel.forward (teacher-forced logprobs and entropy of
    responses of different lengths) at temperature 1 and 0.7: atol 1e-5."""
    jmodel, tmodel = _models()
    jparams, tparams = _vlm_params(jmodel)
    images, ids, mask = _left_padded_batch()
    r = np.random.default_rng(1)
    resp = r.integers(2, 258, (4, 5)).astype(np.int32)
    rmask = np.arange(5)[None] < np.array([5, 3, 1, 4])[:, None]
    jforward = jax.jit(jmodel.forward, static_argnames=("temperature",))
    for temp in (1.0, 0.7):
        jlp, jent = jforward(jparams, images, ids, mask, resp, rmask, temperature=temp)
        tlp, tent = tmodel.forward(tparams, torch.as_tensor(images), torch.as_tensor(ids),
                                   torch.as_tensor(mask), torch.as_tensor(resp),
                                   torch.as_tensor(rmask), temperature=temp)
        np.testing.assert_allclose(_np(tlp), np.asarray(jlp), atol=1e-5)
        np.testing.assert_allclose(_np(tent), np.asarray(jent), atol=1e-5)


def test_vlm_greedy_generate_matches_jax_on_a_left_padded_batch():
    """Greedy generate of 6 tokens with an eos: ids, mask and lengths equal,
    behaviour logprobs atol 1e-5."""
    jmodel, tmodel = _models()
    jparams, tparams = _vlm_params(jmodel, seed=3)
    images, ids, mask = _left_padded_batch(seed=2)
    kw = dict(max_new_tokens=6, greedy=True, eos_token_id=100, pad_token_id=0)
    want = jax.jit(lambda *a: jmodel.generate(*a, JSamplingParams(**kw)))(
        jparams, jax.random.PRNGKey(0), images, ids, mask)
    got = tmodel.generate(tparams, torch.Generator(), torch.as_tensor(images),
                          torch.as_tensor(ids), torch.as_tensor(mask), SamplingParams(**kw))
    assert set(got) == set(want)
    for k in ("response_ids", "response_mask", "response_lengths"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(_np(got["response_logprobs"]),
                               np.asarray(want["response_logprobs"]), atol=1e-5)
    assert got["response_ids"].dtype == torch.int32


# ---------------------------------------------------------------------------
# runners
# ---------------------------------------------------------------------------

def test_vlm_train_step_matches_jax_on_the_jax_runners_batch():
    """One JAX run_step (rollout, rule rewards, GRPO advantages) hands its
    batch to the port's _train_step from the same params: loss, every
    metric and the grad norm rtol 1e-4, atol 1e-5 (``actor/policy_loss`` is
    a sum of terms of order 50 that cancel to ~1e-6, so f32 order leaves
    ~1e-6 in it), new params atol 5e-5 (adam's first step is
    lr * g / (|g| + 1e-8), so an element whose gradient is near 1e-8 turns
    the f32 rounding of g into ~1e-5 of its step at lr 4e-3: one of
    patch_proj's 24,576 does)."""
    jcfg, tcfg = _cfgs(rollout_batch_size=2)
    jmodel, tmodel = _models()
    jr = JRunner(jcfg, JTokenizer(), _color_dataset(jdata), jmodel, reward_fn=_odd_reward)
    jparams = jax.device_get(jr.state.params)
    seen = {}
    inner = jr._train_step

    def capture(state, batch):
        seen["batch"] = jax.device_get(batch)
        state, metrics = inner(state, batch)
        seen["metrics"] = jax.device_get(metrics)
        return state, metrics

    jr._train_step = capture
    jr.run_step()
    assert np.abs(seen["batch"]["advantages"]).max() > 0
    tr = VLMReasoningRunner(tcfg, ByteTokenizer(), _color_dataset(tdata), tmodel,
                            reward_fn=_odd_reward, device="cpu",
                            init_params_override=lambda s: vlm_params_from_numpy(
                                jparams, tcfg.model, device="cpu"))
    state, metrics = tr._train_step(tr.state, seen["batch"])
    assert set(metrics) == set(seen["metrics"])
    for k, want in seen["metrics"].items():
        np.testing.assert_allclose(_np(metrics[k]), np.asarray(want), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    _assert_trees_close(state.params, jax.device_get(jr.state.params), atol=5e-5)
    assert state.step == 1


def test_vlm_sft_two_steps_match_jax():
    """Two whole VLMSFTRunner steps (numpy batch draws, nothing sampled) from
    one init: each step's metrics rtol 1e-5, params after step 2 atol
    1e-5."""
    jcfg, tcfg = _cfgs(max_steps=2, lr=3e-3, rollout_batch_size=16)
    jmodel, tmodel = _models()
    js = JSFTRunner(jcfg, JTokenizer(), _color_dataset(jdata), jmodel)
    jparams = jax.device_get(js.state.params)
    jh = js.run()
    ts = VLMSFTRunner(tcfg, ByteTokenizer(), _color_dataset(tdata), tmodel, device="cpu",
                      init_params_override=lambda s: vlm_params_from_numpy(
                          jparams, tcfg.model, device="cpu"))
    th = ts.run()
    assert len(th) == len(jh) == 2
    for t, j in zip(th, jh):
        assert set(t) == set(j)
        for k in j:
            if not k.startswith("time/"):
                np.testing.assert_allclose(t[k], j[k], rtol=1e-5, err_msg=k)
    assert th[1]["sft/loss"] < th[0]["sft/loss"]
    _assert_trees_close(ts.state.params, jax.device_get(js.state.params), atol=1e-5)


def test_vqa_dataset_and_load_image_match_jax(tmp_path):
    """VQADataset.from_jsonl on array rows, path rows (a PNG written here),
    rows without an image or question (skipped) and answer/label
    variants; load_image for both kinds: equal to the JAX package's."""
    from PIL import Image

    img = np.random.default_rng(0).integers(0, 256, (6, 5, 3)).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "a.png")
    rows = [{"image": str(tmp_path / "a.png"), "question": "q1", "answers": ["x", "y"]},
            {"image_path": str(tmp_path / "a.png"), "prompt": "q2", "answer": 3},
            {"question": "no image", "answer": "z"},
            {"image": str(tmp_path / "a.png"), "question": "q3", "label": "w"},
            {"image": str(tmp_path / "a.png"), "question": "q4"}]
    path = tmp_path / "vqa.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")
    jd, td = jdata.VQADataset.from_jsonl(str(path)), tdata.VQADataset.from_jsonl(str(path))
    assert len(td) == len(jd) == 4
    assert [dataclasses.asdict(e) for e in td.examples] == [
        dataclasses.asdict(e) for e in jd.examples]
    assert len(tdata.VQADataset.from_jsonl(str(path), max_examples=2)) == 2
    got = tdata.VQADataset.load_image(td[0])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jdata.VQADataset.load_image(jd[0]))
    np.testing.assert_array_equal(got, img.astype(np.float32) / 255.0)
    arr = tdata.VQAExample(image=img[..., 0].tolist(), question="q", answers=[])
    np.testing.assert_array_equal(tdata.VQADataset.load_image(arr),
                                  jdata.VQADataset.load_image(arr))


def test_vlm_grpo_learns_visual_reward():
    """The JAX test's colour task, seed and bars: 60 GRPO steps lift the
    reward by more than 0.05 and past the image-blind ceiling of 1/3 (0.45),
    and step 1's approx_kl is under 1e-3 (behaviour and training logprobs
    are one computation)."""
    _, tcfg = _cfgs()
    _, tmodel = _models()
    runner = VLMReasoningRunner(tcfg, ByteTokenizer(), _color_dataset(tdata), tmodel,
                                reward_fn=_color_char_reward, device="cpu")
    history = runner.run(max_steps=60)
    first5 = np.mean([h["rollout/reward_mean"] for h in history[:5]])
    last5 = np.mean([h["rollout/reward_mean"] for h in history[-5:]])
    assert last5 > first5 + 0.05, f"no visual learning: {first5:.4f} -> {last5:.4f}"
    assert last5 > 0.45, f"reward {last5:.3f} within the image-blind ceiling (1/3)"
    assert abs(history[0]["actor/approx_kl"]) < 1e-3
    for key in ("actor/loss", "actor/grad_norm", "rollout/reward_mean", "time/rollout",
                "time/reward", "time/training", "time/step"):
        assert key in history[0]


def test_vlm_runner_resumes_bitwise(tmp_path):
    """resume="auto": a second runner on the checkpoint directory restores
    the saved state bitwise at step 2 and takes step 3."""
    _, tcfg = _cfgs(max_steps=2, rollout_batch_size=2, checkpoint_dir=str(tmp_path / "ckpt"),
                    save_interval=1)
    _, tmodel = _models()
    make = lambda: VLMReasoningRunner(tcfg, ByteTokenizer(), _color_dataset(tdata), tmodel,
                                      reward_fn=_odd_reward, device="cpu")
    r1 = make()
    r1.run()
    r2 = make()
    assert r2.global_step == 2
    f1, f2 = flatten(r1.state), flatten(r2.state)
    assert f1.keys() == f2.keys()
    for k in f1:
        if isinstance(f1[k], torch.Tensor):
            assert f1[k].dtype == f2[k].dtype and torch.equal(f1[k], f2[k]), k
        else:
            assert f1[k] == f2[k], k
    (step3,) = r2.run(3)
    assert r2.global_step == 3 and np.isfinite(step3["actor/loss"])
    assert r2.ckpt.latest_step() == 3


def test_main_vlm_grpo_runs_on_the_cpu(tmp_path, capsys):
    """main_vlm_grpo.main(device="cpu") with 2 SFT and 2 GRPO steps at the
    example's model: the SFT'd params are the GRPO runner's start, every
    metric finite, the metrics file written; the CLI defaults to the card
    and the example's step counts."""
    out = main_vlm_grpo.main(device="cpu", sft_steps=2, grpo_steps=2, log_dir=str(tmp_path))
    assert len(out["sft"]) == 2 and len(out["grpo"]) == 2
    assert out["runner"].state.params is out["sft_runner"].state.params
    for h in out["sft"] + out["grpo"]:
        assert all(np.isfinite(v) for v in h.values())
    assert out["runner"].model.vit_cfg.hidden == 48 and out["runner"].cfg.model.num_layers == 3
    assert "sft loss" in capsys.readouterr().out
    assert (tmp_path / "metrics.jsonl").exists()
    args = main_vlm_grpo.parse_args([])
    assert (args.device, args.sft_steps, args.grpo_steps) == ("cuda", 40, 60)
    ds = main_vlm_grpo.color_dataset(n=6, image_size=16)
    assert len(ds) == 6 and ds[4].answers == ["green"] and ds[0].image.shape == (16, 16, 3)
