"""Hugging Face checkpoints through the port's own readers, on the CPU.

Tiny Qwen2 (tied, qkv biases), Qwen3 (qk-norm, q_dim != D, untied) and
Llama (untied) models are built in code with ``transformers``, their
weights randomised from a seed (norms around 1, biases non-zero), and
saved by ``save_pretrained`` in f32, in bf16, sharded (``max_shard_size``)
and as ``pytorch_model.bin``. The port's ``load_hf_pretrained(device=
"cpu")`` must equal the JAX package's bitwise, leaf by leaf, and its
``forward_logits`` must match the transformers model within 2e-4 in f32
(as ``tests/test_qwen3_model.py`` holds JAX). ``config.json`` files with
keys removed give the same ``LLMConfig`` as JAX's
``from_hf_config(AutoConfig.from_pretrained(dir))``; the export loads in
``safetensors`` and transformers and equals the JAX export. The entry
points run ``--model-path``/``--model`` on a tiny checkpoint with the
tokenizer fixture.
"""

import dataclasses
import json
import os
import shutil
import struct
import urllib.request

import numpy as np
import pytest
import torch

from rlinf_tpu.data.tokenizers import HFTokenizer as JHF
from rlinf_tpu.models.llm import hf_import as JH
from rlinf_tpu.models.llm.config import LLMConfig as JConfig
from rlinf_tpu_torch import main_grpo, main_sft, serve_openai
from rlinf_tpu_torch.config import load_config
from rlinf_tpu_torch.models.llm import hf_files
from rlinf_tpu_torch.models.llm import hf_import as TH
from rlinf_tpu_torch.models.llm.config import LLMConfig as TConfig
from rlinf_tpu_torch.models.llm.model import forward_logits

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "hf_tokenizer")
YAML = os.path.join(ROOT, "examples", "reasoning", "config", "grpo_demo_tiny.yaml")


def _hf_model(family):
    from transformers import (LlamaConfig, LlamaForCausalLM, Qwen2Config, Qwen2ForCausalLM,
                              Qwen3Config, Qwen3ForCausalLM)

    common = dict(vocab_size=448, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
                  rope_theta=1e4, rms_norm_eps=1e-6)
    if family == "qwen2":
        model = Qwen2ForCausalLM(Qwen2Config(**common, tie_word_embeddings=True))
    elif family == "qwen3":
        model = Qwen3ForCausalLM(Qwen3Config(**common, head_dim=32, tie_word_embeddings=False))
    else:
        model = LlamaForCausalLM(LlamaConfig(**common, tie_word_embeddings=False))
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=g)
            p.copy_(1.0 + 0.1 * noise if "norm" in name else 0.05 * noise)
    return model.eval()


FAMILIES = ["qwen2", "qwen3", "llama"]
LAYOUTS = ["f32", "bf16", "sharded", "bin"]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """{(family, layout): (directory, the f32 transformers model)}."""
    out = {}
    for family in FAMILIES:
        model = _hf_model(family)
        for layout in LAYOUTS:
            d = tmp_path_factory.mktemp(f"{family}_{layout}")
            if layout == "bf16":
                _hf_model(family).to(torch.bfloat16).save_pretrained(d)
            elif layout == "sharded":
                model.save_pretrained(d, max_shard_size="100KB")
            elif layout == "bin":
                model.save_pretrained(d, safe_serialization=False)
            else:
                model.save_pretrained(d)
            out[family, layout] = (str(d), model)
    return out


def _bits(x):
    """The raw bits of a JAX array or a torch tensor, as numpy."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy().view(np.int32 if x.dtype == torch.float32 else np.int16)
    a = np.asarray(x)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _assert_params_bitwise(tp, jp, path=""):
    if isinstance(jp, dict):
        assert set(tp) == set(jp), path
        for k in jp:
            _assert_params_bitwise(tp[k], jp[k], f"{path}/{k}")
        return
    assert tuple(tp.shape) == tuple(jp.shape), path
    np.testing.assert_array_equal(_bits(tp), _bits(jp), err_msg=path)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_load_hf_pretrained_equals_jax_bitwise(checkpoints, family, layout, dtype):
    path, _ = checkpoints[family, layout]
    if layout == "sharded":
        assert os.path.exists(os.path.join(path, "model.safetensors.index.json"))
    tcfg, tp = TH.load_hf_pretrained(path, dtype=dtype, device="cpu")
    jcfg, jp = JH.load_hf_pretrained(path, dtype=dtype)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert ("lm_head" in tp) == (family != "qwen2")
    _assert_params_bitwise(tp, jp)


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_logits_match_transformers(checkpoints, family):
    path, model = checkpoints[family, "f32"]
    cfg, params = TH.load_hf_pretrained(path, dtype="float32", device="cpu")
    assert cfg.qk_norm == (family == "qwen3") and cfg.qkv_bias == (family == "qwen2")
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12))
    with torch.no_grad():
        want = model(torch.tensor(ids)).logits.numpy()
        got = forward_logits(params, cfg, torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


_REMOVALS = [
    (),
    ("num_key_value_heads",),
    ("head_dim",),
    ("max_position_embeddings", "rope_theta", "rms_norm_eps"),
    ("tie_word_embeddings",),
    ("num_key_value_heads", "head_dim", "max_position_embeddings", "rope_theta", "rms_norm_eps",
     "tie_word_embeddings", "vocab_size", "intermediate_size", "num_hidden_layers", "layer_types"),
]


@pytest.mark.parametrize("removed", _REMOVALS, ids=lambda r: "-".join(r) or "none")
@pytest.mark.parametrize("family", FAMILIES)
def test_config_defaults_match_autoconfig(checkpoints, tmp_path, family, removed):
    from transformers import AutoConfig

    src, _ = checkpoints[family, "f32"]
    data = json.load(open(os.path.join(src, "config.json")))
    for key in removed:
        data.pop(key, None)
    json.dump(data, open(tmp_path / "config.json", "w"))
    want = JConfig.from_hf_config(AutoConfig.from_pretrained(tmp_path))
    assert dataclasses.asdict(TConfig.from_hf_config(data)) == dataclasses.asdict(want)
    assert dataclasses.asdict(TH.load_hf_config(str(tmp_path))) == dataclasses.asdict(want)


@pytest.mark.parametrize("family", FAMILIES)
def test_config_from_object_and_null_kv_heads(checkpoints, tmp_path, family):
    from transformers import AutoConfig

    src, model = checkpoints[family, "f32"]
    assert dataclasses.asdict(TConfig.from_hf_config(model.config)) == dataclasses.asdict(
        JConfig.from_hf_config(model.config))
    data = {**json.load(open(os.path.join(src, "config.json"))), "num_key_value_heads": None}
    json.dump(data, open(tmp_path / "config.json", "w"))
    want = JConfig.from_hf_config(AutoConfig.from_pretrained(tmp_path))
    assert dataclasses.asdict(TConfig.from_hf_config(data)) == dataclasses.asdict(want)


def test_unknown_model_type_raises():
    with pytest.raises(ValueError, match="model_type 'mistral'"):
        TConfig.from_hf_config({"model_type": "mistral", "hidden_size": 8})


@pytest.mark.parametrize("family", FAMILIES)
def test_export_loads_in_safetensors_and_transformers(checkpoints, tmp_path, family):
    from safetensors.torch import load_file

    path, model = checkpoints[family, "f32"]
    cfg, params = TH.load_hf_pretrained(path, dtype="float32", device="cpu")
    jcfg, jp = JH.load_hf_pretrained(path, dtype="float32")
    sd = TH.params_to_hf_state_dict(params, cfg)
    jsd = JH.params_to_hf_state_dict(jp, jcfg)
    assert set(sd) == set(jsd)
    for k in jsd:
        np.testing.assert_array_equal(sd[k].numpy(), jsd[k], err_msg=k)
    out = tmp_path / "model.safetensors"
    hf_files.write_safetensors(str(out), sd, {"format": "pt"})
    with open(out, "rb") as f:
        assert struct.unpack("<Q", f.read(8))[0] % 8 == 0
    loaded = load_file(str(out))
    for k in sd:
        assert torch.equal(loaded[k], sd[k]), k
    shutil.copy(os.path.join(path, "config.json"), tmp_path / "config.json")
    again = type(model).from_pretrained(tmp_path, torch_dtype=torch.float32).eval()
    ids = torch.tensor([[3, 1, 4, 1, 5, 9, 2, 6]])
    with torch.no_grad():
        torch.testing.assert_close(again(ids).logits, model(ids).logits, rtol=0, atol=0)


def test_safetensors_reader_matches_the_library_and_refuses_other_dtypes(tmp_path):
    from safetensors.torch import save_file

    ts = {"a": torch.randn(3, 5).bfloat16(), "b": torch.randn(7).half(), "c": torch.randn(2, 2, 3),
          "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 4)}
    save_file(ts, str(tmp_path / "x.safetensors"))
    got = hf_files.read_safetensors(str(tmp_path / "x.safetensors"))
    assert set(got) == set(ts)
    for k in ts:
        assert got[k].dtype == ts[k].dtype and torch.equal(got[k], ts[k]), k
    save_file({"i": torch.arange(4, dtype=torch.int32)}, str(tmp_path / "i.safetensors"))
    with pytest.raises(ValueError, match="'I32'"):
        hf_files.read_safetensors(str(tmp_path / "i.safetensors"))
    with pytest.raises(FileNotFoundError, match="model.safetensors"):
        hf_files.load_state_dict(str(tmp_path / "nowhere"))


def test_missing_tensor_and_card_default_raise(checkpoints, monkeypatch):
    path, _ = checkpoints["qwen2", "f32"]
    cfg = TH.load_hf_config(path)
    sd = hf_files.load_state_dict(path)
    del sd["model.layers.1.mlp.up_proj.weight"]
    with pytest.raises(KeyError, match="layers.1.mlp.up_proj.weight"):
        TH.params_from_hf_state_dict(sd, cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TH.load_hf_pretrained(path)


# ---------------------------------------------------------------------------
# The entry points on a tiny checkpoint with the tokenizer fixture
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model_dir(checkpoints, tmp_path_factory):
    d = tmp_path_factory.mktemp("qwen2_with_tokenizer")
    src, _ = checkpoints["qwen2", "bf16"]
    for name in os.listdir(src):
        shutil.copy(os.path.join(src, name), d / name)
    for name in os.listdir(FIXTURE):
        shutil.copy(os.path.join(FIXTURE, name), d / name)
    return str(d)


def test_main_grpo_model_path_loads_what_jax_loads_and_steps(model_dir, tmp_path):
    """``load_model`` gives the JAX entry point's config (the yaml's dtype),
    params (bitwise) and tokenizer ids; then one GRPO step runs."""
    cfg = load_config(YAML, [])
    tcfg, tok, init = main_grpo.load_model(cfg, model_dir, "cpu")
    jcfg, jp = JH.load_hf_pretrained(model_dir, dtype=cfg.model.dtype)
    assert dataclasses.asdict(tcfg.model) == dataclasses.asdict(jcfg)
    _assert_params_bitwise(init(0), jp)
    jtok = JHF(model_dir)
    assert tok.encode("Compute 12 + 30. Final answer: ") == jtok.encode("Compute 12 + 30. Final answer: ")
    history = main_grpo.main(["--config", YAML, "--device", "cpu", "--model-path", model_dir,
                              "runner.max_steps=1", "runner.rollout_batch_size=2",
                              f"runner.log_dir={tmp_path}"])
    (m,) = history
    assert all(np.isfinite(v) for v in m.values()) and m["rollout/response_len_mean"] > 0


def test_main_sft_model_path_steps(model_dir, tmp_path):
    data = tmp_path / "sft.jsonl"
    data.write_text("\n".join(json.dumps({"prompt": f"Q: {i} + 2 =", "answer": f" {i + 2}"})
                              for i in range(8)))
    history = main_sft.main(["--config", YAML, "--data-path", str(data), "--device", "cpu",
                             "--model-path", model_dir, "runner.rollout_batch_size=4",
                             "runner.max_steps=2", f"runner.log_dir={tmp_path / 'logs'}"])
    assert len(history) == 2 and all(np.isfinite(h["sft/loss"]) for h in history)


def test_serve_openai_model_serves_on_the_cpu(model_dir):
    """serve_openai --model: a completion and a chat request over loopback;
    the prompt is counted in AutoTokenizer.encode's ids (with the file's
    special tokens, here none)."""
    from transformers import AutoTokenizer

    auto = AutoTokenizer.from_pretrained(model_dir)
    server, http = serve_openai.build_server(serve_openai.parse_args(
        ["--device", "cpu", "--port", "0", "--max-new-tokens", "6", "--model", model_dir]))
    try:
        assert server.engine.cfg.vocab_size == 448 and server.engine.cfg.dtype == "bfloat16"
        for route, body in (("/v1/completions", {"prompt": "Tom has 5 apples.", "max_tokens": 4}),
                            ("/v1/chat/completions",
                             {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 4})):
            req = urllib.request.Request(http.url + route, data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                out = json.loads(r.read())
            assert 1 <= out["usage"]["completion_tokens"] <= 4
            if route == "/v1/completions":
                assert out["usage"]["prompt_tokens"] == len(auto.encode(body["prompt"]))
                assert isinstance(out["choices"][0]["text"], str)
    finally:
        http.stop()
        server.stop()
