"""The port's checkpoint converter CLI (``toolkits/ckpt_convert.py``): import
a tiny Hugging Face checkpoint, export it back, after the JAX CLI's test
(``tests/test_ckpt_convert_cli.py``), on the CPU.

The port writes its own checkpoint layout (torch.save files) and reads and
writes safetensors itself; the exported ``model.safetensors`` must equal the
JAX CLI's export of the same checkpoint exactly (both f32) and hold the HF
model's tensors exactly.
"""

import json
import os

import numpy as np
import pytest
import torch

from rlinf_tpu_torch.models.llm import hf_files
from rlinf_tpu_torch.models.llm.hf_import import load_hf_pretrained
from rlinf_tpu_torch.models.llm.model import init_params
from rlinf_tpu_torch.config import load_config
from rlinf_tpu_torch.toolkits.ckpt_convert import main
from rlinf_tpu_torch.utils.checkpoint import CheckpointManager

CONFIG_YAML = (
    "model:\n  vocab_size: 128\n  hidden_size: 32\n"
    "  intermediate_size: 64\n  num_layers: 2\n  num_heads: 2\n"
    "  num_kv_heads: 2\n  max_seq_len: 256\n  dtype: float32\n"
    "  tie_word_embeddings: true\n  qkv_bias: true\n"
)


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    from transformers import Qwen2Config, Qwen2ForCausalLM

    hf_cfg = Qwen2Config(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=2,
        max_position_embeddings=64, rope_theta=1e4, tie_word_embeddings=True,
    )
    torch.manual_seed(0)
    model = Qwen2ForCausalLM(hf_cfg)
    d = tmp_path_factory.mktemp("hf")
    model.save_pretrained(d)
    return d, model


def test_import_export_round_trip_equals_the_jax_cli(hf_dir, tmp_path, capsys):
    d, model = hf_dir
    out = tmp_path / "ckpt"
    assert main(["import", "--hf", str(d), "--out", str(out), "--dtype", "float32",
                 "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["params"] == sum(p.numel() for p in model.parameters())
    assert os.path.exists(out / "global_step_0" / "_DONE")
    extra = json.load(open(out / "global_step_0" / "extra.json"))
    assert extra["source"] == str(d) and extra["model_config"]["qkv_bias"] is True

    cfgfile = tmp_path / "cfg.yaml"
    cfgfile.write_text(CONFIG_YAML)
    hf_out = tmp_path / "hf_out"
    assert main(["export", "--ckpt", str(out), "--config", str(cfgfile), "--out", str(hf_out),
                 "--device", "cpu"]) == 0
    sd = hf_files.read_safetensors(str(hf_out / "model.safetensors"))
    ref = model.state_dict()
    assert set(sd) == set(ref)
    for k in ref:
        assert sd[k].dtype == torch.float32 and torch.equal(sd[k], ref[k]), k

    # the JAX CLI on the same HF directory
    from safetensors.numpy import load_file
    from rlinf_tpu.toolkits.ckpt_convert import main as jmain

    jout = tmp_path / "orbax"
    assert jmain(["import", "--hf", str(d), "--out", str(jout), "--dtype", "float32"]) == 0
    jhf_out = tmp_path / "jax_hf_out"
    assert jmain(["export", "--ckpt", str(jout), "--config", str(cfgfile),
                  "--out", str(jhf_out)]) == 0
    jsd = load_file(jhf_out / "model.safetensors")
    assert set(jsd) == set(sd)
    for k in jsd:
        np.testing.assert_array_equal(sd[k].numpy(), jsd[k], err_msg=k)


def test_imported_checkpoint_restores_with_a_params_template(hf_dir, tmp_path):
    d, _ = hf_dir
    out = tmp_path / "ckpt"
    assert main(["import", "--hf", str(d), "--out", str(out), "--device", "cpu"]) == 0
    cfg, params = load_hf_pretrained(str(d), device="cpu")
    template = init_params(cfg, 1, device="cpu")
    restored, extra, step = CheckpointManager(str(out)).restore(template)
    assert step == 0 and extra["model_config"]["dtype"] == "bfloat16"
    for k in params["blocks"]:
        assert torch.equal(restored["blocks"][k], params["blocks"][k]), k
    assert torch.equal(restored["embed"], params["embed"])


def test_export_of_another_config_and_an_empty_dir(hf_dir, tmp_path, capsys):
    d, _ = hf_dir
    out = tmp_path / "ckpt"
    assert main(["import", "--hf", str(d), "--out", str(out), "--dtype", "float32",
                 "--device", "cpu"]) == 0
    wrong = tmp_path / "wrong.yaml"
    wrong.write_text(CONFIG_YAML.replace("num_layers: 2", "num_layers: 3"))
    with pytest.raises(SystemExit, match="params-only"):
        main(["export", "--ckpt", str(out), "--config", str(wrong), "--out", str(tmp_path / "x"),
              "--device", "cpu"])
    cfgfile = tmp_path / "cfg.yaml"
    cfgfile.write_text(CONFIG_YAML)
    assert main(["export", "--ckpt", str(tmp_path / "empty"), "--config", str(cfgfile),
                 "--out", str(tmp_path / "y"), "--device", "cpu"]) == 1
    assert load_config(str(cfgfile)).model.num_layers == 2
