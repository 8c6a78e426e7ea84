"""The port's metrics, timers, checkpoints and FLOP counts against the JAX
package's, on the CPU. The rollout statistics and the FLOP count are host
arithmetic and must agree exactly; the checkpoint manager keeps the JAX
package's layout (``global_step_N/``, ``_DONE``, ``extra.json``) with
``torch.save`` in place of orbax."""

import json
import os
import time

import numpy as np
import pytest
import torch

from rlinf_tpu.models.llm.config import LLMConfig as JConfig
from rlinf_tpu.utils import flops as JF
from rlinf_tpu.utils import metrics as JM
from rlinf_tpu_torch.models.llm.config import LLMConfig as TConfig
from rlinf_tpu_torch.training.train_state import TrainState
from rlinf_tpu_torch.utils import flops as TF
from rlinf_tpu_torch.utils import metrics as TM
from rlinf_tpu_torch.utils.checkpoint import CheckpointManager
from rlinf_tpu_torch.utils.sync import host_sync, synchronize
from rlinf_tpu_torch.utils.timers import Timers


@pytest.mark.parametrize("with_optional", [False, True])
def test_rollout_metrics_match(with_optional):
    r = np.random.default_rng(0)
    B, N = 24, 32
    lens = r.integers(1, N + 1, B)
    rewards = r.choice([0.0, 1.0, 0.5], B).astype(np.float32)
    kw = {}
    if with_optional:
        mask = np.arange(N)[None, :] < lens[:, None]
        kw = dict(prompt_lengths=r.integers(5, 50, B),
                  advantages=(r.normal(size=(B, N)) * mask).astype(np.float32), loss_mask=mask)
    got = TM.rollout_metrics(lens, rewards, N, **kw)
    assert got == JM.rollout_metrics(lens, rewards, N, **kw)
    assert got["rollout/response_len_clip_ratio"] == float((lens >= N).mean())


def test_metric_logger_writes_jsonl(tmp_path, capsys):
    log = TM.MetricLogger(str(tmp_path), print_every=2)
    log.log({"a": 1, "b": torch.tensor(2.5), "c": np.float32(3.0), "skip": "text"}, 1)
    log.log({"a": torch.tensor([4.0])}, 2)
    log.close()
    rows = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [(r["step"], r.get("a"), r.get("b"), r.get("c")) for r in rows] == [
        (1, 1.0, 2.5, 3.0), (2, 4.0, None, None)]
    assert all("skip" not in r and r["time"] > 0 for r in rows)
    assert capsys.readouterr().out.strip() == "[step 2] a=4"


def test_timers_sum_and_mean():
    t = Timers()
    for s in (0.01, 0.03):
        with t.scope("a", block_on={"x": [torch.ones(2)]}):
            time.sleep(s)
    t.record("b", 2.0)
    t.record("b", 4.0)
    mean = t.consume("mean")
    assert mean["b"] == 3.0 and 0.02 <= mean["a"] < 0.2
    assert t.consume() == {}
    t.record("b", 2.0)
    t.record("b", 4.0)
    assert t.consume() == {"b": 6.0}


def test_sync_takes_trees_of_cpu_tensors():
    tree = {"a": (torch.ones(3), [torch.zeros(())]), "b": 1.0}
    synchronize(tree)
    host_sync(tree)
    host_sync({})


def _state(seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    p = {"embed": torch.randn(6, 4, generator=g).to(dtype),
         "blocks": {"wq": torch.randn(2, 4, 4, generator=g).to(dtype)}}
    opt = {"count": seed, "mu": {k: v * 0 for k, v in p.items() if k == "embed"}}
    return TrainState(seed, p, opt)


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return type(a) is type(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def test_checkpoint_save_restore_latest_and_gc(tmp_path):
    ck = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    assert ck.latest_step() is None and ck.restore(_state()) == (None, None, None)
    for step in (1, 2, 3):
        ck.save(step, _state(step), extra={"dataloader": {"epoch": 0, "index": step}})
    assert sorted(os.listdir(ck.root_dir)) == ["global_step_2", "global_step_3"]
    assert set(os.listdir(tmp_path / "ck" / "global_step_3")) == {"state.pt", "extra.json",
                                                                  "_DONE"}
    state, extra, step = ck.restore(_state())
    assert step == 3 and extra == {"dataloader": {"epoch": 0, "index": 3}}
    assert isinstance(state, TrainState) and _equal(state, _state(3))
    state, _, step = ck.restore(_state(), step=2)
    assert step == 2 and _equal(state, _state(2))
    os.remove(tmp_path / "ck" / "global_step_3" / "_DONE")   # a save cut short
    assert ck.latest_step() == 2


def test_checkpoint_restores_moments_widened_by_an_update(tmp_path):
    """A bf16 template's moments may come back in f32 (the first update
    promotes them); the params keep their dtype."""
    ck = CheckpointManager(str(tmp_path))
    saved = _state(1, torch.bfloat16)
    saved.opt_state["mu"]["embed"] = saved.opt_state["mu"]["embed"].float() + 0.5
    ck.save(1, saved)
    state, _, _ = ck.restore(_state(0, torch.bfloat16))
    assert _equal(state, saved) and state.opt_state["mu"]["embed"].dtype == torch.float32


@pytest.mark.parametrize("change", ["shape", "narrower", "int", "missing", "type",
                                    "wider_params", "wider_outside_a_train_state"])
def test_checkpoint_refuses_a_mismatched_template(tmp_path, change):
    """Every leaf is held to the template's shape, type and dtype; only the
    optimizer state of a TrainState may come back wider."""
    ck = CheckpointManager(str(tmp_path))
    ck.save(1, _state(1))
    t = _state()
    if change == "wider_params":                  # f32 params under a bf16 config
        t = _state(0, torch.bfloat16)
        t.opt_state["mu"]["embed"] = t.opt_state["mu"]["embed"].float()
    elif change == "wider_outside_a_train_state":
        ck.save(2, {"opt_state": _state(2).opt_state})
        t = {"opt_state": _state(0, torch.bfloat16).opt_state}
    elif change == "shape":
        t.params["embed"] = torch.zeros(6, 5)
    elif change == "narrower":
        ck.save(2, _state(2, torch.bfloat16))
        t = _state(0, torch.float64)
    elif change == "int":
        t.params["embed"] = torch.zeros(6, 4, dtype=torch.int32)
    elif change == "missing":
        t.params["blocks"]["wk"] = torch.zeros(2, 4, 4)
    else:
        t.opt_state["count"] = 0.0
    with pytest.raises(ValueError):
        ck.restore(t)


@pytest.mark.parametrize("preset", ["qwen2_0_5b", "qwen2_1_5b", "qwen2_7b", "qwen3_0_6b",
                                    "qwen3_1_7b", "qwen3_moe_30b_a3b", "qwen3_moe_2b", "tiny"])
def test_flops_match(preset):
    jc, tc = getattr(JConfig, preset)(), getattr(TConfig, preset)()
    assert TF.model_matmul_flops_per_token(tc) == JF.model_matmul_flops_per_token(jc)
