"""Multi-process GRPO drill: ``ReasoningRunner(mesh=)`` and the
disaggregated runner across processes, one a rank.

Port of ``examples/distributed/multiprocess_runner_drill.py``. N processes
(``--num-processes``) form a ``torch.distributed`` world and drive the SAME
``ReasoningRunner`` over one mesh of data x fsdp x tensor (fsdp=2 and
tensor=2 at 4 or more ranks, as the JAX drill's mesh ``data=-1, fsdp=2,
tensor=2``):

  * the prompts are split over the batch axes, the rollout results
    gathered to every rank, every rank scores and assembles the batch and
    trains on its rows; the reward is the mean byte value of the response,
    so rewards vary within every GRPO group and the losses and grad norms
    are nonzero; two PPO epochs a batch, so the second epoch's ratios
    leave 1;
  * phase A: 3 GRPO steps with a checkpoint at step 2 (every rank takes
    part in the save; the mesh's first rank writes). Rank 0 keeps step 1's
    rollout, and a world of ONE process trains a plain ``ReasoningRunner``
    on it from the same weights: its loss and grad norm must match the
    sharded step's within the drill's tolerance;
  * the processes exit (the "kill"); phase B: new processes resume from
    the checkpoint and train 2 more steps;
  * phase C (in B's processes): ``DisaggregatedReasoningRunner`` with the
    actor on the even ranks and the rollout on the odd ones, 2 decoupled
    PPO steps, the rollout's weights checked against the actor's after
    every sync;
  * the parent asserts that every step's loss and grad norm are
    bit-identical across ranks in every phase and nonzero in A and B,
    that B resumed from A's last save, and that each sync left the rollout
    ranks with the actor's weights.

``--device cpu`` runs the ranks on the CPU over gloo; ``--device cuda``
(the default) puts them on the card(s): NCCL when each rank has a card of
its own, gloo when they share one, where every kernel runs at the local
(sharded) shapes a multi-GPU machine gives it. ``--model mini`` (8 layers,
hidden 512, f32) or an ``LLMConfig`` preset (``qwen2_0_5b``: bf16 at the
preset's widths); ``--num-layers`` cuts the depth. Prints one JSON line,
the summary, last.

Usage: python -m rlinf_tpu_torch.multiprocess_runner_drill \\
         --device cpu --num-processes 4 --model mini
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional


class ModTokenizer:
    """ByteTokenizer view for large-vocab drill models: ids decode through
    ``(id - 2) mod 256`` so random samples from a big vocab still yield
    text (and reward variance) instead of an empty string."""

    pad_id = 0
    eos_id = 1

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def encode(self, text):
        return [b + 2 for b in text.encode("utf-8")]

    def decode(self, ids):
        return bytes((i - 2) % 256 for i in ids if i >= 2).decode("utf-8", errors="replace")


def reward_mean_byte(texts, answers):
    """Mean byte value of the response: continuous, almost surely distinct
    across temperature-1.0 samples, so every group has reward variance."""
    out = []
    for t in texts:
        bs = t.encode("utf-8", errors="replace")
        out.append(float(sum(bs)) / (255.0 * max(len(bs), 1)))
    return out


def model_config(name: str, num_layers: Optional[int] = None):
    from rlinf_tpu_torch.models.llm.config import LLMConfig

    if name == "mini":
        cfg = LLMConfig(vocab_size=258, hidden_size=512, intermediate_size=1408,
                        num_layers=8, num_heads=8, num_kv_heads=4, max_seq_len=128,
                        dtype="float32", qkv_bias=False, rope_theta=1e4)
    else:
        cfg = dataclasses.replace(getattr(LLMConfig, name)(), max_seq_len=128)
    if num_layers:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    return cfg


def mesh_config(world: int):
    """The JAX drill's ``data=-1, fsdp=2, tensor=2`` where the world
    allows it."""
    from rlinf_tpu_torch.parallel.mesh import MeshConfig

    return MeshConfig(data=-1, fsdp=2 if world >= 2 else 1, tensor=2 if world >= 4 else 1)


def trainer_config(opts: Dict, ckpt_dir: Optional[str], max_steps: int):
    from rlinf_tpu_torch.config import (
        AlgorithmConfig, DataConfig, RolloutConfig, RunnerConfig, TrainerConfig,
    )
    from rlinf_tpu_torch.models.llm.sampler import SamplingParams
    from rlinf_tpu_torch.training.learner import PolicyLossConfig
    from rlinf_tpu_torch.training.train_state import OptimizerConfig

    on_card = opts["device"] == "cuda"
    return TrainerConfig(
        model=model_config(opts["model"], opts.get("num_layers")),
        sampling=SamplingParams(max_new_tokens=8, temperature=1.0, eos_token_id=-1,
                                pad_token_id=0),
        optimizer=OptimizerConfig(lr=5e-4, clip_grad=1.0),
        loss=PolicyLossConfig(clip_ratio_low=0.2, clip_ratio_high=0.2),
        algorithm=AlgorithmConfig(adv_type="grpo", group_size=4),
        rollout=RolloutConfig(engine="static", prompt_bucket=16),
        data=DataConfig(max_prompt_len=32),
        runner=RunnerConfig(rollout_batch_size=4, max_steps=max_steps,
                            seed=0, checkpoint_dir=ckpt_dir, save_interval=2, resume="auto",
                            num_epochs=2),
        # the card runs the attention kernels at any length (K1, K7, K8)
        attn_impl="pallas" if on_card else "xla",
        remat=False,
    )


def _dataset():
    from rlinf_tpu_torch.data.datasets import PromptDataset, PromptExample

    return PromptDataset([PromptExample(f"question {i}:", "unused") for i in range(16)])


def _tokenizer(cfg):
    from rlinf_tpu_torch.data.tokenizers import ByteTokenizer

    return ByteTokenizer() if cfg.model.vocab_size == 258 else ModTokenizer(cfg.model.vocab_size)


def _launches() -> Dict[str, int]:
    from rlinf_tpu_torch.ops.cuda import kernels

    return {name: k.launches for name, k in kernels().items()}


def _reset_launches() -> None:
    from rlinf_tpu_torch.ops.cuda import kernels

    for k in kernels().values():
        k.launches = 0


def _peak_gib(device: str) -> Optional[float]:
    import torch

    return torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else None


def drill_rank(rank: int, world: int, opts: Dict, phase: str, workdir: str) -> Dict:
    """One rank of phase "A" (3 steps, checkpointed) or "BC" (resume to
    step 5, then the disaggregated steps)."""
    import torch

    from rlinf_tpu_torch.parallel import collectives as C
    from rlinf_tpu_torch.parallel.mesh import ComponentPlacement, MeshConfig, make_mesh
    from rlinf_tpu_torch.runners.reasoning_runner import ReasoningRunner

    device = opts["device"]
    on_card = device == "cuda"
    if on_card:
        from rlinf_tpu_torch.ops.cuda import build

        build()
        torch.cuda.reset_peak_memory_stats()
    ckpt_dir = os.path.join(workdir, "ckpt")
    max_steps = 3 if phase == "A" else 5
    cfg = trainer_config(opts, ckpt_dir, max_steps)
    tok = _tokenizer(cfg)
    mesh = make_mesh(mesh_config(world))
    runner = ReasoningRunner(cfg, tok, _dataset(), mesh=mesh, reward_fn=reward_mean_byte,
                             device=device)
    start = runner.global_step
    _reset_launches()
    C.reset_counts()
    history, step_s = [], []
    if phase == "A":
        # step 1 by hand, to keep its rollout for the world-1 reference
        t0 = time.perf_counter()
        result = runner._rollout_phase(runner._policy_params())
        if rank == 0:
            torch.save(result, os.path.join(workdir, "step1_rollout.pt"))
        history.append(runner._train_on_result(result))
        step_s.append(time.perf_counter() - t0)
    while runner.global_step < max_steps:
        t0 = time.perf_counter()
        history.append(runner.run_step())
        step_s.append(time.perf_counter() - t0)
    n_steps = max(len(history), 1)
    out = {
        "rank": rank, "start_step": start, "end_step": runner.global_step,
        "losses": [h["actor/loss"] for h in history],
        "grad_norms": [h["actor/grad_norm"] for h in history],
        "reward_stds": [h.get("rollout/reward_std", 0.0) for h in history],
        "step_s": step_s,
        "all_reduce_per_step": C.counts().get("all_reduce", 0) / n_steps,
        "collectives": C.counts(),
        "launches": _launches() if on_card else {},
        "peak_gib": _peak_gib(device),
        "mesh": dict(mesh.shape),
    }
    del runner
    if phase != "BC":
        return out

    # phase C: actor on the even ranks, rollout on the odd ones
    from rlinf_tpu_torch.runners.disaggregated_runner import DisaggregatedReasoningRunner
    from rlinf_tpu_torch.training.learner import PolicyLossConfig

    placement = ComponentPlacement(
        components={"actor": list(range(0, world, 2)), "rollout": list(range(1, world, 2))},
        mesh_configs={"actor": MeshConfig(data=-1), "rollout": MeshConfig(data=-1)},
    )
    dcfg = dataclasses.replace(
        cfg,
        loss=PolicyLossConfig(clip_ratio_low=0.2, clip_ratio_high=0.2, loss_type="decoupled"),
        runner=dataclasses.replace(cfg.runner, checkpoint_dir=None, max_steps=2, resume="none"),
    )
    _reset_launches()
    drunner = DisaggregatedReasoningRunner(dcfg, tok, _dataset(), placement=placement,
                                           reward_fn=reward_mean_byte, check_sync=True,
                                           device=device)
    dh = drunner.run()
    out.update({
        "disagg_role": "actor" if drunner.is_actor else "rollout",
        "disagg_losses": [h["actor/loss"] for h in dh],
        "disagg_version_lags": [h["disagg/version_lag"] for h in dh],
        "disagg_sync_max_abs": [h["disagg/sync_max_abs"] for h in dh],
        "disagg_sync_s": [h["disagg/sync_s"] for h in dh],
        "disagg_sync_bytes": [h["disagg/sync_bytes"] for h in dh],
        "disagg_param_version": drunner.param_version,
        "disagg_launches": _launches() if on_card else {},
    })
    return out


def reference_rank(rank: int, world: int, opts: Dict, workdir: str):
    """A world of one: a plain ``ReasoningRunner`` trains on phase A's
    first rollout from the same weights."""
    import torch

    from rlinf_tpu_torch.runners.reasoning_runner import ReasoningRunner

    device = opts["device"]
    if device == "cuda":
        from rlinf_tpu_torch.ops.cuda import build

        build()
    cfg = trainer_config(opts, None, 3)
    runner = ReasoningRunner(cfg, _tokenizer(cfg), _dataset(), reward_fn=reward_mean_byte,
                             device=device)
    result = torch.load(os.path.join(workdir, "step1_rollout.pt"), weights_only=False)
    m = runner._train_on_result(result)
    return {"loss": m["actor/loss"], "grad_norm": m["actor/grad_norm"]}


def _assert_identical_nonzero(results: List[Dict], key: str, *, nonzero=True, phase=""):
    for step, vals in enumerate(zip(*(r[key] for r in results))):
        assert len(set(vals)) == 1, f"{phase} {key} step {step} differs across ranks: {vals}"
        if nonzero:
            assert abs(vals[0]) > 1e-12, f"{phase} {key} step {step} is ~zero ({vals[0]})"


#: step 1 of the sharded runner against the world-1 runner: (rel, abs) on
#: the loss and the grad norm. f32 on the CPU differs by the order of the
#: reductions alone; bf16 on the card also rounds each rank's partial
#: products before the all-reduce that adds them
TOLERANCE = {"cpu": (1e-3, 1e-6), "cuda": (2e-2, 1e-3)}


def run_drill(opts: Dict) -> Dict:
    """Phases A, B and C and the world-1 reference; raises on a failed
    check, returns the summary."""
    from rlinf_tpu_torch.parallel.launch import spawn_world

    n, device = opts["num_processes"], opts["device"]
    workdir = tempfile.mkdtemp(prefix="mp_runner_drill_", dir=opts.get("workdir"))
    try:
        t0 = time.perf_counter()
        a = spawn_world(drill_rank, n, (opts, "A", workdir), device=device,
                        workdir=os.path.join(workdir, "world_a"))
        t_a = time.perf_counter() - t0
        assert all(r["start_step"] == 0 and r["end_step"] == 3 for r in a), a
        _assert_identical_nonzero(a, "losses", phase="A")
        _assert_identical_nonzero(a, "grad_norms", phase="A")
        for r in a:
            assert all(s > 0 for s in r["reward_stds"]), r["reward_stds"]
        ref = spawn_world(reference_rank, 1, (opts, workdir), device=device,
                          workdir=os.path.join(workdir, "world_ref"))[0]
        rel, ab = TOLERANCE[device]
        for key, got in (("loss", a[0]["losses"][0]), ("grad_norm", a[0]["grad_norms"][0])):
            assert abs(got - ref[key]) <= rel * abs(ref[key]) + ab, (
                f"step 1 {key}: sharded {got} against world-1 {ref[key]} "
                f"(rel {rel}, abs {ab})")
        t0 = time.perf_counter()
        b = spawn_world(drill_rank, n, (opts, "BC", workdir), device=device,
                        workdir=os.path.join(workdir, "world_bc"))
        t_bc = time.perf_counter() - t0
        assert all(r["start_step"] == 2 for r in b), (
            f"resume did not pick up the checkpoint: {[r['start_step'] for r in b]}")
        assert all(r["end_step"] == 5 for r in b), b
        _assert_identical_nonzero(b, "losses", phase="B")
        _assert_identical_nonzero(b, "grad_norms", phase="B")
        _assert_identical_nonzero(b, "disagg_losses", nonzero=False, phase="C")
        for r in b:
            assert r["disagg_param_version"] == 2, r["disagg_param_version"]
            assert r["disagg_version_lags"] == [0.0, 1.0], r["disagg_version_lags"]
            assert all(d == 0.0 for d in r["disagg_sync_max_abs"]), r["disagg_sync_max_abs"]
        return {
            "multiprocess_runner": True, "num_processes": n, "device": device,
            "model": opts["model"], "num_layers": model_config(
                opts["model"], opts.get("num_layers")).num_layers,
            "mesh": a[0]["mesh"],
            "phase_a_losses": a[0]["losses"], "phase_a_grad_norms": a[0]["grad_norms"],
            "world1_step1": ref, "tolerance": TOLERANCE[device],
            "resume_start_step": b[0]["start_step"], "phase_b_losses": b[0]["losses"],
            "disagg_losses": b[0]["disagg_losses"],
            "disagg_version_lags": b[0]["disagg_version_lags"],
            "disagg_sync_s": b[0]["disagg_sync_s"], "disagg_sync_bytes": b[0]["disagg_sync_bytes"],
            "step_s_a": {r["rank"]: r["step_s"] for r in a},
            "step_s_b": {r["rank"]: r["step_s"] for r in b},
            "all_reduce_per_step": {r["rank"]: r["all_reduce_per_step"] for r in a},
            "peak_gib": {r["rank"]: r["peak_gib"] for r in b},
            "launches_a": {r["rank"]: r["launches"] for r in a},
            "launches_b": {r["rank"]: r["launches"] for r in b},
            "launches_c": {r["rank"]: (r["disagg_role"], r["disagg_launches"]) for r in b},
            "phase_seconds": {"A": t_a, "BC": t_bc},
            "ok": True,
        }
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--num-processes", type=int, default=4)
    ap.add_argument("--model", default="mini")
    ap.add_argument("--num-layers", type=int, default=None,
                    help="cut the model's depth (widths stay the preset's)")
    ap.add_argument("--workdir", default=None, help="parent of the drill's scratch directory")
    args = ap.parse_args(argv)
    opts = {k.replace("-", "_"): v for k, v in vars(args).items()}
    if opts["device"] == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --device cpu to drill on the CPU")
    print(json.dumps(run_drill(opts)), flush=True)


if __name__ == "__main__":
    main()
