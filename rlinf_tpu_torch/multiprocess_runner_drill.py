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
    rollout; in phase B's processes, before it joins a mesh, rank 0 trains
    a plain ``ReasoningRunner`` (no mesh: a world of one) on it from the
    same weights: its loss and grad norm must match the sharded step's
    within the drill's tolerance;
  * the processes exit (the "kill"); phase B: new processes resume from
    the checkpoint and train 2 more steps;
  * phase C (in B's processes): ``DisaggregatedReasoningRunner`` with the
    actor on the even ranks and the rollout on the odd ones, 2 decoupled
    PPO steps, the rollout's weights checked against the actor's after
    every sync;
  * then, in B's processes, the parts of the context axis and of the mesh
    configurations (``parts_rank``): (a) the ring train step on data=1 x
    context=N (``--ring-seq-len`` tokens a row, 3 steps; step 1 held
    against a world-1 step of the same weights and batch with the plain
    attention, on rank 0); (b) the GRPO runner with ``attn_impl=ring`` on
    data=1 x context=2 x tensor=2 (2 steps; every rank's sampled tokens
    bitwise equal); (c) one step each at fsdp=2 x tensor=2 of
    ``SFTRunner``, the runner with LoRA, with the token budget, with
    adafactor, and with an MoE model (``moe_model_config``, capacity);
    (d) one rollout each of the continuous engine (int8 KV), the same with
    the megakernel (``use_mega``: the params gathered whole) and the paged
    engine at data=2 x tensor=2 (every rank the same tokens); (e) one GRPO
    step of the MoE model (capacity) at fsdp=2 x expert=2, held on rank 0
    against a world-1 runner step on the same weights and rollout; (f)
    ``moe_layer_dropless_ep`` forward and backward over an expert group of
    every rank, held on rank 0 against ``moe_layer_dropless`` on the whole
    batch, with the exchange's bytes and seconds; (g) one ring train step
    of the MoE model at expert=2 x context=2 (``--moe-seq-len`` tokens a
    row) against the world-1 step; (h) a ``DynamicScheduler`` that
    migrates, and a ``StandbyMigrator`` moving a train state from a data=2
    submesh of ranks {0, 1} onto fsdp=2 x tensor=2 over every rank, then
    one step, against a state built there directly. Each part reports its
    seconds, its kernel launches and its collectives;
  * the parent asserts that every step's loss and grad norm are
    bit-identical across ranks in every phase and nonzero in A and B,
    that B resumed from A's last save, that each sync left the rollout
    ranks with the actor's weights, and the parts' checks above.

``--device cpu`` runs the ranks on the CPU over gloo; ``--device cuda``
(the default) puts them on the card(s): NCCL when each rank has a card of
its own, gloo when they share one, where every kernel runs at the local
(sharded) shapes a multi-GPU machine gives it. ``--model mini`` (8 layers,
hidden 512, f32) or an ``LLMConfig`` preset (``qwen2_0_5b``: bf16 at the
preset's widths); ``--num-layers`` cuts the depth (of the MoE model
too). Prints one JSON line, the summary, last.

Usage: python -m rlinf_tpu_torch.multiprocess_runner_drill \\
         --device cpu --num-processes 4 --model mini --ring-seq-len 512 \\
         --moe-seq-len 256
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


def moe_model_config(name: str, num_layers: Optional[int] = None):
    """The MoE model of part (c): ``qwen3_moe_2b``'s widths (32 experts,
    top-2) beside a preset, a mini MoE (8 experts) beside ``mini``."""
    from rlinf_tpu_torch.models.llm.config import LLMConfig

    if name == "mini":
        cfg = dataclasses.replace(model_config("mini"), intermediate_size=256, num_experts=8,
                                  num_experts_per_token=2)
    else:
        cfg = dataclasses.replace(LLMConfig.qwen3_moe_2b(), max_seq_len=128)
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
    # phase A's world-1 reference, before this rank joins a mesh (the other
    # ranks wait for it in the mesh's first collective)
    world1 = world1_step1(opts, workdir) if phase == "BC" and rank == 0 else None
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
        "rank": rank, "start_step": start, "end_step": runner.global_step, "world1": world1,
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
    del drunner
    out["parts"] = parts_rank(rank, world, opts, cfg, tok)
    return out


# ---------------------------------------------------------------------------
# The parts of the context axis and the mesh configurations
# ---------------------------------------------------------------------------

def _sync(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


def _timed(device: str, fn):
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def _part(device: str, fn) -> Dict:
    """Run one part: its result, seconds, launches and collectives."""
    from rlinf_tpu_torch.parallel import collectives as C

    if device == "cuda":
        import torch

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    C.reset_counts()
    result, seconds = _timed(device, fn)
    return {**result, "seconds": seconds, "launches": _launches() if device == "cuda" else {},
            "collectives": C.counts(), "peak_gib": _peak_gib(device)}


def _ring_batch(vocab: int, T: int, seed: int = 7) -> Dict:
    """2 rows of T tokens, the second right-padded; the loss on the second
    half of each row's tokens."""
    import numpy as np

    r = np.random.default_rng(seed)
    attn = np.ones((2, T), bool)
    attn[1, T - T // 16:] = False
    loss_mask = attn & (np.arange(T)[None, :] >= T // 2)
    return {"input_ids": np.where(attn, r.integers(2, vocab, (2, T)), 0).astype(np.int32),
            "target_ids": r.integers(2, vocab, (2, T)).astype(np.int32),
            "attention_mask": attn, "loss_mask": loss_mask,
            "old_logprobs": np.where(loss_mask, -np.log(vocab), 0).astype(np.float32),
            "advantages": (r.normal(size=(2, T)) * loss_mask).astype(np.float32)}


def ring_step_part(rank: int, world: int, opts: Dict, params_of) -> Dict:
    """(a): 3 ring train steps on data=1 x context=world from one init; on
    rank 0 the world-1 step 1 (same weights, same batch, the plain
    attention: the kernels on the card)."""
    import torch

    from rlinf_tpu_torch.models.llm import model as M
    from rlinf_tpu_torch.parallel import collectives as C
    from rlinf_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from rlinf_tpu_torch.training.learner import PolicyLossConfig, make_policy_train_step
    from rlinf_tpu_torch.training.train_state import (
        OptimizerConfig, create_train_state, make_optimizer,
    )

    device, T = opts["device"], opts["ring_seq_len"]
    cfg = dataclasses.replace(model_config(opts["model"], opts.get("num_layers")),
                              max_seq_len=T)
    mesh = make_mesh(MeshConfig(data=1, context=world))
    batch = _ring_batch(cfg.vocab_size, T)
    tx = make_optimizer(OptimizerConfig(lr=5e-4, clip_grad=1.0))
    loss_cfg = PolicyLossConfig(logprob_chunk_size=1024)
    params = params_of(cfg)
    keep = params_of(cfg) if rank == 0 else None
    state = create_train_state(lambda: params, tx, mesh=mesh, partition_rules=M.partition_rules())
    step = make_policy_train_step(cfg, loss_cfg, tx, remat=True, attn_impl="ring", mesh=mesh,
                                  device=device)
    losses, norms, step_s, shifts = [], [], [], []
    for _ in range(3):
        before = C.counts().get("ring_shift", 0)
        (state, m), sec = _timed(device, lambda: step(state, batch))
        losses.append(float(m["actor/loss"]))
        norms.append(float(m["actor/grad_norm"]))
        step_s.append(sec)
        shifts.append(C.counts().get("ring_shift", 0) - before)
    out = {"losses": losses, "grad_norms": norms, "step_s": step_s, "shifts_per_step": shifts,
           "seq_len": T, "chunk": T // world, "mesh": dict(mesh.shape)}
    del state, step
    if rank == 0:
        ring_launches = _launches() if device == "cuda" else {}
        _reset_launches()
        plain = "pallas" if device == "cuda" else "xla"
        ref_step = make_policy_train_step(cfg, loss_cfg, tx, remat=True, attn_impl=plain,
                                          device=device)
        _, m = ref_step(create_train_state(lambda: keep, tx), batch)
        out["world1"] = {"loss": float(m["actor/loss"]), "grad_norm": float(m["actor/grad_norm"]),
                         "attn_impl": plain,
                         "launches": _launches() if device == "cuda" else {}}
        _restore_launches(ring_launches, device)   # the part's own: the ring steps'
        del keep
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def ring_runner_part(rank: int, world: int, opts: Dict, params_of) -> Dict:
    """(b): 2 GRPO steps of ``ReasoningRunner(mesh=)`` with
    ``attn_impl=ring`` on data=1 x context=2 x tensor=2."""
    from rlinf_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from rlinf_tpu_torch.runners.reasoning_runner import ReasoningRunner

    cfg = dataclasses.replace(trainer_config(opts, None, 2), attn_impl="ring")
    mesh = make_mesh(MeshConfig(data=1, context=2, tensor=2))
    runner = ReasoningRunner(cfg, _tokenizer(cfg), _dataset(), mesh=mesh,
                             reward_fn=reward_mean_byte, device=opts["device"],
                             init_params_override=lambda s: params_of(cfg.model))
    tokens, losses = [], []
    for _ in range(2):
        result = runner._rollout_phase(runner._policy_params())
        tokens.append(result.response_ids.tolist())
        losses.append(runner._train_on_result(result)["actor/loss"])
    return {"tokens": tokens, "losses": losses, "mesh": dict(mesh.shape)}


def _sft_dataset():
    from rlinf_tpu_torch.data.datasets import PromptDataset, PromptExample

    return PromptDataset([PromptExample(f"question {i}:", f" answer {2 * i + 1}")
                          for i in range(16)])


def config_part(rank: int, world: int, opts: Dict, kind: str, params_of) -> Dict:
    """(c): one step at fsdp=2 x tensor=2 of ``SFTRunner`` ("sft") or of
    the runner with LoRA ("lora"), the token budget ("budget"), adafactor
    ("adafactor") or the MoE model ("moe")."""
    from rlinf_tpu_torch.models.llm.lora import LoRAConfig
    from rlinf_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from rlinf_tpu_torch.runners.reasoning_runner import ReasoningRunner
    from rlinf_tpu_torch.runners.sft_runner import SFTRunner

    cfg = trainer_config(opts, None, 1)
    cfg = dataclasses.replace(cfg, runner=dataclasses.replace(cfg.runner, num_epochs=1))
    if kind == "lora":
        cfg = dataclasses.replace(cfg, lora=LoRAConfig(enabled=True, rank=8))
    elif kind == "budget":
        cfg = dataclasses.replace(cfg, loss=dataclasses.replace(cfg.loss, max_tokens_per_mb=256))
    elif kind == "adafactor":
        cfg = dataclasses.replace(cfg, optimizer=dataclasses.replace(cfg.optimizer,
                                                                      name="adafactor"))
    elif kind == "moe":
        cfg = dataclasses.replace(cfg, model=moe_model_config(opts["model"],
                                                              opts.get("num_layers")))
    mesh = make_mesh(MeshConfig(data=1, fsdp=2, tensor=2))
    if kind == "sft":
        runner = SFTRunner(cfg, _tokenizer(cfg), _sft_dataset(), mesh=mesh,
                           device=opts["device"],
                           init_params_override=lambda s: params_of(cfg.model))
        m = runner.run_step()
        return {"loss": m["sft/loss"], "grad_norm": m["sft/grad_norm"]}
    runner = ReasoningRunner(cfg, _tokenizer(cfg), _dataset(), mesh=mesh,
                             reward_fn=reward_mean_byte, device=opts["device"],
                             init_params_override=lambda s: params_of(cfg.model))
    m = runner.run_step()
    return {"loss": m["actor/loss"], "grad_norm": m["actor/grad_norm"],
            "microbatches": m.get("actor/num_dyn_microbatches")}


def engine_part(rank: int, world: int, opts: Dict, kind: str, params_of) -> Dict:
    """(d): one rollout of 12 requests of the continuous engine with an
    int8 KV cache ("continuous"), the same with the megakernel
    ("continuous_mega") or the paged engine ("paged") at data=2 x
    tensor=2; the pool whole on every rank."""
    import numpy as np
    import torch

    from rlinf_tpu_torch.data.io_struct import RolloutRequest
    from rlinf_tpu_torch.models.llm import model as M
    from rlinf_tpu_torch.models.llm.sampler import SamplingParams
    from rlinf_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from rlinf_tpu_torch.parallel.sharding import Layout
    from rlinf_tpu_torch.rollout.continuous_engine import ContinuousBatchingEngine
    from rlinf_tpu_torch.rollout.paged_engine import PagedContinuousEngine

    device = opts["device"]
    cfg = model_config(opts["model"], opts.get("num_layers"))
    mesh = make_mesh(MeshConfig(data=2, tensor=2))
    full = params_of(cfg)
    params = Layout.from_rules(mesh, M.partition_rules(), full).shard(full)
    del full
    sp = SamplingParams(max_new_tokens=16, temperature=1.0, eos_token_id=-1, pad_token_id=0)
    common = dict(num_slots=8, prompt_bucket=16, decode_chunk=8, device=device)
    if kind == "paged":
        eng = PagedContinuousEngine(cfg, sp, max_seq_len=64, page_size=16,
                                    attn_impl="pallas" if device == "cuda" else "xla", **common)
    else:
        quant = "int8" if device == "cuda" else "none"
        mega = kind == "continuous_mega"
        eng = ContinuousBatchingEngine(
            cfg, sp, max_seq_len=128 if mega else 64, weight_quant="int8" if mega else quant,
            kv_quant="int8", use_mega=mega, **common)
    r = np.random.default_rng(3)
    req = RolloutRequest(prompt_ids=[r.integers(2, 250, n).tolist() for n in
                                     r.integers(4, 30, 12)])
    res = eng.rollout(params, req, torch.Generator().manual_seed(9), mesh=mesh)
    return {"tokens": res.response_ids.tolist(),
            "finite": bool(np.isfinite(res.response_logprobs).all())}


def _world1_runner_step(cfg, result, device: str, params=None) -> Dict:
    """A world of one: a plain ``ReasoningRunner`` (no mesh) from
    ``params`` (None: its own init) trains on ``result`` (the same
    rollout)."""
    from rlinf_tpu_torch.runners.reasoning_runner import ReasoningRunner

    runner = ReasoningRunner(cfg, _tokenizer(cfg), _dataset(), reward_fn=reward_mean_byte,
                             device=device,
                             init_params_override=None if params is None else lambda s: params)
    m = runner._train_on_result(result)
    return {"loss": m["actor/loss"], "grad_norm": m["actor/grad_norm"]}


def moe_ep_part(rank: int, world: int, opts: Dict, params_of) -> Dict:
    """(e): one GRPO step of ``ReasoningRunner(mesh=)`` of the MoE model
    (capacity routing) at fsdp=2 x expert=2: the rollout (the expert stacks
    gathered whole), the recompute and the sharded train step (each expert
    rank computes its 16 of 32 experts); on rank 0 then a world-1 runner
    step on the same weights and rollout."""
    from rlinf_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from rlinf_tpu_torch.runners.reasoning_runner import ReasoningRunner

    device = opts["device"]
    cfg = trainer_config(opts, None, 1)
    cfg = dataclasses.replace(cfg, model=moe_model_config(opts["model"], opts.get("num_layers")),
                              runner=dataclasses.replace(cfg.runner, num_epochs=1))
    mesh = make_mesh(MeshConfig(data=1, fsdp=2, expert=2))
    keep = params_of(cfg.model) if rank == 0 else None
    runner = ReasoningRunner(cfg, _tokenizer(cfg), _dataset(), mesh=mesh,
                             reward_fn=reward_mean_byte, device=device,
                             init_params_override=lambda s: params_of(cfg.model))
    result = runner._rollout_phase(runner._policy_params())
    m = runner._train_on_result(result)
    out = {"tokens": result.response_ids.tolist(), "loss": m["actor/loss"],
           "grad_norm": m["actor/grad_norm"], "mesh": dict(mesh.shape)}
    del runner
    if rank == 0:                     # its launches are the reference's, not the part's
        launches = _launches() if device == "cuda" else {}
        out["world1"] = _world1_runner_step(cfg, result, device, keep)
        _restore_launches(launches, device)
    return out


def _restore_launches(launches: Dict[str, int], device: str) -> None:
    if device == "cuda":
        from rlinf_tpu_torch.ops.cuda import kernels

        for k, c in launches.items():
            kernels()[k].launches = c


def moe_ep_dropless_part(rank: int, world: int, opts: Dict, params_of) -> Dict:
    """(f): ``moe_layer_dropless_ep`` forward and backward over an expert
    group of every rank (``qwen3_moe_2b``'s widths: 32 experts top-2, D
    1024, expert ffn 768; 4 rows x 512 tokens a rank, f32), the exchange
    the backend's (on CUDA tensors of a gloo group, built from all-reduce);
    the output and every gradient gathered and held on rank 0 against
    ``moe_layer_dropless`` on the whole batch. Reports the exchanges' count,
    bytes (the rows they carry) and seconds."""
    import torch

    from rlinf_tpu_torch.ops import moe as MO
    from rlinf_tpu_torch.parallel import collectives as C
    from rlinf_tpu_torch.parallel.mesh import AxisNames as Ax, MeshConfig, make_mesh

    device = opts["device"]
    mcfg = moe_model_config(opts["model"], opts.get("num_layers"))
    moe = dataclasses.replace(mcfg.moe_config, impl="dropless")
    mesh = make_mesh(MeshConfig(data=1, expert=world))
    g, me = mesh.get_group(Ax.EXPERT), mesh.axis_index(Ax.EXPERT)
    E, D, F, rows, seq = moe.num_experts, mcfg.hidden_size, mcfg.intermediate_size, 4, 512
    gen = torch.Generator().manual_seed(17)           # the same draw on every rank
    full = {k: (torch.randn(shape, generator=gen) * 0.02).to(device)
            for k, shape in (("router", (D, E)), ("gate", (E, D, F)), ("up", (E, D, F)),
                             ("down", (E, F, D)))}
    x_all = torch.randn((rows * world, seq, D), generator=gen).to(device)
    n = E // world
    p = {"router": full["router"].clone().requires_grad_(True),
         **{k: full[k][me * n:(me + 1) * n].clone().requires_grad_(True)
            for k in ("gate", "up", "down")}}
    x = x_all[me * rows:(me + 1) * rows].clone().requires_grad_(True)
    stats = {"calls": 0, "bytes": 0, "seconds": 0.0}
    real = C._exchange

    def timed(t, send, recv, group):
        _sync(device)
        t0 = time.perf_counter()
        out = real(t, send, recv, group)
        _sync(device)
        stats["seconds"] += time.perf_counter() - t0
        stats["calls"] += 1
        stats["bytes"] += int(sum(send)) * t[0].numel() * t.element_size() if t.numel() else 0
        return out

    C._exchange = timed
    try:
        (out, aux), fwd_s = _timed(device, lambda: MO.moe_layer_dropless_ep(p, x, moe, mesh))
        _, bwd_s = _timed(device, lambda: ((out.float() ** 2).sum() + aux).backward())
    finally:
        C._exchange = real
    got = {"out": C.gather_tensor(out.detach(), 0, g), "dx": C.gather_tensor(x.grad, 0, g),
           **{f"d_{k}": C.gather_tensor(p[k].grad, 0, g) for k in ("gate", "up", "down")},
           "d_router": p["router"].grad}
    res = {"exchange": stats, "forward_s": fwd_s, "backward_s": bwd_s,
           "aux": float(aux.detach()),
           "tokens_per_rank": rows * seq}
    if rank == 0:
        ref = {k: v.clone().requires_grad_(True) for k, v in full.items()}
        xr = x_all.clone().requires_grad_(True)
        r_out, r_aux, _ = MO.moe_layer_dropless(ref, xr, moe)
        ((r_out.float() ** 2).sum() + r_aux).backward()
        want = {"out": r_out.detach(), "dx": xr.grad,
                **{f"d_{k}": ref[k].grad for k in ("gate", "up", "down", "router")}}
        res["rel_err"] = {k: float((got[k] - want[k]).abs().max() / want[k].abs().max())
                          for k in want}
        res["aux_rel_err"] = abs(res["aux"] - float(r_aux.detach())) / abs(float(r_aux.detach()))
    return res


def _train_batch(vocab: int, B: int, T: int, seed: int = 5) -> Dict:
    """B rows of T tokens, right-padded; the loss on each row's second half."""
    import numpy as np

    r = np.random.default_rng(seed)
    lens = r.integers(T // 2, T + 1, B)
    attn = np.arange(T)[None, :] < lens[:, None]
    loss_mask = attn & (np.arange(T)[None, :] >= T // 4)
    return {"input_ids": np.where(attn, r.integers(2, vocab, (B, T)), 0).astype(np.int32),
            "target_ids": r.integers(2, vocab, (B, T)).astype(np.int32),
            "attention_mask": attn, "loss_mask": loss_mask,
            "old_logprobs": np.where(loss_mask, -np.log(vocab), 0).astype(np.float32),
            "advantages": (r.normal(size=(B, T)) * loss_mask).astype(np.float32)}


def moe_context_part(rank: int, world: int, opts: Dict, params_of) -> Dict:
    """(g): one train step of the MoE model (capacity) at expert=2 x
    context=2 with ring attention (B=2, T=``--moe-seq-len``): the MoE
    layers' capacity, slots and statistics over the whole [B, T] batch; on
    rank 0 the world-1 steps of the same weights and batch through the
    attention kernels (on the card) and through the plain attention."""
    from rlinf_tpu_torch.models.llm import model as M
    from rlinf_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from rlinf_tpu_torch.training.learner import PolicyLossConfig, make_policy_train_step
    from rlinf_tpu_torch.training.train_state import (
        OptimizerConfig, create_train_state, make_optimizer, tree_map,
    )

    device, T = opts["device"], opts["moe_seq_len"]
    cfg = dataclasses.replace(moe_model_config(opts["model"], opts.get("num_layers")),
                              max_seq_len=T)
    mesh = make_mesh(MeshConfig(data=1, expert=2, context=2))
    batch = _ring_batch(cfg.vocab_size, T, seed=9)
    tx = make_optimizer(OptimizerConfig(lr=5e-4, clip_grad=1.0))
    loss_cfg = PolicyLossConfig(logprob_chunk_size=1024)
    keep = params_of(cfg) if rank == 0 else None
    state = create_train_state(lambda: params_of(cfg), tx, mesh=mesh,
                               partition_rules=M.partition_rules())
    step = make_policy_train_step(cfg, loss_cfg, tx, remat=True, attn_impl="ring", mesh=mesh,
                                  device=device)
    (state, m), sec = _timed(device, lambda: step(state, batch))
    out = {"loss": float(m["actor/loss"]), "grad_norm": float(m["actor/grad_norm"]),
           "aux": float(m["actor/moe_aux_loss"]), "step_s": sec, "seq_len": T,
           "mesh": dict(mesh.shape)}
    del state, step
    if rank == 0:
        # two world-1 steps: through the attention kernels on the card, and
        # through the plain attention (f32 softmax, as the ring's blocks)
        launches = _launches() if device == "cuda" else {}
        for key, impl in (("world1", "pallas" if device == "cuda" else "xla"),
                          ("world1_plain", "xla")):
            ref = make_policy_train_step(cfg, loss_cfg, tx, remat=True, attn_impl=impl,
                                         device=device)
            _, rm = ref(create_train_state(lambda: tree_map(lambda t: t.clone(), keep), tx),
                        batch)
            out[key] = {"loss": float(rm["actor/loss"]), "grad_norm": float(rm["actor/grad_norm"]),
                        "aux": float(rm["actor/moe_aux_loss"]), "attn_impl": impl}
        _restore_launches(launches, device)
        del keep
    return out


def migrate_part(rank: int, world: int, opts: Dict, params_of) -> Dict:
    """(h): a ``DynamicScheduler`` over the world's ranks is fed timings
    under which a disaggregated split wins (a slow rollout and a costly
    collocated switch) and must migrate; a ``StandbyMigrator`` prepared
    (on a thread) for the drill's fsdp=2 x tensor=2 mesh over every rank
    moves a train state from a data=2 submesh of ranks {0, 1} onto it and
    takes one step; the same step from a state built on that mesh
    directly. Reports the migration's seconds (the move and the step)."""
    from rlinf_tpu_torch.models.llm import model as M
    from rlinf_tpu_torch.parallel.dynamic_scheduler import (
        DynamicScheduler, StandbyMigrator, submesh,
    )
    from rlinf_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from rlinf_tpu_torch.training.learner import PolicyLossConfig, make_policy_train_step
    from rlinf_tpu_torch.training.sharded_step import model_layout
    from rlinf_tpu_torch.training.train_state import (
        OptimizerConfig, create_train_state, make_optimizer,
    )

    device = opts["device"]
    sched = DynamicScheduler(world, interval=2, warmup_steps=1, hysteresis=0.1,
                             sync_disaggregated_s=0.0)
    migs = [m for m in (sched.observe({"time/rollout": 3.0, "time/training": 1.0,
                                       "time/weight_sync": 1.5}) for _ in range(4)) if m]
    cfg = model_config(opts["model"], opts.get("num_layers"))
    rules = M.partition_rules()
    mesh_a = submesh(list(range(world)), 0, 2)
    mesh_b = make_mesh(MeshConfig(data=1, fsdp=2, tensor=2))
    tx = make_optimizer(OptimizerConfig(lr=5e-4, clip_grad=1.0))
    loss_cfg = PolicyLossConfig(logprob_chunk_size=1024)
    attn = "pallas" if device == "cuda" else "xla"
    batch = _train_batch(cfg.vocab_size, 8, 128)

    def build(mesh):
        return make_policy_train_step(cfg, loss_cfg, tx, remat=False, attn_impl=attn, mesh=mesh,
                                      device=device)

    state = (create_train_state(lambda: params_of(cfg), tx, mesh=mesh_a, partition_rules=rules)
             if mesh_a.contains() else None)
    mig = StandbyMigrator(build, rules)
    mig.prepare(mesh_b)
    t0 = time.perf_counter()
    mig.prepare(mesh_b, block=True)
    prepare_wait = time.perf_counter() - t0
    ready = mig.ready(mesh_b)
    (moved, m), move_s = _timed(device, lambda: mig.migrate(
        mesh_b, state, batch, old_layout=model_layout(cfg, mesh_a, rules=rules)))
    del state, moved
    direct = create_train_state(lambda: params_of(cfg), tx, mesh=mesh_b, partition_rules=rules)
    _, dm = build(mesh_b)(direct, batch)
    return {"migrations": [(x.step, x.plan.mode, x.plan.rollout_chips, x.plan.train_chips)
                           for x in migs],
            "ready": ready, "prepare_wait_s": prepare_wait, "migrate_and_step_s": move_s,
            "loss": float(m["actor/loss"]), "grad_norm": float(m["actor/grad_norm"]),
            "direct_loss": float(dm["actor/loss"]), "direct_grad_norm": float(dm["actor/grad_norm"])}


def parts_rank(rank: int, world: int, opts: Dict, cfg, tok) -> Dict:
    """The parts (a)-(h) in this world, in order, each with its report.
    The parts' initial params are drawn once a process for each model's
    shapes (``params_of`` hands each part a copy to train): the draw of a
    151,936-row embedding costs seconds on a host that four ranks share."""
    from rlinf_tpu_torch.models.llm import init_params
    from rlinf_tpu_torch.training.train_state import tree_map

    del cfg, tok
    device = opts["device"]
    drawn = {}

    def params_of(model_cfg):
        key = dataclasses.replace(model_cfg, max_seq_len=0)
        if key not in drawn:
            drawn[key] = init_params(model_cfg, 11, device=device)
        return tree_map(lambda t: t.clone(), drawn[key])

    run = lambda fn, *a: _part(device, lambda: fn(rank, world, opts, *a, params_of))
    parts = {"ring_step": run(ring_step_part), "ring_runner": run(ring_runner_part)}
    for kind in ("sft", "lora", "budget", "adafactor", "moe"):
        parts[kind] = run(config_part, kind)
    engines = ("continuous", "continuous_mega", "paged") if device == "cuda" else (
        "continuous", "paged")
    for kind in engines:
        parts[kind] = run(engine_part, kind)
    parts["moe_ep"] = run(moe_ep_part)
    parts["moe_ep_dropless"] = run(moe_ep_dropless_part)
    parts["moe_context"] = run(moe_context_part)
    parts["migrate"] = run(migrate_part)
    return parts


def world1_step1(opts: Dict, workdir: str) -> Dict:
    """A world of one: a plain ``ReasoningRunner`` (no mesh) trains on
    phase A's first rollout from the same weights."""
    import torch

    result = torch.load(os.path.join(workdir, "step1_rollout.pt"), weights_only=False)
    return _world1_runner_step(trainer_config(opts, None, 3), result, opts["device"])


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
#: part (e) against its world-1 runner step: (rel on the loss, rel on the
#: grad norm). Part (g) is held to TOLERANCE's relative bar, as part (a):
#: its ring attention (f32 einsums) and the world-1 step's kernels (bf16)
#: move the router's inputs, and the capacity routing's choices and drops
#: are discrete (on the card two world-1 steps, through the kernels and
#: through the plain attention, differ by ~0.3% in the loss; ``world1_plain``
#: is reported beside it)
MOE_TOLERANCE = (5e-3, 2e-2)
#: (f): the largest error of the output, the aux loss and every gradient
#: over the largest magnitude of the plain layer's (f32 both)
EP_DROPLESS_TOLERANCE = 1e-4


def check_parts(per_rank: List[Dict], device: str) -> Dict:
    """The parts' checks (the module docstring); returns their summary:
    per part its seconds (the slowest rank's), its launches summed over
    the ranks, rank 0's collectives and every rank's peak."""
    import math

    rel, ab = TOLERANCE[device]
    ring = [p["ring_step"] for p in per_rank]
    _assert_identical_nonzero(ring, "losses", phase="ring step")
    _assert_identical_nonzero(ring, "grad_norms", phase="ring step")
    w1 = ring[0]["world1"]
    for key, got in (("loss", ring[0]["losses"][0]), ("grad_norm", ring[0]["grad_norms"][0])):
        assert abs(got - w1[key]) <= rel * abs(w1[key]) + ab, (
            f"ring step 1 {key}: {got} against the world-1 step's {w1[key]} "
            f"(rel {rel}, abs {ab})")
    runner = [p["ring_runner"] for p in per_rank]
    assert all(r["tokens"] == runner[0]["tokens"] for r in runner), \
        "the ring runner's context ranks sampled different tokens"
    _assert_identical_nonzero(runner, "losses", nonzero=False, phase="ring runner")
    for kind in ("sft", "lora", "budget", "adafactor", "moe"):
        vals = [(p[kind]["loss"], p[kind]["grad_norm"]) for p in per_rank]
        assert len(set(vals)) == 1, f"{kind}: ranks differ: {vals}"
        assert all(math.isfinite(v) for v in vals[0]), f"{kind}: {vals[0]}"
    assert per_rank[0]["budget"]["microbatches"] >= 2, per_rank[0]["budget"]
    for kind in ("continuous", "continuous_mega", "paged"):
        if kind not in per_rank[0]:
            continue
        assert all(p[kind]["tokens"] == per_rank[0][kind]["tokens"] for p in per_rank), \
            f"{kind}: the ranks decoded different tokens"
        assert all(p[kind]["finite"] for p in per_rank), kind
    moe = [p["moe_ep"] for p in per_rank]
    assert all(r["tokens"] == moe[0]["tokens"] for r in moe), \
        "moe_ep: the ranks sampled different tokens"
    assert len({(r["loss"], r["grad_norm"]) for r in moe}) == 1, "moe_ep: ranks differ"
    _close_to_world1("moe_ep", moe[0], MOE_TOLERANCE)
    ctx = [p["moe_context"] for p in per_rank]
    assert len({(r["loss"], r["grad_norm"]) for r in ctx}) == 1, "moe_context: ranks differ"
    _close_to_world1("moe_context", ctx[0], TOLERANCE[device][:1] * 2)
    ep = per_rank[0]["moe_ep_dropless"]
    bar = EP_DROPLESS_TOLERANCE
    assert all(e <= bar for e in ep["rel_err"].values()) and ep["aux_rel_err"] <= bar, (
        f"moe_ep_dropless against moe_layer_dropless: {ep['rel_err']}, aux "
        f"{ep['aux_rel_err']} (bar {bar})")
    assert len({p["moe_ep_dropless"]["aux"] for p in per_rank}) == 1
    mig = [p["migrate"] for p in per_rank]
    assert all(r["migrations"] and r["migrations"][0][1] == "disaggregated" for r in mig), \
        f"migrate: the scheduler did not migrate: {mig[0]['migrations']}"
    assert all(r["ready"] for r in mig), "migrate: the standby step was not ready"
    assert len({(r["loss"], r["grad_norm"]) for r in mig}) == 1, "migrate: ranks differ"
    for key, rtol in (("loss", 1e-6), ("grad_norm", 1e-4)):
        got, want = mig[0][key], mig[0][f"direct_{key}"]
        assert abs(got - want) <= rtol * abs(want), (
            f"migrate: the migrated step's {key} {got} against the direct build's {want}")
    out = {}
    for name in per_rank[0]:
        launches: Dict[str, int] = {}
        for p in per_rank:
            for k, c in p[name]["launches"].items():
                launches[k] = launches.get(k, 0) + c
        out[name] = {"seconds": max(p[name]["seconds"] for p in per_rank),
                     "launches": launches, "collectives": per_rank[0][name]["collectives"],
                     "peak_gib": [p[name]["peak_gib"] for p in per_rank]}
    out["ring_step"].update({k: ring[0][k] for k in (
        "losses", "grad_norms", "step_s", "shifts_per_step", "seq_len", "chunk", "mesh")})
    out["ring_step"]["world1"] = w1
    for kind in ("sft", "lora", "budget", "adafactor", "moe"):
        out[kind].update(loss=per_rank[0][kind]["loss"], grad_norm=per_rank[0][kind]["grad_norm"])
    out["ring_runner"]["losses"] = runner[0]["losses"]
    for kind in ("moe_ep", "moe_context"):
        out[kind].update({k: v for k, v in per_rank[0][kind].items() if k != "tokens"})
    out["moe_ep_dropless"].update({k: per_rank[0]["moe_ep_dropless"][k] for k in (
        "exchange", "forward_s", "backward_s", "rel_err", "aux_rel_err", "tokens_per_rank")})
    out["moe_ep_dropless"]["exchange_s_per_rank"] = [
        p["moe_ep_dropless"]["exchange"]["seconds"] for p in per_rank]
    out["migrate"].update({k: v for k, v in mig[0].items()})
    return out


def _close_to_world1(name: str, got: Dict, tol, ref: str = "world1") -> None:
    """``got``'s loss and grad norm within (rel, rel) of its world-1 step
    ``ref``."""
    rel_loss, rel_norm = tol
    w1 = got[ref]
    for key, rel in (("loss", rel_loss), ("grad_norm", rel_norm)):
        assert abs(got[key] - w1[key]) <= rel * abs(w1[key]), (
            f"{name} {key}: {got[key]} against the {ref} step's {w1[key]} (rel {rel})")


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
        t0 = time.perf_counter()
        b = spawn_world(drill_rank, n, (opts, "BC", workdir), device=device,
                        workdir=os.path.join(workdir, "world_bc"))
        t_bc = time.perf_counter() - t0
        ref = b[0]["world1"]
        rel, ab = TOLERANCE[device]
        for key, got in (("loss", a[0]["losses"][0]), ("grad_norm", a[0]["grad_norms"][0])):
            assert abs(got - ref[key]) <= rel * abs(ref[key]) + ab, (
                f"step 1 {key}: sharded {got} against world-1 {ref[key]} "
                f"(rel {rel}, abs {ab})")
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
        parts = check_parts([r["parts"] for r in b], device)
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
            "parts": parts,
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
    ap.add_argument("--ring-seq-len", type=int, default=8192,
                    help="tokens a row of the ring train step (part a)")
    ap.add_argument("--moe-seq-len", type=int, default=2048,
                    help="tokens a row of the MoE step under the context axis (part g)")
    args = ap.parse_args(argv)
    opts = {k.replace("-", "_"): v for k, v in vars(args).items()}
    if opts["device"] == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --device cpu to drill on the CPU")
    print(json.dumps(run_drill(opts)), flush=True)


if __name__ == "__main__":
    main()
