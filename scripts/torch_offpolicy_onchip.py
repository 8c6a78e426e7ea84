#!/usr/bin/env python3
"""Readings of ``chip_smoke.py``'s phase 29 (the off-policy path and the
flow families) that the whole script does not repeat each run, on one GPU:

    python3 scripts/torch_offpolicy_onchip.py [--seed 0] [--sac-seeds 0 1 2 3 4]

1. sac: part (a), async SAC through ``main_sac_async`` at chip_smoke's
   ``SAC_PROOF`` settings, once for each of ``--sac-seeds`` with the
   snapshot recorder on (as chip_smoke runs it), then for the first two
   with it off: the deterministic eval's mean reward against the proof's
   bar, learner steps/s and syncs. The run depends on thread timing, so
   one seed read twice may differ.
2. pi0_init: ``Pi0Policy`` at part (e)'s full geometry (``PI0_TRUNK``,
   ``PI0_TOWER``, ``Pi0Config.pi0_full()``; 3.25 B params), its init drawn
   from a CPU generator (``EmbodiedRunner``'s default) and from one on the
   card (what part (e) passes as ``init_generator``), seconds each.
3. pi0_gap: ``EmbodiedRunner`` with that policy as part (e) builds it, one
   step; on its first minibatch, before the update, the chain-logprob gap
   (``chip_smoke.chain_gap``) of the sound recompute and of two planted
   faults in the recompute alone: the trunk run in f32 against the bf16
   rollout, and the suffix's rope positions from 0 instead of the prefix
   length. The faults show what ``FLOW_GAP_BAR`` has to catch.

Each phase prints one JSON line; the first line is the card's name and
power limit. It fails if part (a) fails its gates.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def sac_readings(kerns, seeds) -> dict:
    runs = []
    for record in (True, False):
        for seed in seeds if record else seeds[:2]:
            part, bad = cs.sac_part(kerns, seed, record_snapshots=record)
            runs.append({"seed": seed, "recorder": record, "bad": bad,
                         "eval_mean_reward": part["eval_mean_reward"],
                         "learner_steps_per_s": part["learner_steps_per_s"],
                         "seconds": part["seconds"], "syncs": part["syncs"],
                         "chunks_produced": part["chunks_produced"],
                         "snapshots": part["snapshots"]})
    rewards = [r["eval_mean_reward"] for r in runs]
    return {"phase": "sac", "settings": cs.SAC_PROOF, "runs": runs,
            "eval_mean_reward_min": min(rewards), "eval_mean_reward_max": max(rewards)}


def pi0_policy(trunk_dtype="bfloat16"):
    from rlinf_tpu_torch.models.embodiment.openpi import Pi0Config, Pi0Policy
    from rlinf_tpu_torch.models.embodiment.vit import ViTConfig
    from rlinf_tpu_torch.models.llm.config import LLMConfig

    cfg = dataclasses.replace(Pi0Config.pi0_full(), action_dim=2, state_dim=4)
    return Pi0Policy(cfg, vlm_cfg=LLMConfig(**{**cs.PI0_TRUNK, "dtype": trunk_dtype}),
                     vit_cfg=ViTConfig(**cs.PI0_TOWER), remat=True)


def pi0_init(seed) -> dict:
    policy = pi0_policy()
    out = {"phase": "pi0_init"}
    for where in ("cpu", "cuda"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = policy.init(torch.Generator(where).manual_seed(seed), device="cuda")
        torch.cuda.synchronize()
        out[f"{where}_generator_s"] = time.perf_counter() - t0
        out["params"] = sum(t.numel() for t in cs._tree_leaves(params))
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


class SuffixFromZero:
    """A planted fault: the suffix's rope positions start at 0."""

    def __init__(self, policy):
        self.policy = policy

    def __getattr__(self, name):
        return getattr(self.policy, name)

    def default_forward(self, params, obs, actions):
        p = self.policy
        inner = p._suffix_hidden
        p._suffix_hidden = lambda prm, pk, pv, pvalid, plen, *a, **kw: inner(
            prm, pk, pv, pvalid, torch.zeros_like(plen), *a, **kw)
        try:
            return p.default_forward(params, obs, actions)
        finally:
            del p._suffix_hidden


def pi0_gap(seed) -> dict:
    from rlinf_tpu_torch.envs.toy import ImageReachEnv
    from rlinf_tpu_torch.envs.wrappers import ActionChunkWrapper
    from rlinf_tpu_torch.runners.embodied_runner import EmbodiedRunner, EmbodiedRunnerConfig
    from rlinf_tpu_torch.training.train_state import OptimizerConfig, tree_map

    run = cs.PI0_RUN
    policy = pi0_policy()
    env = ActionChunkWrapper(ImageReachEnv(run["num_envs"], seed=seed, size=224,
                                           max_episode_steps=run["max_episode_steps"]),
                             run["chunk"])
    runner = EmbodiedRunner(
        EmbodiedRunnerConfig(num_chunk_steps=run["num_chunk_steps"], num_epochs=run["num_epochs"],
                             num_mini_batches=run["num_mini_batches"], max_steps=1, seed=seed),
        [env], policy, optimizer=OptimizerConfig(name="adafactor", lr=run["lr"], clip_grad=0.0),
        init_generator=torch.Generator("cuda").manual_seed(seed), device="cuda")
    out, step = {"phase": "pi0_gap", "bar": cs.FLOW_GAP_BAR}, runner.train_step

    def watched(state, mb):
        if "sound" not in out:
            out["sound"] = cs.chain_gap(policy, state.params, mb)
            out["fault_suffix_positions_from_0"] = cs.chain_gap(
                SuffixFromZero(policy), state.params, mb)
            f32 = {**state.params, "vlm": tree_map(lambda t: t.float(), state.params["vlm"])}
            out["fault_trunk_f32"] = cs.chain_gap(pi0_policy("float32"), f32, mb)
            del f32
        return step(state, mb)

    runner.train_step = watched
    runner.run()
    out["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sac-seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from rlinf_tpu_torch.ops.cuda import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.gpu_line(), flush=True)
    sac = sac_readings(kernels(), args.sac_seeds)
    cs.emit(sac)
    cs.emit(pi0_init(args.seed))
    cs.emit(pi0_gap(args.seed))
    bad = [(r["seed"], r["bad"]) for r in sac["runs"] if r["bad"]]
    if bad:
        raise SystemExit(f"part (a) failed: {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
