"""VLM reasoning GRPO entry point of the port: [image | question] -> graded
free-text answer.

The port's ``examples/vlm/main_vlm_grpo.py``: the whole multimodal RL path
on a synthetic colour-VQA task (``color_dataset``: a solid colour image
with noise, the question "what color?", the colour's name as the answer):
a VLM SFT warm-up (``VLMSFTRunner``), then GRPO (``VLMReasoningRunner``)
from the SFT'd params, where the reward is earnable only by conditioning
the text on the image. The defaults are the example's (a 3-layer decoder
of width 96, a 2-layer ViT of width 48 on 32x32 images, 40 SFT and 60 GRPO
steps, the byte tokenizer); ``main``'s keywords take other models, image
sizes (the tower's), batches, tokenizers and rewards. The run is on the card unless
``device="cpu"`` (``--device cpu``) is given.

Usage:
  python -m rlinf_tpu_torch.main_vlm_grpo --device cpu --sft-steps 2 --grpo-steps 2 \\
      --log-dir /tmp/vlm
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

COLORS = {"red": (1.0, 0.1, 0.1), "green": (0.1, 1.0, 0.1),
          "blue": (0.1, 0.1, 1.0)}


def color_dataset(n: int = 96, seed: int = 0, image_size: int = 32):
    """``n`` examples cycling through COLORS: an [image_size, image_size, 3]
    float32 image of the colour plus N(0, 0.05) noise, clipped to [0, 1]."""
    from rlinf_tpu_torch.data.datasets import VQADataset, VQAExample

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        name = list(COLORS)[i % 3]
        img = np.ones((image_size, image_size, 3), np.float32) * np.asarray(COLORS[name])
        img += rng.normal(0, 0.05, img.shape).astype(np.float32)
        out.append(VQAExample(image=np.clip(img, 0, 1),
                              question="what color?", answers=[name]))
    return VQADataset(out)


def trainer_config(model=None, *, rollout_batch_size: int = 8, max_new_tokens: int = 8,
                   max_steps: int = 60, seed: int = 0,
                   log_dir: Optional[str] = "logs/vlm_grpo_demo"):
    """The example's TrainerConfig, with ``model`` (an LLMConfig) in place
    of its 3-layer decoder where given."""
    from rlinf_tpu_torch.config import (
        AlgorithmConfig, DataConfig, RunnerConfig, TrainerConfig,
    )
    from rlinf_tpu_torch.models.llm.config import LLMConfig
    from rlinf_tpu_torch.models.llm.sampler import SamplingParams
    from rlinf_tpu_torch.training.learner import PolicyLossConfig
    from rlinf_tpu_torch.training.train_state import OptimizerConfig

    return TrainerConfig(
        model=model or LLMConfig(
            vocab_size=258, hidden_size=96, intermediate_size=192,
            num_layers=3, num_heads=4, num_kv_heads=2, max_seq_len=128,
            dtype="float32",
        ),
        sampling=SamplingParams(max_new_tokens=max_new_tokens, temperature=1.0,
                                eos_token_id=1, pad_token_id=0),
        optimizer=OptimizerConfig(lr=2e-3, clip_grad=1.0),
        loss=PolicyLossConfig(clip_ratio_low=0.2, clip_ratio_high=0.2,
                              entropy_bonus=0.001),
        algorithm=AlgorithmConfig(adv_type="grpo", group_size=8),
        runner=RunnerConfig(rollout_batch_size=rollout_batch_size, max_steps=max_steps,
                            seed=seed, log_dir=log_dir),
        data=DataConfig(max_prompt_len=16),
    )


def main(device="cuda", sft_steps: int = 40, grpo_steps: int = 60, *, model=None,
         vit=None, rollout_batch_size: int = 8,
         max_new_tokens: int = 8, tokenizer=None, reward_fn=None, seed: int = 0,
         log_dir: Optional[str] = "logs/vlm_grpo_demo") -> Dict:
    """SFT warm-up for ``sft_steps``, then GRPO for ``grpo_steps`` from the
    SFT'd params. ``model``/``vit``: the decoder's LLMConfig and the
    tower's ViTConfig (default: the example's; the images take its
    ``image_size``); ``reward_fn(texts,
    answers)`` defaults to the VQA soft accuracy. Returns {"sft": history,
    "grpo": history, "sft_runner", "runner"}."""
    from rlinf_tpu_torch.data.tokenizers import ByteTokenizer
    from rlinf_tpu_torch.models.embodiment.vit import ViTConfig
    from rlinf_tpu_torch.models.vlm import VLMReasoningModel
    from rlinf_tpu_torch.runners.vlm_reasoning_runner import VLMReasoningRunner
    from rlinf_tpu_torch.runners.vlm_sft_runner import VLMSFTRunner

    cfg = trainer_config(model, rollout_batch_size=rollout_batch_size,
                         max_new_tokens=max_new_tokens, max_steps=grpo_steps, seed=seed,
                         log_dir=log_dir)
    vlm = VLMReasoningModel(
        vlm_cfg=cfg.model,
        vit_cfg=vit or ViTConfig(image_size=32, patch_size=16, hidden=48, layers=2, heads=4),
    )
    ds = color_dataset(seed=seed, image_size=vlm.vit_cfg.image_size)
    tok = tokenizer or ByteTokenizer()

    # SFT warm-up (VLM SFT worker analog), then GRPO from the SFT'd params
    sft = VLMSFTRunner(
        dataclasses.replace(cfg, runner=dataclasses.replace(cfg.runner, max_steps=sft_steps)),
        tok, ds, vlm, device=device,
    )
    sft_hist = sft.run()
    if sft_hist:
        print(f"sft loss {sft_hist[0]['sft/loss']:.3f} -> {sft_hist[-1]['sft/loss']:.3f}")

    runner = VLMReasoningRunner(cfg, tok, ds, vlm, reward_fn=reward_fn,
                                init_params_override=lambda _seed: sft.state.params,
                                device=device)
    hist = runner.run()
    if hist:
        r0 = np.mean([h["rollout/reward_mean"] for h in hist[:5]])
        r1 = np.mean([h["rollout/reward_mean"] for h in hist[-5:]])
        print(f"reward {r0:.3f} -> {r1:.3f}")
    for r in (sft, runner):
        r.logger.close()
    return {"sft": sft_hist, "grpo": hist, "sft_runner": sft, "runner": runner}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="VLM SFT warm-up, then GRPO, on the port")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the run (cuda, or cpu for the plain versions)")
    parser.add_argument("--sft-steps", type=int, default=40)
    parser.add_argument("--grpo-steps", type=int, default=60)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--log-dir", default="logs/vlm_grpo_demo")
    return parser.parse_args(argv)


if __name__ == "__main__":
    _args = parse_args()
    main(_args.device, _args.sft_steps, _args.grpo_steps, seed=_args.seed,
         log_dir=_args.log_dir)
