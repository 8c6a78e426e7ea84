"""Metric logging: console + jsonl + TensorBoard/wandb/swanlab backends,
and the rollout statistics.

The port's own copy of ``rlinf_tpu/utils/metrics.py``. A metric may be a
Python number, a numpy scalar or a tensor on any device.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch


def _scalar(v) -> float:
    """A one-element metric as a Python float (a tensor's ``item()``)."""
    if isinstance(v, torch.Tensor):
        return float(v.item())
    return float(np.asarray(v))


class MetricLogger:
    """Multiplexing metric logger.

    ``backends``: any of "tensorboard", "wandb", "swanlab" (reference
    ``runner.logger.logger_backends``). Each backend is import-gated: a
    missing package logs a one-line warning (TensorBoard: nothing) and is
    skipped, so headless machines run identically. jsonl + console are
    always on when ``log_dir`` is set.
    """

    supported_backends = ("tensorboard", "wandb", "swanlab")

    def __init__(
        self,
        log_dir: Optional[str] = None,
        use_tensorboard: bool = False,
        print_every: int = 1,
        backends: Sequence[str] = (),
        project_name: str = "rlinf_tpu",
        experiment_name: str = "default",
        config: Optional[Dict] = None,
    ):
        self.log_dir = log_dir
        self.print_every = print_every
        self._jsonl = None
        self._tb = None
        self._wandb = None
        self._swanlab = None
        backends = list(backends)
        if use_tensorboard and "tensorboard" not in backends:
            backends.append("tensorboard")
        unknown = set(backends) - set(self.supported_backends)
        if unknown:
            raise ValueError(
                f"Unsupported logger backend(s): {sorted(unknown)}; "
                f"supported: {self.supported_backends}"
            )
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            if "tensorboard" in backends:
                try:
                    from torch.utils.tensorboard import SummaryWriter

                    self._tb = SummaryWriter(log_dir)
                except Exception:
                    self._tb = None
            if "wandb" in backends:
                try:
                    import wandb

                    wandb.init(
                        project=project_name, name=experiment_name,
                        config=config or {},
                        dir=os.path.join(log_dir, "wandb"),
                    )
                    self._wandb = wandb
                except Exception as e:  # noqa: BLE001
                    print(f"[metrics] wandb backend unavailable: {e}")
            if "swanlab" in backends:
                try:
                    import swanlab

                    swanlab.init(
                        project=project_name,
                        experiment_name=experiment_name,
                        config=config or {},
                        logdir=os.path.join(log_dir, "swanlab"),
                    )
                    self._swanlab = swanlab
                except Exception as e:  # noqa: BLE001
                    print(f"[metrics] swanlab backend unavailable: {e}")

    def log(self, metrics: Dict, step: int):
        scalars = {}
        for k, v in metrics.items():
            try:
                scalars[k] = _scalar(v)
            except (TypeError, ValueError, RuntimeError):
                continue
        if self._jsonl:
            self._jsonl.write(
                json.dumps({"step": step, "time": time.time(), **scalars}) + "\n"
            )
            self._jsonl.flush()
        if self._tb:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)
        if self._wandb:
            self._wandb.log(scalars, step=step)
        if self._swanlab:
            self._swanlab.log(scalars, step=step)
        if self.print_every and step % self.print_every == 0:
            parts = " ".join(f"{k}={v:.4g}" for k, v in sorted(scalars.items()))
            print(f"[step {step}] {parts}", flush=True)

    def close(self):
        if self._jsonl:
            self._jsonl.close()
        if self._tb:
            self._tb.close()
        if self._wandb:
            self._wandb.finish()
        if self._swanlab:
            self._swanlab.finish()


def rollout_metrics(
    response_lengths,
    rewards,
    max_new_tokens: int,
    *,
    prompt_lengths=None,
    advantages=None,
    loss_mask=None,
) -> Dict[str, float]:
    """Rollout statistics (reference compute_rollout_metrics,
    utils/distributed.py:34-186): response-length distribution incl.
    histogram percentiles and clip ratio, reward stats + positive rate,
    optional prompt-length and masked-advantage stats."""
    lens = np.asarray(response_lengths, np.float32)
    r = np.asarray(rewards, np.float32)
    out = {
        "rollout/response_len_mean": float(lens.mean()),
        "rollout/response_len_max": float(lens.max()),
        "rollout/response_len_min": float(lens.min()),
        "rollout/response_len_p50": float(np.percentile(lens, 50)),
        "rollout/response_len_p90": float(np.percentile(lens, 90)),
        "rollout/response_len_p99": float(np.percentile(lens, 99)),
        "rollout/response_len_clip_ratio": float(
            (lens >= max_new_tokens).mean()),
        "rollout/reward_mean": float(r.mean()),
        "rollout/reward_std": float(r.std()),
        "rollout/reward_max": float(r.max()),
        "rollout/reward_min": float(r.min()),
        "rollout/reward_positive_rate": float((r > 0).mean()),
    }
    if prompt_lengths is not None:
        pl = np.asarray(prompt_lengths, np.float32)
        out["rollout/prompt_len_mean"] = float(pl.mean())
        out["rollout/prompt_len_max"] = float(pl.max())
    if advantages is not None:
        adv = np.asarray(advantages, np.float32)
        if loss_mask is not None:
            m = np.asarray(loss_mask, bool)
            adv = adv[m] if m.any() else adv.reshape(-1)
        out["rollout/advantage_mean"] = float(adv.mean())
        out["rollout/advantage_std"] = float(adv.std())
        out["rollout/advantage_abs_max"] = float(np.abs(adv).max())
    return out
