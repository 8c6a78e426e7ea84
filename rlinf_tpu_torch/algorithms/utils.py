"""Masked reductions, KL approximations and normalization helpers.

Port of ``rlinf_tpu/algorithms/utils.py``. Standard deviations use ddof=1
where the JAX package does.
"""

from __future__ import annotations

from typing import Callable

import torch


def masked_mean(values, mask, axis=None, _ratio=None):
    """Mean over entries where mask is nonzero; 0 if the mask is empty."""
    if mask is None:
        return values.mean() if axis is None else values.mean(dim=axis)
    mask = mask.to(values.dtype)
    total = mask.sum() if axis is None else mask.sum(dim=axis)
    s = (values * mask).sum() if axis is None else (values * mask).sum(dim=axis)
    return torch.where(total > 0, s / total.clamp_min(1.0), s)


def masked_sum(values, mask, axis=None):
    v = values * mask.to(values.dtype)
    return v.sum() if axis is None else v.sum(dim=axis)


def masked_mean_ratio(values, mask, loss_mask_ratio):
    """Per-sample normalization by (valid steps / max episode steps)."""
    mask = mask.to(values.dtype)
    return (values / loss_mask_ratio * mask).mean()


def seq_mean_token_sum(values, mask, axis=-1):
    return (values * mask.to(values.dtype)).sum(dim=axis).mean()


def seq_mean_token_mean(values, mask, axis=-1):
    mask = mask.to(values.dtype)
    denom = mask.sum(dim=axis).clamp_min(1.0)
    return ((values * mask).sum(dim=axis) / denom).mean()


def get_loss_agg_func(loss_agg: str) -> Callable:
    if loss_agg == "token-mean":
        return masked_mean
    if loss_agg == "seq-mean-token-sum":
        return lambda v, m, *_: seq_mean_token_sum(v, m)
    if loss_agg == "seq-mean-token-mean":
        return lambda v, m, *_: seq_mean_token_mean(v, m)
    raise ValueError(f"Unknown loss_agg {loss_agg!r}")


def huber_loss(error, delta: float):
    abs_err = error.abs()
    return torch.where(abs_err < delta, 0.5 * error**2, delta * (abs_err - 0.5 * delta))


def kl_penalty(logprob, ref_logprob, kl_penalty_type: str):
    """Token-level KL estimators k1/k2/k3 and abs."""
    if kl_penalty_type in ("kl", "k1"):
        return logprob - ref_logprob
    if kl_penalty_type == "abs":
        return (logprob - ref_logprob).abs()
    if kl_penalty_type in ("mse", "k2"):
        return 0.5 * (logprob - ref_logprob).square()
    if kl_penalty_type in ("low_var_kl", "k3"):
        kl = (ref_logprob - logprob).clamp(-20.0, 20.0)
        kld = torch.exp(kl) - kl - 1.0
        return kld.clamp(-10.0, 10.0)
    raise NotImplementedError(f"kl_penalty {kl_penalty_type!r}")


def _masked_std(array, mask, ddof=1):
    mask = mask.to(array.dtype)
    n = mask.sum()
    mean = (array * mask).sum() / n.clamp_min(1.0)
    var = ((array - mean).square() * mask).sum() / (n - ddof).clamp_min(1.0)
    return mean, var.sqrt()


def safe_normalize(array, loss_mask=None, eps: float = 1e-5):
    """(x - mean) / (std + eps) over masked entries, identity on an empty
    mask; mean/std over valid entries (ddof=1), applied to every entry."""
    if loss_mask is None:
        loss_mask = torch.ones_like(array, dtype=torch.bool)
    mean, std = _masked_std(array, loss_mask)
    n = loss_mask.to(torch.int32).sum()
    normalized = (array - mean) / (std + eps)
    return torch.where(n > 0, normalized, array)
