"""Shared flow-matching / flow-SDE machinery over action CHUNKS.

Port of ``rlinf_tpu/models/embodiment/flow_utils.py`` (reference analog:
the flow-matching sampling and flow-SDE RL construction of the openpi
pi0/pi0.5 policies and starvla's flow-matching action head; the piRL
recipe, docs pi_rl.rst:41-89): actions of any shape [B, ...], a
``velocity_fn(x_t, t) -> v`` closure, so pi0 / GR00T / the MLP flow policy
share one exact-logprob denoising MDP. Each SDE step
x_{k+1} = x_k + dt v + sigma sqrt(dt) eps is a Gaussian whose logprob is
exact, so PPO importance ratios over the denoising chain are well-defined.

The random draws are apart from the arithmetic: each function draws its
noise from a CPU ``torch.Generator`` (so a seed gives the same draws on any
device) unless the caller hands the draws in (``x0``, ``t``, ``eps``), as
the tests do with the JAX package's threefry draws.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from rlinf_tpu_torch.models.embodiment.base_policy import normal_noise, to_device

_LOG_2PI = math.log(2.0 * math.pi)

VelocityFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (x_t [B,...], t [B])


class ChunkFlowChain(NamedTuple):
    """Denoising-MDP record for chunked actions."""

    actions: torch.Tensor   # [B, K, A] final x1
    chain: torch.Tensor     # [B, steps+1, K, A]
    logprobs: torch.Tensor  # [B, steps]


def time_embed(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding of t in [0,1]; t: [...] -> [..., dim]. The
    exponents are ``jnp.linspace(0, log 1000, half)``'s f32 values: stop x
    i / (half - 1), the last exactly stop."""
    half = dim // 2
    stop = torch.tensor(math.log(1000.0), dtype=torch.float32, device=t.device)
    step = torch.arange(half - 1, dtype=torch.float32, device=t.device) / (half - 1)
    freqs = torch.exp(torch.cat([stop * step, stop[None]]))
    ang = t[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def uniform_noise(generator: torch.Generator, shape, device) -> torch.Tensor:
    """U[0, 1) f32 draws of ``shape`` from the CPU ``generator``, sent to
    ``device``."""
    return to_device(torch.rand(tuple(shape), generator=generator), device)


def _as(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def flow_matching_loss(
    velocity_fn: VelocityFn,
    generator: Optional[torch.Generator],
    target: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
    x0: Optional[torch.Tensor] = None,
    t: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Conditional flow matching: E_t ||v(x_t,t) - (x1-x0)||^2, x1=target.
    ``x0`` ~ N(0, I) [like target] and ``t`` ~ U[0, 1) [B] are drawn from
    ``generator`` unless given."""
    B = target.shape[0]
    x1 = target.float()
    x0 = normal_noise(generator, x1.shape, x1.device) if x0 is None else _as(x0, x1)
    t = uniform_noise(generator, (B,), x1.device) if t is None else _as(t, x1)
    t_b = t.reshape((B,) + (1,) * (x1.ndim - 1))
    x_t = (1.0 - t_b) * x0 + t_b * x1
    err = (velocity_fn(x_t, t) - (x1 - x0)).square()
    if mask is not None:
        m = mask.float()
        return (err * m).sum() / (m.sum() * err.shape[-1]).clamp_min(1.0)
    return err.mean()


def sample_ode(
    velocity_fn: VelocityFn,
    generator: Optional[torch.Generator],
    shape: Tuple[int, ...],
    *,
    steps: int,
    x0: Optional[torch.Tensor] = None,
    device="cuda",
) -> torch.Tensor:
    """Deterministic Euler ODE integration from N(0,I) (eval-mode action);
    ``x0`` drawn from ``generator`` onto ``device`` unless given."""
    B = shape[0]
    x = normal_noise(generator, shape, device) if x0 is None else x0.float()
    dt = 1.0 / steps
    for i in range(steps):
        t = torch.full((B,), i * dt, dtype=torch.float32, device=x.device)
        x = x + dt * velocity_fn(x, t)
    return x


def _step_logprob(z: torch.Tensor, std: float) -> torch.Tensor:
    """Sum over every dim but the first of the N(0, std^2) logprob of z std."""
    lp = -0.5 * z.square() - math.log(std) - 0.5 * _LOG_2PI
    return lp.flatten(1).sum(dim=1)


def sample_sde(
    velocity_fn: VelocityFn,
    generator: Optional[torch.Generator],
    shape: Tuple[int, ...],
    *,
    steps: int,
    noise_scale: float,
    x0: Optional[torch.Tensor] = None,
    eps: Optional[torch.Tensor] = None,
    device="cuda",
) -> ChunkFlowChain:
    """Flow-SDE sampling with exact per-step chain logprobs (summed over the
    action dims of each step's Gaussian). ``x0`` [shape] and ``eps`` [steps,
    *shape] are drawn from ``generator`` onto ``device`` unless given."""
    B = shape[0]
    dt = 1.0 / steps
    std = noise_scale * math.sqrt(dt)
    x = normal_noise(generator, shape, device) if x0 is None else x0.float()
    if eps is None:
        eps = normal_noise(generator, (steps, *shape), x.device)
    chain, lps = [x], []
    for i in range(steps):
        t = torch.full((B,), i * dt, dtype=torch.float32, device=x.device)
        mean = x + dt * velocity_fn(x, t)
        e = eps[i].float()
        x = mean + std * e
        chain.append(x)
        lps.append(_step_logprob(e, std))
    return ChunkFlowChain(actions=x, chain=torch.stack(chain, dim=1),
                          logprobs=torch.stack(lps, dim=-1))


def chain_logprobs(
    velocity_fn: VelocityFn,
    chain: torch.Tensor,
    *,
    noise_scale: float,
    remat: bool = False,
) -> torch.Tensor:
    """Per-step logprobs of a stored chain [B, S+1, ...] under CURRENT params
    (the PPO 'new logprob' recompute). Returns [B, S].

    ``remat``: recompute each step's velocity pass in the backward
    (``torch.utils.checkpoint``, non-reentrant; the pass's closure over the
    prefix K/V keeps its gradient), so that one pass's activations are
    live at a time instead of all S."""
    B, S1 = chain.shape[:2]
    steps = S1 - 1
    dt = 1.0 / steps
    std = noise_scale * math.sqrt(dt)
    lps = []
    for i in range(steps):
        x_k, x_next = chain[:, i], chain[:, i + 1]
        t = torch.full((B,), i * dt, dtype=torch.float32, device=chain.device)
        if remat and torch.is_grad_enabled():
            v = checkpoint(velocity_fn, x_k, t, use_reentrant=False)
        else:
            v = velocity_fn(x_k, t)
        mean = x_k + dt * v
        lps.append(_step_logprob((x_next - mean) / std, std))
    return torch.stack(lps, dim=-1)


def chain_entropy_like(lp: torch.Tensor, action_size: int, steps: int,
                       noise_scale: float) -> torch.Tensor:
    """Entropy of each (constant-variance) denoising Gaussian, shaped like
    the per-step logprob array."""
    std = noise_scale * math.sqrt(1.0 / steps)
    return torch.full_like(lp, action_size * (math.log(std) + 0.5 * (_LOG_2PI + 1.0)))
