"""TrainState and the optimizer, written as optax writes them.

Port of ``rlinf_tpu/training/train_state.py``. Parameters are the model's
nested dict of tensors. The optimizer is a chain of plain functions on
tensors that follows optax's arithmetic step for step, so that three steps
agree with ``optax`` to fp32 rounding:

  clip_by_global_norm -> scale_by_adam (bias-corrected, m^ / (sqrt(v^) + eps))
  -> add_decayed_weights -> scale by -lr * schedule(count)

The caller applies an update as ``(p.float() + u).to(p.dtype)``. Moments
take the dtype optax gives them: at init the parameter's dtype (bf16 for
bf16 parameters, f32 against the f32 master copy), then the dtype of the
arithmetic that updates them (bf16 moments updated with f32 gradients
become f32, as in optax). ``torch.optim.AdamW`` rounds in another order and
is not used.

Adafactor comes with a later slice of the port; ``create_train_state``
takes no mesh yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch


class TrainState(NamedTuple):
    step: int
    params: Any
    opt_state: Any


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """The JAX package's optimizer block, same fields and defaults."""

    lr: float = 1e-6
    min_lr: float = 0.0
    weight_decay: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    clip_grad: float = 1.0
    warmup_steps: int = 0
    total_steps: int = 0  # 0 => constant after warmup
    schedule: str = "constant"  # constant | cosine
    #: adamw | adafactor (adafactor is not ported yet)
    name: str = "adamw"
    #: adamw first-moment dtype ("float32" | "bfloat16")
    moment_dtype: str = "float32"
    #: keep an f32 master copy of the params in the optimizer state and
    #: derive each step's update from it (sub-ulp bf16 updates accumulate
    #: there instead of rounding away)
    master_weights: bool = False


# ---------------------------------------------------------------------------
# Nested-dict trees
# ---------------------------------------------------------------------------

def tree_map(fn: Callable, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def global_norm(tree) -> torch.Tensor:
    """sqrt(sum of squares) over every leaf, in the leaves' dtype (optax)."""
    return torch.sqrt(sum((x * x).sum() for x in tree_leaves(tree)))


# ---------------------------------------------------------------------------
# Schedules (optax.linear_schedule / warmup_cosine_decay_schedule, in f32)
# ---------------------------------------------------------------------------

def _linear(init_value: float, end_value: float, steps: int) -> Callable:
    if steps <= 0:
        return lambda count: init_value

    def schedule(count: int):
        c = torch.tensor(min(max(count, 0), steps), dtype=torch.int32)
        frac = 1 - c / steps
        return (init_value - end_value) * frac + end_value

    return schedule


def _cosine(init_value: float, decay_steps: int, alpha: float) -> Callable:
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs decay_steps > 0, got {decay_steps}")

    def schedule(count):
        c = torch.minimum(torch.as_tensor(count, dtype=torch.float32),
                          torch.tensor(float(decay_steps)))
        cosine_decay = 0.5 * (1 + torch.cos(math.pi * c / float(decay_steps)))
        return init_value * ((1 - alpha) * cosine_decay**1.0 + alpha)

    return schedule


def make_schedule(cfg: OptimizerConfig):
    """A float (constant) or a function of the step count, as the JAX package."""
    if cfg.schedule == "cosine" and cfg.total_steps > 0:
        warmup = _linear(0.0, cfg.lr, cfg.warmup_steps)
        decay_steps = max(cfg.total_steps, cfg.warmup_steps + 1)
        alpha = 0.0 if cfg.lr == 0.0 else cfg.min_lr / cfg.lr
        cosine = _cosine(cfg.lr, decay_steps - cfg.warmup_steps, alpha)

        def schedule(count: int):
            if count < cfg.warmup_steps:
                return torch.as_tensor(warmup(count), dtype=torch.float32)
            return cosine(count - cfg.warmup_steps)

        return schedule
    if cfg.warmup_steps > 0:
        return _linear(0.0, cfg.lr, cfg.warmup_steps)
    return cfg.lr


# ---------------------------------------------------------------------------
# The optimizer
# ---------------------------------------------------------------------------

class Optimizer:
    """An optax-style pair: ``init(params) -> state`` and
    ``update(grads, state, params) -> (updates, state)``.

    Unlike optax, ``update`` writes the new moments and master weights into
    the old state's tensors where the dtype allows (the port keeps one copy
    of the optimizer state where the JAX package donated the old buffers):
    the state passed in is consumed.
    """

    def __init__(self, init: Callable, update: Callable):
        self.init = init
        self.update = update


def _store(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """``new`` written into ``old`` when the dtypes agree, else ``new``."""
    if old.dtype != new.dtype:
        return new
    old.copy_(new)
    return old


def adamw(cfg: OptimizerConfig) -> Optimizer:
    """optax.chain(clip_by_global_norm(clip) | identity, adamw(schedule, b1,
    b2, eps, weight_decay, mu_dtype))."""
    lr = make_schedule(cfg)
    mu_dtype = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else None
    b1, b2, eps, wd, clip = cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay, cfg.clip_grad

    def init(params):
        return {
            "count": 0,
            "mu": tree_map(lambda p: torch.zeros_like(p, dtype=mu_dtype or p.dtype), params),
            "nu": tree_map(torch.zeros_like, params),
        }

    @torch.no_grad()
    def update(grads, state, params):
        count = state["count"]
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** (count + 1)
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** (count + 1)
        step_size = -lr(count) if callable(lr) else -lr
        g_norm = global_norm(grads) if clip > 0 else None
        clipped = g_norm is not None and not bool(g_norm < clip)

        def leaf(g, mu, nu, p):
            if clipped:
                g = (g / g_norm.to(g.dtype)) * clip
            new_mu = (1 - b1) * g + b1 * mu
            new_nu = (1 - b2) * (g**2) + b2 * nu
            mu_hat = new_mu / bc1.to(device=g.device, dtype=new_mu.dtype)
            nu_hat = new_nu / bc2.to(device=g.device, dtype=new_nu.dtype)
            u = mu_hat / (torch.sqrt(nu_hat + 0.0) + eps)
            u = u + wd * p
            if torch.is_tensor(step_size):
                u = step_size.to(device=u.device, dtype=u.dtype) * u
            else:
                u = step_size * u
            if mu_dtype is not None:
                new_mu = new_mu.to(mu_dtype)
            return u, _store(mu, new_mu), _store(nu, new_nu)

        out = tree_map(leaf, grads, state["mu"], state["nu"], params)
        updates, mu, nu = (tree_map(lambda t, i=i: t[i], out) for i in range(3))
        return updates, {"count": count + 1, "mu": mu, "nu": nu}

    return Optimizer(init, update)


def with_master_weights(inner: Optimizer) -> Optimizer:
    """Wrap an optimizer with an f32 master copy of the params: the inner
    optimizer runs in f32 against the master; the emitted update is
    ``new_master - params`` in f32, so the caller's apply
    ``(p.float() + u).to(p.dtype)`` lands on the rounded master."""

    def init(params):
        master = tree_map(lambda p: p.float().clone(), params)
        return {"inner": inner.init(master), "master": master}

    @torch.no_grad()
    def update(grads, state, params):
        grads32 = tree_map(lambda g: g.float(), grads)
        updates32, inner_state = inner.update(grads32, state["inner"], state["master"])

        def leaf(m, u, p):
            m.add_(u)                          # new master, in place
            return torch.sub(m, p.float(), out=u)

        emitted = tree_map(leaf, state["master"], updates32, params)
        return emitted, {"inner": inner_state, "master": state["master"]}

    return Optimizer(init, update)


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    if cfg.name == "adafactor":
        raise NotImplementedError(
            "optimizer.name='adafactor' comes with a later slice of the port; use adamw")
    if cfg.name != "adamw":
        raise ValueError(f"optimizer.name must be adamw|adafactor, got {cfg.name!r}")
    tx = adamw(cfg)
    return with_master_weights(tx) if cfg.master_weights else tx


def create_train_state(
    init_params_fn: Callable[[], Any],
    tx: Optimizer,
    mesh=None,
) -> TrainState:
    """Params from ``init_params_fn()`` and the optimizer state for them."""
    if mesh is not None:
        raise NotImplementedError(
            "create_train_state(mesh=...) comes with the port's parallel slice")
    params = init_params_fn()
    return TrainState(0, params, tx.init(params))


def apply_updates(params, updates) -> None:
    """p <- (p.float() + u.float()).to(p.dtype), in place: the port keeps one
    copy of the params where the JAX package donated the old buffers."""
    def one(p, u):
        p.copy_((p.float() + u.float()).to(p.dtype))

    with torch.no_grad():
        tree_map(one, params, updates)
