"""TrainState and the optimizer, written as optax writes them.

Port of ``rlinf_tpu/training/train_state.py``. Parameters are the model's
nested dict of tensors. The optimizer is a chain of plain functions on
tensors that follows optax's arithmetic step for step, so that three steps
agree with ``optax`` to fp32 rounding:

  clip_by_global_norm -> scale_by_adam (bias-corrected, m^ / (sqrt(v^) + eps))
  -> add_decayed_weights -> scale by -lr * schedule(count)

or, for ``name="adafactor"`` (optax 0.2.6's ``adafactor`` as the JAX
package calls it):

  clip_by_global_norm -> scale_by_factored_rms -> clip_by_block_rms(1)
  -> scale by schedule(count) -> scale_by_param_block_rms(1e-3)
  -> add_decayed_weights (weight_decay > 0 only) -> scale(-1)

The caller applies an update as ``(p.float() + u).to(p.dtype)``. Moments
take the dtype optax gives them: at init the parameter's dtype (bf16 for
bf16 parameters, f32 against the f32 master copy), then the dtype of the
arithmetic that updates them (bf16 moments updated with f32 gradients
become f32, as in optax; adafactor casts its statistics back to the
parameter's dtype). ``torch.optim.AdamW`` rounds in another order and is
not used.

Under a mesh the params are this rank's blocks (``create_train_state(mesh=,
partition_rules=)``) and the optimizer state is made from them, so it is
sharded like the params (the JAX package's ``_opt_state_specs``). adamw is
elementwise, so it runs on the blocks as they are; its global-norm clip
reads the norm the train step reduced across the mesh (``update(...,
grad_norm=)``). adafactor's statistics reduce over whole rows, columns and
leaves (the factored second moments, the block-RMS clip, the parameter
scale): on sharded leaves each such mean is a sum over the rank's block,
all-reduced over the axes that split the reduced dims and divided by the
whole leaf's size (``Blocks``, from ``update(..., shards=)`` and
``init(..., shards=)``), as XLA partitions optax's reductions. The
factored rows and columns are then the rank's blocks of the whole leaf's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
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
    #: adamw | adafactor (beta2 is then adafactor's decay exponent: the
    #: second moment's decay at step t is 1 - (t + 1)^-beta2)
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
    """``fn`` over the leaves of nested dicts and lists (a list of layers: the
    VLM's projector); tuples are leaves."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if type(tree) is list:
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if type(tree) is list:
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def _mean(x: torch.Tensor, *dims, keepdim: bool = False) -> torch.Tensor:
    """``jnp.mean``: a bf16 or f16 input is summed in f32 and the mean cast
    back (torch's own half-precision reduction of a large leaf rounds
    differently)."""
    return x.float().mean(dims or None, keepdim=keepdim).to(x.dtype)


class Blocks:
    """How a leaf is cut on a mesh: its resolved partition spec (one entry
    per leading dim: an axis, a tuple of axes or None). ``mean`` takes a
    mean over dims of the whole leaf from this rank's block of it."""

    def __init__(self, spec, mesh):
        self.spec = tuple(spec or ())
        self.mesh = mesh

    def _axes(self, dim: int) -> tuple:
        entry = self.spec[dim] if dim < len(self.spec) else None
        if entry is None:
            return ()
        return (entry,) if isinstance(entry, str) else tuple(entry)

    @property
    def sharded(self) -> bool:
        return any(self._axes(d) for d in range(len(self.spec)))

    def full(self, shape) -> tuple:
        """The whole leaf's shape from a block's."""
        return tuple(n * self.mesh.size(self._axes(d)) for d, n in enumerate(shape))

    def without(self, dim: int) -> "Blocks":
        """The spec of a statistic that reduced ``dim`` away."""
        spec = list(self.spec) + [None] * max(0, dim + 1 - len(self.spec))
        return Blocks(spec[:dim] + spec[dim + 1:], self.mesh)

    def mean(self, x: torch.Tensor, dims=None, keepdim: bool = False) -> torch.Tensor:
        """``_mean(x, *dims)`` of the whole leaf, from this block: the
        block's f32 sum, all-reduced over the axes that split ``dims``,
        over the whole count, in ``x``'s dtype."""
        from rlinf_tpu_torch.parallel import collectives as C

        dims = tuple(range(x.dim())) if dims is None else tuple(dims)
        axes = tuple(a for d in dims for a in self._axes(d))
        if not axes:
            return _mean(x, *dims, keepdim=keepdim)
        total = x.float().sum(dims, keepdim=keepdim)
        C.all_reduce_(total, "sum", self.mesh.get_group(axes))
        n = math.prod(self.full(x.shape)[d] for d in dims)
        return (total / n).to(x.dtype)


def global_norm(tree) -> torch.Tensor:
    """sqrt(sum of squares) over every leaf, in the leaves' dtype, each
    leaf's sum taken in f32 as XLA takes it (optax)."""
    return torch.sqrt(sum((x * x).float().sum().to(x.dtype) for x in tree_leaves(tree)))


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
    """An optax-style pair: ``init(params, shards=None) -> state`` and
    ``update(grads, state, params, grad_norm=None, shards=None) -> (updates,
    state)``; ``shards`` is a tree of ``Blocks`` in the params' structure
    where the params are blocks of a mesh (read by adafactor).

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


def _global_clip(grads, clip: float, grad_norm=None) -> Callable:
    """optax.clip_by_global_norm(clip) (or identity at clip <= 0) as a
    function of one leaf: g / ||grads|| * clip where the norm reaches clip.
    ``grad_norm``: the norm of the whole (sharded) gradient, where
    ``grads`` holds this rank's blocks."""
    if clip <= 0:
        g_norm = None
    else:
        g_norm = global_norm(grads) if grad_norm is None else grad_norm
    if g_norm is None or bool(g_norm < clip):
        return lambda g: g
    return lambda g: (g / g_norm.to(g.dtype)) * clip


def adamw(cfg: OptimizerConfig) -> Optimizer:
    """optax.chain(clip_by_global_norm(clip) | identity, adamw(schedule, b1,
    b2, eps, weight_decay, mu_dtype))."""
    lr = make_schedule(cfg)
    mu_dtype = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else None
    b1, b2, eps, wd, clip = cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay, cfg.clip_grad

    def init(params, shards=None):
        return {
            "count": 0,
            "mu": tree_map(lambda p: torch.zeros_like(p, dtype=mu_dtype or p.dtype), params),
            "nu": tree_map(torch.zeros_like, params),
        }

    @torch.no_grad()
    def update(grads, state, params, grad_norm=None, shards=None):
        count = state["count"]
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** (count + 1)
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** (count + 1)
        step_size = -lr(count) if callable(lr) else -lr
        clipped = _global_clip(grads, clip, grad_norm)

        def leaf(g, mu, nu, p):
            g = clipped(g)
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


#: adafactor's constants (optax.adafactor's defaults, which the JAX package keeps)
FACTOR_MIN_DIM = 128
FACTOR_EPS = 1e-30
PARAM_SCALE_MIN = 1e-3


def factored_dims(shape) -> Optional[Tuple[int, int]]:
    """(second largest, largest) dim of ``shape`` where the second largest
    reaches FACTOR_MIN_DIM, else None: optax's ``_factored_dims``, ties
    broken by numpy's argsort as there."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < FACTOR_MIN_DIM:
        return None
    return int(order[-2]), int(order[-1])


def _rms(x: torch.Tensor, blk: Optional[Blocks] = None) -> torch.Tensor:
    m = _mean(x * x) if blk is None else blk.mean(x * x)
    return torch.sqrt(m.float()).to(m.dtype)


def _rsqrt(x: torch.Tensor) -> torch.Tensor:
    """``x ** -0.5`` as XLA computes it for bf16: in f32, rounded once
    (torch's bf16 pow rounds differently for about 1% of inputs)."""
    return (x.float() ** -0.5).to(x.dtype)


def _whole(p: torch.Tensor, blk: Optional[Blocks]) -> tuple:
    """The whole leaf's shape (factored_dims reads it, not the block's)."""
    return tuple(p.shape) if blk is None else blk.full(p.shape)


def adafactor(cfg: OptimizerConfig) -> Optimizer:
    """optax.chain(clip_by_global_norm(clip) | identity, adafactor(schedule,
    decay_rate=beta2, weight_decay_rate=weight_decay or None)).

    A leaf whose two largest dims reach 128 keeps a row and a column mean of
    the squared gradient (``v_row`` drops the largest dim, ``v_col`` the
    second largest); any other leaf keeps ``v`` of its own shape. Unused
    statistics are [1] tensors, as in optax. The arithmetic follows optax's
    dtypes: the decay is an f32 scalar, the statistics are cast back to the
    parameter's dtype, and each later product takes the wider of its
    operands' dtypes."""
    lr = make_schedule(cfg)
    wd, clip, exponent = cfg.weight_decay, cfg.clip_grad, cfg.beta2

    def init(params, shards=None):
        def one(p, blk=None):
            dims = factored_dims(_whole(p, blk))
            small = lambda: torch.zeros((1,), dtype=p.dtype, device=p.device)
            if dims is None:
                return small(), small(), torch.zeros_like(p)
            d1, d0 = dims
            row = [n for i, n in enumerate(p.shape) if i != d0]
            col = [n for i, n in enumerate(p.shape) if i != d1]
            return (torch.zeros(row, dtype=p.dtype, device=p.device),
                    torch.zeros(col, dtype=p.dtype, device=p.device), small())

        out = tree_map(one, params) if shards is None else tree_map(one, params, shards)
        v_row, v_col, v = (tree_map(lambda t, i=i: t[i], out)
                           for i in range(3))
        return {"count": 0, "v_row": v_row, "v_col": v_col, "v": v}

    @torch.no_grad()
    def update(grads, state, params, grad_norm=None, shards=None):
        count = state["count"]
        t = torch.tensor(count + 1, dtype=torch.float32)
        decay = 1.0 - t ** (-exponent)          # f32, as optax's _decay_rate_pow
        step = lr(count) if callable(lr) else None
        clipped = _global_clip(grads, clip, grad_norm)

        def leaf(g, v_row, v_col, v, p, blk=None):
            g = clipped(g)
            dt, dev = p.dtype, g.device
            d = decay.to(dev)
            g_sqr = g * g + FACTOR_EPS
            blk = blk if blk is not None and blk.sharded else None
            mean = _mean if blk is None else (
                lambda x, *ds, keepdim=False: blk.mean(x, ds, keepdim))
            dims = factored_dims(_whole(p, blk))
            if dims is not None:
                d1, d0 = dims
                new_row = (d * v_row.float() + (1.0 - d) * mean(g_sqr, d0).float()).to(dt)
                new_col = (d * v_col.float() + (1.0 - d) * mean(g_sqr, d1).float()).to(dt)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_mean = (_mean(new_row, reduced_d1, keepdim=True) if blk is None else
                            blk.without(d0).mean(new_row, (reduced_d1,), keepdim=True))
                row_factor = _rsqrt(new_row / row_mean)
                col_factor = _rsqrt(new_col)
                u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
                v_row, v_col = _store(v_row, new_row), _store(v_col, new_col)
            else:
                new_v = (d * v.float() + (1.0 - d) * g_sqr.float()).to(dt)
                u = g * _rsqrt(new_v)
                v = _store(v, new_v)
            u = u / torch.clamp_min(_rms(u, blk), 1.0)            # clip_by_block_rms(1)
            if step is None:
                u = lr * u
            else:
                u = torch.as_tensor(step).to(device=dev, dtype=u.dtype) * u
            rms = _rms(p, blk)                                    # scale_by_param_block_rms
            scale = torch.where(rms <= PARAM_SCALE_MIN,
                                torch.full_like(rms, PARAM_SCALE_MIN), rms)
            wide = torch.promote_types(u.dtype, scale.dtype)
            u = u.to(wide) * scale.to(wide)
            if wd > 0:
                wide = torch.promote_types(u.dtype, p.dtype)
                u = u.to(wide) + (wd * p).to(wide)
            return -1 * u, v_row, v_col, v

        out = tree_map(leaf, grads, state["v_row"], state["v_col"], state["v"], params,
                       *(() if shards is None else (shards,)))
        updates, v_row, v_col, v = (tree_map(lambda t, i=i: t[i], out)
                                    for i in range(4))
        return updates, {"count": count + 1, "v_row": v_row, "v_col": v_col, "v": v}

    return Optimizer(init, update)


def with_master_weights(inner: Optimizer) -> Optimizer:
    """Wrap an optimizer with an f32 master copy of the params: the inner
    optimizer runs in f32 against the master; the emitted update is
    ``new_master - params`` in f32, so the caller's apply
    ``(p.float() + u).to(p.dtype)`` lands on the rounded master."""

    def init(params, shards=None):
        master = tree_map(lambda p: p.float().clone(), params)
        return {"inner": inner.init(master, shards=shards), "master": master}

    @torch.no_grad()
    def update(grads, state, params, grad_norm=None, shards=None):
        grads32 = tree_map(lambda g: g.float(), grads)
        updates32, inner_state = inner.update(grads32, state["inner"], state["master"],
                                              grad_norm=grad_norm, shards=shards)

        def leaf(m, u, p):
            m.add_(u)                          # new master, in place
            return torch.sub(m, p.float(), out=u)

        emitted = tree_map(leaf, state["master"], updates32, params)
        return emitted, {"inner": inner_state, "master": state["master"]}

    return Optimizer(init, update)


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    makers = {"adamw": adamw, "adafactor": adafactor}
    if cfg.name not in makers:
        raise ValueError(f"optimizer.name must be adamw|adafactor, got {cfg.name!r}")
    tx = makers[cfg.name](cfg)
    return with_master_weights(tx) if cfg.master_weights else tx


def create_train_state(
    init_params_fn: Callable[[], Any],
    tx: Optimizer,
    mesh=None,
    partition_rules=None,
) -> TrainState:
    """Params from ``init_params_fn()`` and the optimizer state for them.

    Under ``mesh`` the full params are cut into this rank's blocks under
    ``partition_rules`` and the optimizer state is made from the blocks:
    each moment is sharded like its parameter."""
    params = init_params_fn()
    if mesh is None:
        return TrainState(0, params, tx.init(params))
    from rlinf_tpu_torch.parallel.sharding import Layout
    from rlinf_tpu_torch.training.sharded_step import shards_of

    layout = Layout.from_rules(mesh, partition_rules, params)
    params = layout.shard(params)
    return TrainState(0, params, tx.init(params, shards=shards_of(layout, params)))


def rescale_train_state(state: TrainState, new_mesh, partition_rules, *,
                        old_layout=None) -> TrainState:
    """Re-shard a live TrainState (params and optimizer state) onto
    ``new_mesh`` under the same rules: the online parallel-strategy switch.
    Every rank gathers each leaf whole under ``old_layout`` (the blocks'
    layout; None: the leaves are whole already) and keeps its block of the
    new mesh (None: the whole leaves, as on one card)."""
    from rlinf_tpu_torch.parallel.sharding import Layout

    params, opt_state = state.params, state.opt_state
    if old_layout is not None:
        params, opt_state = old_layout.gather(params), old_layout.gather(opt_state)
    if new_mesh is not None:
        new = Layout.from_rules(new_mesh, partition_rules, params)
        params, opt_state = new.shard(params), new.shard(opt_state)
    return TrainState(state.step, params, opt_state)


def apply_updates(params, updates) -> None:
    """p <- (p.float() + u.float()).to(p.dtype), in place: the port keeps one
    copy of the params where the JAX package donated the old buffers."""
    def one(p, u):
        p.copy_((p.float() + u.float()).to(p.dtype))

    with torch.no_grad():
        tree_map(one, params, updates)
