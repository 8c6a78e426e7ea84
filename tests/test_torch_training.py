"""The port's optimizer, policy train step, logprob recompute and config
against the JAX package, on the CPU at ``LLMConfig.tiny`` (2 layers).

One JAX init feeds both sides through ``params_from_numpy``; batches and
gradients are drawn with numpy from a seed. Tolerances are stated per test:
fp32 paths agree to summation-order rounding; bf16 paths differ where the
two frameworks round bf16 intermediates at different places.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlinf_tpu import config as jconfig
from rlinf_tpu.models.llm import model as JM
from rlinf_tpu.models.llm.config import LLMConfig as JConfig
from rlinf_tpu.training import learner as JL
from rlinf_tpu.training import train_state as JS
from rlinf_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from rlinf_tpu_torch import config as tconfig
from rlinf_tpu_torch.models.llm import model as TM
from rlinf_tpu_torch.models.llm.config import LLMConfig as TConfig
from rlinf_tpu_torch.models.llm.convert import params_from_numpy
from rlinf_tpu_torch.training import learner as TL
from rlinf_tpu_torch.training import train_state as TS

torch.set_num_threads(2)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_trees_close(got, want, **tol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_trees_close(got[k], want[k], **tol)
    else:
        np.testing.assert_allclose(_np(got), _np(want), **tol)


# --- optimizer ------------------------------------------------------------------

OPT_CASES = {
    # fp32 params, clipping active, decoupled weight decay, warmup + cosine
    "fp32_clip_wd_cosine": (jnp.float32, dict(
        lr=1e-2, min_lr=1e-3, weight_decay=0.05, clip_grad=0.5, warmup_steps=2,
        total_steps=6, schedule="cosine")),
    # bf16 params, bf16 first moment (nu starts bf16 too), linear warmup
    "bf16_moments_warmup": (jnp.bfloat16, dict(
        lr=1e-2, weight_decay=0.01, clip_grad=1.0, warmup_steps=2, moment_dtype="bfloat16")),
    # bf16 params against an f32 master copy, cosine without warmup
    "bf16_master_cosine": (jnp.bfloat16, dict(
        lr=1e-2, clip_grad=1.0, total_steps=5, schedule="cosine", master_weights=True)),
    # fp32 params, clipping off
    "fp32_noclip": (jnp.float32, dict(lr=3e-3, clip_grad=0.0)),
    # adafactor (optax.adafactor as the JAX package calls it): fp32, constant lr
    "adafactor_fp32": (jnp.float32, dict(name="adafactor", lr=1e-2, clip_grad=1.0)),
    # fp32, weight decay (added after the lr step), warmup, clipping active
    "adafactor_fp32_wd_warmup": (jnp.float32, dict(
        name="adafactor", lr=1e-2, weight_decay=0.1, warmup_steps=2, clip_grad=0.5)),
    # bf16 params against an f32 master copy (the parameter scale reads it)
    "adafactor_bf16_master_wd": (jnp.bfloat16, dict(
        name="adafactor", lr=1e-2, weight_decay=0.01, total_steps=5, schedule="cosine",
        master_weights=True)),
    # bf16 params and bf16 statistics, warmup
    "adafactor_bf16_warmup": (jnp.bfloat16, dict(name="adafactor", lr=1e-2, warmup_steps=2)),
}
# adafactor's leaves: factored over the two largest dims ([2, 256, 384]:
# rows of 256, columns of 384), unfactored where the second largest dim is
# under 128 ([2, 256, 64]), vectors and a small matrix
FACTORED_SHAPES = {"w": (2, 256, 384), "u": (2, 256, 64), "blocks": {"b": (3, 5), "c": (7,)}}


def _factored_state(jstate):
    """optax's FactoredState (count, v_row, v_col, v) inside a JAX state."""
    from optax._src.factorized import FactoredState

    (st,) = [x for x in jax.tree_util.tree_leaves(
        jstate, is_leaf=lambda x: isinstance(x, FactoredState)) if isinstance(x, FactoredState)]
    return st


@pytest.mark.parametrize("case", sorted(OPT_CASES))
@pytest.mark.parametrize("grad_dtype", ["f32", "param"])
def test_optimizer_three_steps_match_optax(case, grad_dtype):
    """Three updates from the same params and gradients. fp32: params within
    1e-6; bf16 params: within one bf16 step of the parameter (the f32
    updates agree to 1e-6 before the cast, so a cast may round either way
    only at a tie). Adafactor's fp32 statistics within rtol=1e-5,
    atol=1e-8."""
    dtype, fields = OPT_CASES[case]
    r = np.random.default_rng(0)
    factored = fields.get("name") == "adafactor"
    shapes = FACTORED_SHAPES if factored else {"a": (4, 6), "blocks": {"b": (3, 5), "c": (7,)}}
    p0 = jax.tree_util.tree_map(lambda s: (r.normal(size=s) * 0.5).astype(np.float32), shapes,
                                is_leaf=lambda x: isinstance(x, tuple))
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), p0)
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32), jp)
    jtx = JS.make_optimizer(JS.OptimizerConfig(**fields))
    ttx = TS.make_optimizer(TS.OptimizerConfig(**fields))
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    for step in range(3):
        g = jax.tree_util.tree_map(lambda a: (r.normal(size=a.shape) * (step + 1)).astype(np.float32), p0)
        gdt = jnp.float32 if grad_dtype == "f32" else dtype
        jg = jax.tree_util.tree_map(lambda a: jnp.asarray(a, gdt), g)
        tg = TS.tree_map(lambda a, p: torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(
            torch.float32 if grad_dtype == "f32" else p.dtype), jg, tp)
        ju, jstate = jtx.update(jg, jstate, jp)
        jp = jax.tree_util.tree_map(
            lambda p, u: (p.astype(jnp.float32) + u.astype(jnp.float32)).astype(p.dtype), jp, ju)
        tu, tstate = ttx.update(tg, tstate, tp)
        TS.apply_updates(tp, tu)
        if dtype == jnp.float32:
            _assert_trees_close(tu, ju, rtol=1e-5, atol=1e-8)
            _assert_trees_close(tp, jp, rtol=1e-6, atol=1e-7)
            if factored:
                js = _factored_state(jstate)
                ts = tstate["inner"] if "inner" in tstate else tstate
                for key in ("v_row", "v_col", "v"):
                    _assert_trees_close(ts[key], getattr(js, key), rtol=1e-5, atol=1e-8)
                assert ts["count"] == int(js.count)
        else:
            _assert_trees_close(tp, jp, rtol=2 ** -7, atol=1e-6)
    if factored:
        ts = tstate["inner"] if "inner" in tstate else tstate
        assert ts["v_row"]["w"].shape == (2, 256) and ts["v_col"]["w"].shape == (2, 384)
        assert ts["v"]["u"].shape == (2, 256, 64) and ts["v"]["blocks"]["c"].shape == (7,)
        assert ts["v"]["w"].shape == ts["v_row"]["u"].shape == (1,)
    jt = jax.tree_util.tree_leaves(jstate)
    assert sum(x.size for x in jt if hasattr(x, "size")) > 0


def test_optimizer_rejects_adafactor_and_mesh():
    """sgd raises; adafactor is an optimizer of the port (its updates are
    held against optax by the cases above) and takes a mesh that shards its
    leaves: its statistics are made from the WHOLE leaf's shape, cut to the
    rank's block (a [256, 128] leaf split to [256, 64] still factors: its
    row statistic, without the largest dim, keeps the rank's 64 columns,
    its column statistic the 256 rows), and the layout gives them their
    specs for the checkpoints.
    adamw takes the same mesh (each rank its block). The sharded updates
    against optax on a mesh: tests/test_torch_mesh_configs.py."""
    tx = TS.make_optimizer(TS.OptimizerConfig(name="adafactor"))
    assert set(tx.init({"w": torch.zeros(256, 128)})) == {"count", "v_row", "v_col", "v"}
    with pytest.raises(ValueError):
        TS.make_optimizer(TS.OptimizerConfig(name="sgd"))
    mesh = make_mesh(MeshConfig(data=1, tensor=2), ranks=[0, 1], device_type="cpu")
    rules = [(r"w", (None, "tensor"))]
    st = TS.create_train_state(lambda: {"w": torch.zeros(256, 128)}, tx, mesh=mesh,
                               partition_rules=rules)
    assert st.params["w"].shape == (256, 64)
    assert st.opt_state["v_row"]["w"].shape == (64,)
    assert st.opt_state["v_col"]["w"].shape == (256,)
    assert st.opt_state["v"]["w"].shape == (1,)
    from rlinf_tpu_torch.parallel.sharding import Layout

    lay = Layout.from_rules(mesh, rules, {"w": torch.zeros(256, 128)})
    assert lay.spec_for("v_row/w", (64,)) == ("tensor",)
    assert lay.spec_for("v_col/w", (256,)) == ()
    assert lay.spec_for("mu/w", (256, 64)) == (None, "tensor")
    st = TS.create_train_state(lambda: {"w": torch.zeros(256, 128)},
                               TS.make_optimizer(TS.OptimizerConfig()), mesh=mesh,
                               partition_rules=rules)
    assert st.params["w"].shape == st.opt_state["mu"]["w"].shape == (256, 64)


@pytest.mark.parametrize("fields", [
    dict(lr=1e-3),
    dict(lr=1e-3, warmup_steps=3),
    dict(lr=1e-3, min_lr=1e-4, warmup_steps=2, total_steps=7, schedule="cosine"),
    dict(lr=1e-3, total_steps=4, schedule="cosine"),
])
def test_schedule_matches_optax(fields):
    js = JS.make_schedule(JS.OptimizerConfig(**fields))
    ts = TS.make_schedule(TS.OptimizerConfig(**fields))
    for c in range(10):
        want = js(jnp.int32(c)) if callable(js) else js
        got = ts(c) if callable(ts) else ts
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-12)


# --- train step -------------------------------------------------------------------

def _configs(dtype):
    jcfg = dataclasses.replace(JConfig.tiny(), dtype=dtype)
    return jcfg, TConfig(**dataclasses.asdict(jcfg))


def _batch(cfg, B=4, T=16, seed=0, decoupled=False):
    """Right-padded rows (as build_train_batch lays them out)."""
    r = np.random.default_rng(seed)
    lens = r.integers(T // 2, T + 1, B)
    lens[0] = T
    attn = np.arange(T)[None, :] < lens[:, None]
    loss_mask = attn & (r.random((B, T)) > 0.3)
    b = {
        "input_ids": np.where(attn, r.integers(0, cfg.vocab_size, (B, T)), 0).astype(np.int32),
        "target_ids": r.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
        "attention_mask": attn,
        "loss_mask": loss_mask,
        "old_logprobs": np.where(loss_mask, -np.log(cfg.vocab_size) + r.normal(size=(B, T)) * 0.1,
                                 0).astype(np.float32),
        "advantages": (r.normal(size=(B, T)) * loss_mask).astype(np.float32),
    }
    if decoupled:
        b["versions"] = np.array([3, 4, -1, 2][:B], np.int32)
        b["current_version"] = np.full((B,), 5, np.int32)
    return b


STEP_CASES = [
    # (num_microbatches, remat, dtype, loss_type, port attn_impl)
    (1, False, "float32", "ppo", "xla"),
    (2, True, "float32", "ppo", "pallas"),
    (2, True, "float32", "decoupled", "xla"),
    (2, False, "bfloat16", "ppo", "xla"),
    (1, True, "bfloat16", "decoupled", "pallas"),
]


@pytest.mark.parametrize("n_mb,remat,dtype,loss_type,impl", STEP_CASES)
def test_policy_train_step_matches_jax(n_mb, remat, dtype, loss_type, impl):
    """One step at LLMConfig.tiny with entropy bonus, KL term and adamw
    (master weights for bf16). The JAX side runs its plain attention; the
    port's "pallas" runs the flash autograd Function's plain versions.
    Adam's first step is g / (|g| + eps): with eps = 1e-8 an entry whose
    gradient is rounding noise on both sides can move by up to 2 lr, so the
    test takes eps = 1e-3, which bounds the update's sensitivity to 1/eps.
    fp32: loss and metrics within 1e-5, grad norm 1e-4 relative, params
    1e-6. bf16: loss and metrics within 2e-2 relative, grad norm 5e-2,
    master-weight updates within 5% of their norm per leaf (the bf16
    forward rounds differently)."""
    jcfg, tcfg = _configs(dtype)
    loss_cfg = dict(entropy_bonus=1e-2, kl_beta=0.05, loss_type=loss_type, logprob_chunk_size=8,
                    clip_ratio_c=3.0)
    opt = dict(lr=1e-3, eps=1e-3, weight_decay=0.01, master_weights=dtype == "bfloat16")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(1))
    p0 = jax.tree_util.tree_map(np.array, jp)       # the JAX step donates jp
    tp = params_from_numpy(p0, tcfg, device="cpu")
    batch = _batch(tcfg, decoupled=loss_type == "decoupled")
    batch["ref_logprobs"] = batch["old_logprobs"] + 0.05

    jtx = JS.make_optimizer(JS.OptimizerConfig(**opt))
    jstep = JL.make_policy_train_step(jcfg, JL.PolicyLossConfig(**loss_cfg), jtx,
                                      num_microbatches=n_mb, remat=remat, attn_impl="xla")
    jstate, jm = jstep(JS.TrainState(jnp.zeros((), jnp.int32), jp, jtx.init(jp)),
                       {k: jnp.asarray(v) for k, v in batch.items()})
    ttx = TS.make_optimizer(TS.OptimizerConfig(**opt))
    tstep = TL.make_policy_train_step(tcfg, TL.PolicyLossConfig(**loss_cfg), ttx,
                                      num_microbatches=n_mb, remat=remat, attn_impl=impl,
                                      device="cpu")
    tstate, tm = tstep(TS.TrainState(0, tp, ttx.init(tp)), batch)

    assert tstate.step == 1 and set(tm) == set(jm)
    fp32 = dtype == "float32"
    for k in jm:
        if k == "actor/grad_norm":
            np.testing.assert_allclose(_np(tm[k]), _np(jm[k]), rtol=1e-4 if fp32 else 5e-2)
        else:
            np.testing.assert_allclose(_np(tm[k]), _np(jm[k]), rtol=1e-5 if fp32 else 2e-2,
                                       atol=1e-5 if fp32 else 2e-2, err_msg=k)
    if fp32:
        _assert_trees_close(tstate.params, jstate.params, rtol=1e-6, atol=1e-6)
        return
    # bf16 against f32 master weights: per leaf, the master's update differs
    # from JAX's by under 5% of its norm, and the bf16 params are the
    # rounded masters on both sides
    for b0, tm1, jm1, t1 in zip(
            [a.astype(np.float32) for a in jax.tree_util.tree_leaves(p0)],
            TS.tree_leaves(tstate.opt_state["master"]),
            jax.tree_util.tree_leaves(jstate.opt_state["master"]),
            TS.tree_leaves(tstate.params)):
        dt, dj = _np(tm1) - b0, _np(jm1) - b0
        assert np.linalg.norm(dt - dj) <= 0.05 * np.linalg.norm(dj) + 1e-9
        assert torch.equal(t1, tm1.to(torch.bfloat16))


def test_grad_and_apply_equals_train_step():
    """make_policy_grad_and_apply over two microbatches gives the params of
    make_policy_train_step(num_microbatches=2) (fp32, 1e-6)."""
    _, tcfg = _configs("float32")
    loss_cfg = TL.PolicyLossConfig()
    opt = TS.OptimizerConfig(lr=1e-3)
    batch = _batch(tcfg, seed=3)
    tx = TS.make_optimizer(opt)
    p1 = TM.init_params(tcfg, 0, device="cpu")
    s1, m1 = TL.make_policy_train_step(tcfg, loss_cfg, tx, num_microbatches=2, device="cpu")(
        TS.TrainState(0, p1, tx.init(p1)), batch)
    p2 = TM.init_params(tcfg, 0, device="cpu")
    grad_step, apply_step, zero_grads = TL.make_policy_grad_and_apply(tcfg, loss_cfg, tx,
                                                                      device="cpu")
    acc = zero_grads(p2)
    gv = float(batch["loss_mask"].sum())
    for half in (slice(0, 2), slice(2, 4)):
        acc, _, _ = grad_step(p2, acc, {k: v[half] for k, v in batch.items()}, gv)
    s2, gn = apply_step(TS.TrainState(0, p2, tx.init(p2)), acc)
    np.testing.assert_allclose(_np(gn), _np(m1["actor/grad_norm"]), rtol=1e-6)
    _assert_trees_close(s2.params, s1.params, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("temperature,impl", [(1.0, "xla"), (0.7, "pallas")])
def test_logprob_fn_matches_jax(temperature, impl):
    """Recompute at LLMConfig.tiny, fp32, within 1e-4 (two layers of fp32
    summation-order noise)."""
    jcfg, tcfg = _configs("float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(2))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    batch = _batch(tcfg, seed=4)
    jlp, jent = JL.make_logprob_fn(jcfg, chunk_size=8, temperature=temperature)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tlp, tent = TL.make_logprob_fn(tcfg, chunk_size=8, temperature=temperature, attn_impl=impl,
                                   device="cpu")(tp, batch)
    valid = batch["attention_mask"]
    np.testing.assert_allclose(_np(tlp) * valid, _np(jlp) * valid, atol=1e-4)
    np.testing.assert_allclose(_np(tent) * valid, _np(jent) * valid, atol=1e-4)


def test_forward_logits_and_remat_options():
    jcfg, tcfg = _configs("float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    ids = np.random.default_rng(5).integers(0, tcfg.vocab_size, (2, 6)).astype(np.int32)
    got = TM.forward_logits(tp, tcfg, torch.from_numpy(ids), remat=True, unroll_layers=True)
    want = JM.forward_logits(jp, jcfg, jnp.asarray(ids))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4)
    got = TM.forward_logits(tp, tcfg, torch.from_numpy(ids), remat="dots")
    np.testing.assert_allclose(_np(got), _np(JM.forward_logits(jp, jcfg, jnp.asarray(ids),
                                                             remat="dots")), atol=1e-4)
    with pytest.raises(ValueError):
        TM.forward_hidden(tp, tcfg, torch.from_numpy(ids), remat="some")


def _held_bytes(fn) -> int:
    """Bytes that ``fn()`` leaves allocated on the CPU while its result
    lives (torch.profiler's memory records: allocations less frees)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        out = fn()
    del out
    return sum(e.self_cpu_memory_usage for e in prof.key_averages())


def test_remat_dots_grads_and_what_it_keeps():
    """remat="dots" against remat=False: logits and the gradients of every
    parameter within f32 atol=1e-6. What the forward keeps for the backward
    lies between the two other forms: fewer bytes than remat=False (norms,
    activations and attention are recomputed) and more than remat=True
    (the projections' outputs are kept); the backward recomputes no matrix
    product where True recomputes each projection. (A saved-tensors hook
    outside the block sees only a non-reentrant checkpoint's inputs, so
    the bytes are read from the profiler's memory records.)"""
    from torch.utils._python_dispatch import TorchDispatchMode

    _, tcfg = _configs("float32")
    params = TM.init_params(tcfg, 1, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(6).integers(0, tcfg.vocab_size, (2, 32)))
    mask = torch.ones(2, 32, dtype=torch.bool)
    mask[1, :5] = False

    class CountMM(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.mm = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.mm += func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
            return func(*args, **(kwargs or {}))

    def forward(p, remat):
        return TM.forward_logits(p, tcfg, ids, attention_mask=mask, remat=remat)

    runs = {}
    for remat in (False, True, "dots"):
        alias = TS.tree_map(lambda t: t.detach().requires_grad_(True), params)
        logits = forward(alias, remat)
        leaves = TS.tree_leaves(alias)
        count = CountMM()
        with count:
            grads = torch.autograd.grad(logits.square().mean(), leaves)
        runs[remat] = (logits.detach(), grads, count.mm)
        forward(alias, remat)       # warm the allocator before measuring
        runs[remat] += (_held_bytes(lambda: forward(alias, remat)),)
    (l0, g0, mm0, b0), (_, _, mm1, b1), (l2, g2, mm2, b2) = (runs[k] for k in (False, True, "dots"))
    np.testing.assert_allclose(_np(l2), _np(l0), rtol=0, atol=1e-6)
    for a, b in zip(g2, g0):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-6)
    assert b1 < b2 < b0, (b0, b1, b2)
    assert mm2 == mm0 < mm1, (mm0, mm1, mm2)


def test_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _configs("float32")
    tx = TS.make_optimizer(TS.OptimizerConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TL.make_policy_train_step(tcfg, TL.PolicyLossConfig(), tx)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TL.make_logprob_fn(tcfg)


# --- config -------------------------------------------------------------------------

def test_yaml_config_loads_equal_on_both_sides():
    path = "examples/reasoning/config/grpo_demo_tiny.yaml"
    overrides = ["optimizer.lr=3e-4", "loss.entropy_bonus=0.01", "num_microbatches=2"]
    j = jconfig.load_config(path, overrides)
    t = tconfig.load_config(path, overrides)
    jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
    assert jd == td
    assert tconfig.resolve_attn_impl(t, device="cpu") == "xla"
    assert tconfig.resolve_attn_impl(dataclasses.replace(t, attn_impl="pallas"), "cpu") == "pallas"
    # on the card "auto" takes the kernels from ATTN_KERNELS_FROM_T (128) trained
    # tokens, for a head dim they take (the YAML model's is 16: refused there,
    # tests/test_torch_geometry.py)
    assert tconfig.ATTN_KERNELS_FROM_T == 128
    kernel_heads = dataclasses.replace(t.model, max_seq_len=4096, head_dim=64)
    long = dataclasses.replace(t, data=dataclasses.replace(t.data, max_prompt_len=2048),
                               model=kernel_heads)
    assert tconfig.resolve_attn_impl(long, device="cuda") == "pallas"
    at = dataclasses.replace(t, data=dataclasses.replace(t.data, max_prompt_len=112),
                             model=kernel_heads)
    assert tconfig.resolve_attn_impl(at, device="cuda") == "pallas"          # 112 + 16 tokens
    short = dataclasses.replace(at, data=dataclasses.replace(t.data, max_prompt_len=111))
    assert tconfig.resolve_attn_impl(short, device="cuda") == "xla"


@pytest.mark.parametrize("override", [
    "num_microbatches=3", "model.dtype=int8", "algorithm.adv_type=nope",
    "algorithm.group_size=1", "mesh.data=-1", "rollout.engine=nope",
])
def test_config_validators_match_jax(override):
    path = "examples/reasoning/config/grpo_demo_tiny.yaml"
    extra = ["mesh.fsdp=-1"] if override == "mesh.data=-1" else []
    outcomes = []
    for load in (jconfig.load_config, tconfig.load_config):
        try:
            load(path, [override] + extra)
            outcomes.append("ok")
        except ValueError:
            outcomes.append("ValueError")
    assert outcomes[0] == outcomes[1]
