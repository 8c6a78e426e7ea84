"""Rank bodies for worlds of processes (``parallel.launch.spawn_world``).

Each function runs on every rank of a world and returns plain data (numpy
arrays, floats, dicts), so that a parent process, which may hold other
packages, compares what the ranks computed. They drive the port's public
entry points under a mesh: the sharded train step, the logprob recompute,
the static engine, ``ReasoningRunner(mesh=)``, the checkpoints, the weight
syncers and the disaggregated runner; ring attention and the context axis
(``ring_case``, ``ring_shift_case``, ``ring_forward``); ``SFTRunner(mesh=)``
(``sft_steps``) and the slot-pool engines under a mesh
(``greedy_rollout(engine=)``); the expert-parallel dropless layer
(``dropless_ep_case``) and the dynamic scheduler's moves
(``migration_case``). ``jobs`` runs several bodies in one world,
so that a caller pays the start of a world once.
"""

from __future__ import annotations

import os
from typing import Any, List

import numpy as np
import torch
import torch.distributed as dist


def _np(t) -> np.ndarray:
    """A copy as numpy (never a view of a buffer a later step writes)."""
    return t.detach().float().cpu().numpy().copy() if torch.is_tensor(t) else np.array(t)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return _np(tree)


def jobs(rank: int, world: int, items: List[Any], device: str = "cuda") -> List[Any]:
    """Run ``(function name, kwargs)`` items of this module in order on
    every rank; return their results. The ranks run at a lower scheduling
    priority (nice 10) than the process that started them, so that a world
    of checks crowds no other work on the host."""
    os.nice(10)
    out = []
    for name, kw in items:
        out.append(globals()[name](rank, world, device=device, **kw))
    return out


# ---------------------------------------------------------------------------
# Meshes and sharding
# ---------------------------------------------------------------------------

def mesh_facts(rank, world, *, mesh_cfg, device="cuda"):
    """The mesh's shape, this rank's coordinate, the batch block, and one
    all-reduce over each axis (the sum of the ranks' global indices)."""
    from rlinf_tpu_torch.parallel import collectives as C
    from rlinf_tpu_torch.parallel.distributed import shard_rows_for_process
    from rlinf_tpu_torch.parallel.mesh import MESH_ORDER, AxisNames as Ax, make_mesh

    mesh = make_mesh(mesh_cfg, device_type=torch.device(device).type)
    sums = {}
    for axis in MESH_ORDER + (Ax.BATCH,):
        x = torch.tensor([float(rank)])
        sums[str(axis)] = float(C.all_reduce_(x, "sum", mesh.get_group(axis))[0])
    sl = shard_rows_for_process(8, mesh)
    return {"shape": dict(mesh.shape), "coord": mesh.coordinate(), "sums": sums,
            "rows": (sl.start, sl.stop)}


def shard_roundtrip(rank, world, *, mesh_cfg, cfg, params, device="cuda"):
    """Blocks of the JAX-layout params under ``partition_rules``, their
    shapes, and the params gathered back whole."""
    from rlinf_tpu_torch.models.llm import model as M
    from rlinf_tpu_torch.parallel.mesh import make_mesh
    from rlinf_tpu_torch.parallel.sharding import (
        gather_pytree, match_partition_rules, tree_shardings,
    )
    from rlinf_tpu_torch.models.llm.convert import params_from_numpy

    mesh = make_mesh(mesh_cfg, device_type=torch.device(device).type)
    blocks = M.shard_params_from_numpy(params, cfg, mesh, device=device)
    full = params_from_numpy(params, cfg, device=device)
    specs = tree_shardings(full, match_partition_rules(M.partition_rules(), full), mesh)
    back = gather_pytree(blocks, specs, mesh)
    return {"shapes": {k: tuple(v.shape) for k, v in _flat(blocks).items()},
            "back": _np_tree(back)}


def _flat(tree, prefix=""):
    from rlinf_tpu_torch.parallel.sharding import flatten_with_paths

    return dict(flatten_with_paths(tree, prefix))


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def train_steps(rank, world, *, mesh_cfg, size=None, **kw):
    """``make_policy_train_step(mesh=)`` on each global batch in turn from
    the JAX-layout ``params``, on a mesh of ``size`` ranks (default: the
    world; smaller meshes run side by side): the losses, grad norms and
    the updated params gathered whole (on the mesh's first rank)."""
    return _train_steps(rank, _my_mesh(mesh_cfg, size or world, kw.get("device", "cuda")), **kw)


def logprobs(rank, world, *, mesh_cfg, cfg, params, batch, device="cuda"):
    """``make_logprob_fn(mesh=)`` on a global batch, and
    ``vocab_parallel_logprobs_and_entropy`` over the tensor axis."""
    from rlinf_tpu_torch.models.llm import model as M
    from rlinf_tpu_torch.ops.logprobs import vocab_parallel_logprobs_and_entropy
    from rlinf_tpu_torch.parallel import collectives as C
    from rlinf_tpu_torch.parallel.mesh import AxisNames as Ax, make_mesh, use_mesh
    from rlinf_tpu_torch.training.learner import make_logprob_fn

    mesh = make_mesh(mesh_cfg, device_type=torch.device(device).type)
    p = M.shard_params_from_numpy(params, cfg, mesh, device=device)
    fn = make_logprob_fn(cfg, chunk_size=batch["input_ids"].shape[1], attn_impl="xla",
                         mesh=mesh, device=device)
    lp, ent = fn(p, batch)
    # the vocab-parallel form on this rank's columns of the (untied) head
    with use_mesh(mesh):
        hidden, _ = M.forward_hidden(p, cfg, torch.as_tensor(batch["input_ids"]),
                                     attention_mask=torch.as_tensor(batch["attention_mask"]))
    w = p["lm_head"]                         # [D/fsdp, V/tp] -> [D, V/tp]
    for d in M._split_dims(cfg, mesh, "lm_head", w, Ax.FSDP):
        w = C.gather_tensor(w, d, mesh.get_group(Ax.FSDP))
    vlp, vent = vocab_parallel_logprobs_and_entropy(
        hidden, w, torch.as_tensor(batch["target_ids"]), mesh=mesh, vocab_axis=Ax.TENSOR)
    return {"lp": _np(lp), "ent": _np(ent), "vlp": _np(vlp), "vent": _np(vent)}


def quantized_blocks(rank, world, *, mesh_cfg, cfg, params, size=None, device="cuda"):
    """int8 decode weights of this rank's blocks (``quantize_params`` with
    the mesh active, unfused): q and scales of every block weight."""
    from rlinf_tpu_torch.models.llm import model as M
    from rlinf_tpu_torch.models.llm.quant import quantize_params
    from rlinf_tpu_torch.parallel.mesh import AxisNames as Ax, use_mesh

    mesh = _my_mesh(mesh_cfg, size or world, device)
    p = M.shard_params_from_numpy(params, cfg, mesh, device=device)
    with use_mesh(mesh), torch.no_grad():
        q = quantize_params(M.rollout_params(p, cfg), fuse=False)
    return {"tensor_index": mesh.axis_index(Ax.TENSOR),
            "blocks": {k: (_np(v.q), _np(v.scale)) for k, v in q["blocks"].items()
                       if hasattr(v, "scale")}}


def greedy_rollout(rank, world, *, mesh_cfg, cfg, params, prompts, max_new_tokens,
                   size=None, engine="static", engine_kw=None, device="cuda"):
    """Greedy tokens of an engine ("static", "continuous" or "paged", with
    ``engine_kw``) under ``rollout(mesh=)``."""
    from rlinf_tpu_torch.data.io_struct import RolloutRequest
    from rlinf_tpu_torch.models.llm import model as M
    from rlinf_tpu_torch.models.llm.sampler import SamplingParams
    from rlinf_tpu_torch.rollout.continuous_engine import ContinuousBatchingEngine
    from rlinf_tpu_torch.rollout.engine import RolloutEngine
    from rlinf_tpu_torch.rollout.paged_engine import PagedContinuousEngine

    mesh = _my_mesh(mesh_cfg, size or world, device)
    p = M.shard_params_from_numpy(params, cfg, mesh, device=device)
    sp = SamplingParams(max_new_tokens=max_new_tokens, greedy=True, eos_token_id=-1)
    kind = {"static": RolloutEngine, "continuous": ContinuousBatchingEngine,
            "paged": PagedContinuousEngine}[engine]
    eng = kind(cfg, sp, prompt_bucket=8, device=device, **(engine_kw or {}))
    res = eng.rollout(p, RolloutRequest(prompt_ids=prompts), torch.Generator().manual_seed(0),
                      mesh=mesh)
    return {"ids": res.response_ids, "lps": res.response_logprobs}


def _my_mesh(mesh_cfg, size: int, device: str):
    """A mesh of ``size`` ranks: the world cut into consecutive blocks of
    ``size``, each block a mesh (every rank builds all of them, in order);
    returns this rank's."""
    from rlinf_tpu_torch.parallel.mesh import make_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    mine = None
    for lo in range(0, world, size):
        m = make_mesh(mesh_cfg, ranks=list(range(lo, lo + size)),
                      device_type=torch.device(device).type)
        if m.contains():
            mine = m
    return mine


def _train_steps(rank, mesh, *, cfg, params, batches, opt_cfg, loss_cfg,
                 num_microbatches=1, attn_impl="xla", remat=False, device="cuda"):
    from rlinf_tpu_torch.models.llm import model as M
    from rlinf_tpu_torch.training.learner import make_policy_train_step
    from rlinf_tpu_torch.training.sharded_step import model_layout, shards_of
    from rlinf_tpu_torch.training.train_state import TrainState, make_optimizer

    tx = make_optimizer(opt_cfg)
    lay = model_layout(cfg, mesh)
    p = M.shard_params_from_numpy(params, cfg, mesh, device=device)
    state = TrainState(0, p, tx.init(p, shards=shards_of(lay, p)))
    step = make_policy_train_step(cfg, loss_cfg, tx, num_microbatches=num_microbatches,
                                  remat=remat, attn_impl=attn_impl, mesh=mesh, device=device)
    losses, norms = [], []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["actor/loss"]))
        norms.append(float(m["actor/grad_norm"]))
    full, opt = lay.gather(state.params), lay.gather(state.opt_state)   # on every rank
    first = rank == mesh.ranks[0]
    return {"losses": losses, "grad_norms": norms,
            "params": _np_tree(full) if first else None,
            "opt_state": _np_tree(opt) if first else None}


# ---------------------------------------------------------------------------
# The runner, rescale and checkpoints
# ---------------------------------------------------------------------------

def runner_steps(rank, world, *, mesh_cfg, yaml, overrides, params, rollouts, perm,
                 reward, ckpt_dir=None, rescale_to=None, pipelined_steps=0, adapters=None,
                 critic_params=None, rollouts_after=(), size=None, device="cuda"):
    """``ReasoningRunner(mesh=)`` from the JAX-layout ``params`` (LoRA:
    with the given ``adapters``; a separate critic: from
    ``critic_params``): one ``_train_on_result`` per given rollout (the
    permutation ``perm`` injected), then optionally a checkpoint
    (``ckpt_dir``), a ``rescale`` to ``rescale_to``, one
    ``_train_on_result`` per rollout of ``rollouts_after`` and
    ``pipelined_steps`` of ``run_pipelined`` (its rollouts from the
    runner's engine, on the new mesh). Returns the metrics, the params
    gathered whole before and after the rescale, and the pipelined steps'
    history."""
    from rlinf_tpu_torch import config as tconfig
    from rlinf_tpu_torch.data.datasets import PromptDataset, PromptExample
    from rlinf_tpu_torch.data.io_struct import RolloutResult
    from rlinf_tpu_torch.data.tokenizers import ByteTokenizer
    from rlinf_tpu_torch.models.llm.convert import params_from_numpy
    from rlinf_tpu_torch.parallel.mesh import make_mesh
    from rlinf_tpu_torch.runners.reasoning_runner import ReasoningRunner

    cfg = tconfig.load_config(yaml, overrides)
    if ckpt_dir:
        import dataclasses

        cfg = dataclasses.replace(cfg, runner=dataclasses.replace(
            cfg.runner, checkpoint_dir=ckpt_dir, save_interval=len(rollouts)))
    mesh = (make_mesh(mesh_cfg, device_type=torch.device(device).type) if size is None
            else _my_mesh(mesh_cfg, size, device))
    data = PromptDataset([PromptExample(f"q{i}", "a") for i in range(8)])
    r = ReasoningRunner(cfg, ByteTokenizer(), data, mesh=mesh, reward_fn=globals()[reward],
                        device=device,
                        init_params_override=lambda s: params_from_numpy(params, cfg.model,
                                                                         device=device))
    if adapters is not None:            # LoRA: the given adapters, whole on every rank
        from rlinf_tpu_torch.training.train_state import create_train_state

        tree = params_from_numpy({"embed": np.zeros((cfg.model.vocab_size,
                                                     cfg.model.hidden_size)), **adapters},
                                 cfg.model, device=device)
        tree.pop("embed")
        r.state = create_train_state(lambda: tree, r.tx)
    if critic_params is not None:
        from rlinf_tpu_torch.training.train_state import create_train_state

        r.critic_state = create_train_state(
            lambda: params_from_numpy(critic_params, cfg.model, device=device), r.critic_tx,
            mesh=mesh, partition_rules=r._rules(True))
    r._permutation = lambda n: np.asarray(perm)[:n]
    metrics = [r._train_on_result(RolloutResult(**arrays)) for arrays in rollouts]
    out = {"metrics": metrics, "params": _np_tree(r._layout(False).gather(r.state.params))}
    if rescale_to is not None:
        r.rescale(make_mesh(rescale_to, device_type=torch.device(device).type))
        out["rescaled_shapes"] = {k: tuple(v.shape) for k, v in _flat(r.state.params).items()}
        out["rescaled"] = _np_tree(r._layout(False).gather(r.state.params))
        out["rescaled_mu"] = _np_tree(r._layout(False).gather(r.state.opt_state["mu"]))
        out["metrics_after"] = [r._train_on_result(RolloutResult(**arrays))
                                for arrays in rollouts_after]
        out["params_after"] = _np_tree(r._layout(False).gather(r.state.params))
    if pipelined_steps:
        r.ckpt = None            # the checkpoint above stays the latest
        out["pipelined"] = r.run_pipelined(len(rollouts) + pipelined_steps)
    return out


# ---------------------------------------------------------------------------
# Weight sync and the disaggregated runner
# ---------------------------------------------------------------------------

def weight_syncs(rank, world, *, kind, actor_cfg, rollout_cfg, params, updates,
                 syncer_kwargs=None, device="cuda"):
    """A syncer from the actor's ranks (the first half) to the rollout's
    (the second half): the initial sync, then one after each update (the
    actor adds ``updates[i]`` to its blocks). Rollout ranks return their
    whole params after each sync; every rank the versions and bytes."""
    from rlinf_tpu_torch.parallel.mesh import ComponentPlacement
    from rlinf_tpu_torch.parallel.sharding import Layout
    from rlinf_tpu_torch.parallel.weight_sync import make_weight_syncer

    half = world // 2
    placement = ComponentPlacement(
        components={"actor": list(range(half)), "rollout": list(range(half, world))},
        mesh_configs={"actor": actor_cfg, "rollout": rollout_cfg}, device_type=torch.device(device).type)
    rules = [(r"w1", (None, "tensor")), (r"w2", ("tensor", None)), (r"scale", ())]
    full = {k: torch.as_tensor(v) for k, v in params.items()}
    meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in full.items()}
    actor = placement.mesh("actor")
    syncer = make_weight_syncer(kind, placement.mesh("rollout"), rules, source_mesh=actor,
                                source_rules=rules, full_shapes=meta, device=device,
                                **(syncer_kwargs or {}))
    mine = Layout.from_rules(actor, rules, full).shard(full) if actor.contains() else None
    got, versions, sent = [], [], []
    for i in range(len(updates) + 1):
        if i and mine is not None:
            lay = Layout.from_rules(actor, rules, full)
            upd = lay.shard({k: torch.as_tensor(v) for k, v in updates[i - 1].items()})
            for k in mine:
                mine[k].add_(upd[k])
        out = syncer.sync(mine)
        versions.append(syncer.version)
        sent.append(syncer.last_bytes_sent)
        if out is not None:
            got.append({"blocks": {k: tuple(v.shape) for k, v in out.items()},
                        "full": _np_tree(syncer.full_params())})
    return {"role": "actor" if mine is not None else "rollout", "got": got,
            "versions": versions, "bytes": sent}


def disaggregated_run(rank, world, *, yaml, overrides, steps, syncer="bucket",
                      sync_interval=1, actor_cfg=None, rollout_cfg=None, device="cuda"):
    """``DisaggregatedReasoningRunner`` with the actor on the first half of
    the world and the rollout on the second; every rank returns the
    history (the actor's metrics)."""
    from rlinf_tpu_torch import config as tconfig
    from rlinf_tpu_torch.data.datasets import PromptDataset, PromptExample
    from rlinf_tpu_torch.data.tokenizers import ByteTokenizer
    from rlinf_tpu_torch.parallel.mesh import ComponentPlacement, MeshConfig
    from rlinf_tpu_torch.runners.disaggregated_runner import DisaggregatedReasoningRunner

    cfg = tconfig.load_config(yaml, overrides)
    half = world // 2
    placement = ComponentPlacement(
        components={"actor": list(range(half)), "rollout": list(range(half, world))},
        mesh_configs={"actor": actor_cfg or MeshConfig(), "rollout": rollout_cfg or MeshConfig()},
        device_type=torch.device(device).type)
    data = PromptDataset([PromptExample(f"question {i}:", "unused") for i in range(32)])
    r = DisaggregatedReasoningRunner(cfg, ByteTokenizer(), data, placement=placement,
                                     reward_fn=char_reward, syncer=syncer,
                                     sync_interval=sync_interval, check_sync=True,
                                     device=device)
    hist = r.run(steps)
    return {"history": hist, "param_version": r.param_version, "is_actor": r.is_actor}


def disaggregated_steps(rank, world, *, yaml, overrides, params, rollouts, perm, syncer="bucket",
                        actor_cfg=None, rollout_cfg=None, device="cuda"):
    """``DisaggregatedReasoningRunner`` from the JAX-layout ``params``, as
    ``disaggregated_run`` places it, for ``len(rollouts)`` steps: the rollout
    ranks hand out the given rollouts in turn (stamped with the version
    they would have been generated at) and the permutation ``perm`` is
    injected. Returns the history, and on the rollout's first rank its
    whole weights after each sync (the initial one first)."""
    from rlinf_tpu_torch import config as tconfig
    from rlinf_tpu_torch.data.datasets import PromptDataset, PromptExample
    from rlinf_tpu_torch.data.io_struct import RolloutResult
    from rlinf_tpu_torch.data.tokenizers import ByteTokenizer
    from rlinf_tpu_torch.models.llm.convert import params_from_numpy
    from rlinf_tpu_torch.parallel.mesh import ComponentPlacement, MeshConfig
    from rlinf_tpu_torch.runners import reasoning_runner as RR
    from rlinf_tpu_torch.runners.disaggregated_runner import DisaggregatedReasoningRunner

    cfg = tconfig.load_config(yaml, overrides)
    half = world // 2
    placement = ComponentPlacement(
        components={"actor": list(range(half)), "rollout": list(range(half, world))},
        mesh_configs={"actor": actor_cfg or MeshConfig(), "rollout": rollout_cfg or MeshConfig()},
        device_type=torch.device(device).type)
    data = PromptDataset([PromptExample(f"q{i}", "a") for i in range(8)])
    # the actor's initial weights are the given ones (the rollout ranks
    # start on the meta device and get them by the initial sync)
    init = RR.init_params
    RR.init_params = lambda c, s, device="cuda": params_from_numpy(params, c, device=device)
    try:
        r = DisaggregatedReasoningRunner(cfg, ByteTokenizer(), data, placement=placement,
                                         reward_fn=odd_rule_reward, syncer=syncer,
                                         check_sync=True, device=device)
    finally:
        RR.init_params = init
    r._permutation = lambda n: np.asarray(perm)[:n]
    given = iter(rollouts)

    def injected():
        res = RolloutResult(**next(given))
        res.version = r.param_version
        return res

    synced = []
    sync = r._sync_weights

    def recorded():
        sync()
        if rank == r.rollout_leader:
            synced.append(_np_tree(r.syncer.full_params()))

    if rank == r.rollout_leader:
        synced.append(_np_tree(r.syncer.full_params()))
    r._disagg_rollout = injected
    r._sync_weights = recorded
    hist = r.run(len(rollouts))
    return {"history": hist, "synced": synced}


def odd_rule_reward(texts, answers):
    """1.0 where more than half of a text's characters have an odd code
    point, else 0.0."""
    return [float(sum(ord(c) % 2 for c in t) * 2 > len(t)) for t in texts]


def char_reward(texts, answers):
    """The fraction of the letter "a" in each response."""
    return [(sum(c == "a" for c in t) / max(len(t), 1)) if t else 0.0 for t in texts]


def sft_steps(rank, world, *, mesh_cfg, yaml, overrides, params, examples, steps,
              device="cuda"):
    """``SFTRunner(mesh=)`` from the JAX-layout ``params`` on ``examples``
    ((prompt, answer) pairs): ``steps`` run_steps; the metrics and the
    params gathered whole."""
    from rlinf_tpu_torch import config as tconfig
    from rlinf_tpu_torch.data.datasets import PromptDataset, PromptExample
    from rlinf_tpu_torch.data.tokenizers import ByteTokenizer
    from rlinf_tpu_torch.models.llm.convert import params_from_numpy
    from rlinf_tpu_torch.parallel.mesh import make_mesh
    from rlinf_tpu_torch.runners.sft_runner import SFTRunner

    cfg = tconfig.load_config(yaml, overrides)
    mesh = make_mesh(mesh_cfg, device_type=torch.device(device).type)
    r = SFTRunner(cfg, ByteTokenizer(), PromptDataset([PromptExample(p, a) for p, a in examples]),
                  mesh=mesh, device=device,
                  init_params_override=lambda s: params_from_numpy(params, cfg.model,
                                                                   device=device))
    metrics = [r.run_step() for _ in range(steps)]
    return {"metrics": metrics, "params": _np_tree(r.layout.gather(r.state.params))}


# ---------------------------------------------------------------------------
# Ring attention and the context axis
# ---------------------------------------------------------------------------

def ring_case(rank, world, *, cp, q, k, v, positions, mask, weight, emulated=False,
              device="cuda"):
    """``ring_attention`` over a context group of ``cp`` ranks (meshes of
    ``cp`` ranks side by side) on the whole-sequence inputs cut into the
    rank's chunk; the loss sum(out * weight) backward. Returns the output
    and the gradients of q, k, v gathered whole over the group.
    ``emulated``: the shift built from all-reduce, as on CUDA tensors of a
    gloo group."""
    from rlinf_tpu_torch.ops.ring_attention import ring_attention
    from rlinf_tpu_torch.parallel import collectives as C
    from rlinf_tpu_torch.parallel.mesh import AxisNames as Ax, MeshConfig
    from rlinf_tpu_torch.parallel.sharding import context_chunk

    mesh = _my_mesh(MeshConfig(data=1, context=cp), cp, device)
    g = mesh.get_group(Ax.CONTEXT)
    real = C._emulated
    if emulated:
        C._emulated = lambda x, group: True
    try:
        C.reset_counts()
        cut = lambda a: context_chunk(torch.as_tensor(a).to(device), mesh).contiguous()
        qc, kc, vc = (cut(a).requires_grad_(True) for a in (q, k, v))
        out = ring_attention(qc, kc, vc, group=g, positions=cut(positions),
                             kv_valid_mask=cut(mask))
        (out * cut(weight)).sum().backward()
        got = {n: _np(C.gather_tensor(t.detach(), 1, g))
               for n, t in (("out", out), ("dq", qc.grad), ("dk", kc.grad), ("dv", vc.grad))}
        got["counts"] = C.counts()
    finally:
        C._emulated = real
    return got


def ring_shift_case(rank, world, *, emulated=False, device="cuda"):
    """``ring_shift`` over a group of all 4 ranks on x = rank + [0, 1, 2],
    with the loss sum(y * (rank + 1)): y and the gradient of x."""
    from rlinf_tpu_torch.parallel import collectives as C
    from rlinf_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    mesh = make_mesh(MeshConfig(data=1, context=world), device_type=torch.device(device).type)
    real = C._emulated
    if emulated:
        C._emulated = lambda x, group: True
    try:
        x = (rank + torch.arange(3.0)).requires_grad_(True)
        y = C.ring_shift(x, mesh.get_group("context"))
        (y * (rank + 1)).sum().backward()
    finally:
        C._emulated = real
    return {"y": _np(y), "dx": _np(x.grad)}


def ring_forward(rank, world, *, mesh_cfg, cfg, params, ids, mask=None, size=None,
                 device="cuda"):
    """``forward_hidden(attn_impl="ring")`` on whole rows under the mesh,
    the rank's chunk of the hidden states gathered whole."""
    from rlinf_tpu_torch.models.llm import model as M
    from rlinf_tpu_torch.parallel.mesh import use_mesh

    mesh = _my_mesh(mesh_cfg, size or world, device)
    p = M.shard_params_from_numpy(params, cfg, mesh, device=device)
    with use_mesh(mesh), torch.no_grad():
        h, _ = M.forward_hidden(p, cfg, torch.as_tensor(ids).to(device),
                                attention_mask=None if mask is None else
                                torch.as_tensor(mask).to(device), attn_impl="ring")
        whole, _ = M.gather_sequence(h, None, "ring")
    return {"chunk": tuple(h.shape), "hidden": _np(whole)}


def collectives(rank, world, *, device="cuda"):
    """Each collective over the tensor group of a data=1, fsdp=2, tensor=2
    mesh, forward and backward, on x = rank + [0, 1, 2, 3]."""
    from rlinf_tpu_torch.parallel import collectives as C
    from rlinf_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    mesh = make_mesh(MeshConfig(data=1, fsdp=2, tensor=2), device_type=torch.device(device).type)
    g = mesh.get_group("tensor")
    w = torch.arange(1.0, 9.0)
    out = {}

    def grad_of(fn):
        x = (rank + torch.arange(4.0)).requires_grad_(True)
        fn(x).backward()
        return _np(x.grad)

    x = rank + torch.arange(4.0)
    out["gather"] = _np(C.all_gather(x, 0, g))
    out["gather_grad_rs"] = grad_of(lambda x: (w * C.all_gather(x, 0, g)).sum())
    out["gather_grad_split"] = grad_of(lambda x: (w * C.all_gather(x, 0, g, "split")).sum())
    out["reduce_scatter"] = _np(C.reduce_scatter(torch.cat([x, x]), 0, g))
    out["all_reduce"] = _np(C.all_reduce(x, g))
    out["all_reduce_grad"] = grad_of(lambda x: C.all_reduce(x, g).sum())
    out["copy_to_grad"] = grad_of(lambda x: C.copy_to(x, g).sum())
    out["max"] = float(C.all_reduce_(x.max().clone(), "max", g))
    return out


# ---------------------------------------------------------------------------
# The expert axis and the dynamic scheduler
# ---------------------------------------------------------------------------

def dropless_ep_case(rank, world, *, moe, params, x, ragged=True, emulated=False,
                     device="cuda"):
    """``moe_layer_dropless_ep`` over an expert group of every rank (the
    batch rows and the experts cut into the rank's blocks), the loss
    sum(out ** 2) + aux backward: the output and the gradients of x and of
    every expert leaf gathered whole, the router's gradient (whole on every
    rank), the aux loss and the exchange's counts. ``ragged`` pins
    ``FORCE_RAGGED``; ``emulated``: the exchange built from all-reduce, as
    on CUDA tensors of a gloo group."""
    from rlinf_tpu_torch.ops import moe as MO
    from rlinf_tpu_torch.parallel import collectives as C
    from rlinf_tpu_torch.parallel.mesh import AxisNames as Ax, MeshConfig, make_mesh

    mesh = make_mesh(MeshConfig(data=1, expert=world), device_type=torch.device(device).type)
    g = mesh.get_group(Ax.EXPERT)
    me = mesh.axis_index(Ax.EXPERT)

    def block(a, n):
        a = torch.as_tensor(np.asarray(a)).to(device)
        k = a.shape[0] // world
        return a[me * k:(me + 1) * k].clone().requires_grad_(True) if n else a

    p = {"router": block(params["router"], 0).clone().requires_grad_(True),
         **{k: block(params[k], 1) for k in ("gate", "up", "down")}}
    xb = block(x, 1)
    real_c, real_f = C._emulated, MO.FORCE_RAGGED
    if emulated:
        C._emulated = lambda t, group: True
    MO.FORCE_RAGGED = ragged
    try:
        C.reset_counts()
        out, aux = MO.moe_layer_dropless_ep(p, xb, moe, mesh)
        ((out.float() ** 2).sum() + aux).backward()
        counts = C.counts()
    finally:
        C._emulated, MO.FORCE_RAGGED = real_c, real_f
    got = {"out": _np(C.gather_tensor(out.detach(), 0, g)), "aux": float(aux),
           "dx": _np(C.gather_tensor(xb.grad, 0, g)), "d_router": _np(p["router"].grad),
           "counts": counts}
    for k in ("gate", "up", "down"):
        got[f"d_{k}"] = _np(C.gather_tensor(p[k].grad, 0, g))
    return got


def migration_case(rank, world, *, cfg, params, batch, opt_cfg, loss_cfg, device="cuda"):
    """The dynamic scheduler's moves in a world of 4: a train state built on
    a data=2 submesh of ranks {0, 1} (ranks 2 and 3 hold nothing) moves to
    data=2 x tensor=2 over all four ranks through a ``StandbyMigrator``
    prepared for that mesh, which then takes one step; the same step from
    a state built on the 4-rank mesh directly; ``migrate_sharded_state``
    of the params onto ranks {2, 3} and back; ``reshard_delta`` on a leaf
    whose placement does not change and on one that moves."""
    import time

    from rlinf_tpu_torch.models.llm import model as M
    from rlinf_tpu_torch.models.llm.convert import params_from_numpy
    from rlinf_tpu_torch.parallel.dynamic_scheduler import (
        NamedSharding, StandbyMigrator, migrate_sharded_state, reshard_delta, submesh,
    )
    from rlinf_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from rlinf_tpu_torch.parallel.sharding import P
    from rlinf_tpu_torch.training.learner import make_policy_train_step
    from rlinf_tpu_torch.training.sharded_step import model_layout
    from rlinf_tpu_torch.training.train_state import create_train_state, make_optimizer

    dt = torch.device(device).type
    ranks = list(range(world))
    mesh_a = submesh(ranks, 0, 2, device_type=dt)                 # data=2 on {0, 1}
    mesh_b = make_mesh(MeshConfig(data=2, tensor=2), device_type=dt)
    mesh_c = submesh(ranks, 2, 2, device_type=dt)                 # data=2 on {2, 3}
    rules = M.partition_rules()
    tx = make_optimizer(opt_cfg)
    full = lambda: params_from_numpy(params, cfg, device=device)

    def build(mesh):
        return make_policy_train_step(cfg, loss_cfg, tx, remat=False, mesh=mesh, device=device)

    state = (create_train_state(full, tx, mesh=mesh_a, partition_rules=rules)
             if mesh_a.contains() else None)
    lay_a = model_layout(cfg, mesh_a, rules=rules)
    mig = StandbyMigrator(build, rules)
    mig.prepare(mesh_b)
    mig.prepare(mesh_b, block=True)
    ready = mig.ready(mesh_b)
    t0 = time.perf_counter()
    moved, m = mig.migrate(mesh_b, state, batch, old_layout=lay_a)
    seconds = time.perf_counter() - t0
    lay_b = model_layout(cfg, mesh_b, rules=rules)
    direct = create_train_state(full, tx, mesh=mesh_b, partition_rules=rules)
    direct, dm = build(mesh_b)(direct, batch)
    out = {"ready": ready, "seconds": seconds,
           "loss": float(m["actor/loss"]), "grad_norm": float(m["actor/grad_norm"]),
           "direct_loss": float(dm["actor/loss"]), "direct_grad_norm": float(dm["actor/grad_norm"]),
           "params": _np_tree(lay_b.gather(moved.params)),
           "direct_params": _np_tree(lay_b.gather(direct.params)),
           "mu": _np_tree(lay_b.gather(moved.opt_state["mu"])),
           "direct_mu": _np_tree(lay_b.gather(direct.opt_state["mu"]))}

    # the params alone onto ranks {2, 3}, then back onto {0, 1}
    p_c = migrate_sharded_state(moved.params, mesh_c, rules, old_layout=lay_b)
    out["on_c"] = p_c is not None
    lay_c = model_layout(cfg, mesh_c, rules=rules)
    p_a = migrate_sharded_state(p_c, mesh_a, rules, old_layout=lay_c)
    out["back_on_a"] = None if p_a is None else _np_tree(lay_a.gather(p_a))

    # reshard_delta: the same blocks on the same ranks stay the same tensor
    w = moved.params["blocks"]["wq"]
    same = NamedSharding(mesh_b, lay_b.spec_for("blocks/wq"))
    relabel = NamedSharding(make_mesh(MeshConfig(data=2, tensor=2), device_type=dt),
                            lay_b.spec_for("blocks/wq"))
    kept = reshard_delta({"wq": w}, {"wq": relabel}, {"wq": same})["wq"]
    out["kept_same_tensor"] = kept is w
    whole = reshard_delta({"wq": w}, {"wq": NamedSharding(mesh_c, P())}, {"wq": same})["wq"]
    out["moved_to_c"] = None if whole is None else _np(whole)
    return out
