"""GRPO/PPO reasoning RL loop.

Port of ``rlinf_tpu/runners/reasoning_runner.py``. Each global step calls
the phases in sequence:

  1. rollout:   engine.rollout(params, prompts)          [decode-shaped phase]
  2. reward:    host-side rule verification              [CPU]
  3. training:  the optional logprob recompute, then train_step(state, batch)
                x minibatches                             [train-shaped phase]

Weight sync is free: the train step updates the params in place and the next
rollout reads them. PPO with a learned critic (``algorithm.adv_type="gae"``)
runs with a value head on the actor's trunk (``algorithm.critic="shared"``)
or with a critic of its own (``"separate"``: its own trunk, optimizer,
``critic_lr``, checkpoint directory ``checkpoint_dir + "_critic"`` and
``critic_warmup_steps`` critic-only steps). As in the JAX package, a
token-budget microbatch run (``loss.max_tokens_per_mb > 0``) takes the
policy-only update and never steps the critic. With ``lora.enabled`` the
train state holds the adapters alone (``models/llm/lora.py``), the base
params stay frozen, and the rollout, the recompute and the checkpoints
read ``_policy_params()``, the adapters merged into the base (the engine
re-quantizes the merged weights at each rollout); ``lora.path`` restores
an adapter checkpoint, and the checkpoints hold the adapter state only.
LoRA refuses a critic (the config's validator) and the token budget, as
the JAX runner does.

Under ``mesh=`` (a ``parallel.mesh.Mesh``; every rank of the world runs
the same script with the same seeds) the train state holds this rank's
blocks under ``partition_rules()``, the rollout splits the prompts over the
batch axes and returns the global result on every rank, every rank scores
and assembles the whole batch, and each train step keeps its rows and
reduces across the mesh. The checkpoints hold the single-card layout
(gathered on save, cut on restore), and ``rescale(new_mesh)`` re-shards the
live state. With LoRA the base params are this rank's blocks and the
adapters are whole on every rank (the JAX package's layout); the merge
runs per rank on its blocks. The token-budget microbatches are packed from
the whole minibatch on every rank, and each rank trains on its rows of
each. Under ``attn_impl="ring"`` on a context axis > 1 the forward, the
recompute and the loss run on each rank's chunk of the sequence; the
rollout's prefill too, after which each layer's K/V is gathered over the
context group and every context rank decodes the same tokens.

Randomness: two seeded ``torch.Generator``s on the host, one for the
rollout's per-call sampling seeds (the engines draw their device noise from
a seed taken from it) and one for the minibatch permutations. They are not
JAX's threefry, so the samples and permutations differ from the JAX
package's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from rlinf_tpu_torch.algorithms import get_advantage_fn
from rlinf_tpu_torch.algorithms.rewards.math_verifier import batch_math_rewards
from rlinf_tpu_torch.config import TrainerConfig, resolve_attn_impl
from rlinf_tpu_torch.data.datasets import PromptDataset, StatefulBatchIterator
from rlinf_tpu_torch.data.io_struct import RolloutRequest, RolloutResult, build_train_batch
from rlinf_tpu_torch.models.llm import init_params, model as M
from rlinf_tpu_torch.rollout import build_rollout_engine, resolve_recompute_logprobs
from rlinf_tpu_torch.training.learner import (
    make_actor_critic_train_step,
    make_logprob_fn,
    make_policy_grad_and_apply,
    make_policy_train_step,
)
from rlinf_tpu_torch.training.train_state import create_train_state, make_optimizer, tree_map
from rlinf_tpu_torch.utils import flops as F
from rlinf_tpu_torch.utils.checkpoint import CheckpointManager
from rlinf_tpu_torch.utils.device import resolve_device
from rlinf_tpu_torch.utils.metrics import MetricLogger, rollout_metrics
from rlinf_tpu_torch.utils.sync import host_sync
from rlinf_tpu_torch.utils.timers import Timers


#: why ``rescale`` refuses LoRA: the JAX runner's ``rescale``
#: (rlinf_tpu/runners/reasoning_runner.py:259-286) replaces the LoRA step
#: (:151) by a full-parameter ``make_policy_train_step`` over the adapter
#: tree, whose next call fails (tests/test_torch_mesh_configs.py
#: test_jax_rescale_with_lora_or_a_separate_critic; ROADMAP.md §C.4)
RESCALE_REFUSED = (
    "rescale with LoRA: the JAX runner's rescale (rlinf_tpu/runners/reasoning_runner.py:"
    "259-286) re-shards the adapter tree under the model's rules, leaves base_params on the "
    "old mesh and replaces the LoRA step (:151) by a full-parameter make_policy_train_step "
    "over the adapters, whose next call fails (KeyError 'embed'); ROADMAP.md §C.4")


class ReasoningRunner:
    def __init__(
        self,
        cfg: TrainerConfig,
        tokenizer,
        dataset: PromptDataset,
        *,
        init_params_override=None,
        mesh=None,
        reward_fn=None,
        device="cuda",
    ):
        """``init_params_override(seed)`` returns the initial params (the
        port's dict of tensors on ``device``) in place of a random init;
        ``reward_fn(texts, answers)`` scores the decoded responses (default:
        the math verifier)."""
        if cfg.lora.enabled and cfg.loss.max_tokens_per_mb > 0:
            raise NotImplementedError(
                "lora.enabled with dynamic token-budget microbatching "
                "(loss.max_tokens_per_mb > 0) is not supported, as in the JAX runner")
        dev = resolve_device(device)
        cfg = dataclasses.replace(cfg, attn_impl=resolve_attn_impl(cfg, dev))
        self.cfg = cfg
        self.device = dev
        self.mesh = mesh
        M.check_mesh(cfg.model, mesh)
        self.tokenizer = tokenizer
        self.reward_fn = reward_fn or batch_math_rewards
        self.timers = Timers()
        # under a mesh every rank holds the same metrics: the first writes
        # and prints them
        writes = mesh is None or (dist.get_rank() if dist.is_initialized() else 0) == mesh.ranks[0]
        self.logger = (MetricLogger(cfg.runner.log_dir) if writes
                       else MetricLogger(None, print_every=0))

        # continuous slot-pool batching unless cfg.rollout names another
        # (the static engine under a mesh)
        self.engine = build_rollout_engine(cfg, mesh=mesh, device=dev)
        self.tx = make_optimizer(cfg.optimizer)
        self.with_critic = cfg.algorithm.adv_type == "gae"
        self.separate_critic = self.with_critic and cfg.algorithm.critic == "separate"
        self.critic_state = None
        seed = cfg.runner.seed
        if self.with_critic and not self.separate_critic:
            # a value head on the shared trunk
            from rlinf_tpu_torch.training.critic import make_critic_value_fn

            self.train_step = make_actor_critic_train_step(
                cfg.model, cfg.loss, self.tx,
                remat=cfg.remat, attn_impl=cfg.attn_impl, mesh=mesh, device=dev,
            )
            self._value_fn = make_critic_value_fn(
                cfg.model, attn_impl=cfg.attn_impl, mesh=mesh, device=dev)
        elif cfg.lora.enabled:
            # train only the adapters; the frozen base params are an argument
            from rlinf_tpu_torch.training.lora_learner import make_lora_policy_train_step

            lora_step = make_lora_policy_train_step(
                cfg.model, cfg.loss, self.tx, cfg.lora,
                num_microbatches=cfg.num_microbatches,
                remat=cfg.remat, attn_impl=cfg.attn_impl, mesh=mesh, device=dev,
            )
            self.train_step = lambda state, batch: lora_step(state, self.base_params, batch)
        else:
            self.train_step = make_policy_train_step(
                cfg.model, cfg.loss, self.tx,
                num_microbatches=cfg.num_microbatches,
                remat=cfg.remat, attn_impl=cfg.attn_impl, mesh=mesh, device=dev,
            )
        if self.separate_critic:
            # the critic is its own model + optimizer + warmup schedule; the
            # actor trains with the plain policy step and GAE reads the
            # critic's values
            from rlinf_tpu_torch.training.critic import (
                CriticConfig, init_critic_params, make_critic_train_step,
                make_critic_value_fn,
            )

            self.critic_cfg = CriticConfig(
                warmup_steps=cfg.algorithm.critic_warmup_steps,
                lr=cfg.algorithm.critic_lr,
            )
            opt = cfg.optimizer
            if self.critic_cfg.lr is not None:
                opt = dataclasses.replace(opt, lr=self.critic_cfg.lr)
            self.critic_tx = make_optimizer(opt)
            self.critic_step = make_critic_train_step(
                cfg.model, self.critic_cfg, self.critic_tx,
                remat=cfg.remat, attn_impl=cfg.attn_impl, mesh=mesh, device=dev,
            )
            self.critic_state = create_train_state(
                lambda: init_critic_params(cfg.model, seed + 104729, device=dev),
                self.critic_tx, mesh=mesh, partition_rules=self._rules(True),
            )
            raw_value_fn = make_critic_value_fn(cfg.model, attn_impl=cfg.attn_impl,
                                                mesh=mesh, device=dev)
            self._value_fn = lambda _actor_params, ids, mask: raw_value_fn(
                self.critic_state.params, ids, mask)
        if cfg.loss.max_tokens_per_mb > 0:
            self._grad_step, self._apply_step, self._zero_grads = (
                make_policy_grad_and_apply(
                    cfg.model, cfg.loss, self.tx,
                    remat=cfg.remat, attn_impl=cfg.attn_impl, mesh=mesh, device=dev,
                )
            )
        # Logprob-consistency invariant: the recompute is on whenever the
        # rollout decode path differs from the training path (int8 weights,
        # the decode kernels), so PPO ratios are anchored to the training-path
        # policy: step-1 approx_kl ~ 0 by construction.
        self.recompute_logprobs = resolve_recompute_logprobs(cfg, device=dev)
        self.logprob_fn = (
            make_logprob_fn(
                cfg.model,
                chunk_size=cfg.loss.logprob_chunk_size,
                attn_impl=cfg.attn_impl,
                temperature=cfg.sampling.temperature,
                mesh=mesh,
                device=dev,
            )
            if self.recompute_logprobs
            else None
        )

        base_init = init_params_override or (
            lambda s: init_params(cfg.model, s, device=dev)
        )
        if self.with_critic and not self.separate_critic:
            from rlinf_tpu_torch.models.llm.value_head import add_value_head

            init_fn = lambda s: add_value_head(base_init(s), cfg.model, s + 7, device=dev)
        else:
            # a separate critic owns its trunk: the actor carries no value head
            init_fn = base_init
        self._sample_gen = torch.Generator().manual_seed(seed)
        self._perm_gen = torch.Generator().manual_seed(seed + 1)
        if cfg.lora.enabled:
            from rlinf_tpu_torch.models.llm.lora import init_lora_params, merge_lora

            self.base_params = init_fn(seed)
            lay = self._layout(False)
            if lay is not None:
                self.base_params = lay.shard(self.base_params)
            self.state = create_train_state(
                lambda: init_lora_params(cfg.model, cfg.lora,
                                         torch.Generator().manual_seed(seed + 11), device=dev),
                self.tx,
            )
            if cfg.lora.path:
                state, _, _ = CheckpointManager(cfg.lora.path).restore(self.state)
                if state is not None:
                    self.state = state
            self._merge = torch.no_grad()(
                lambda base, lora: merge_lora(base, lora, cfg.lora, self._layout(False)))
        else:
            self.base_params = None
            self.state = create_train_state(
                lambda: init_fn(seed), self.tx, mesh=mesh,
                partition_rules=self._rules(self.with_critic and not self.separate_critic))

        self.iterator = StatefulBatchIterator(
            dataset, cfg.runner.rollout_batch_size, seed=seed
        )
        self.ckpt = (
            CheckpointManager(cfg.runner.checkpoint_dir, layout=self._layout(
                self.with_critic and not self.separate_critic))
            if cfg.runner.checkpoint_dir
            else None
        )
        self.critic_ckpt = (
            CheckpointManager(cfg.runner.checkpoint_dir + "_critic",
                              layout=self._layout(True))
            if cfg.runner.checkpoint_dir and self.separate_critic
            else None
        )
        self.global_step = 0
        if self.ckpt and cfg.runner.resume == "auto":
            state, extra, step = self.ckpt.restore(self.state)
            if state is not None:
                self.state = state
                self.global_step = step
                if extra and "dataloader" in extra:
                    self.iterator.load_state_dict(extra["dataloader"])
                if self.critic_ckpt is not None:
                    cstate, _, _ = self.critic_ckpt.restore(self.critic_state, step=step)
                    if cstate is not None:
                        self.critic_state = cstate

    # ------------------------------------------------------------------
    def _rules(self, value_head: bool):
        """The partition rules of the actor's (or a critic's) params."""
        from rlinf_tpu_torch.models.llm.value_head import value_partition_rules

        return (value_partition_rules() if value_head else []) + M.partition_rules()

    def _layout(self, value_head: bool):
        """The sharding layout of the actor's (or a critic's) state on the
        runner's mesh (None without one): what the checkpoints read."""
        from rlinf_tpu_torch.training.sharded_step import model_layout

        if self.mesh is None:
            return None
        return model_layout(self.cfg.model, self.mesh, self._rules(value_head), value_head)

    def rescale(self, new_mesh):
        """Online parallel-strategy switch: re-shard the live train state
        onto ``new_mesh`` (every rank gathers each leaf whole and keeps its
        new block) and rebuild the mesh-bound step functions. Training
        resumes on the next step. A separate critic stays on the old mesh
        with its steps, as the JAX runner's rescale leaves it (it re-shards
        the actor alone); LoRA is refused (``RESCALE_REFUSED``)."""
        from rlinf_tpu_torch.training.train_state import rescale_train_state

        if self.base_params is not None:
            raise NotImplementedError(RESCALE_REFUSED)
        shared = self.with_critic and not self.separate_critic
        M.check_mesh(self.cfg.model, new_mesh)
        self.state = rescale_train_state(self.state, new_mesh, self._rules(shared),
                                         old_layout=self._layout(shared))
        self.mesh = new_mesh
        cfg, dev = self.cfg, self.device
        if shared:
            from rlinf_tpu_torch.training.critic import make_critic_value_fn

            self.train_step = make_actor_critic_train_step(
                cfg.model, cfg.loss, self.tx, remat=cfg.remat, attn_impl=cfg.attn_impl,
                mesh=new_mesh, device=dev)
            self._value_fn = make_critic_value_fn(
                cfg.model, attn_impl=cfg.attn_impl, mesh=new_mesh, device=dev)
        else:
            self.train_step = make_policy_train_step(
                cfg.model, cfg.loss, self.tx, num_microbatches=cfg.num_microbatches,
                remat=cfg.remat, attn_impl=cfg.attn_impl, mesh=new_mesh, device=dev)
        if cfg.loss.max_tokens_per_mb > 0:
            self._grad_step, self._apply_step, self._zero_grads = make_policy_grad_and_apply(
                cfg.model, cfg.loss, self.tx, remat=cfg.remat, attn_impl=cfg.attn_impl,
                mesh=new_mesh, device=dev)
        if self.logprob_fn is not None:
            self.logprob_fn = make_logprob_fn(
                cfg.model, chunk_size=cfg.loss.logprob_chunk_size, attn_impl=cfg.attn_impl,
                temperature=cfg.sampling.temperature, mesh=new_mesh, device=dev)
        if self.ckpt is not None:
            self.ckpt.layout = self._layout(shared)

    def _permutation(self, n: int) -> np.ndarray:
        return torch.randperm(n, generator=self._perm_gen).numpy()

    def _make_request(self, examples) -> RolloutRequest:
        max_p = self.cfg.data.max_prompt_len
        prompt_ids = [
            self.tokenizer.encode(ex.prompt)[:max_p] for ex in examples
        ]
        answers = [ex.answer for ex in examples]
        return RolloutRequest(prompt_ids=prompt_ids, answers=answers).repeat(
            self.cfg.algorithm.group_size
        )

    def _compute_advantages(self, result: RolloutResult, rewards: np.ndarray):
        a = self.cfg.algorithm
        adv_fn = get_advantage_fn(a.adv_type)
        adv, _ = adv_fn(
            rewards=torch.as_tensor(rewards),
            loss_mask=torch.as_tensor(result.response_mask.T),  # [N, B]
            group_size=a.group_size,
            normalize_advantages=a.normalize_advantages,
        )
        return adv.numpy().T  # [B, N]

    def _put_batch(self, arrays):
        """Host batch -> the runner's device."""
        return {k: torch.as_tensor(v).to(self.device) for k, v in arrays.items()}

    def _gae_token_advantages(self, train_batch, rewards):
        """Token-level GAE with a critic: the sequence reward lands on the
        last response token, and the bootstrap is cut there (done); fp32
        values of the critic (the shared head or the separate critic)."""
        a = self.cfg.algorithm
        ids = torch.as_tensor(train_batch.input_ids).to(self.device)
        amask = torch.as_tensor(train_batch.attention_mask).to(self.device)
        values_bt = self._value_fn(self.state.params, ids, amask).float().cpu().numpy()  # [B, T]
        lm = train_batch.loss_mask  # [B, T] bool
        B, T = lm.shape
        values_bt = values_bt * lm  # values outside the response don't matter

        # last valid loss position per row
        last_pos = T - 1 - np.argmax(lm[:, ::-1], axis=1)  # [B]
        has_any = lm.any(axis=1)
        rewards_tb = np.zeros((T, B), np.float32)
        rewards_tb[last_pos[has_any], np.nonzero(has_any)[0]] = rewards[has_any]
        dones_tb = np.zeros((T + 1, B), np.float32)
        dones_tb[last_pos[has_any] + 1, np.nonzero(has_any)[0]] = 1.0
        values_tb = np.concatenate([values_bt.T, np.zeros((1, B), np.float32)], axis=0)

        gae = get_advantage_fn("gae")
        adv, ret = gae(
            rewards=torch.as_tensor(rewards_tb),
            values=torch.as_tensor(values_tb),
            dones=torch.as_tensor(dones_tb),
            gamma=a.gamma,
            gae_lambda=a.gae_lambda,
            normalize_advantages=a.normalize_advantages,
            loss_mask=torch.as_tensor(lm.T),
        )
        adv = adv.numpy().T * lm
        ret = ret.numpy().T * lm
        return {
            "advantages": adv.astype(np.float32),
            "returns": ret.astype(np.float32),
            "prev_values": values_bt.astype(np.float32),
        }

    def _dynamic_minibatch_update(self, batch_dict, train_batch, mb_idx):
        """Token-budget microbatching: pack the minibatch's rows under
        max_tokens_per_mb, accumulate grads over the packed microbatches,
        one optimizer step. The batch goes to the host and each
        microbatch's loss comes back to it, as in the JAX package."""
        from rlinf_tpu_torch.data.dynamic_batching import pack_microbatches

        np_batch = {k: v.cpu().numpy()[mb_idx] for k, v in batch_dict.items()}
        lengths = np_batch["attention_mask"].sum(-1).astype(int)
        mbs = pack_microbatches(
            np_batch, lengths, self.cfg.loss.max_tokens_per_mb
        )
        global_valid = torch.tensor(
            max(float(np_batch["loss_mask"].sum()), 1.0), dtype=torch.float32
        )
        grads = self._zero_grads(self.state.params)
        total_loss, metrics = 0.0, {}
        for mb in mbs:
            grads, loss, metrics = self._grad_step(
                self.state.params, grads, mb, global_valid
            )
            total_loss += float(loss)
        self.state, grad_norm = self._apply_step(self.state, grads)
        metrics = dict(metrics)
        metrics["actor/loss"] = total_loss
        if self.mesh is not None:
            # this rank's shares: the loss summed, the last microbatch's
            # metrics over the ranks, as the train step reduces them
            metrics = {k: float(v) for k, v in self._grad_step.reduce_metrics(
                metrics, mbs[-1]).items()}
        metrics["actor/grad_norm"] = grad_norm
        metrics["actor/num_dyn_microbatches"] = float(len(mbs))
        return metrics

    def _policy_params(self):
        """The params the rollout and the recompute read: the adapters merged
        into the base under LoRA (new tensors for the targets, the base's
        own for the rest), the train state's otherwise."""
        if self.base_params is not None:
            return self._merge(self.base_params, self.state.params)
        return self.state.params

    def _augment_batch(self, batch_dict, result):
        """Hook for subclasses to add loss inputs (e.g. version stamps in
        disaggregated/async mode) before the recompute + train phases."""

    def run_step(self) -> Dict[str, float]:
        with self.timers.scope("rollout"):
            result = self._rollout_phase(self._policy_params())
        return self._train_on_result(result)

    def _train_on_result(self, result) -> Dict[str, float]:
        cfg = self.cfg
        step_start = time.perf_counter()

        # 2. rewards --------------------------------------------------------
        with self.timers.scope("reward"):
            texts = result.response_texts(self.tokenizer)
            rewards = np.asarray(
                self.reward_fn(texts, result.answers), np.float32
            )
            result.rewards = rewards

        # 3. advantages + batch assembly ------------------------------------
        if self.with_critic:
            train_batch = build_train_batch(
                result, np.zeros_like(result.response_logprobs),
                pad_id=cfg.sampling.pad_token_id,
            )
            extra = self._gae_token_advantages(train_batch, rewards)
            train_batch.advantages = extra["advantages"]
            batch_dict = self._put_batch(train_batch.to_dict())
            batch_dict.update(self._put_batch(
                {"returns": extra["returns"], "prev_values": extra["prev_values"]}))
        else:
            token_advantages = self._compute_advantages(result, rewards)
            train_batch = build_train_batch(
                result, token_advantages, pad_id=cfg.sampling.pad_token_id
            )
            batch_dict = self._put_batch(train_batch.to_dict())

        self._augment_batch(batch_dict, result)

        # 3b. optional logprob recompute on the training path
        if self.logprob_fn is not None:
            lp, _ = self.logprob_fn(self._policy_params(), batch_dict)
            lp = torch.where(batch_dict["loss_mask"], lp, 0.0)
            if cfg.loss.loss_type == "decoupled":
                # decoupled PPO: behaviour logprobs (from the rollout engine)
                # stay in old_logprobs; the recompute is the PROXIMAL anchor
                batch_dict["proximal_logprobs"] = lp
            else:
                batch_dict["old_logprobs"] = lp

        # 4. training -------------------------------------------------------
        B = train_batch.input_ids.shape[0]
        n_mini = cfg.runner.num_mini_batches
        metrics = {}
        with self.timers.scope("training"):
            perm = np.arange(B)
            for epoch in range(cfg.runner.num_epochs):
                if cfg.runner.num_epochs > 1 or n_mini > 1:
                    perm = self._permutation(B)
                for mb_idx in np.split(perm, n_mini):
                    if cfg.loss.max_tokens_per_mb > 0:
                        metrics = self._dynamic_minibatch_update(
                            batch_dict, train_batch, mb_idx
                        )
                    elif self.separate_critic:
                        idx = torch.as_tensor(mb_idx, device=self.device)
                        mb = {k: v[idx] for k, v in batch_dict.items()}
                        self.critic_state, cmetrics = self.critic_step(self.critic_state, mb)
                        if self.global_step >= cfg.algorithm.critic_warmup_steps:
                            self.state, metrics = self.train_step(self.state, mb)
                        else:
                            # critic warmup: no actor update yet
                            metrics = {"actor/warmup_skipped": torch.tensor(1.0)}
                        metrics = {**metrics, **cmetrics}
                    else:
                        idx = torch.as_tensor(mb_idx, device=self.device)
                        mb = {k: v[idx] for k, v in batch_dict.items()}
                        self.state, metrics = self.train_step(self.state, mb)
            host_sync(metrics)

        # 5. metrics / checkpoint ------------------------------------------
        self.global_step += 1
        out = {k: float(v) for k, v in metrics.items()}
        out.update(
            rollout_metrics(
                result.response_lengths, rewards, cfg.sampling.max_new_tokens,
                prompt_lengths=result.prompt_lengths,
                advantages=train_batch.advantages,
                loss_mask=train_batch.loss_mask,
            )
        )
        times = self.timers.consume()
        out.update({f"time/{k}": v for k, v in times.items()})
        out["time/step"] = time.perf_counter() - step_start

        gen_tokens = float(result.response_lengths.sum())
        train_tokens = float(train_batch.attention_mask.sum()) * cfg.runner.num_epochs
        if times.get("rollout"):
            out["perf/gen_tokens_per_s"] = gen_tokens / times["rollout"]
        if times.get("training"):
            out["perf/train_tokens_per_s"] = train_tokens / times["training"]
            tr_flops = 3.0 * F.model_matmul_flops_per_token(cfg.model) * train_tokens
            out["perf/train_tflops_per_s"] = tr_flops / times["training"] / 1e12
        out["perf/e2e_tokens_per_s"] = (gen_tokens + train_tokens) / out["time/step"]
        self.logger.log(out, self.global_step)

        if (
            self.ckpt
            and self.global_step % cfg.runner.save_interval == 0
        ):
            self.save_checkpoint()
        return out

    def save_checkpoint(self):
        """The state and the dataloader position, at ``global_step``; a
        separate critic's state beside them."""
        self.ckpt.save(
            self.global_step,
            self.state,
            extra={"dataloader": self.iterator.state_dict()},
        )
        if self.critic_ckpt is not None:
            self.critic_ckpt.save(self.global_step, self.critic_state)

    def _rollout_phase(self, params):
        examples = self.iterator.next_batch()
        request = self._make_request(examples)
        return self.engine.rollout(params, request, self._sample_gen, mesh=self.mesh)

    def _timed_rollout(self, params):
        t0 = time.perf_counter()
        result = self._rollout_phase(params)
        return result, time.perf_counter() - t0

    def run_pipelined(self, max_steps: Optional[int] = None) -> List[Dict[str, float]]:
        """Overlap the rollout of batch N+1 (in a worker thread) with the
        training on batch N. Behaviour logprobs recorded at generation time
        keep the PPO ratios correct under the one-step staleness.

        The train step updates the params in place, so each rollout reads a
        clone taken before the next update. The worker's rollout seconds are
        recorded as ``time/rollout`` of the step that trains on it. The
        kernels are built before the worker starts; on one device both
        threads queue their work on the same stream.

        Under a mesh the two phases run in turn, with the same one-step
        staleness (batch N+1 from the params before the update on N):
        collectives from two threads would meet in another order on each
        rank."""
        import concurrent.futures

        if self.device.type == "cuda":
            from rlinf_tpu_torch.ops.cuda import build

            build()
        n = max_steps or self.cfg.runner.max_steps
        history: List[Dict[str, float]] = []
        snapshot = lambda: tree_map(lambda t: t.clone(), self._policy_params())
        if self.mesh is not None:
            pending = self._timed_rollout(snapshot())
            while self.global_step < n:
                (result, rollout_s), snap = pending, None
                if self.global_step + 1 < n:
                    snap = snapshot()
                self.timers.record("rollout", rollout_s)
                history.append(self._train_on_result(result))
                if snap is not None:
                    pending = self._timed_rollout(snap)
            return history
        pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        try:
            future = pool.submit(self._timed_rollout, snapshot())
            while self.global_step < n:
                result, rollout_s = future.result()
                if self.global_step + 1 < n:
                    future = pool.submit(self._timed_rollout, snapshot())
                self.timers.record("rollout", rollout_s)
                history.append(self._train_on_result(result))
        finally:
            pool.shutdown(wait=True)
        return history

    def run(self, max_steps: Optional[int] = None) -> List[Dict[str, float]]:
        n = max_steps or self.cfg.runner.max_steps
        history = []
        while self.global_step < n:
            history.append(self.run_step())
        return history
