#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rlinf_tpu_torch``) on one GPU:
the rollout serving paths (static, megakernel, continuous and paged
engines), the GRPO training path, the runners and server mode, HF
checkpoints, the MoE model family, the agent recipes and the
AgentLightning runner, the mesh drill, the VLM reasoning stack and the
embodied PPO stack.

    python3 chip_smoke.py [--seed 0]

Phases, each printing one JSON line:

1. build: compile every kernel of ``rlinf_tpu_torch/csrc`` with nvcc
   (sm_90a), all sources at once, and report the seconds; then ptxas's
   registers and spills and the SASS tensor-core counts of K1, K2, K3, K5,
   K9 and K10, held to their designs (no spill; K5 and K9 on wgmma, K2 and
   K3 on mma.sync).
2. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the shapes of the main path (Qwen2-1.5B, 64 prompts of up
   to 512 tokens, 256 new tokens): error against a stated tolerance, the
   kernel's, the plain version's and one library call's time (CUDA events;
   K2's, K3's and their library call's also from a CUDA-graph replay, their
   ``ms``), and the least time the card could take (bytes or operations at
   the card's published peak). K2 and K3 also at ragged intervals (empty
   rows, rows over split boundaries, Hd=64 with G=7, G=8 at an odd cache
   length; K2 also G=16, its largest, at both head dims). K4
   runs on the head packed once, at B=64 and at B=8, sampled and greedy
   (the difference is what the draws cost).
3. main path: ``build_rollout_engine`` (static engine, int8 weights,
   hand-written kernels, bf16 packed KV cache) rolls out 64 prompts of
   128-512 tokens to 256 new tokens at the full width and depth of
   Qwen2-1.5B with random weights from --seed; then ``generate`` with the
   int8 KV cache on the same prompts. Launch counts are zeroed before and
   read after each run and must show every kernel of that run.
4. greedy check: a 16-token greedy run at Qwen2-1.5B for each KV-cache
   type in which every kernel call is checked against its plain version
   on the same inputs (token agreement > 0.95, logprob error < 0.15,
   attention error < 2e-2); whole-run agreement with the plain path is
   reported. Then whole 16-token greedy runs, kernels against plain, at
   the small configuration of the JAX package's check_q8_generate, with
   its bar (agreement > 0.95, logprob error < 0.15). Then a profile of a
   few decode steps.

5. training kernels: K5/K6 (fused linear cross-entropy) at one row chunk
   of the training path (4096 rows, tied [V, D] embedding and the untied
   [D, V] weight, non-zero entropy gradient; K6's two passes read apart
   from a profiler trace; K5 also at a ragged shape: 100 rows, D=100,
   V=1001, T=1.3) and K7/K8 (flash-attention backward) at one microbatch
   of the training batch (16 right-padded rows, T=768; K7 forms delta
   itself), each against its plain version
   with a stated tolerance and timed beside its bound, its plain version
   and a library call; the whole flash_attention_bwd call beside the
   library call; K7/K8 also at ragged shapes (T=700 left-padded at Hd=64,
   Sq=100, a row with no valid key). Then K4 and K6 against their plain
   versions at ragged shapes (K6 also at n=100, D=100, V=1001), and
   causal_attention forward + backward through the kernels and the plain
   path at T = 512-2048 (12,288 tokens each).
6. training path: GRPO on phase 3's rollout (64 rows as 8 groups of 8,
   a stated reward rule on the token ids), ``build_train_batch`` (T=768),
   ``make_logprob_fn`` (recompute), then four ``make_policy_train_step``
   calls at full width and depth (remat, attn_impl="pallas", 4
   microbatches, adamw with master weights, entropy bonus 1e-3): the step
   time is the median of steps 2-4, and each step's seconds stand beside
   the allocator's device allocations and the garbage collector's pauses
   in it. Gates: K1 and K5 launched by the recompute, every training
   kernel launched by the steps, finite loss and grad norm, step-1
   |approx_kl| < 1e-3, params moved. One more step runs under the
   profiler: device time by kernel, with K5's, K6's passes' and K7's and
   K8's time a step read from the whole trace.
7. whole-step check: one train step at check_q8_generate's configuration,
   kernels against the plain path from the same params.

Between phases 4 and 5, the megakernel, continuous and paged paths:

8. engine kernels: K10 (paged attention; 64 rows, 48 pages of 16 tokens a
   row, ragged lengths with a 0) and K9 (the whole-step decode megakernel
   on Qwen2-1.5B packed weights and a random int8 cache: a small shape
   first, then B=64, S=768 with one write slot and with per-row slots, B=8
   and B=96; then at Qwen2-7B's widths, 2 layers, B=64, S=768), each
   against its plain version with stated limits, timed beside its bound,
   K9 also by phase; K10 beside scaled_dot_product_attention, K9 beside the
   device-busy time of one per-layer int8-KV decode step.
9. megakernel generate: ``generate(kv_quant="int8", mega=...)`` on phase
   3's prompts, with the lm head packed once; launch gate K9 = 255, K3 = 0,
   K1 = 28, K4 = 256; the idle share of a decode step.
10. engine shadow: a 16-token greedy ``generate(mega=)`` and a 16-token
   paged-engine run at full size with every K9 / K10 call checked against
   its plain version on the same inputs; then a 16-token greedy
   ``generate(kv_quant="int8", mega=)`` at Qwen2-7B's widths (2 layers)
   with every K9 call checked the same way.
11. engines: at 7 of the main path's 28 layers (``ENGINES_CUT``), on one
   long-tail mix (128 requests, prompts of 128-512 tokens, budgets of
   32-256 tokens, no eos) the continuous engine through
   ``build_rollout_engine(engine="auto")`` with the per-layer kernels, the
   continuous engine with ``use_mega="auto"`` and the fused sampler (both
   cache layouts must be seen, K9 launched with per-row write slots), and
   the paged engine (K10 = layers x decode steps, page pool empty at the
   end). Every request must be answered with exactly its budget.
12. engine small checks: whole greedy runs at the configurations of the
   JAX package's on-chip gates (check_megakernel_generate,
   check_mega_engine, check_paged_kernel, paged against dense engine),
   kernels against plain paths from the same params, with their bars.

Last, the reasoning runner:

13. runner: three GRPO steps through ``rlinf_tpu_torch.main_grpo.main``
   on examples/reasoning/config/grpo_math_qwen05b.yaml at full width and
   ``RUNNER_CUT``'s depth (Qwen2.5-0.5B: Hd=64, G=7; random weights from --seed, the byte
   tokenizer, main_grpo's 512 synthetic additions, the math verifier; the
   continuous engine with int8 weights and a bf16 cache, the recompute,
   token-budget microbatches of 16,384, 4 minibatches, adamw), the
   traffic cut as ``RUNNER_REDUCED`` lists (64 rows, 256 new tokens).
   Each step's metrics, the peak memory and which partitioner ran. Gates:
   K1, K2 and K5-K8 launched in the run and no other kernel; step 1's
   drift between the engine's behaviour logprobs and the recompute, with
   the kernels and with their plain versions (``DRIFT_BAR``); a second
   runner resumes from the run's checkpoint with its state bitwise equal
   and the next batch the same, then takes step 4; a shadow step (one
   ``_train_on_result`` from one state on step 1's rollout with rule
   rewards, kernels against plain versions, ``SHADOW_BARS``); a two-step
   ``run_pipelined`` beside ``run``'s step time. Then K1, K2 and K5-K8
   against their plain versions at the runner's shapes.

Then server mode and agentic rollout:

14. server: ``GenerationServer`` over the continuous engine with int8
   weights and cache, ``use_mega=True`` and the fused sampler, at
   Qwen2-1.5B's full width and depth on the main path's weights: phase 11's
   long-tail mix through the engine directly, then through the server from
   128 client threads, 16 of them over loopback HTTP (``RouterServer`` ->
   ``OpenAIHTTPServer``, completions and chat), ``update_params`` swapping
   in a perturbed copy once half are answered. Gates: every request
   answered with exactly its budget; K1, K4 and K9 launched and no other
   kernel; two ``prepare_params`` calls. Reported: tokens/s served beside
   the engine's, p50/p95 latency, the swap's ``prepare_params`` ms. Then a
   greedy server on 64 prompts of 640 tokens: every K9, K4 and K1 call
   against its plain version (phase 10's and phase 4's bars); after a swap
   the served tokens pass phase 4's bars against ``generate(mega=)`` on the
   new params and fail them on the old. Then ``serve_openai``'s own server
   (``--preset qwen2_1_5b``: bf16, 32 slots, K2 alone) answers 8 HTTP
   requests and ``APIRewardClient`` scores 8 payloads against it.
15. coding_online: ``CodingOnlineRunner`` on grpo_math_qwen05b.yaml with
   the decoupled loss at full width, 4 of the 24 layers (``CODING_CUT``),
   the runner phase's traffic (``CODING_REDUCED``), 64 coding tasks with I/O tests, 3 overlapped
   online steps; rewards from the code-execution verifier plus
   ``text_rule``. Gates: the verifier scored every response; param version
   4, lag <= 2; finite metrics; params moved; K1, K2 and K5-K8 launched and
   no other kernel.
16. agent: ``AgentRunner`` at Qwen2.5-0.5B's widths, 4 of its 24 layers
   (``AGENT_CUT``, ``AGENT_REDUCED``): ``CalculatorTool``, a scripted call in each
   conversation's first turn, 2 turns, 64 conversations, 2 steps,
   ``agent_rule`` rewards. Gates: every conversation has its two turns,
   the observation tokens masked off with logprob 0; params moved; K1, K2
   and K5-K8 launched and no other kernel. Then ``evaluate_reasoning``
   greedy on the trained params over 64 synthetic additions: 64 records,
   K1 and K2 launched and no other kernel.

Then the head dims and dtypes the kernels take beside bf16 at 64 and 128,
the small models' default runs, and PPO with a learned critic:

17. dtypes_and_head_dims: every attention kernel (K1, K7, K8, K2, K3, K10)
   at Hd 16 and 32 in bf16, f16 and f32 and at Hd 64 and 128 in f16 and
   f32, K4-K6 in f16 and f32, K9 at Hd 16 and 32, each against its plain
   version with its dtype's bar (``DTYPE_BARS``: max-abs error over max
   |plain|); timed beside the plain version, a library call and the bound
   at the dtype's peak: the shipped small models' variants and one
   main-path shape per dtype at the runner's Qwen2.5-0.5B widths.
18. small_defaults: through their entry points, the default runs whose
   model (heads of 16, f32) no kernel took before: ``main_grpo`` on
   grpo_demo_tiny.yaml for 2 steps, ``main_agent_grpo`` at ``--preset
   tiny`` for 2 steps, ``serve_openai`` at ``--preset tiny`` answering 8
   HTTP requests; launch counts shown, K5, K6 and a decode kernel gated.
19. critic: ppo_separate_critic.yaml as shipped (Hd=32, bf16) for 3 steps
   with ``critic_warmup_steps=1``; then grpo_math_qwen05b.yaml's model at
   full width, 4 of its 24 layers (``CRITIC_CUT``), as PPO with a learned
   critic (``CRITIC_OVERRIDES``, cut as ``CRITIC_REDUCED``), once with a
   separate critic and once with
   the shared value head, 3 steps each. Gates: K1, K2 and K5-K8 launched,
   the critic's params moved, ``critic/*`` finite, and a shadow critic
   step and actor-critic step, kernels against plain on one batch, within
   ``CRITIC_SHADOW_BARS``.

Then adafactor and selective recompute, LoRA and SFT:

20. adafactor_remat: the training phase's batch (B=64, T=768, 4
   microbatches) at Qwen2-1.5B's full width and depth with adafactor at lr
   1e-6 (bench.py's optimizer above 1e9 parameters), 4 steps under
   remat=True and 4 under remat="dots" (the projections' outputs kept):
   the median of steps 2-4, peak memory and the optimizer state's bytes
   beside the training phase's adamw with master weights. Gates: K1 and
   K5-K8 launched under each, K1 twice a layer in one microbatch's forward
   and backward under each, the two forms' gradients on one microbatch
   bitwise equal or within ``SHADOW_BARS``.
21. lora: ``main_grpo`` on grpo_math_qwen05b.yaml in LoRA mode
   (``LORA_OVERRIDES``, rank 16, the runner phase's cut, 4 of the 24
   layers: ``LORA_CUT``) for 3 steps; then a
   runner with ``text_rule`` rewards for 3 steps. Gates: the base params
   bitwise the init's, the adapters' b moved, every rollout's params
   bitwise the merge of its step, a shadow step within ``SHADOW_BARS``, a
   ``resume=auto`` and a ``lora.path`` runner bitwise, K1, K2 and K5-K8
   launched; the train step with K6's dw product skipped and computed, in
   turns; one step with an lm_head target (K5/K6 on the untied head).
22. sft: ``main_sft`` on a jsonl of 512 synthetic GSM8K-style problems with
   chain-of-thought answers, grpo_math_qwen05b.yaml's model at full width
   and depth, 64 rows a batch, 3 steps. Gates: T >= 128 (the attention
   kernels, not the plain path), finite loss, K1 and K5-K8 launched, a
   bitwise resume, a shadow step within ``SHADOW_BARS``.

Then Hugging Face checkpoints and the MoE model family:

23. hf_checkpoints: Qwen2.5-0.5B (D=896, H=14, Kv=2, tied, ``model_type``
   qwen2) and Qwen3-0.6B (D=1024, H=16, Kv=8, Hd=128, qk-norm, tied, qwen3)
   written as bf16 HF checkpoints at their published widths and 4 of
   their 24 and 28 layers (``HF_CUT``; random weights from --seed, ``params_to_hf_state_dict``
   and the port's safetensors writer, ``config.json``, the tokenizer fixture
   ``tests/fixtures/hf_tokenizer``); ``load_hf_pretrained`` must return the
   written tensors bitwise (load seconds and peak reported). Then
   ``main_grpo --model-path`` on the Qwen2.5 one at the runner phase's cut
   for 2 steps (K1, K2 and K5-K8 launched and no other kernel, step-1 drift
   under ``DRIFT_BAR``), ``main_sft --model-path`` on the Qwen3 one for 2
   steps (K1 and K5-K8), one Qwen3 forward, kernels against plain
   (``QWEN3_FORWARD_BARS``), and ``serve_openai --model`` on the Qwen2.5
   one (a completion and a chat request; K2 alone). Also whether the
   machine has ``transformers``, ``safetensors``, ``tokenizers`` and
   ``jinja2`` (also in the ``device`` line).
24. moe: ``main_grpo`` on grpo_math_qwen05b.yaml with the model of
   ``LLMConfig.qwen3_moe_2b`` (``MOE_OVERRIDES``: 32 experts, top-2, expert
   ffn 768, D=1024, Hd=64, G=4; full width, 2 of its 24 layers
   (``MOE_CUT``), byte tokenizer) at the runner phase's cut: capacity routing for 2 steps and a
   shadow check on its params (one microbatch's loss and gradients, kernels
   against plain on the plain run's routing, ``MOE_SHADOW_BARS``; the free
   runs' flipped choices reported), then dropless routing for 1 step. Gates: K1, K2 and K5-K8 launched and no other kernel, finite
   metrics with ``actor/moe_aux_loss``; ``capacity_overflow_frac`` reported
   at the rollout's decode shape and at a training microbatch.

Then the agent recipes and the AgentLightning runner:

25. agent_recipes: at grpo_math_qwen05b.yaml's model, full width, 4 of its
   24 layers (``RECIPES_CUT``)
   (Qwen2.5-0.5B, random weights from --seed), cut as ``RECIPES_REDUCED``,
   the launch counts zeroed before steps 1-5 and read after them: (1) a
   jsonl of gsm_synth problems through ``create_rl_dataset(type="rstar2")``
   on the tokenizer fixture with a chat template that renders tools,
   templated and filtered by length (rows kept and dropped); (2)
   ``SearchR1Recipe`` over a ``RetrievalServer`` (BM25 over 300 passages
   made in code, on 127.0.0.1): 8 questions, a scripted search in turn 1,
   the server's requests equal to the calls and its passage in every
   rollout, EM and F1; (3) ``RStar2Recipe``'s loop, 8 conversations of 3
   turns (the state carried from turn 1 to turn 2, an error and a timeout
   turn), ``rstar2_reward``; then the forked ``SessionPythonTool`` in a
   process that holds a CUDA context (state across calls in 8 sessions, a
   timeout, an error); (4) ``WideSeekR1Recipe.run_team`` (2 searchers, 4
   questions; failed turns from a scripted unknown tool) and
   ``build_team_batch``, then one ``make_policy_train_step`` call on that
   batch; (5) two ``AgentLightningRunner.run_step`` calls, 2 prompts x 4
   tasks from step 1's dataset, an agent that calls ``complete`` twice a
   task (prompts of 500+ tokens) and returns a reward for two tasks in
   three (``batch_f1_rewards`` scores the rest), the second step under
   ``StepProfiler`` (K1's and K2's launches read from its trace by their
   source names), ``train_mfu`` against ``ChipSpec.h100()``. Gates: K1, K2
   and K5-K8 launched in steps 1-5 and no other kernel; then (6) step 1's
   batch through the train step from one state, kernels against plain
   (``SHADOW_BARS``), and its logprob drift from the behaviour logprobs,
   both ways (``DRIFT_BAR``). Also whether ``sympy`` imports.

Then the mesh, across processes:

26. mesh_drill: ``python -m rlinf_tpu_torch.multiprocess_runner_drill
   --device cuda --num-processes 4 --model qwen2_0_5b`` at DRILL_CUT's
   depth: 4 ranks that share the one card over gloo, grpo_math_qwen05b.yaml's
   model (Qwen2.5-0.5B's widths, bf16, random weights). Phase A: 3 GRPO
   steps of ``ReasoningRunner(mesh=)`` on a data=1 x fsdp=2 x tensor=2 mesh
   (a checkpoint at step 2), step 1 held against a world-1 runner on the
   same rollout and weights (loss and grad norm within the drill's
   ``TOLERANCE``); B: new processes resume from the checkpoint to step 5;
   C: ``DisaggregatedReasoningRunner`` with the actor on ranks {0, 2} and the
   rollout on {1, 3}, 2 steps, the rollout's weights equal to the actor's
   after each sync. Before the drill, in this process, K1, K7 + K8, K2 and
   K3 are held against their plain versions at a rank's local shapes (a
   tensor=2 shard's 7 query heads on 1 kv head, Hd 64, 8 rows of 24
   tokens, ``drill_local_kernels``) at the bars of phases 2 and 4. Gates
   (the drill's and this phase's): those checks; losses bitwise
   equal across ranks in A, B and C; B resumed from A; every rank's
   launches in A and B show K1, K2, K4, K5, K6, K7 and K8. Reported: each
   rank's step seconds, the weight sync's seconds and bytes, all-reduces
   per step, each rank's peak memory. These are times of gloo between
   processes that share one card: they say nothing of NCCL on several.
   Then, in B's processes, the parts of the context axis and the mesh
   configurations (``DRILL_PARTS``): (a) 3 ring train steps on data=1 x
   context=4 at B=2, T=8,192 (step 1 within ``TOLERANCE`` of a world-1
   step of the same weights and batch through K1/K7/K8, on rank 0);
   (b) 2 GRPO steps with ``attn_impl=ring`` on data=1 x context=2 x
   tensor=2 (4 prompts x 4, 8 new tokens; every rank's sampled tokens
   bitwise equal); (c) one step each at fsdp=2 x tensor=2 of
   ``SFTRunner``, the runner with LoRA, with the token budget, with
   adafactor and with ``qwen3_moe_2b``'s widths (32 experts, top-2,
   capacity); (d) one rollout each of the continuous engine (int8 KV),
   the same with the megakernel and the paged engine at data=2 x
   tensor=2 (every rank the same tokens); (e) one GRPO step of
   ``qwen3_moe_2b``'s widths (capacity) at fsdp=2 x expert=2 (each rank
   computes 16 of the 32 experts; every rank the same tokens, loss and
   grad norm, within ``MOE_TOLERANCE`` of a world-1 runner step on the
   same weights and rollout, on rank 0); (f) ``moe_layer_dropless_ep``
   forward and backward at ep=4 on 4 x 512 tokens a rank (the exchange
   built from all-reduce), the output and every gradient held on rank 0
   against ``moe_layer_dropless`` on the whole batch
   (``EP_DROPLESS_TOLERANCE``), the exchange's bytes and seconds
   reported; (g) one ring train step of the MoE model at expert=2 x
   context=2 (B=2, T=2,048) within ``MOE_TOLERANCE`` of the world-1 step;
   (h) a ``DynamicScheduler`` fed timings that make it migrate, and a
   ``StandbyMigrator`` that moves a train state from a data=2 submesh of
   ranks {0, 1} onto fsdp=2 x tensor=2 over all four and takes one step,
   equal to the step of a state built there directly, the migration's
   seconds reported. Gates: those checks, and each part's launches of
   ``PART_KERNELS``. Reported: each part's seconds, launches, collectives
   (``parallel.collectives.COUNTS``) and peaks.

Last, the VLM reasoning stack:

27. vlm: ``rlinf_tpu_torch.main_vlm_grpo.main`` at full width and depth:
   the decoder of ``LLMConfig.qwen2_0_5b`` (bf16, 24 layers, V=151,936),
   a vision tower at CLIP ViT-L/14-224's widths (``VLM_VIT``: 24 timm-style
   layers of 1024, 16 heads, 256 patches of 14 px and a class token, f32),
   the two-layer GELU projector to 896 (f32), ``color_dataset`` at 224x224,
   4 prompts x 8 = 32 rows, 32 new tokens (``VLM_RUN``), random weights
   from --seed; 2 ``VLMSFTRunner`` steps, then 2 ``VLMReasoningRunner``
   steps from the SFT'd params, rewards from ``vlm_rule`` (crc32 of the
   text mod 2, on ``IdTextTokenizer``'s texts, which render every id)
   so that the groups are mixed. Gates: every param, optimizer moment and
   batch tensor on the card; finite losses and grad norms; the params
   moved; at GRPO step 1 the mean and max |behaviour - recompute| logprob
   over the response tokens under ``VLM_GAP_BAR``; at least half the groups
   mixed; every kernel's launch count 0 (the path runs the plain versions,
   as the JAX package's VLM runs XLA; the reason is printed). Reported:
   seconds a step of rollout, reward, training and the whole step, SFT
   seconds a step, step-1 ``actor/approx_kl``, the mixed groups' share,
   peak memory.

Then the embodied PPO stack:

28. embodied: (a) ``rlinf_tpu_torch.main_embodied_ppo.main`` at
   train_ppo_point_reach.py's settings (256 PointReach envs, 32 chunk steps
   a rollout, 2 epochs x 4 minibatches) for 2 steps, with 1 stage of 256
   envs and then 2 stages of 128 (``time/rollout`` of each, so the stage
   overlap is measured); (b) ``CNNGaussianPolicy`` and (c) the OFT-style
   ``VLAPolicy`` through ``EmbodiedRunner`` at image_reach_tpu_proof.py's
   settings (128 pos-only ImageReach envs in 2-step action chunks, 8 chunk
   steps, 2 epochs x 4 minibatches; the CNN's images 36 px, its least) for
   2 steps each; (d) ``EmbodiedRunner`` with ``OpenVLAPolicy``: the
   decoder of ``LLMConfig.qwen2_0_5b`` (bf16, 24 layers, the last 256 ids
   the action bins), two fused towers (phase 27's ``VLM_VIT`` at CLIP
   ViT-L/14's widths and ``OPENVLA_TOWER2`` at DINOv2-L/14's; ViTConfig
   cannot express SigLIP-so400m's widths or DINOv2's register tokens), the
   erf-GELU projector, ImageReachEnv at 224 px with the env's 2-dim action,
   2 stages x 8 envs x 8 chunk steps (128 samples), 1 epoch over 4
   minibatches of 32, 2 steps and one deterministic eval epoch
   (``OPENVLA_RUN``), random weights from --seed. Gates: finite metrics,
   params moved, every batch and state tensor on the card, (d)'s step-1
   |behaviour - recompute| logprob of the bins under ``OPENVLA_GAP_BAR``,
   every kernel's launch count 0 (the path runs the plain versions, as the
   JAX package's embodied path runs XLA; the reason is printed). Reported:
   each part's seconds and per-step metrics, (d)'s init seconds, params
   and peak memory.

The last lines are the GPU's name and power limit (nvidia-smi), one JSON
line with every kernel's figures (each with its timed ``variants`` of
phase 17), and ``{"ok": true, "device": ...}``.
Any failure raises: the script exits non-zero and prints no result. It
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import re
import signal
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

# Published dense peaks (NVIDIA data sheets): memory bytes/s, bf16 FLOP/s.
PEAKS = {
    "H100 SXM": (3.35e12, 989e12),
    "H100 PCIe": (2.0e12, 756e12),
    "H100 NVL": (3.9e12, 835e12),
    "H200": (4.8e12, 989e12),
}


#: the script's clock: every phase line says when it was written (``at_s``)
T0 = time.perf_counter()


def emit(obj) -> None:
    print(json.dumps({**obj, "at_s": time.perf_counter() - T0}), flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card_peaks(name: str):
    for key, label in (("PCIe", "H100 PCIe"), ("NVL", "H100 NVL"), ("H200", "H200")):
        if key in name:
            return label, PEAKS[label]
    return "H100 SXM", PEAKS["H100 SXM"]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one call: CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, reps: int = 20, iters: int = 10) -> float:
    """Device time of one call with the host's launch overhead out of the
    way: ``reps`` calls captured in one CUDA graph (after three warm-up
    calls), replayed ``iters`` times between CUDA events. For calls whose
    device time is shorter than their host-side dispatch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def bound(nbytes: float, flops: float, peaks):
    bw, fl = peaks
    t_bytes, t_ops = nbytes / bw * 1e3, flops / fl * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# The kernels whose compiler report the build phase prints, by source: the
# __global__ names of csrc/flash_attention_fwd.cu (K1),
# csrc/paged_attention.cu (K10: the split kernel and the merge),
# csrc/linear_ce.cu (K5 and K6's product kernel, PASS 2 being K5's, and
# K5's combine), csrc/decode_attention.cu (K3's and K2's split kernels and
# their merge) and csrc/decode_megakernel.cu (K9).
REPORTED_KERNELS = {"flash_attention_fwd.cu": ("flash_fwd_kernel",),
                    "paged_attention.cu": ("paged_split_kernel", "paged_merge_kernel"),
                    "linear_ce.cu": ("ce_gemm_kernel", "ce_fwd_combine_kernel"),
                    "decode_attention.cu": ("decode_q8_split_kernel", "decode_bf16_split_kernel",
                                            "decode_merge_kernel"),
                    "decode_megakernel.cu": ("mega_kernel",)}


def _kernel_key(mangled: str, names) -> str:
    """'name<args>' (or 'name') of the reported kernel a mangled symbol is,
    its int and bool template arguments kept, else ''."""
    for name in names:
        m = re.search(rf"\d+{name}(I(?:L[ib]\d+E)+E)?", mangled)
        if m:
            args = re.findall(r"L[ib](\d+)E", m.group(1) or "")
            return f"{name}<{', '.join(args)}>" if args else name
    return ""


def ptxas_report(log: str, names) -> dict:
    """{kernel: registers, spill bytes, stack, and ptxas's performance
    notes} of the named kernels, from an ``nvcc -Xptxas -v`` log."""
    out, key = {}, ""
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            key = _kernel_key(m.group(1), names)
            if key:
                out.setdefault(key, {"notes": []})
            continue
        if not key:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[key].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[key]["registers"] = int(m.group(1))
        if re.search(r"C7\d\d\d|Performance Loss|serialized", line):
            out[key]["notes"].append(line.strip())
    return out


def sass_counts(sass: str, names) -> dict:
    """{kernel: count of each tensor-core instruction and of the wgmma
    waits} of the named kernels, from ``cuobjdump -sass`` output: one
    WARPGROUP.DEPBAR for every HGMMA means ptxas serialised the wgmma."""
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        key = _kernel_key(part.split("\n", 1)[0], names)
        if key:
            out[key] = {op: part.count(op) for op in
                        ("HGMMA", "WARPGROUP.DEPBAR", "HMMA", "MOVM", "UBLKCP", "UTMALDG")}
    return out


def kernel_reports() -> dict:
    """ptxas's registers and spills and the SASS instruction counts of the
    REPORTED_KERNELS, from the libraries just built (check_reports holds
    them to their designs)."""
    import shutil

    from rlinf_tpu_torch.ops.cuda import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for src, names in REPORTED_KERNELS.items():
        sass = subprocess.run([tool, "-sass", str(_build._library_path(src))], capture_output=True,
                              text=True, check=True, timeout=120).stdout
        out[src] = {"ptxas": ptxas_report(_build.build_log(src), names),
                    "sass": sass_counts(sass, names)}
    return out


def check_reports(reports: dict) -> None:
    """Raise unless no reported kernel spills, K5's product kernel (PASS 2
    of ce_gemm_kernel) runs on wgmma (HGMMA, no HMMA) with fewer wgmma waits
    than products, K9's products run on wgmma (HGMMA; its attention on
    mma.sync) and K2's and K3's split kernels run on mma.sync (HMMA)."""
    bad = [k for rep in reports.values() for k, r in rep["ptxas"].items()
           if r.get("spill_stores") or r.get("spill_loads")]
    sass = {k: v for rep in reports.values() for k, v in rep["sass"].items()}
    k5 = {k: v for k, v in sass.items() if k.startswith("ce_gemm_kernel<2")}
    k3 = {k: v for k, v in sass.items() if k.startswith("decode_q8_split_kernel")}
    k2 = {k: v for k, v in sass.items() if k.startswith("decode_bf16_split_kernel")}
    k9 = {k: v for k, v in sass.items() if k.startswith("mega_kernel")}
    bad += [k for k, v in k5.items()
            if not (v["HGMMA"] > 0 and v["HMMA"] == 0 and v["WARPGROUP.DEPBAR"] < v["HGMMA"])]
    bad += [k for k, v in {**k3, **k2}.items() if not v["HMMA"] > 0]
    bad += [k for k, v in k9.items() if not v["HGMMA"] > 0]
    if (bad or len(k5) != 2 or len(k3) != 2 or len(k2) != 2
            or not {"mega_kernel<64>", "mega_kernel<128>"} <= set(k9)):
        raise AssertionError(f"kernel reports: {bad} (K5 {sorted(k5)}, K3 {sorted(k3)}, "
                             f"K2 {sorted(k2)}, K9 {sorted(k9)})")


class Rotation:
    """Cycle through copies of a kernel's inputs so that repeated timing
    calls do not find them in the 50 MB L2 cache."""

    def __init__(self, make, copies: int):
        self.sets = [make() for _ in range(copies)]
        self.i = 0

    def next(self):
        self.i = (self.i + 1) % len(self.sets)
        return self.sets[self.i]


# ---------------------------------------------------------------------------
# Phase 2: every kernel against its plain version
# ---------------------------------------------------------------------------

def k1_figures(rot, pos, valid, peaks) -> dict:
    """K1 on the first of ``rot``'s (q, k, v) sets against its plain
    version (o and lse max-abs error < 2e-2, else raise), its time over the
    rotated sets, the plain version's and scaled_dot_product_attention's
    (CUDA events), and its bound: the bytes of q, k, v, the masks, o and lse,
    or 4 Hd operations per unmasked (query, key) pair and head."""
    from rlinf_tpu_torch.ops.cuda import flash_attention as FA

    q, k, v = rot.sets[0]
    B, T, H, Hd = q.shape
    G = H // k.shape[2]
    valid_u8 = valid.to(torch.uint8)
    scale = Hd**-0.5
    o, lse = FA.flash_attention_fwd(q, k, v, pos, pos, valid_u8, scale)
    o_ref, lse_ref = FA.flash_attention_fwd_plain(q, k, v, pos, pos, valid_u8, scale)
    torch.cuda.synchronize()
    err = (o.float() - o_ref.float()).abs().max().item()
    lse_err = (lse - lse_ref).abs().max().item()
    del o_ref, lse_ref
    if not err < 2e-2 or not lse_err < 2e-2:
        raise AssertionError(f"K1 disagrees with its plain version at {tuple(q.shape)}: "
                             f"{err} (lse {lse_err})")
    ms = cuda_ms(lambda: FA.flash_attention_fwd(*rot.next(), pos, pos, valid_u8, scale), 20,
                 warmup=5)
    plain_ms = cuda_ms(lambda: FA.flash_attention_fwd_plain(q, k, v, pos, pos, valid_u8, scale), 3)
    mask4 = ((pos[:, None, :] <= pos[:, :, None]) & valid[:, None, :])[:, None]
    qt, kt, vt = (q.transpose(1, 2), k.repeat_interleave(G, 2).transpose(1, 2),
                  v.repeat_interleave(G, 2).transpose(1, 2))
    lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask4), 10, warmup=3)
    pairs = int(mask4.sum().item())
    b_ms, b_by = bound(nbytes(q, k, v, pos, pos, valid_u8, o, lse), 4.0 * Hd * H * pairs, peaks)
    return dict(max_abs_err=err, lse_max_abs_err=lse_err, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, unmasked_pairs=pairs)


def sdpa_decode(qd, kd, vd, num_kv, smask):
    """The library call for decode attention: scaled_dot_product_attention
    of q [B, H, Hd] over a packed cache [B, S, Kv Hd] (each kv head repeated
    over its group) under the slot mask [B, 1, 1, S] -> a call."""
    B, S, KD = kd.shape
    Hd, G = KD // num_kv, qd.shape[1] // num_kv
    kk = kd.reshape(B, S, num_kv, Hd).repeat_interleave(G, 2).transpose(1, 2)
    vv = vd.reshape(B, S, num_kv, Hd).repeat_interleave(G, 2).transpose(1, 2)
    qq = qd[:, :, None, :]
    return lambda: torch.nn.functional.scaled_dot_product_attention(qq, kk, vv, attn_mask=smask)


def k2_figures(randn, B, S, H, Kv, Hd, starts, lengths, peaks) -> dict:
    """K2 on a packed bf16 cache [B, S, Kv Hd] over the intervals [starts,
    lengths) against its plain version (max-abs error < 2e-2 and per-head
    relative error < K3_TOL_REL, else raise); its device time by CUDA-graph
    replay (``ms``) and by events around eager calls, the plain version's
    and scaled_dot_product_attention's, and its bound."""
    from rlinf_tpu_torch.ops.cuda import decode_attention as DA

    KD = Kv * Hd
    slots = int((lengths - starts).clamp_min(0).sum().item())
    pos_s = torch.arange(S, device=starts.device)
    smask = ((pos_s[None, :] >= starts[:, None]) & (pos_s[None, :] < lengths[:, None]))[:, None, None, :]
    rot = Rotation(lambda: (randn(B, H, Hd), randn(B, S, KD, scale=0.5),
                            randn(B, S, KD, scale=0.5)), 4)
    qd, kc, vc = rot.sets[0]
    out = DA.decode_attention_packed(qd, kc, vc, starts, lengths, num_kv=Kv)
    ref = DA.decode_attention_packed_xla(qd, kc, vc, starts, lengths, num_kv=Kv)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    rel = head_rel_err(out, ref)
    if not (err < 2e-2 and rel < K3_TOL_REL):
        raise AssertionError(f"K2 disagrees with its plain version at q[{B},{H},{Hd}] "
                             f"cache[{B},{S},{KD}]: {err}, relative {rel}")
    call = lambda: DA.decode_attention_packed(*rot.next(), starts, lengths, num_kv=Kv)
    library = sdpa_decode(qd, kc, vc, Kv, smask)
    b_ms, b_by = bound(nbytes(qd, starts, lengths, out) + 2 * slots * KD * 2,
                       4.0 * Hd * H * slots, peaks)
    return dict(
        shapes=f"q[{B},{H},{Hd}] cache[{B},{S},{KD}] bf16, {slots} valid slots",
        max_abs_err=err, tolerance=2e-2, rel_err=rel, tolerance_rel=K3_TOL_REL,
        ms=graph_ms(call), eager_ms=cuda_ms(call, 50, warmup=5),
        plain_ms=cuda_ms(lambda: DA.decode_attention_packed_xla(
            qd, kc, vc, starts, lengths, num_kv=Kv), 10),
        library_ms=graph_ms(library), library_eager_ms=cuda_ms(library, 20),
        split_plan=DA.split_plan(B * Kv, -(-S // DA.KEY_BLOCK),
                                 torch.cuda.get_device_properties(0).multi_processor_count),
        bound_ms=b_ms, bound_by=b_by)


def check_kernels(cfg, B, P, N, prompt_lens, peaks, seed):
    from rlinf_tpu_torch.models.llm.quant import quantize_tensor
    from rlinf_tpu_torch.ops.cuda import decode_attention as DA
    from rlinf_tpu_torch.ops.cuda import sampler_kernel as SK

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    H, Kv, Hd, D, V = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_, cfg.hidden_size, cfg.vocab_size
    S_max = P + N
    plen = torch.as_tensor(prompt_lens, device=dev, dtype=torch.int32)
    results = []

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    # --- K1: prefill flash attention, [B, P] left-padded --------------------
    valid = torch.arange(P, device=dev)[None, :] >= (P - plen)[:, None]
    pos = (valid.to(torch.int32).cumsum(-1) - 1).clamp_min(0).to(torch.int32)
    rot = Rotation(lambda: (randn(B, P, H, Hd), randn(B, P, Kv, Hd), randn(B, P, Kv, Hd)), 3)
    k1 = k1_figures(rot, pos, valid, peaks)
    results.append(dict(
        name="flash_attention_fwd", route="cuda",
        source="rlinf_tpu_torch/csrc/flash_attention_fwd.cu",
        replaces="rlinf_tpu/ops/pallas/flash_attention.py:166",
        shapes=f"prefill: q[{B},{P},{H},{Hd}] k/v[{B},{P},{Kv},{Hd}] bf16, left-padded",
        **k1, tolerance=2e-2, library="scaled_dot_product_attention",
        ragged=flash_fwd_ragged(randn)))
    del rot

    # --- K2/K3: decode attention over [B, S_max] packed caches, mid decode --
    starts = (P - plen).to(torch.int32)
    lengths = torch.full((B,), P + N // 2 + 1, dtype=torch.int32, device=dev)
    slots = int((lengths - starts).sum().item())
    KD = Kv * Hd
    pos_s = torch.arange(S_max, device=dev)
    valid_s = (pos_s[None, :] >= starts[:, None]) & (pos_s[None, :] < lengths[:, None])
    smask = valid_s[:, None, None, :]

    k2 = k2_figures(randn, B, S_max, H, Kv, Hd, starts, lengths, peaks)
    results.append(dict(
        name="decode_attention_bf16", route="cuda",
        source="rlinf_tpu_torch/csrc/decode_attention.cu",
        replaces="rlinf_tpu/ops/pallas/decode_attention.py:200", **k2,
        library="scaled_dot_product_attention",
        timing="ms, library_ms: device time of one call, replayed from a CUDA graph (the split "
               "kernel and the merge); eager_ms, library_eager_ms: CUDA events around calls "
               "made one after another, the host's dispatch included",
        ragged=decode_ragged(randn, RAGGED_BF16, q8=False)))

    def q8_set():
        qq, kk, vv = randn(B, H, Hd), randn(B, S_max, KD, scale=0.5), randn(B, S_max, KD, scale=0.5)
        kq, ks = DA.quantize_kv_token(kk)
        vq, vs = DA.quantize_kv_token(vv)
        return qq, kq, vq, ks, vs

    rot = Rotation(q8_set, 4)
    qd, kq, vq, ks, vs = rot.sets[0]
    out = DA.decode_attention_packed_q8(qd, kq, vq, ks, vs, starts, lengths, num_kv=Kv)
    ref = DA.decode_attention_packed_q8_xla(qd, kq, vq, ks, vs, starts, lengths, num_kv=Kv)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    k3_rel = head_rel_err(out, ref)
    if not (err < 2e-2 and k3_rel < K3_TOL_REL):
        raise AssertionError(f"K3 disagrees with its plain version: {err}, relative {k3_rel}")
    call = lambda: DA.decode_attention_packed_q8(*rot.next(), starts, lengths, num_kv=Kv)
    ms = graph_ms(call)
    eager_ms = cuda_ms(call, 50, warmup=5)
    plain_ms = cuda_ms(lambda: DA.decode_attention_packed_q8_xla(
        qd, kq, vq, ks, vs, starts, lengths, num_kv=Kv), 10)
    kdq = (kq.float() * ks[..., None]).bfloat16()
    vdq = (vq.float() * vs[..., None]).bfloat16()
    library = sdpa_decode(qd, kdq, vdq, Kv, smask)
    lib_ms = graph_ms(library)
    lib_eager_ms = cuda_ms(library, 20)
    b_ms, b_by = bound(nbytes(qd, starts, lengths, out) + 2 * slots * (KD + 4),
                       4.0 * Hd * H * slots, peaks)
    results.append(dict(
        name="decode_attention_q8", route="cuda",
        source="rlinf_tpu_torch/csrc/decode_attention.cu",
        replaces="rlinf_tpu/ops/pallas/decode_attention.py:418",
        shapes=f"q[{B},{H},{Hd}] cache[{B},{S_max},{KD}] int8 + scales, {slots} valid slots",
        max_abs_err=err, tolerance=2e-2, rel_err=k3_rel, tolerance_rel=K3_TOL_REL, ms=ms,
        eager_ms=eager_ms, plain_ms=plain_ms, library_ms=lib_ms, library_eager_ms=lib_eager_ms,
        library="scaled_dot_product_attention on dequantized bf16",
        timing="ms, library_ms: device time of one call, replayed from a CUDA graph (the split "
               "kernel and the merge); eager_ms, library_eager_ms: CUDA events around calls "
               "made one after another, the host's dispatch included",
        split_plan=DA.split_plan(B * Kv, -(-S_max // DA.KEY_BLOCK),
                                 torch.cuda.get_device_properties(0).multi_processor_count),
        bound_ms=b_ms, bound_by=b_by, ragged=decode_ragged(randn, RAGGED_Q8, q8=True)))
    del rot, kdq, vdq

    # --- K4: fused int8 lm-head sampler at [B, D] x [D, V], on the head
    # packed once (as the serving paths hold it), at B and at 8 rows -------
    lm = quantize_tensor(randn(D, V, scale=0.02, dtype=torch.float32))
    lm_q, lm_s = lm.q, lm.scale
    head = SK.pack_lm_head(lm_q, lm_s)
    lm_bf16 = (lm_q.float() * lm_s).bfloat16()
    k4 = {}
    for rows in (B, 8):
        hidden = randn(rows, D)
        tok, lp = SK.fused_lmhead_sample_packed(hidden, head, 3, greedy=True)
        tok_r, lp_r = SK.fused_lmhead_sample_plain(hidden, lm_q, lm_s, 3, greedy=True)
        tok_s, lp_s = SK.fused_lmhead_sample_packed(hidden, head, 11, temperature=0.9)
        tok_sr, _ = SK.fused_lmhead_sample_plain(hidden, lm_q, lm_s, 11, temperature=0.9)
        z = (hidden.float() @ lm_q.float()) * lm_s.reshape(1, V) / 0.9
        lp_given = torch.log_softmax(z, -1).gather(1, tok_s.long()[:, None])[:, 0]
        torch.cuda.synchronize()
        greedy_agree = (tok == tok_r).float().mean().item()
        err = (lp - lp_r).abs().max().item()
        sampled_lp_err = (lp_s - lp_given).abs().max().item()
        ms = cuda_ms(lambda: SK.fused_lmhead_sample_packed(hidden, head, 5, temperature=1.0), 20)
        # the same product and stream without the draws
        greedy_ms = cuda_ms(lambda: SK.fused_lmhead_sample_packed(hidden, head, 5, greedy=True), 20)
        plain_ms = cuda_ms(lambda: SK.fused_lmhead_sample_plain(
            hidden, lm_q, lm_s, 5, temperature=1.0), 3)

        def library():
            logits = torch.matmul(hidden, lm_bf16).float()
            return torch.log_softmax(logits, -1), logits.argmax(-1)

        lib_ms = cuda_ms(library, 10)
        b_ms, b_by = bound(nbytes(hidden, head.w, head.scale, tok, lp), 2.0 * rows * D * V, peaks)
        k4[rows] = dict(
            shapes=f"hidden[{rows},{D}] bf16, lm head [{D},{V}] int8 packed",
            max_abs_err=err, tolerance=5e-3, greedy_token_agreement=greedy_agree,
            sampled_token_agreement=(tok_s == tok_sr).float().mean().item(),
            sampled_logprob_err=sampled_lp_err, ms=ms, greedy_ms=greedy_ms, plain_ms=plain_ms,
            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        if greedy_agree != 1.0 or not err < 5e-3 or not sampled_lp_err < 5e-3:
            raise AssertionError(
                f"K4 disagrees with its plain version at B={rows}: greedy agreement "
                f"{greedy_agree}, lp err {err}, sampled lp err {sampled_lp_err}")
    results.append(dict(
        name="fused_lmhead_sample", route="cuda", source="rlinf_tpu_torch/csrc/sampler.cu",
        replaces="rlinf_tpu/ops/pallas/sampler_kernel.py:167", **k4[B],
        library="matmul(bf16) + log_softmax + argmax", at_batch_8=k4[8]))
    return results


# (B, S, H, Kv, Hd, starts, lengths) of K3's ragged cases: Qwen2-1.5B's
# heads with an empty row (start == length), a row whose start > length, a
# row of one slot and a row with start > 0 that runs over split boundaries
# (runs of 4 blocks here); Qwen2-0.5B's (Hd=64, G=7) with empty rows and
# rows ending past S; G=8 at an odd S, a partial last block past it, and
# an empty row. K2 takes the same cases and G=16, its largest, at both
# head dims.
RAGGED_Q8 = (
    (8, 300, 12, 2, 128, [0, 5, 37, 17, 299, 120, 64, 250], [300, 5, 250, 3, 300, 121, 300, 251]),
    (8, 300, 14, 2, 64, [0, 3, 200, 16, 31, 0, 250, 7], [300, 290, 201, 16, 400, 0, 299, 170]),
    (5, 77, 16, 2, 128, [0, 1, 60, 2, 30], [77, 76, 77, 3, 30]))
RAGGED_BF16 = RAGGED_Q8 + (
    (6, 211, 32, 2, 128, [0, 9, 100, 40, 210, 3], [211, 9, 211, 41, 300, 150]),
    (6, 133, 32, 2, 64, [0, 17, 5, 0, 64, 70], [133, 17, 120, 1, 129, 133]))

# K3's bar beside the max-abs 2e-2, per (row, query head): max-abs error
# over max |plain| of that head's output < 1e-2 (``head_rel_err``). The
# output is bf16, whose step is at most 2^-8 (3.9e-3) of the head's largest
# output, and two correct results differ by about one step; one stale slot
# in a row of ~450 moves its outputs by ~1e-3 absolute, ~1e-2 of their
# largest at the main shape. Per head, so that a short row's large outputs
# do not set the bar of a long row.
K3_TOL_REL = 1e-2


def decode_ragged(randn, cases, q8: bool) -> dict:
    """K3 (``q8``) or K2 against its plain version at ``cases``, at the main
    check's bars (max-abs error < 2e-2, relative error < K3_TOL_REL); a row
    with an empty interval must give exactly 0."""
    from rlinf_tpu_torch.ops.cuda import decode_attention as DA

    out = {}
    for B, S, H, Kv, Hd, st, ln in cases:
        starts = torch.as_tensor(st, dtype=torch.int32, device="cuda")
        lengths = torch.as_tensor(ln, dtype=torch.int32, device="cuda")
        k, v, q = randn(B, S, Kv * Hd, scale=0.5), randn(B, S, Kv * Hd, scale=0.5), randn(B, H, Hd)
        if q8:
            kq, ks = DA.quantize_kv_token(k)
            vq, vs = DA.quantize_kv_token(v)
            got = DA.decode_attention_packed_q8(q, kq, vq, ks, vs, starts, lengths, num_kv=Kv)
            ref = DA.decode_attention_packed_q8_xla(q, kq, vq, ks, vs, starts, lengths, num_kv=Kv)
        else:
            got = DA.decode_attention_packed(q, k, v, starts, lengths, num_kv=Kv)
            ref = DA.decode_attention_packed_xla(q, k, v, starts, lengths, num_kv=Kv)
        torch.cuda.synchronize()
        empty = [b for b in range(B) if min(ln[b], S) <= max(st[b], 0)]
        key = f"B={B} S={S} H={H} Kv={Kv} Hd={Hd}"
        out[key] = {"max_abs_err": (got.float() - ref.float()).abs().max().item(),
                    "rel_err": head_rel_err(got, ref), "empty_rows": empty,
                    "empty_rows_zero": all(bool((got[b] == 0).all().item()) for b in empty)}
        if not (out[key]["max_abs_err"] < 2e-2 and out[key]["rel_err"] < K3_TOL_REL
                and empty and out[key]["empty_rows_zero"]):
            raise AssertionError(f"{'K3' if q8 else 'K2'} at {key}: {out[key]}")
    return out


def rel_err(a, b) -> float:
    """max |a - b| over max |b|."""
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def head_rel_err(got, ref) -> float:
    """Decode attention [B, H, Hd]: the largest, over (row, head), of the
    max-abs error over max |ref| of that head's output; heads whose ref is
    all 0 (empty rows, held to exactly 0 apart) are left out."""
    got, ref = got.float(), ref.float()
    scale = ref.abs().amax(-1)
    keep = scale > 0
    err = (got - ref).abs().amax(-1)
    return (err[keep] / scale[keep]).max().item() if bool(keep.any()) else 0.0


# ---------------------------------------------------------------------------
# Phase 8: the paged-attention kernel and the decode megakernel
# ---------------------------------------------------------------------------

def random_q8_cache(L, B, S, KD, gen):
    """A random plausible stacked int8 cache (values in +-80, scales of the
    size that unit-variance keys give)."""
    dev = gen.device
    kc = torch.randint(-80, 81, (L, B, S, KD), generator=gen, device=dev, dtype=torch.int8)
    vc = torch.randint(-80, 81, (L, B, S, KD), generator=gen, device=dev, dtype=torch.int8)
    ks = torch.rand((L, B, S), generator=gen, device=dev) * 0.02 + 0.005
    vs = torch.rand((L, B, S), generator=gen, device=dev) * 0.02 + 0.005
    return kc, vc, ks, vs


def mega_case(MK, plan, mw, cfg, qparams, B, S, wp, positions, starts, gen):
    """One K9 launch against the plain version on the same inputs ->
    (errors, the inputs for timing). ``wp`` is an int or a [B] tensor."""
    from rlinf_tpu_torch.ops.rope import rope_frequencies

    dev = gen.device
    cache = random_q8_cache(plan.L, B, S, plan.KVD, gen)
    tok = torch.randint(0, cfg.vocab_size, (B,), generator=gen, device=dev)
    x0 = qparams["embed"][tok].to(torch.bfloat16)
    cos, sin = rope_frequencies(cfg.head_dim_, cfg.max_seq_len, cfg.rope_theta, dev)
    args = (x0, wp, positions, starts, cos, sin)
    before = [t.clone() for t in cache]
    ref_cache = [t.clone() for t in cache]
    hid, kc, vc, ks, vs = MK.decode_step_mega(plan, mw, x0, *cache, wp, positions, starts, cos, sin)
    torch.cuda.synchronize()
    ref, rkc, rvc, rks, rvs = MK.decode_step_mega_plain(
        plan, mw, x0, *ref_cache, wp, positions, starts, cos, sin)
    rows = torch.arange(B, device=dev)
    slot = (wp if torch.is_tensor(wp) else torch.full((B,), wp, device=dev)).long()
    deq = lambda c, s: c[:, rows, slot].float() * s[:, rows, slot][..., None]
    errs = {"hidden_rel": rel_err(hid, ref), "k_rel": rel_err(deq(kc, ks), deq(rkc, rks)),
            "v_rel": rel_err(deq(vc, vs), deq(rvc, rvs)),
            "hidden_abs": (hid.float() - ref.float()).abs().max().item(),
            "finite": bool(torch.isfinite(hid.float()).all())}
    # every slot but the written one is bit-equal to the input
    untouched = True
    for new, old in zip((kc, vc, ks, vs), before):
        old[:, rows, slot] = new[:, rows, slot]
        untouched = untouched and bool(torch.equal(new, old))
    errs["other_slots_untouched"] = untouched
    return errs, cache, args


def mega_phase_us(MK, plan, mw, cache, args) -> dict:
    """K9's time by phase from the device's timer as CTA 0 sees it (the
    mean over layers of each phase up to its grid barrier), the prologue
    and the whole launch, in microseconds."""
    clock = torch.zeros((plan.L * len(MK.PHASES) + 2,), dtype=torch.int64, device="cuda")
    MK.decode_step_mega(plan, mw, args[0], *cache, *args[1:], phase_clock=clock)
    edges = clock.cpu().numpy()
    spans = np.diff(edges[1:]).reshape(plan.L, len(MK.PHASES)) / 1e3
    out = {name: float(spans[:, i].mean()) for i, name in enumerate(MK.PHASES)}
    out["prologue"] = float(edges[1] - edges[0]) / 1e3
    out["whole_launch"] = float(edges[-1] - edges[0]) / 1e3
    return out


def mega_bound(plan, mw, B, valid_slots, peaks):
    """K9's bound: every weight byte and the valid int8 cache read once, the
    embedded and final rows and the written slots moved once; 2 flops a
    weight byte a row and 4 Hd flops a query head and slot."""
    KVD, L = plan.KVD, plan.L
    moved = (nbytes(mw.stream, mw.scales, mw.norms, mw.bias) + 2 * B * plan.D * 2
             + L * valid_slots * (2 * KVD + 8) + L * B * (2 * KVD + 8))
    return bound(moved, 2.0 * B * plan.layer_bytes * L
                 + 4.0 * plan.Hd * plan.H * (valid_slots + B) * L, peaks)


MEGA_BARS = {"hidden_rel": 5e-2, "k_rel": 3e-2, "v_rel": 3e-2}


def mega_bad(cases: dict) -> list:
    """The K9 cases that miss a bar of MEGA_BARS, are not finite or touched
    a slot other than the written one."""
    return [k for k, v in cases.items()
            if not (all(v[m] < bar for m, bar in MEGA_BARS.items())
                    and v["finite"] and v["other_slots_untouched"])]


def mega_qwen2_7b(MK, g, peaks, seed) -> dict:
    """K9 at Qwen2-7B's widths (D=3584, F=18944, H=28, Kv=4, Hd=128; 2 of
    its 28 layers, random weights from the seed) against its plain version
    at the Qwen2-1.5B case's bars: B=64, S=768 with one write slot and with
    per-row slots; timed beside its bound, with its time by phase."""
    import dataclasses

    from rlinf_tpu_torch.models.llm import model as M
    from rlinf_tpu_torch.models.llm.config import LLMConfig
    from rlinf_tpu_torch.models.llm.quant import quantize_params

    cfg = dataclasses.replace(LLMConfig.qwen2_7b(), num_layers=2)
    qp = quantize_params(M.init_params(cfg, seed + 7, device="cuda"))
    plan, mw = MK.pack_decode_weights(qp, cfg, chunk_width=cfg.hidden_size)
    dev = g.device
    B, S, slot = 64, 768, 640
    plens = torch.randint(128, 513, (B,), generator=g, device=dev, dtype=torch.int32)
    starts = (512 - plens).to(torch.int32)
    cases = {}
    cases["uniform"], cache, args = mega_case(MK, plan, mw, cfg, qp, B, S, slot,
                                              (plens + 128).to(torch.int32), starts, g)
    ms = cuda_ms(lambda: MK.decode_step_mega(plan, mw, args[0], *cache, *args[1:]), 5)
    plain_ms = cuda_ms(lambda: MK.decode_step_mega_plain(plan, mw, args[0], *cache, *args[1:]),
                       1, warmup=1)
    phase_us = mega_phase_us(MK, plan, mw, cache, args)
    del cache
    wps = torch.randint(8, S - 1, (B,), generator=g, device=dev, dtype=torch.int32)
    wps[0], wps[1] = 0, S - 1
    zeros = torch.zeros((B,), dtype=torch.int32, device=dev)
    cases["ragged"], cache, _ = mega_case(MK, plan, mw, cfg, qp, B, S, wps, wps, zeros, g)
    del cache
    b_ms, b_by = mega_bound(plan, mw, B, int((slot - starts).sum().item()), peaks)
    return dict(shapes=f"x0[{B},{plan.D}] bf16, {plan.L} layers of int8 weights "
                       f"({plan.layer_bytes} B a layer), cache[{plan.L},{B},{S},{plan.KVD}] int8",
                schedule=MK.mega_schedule(plan, B, S, torch.cuda.get_device_properties(0)
                                          .multi_processor_count)._asdict(),
                cases=cases, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                phase_us_mean_over_layers=phase_us)


def paged_case(g, B, H, Kv, Hd, Pg, max_pages, peaks, timed=True) -> dict:
    """K10 against its plain version (max-abs error < 1e-2, the row of
    length 0 exactly 0, else raise) on a random pool and page table of B
    rows whose lengths are random but for rows of 0, 1 and max_pages * Pg
    tokens; with ``timed``, its time beside its plain version, SDPA on the
    pages gathered beforehand, and its bound (the valid pages' bytes, or 4
    Hd operations per valid token and head)."""
    from rlinf_tpu_torch.ops.cuda import paged_attention as PA

    dev = torch.device("cuda")
    G = H // Kv
    num_pages = 1 + B * max_pages
    lengths = torch.randint(2, max_pages * Pg, (B,), generator=g, device=dev, dtype=torch.int32)
    lengths[3 % B], lengths[5 % B], lengths[6 % B] = 0, max_pages * Pg, 1
    table = torch.zeros((B, max_pages), dtype=torch.int32, device=dev)
    perm = (torch.randperm(num_pages - 1, generator=g, device=dev) + 1).to(torch.int32)
    used = (lengths + Pg - 1) // Pg
    at = 0
    for b in range(B):
        n = int(used[b])
        table[b, :n] = perm[at:at + n]
        at += n

    def pools():
        return tuple((torch.randn((num_pages, Kv, Pg, Hd), generator=g, device=dev) * 0.5
                      ).to(torch.bfloat16) for _ in range(2))

    rot = Rotation(pools, 3 if timed else 1)
    kp, vp = rot.sets[0]
    q = torch.randn((B, H, Hd), generator=g, device=dev).to(torch.bfloat16)
    out = PA.paged_attention(q, kp, vp, table, lengths)
    ref = PA.paged_attention_xla(q, kp, vp, table, lengths)
    torch.cuda.synchronize()
    tokens = int(lengths.sum().item())
    r = {"shapes": f"q[{B},{H},{Hd}] pages[{num_pages},{Kv},{Pg},{Hd}] bf16 table[{B},{max_pages}], "
                   f"{tokens} valid tokens, rows of 0, 1 and {max_pages * Pg} tokens",
         "max_abs_err": (out.float() - ref.float()).abs().max().item(),
         "empty_row_max_abs": out[3 % B].float().abs().max().item(),
         "split_plan": PA.split_plan(B * Kv, max_pages, torch.cuda.get_device_properties(0)
                                     .multi_processor_count)}
    if not r["max_abs_err"] < 1e-2 or r["empty_row_max_abs"] != 0.0:
        raise AssertionError(f"K10 disagrees with its plain version at {r['shapes']}: {r}")
    if not timed:
        return r
    call = lambda: PA.paged_attention(q, *rot.next(), table, lengths)
    r["ms"] = graph_ms(call)
    r["eager_ms"] = cuda_ms(call, 50, warmup=5)
    r["plain_ms"] = cuda_ms(lambda: PA.paged_attention_xla(q, kp, vp, table, lengths), 10)
    S = max_pages * Pg
    dense = lambda p: p[table.long()].permute(0, 2, 1, 3, 4).reshape(B, Kv, S, Hd)
    kd = dense(kp).repeat_interleave(G, 1)
    vd = dense(vp).repeat_interleave(G, 1)
    smask = (torch.arange(S, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    library = lambda: torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None, :], kd, vd, attn_mask=smask)
    r["library_ms"] = graph_ms(library)
    r["library_eager_ms"] = cuda_ms(library, 20)
    r["bound_ms"], r["bound_by"] = bound(
        nbytes(q, out, lengths) + int(used.sum().item()) * 4 + 2 * tokens * Kv * Hd * 2,
        4.0 * Hd * H * tokens, peaks)
    return r


def check_new_kernels(cfg, qparams, peaks, seed):
    """K10 at the paged engine's shapes (64 rows, 48 pages of 16 tokens a
    row, ragged lengths with rows of 0, 1 and all tokens) and at 8 rows,
    then at other geometries (Hd=64 with G=7, G=16, pages of 32 and of 8
    tokens); and K9 on Qwen2-1.5B packed weights and a random int8 cache:
    first at a small shape (a grid that does not fit deadlocks rather than
    errs), then B=64, S=768 with one write slot and with ragged per-row
    slots, and at B=8 and B=96 (two row blocks of the kernel); then at
    Qwen2-7B's widths (``mega_qwen2_7b``)."""
    from rlinf_tpu_torch.models.llm import model as M
    from rlinf_tpu_torch.models.llm.config import LLMConfig
    from rlinf_tpu_torch.models.llm.quant import quantize_params
    from rlinf_tpu_torch.ops.cuda import decode_megakernel as MK
    from rlinf_tpu_torch.ops.cuda import paged_attention as PA

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 40)
    H, Kv, Hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    G = H // Kv
    results = []

    # --- K10 -----------------------------------------------------------------
    main = paged_case(g, 64, H, Kv, Hd, 16, 48, peaks)
    b8 = paged_case(g, 8, H, Kv, Hd, 16, 48, peaks)
    geometries = {}
    for B, Hq, Kvq, Hdq, Pg, pages in ((16, 14, 2, 64, 16, 20), (16, 32, 2, 128, 16, 20),
                                       (16, H, Kv, Hd, 32, 24), (16, 14, 2, 64, 8, 40)):
        r = paged_case(g, B, Hq, Kvq, Hdq, Pg, pages, peaks, timed=False)
        geometries[r.pop("shapes")] = r
    results.append(dict(
        name="paged_attention", route="cuda", source="rlinf_tpu_torch/csrc/paged_attention.cu",
        replaces="rlinf_tpu/ops/pallas/paged_attention.py:152", **main, tolerance=1e-2,
        library="scaled_dot_product_attention on pages gathered beforehand",
        timing="ms, library_ms: device time of one call, replayed from a CUDA graph (the split "
               "kernel and the merge); eager_ms, library_eager_ms: CUDA events around calls "
               "made one after another, the host's dispatch included",
        at_batch_8=b8, geometries=geometries))

    # --- K9, small shape first ----------------------------------------------
    small = LLMConfig(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
                      head_dim=64, intermediate_size=512, max_seq_len=256)
    sq = quantize_params(M.init_params(small, seed, device="cuda"))
    splan, smw = MK.pack_decode_weights(sq, small)
    wp = torch.randint(5, 127, (8,), generator=g, device=dev, dtype=torch.int32)
    k9 = {}
    k9["small_ragged"], _, _ = mega_case(MK, splan, smw, small, sq, 8, 128, wp, wp,
                                         torch.zeros(8, dtype=torch.int32, device=dev), g)
    emit({"phase": "megakernel_small", **k9["small_ragged"]})

    # --- K9 at Qwen2-1.5B ------------------------------------------------------
    plan, mw = MK.pack_decode_weights(qparams, cfg)
    B, S = 64, 768
    plens = torch.randint(128, 513, (B,), generator=g, device=dev, dtype=torch.int32)
    starts = (512 - plens).to(torch.int32)
    slot = 512 + 128
    k9["uniform"], cache, args = mega_case(MK, plan, mw, cfg, qparams, B, S, slot,
                                           (plens + 128).to(torch.int32), starts, g)
    run = lambda: MK.decode_step_mega(plan, mw, args[0], *cache, *args[1:])
    ms = cuda_ms(run, 5)
    plain_ms = cuda_ms(lambda: MK.decode_step_mega_plain(plan, mw, args[0], *cache, *args[1:]),
                       1, warmup=1)
    phase_us = mega_phase_us(MK, plan, mw, cache, args)
    valid_slots = int((slot - starts).sum().item())
    layers = tuple((cache[0][l], cache[1][l], cache[2][l], cache[3][l]) for l in range(plan.L))
    tok = torch.zeros((B,), dtype=torch.long, device=dev)
    per_layer_busy = profile_window(lambda: M.decode_step_packed_q8(
        qparams, cfg, tok, layers, slot, args[2], starts,
        torch.full((B,), slot + 1, dtype=torch.int32, device=dev), attn_impl="pallas")
    )["device_busy_ms"]
    del cache, layers

    wps = torch.randint(8, S - 1, (B,), generator=g, device=dev, dtype=torch.int32)
    wps[0], wps[1] = 0, S - 1          # a free slot of the engine, and a full row
    zeros = torch.zeros((B,), dtype=torch.int32, device=dev)
    k9["ragged"], cache, args = mega_case(MK, plan, mw, cfg, qparams, B, S, wps, wps, zeros, g)
    ragged_ms = cuda_ms(lambda: MK.decode_step_mega(plan, mw, args[0], *cache, *args[1:]), 5)
    del cache
    wp8 = torch.randint(8, S - 1, (8,), generator=g, device=dev, dtype=torch.int32)
    k9["ragged_b8"], cache, args = mega_case(MK, plan, mw, cfg, qparams, 8, S, wp8, wp8,
                                             zeros[:8], g)
    b8_ms = cuda_ms(lambda: MK.decode_step_mega(plan, mw, args[0], *cache, *args[1:]), 5)
    del cache
    w96 = torch.randint(8, S - 1, (96,), generator=g, device=dev, dtype=torch.int32)
    k9["ragged_b96"], cache, _ = mega_case(MK, plan, mw, cfg, qparams, 96, S, w96, w96,
                                           torch.zeros(96, dtype=torch.int32, device=dev), g)
    del cache

    KVD, L = plan.KVD, plan.L
    b_ms, b_by = mega_bound(plan, mw, B, valid_slots, peaks)
    worst = {k: max(v[k] for v in k9.values()) for k in ("hidden_rel", "k_rel", "v_rel")}
    k9_7b = mega_qwen2_7b(MK, g, peaks, seed)
    results.append(dict(
        name="decode_megakernel", route="cuda", source="rlinf_tpu_torch/csrc/decode_megakernel.cu",
        replaces="rlinf_tpu/ops/pallas/decode_megakernel.py:598",
        shapes=f"x0[{B},{plan.D}] bf16, {L} layers of int8 weights ({plan.layer_bytes} B a layer), "
               f"cache[{L},{B},{S},{KVD}] int8 + scales, {valid_slots} valid slots a layer",
        max_abs_err=max(v["hidden_abs"] for v in k9.values()), rel_err=worst, cases=k9,
        tolerance_rel=MEGA_BARS, schedule=MK.mega_schedule(
            plan, B, S, torch.cuda.get_device_properties(0).multi_processor_count)._asdict(),
        ms=ms, ragged_ms=ragged_ms, b8_ms=b8_ms, plain_ms=plain_ms, library_ms=None,
        per_layer_step_device_busy_ms=per_layer_busy, phase_us_mean_over_layers=phase_us,
        comparison="no one PyTorch call computes a whole step; per_layer_step_device_busy_ms is "
                   "the device-busy time of one decode_step_packed_q8 step (K3 and eager "
                   "PyTorch, 28 layers) at the same shape",
        bound_ms=b_ms, bound_by=b_by, qwen2_7b=k9_7b))
    bad = mega_bad(k9) + [f"qwen2_7b {k}" for k in mega_bad(k9_7b["cases"])]
    if bad:
        raise AssertionError(f"K9 disagrees with its plain version in {bad}: {k9}, {k9_7b}")
    return results[::-1], (plan, mw)      # K9, then K10


# ---------------------------------------------------------------------------
# Phase 5: the training kernels against their plain versions
# ---------------------------------------------------------------------------


def check_training_kernels(cfg, attention_mask, peaks, seed):
    """K5/K6 at one row chunk of the training path (4096 rows, the tied
    [V, D] embedding) and K1, K7/K8 at one microbatch (the training batch's
    first 16 rows, right-padded, T=768) -> (K5-K8's results, K1's figures
    at the microbatch)."""
    from rlinf_tpu_torch.ops.cuda import flash_attention as FA
    from rlinf_tpu_torch.ops.cuda import linear_ce as LCE

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 20)
    H, Kv, Hd, D, V = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_, cfg.hidden_size, cfg.vocab_size
    G = H // Kv
    results = []

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    # --- K5: fused linear-CE forward, the tied [V, D] layout of the training
    # path and the untied [D, V] one ------------------------------------------
    n = 4096
    h, w = randn(n, D), randn(V, D, scale=0.02)
    tgt = torch.randint(0, V, (n,), generator=g, device=dev, dtype=torch.int32)
    k5 = {}
    for layout in ("vd", "dv"):
        wl_ = w if layout == "vd" else w.t().contiguous()
        got = LCE.ce_forward(h, wl_, tgt, 1.0, layout)
        ref = LCE.ce_forward_plain(h, wl_, tgt, 1.0, layout)
        torch.cuda.synchronize()
        errs = [(a - b).abs().max().item() for a, b in zip(got, ref)]
        del ref
        k5[layout] = dict(max_abs_err=max(errs), lp_ent_lse_err=errs,
                          ms=cuda_ms(lambda: LCE.ce_forward(h, wl_, tgt, 1.0, layout), 3, warmup=1))
        if not max(errs) < 2e-3:
            raise AssertionError(f"K5 ({layout}) disagrees with its plain version: {errs}")
        if layout == "vd":
            lp, ent, lse = got
        del wl_, got
        torch.cuda.empty_cache()
    plain_ms = cuda_ms(lambda: LCE.ce_forward_plain(h, w, tgt, 1.0, "vd"), 2, warmup=1)
    hl, wl = h.clone().requires_grad_(True), w.clone().requires_grad_(True)

    def library():
        logp = torch.log_softmax((hl @ wl.t()).float(), -1)
        return logp.gather(1, tgt.long()[:, None])[:, 0], -(logp.exp() * logp).sum(-1)

    with torch.no_grad():
        lib_ms = cuda_ms(library, 3, warmup=1)
    b_ms, b_by = bound(nbytes(h, w, tgt, lp, ent, lse), 2.0 * n * D * V, peaks)
    results.append(dict(
        name="linear_ce_fwd", route="cuda", source="rlinf_tpu_torch/csrc/linear_ce.cu",
        replaces="rlinf_tpu/ops/pallas/linear_ce.py:234",
        shapes=f"h[{n},{D}] bf16 w[{V},{D}] bf16 (vd) targets int32",
        **k5["vd"], tolerance=2e-3, plain_ms=plain_ms, library_ms=lib_ms,
        library="matmul(bf16) + log_softmax + gather/entropy", bound_ms=b_ms, bound_by=b_by,
        untied_dv=k5["dv"], ragged=k5_ragged(g)))

    # --- K6: fused linear-CE backward (non-zero entropy gradient), the tied
    # [V, D] layout of the training path and the untied [D, V] one; the
    # passes read apart from a profiler trace --------------------------------
    g_lp, g_ent = randn(n, dtype=torch.float32), randn(n, scale=0.1, dtype=torch.float32)
    mu = lse - ent
    lpv, entv = library()
    loss = (lpv * g_lp + entv * g_ent).sum()
    lib_ms = cuda_ms(lambda: torch.autograd.grad(loss, (hl,), retain_graph=True), 3, warmup=1)
    del lpv, entv, loss, hl, wl
    torch.cuda.empty_cache()
    k6 = {}
    for layout in ("vd", "dv"):
        wl_ = w if layout == "vd" else w.t().contiguous()
        args = (h, wl_, tgt, lse, mu, g_lp, g_ent, 1.0, layout)
        dz, dh = LCE.ce_backward(*args)
        dz_r, dh_r = LCE.ce_backward_plain(*args)
        dw = LCE.weight_grad(h, dz, layout, V, w.dtype)
        dw_r = LCE.weight_grad(h, dz_r, layout, V, w.dtype)
        torch.cuda.synchronize()
        errs = {"dz": rel_err(dz, dz_r), "dh": rel_err(dh, dh_r), "dw": rel_err(dw, dw_r)}
        dh_abs = (dh.float() - dh_r.float()).abs().max().item()
        del dz_r, dh_r, dw, dw_r
        torch.cuda.empty_cache()
        ms = cuda_ms(lambda: LCE.ce_backward(*args), 3, warmup=1)
        plain_ms = cuda_ms(lambda: LCE.ce_backward_plain(*args), 2, warmup=1)
        # a profiler session after the first can lose its first tens of ms of
        # records (device_ms_by_kernel), all of a pass's in a short trace:
        # trace again over twice as many calls, at most K6_TRACES times
        for traces in range(1, K6_TRACES + 1):
            traced_ms, traced_n = device_ms_by_kernel(lambda: LCE.ce_backward(*args),
                                                      K6_TRACED_CALLS << (traces - 1))
            if all(any(name in key for key in traced_ms) for _, name in K6_PASSES):
                break
        by_pass = k6_passes(traced_ms, 2.0 * n * D * V)
        by_pass["traces"] = traces
        by_pass["launches_traced"] = {p: sum(c for key, c in traced_n.items() if name in key)
                                      for p, name in K6_PASSES}
        b_ms, b_by = bound(nbytes(h, wl_, tgt, lse, mu, g_lp, g_ent, dz, dh), 4.0 * n * D * V, peaks)
        k6[layout] = dict(max_abs_err=dh_abs, rel_err=errs, tolerance_rel=1e-2, ms=ms,
                          plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, **by_pass)
        if not max(errs.values()) < 1e-2:
            raise AssertionError(f"K6 ({layout}) disagrees with its plain version: {errs}")
        del wl_, args, dz, dh
        torch.cuda.empty_cache()
    results.append(dict(
        name="linear_ce_bwd", route="cuda", source="rlinf_tpu_torch/csrc/linear_ce.cu",
        replaces="rlinf_tpu/ops/pallas/linear_ce.py:283",
        shapes=f"as K5, dz[{n},{LCE._v_pad(V)}] bf16 out", **k6["vd"], library_ms=lib_ms,
        library="autograd backward of the K5 library call, d/dh", untied_dv=k6["dv"]))
    del h, w, tgt, lp, ent, lse, mu
    torch.cuda.empty_cache()

    # --- K7 / K8: flash-attention backward at one microbatch ----------------
    valid = torch.as_tensor(attention_mask, device=dev)
    B, T = valid.shape
    pos = (valid.to(torch.int32).cumsum(-1) - 1).clamp_min(0).to(torch.int32)
    # K1 at the microbatch: the forward of the train step
    k1_train = k1_figures(Rotation(lambda: (randn(B, T, H, Hd), randn(B, T, Kv, Hd),
                                            randn(B, T, Kv, Hd)), 2), pos, valid, peaks)
    k1_train["shapes"] = f"train microbatch: q[{B},{T},{H},{Hd}] k/v[{B},{T},{Kv},{Hd}], right-padded"
    args = flash_bwd_inputs(randn, pos, valid, H, Kv, Hd)
    q, k, v, _, _, valid_u8, o, lse, do, scale = args
    (dq, dk, dv), errs, abs_errs = flash_bwd_errors(args)
    delta = torch.empty((B, H, T), dtype=torch.float32, device=dev)
    k7, k8 = flash_bwd_launches(args, delta, (dq, dk, dv))
    k7()
    torch.cuda.synchronize()
    delta_err = rel_err(delta, FA._delta(o, do))
    # right after the multi-GB plain version, a few calls read high: each
    # timer warms up on ten calls first
    ms_dq, ms_dkv = cuda_ms(k7, 50, warmup=10), cuda_ms(k8, 50, warmup=10)
    # the whole call (K7 with its delta, then K8) beside the library's one
    # call in the same run: the comparison that counts
    whole_ms = cuda_ms(lambda: FA.flash_attention_bwd(*args), 50, warmup=10)
    plain_ms = cuda_ms(lambda: FA.flash_attention_bwd_plain(*args), 2, warmup=1)
    mask = (pos[:, None, :] <= pos[:, :, None]) & valid[:, None, :]
    ql = q.transpose(1, 2).detach().requires_grad_(True)
    kl_ = k.detach().requires_grad_(True)
    vl = v.detach().requires_grad_(True)
    ol = torch.nn.functional.scaled_dot_product_attention(
        ql, kl_.repeat_interleave(G, 2).transpose(1, 2), vl.repeat_interleave(G, 2).transpose(1, 2),
        attn_mask=mask[:, None])
    do_t = do.transpose(1, 2)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(ol, (ql, kl_, vl), do_t, retain_graph=True), 50,
                     warmup=10)
    del ql, kl_, vl, ol, do_t
    ragged = flash_bwd_ragged(randn)
    pairs = int(mask.sum().item())
    common_fields = dict(
        source="rlinf_tpu_torch/csrc/flash_attention_bwd.cu",
        shapes=f"q/do[{B},{T},{H},{Hd}] k/v[{B},{T},{Kv},{Hd}] bf16, right-padded rows",
        max_abs_err=max(abs_errs.values()), rel_err=errs, tolerance_rel=2e-2,
        plain_ms=plain_ms, plain="dq, dk and dv together (delta included)", library_ms=lib_ms,
        library="autograd backward of scaled_dot_product_attention (dq, dk, dv)",
        whole_call_ms=whole_ms, whole_call_over_library=whole_ms / lib_ms)
    # the bound counts 3 (K7) and 4 (K8) products on the unmasked pairs
    for name, site, ins, outs, products, ms_k, extra in (
            ("flash_attention_bwd_dq", 311, nbytes(q, k, v, o, do, pos, pos, valid_u8, lse),
             nbytes(dq, delta), 3, ms_dq, {"delta_rel_err": delta_err, "ragged": ragged}),
            ("flash_attention_bwd_dkv", 342, nbytes(q, k, v, do, pos, pos, valid_u8, lse, delta),
             nbytes(dk, dv), 4, ms_dkv, {})):
        b_ms, b_by = bound(ins + outs, 2.0 * products * Hd * H * pairs, peaks)
        results.append(dict(name=name, route="cuda",
                            replaces=f"rlinf_tpu/ops/pallas/flash_attention.py:{site}",
                            ms=ms_k, bound_ms=b_ms, bound_by=b_by, **common_fields, **extra))
    if not (max(errs.values()) < 2e-2 and delta_err < 1e-4):
        raise AssertionError(f"K7/K8 disagree with their plain version: {errs}, delta {delta_err}")
    return results, k1_train


def flash_bwd_inputs(randn, pos, valid, H, Kv, Hd):
    """(q, k, v, pos, pos, valid, o, lse, do, scale) of one flash-attention
    backward: random bf16 inputs, o and lse from K1."""
    from rlinf_tpu_torch.ops.cuda import flash_attention as FA

    B, T = valid.shape
    q, k, v, do = randn(B, T, H, Hd), randn(B, T, Kv, Hd), randn(B, T, Kv, Hd), randn(B, T, H, Hd)
    valid_u8 = valid.to(torch.uint8)
    scale = Hd**-0.5
    o, lse = FA.flash_attention_fwd(q, k, v, pos, pos, valid_u8, scale)
    return q, k, v, pos, pos, valid_u8, o, lse, do, scale


def flash_bwd_launches(args, delta, grads):
    """(K7 call, K8 call): each of the backward's two kernels launched
    alone on ``args`` (flash_bwd_inputs' tuple), K7 writing delta, K8
    reading it, into ``grads`` = (dq, dk, dv)."""
    from rlinf_tpu_torch.ops.cuda import flash_attention as FA

    q, k, v, pos_q, pos_kv, valid_u8, o, lse, do, scale = args
    B, Sq, H, Hd = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    dq, dk, dv = grads

    def common():  # the tensors, not only their addresses, stay with the calls
        return (q.data_ptr(), k.data_ptr(), v.data_ptr(), pos_q.data_ptr(), pos_kv.data_ptr(),
                valid_u8.data_ptr())

    def dims():
        return (B, Sq, Sk, H, Kv, Hd, FA.dtype_code("q", q), float(scale),
                torch.cuda.current_stream().cuda_stream)

    def k7():
        FA.KERNEL_DQ(q.device.index, *common(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                     delta.data_ptr(), dq.data_ptr(), *dims())

    def k8():
        FA.KERNEL_DKV(q.device.index, *common(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                      dk.data_ptr(), dv.data_ptr(), *dims())

    return k7, k8


def flash_bwd_errors(args):
    """K7 + K8 against their plain version on the same inputs -> (their
    (dq, dk, dv), relative errors, absolute errors)."""
    from rlinf_tpu_torch.ops.cuda import flash_attention as FA

    got = FA.flash_attention_bwd(*args)
    want = FA.flash_attention_bwd_plain(*args)
    torch.cuda.synchronize()
    names = ("dq", "dk", "dv")
    return (got, {nm: rel_err(a, b) for nm, a, b in zip(names, got, want)},
            {nm: (a.float() - b.float()).abs().max().item() for nm, a, b in zip(names, got, want)})


# (B, T, H, Kv, Hd, left-padded) where the attention tiles leave ragged
# edges: T=700 left-padded at Hd=64 with Qwen2-0.5B's heads, and Sq=Sk=100
# right-padded at Hd=128; row 1 of each has no valid key.
RAGGED_ATTENTION = ((4, 700, 14, 2, 64, True), (3, 100, 12, 2, 128, False))


def ragged_rows(B, T, left):
    """(valid [B, T] bool, positions [B, T] int32) of one ragged case."""
    lens = torch.linspace(T // 3, T, B, device="cuda").round().long().flip(0)
    ar = torch.arange(T, device="cuda")[None]
    valid = ar >= (T - lens)[:, None] if left else ar < lens[:, None]
    pos = (valid.to(torch.int32).cumsum(-1) - 1).clamp_min(0).to(torch.int32)
    valid[1] = False
    return valid, pos


def flash_fwd_ragged(randn, cases=RAGGED_ATTENTION) -> dict:
    """K1 against its plain version at ``cases``, at the main check's bar
    (o and lse max-abs error < 2e-2); the row with no valid key must give
    exactly 0."""
    from rlinf_tpu_torch.ops.cuda import flash_attention as FA

    out = {}
    for B, T, H, Kv, Hd, left in cases:
        valid, pos = ragged_rows(B, T, left)
        vu8 = valid.to(torch.uint8)
        q, k, v = randn(B, T, H, Hd), randn(B, T, Kv, Hd), randn(B, T, Kv, Hd)
        o, lse = FA.flash_attention_fwd(q, k, v, pos, pos, vu8, Hd**-0.5)
        o_r, lse_r = FA.flash_attention_fwd_plain(q, k, v, pos, pos, vu8, Hd**-0.5)
        torch.cuda.synchronize()
        key = f"{'left' if left else 'right'}-padded B={B} T={T} H={H} Kv={Kv} Hd={Hd}"
        out[key] = {"max_abs_err": (o.float() - o_r.float()).abs().max().item(),
                    "lse_max_abs_err": (lse - lse_r).abs().max().item(),
                    "masked_row_zero": bool((o[1] == 0).all().item())}
        r = out[key]
        if not (r["max_abs_err"] < 2e-2 and r["lse_max_abs_err"] < 2e-2 and r["masked_row_zero"]):
            raise AssertionError(f"K1 at {key}: {r}")
    return out


def flash_bwd_ragged(randn, cases=RAGGED_ATTENTION) -> dict:
    """K7 + K8 against their plain version at ``cases``, at the main
    check's bar (relative error < 2e-2 on dq, dk, dv); the gradients of the
    row with no valid key must be exactly zero."""
    out = {}
    for B, T, H, Kv, Hd, left in cases:
        valid, pos = ragged_rows(B, T, left)
        args = flash_bwd_inputs(randn, pos, valid, H, Kv, Hd)
        got, errs, _ = flash_bwd_errors(args)
        key = f"{'left' if left else 'right'}-padded B={B} T={T} H={H} Kv={Kv} Hd={Hd}"
        out[key] = {"rel_err": errs,
                    "masked_row_zero": all(bool((t[1] == 0).all().item()) for t in got)}
        if not (max(errs.values()) < 2e-2 and out[key]["masked_row_zero"]):
            raise AssertionError(f"K7/K8 at {key}: {out[key]}")
    return out


def attn_impl_crossover(cfg, seed) -> dict:
    """causal_attention forward + backward through the kernels
    (impl="pallas": K1, K7, K8) and through the plain path (impl="xla") on
    one Qwen2-1.5B layer's q, k, v at a fixed 12,288 tokens, for T = 128,
    256, 512, 768, 1024 and 2048 (B = 12,288 / T, no padding). Each time is
    the mean of 50 calls after 10 warm-up calls. It records the plain
    path's time over the kernels' at each T, the pairs of neighbouring T
    between which the faster path changes (none where one path wins
    throughout), and the least T from which the kernels win at every
    longer T: what resolve_attn_impl's threshold (config.py) is set from."""
    from rlinf_tpu_torch.config import ATTN_KERNELS_FROM_T
    from rlinf_tpu_torch.ops.attention import causal_attention

    g = torch.Generator(device="cuda").manual_seed(seed + 30)
    H, Kv, Hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    out = {}
    for T in (128, 256, 512, 768, 1024, 2048):
        B = 12288 // T
        q, k, v, do = (torch.randn(shape, generator=g, device="cuda").bfloat16()
                       for shape in ((B, T, H, Hd), (B, T, Kv, Hd), (B, T, Kv, Hd), (B, T, H, Hd)))
        row = {"batch": B}
        for impl in ("pallas", "xla"):
            def step():
                qq, kk, vv = (x.detach().requires_grad_(True) for x in (q, k, v))
                torch.autograd.backward(causal_attention(qq, kk, vv, impl=impl), do)
            row[f"{impl}_ms"] = cuda_ms(step, 50, warmup=10)
        row["xla_over_pallas"] = row["xla_ms"] / row["pallas_ms"]
        out[f"T={T}"] = row
        del q, k, v, do
        torch.cuda.empty_cache()
    wins = [(int(key[2:]), r["xla_over_pallas"] > 1) for key, r in out.items()]
    out["kernels_win_at_T"] = [T for T, won in wins if won]
    out["crossover_between_T"] = [[t0, t1] for (t0, w0), (t1, w1) in zip(wins, wins[1:])
                                  if w0 != w1]
    losing = [T for T, won in wins if not won]
    later = [T for T, _ in wins if not losing or T > max(losing)]
    out["kernels_win_from_T"] = later[0] if later else None
    out["resolve_attn_impl_threshold"] = ATTN_KERNELS_FROM_T
    return out


def ragged_shapes(seed) -> dict:
    """K4 and K6 against their plain versions where the shapes leave ragged
    edges: K4 at B = 100 (a full and a partial row block) and at D = 200,
    V = 1000 (the packed head padded in depth and vocabulary); K6 at 320
    rows (two and a half 128-row tiles), D = 200, V = 1000, and at D = 100,
    V = 1001 (depth zero-padded to 104, the untied weight's rows to 1008),
    both layouts. Bars as at the main shapes: K4 greedy tokens equal and
    logprob error < 5e-3, K6 relative error < 1e-2 and the pad columns of
    dz zero."""
    from rlinf_tpu_torch.models.llm.quant import quantize_tensor
    from rlinf_tpu_torch.ops.cuda import sampler_kernel as SK

    g = torch.Generator(device="cuda").manual_seed(seed + 42)
    out = {}
    for B, D, V in ((100, 1536, 151936), (8, 200, 1000), (100, 200, 1000)):
        lm = quantize_tensor(torch.randn((D, V), generator=g, device="cuda") * 0.05)
        head = SK.pack_lm_head(lm.q, lm.scale)
        hidden = torch.randn((B, D), generator=g, device="cuda").bfloat16()
        tok, lp = SK.fused_lmhead_sample_packed(hidden, head, 3, greedy=True)
        ref_tok, ref_lp = SK.fused_lmhead_sample_plain(hidden, lm.q, lm.scale, 3, greedy=True)
        tok_s, _ = SK.fused_lmhead_sample_packed(hidden, head, 9, temperature=0.7)
        ref_s, _ = SK.fused_lmhead_sample_plain(hidden, lm.q, lm.scale, 9, temperature=0.7)
        r = {"greedy_agree": (tok == ref_tok).float().mean().item(),
             "lp_err": (lp - ref_lp).abs().max().item(),
             "sampled_agree": (tok_s == ref_s).float().mean().item()}
        out[f"K4 B={B} D={D} V={V}"] = r
        if r["greedy_agree"] != 1.0 or not r["lp_err"] < 5e-3:
            raise AssertionError(f"K4 at B={B}, D={D}, V={V}: {r}")
    for n, D, V in ((320, 200, 1000), (100, 100, 1001)):
        out.update(k6_ragged(g, n, D, V))
    return out


def k5_ragged(g, n=100, D=100, V=1001, T=1.3) -> dict:
    """K5 against its plain version where every tile is ragged: n rows (a
    partial 128-row tile, as fused_linear_ce passes them), depth D
    (zero-padded to a multiple of 8 by the wrapper), V columns (a partial
    last tile, where the last row's target lies), at temperature T, both
    layouts; max-abs error < 2e-3 on lp, ent and lse."""
    from rlinf_tpu_torch.ops.cuda import linear_ce as LCE

    h = torch.randn((n, D), generator=g, device="cuda").bfloat16()
    tgt = torch.randint(0, V, (n,), generator=g, device="cuda", dtype=torch.int32)
    tgt[n - 1] = V - 1
    w_vd = (torch.randn((V, D), generator=g, device="cuda") * 0.1).bfloat16()
    out = {}
    for layout in ("vd", "dv"):
        w = w_vd if layout == "vd" else w_vd.t().contiguous()
        got = LCE.ce_forward(h, w, tgt, 1.0 / T, layout)
        ref = LCE.ce_forward_plain(h, w, tgt, 1.0 / T, layout)
        torch.cuda.synchronize()
        errs = [(a - b).abs().max().item() for a, b in zip(got, ref)]
        key = f"K5 {layout} n={n} D={D} V={V} T={T}"
        out[key] = {"lp_ent_lse_err": errs}
        if not max(errs) < 2e-3:
            raise AssertionError(f"K5 at {key}: {errs}")
    return out


def k6_ragged(g, n, D, V) -> dict:
    """K6 against its plain version at n rows, depth D and vocabulary V, in
    both layouts: relative error < 1e-2 on dz and dh, pad columns of dz 0."""
    from rlinf_tpu_torch.ops.cuda import linear_ce as LCE

    out = {}
    h = torch.randn((n, D), generator=g, device="cuda").bfloat16()
    tgt = torch.randint(0, V, (n,), generator=g, device="cuda", dtype=torch.int32)
    g_lp = torch.randn((n,), generator=g, device="cuda")
    g_ent = torch.randn((n,), generator=g, device="cuda")
    w_vd = (torch.randn((V, D), generator=g, device="cuda") * 0.1).bfloat16()
    for layout in ("vd", "dv"):
        w = w_vd if layout == "vd" else w_vd.t().contiguous()
        _, ent, lse = LCE.ce_forward_plain(h, w, tgt, 1.3, layout)
        args = (h, w, tgt, lse, lse - ent, g_lp, g_ent, 1.3, layout)
        dz, dh = LCE.ce_backward(*args)
        dz_r, dh_r = LCE.ce_backward_plain(*args)
        torch.cuda.synchronize()
        r = {"dz": rel_err(dz, dz_r), "dh": rel_err(dh, dh_r),
             "dz_pad_zero": bool((dz[:, V:] == 0).all().item())}
        out[f"K6 {layout} n={n} D={D} V={V}"] = r
        if not (r["dz"] < 1e-2 and r["dh"] < 1e-2 and r["dz_pad_zero"]):
            raise AssertionError(f"K6 ({layout}) at n={n}, D={D}, V={V}: {r}")
    return out


# ---------------------------------------------------------------------------
# Phases 3 and 4: the main path
# ---------------------------------------------------------------------------

def _kernel_sites():
    """(module, attribute, kernel name, plain version) of every kernel
    wrapper the main path calls, at the name the caller looks it up by."""
    from rlinf_tpu_torch.models.llm import model as M
    from rlinf_tpu_torch.models.llm import sampler as S
    from rlinf_tpu_torch.ops.cuda import decode_attention as DA
    from rlinf_tpu_torch.ops.cuda import flash_attention as FA
    from rlinf_tpu_torch.ops.cuda import sampler_kernel as SK

    return [(FA, "flash_attention_fwd", "flash_attention_fwd", FA.flash_attention_fwd_plain),
            (M, "decode_attention_packed", "decode_attention_bf16",
             DA.decode_attention_packed_xla),
            (M, "decode_attention_packed_q8", "decode_attention_q8",
             DA.decode_attention_packed_q8_xla),
            (S, "fused_lmhead_sample_packed", "fused_lmhead_sample",
             SK.fused_lmhead_sample_packed_plain)]


def _engine_sites():
    """The serving sites and those of the megakernel and paged paths."""
    from rlinf_tpu_torch.models.llm import sampler as S
    from rlinf_tpu_torch.ops.cuda import decode_megakernel as MK
    from rlinf_tpu_torch.ops.cuda import paged_attention as PA
    from rlinf_tpu_torch.rollout import continuous_engine as CE
    from rlinf_tpu_torch.rollout import paged_engine as PE

    return _kernel_sites() + [
        (S, "decode_step_mega", "decode_megakernel", MK.decode_step_mega_plain),
        (CE, "decode_step_mega", "decode_megakernel", MK.decode_step_mega_plain),
        (PE, "paged_attention", "paged_attention", PA.paged_attention_xla)]


@contextlib.contextmanager
def kernels_replaced(make, sites=None):
    """Replace each kernel wrapper of the path (the serving path's unless
    ``sites`` names others) by ``make(name, kernel, plain)``."""
    sites = _kernel_sites() if sites is None else sites
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _, _ in sites]
    for mod, attr, name, plain in sites:
        setattr(mod, attr, make(name, getattr(mod, attr), plain))
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def plain_only(name, kernel, plain):
    return plain


def shadowed(stats: dict):
    """Run each kernel and then its plain version on the same inputs; keep
    the kernel's output and record the disagreement in ``stats``."""
    def make(name, kernel, plain):
        def run(*args, **kwargs):
            if name == "decode_megakernel":
                # K9 fills its cache arguments in place: the plain version gets copies
                ref = plain(*args[:3], *(t.clone() for t in args[3:7]), *args[7:], **kwargs)
                out = kernel(*args, **kwargs)
            else:
                out, ref = kernel(*args, **kwargs), plain(*args, **kwargs)
            st = stats.setdefault(name, {"calls": 0, "max_abs_err": 0.0})
            st["calls"] += 1
            if name == "decode_megakernel":
                st["max_rel_err"] = max(st.get("max_rel_err", 0.0), rel_err(out[0], ref[0]))
                err = (out[0].float() - ref[0].float()).abs().max().item()
            elif name == "fused_lmhead_sample":
                agree = (out[0] == ref[0]).float().mean().item()
                st["token_agree"] = min(st.get("token_agree", 1.0), agree)
                err = (out[1] - ref[1]).abs().max().item()
            else:
                o, r = (out[0], ref[0]) if isinstance(out, tuple) else (out, ref)
                err = (o.float() - r.float()).abs().max().item()
                st["max_rel_err"] = max(st.get("max_rel_err", 0.0), rel_err(o, r))
            st["max_abs_err"] = max(st["max_abs_err"], err)
            return out
        return run
    return make


def profile_window(fn, top: int = 10) -> dict:
    """Host time of one call of ``fn`` (no profiler), and the device time of
    its GPU kernels by name over a second call under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # "Command Buffer Full" is CUPTI's marker of a full launch queue, not a kernel
    events = [e for e in prof.key_averages()
              if e.device_time_total > 0 and e.key != "Command Buffer Full"]
    events.sort(key=lambda e: e.device_time_total, reverse=True)
    return {"wall_ms": wall_ms,
            "device_busy_ms": sum(e.device_time_total for e in events) / 1e3,
            "by_kernel_ms": {e.key[:60]: e.device_time_total / 1e3 for e in events[:top]}}


def idle_between(fn, name: str) -> dict:
    """The device's busy time and idle share over the span of a
    torch.profiler trace of one call of ``fn`` from the start of the first
    kernel whose name holds ``name`` to the end of the last: the kernels of
    that span (one stream) summed, against the span's length. A record lost
    at the start of the session falls before the span."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [(e.time_range.start, e.time_range.end, name in e.name) for e in prof.events()
               if e.device_type == DeviceType.CUDA and e.name != "Command Buffer Full"]
    marks = [(t0, t1) for t0, t1, hit in kernels if hit]
    if not marks:
        return {"launches_traced": 0, "idle_share": "not measured: no launch of " + name}
    lo, hi = min(t0 for t0, _ in marks), max(t1 for _, t1 in marks)
    busy = sum(min(t1, hi) - max(t0, lo) for t0, t1, _ in kernels if t1 > lo and t0 < hi)
    return {"launches_traced": len(marks), "span_ms": (hi - lo) / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1 - busy / (hi - lo)}


def device_ms_by_kernel(fn, calls: int):
    """({kernel: mean device ms of one launch}, {kernel: launches recorded})
    of the GPU kernels that ``fn`` launches, from a torch.profiler trace of
    ``calls`` calls after one untraced call. Each mean is over the launches
    the trace recorded, not the calls made: in a process that has already
    run profiler sessions, a new session can lose the first device records
    it should hold (every record of a session of two K6 calls), so the
    window holds several calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_time_total > 0 and e.key != "Command Buffer Full"]
    return ({e.key: e.device_time_total / 1e3 / e.count for e in events},
            {e.key: e.count for e in events})


# K7's and K8's kernels by the names the trace gives them
# (csrc/flash_attention_bwd.cu)
FLASH_BWD_KERNELS = (("dq", "flash_bwd_dq_kernel"), ("dkv", "flash_bwd_dkv_kernel"))


def flash_bwd_step(events) -> dict:
    """K7's and K8's device ms and launches in a trace's events (the
    profiler's key_averages), summed over the whole trace. Raises where the
    trace holds no time for one of them."""
    out = {}
    for p, name in FLASH_BWD_KERNELS:
        mine = [e for e in events if name in e.key]
        out[f"{p}_ms"] = sum(e.device_time_total for e in mine) / 1e3
        out[f"{p}_launches_traced"] = sum(e.count for e in mine)
        if not out[f"{p}_ms"] > 0:
            raise AssertionError(f"the trace holds no time for {name}: {[e.key for e in events]}")
    return out


# K6 calls in the trace that reads its passes apart (launches_traced tells
# how many of each pass's launches the trace kept), and the traces taken at
# most, each over twice the calls of the last, until every pass has records
K6_TRACED_CALLS = 8
K6_TRACES = 3
# K6's kernels by the names the trace gives them (csrc/linear_ce.cu; K5 is
# the same template's PASS 2)
K6_PASSES = (("pass_a", "ce_gemm_kernel<0"), ("pass_b", "ce_gemm_kernel<1"),
             ("merge", "dh_merge_kernel"))
# K5's kernels by the names the trace gives them
K5_KERNELS = ("ce_gemm_kernel<2", "ce_fwd_combine_kernel")


def k6_passes(by_kernel: dict, flop: float = 0.0) -> dict:
    """K6's pass A (dz), pass B (dh partials) and slice merge from a trace's
    time by kernel, and where ``flop`` is given the TFLOP/s of a pass that
    does that many operations. Raises where the trace holds no time for a
    pass."""
    out = {f"{p}_ms": sum(ms for key, ms in by_kernel.items() if name in key)
           for p, name in K6_PASSES}
    if not (out["pass_a_ms"] > 0 and out["pass_b_ms"] > 0):
        raise AssertionError(f"the trace holds no time for K6's passes: {sorted(by_kernel)}")
    if flop:
        for p in ("pass_a", "pass_b"):
            out[f"{p}_tflops"] = flop / out[f"{p}_ms"] / 1e9
    return out


def run_counted(kernels, fn):
    """Zero every launch count, run ``fn`` to completion, return
    (result, seconds, counts)."""
    for kern in kernels.values():
        kern.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return out, secs, {name: kern.launches for name, kern in kernels.items()}


def free_running_check(kerns, seed) -> dict:
    """Whole 16-token greedy runs, kernel path against plain path, at the
    configuration of the JAX package's on-chip gate check_q8_generate
    (2 layers, D=256, V=512, B=8, P=64), with its bar: token agreement
    > 0.95, logprob error < 0.15. At Qwen2-1.5B depth with random weights
    two plain paths already part after a few tokens (PERF.md, Findings), so
    there the gate is the per-call shadow check instead."""
    from rlinf_tpu_torch.models.llm import model as M
    from rlinf_tpu_torch.models.llm.config import LLMConfig
    from rlinf_tpu_torch.models.llm.quant import quantize_params
    from rlinf_tpu_torch.models.llm.sampler import SamplingParams, generate

    cfg = LLMConfig(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
                    num_kv_heads=2, head_dim=64, intermediate_size=512, max_seq_len=256)
    params = M.init_params(cfg, seed, device="cuda")
    qparams = quantize_params(params)
    rng = np.random.default_rng(seed + 5)
    ids = rng.integers(0, cfg.vocab_size, (8, 64))
    mask = np.ones((8, 64), bool)
    sp = SamplingParams(max_new_tokens=16, greedy=True, eos_token_id=-1)
    out = {}
    for kv in ("none", "int8"):
        def run():
            return generate(params, cfg, torch.Generator(), ids, mask, sp, attn_impl="pallas",
                            decode_params=qparams, decode_attn_impl="pallas", kv_quant=kv,
                            device="cuda")
        fast, _, counts = run_counted(kerns, run)
        with kernels_replaced(plain_only):
            plain = run()
        agree = (fast.response_ids == plain.response_ids).float().mean().item()
        lp_err = (fast.response_logprobs - plain.response_logprobs).abs().max().item()
        out[f"kv_{kv}"] = {"greedy_agree": agree, "lp_max_err": lp_err, "launches": counts}
        ran = [k for k, c in counts.items() if c]
        if not (agree > 0.95 and lp_err < 0.15 and len(ran) == 3):
            raise AssertionError(f"free-running greedy check failed (kv {kv}): {out[f'kv_{kv}']}")
    return out


# ---------------------------------------------------------------------------
# Phases 9-12: megakernel generate, the continuous and paged engines
# ---------------------------------------------------------------------------

def long_tail_mix(cfg, seed, n=128):
    """128 requests: prompts of 128-512 tokens, budgets spread over 32-256."""
    from rlinf_tpu_torch.data.io_struct import RolloutRequest

    r = np.random.default_rng(seed + 60)
    lens = r.integers(128, 513, n)
    budgets = [int(b) for b in r.integers(32, 257, n)]
    prompts = [list(map(int, r.integers(0, cfg.vocab_size, k))) for k in lens]
    return RolloutRequest(prompt_ids=prompts, max_new_tokens=budgets), budgets


def check_answers(res, budgets, V):
    lens = res.response_mask.sum(1)
    if not np.array_equal(lens, budgets):
        raise AssertionError(f"requests not answered with their budgets: {lens} vs {budgets}")
    lps = res.response_logprobs[res.response_mask]
    if not (np.isfinite(lps).all() and (lps <= 0).all()):
        raise AssertionError("logprobs must be finite and <= 0")
    if not ((res.response_ids >= 0) & (res.response_ids < V)).all():
        raise AssertionError("token ids out of range")


def timed(seen, key, fn):
    """``fn`` with its seconds on the host clock, device work included,
    added to ``seen[key]``."""
    def run(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        seen[key] = seen.get(key, 0.0) + time.perf_counter() - t0
        return out
    return run


def watch_engine(eng):
    """Count the engine's decode rounds, prefill calls and compactions, note
    the cache layout of every round (True = stacked), and time the three."""
    seen = {"decode_rounds": 0, "prefill_calls": 0, "compactions": 0, "stacked": [],
            "pool_sizes": []}
    harvest = timed(seen, "decode_s", eng.decode_and_harvest)
    refill = timed(seen, "prefill_s", eng._refill_impl)
    compact = timed(seen, "compact_s", eng.compact_pool)

    def on_harvest(pool, *a):
        seen["decode_rounds"] += 1
        seen["stacked"].append(eng._is_stacked(pool.kv_layers))
        seen["pool_sizes"].append(pool.size)
        t0 = seen.get("decode_s", 0.0)
        out = harvest(pool, *a)
        key = "stacked_decode_s" if seen["stacked"][-1] else "per_layer_decode_s"
        seen[key] = seen.get(key, 0.0) + seen["decode_s"] - t0
        return out

    def on_refill(*a):
        seen["prefill_calls"] += 1
        return refill(*a)

    def on_compact(pool):
        out = compact(pool)
        seen["compactions"] += out.size < pool.size
        return out

    eng.decode_and_harvest, eng._refill_impl, eng.compact_pool = on_harvest, on_refill, on_compact
    return seen


#: the engines phase's depth: the script's time limit (all 28 of
#: Qwen2-1.5B's layers until the expert axis's parts of phase 26 came, 14
#: until phase 28 came; the static rollout of phase 3 still runs all 28)
ENGINES_CUT = {"layers=7": "7 of Qwen2-1.5B's 28 layers: the script's time limit "
                           "(28 until phase 26's expert-axis parts came, then 14 until "
                           "phase 28 came)"}


def engine_phases(cfg, params, kerns, gpu, seed):
    """The continuous engine (a) through build_rollout_engine with the
    per-layer kernels, (b) with use_mega="auto" and the fused sampler, and
    the paged engine, all on one long-tail mix at full width and at the
    depth of ``ENGINES_CUT`` (the first layers of the main path's
    params)."""
    from rlinf_tpu_torch.config import RolloutConfig
    from rlinf_tpu_torch.data.io_struct import RolloutRequest
    from rlinf_tpu_torch.models.llm.sampler import SamplingParams
    from rlinf_tpu_torch.rollout import build_rollout_engine
    from rlinf_tpu_torch.rollout import continuous_engine as CE
    from rlinf_tpu_torch.rollout import paged_engine as PE

    L = int(next(iter(ENGINES_CUT)).split("=")[1])
    cfg = dataclasses.replace(cfg, num_layers=L)
    params = {**params, "blocks": {k: v[:L] for k, v in params["blocks"].items()}}
    request, budgets = long_tail_mix(cfg, seed)
    tokens = int(sum(budgets))
    sp = SamplingParams(max_new_tokens=256, temperature=1.0, eos_token_id=-1)

    def trainer_cfg(**ro):
        return types.SimpleNamespace(
            model=cfg, sampling=sp, attn_impl="pallas",
            rollout=RolloutConfig(num_slots=64, decode_chunk=16, prompt_bucket=64, **ro),
            data=types.SimpleNamespace(max_prompt_len=512),
            algorithm=types.SimpleNamespace(recompute_logprobs=None))

    out = {"phase": "engines", "gpu": gpu, "model": "qwen2_1_5b", "layers": L,
           "reduced": ENGINES_CUT,
           "requests": len(budgets), "generated_tokens": tokens, "slots": 64, "decode_chunk": 16}
    total = dict.fromkeys(kerns, 0)

    def run(name, eng, want, zero):
        seen = watch_engine(eng)
        res, secs, counts = run_counted(kerns, lambda: eng.rollout(
            params, request, torch.Generator().manual_seed(seed + 2)))
        check_answers(res, budgets, cfg.vocab_size)
        missing = [k for k in want if not counts[k]] + [k for k in zero if counts[k]]
        out[name] = {"seconds": secs, "generated_tokens_per_s": tokens / secs,
                     "decode_rounds": seen["decode_rounds"], "prefill_calls": seen["prefill_calls"],
                     "compactions": seen["compactions"], "pool_sizes": sorted(set(seen["pool_sizes"])),
                     "stacked_rounds": sum(seen["stacked"]),
                     **{k: v for k, v in seen.items() if k.endswith("_s")}, "launches": counts}
        for k, c in counts.items():
            total[k] += c
        if missing or seen["prefill_calls"] < 2:
            raise AssertionError(f"{name}: launch gate failed on {missing}: {out[name]}")
        return seen, counts

    # (a) engine="auto" resolves to the continuous engine
    eng = build_rollout_engine(trainer_cfg(engine="auto", weight_quant="int8", kv_quant="int8"),
                               device="cuda")
    if type(eng) is not CE.ContinuousBatchingEngine:
        raise AssertionError(f"engine='auto' built {type(eng)}")
    run("continuous_per_layer", eng, ("flash_attention_fwd", "decode_attention_q8"),
        ("decode_megakernel", "decode_attention_bf16", "paged_attention"))
    del eng

    # (b) hybrid: per-layer kernels on the large pool, K9 after compaction
    eng = CE.ContinuousBatchingEngine(
        cfg, sp, num_slots=64, max_seq_len=768, prompt_bucket=64, decode_chunk=16,
        weight_quant="int8", kv_quant="int8", decode_attn_impl="pallas", attn_impl="pallas",
        use_mega="auto", mega_threshold=32, sampler_impl="fused", device="cuda")
    slot_dims = set()
    real_step = CE.decode_step_mega

    def noting_step(*a):
        slot_dims.add(a[7].ndim if torch.is_tensor(a[7]) else 0)
        return real_step(*a)

    CE.decode_step_mega = noting_step
    try:
        seen, counts = run(
            "continuous_hybrid", eng,
            ("flash_attention_fwd", "decode_attention_q8", "fused_lmhead_sample",
             "decode_megakernel"), ("decode_attention_bf16", "paged_attention"))
    finally:
        CE.decode_step_mega = real_step
    if set(seen["stacked"]) != {False, True} or slot_dims != {1}:
        raise AssertionError(f"hybrid engine: layouts {set(seen['stacked'])}, "
                             f"write_pos dims {slot_dims}")
    if counts["decode_megakernel"] != 16 * sum(seen["stacked"]):
        raise AssertionError(f"K9 launches {counts['decode_megakernel']} for "
                             f"{sum(seen['stacked'])} stacked rounds of 16 steps")
    del eng
    torch.cuda.empty_cache()

    # the paged engine, page pool watched
    class WatchedPool(PE.PagePool):
        made = []

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.peak = 0
            WatchedPool.made.append(self)

        def append_tokens_chunk(self, *a):
            res = super().append_tokens_chunk(*a)
            self.peak = max(self.peak, self.num_pages - 1 - self.free_pages)
            return res

    eng = build_rollout_engine(trainer_cfg(engine="paged", page_size=16), device="cuda")
    if type(eng) is not PE.PagedContinuousEngine or eng.attn_impl != "pallas":
        raise AssertionError(f"engine='paged' built {type(eng)} with {eng.attn_impl}")
    rounds, split = [], {}
    decode = timed(split, "decode_s", eng._decode_paged_impl)
    eng._decode_paged_impl = lambda *a: (rounds.append(a[-1]), decode(*a))[1]
    eng._prefill_paged_impl = timed(split, "prefill_s", eng._prefill_paged_impl)
    real_pool, PE.PagePool = PE.PagePool, WatchedPool
    try:
        res, secs, counts = run_counted(kerns, lambda: eng.rollout(
            params, request, torch.Generator().manual_seed(seed + 3)))
    finally:
        PE.PagePool = real_pool
    check_answers(res, budgets, cfg.vocab_size)
    pool = WatchedPool.made[-1]
    out["paged"] = {"seconds": secs, "generated_tokens_per_s": tokens / secs,
                    "decode_rounds": len(rounds), "decode_steps": sum(rounds), **split,
                    "pages": pool.num_pages, "peak_pages_in_use": pool.peak,
                    "free_pages_at_end": pool.free_pages, "launches": counts,
                    "prefill_attention": "plain (as the JAX engine)"}
    for k, c in counts.items():
        total[k] += c
    want = {**dict.fromkeys(kerns, 0), "paged_attention": L * sum(rounds)}
    if counts != want or pool.free_pages != pool.num_pages - 1:
        raise AssertionError(f"paged engine: launches {counts}, expected {want}; "
                             f"{pool.free_pages} of {pool.num_pages - 1} pages free at the end")
    # the device's idle share while it decodes: the first 64 requests with
    # budgets of 33 tokens (the prefill's and two rounds of 16 steps), traced
    short = RolloutRequest(prompt_ids=request.prompt_ids[:64], max_new_tokens=[33] * 64)
    out["paged"]["decode_trace"] = idle_between(
        lambda: eng.rollout(params, short, torch.Generator()), "paged_split_kernel")
    emit(out)
    return total


def small_engine_checks(kerns, seed) -> dict:
    """Whole greedy runs at small size, kernels against the plain paths from
    the same params, at the configurations of the JAX package's on-chip
    gates and with their bars: check_megakernel_generate (agreement > 0.9,
    against the plain megakernel path and against the per-layer int8 path),
    check_mega_engine (hybrid engine: lengths equal, agreement > 0.9, both
    layouts seen), check_paged_kernel (K10 error < 0.01) and the paged
    engine against the dense continuous engine on its plain decode
    attention (_engine_parity: token match > 0.995, logprob diff < 0.02)."""
    from rlinf_tpu_torch.data.io_struct import RolloutRequest
    from rlinf_tpu_torch.models.llm import model as M
    from rlinf_tpu_torch.models.llm.config import LLMConfig
    from rlinf_tpu_torch.models.llm.quant import quantize_params
    from rlinf_tpu_torch.models.llm.sampler import SamplingParams, generate
    from rlinf_tpu_torch.ops.cuda import decode_megakernel as MK
    from rlinf_tpu_torch.ops.cuda import paged_attention as PA
    from rlinf_tpu_torch.rollout.continuous_engine import ContinuousBatchingEngine
    from rlinf_tpu_torch.rollout.paged_engine import PagedContinuousEngine

    out = {}
    sites = _engine_sites()
    cfg = LLMConfig(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
                    num_kv_heads=2, head_dim=64, intermediate_size=512, max_seq_len=256)

    # check_megakernel_generate
    params = M.init_params(cfg, seed, device="cuda")
    qparams = quantize_params(params)
    mega = MK.pack_decode_weights(qparams, cfg, chunk_width=256)
    r = np.random.default_rng(seed + 5)
    ids, mask = r.integers(0, cfg.vocab_size, (8, 64)), np.ones((8, 64), bool)
    sp = SamplingParams(max_new_tokens=16, greedy=True, eos_token_id=-1)

    def gen(m):
        return generate(params, cfg, torch.Generator(), ids, mask, sp, attn_impl="pallas",
                        decode_params=qparams, decode_attn_impl="pallas", kv_quant="int8",
                        mega=m, sampler_impl="xla", device="cuda")

    fast, _, counts = run_counted(kerns, lambda: gen(mega))
    per_layer = gen(None)
    with kernels_replaced(plain_only, sites):
        plain = gen(mega)
    agree = lambda a, b: (a.response_ids == b.response_ids).float().mean().item()
    out["megakernel_generate"] = {
        "vs_plain_megakernel_path": agree(fast, plain), "vs_per_layer_q8_kernels": agree(fast, per_layer),
        "launches": {k: c for k, c in counts.items() if c}}
    if not (agree(fast, plain) > 0.9 and agree(fast, per_layer) > 0.9
            and counts["decode_megakernel"] == 15 and counts["decode_attention_q8"] == 0):
        raise AssertionError(f"small megakernel generate check failed: {out}")

    # check_mega_engine
    params = M.init_params(cfg, seed + 3, device="cuda")
    sp = SamplingParams(max_new_tokens=32, greedy=True, eos_token_id=-1, pad_token_id=0)
    r = np.random.default_rng(11)
    budgets = [4, 8, 8, 16] * 4
    request = RolloutRequest(
        prompt_ids=[list(map(int, r.integers(2, 500, int(r.integers(4, 24))))) for _ in range(16)],
        max_new_tokens=budgets)

    def engine_run(use_mega):
        eng = ContinuousBatchingEngine(
            cfg, sp, num_slots=16, max_seq_len=128, prompt_bucket=32, decode_chunk=4,
            weight_quant="int8", kv_quant="int8", decode_attn_impl="pallas", attn_impl="pallas",
            use_mega=use_mega, mega_chunk_width=256, mega_threshold=8, device="cuda")
        seen = watch_engine(eng)
        return eng.rollout(params, request, torch.Generator()), seen

    (hybrid, seen), _, counts = run_counted(kerns, lambda: engine_run("auto"))
    per_layer, _ = engine_run(False)
    with kernels_replaced(plain_only, sites):
        plain, _ = engine_run("auto")

    def engine_agree(a, b):
        if not np.array_equal(a.response_lengths, b.response_lengths):
            raise AssertionError("hybrid engine: response lengths differ")
        return float((a.response_ids == b.response_ids)[a.response_mask].mean())

    out["mega_engine"] = {
        "vs_plain_paths": engine_agree(hybrid, plain),
        "vs_per_layer_q8_engine": engine_agree(hybrid, per_layer),
        "layouts_seen": sorted(set(seen["stacked"])),
        "launches": {k: c for k, c in counts.items() if c}}
    if not (out["mega_engine"]["vs_plain_paths"] > 0.9
            and out["mega_engine"]["vs_per_layer_q8_engine"] > 0.9
            and set(seen["stacked"]) == {False, True} and counts["decode_megakernel"] > 0
            and np.array_equal(hybrid.response_lengths, budgets)):
        raise AssertionError(f"small hybrid engine check failed: {out['mega_engine']}")

    # check_paged_kernel
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, H, Kv, Hd, Pg, n_pages, max_pages = 8, 4, 2, 64, 16, 64, 8
    rn = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    q = rn(B, H, Hd).to(torch.bfloat16)
    kp, vp = ((rn(n_pages, Kv, Pg, Hd) * 0.3).to(torch.bfloat16) for _ in range(2))
    table = torch.randint(0, n_pages, (B, max_pages), generator=g, device="cuda", dtype=torch.int32)
    lengths = ((torch.arange(B, device="cuda") * 13) % (Pg * max_pages - 2) + 1).to(torch.int32)
    err = (PA.paged_attention(q, kp, vp, table, lengths).float()
           - PA.paged_attention_xla(q, kp, vp, table, lengths).float()).abs().max().item()
    out["paged_kernel"] = {"max_err": err}
    if not err < 0.01:
        raise AssertionError(f"small paged kernel check failed: {err}")

    # the paged engine against the dense continuous engine (_engine_parity)
    cfg = LLMConfig(vocab_size=256, hidden_size=256, num_layers=2, num_heads=4,
                    num_kv_heads=2, head_dim=64, intermediate_size=512, max_seq_len=256)
    params = M.init_params(cfg, seed + 5, device="cuda")
    sp = SamplingParams(max_new_tokens=16, temperature=1.0, greedy=True, eos_token_id=-1)
    r = np.random.default_rng(7)
    request = RolloutRequest(prompt_ids=[
        list(map(int, r.integers(2, 255, int(r.integers(4, 30))))) for _ in range(16)])
    kw = dict(num_slots=16, max_seq_len=64, prompt_bucket=32, decode_chunk=8, device="cuda")
    dense = ContinuousBatchingEngine(cfg, sp, weight_quant="none", decode_attn_impl="xla",
                                     **kw).rollout(params, request, torch.Generator())
    paged, _, counts = run_counted(kerns, lambda: PagedContinuousEngine(
        cfg, sp, page_size=16, attn_impl="pallas", **kw).rollout(params, request, torch.Generator()))
    match = float(np.mean((dense.response_ids == paged.response_ids) | ~dense.response_mask))
    lp_diff = float(np.abs(np.where(dense.response_mask, dense.response_logprobs, 0.0)
                           - np.where(paged.response_mask, paged.response_logprobs, 0.0)).max())
    out["paged_vs_dense_engine"] = {"token_match": match, "max_logprob_diff": lp_diff,
                                    "paged_attention_launches": counts["paged_attention"]}
    if not (match > 0.995 and lp_diff < 0.02 and counts["paged_attention"] > 0):
        raise AssertionError(f"paged engine against the dense engine: {out['paged_vs_dense_engine']}")
    return out


# ---------------------------------------------------------------------------
# Phases 6 and 7: the training path
# ---------------------------------------------------------------------------

def _training_sites():
    """(module, attribute, kernel name, plain version) of every kernel
    wrapper that the training path's autograd Functions call."""
    from rlinf_tpu_torch.ops.cuda import flash_attention as FA
    from rlinf_tpu_torch.ops.cuda import linear_ce as LCE

    return [(FA, "flash_attention_fwd", "flash_attention_fwd", FA.flash_attention_fwd_plain),
            (FA, "flash_attention_bwd", "flash_attention_bwd", FA.flash_attention_bwd_plain),
            (LCE, "ce_forward", "linear_ce_fwd", LCE.ce_forward_plain),
            (LCE, "ce_backward", "linear_ce_bwd", LCE.ce_backward_plain)]


# the kernels the logprob recompute (a forward pass) launches
RECOMPUTE_KERNELS = ("flash_attention_fwd", "linear_ce_fwd")
TRAIN_KERNELS = ("flash_attention_fwd", "linear_ce_fwd", "linear_ce_bwd",
                 "flash_attention_bwd_dq", "flash_attention_bwd_dkv")


def reward_rule(response_ids, response_mask):
    """The rule rewards of the training phases, which run without a
    tokenizer: 1.0 where more than half of a response's tokens have an even
    id, else 0.0 (the runner phase grades texts: ``text_rule``)."""
    even = ((response_ids % 2 == 0) & response_mask).sum(-1)
    return (even * 2 > response_mask.sum(-1)).astype(np.float32)


TRAIN_STEPS = 4


class StepWatch:
    """What the host did in one train step besides dispatch: the caching
    allocator's device allocations and retries, and the garbage collector's
    pauses."""

    def __init__(self):
        self.gc_s, self._t = 0.0, None
        gc.callbacks.append(self._on_gc)

    def _on_gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.gc_s += time.perf_counter() - self._t
            self._t = None

    def step(self, fn):
        """Run ``fn`` to completion -> (its result, the step's record)."""
        before = torch.cuda.memory_stats()
        self.gc_s = 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        after = torch.cuda.memory_stats()
        return out, {"seconds": secs, "gc_pause_s": self.gc_s, **{
            k: after.get(k, 0) - before.get(k, 0)
            for k in ("num_device_alloc", "num_device_free", "num_alloc_retries")}}

    def close(self):
        gc.callbacks.remove(self._on_gc)


def training_path(cfg, params, rollout, kerns, gpu, seed):
    """GRPO on the serving phase's rollout: rule rewards, GRPO advantages
    over 8 groups of 8, build_train_batch, the logprob recompute, then
    TRAIN_STEPS train steps (remat, attn_impl="pallas", 4 microbatches,
    adamw with master weights, entropy bonus 1e-3) through the public entry
    points. The steps after the first give the step time: their median."""
    from rlinf_tpu_torch.algorithms import get_advantage_fn
    from rlinf_tpu_torch.config import (
        AlgorithmConfig, RunnerConfig, TrainerConfig, validate_config,
    )
    from rlinf_tpu_torch.data.io_struct import build_train_batch
    from rlinf_tpu_torch.training.learner import (
        PolicyLossConfig, make_logprob_fn, make_policy_train_step,
    )
    from rlinf_tpu_torch.training.train_state import OptimizerConfig, TrainState, make_optimizer

    tcfg = TrainerConfig(
        model=cfg, attn_impl="pallas", remat=True, num_microbatches=4,
        optimizer=OptimizerConfig(name="adamw", lr=1e-6, master_weights=True),
        loss=PolicyLossConfig(entropy_bonus=1e-3),
        algorithm=AlgorithmConfig(adv_type="grpo", group_size=8),
        runner=RunnerConfig(rollout_batch_size=8))
    validate_config(tcfg)
    G = tcfg.algorithm.group_size
    rewards = reward_rule(rollout.response_ids, rollout.response_mask)
    adv, _ = get_advantage_fn(tcfg.algorithm.adv_type)(
        rewards=torch.as_tensor(rewards), loss_mask=torch.as_tensor(rollout.response_mask.T),
        group_size=G)
    batch = build_train_batch(rollout, adv.T.numpy(), pad_id=0, seq_bucket=128)
    B, T = batch.input_ids.shape
    tokens = int(batch.attention_mask.sum())

    tx = make_optimizer(tcfg.optimizer)
    logprob_fn = make_logprob_fn(cfg, chunk_size=tcfg.loss.logprob_chunk_size,
                                 attn_impl=tcfg.attn_impl, device="cuda")
    step_fn = make_policy_train_step(cfg, tcfg.loss, tx, num_microbatches=tcfg.num_microbatches,
                                     remat=tcfg.remat, attn_impl=tcfg.attn_impl, device="cuda")
    watch = {k: params["blocks"][k][0].flatten()[:4096].clone() for k in ("wq", "down")}
    watch["embed"] = params["embed"][:64].clone()
    torch.cuda.reset_peak_memory_stats()
    times, metrics, steps = {}, [], []
    watch_host = StepWatch()

    def run():
        t0 = time.perf_counter()
        lp, _ = logprob_fn(params, batch.to_dict())
        torch.cuda.synchronize()
        times["recompute_s"] = time.perf_counter() - t0
        times["recompute_launches"] = {name: kern.launches for name, kern in kerns.items()}
        lp = lp.cpu().numpy()
        times["recompute_vs_rollout_lp"] = {
            "max_abs": float(np.abs(lp - batch.old_logprobs)[batch.loss_mask].max()),
            "mean_abs": float(np.abs(lp - batch.old_logprobs)[batch.loss_mask].mean())}
        batch.old_logprobs = np.where(batch.loss_mask, lp, 0.0).astype(np.float32)
        state = TrainState(0, params, tx.init(params))
        for i in range(1, TRAIN_STEPS + 1):
            (state, m), rec = watch_host.step(lambda: step_fn(state, batch.to_dict()))
            steps.append(rec)
            metrics.append({k: float(v) for k, v in m.items()})
            if i == 1:
                times["moved_after_step1"] = {
                    k: bool((w != (params["embed"][:64] if k == "embed" else
                                   params["blocks"][k][0].flatten()[:4096])).any())
                    for k, w in watch.items()}
        return state

    state, secs, counts = run_counted(kerns, run)
    watch_host.close()
    later = sorted(r["seconds"] for r in steps[1:])
    step_s = later[len(later) // 2]
    out = {"phase": "training", "gpu": gpu, "model": "qwen2_1_5b", "layers": cfg.num_layers,
           "batch": B, "seq_len": T, "train_tokens": tokens, "num_microbatches": 4,
           "rewards_mean": float(rewards.mean()), "seconds": secs, **times,
           "steps": steps, "step_s_median": step_s, "step_s_min": later[0],
           "train_tokens_per_s": tokens / step_s,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2**30,
           "metrics": metrics, "launches": counts}
    emit(out)
    recompute = times["recompute_launches"]
    missing = [k for k in TRAIN_KERNELS if not counts[k] - recompute[k]]
    missing += [f"recompute: {k}" for k in RECOMPUTE_KERNELS if not recompute[k]]
    bad = [k for m in metrics for k in ("actor/loss", "actor/grad_norm")
           if not np.isfinite(m[k])]
    if missing:
        raise AssertionError(f"training path did not launch {missing}: {counts}")
    if bad:
        raise AssertionError(f"non-finite training metrics: {bad}")
    if not abs(metrics[0]["actor/approx_kl"]) < 1e-3:
        raise AssertionError(f"step-1 approx_kl {metrics[0]['actor/approx_kl']} >= 1e-3")
    if not all(times["moved_after_step1"].values()):
        raise AssertionError(f"params did not move in step 1: {times['moved_after_step1']}")
    return state, batch, step_fn, counts


def profile_train_step(state, batch, step_fn, top: int = 12) -> dict:
    """Device time by kernel over one more train step under torch.profiler:
    the ``top`` kernels, every kernel of the port, K6's passes (the mean of
    one launch, and the launches the trace holds) and K7's and K8's time a
    step and launches, all read from the whole trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step_fn(state, batch.to_dict())
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_time_total > 0 and e.key != "Command Buffer Full"]
    events.sort(key=lambda e: e.device_time_total, reverse=True)
    busy = sum(e.device_time_total for e in events) / 1e3
    port = [e for e in events if "(anonymous namespace)::" in e.key]
    k6 = k6_passes({e.key: e.device_time_total / 1e3 / e.count for e in events})
    k6["launches_traced"] = {p: sum(e.count for e in events if name in e.key)
                             for p, name in K6_PASSES}
    k5 = [e for e in events if any(name in e.key for name in K5_KERNELS)]
    k5_step = {"ms": sum(e.device_time_total for e in k5) / 1e3,
               "launches_traced": {e.key[:60]: e.count for e in k5}}
    return {"phase": "train_profile", "wall_ms_under_profiler": wall_ms, "device_busy_ms": busy,
            "by_kernel_ms": {e.key[:60]: e.device_time_total / 1e3 for e in events[:top]},
            "by_kernel_calls": {e.key[:60]: e.count for e in events[:top]},
            "port_kernels_ms": {e.key[:60]: e.device_time_total / 1e3 for e in port},
            "port_kernels_calls": {e.key[:60]: e.count for e in port},
            "k5_step": k5_step, "k6_step_ms": k6, "k7_k8_step": flash_bwd_step(events)}


def whole_step_check(kerns, seed) -> dict:
    """One make_policy_train_step at the configuration of the JAX package's
    check_q8_generate (2 layers, D=256, V=512, bf16), kernels against the
    plain path from the same params and batch. Bar: loss and grad norm
    within 1e-2 relative; over all parameters together, the master-weight
    update within 5e-2 of its norm and the bf16 params within 1e-2 of
    theirs. Adam's eps is 1e-3 here: its first step is g / (|g| + eps), and
    with eps = 1e-8 a gradient that is rounding noise on both paths (the k
    bias's is exactly zero in exact arithmetic) moves by +-lr either way."""
    from rlinf_tpu_torch.models.llm import model as M
    from rlinf_tpu_torch.models.llm.config import LLMConfig
    from rlinf_tpu_torch.training.learner import PolicyLossConfig, make_policy_train_step
    from rlinf_tpu_torch.training.train_state import (
        OptimizerConfig, TrainState, make_optimizer, tree_leaves,
    )

    cfg = LLMConfig(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
                    num_kv_heads=2, head_dim=64, intermediate_size=512, max_seq_len=256)
    r = np.random.default_rng(seed + 7)
    B, T = 8, 128
    lens = r.integers(T // 2, T + 1, B)
    attn = np.arange(T)[None, :] < lens[:, None]
    loss_mask = attn & (np.arange(T)[None, :] >= 32)
    batch = {"input_ids": r.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
             "target_ids": r.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
             "attention_mask": attn, "loss_mask": loss_mask,
             "old_logprobs": np.where(loss_mask, -np.log(cfg.vocab_size), 0).astype(np.float32),
             "advantages": (r.normal(size=(B, T)) * loss_mask).astype(np.float32)}
    runs = {}
    for mode in ("kernels", "plain"):
        params = M.init_params(cfg, seed, device="cuda")
        p0 = [p.float().clone() for p in tree_leaves(params)]
        tx = make_optimizer(OptimizerConfig(lr=1e-4, eps=1e-3, master_weights=True))
        step = make_policy_train_step(cfg, PolicyLossConfig(entropy_bonus=1e-3), tx,
                                      num_microbatches=2, remat=True, attn_impl="pallas",
                                      device="cuda")
        with (kernels_replaced(plain_only, _training_sites()) if mode == "plain"
              else contextlib.nullcontext()):
            (state, m), _, counts = run_counted(
                kerns, lambda: step(TrainState(0, params, tx.init(params)), batch))
        ran = [k for k in TRAIN_KERNELS if counts[k]]
        if ran != (list(TRAIN_KERNELS) if mode == "kernels" else []):
            raise AssertionError(f"whole-step check, {mode} run launched {counts}")
        runs[mode] = (state, m, p0)
    (ks, km, p0), (ps, pm, _) = runs["kernels"], runs["plain"]
    rel = lambda a, b: abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
    flat = lambda ts: torch.cat([t.float().flatten() for t in ts])
    km_, pm_ = (flat(tree_leaves(x)) for x in (ks.opt_state["master"], ps.opt_state["master"]))
    z = flat(p0)
    upd = (torch.linalg.vector_norm(km_ - pm_) / torch.linalg.vector_norm(pm_ - z)).item()
    kp, pp = flat(tree_leaves(ks.params)), flat(tree_leaves(ps.params))
    par = (torch.linalg.vector_norm(kp - pp) / torch.linalg.vector_norm(pp)).item()
    out = {"loss_rel": rel(km["actor/loss"], pm["actor/loss"]),
           "grad_norm_rel": rel(km["actor/grad_norm"], pm["actor/grad_norm"]),
           "master_update_rel": upd, "params_rel": par,
           "loss": float(km["actor/loss"]), "grad_norm": float(km["actor/grad_norm"])}
    if not (out["loss_rel"] < 1e-2 and out["grad_norm_rel"] < 1e-2 and upd < 5e-2
            and par < 1e-2):
        raise AssertionError(f"whole-step check failed: {out}")
    return out


# ---------------------------------------------------------------------------
# Phase 13: the reasoning runner, whole GRPO steps through main_grpo
# ---------------------------------------------------------------------------

RUNNER_YAML = "examples/reasoning/config/grpo_math_qwen05b.yaml"
# the yaml's traffic, cut to a short run: each override and why
#: the runner phase's depth: the script's time limit (all 24 layers until
#: phase 26's parts came, 12 until its expert-axis parts came, 8 until
#: phase 28 came; phase 26 itself runs 2, DRILL_CUT)
RUNNER_CUT = {"model.num_layers=4": "4 of Qwen2.5-0.5B's 24 layers: the script's time limit "
                                    "(24 until phase 26's parts came, then 12, then 8 until "
                                    "phase 28 came)"}
RUNNER_REDUCED = {
    "runner.rollout_batch_size=8": "8 prompts x group_size 8 = 64 rows a step "
                                   "(the yaml: 64 prompts, 512 rows)",
    "sampling.max_new_tokens=256": "the yaml has 1024",
    "rollout.num_slots=64": "one wave: a slot for every row",
    "runner.max_steps=3": "the yaml has 400",
    "runner.save_interval=3": "one checkpoint, at the last step (the yaml: every 50)",
}
# what a step of the runner launches at this config: K1 (prefill, the
# recompute, the train forward), K2 (decode on the bf16 cache), K5 and K6
# (the recompute's and the loss's lm head), K7 and K8 (the flash backward)
RUNNER_KERNELS = ("flash_attention_fwd", "decode_attention_bf16", "linear_ce_fwd",
                  "linear_ce_bwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
RUNNER_METRICS = ("time/rollout", "time/reward", "time/training", "time/step",
                  "perf/gen_tokens_per_s", "perf/train_tokens_per_s", "perf/train_tflops_per_s",
                  "perf/e2e_tokens_per_s", "actor/approx_kl", "actor/grad_norm", "actor/loss",
                  "actor/num_dyn_microbatches", "rollout/reward_mean", "rollout/reward_std",
                  "rollout/advantage_std", "rollout/response_len_mean",
                  "rollout/response_len_max", "rollout/prompt_len_mean")
# step 1's drift between the engine's behaviour logprobs (int8 weights, bf16
# cache, K2) and the recompute on the training path (bf16 weights, K1, K5),
# |delta| in nats over the response tokens, with the kernels and with their
# plain versions on the same rollout
DRIFT_BAR = {"mean_abs": 0.05, "max_abs": 1.0}
# the shadow step: one _train_on_result from one state on one rollout, the
# kernels against their plain versions. The loss bar is absolute: GRPO's
# advantages sum to 0 over a group, so on rows of equal length the loss is a
# near-zero sum. Adam's first moment (the gradients' direction) and the f32
# updates the optimizer hands to the params, summed over the step's
# minibatches: norm of the difference over the norm of the plain run's.
# The params themselves move by under a bf16 step for most weights at the
# yaml's lr (2e-6, reached after its 10 warmup updates, 4 a step), so they
# are held through the f32 updates, and the step must change some of them
# (zero-initialised biases and the smallest weights move).
# The first-moment and update bars are 1.5x the largest of their readings
# on an H100 (first moment 2.97%, 2.83% at seed 0 and 2.71% at seed 1;
# updates 5.74%, 5.91%; PERF.md, Findings).
SHADOW_BARS = {"logprob_max_abs": 0.1, "loss_abs": 1e-2, "grad_norm_rel": 2e-2,
               "first_moment_rel": 4.5e-2, "update_rel": 9e-2}


def text_rule(texts, answers):
    """The shadow step's rewards: 1.0 where a response decodes to some text,
    else 0.0. With random weights the byte tokenizer decodes ~0.17% of the
    tokens (256 byte ids of 151,936), so about a third of the 256-token
    responses have text and the groups' rewards are mixed; the math
    verifier scores every one 0, which makes the update vacuous."""
    return [float(len(t) > 0) for t in texts]


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(clone_tree(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def state_differences(a, b) -> list:
    """Paths at which two state trees differ: structure, dtype, shape or
    any bit."""
    from rlinf_tpu_torch.utils.checkpoint import flatten

    fa, fb = flatten(a), flatten(b)
    bad = sorted(set(fa) ^ set(fb))
    for k in sorted(set(fa) & set(fb)):
        x, y = fa[k], fb[k]
        if isinstance(x, torch.Tensor):
            same = (isinstance(y, torch.Tensor) and x.dtype == y.dtype
                    and x.shape == y.shape and torch.equal(x, y))
        else:
            same = type(x) is type(y) and x == y
        if not same:
            bad.append(k)
    return bad


def norm_rel(a, b) -> float:
    """|| a - b || / || b || over the tensors of two trees together."""
    from rlinf_tpu_torch.utils.checkpoint import flatten

    num = den = 0.0
    for x, y in zip(flatten(a).values(), flatten(b).values()):
        if isinstance(x, torch.Tensor):
            num += (x.float() - y.float()).square().sum().item()
            den += y.float().square().sum().item()
    return (num / max(den, 1e-30)) ** 0.5


def tree_norm(tree) -> float:
    from rlinf_tpu_torch.utils.checkpoint import flatten

    return sum(x.float().square().sum().item() for x in flatten(tree).values()) ** 0.5


def behaviour_drift(runner, result, lp=None) -> dict:
    """|behaviour - recompute| logprob over the response tokens of
    ``result``: with ``lp`` (the runner's own recompute, [B, T]) or a
    recompute on the runner's params."""
    from rlinf_tpu_torch.data.io_struct import build_train_batch

    tb = build_train_batch(result, np.zeros(result.response_ids.shape, np.float32),
                           pad_id=runner.cfg.sampling.pad_token_id)
    if lp is None:
        lp, _ = runner.logprob_fn(runner._policy_params(), runner._put_batch(tb.to_dict()))
    d = np.abs(lp.float().cpu().numpy() - tb.old_logprobs)[tb.loss_mask]
    return {"mean_abs": float(d.mean()), "max_abs": float(d.max()), "tokens": int(d.size)}


def timed_calls(fn, seconds: list):
    """``fn`` that appends each call's seconds (synchronised) to ``seconds``."""
    def run(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out
    return run


@contextlib.contextmanager
def watching_runner(record: dict):
    """For one main_grpo run: keep the runner and step 1's rollout, measure
    step 1's drift with the plain versions (no launch) before the update,
    and record each step's recompute (its seconds; step 1's logprobs) and
    each separate-critic step's seconds."""
    import copy

    from rlinf_tpu_torch.runners import reasoning_runner as RR

    orig = RR.ReasoningRunner._train_on_result

    def train_on_result(self, result):
        if "runner" not in record:
            record["runner"], record["result"] = self, copy.deepcopy(result)
            if self.logprob_fn is None:
                raise AssertionError("the watched run has no logprob recompute")
            with kernels_replaced(plain_only, _training_sites()):
                record["drift_plain"] = behaviour_drift(self, result)
            inner = timed_calls(self.logprob_fn, record.setdefault("recompute_s", []))

            def logprob_fn(params, batch):
                out = inner(params, batch)
                if "lp" not in record:
                    record["lp"] = out[0].float().cpu()
                return out

            self.logprob_fn = logprob_fn
            record["critic_step_s"] = []
            if self.separate_critic:
                self.critic_step = timed_calls(self.critic_step, record["critic_step_s"])
        return orig(self, result)

    RR.ReasoningRunner._train_on_result = train_on_result
    try:
        yield
    finally:
        RR.ReasoningRunner._train_on_result = orig


@contextlib.contextmanager
def summing_updates(total: list):
    """Sum, in f32, every update the optimizer hands to the params (one a
    minibatch) into ``total`` (a list that holds the running tree): the
    policy's, the actor-critic's, the separate critic's, the LoRA and the
    SFT steps."""
    from rlinf_tpu_torch.training import critic, learner, lora_learner, sft
    from rlinf_tpu_torch.training.train_state import tree_map

    mods = (learner, critic, lora_learner, sft)
    orig = learner.apply_updates

    def apply_updates(params, updates):
        with torch.no_grad():
            if total:
                tree_map(lambda a, u: a.add_(u.float()), total[0], updates)
            else:
                total.append(tree_map(lambda u: u.float().clone(), updates))
        orig(params, updates)

    for m in mods:
        m.apply_updates = apply_updates
    try:
        yield
    finally:
        for m in mods:
            m.apply_updates = orig


def moved_share(a, b) -> float:
    """Share of the elements of tree ``a`` that differ from ``b``'s."""
    from rlinf_tpu_torch.utils.checkpoint import flatten

    n = moved = 0
    for x, y in zip(flatten(a).values(), flatten(b).values()):
        n += x.numel()
        moved += int((x != y).sum().item())
    return moved / max(n, 1)


def shadow_step(runner, result, kerns) -> dict:
    """One ``_train_on_result`` on ``result`` from the runner's state, run
    twice: with every training kernel replaced by its plain version, then
    with the kernels; the same permutation, the rule rewards of
    ``text_rule``. The runner keeps the kernels' run's state and step (one
    step on); its reward function, logger, checkpoints and recompute are
    put back."""
    import copy

    from rlinf_tpu_torch.data.io_struct import build_train_batch
    from rlinf_tpu_torch.utils.metrics import MetricLogger

    start, perm_state, step0 = clone_tree(runner.state), runner._perm_gen.get_state(), runner.global_step
    saved = {k: getattr(runner, k) for k in ("reward_fn", "logger", "ckpt", "logprob_fn")}
    runner.reward_fn, runner.logger, runner.ckpt = text_rule, MetricLogger(None, print_every=0), None
    runs = {}
    try:
        for mode in ("plain", "kernels"):
            runner.state = clone_tree(start)
            runner._perm_gen.set_state(perm_state)
            runner.global_step = step0
            seen, updates = {"lp": [], "adv": []}, []

            def lp_fn(params, batch, seen=seen):
                out = saved["logprob_fn"](params, batch)
                seen["lp"].append(out[0].float().cpu())
                return out

            def adv_fn(res, rewards, seen=seen):
                adv = type(runner)._compute_advantages(runner, res, rewards)
                seen["adv"].append(adv)
                return adv

            runner.logprob_fn, runner._compute_advantages = lp_fn, adv_fn
            res = copy.deepcopy(result)
            with (kernels_replaced(plain_only, _training_sites()) if mode == "plain"
                  else contextlib.nullcontext()), summing_updates(updates):
                m, secs, counts = run_counted(kerns, lambda: runner._train_on_result(res))
            runs[mode] = dict(m=m, rewards=res.rewards, adv=seen["adv"][0], lp=seen["lp"][0],
                              state=runner.state, updates=updates[0], counts=counts, seconds=secs,
                              moved=moved_share(runner.state.params, start.params))
    finally:
        for k, v in saved.items():
            setattr(runner, k, v)
        vars(runner).pop("_compute_advantages", None)
    k, p = runs["kernels"], runs["plain"]
    mask = build_train_batch(result, np.zeros(result.response_ids.shape, np.float32),
                             pad_id=runner.cfg.sampling.pad_token_id).loss_mask
    out = {
        "rewards_equal": bool(np.array_equal(k["rewards"], p["rewards"])),
        "reward_mean": float(k["rewards"].mean()),
        "advantages_equal": bool(np.array_equal(k["adv"], p["adv"])),
        "advantage_abs_max": float(np.abs(k["adv"]).max()),
        "logprob_max_abs": float((k["lp"] - p["lp"]).abs().numpy()[mask].max()),
        "logprob_mean_abs": float((k["lp"] - p["lp"]).abs().numpy()[mask].mean()),
        "loss": [k["m"]["actor/loss"], p["m"]["actor/loss"]],
        "loss_abs": abs(k["m"]["actor/loss"] - p["m"]["actor/loss"]),
        "grad_norm": [k["m"]["actor/grad_norm"], p["m"]["actor/grad_norm"]],
        "grad_norm_rel": abs(k["m"]["actor/grad_norm"] - p["m"]["actor/grad_norm"])
                         / max(abs(p["m"]["actor/grad_norm"]), 1e-30),
        "first_moment_rel": norm_rel(k["state"].opt_state["mu"], p["state"].opt_state["mu"]),
        "update_rel": norm_rel(k["updates"], p["updates"]),
        "update_norm": [tree_norm(k["updates"]), tree_norm(p["updates"])],
        "params_moved_share": [k["moved"], p["moved"]],
        "params_moved_rel": norm_rel(k["state"].params, start.params),
        "seconds": [k["seconds"], p["seconds"]],
        "kernel_launches": k["counts"], "bars": SHADOW_BARS,
    }
    ran = [n for n in TRAIN_KERNELS if k["counts"][n]]
    bad = [n for n, bar in SHADOW_BARS.items() if not out[n] < bar]
    if not (out["rewards_equal"] and out["advantages_equal"] and out["advantage_abs_max"] > 0):
        bad.append("rewards or advantages")
    if not (k["moved"] > 0 and p["moved"] > 0):
        bad.append("params unmoved")
    if ran != list(TRAIN_KERNELS) or any(p["counts"].values()):
        bad.append(f"launches {k['counts']} / plain {p['counts']}")
    if bad:
        raise AssertionError(f"runner shadow step failed {bad}: {out}")
    return out, start


def runner_kernels(cfg, result, train_mask, peaks, seed) -> dict:
    """K1, K2 and K5-K8 against their plain versions at the runner's shapes
    (Hd=64, G=7): K1 at the engine's prefill (64 prompts right-padded to the
    bucket of 64) and at the training microbatch, K2 on the engine's cache
    (B=64, S=768) mid decode, K5/K6 at a row chunk (D=896, V=151936, tied),
    K7/K8 at the microbatch -> {kernel name: figures}."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 30)
    H, Kv, Hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    plen = torch.as_tensor(result.prompt_lengths, device=dev, dtype=torch.int32)
    B, P, S = len(plen), 64, 768
    valid = torch.arange(P, device=dev)[None, :] < plen[:, None]
    pos = (valid.to(torch.int32).cumsum(-1) - 1).clamp_min(0).to(torch.int32)
    k1 = k1_figures(Rotation(lambda: (randn(B, P, H, Hd), randn(B, P, Kv, Hd),
                                      randn(B, P, Kv, Hd)), 3), pos, valid, peaks)
    k1["shapes"] = f"engine prefill: q[{B},{P},{H},{Hd}] k/v[{B},{P},{Kv},{Hd}], right-padded"
    k2 = k2_figures(randn, B, S, H, Kv, Hd, torch.zeros_like(plen), plen + 129, peaks)
    train, k1_train = check_training_kernels(cfg, train_mask, peaks, seed + 31)
    figs = {r["name"]: {k: v for k, v in r.items() if k not in ("name", "route", "source",
                                                                 "replaces")} for r in train}
    figs["flash_attention_fwd"] = {"prefill": k1, "train_microbatch": k1_train}
    figs["decode_attention_bf16"] = k2
    return figs


def pack_ms(full, seed) -> dict:
    """Host time of the token-budget packing on one minibatch at the
    yaml's full traffic (rollout_batch_size x group_size / num_mini_batches
    rows of max_prompt_len + max_new_tokens, random lengths, under
    max_tokens_per_mb): the partition alone (best-fit-decreasing, which the
    JAX package runs in host C++) and the whole ``pack_microbatches``,
    median of 20 calls each, ms."""
    from rlinf_tpu_torch.data.dynamic_batching import best_fit_decreasing, pack_microbatches

    rows = (full.runner.rollout_batch_size * full.algorithm.group_size
            // full.runner.num_mini_batches)
    T, budget = full.data.max_prompt_len + full.sampling.max_new_tokens, full.loss.max_tokens_per_mb
    r = np.random.default_rng(seed)
    lengths = r.integers(1, T + 1, rows)
    mask = np.arange(T)[None, :] < lengths[:, None]
    batch = {"input_ids": r.integers(0, 1000, (rows, T)).astype(np.int32),
             "target_ids": r.integers(0, 1000, (rows, T)).astype(np.int32),
             "attention_mask": mask, "loss_mask": mask,
             "old_logprobs": r.normal(size=(rows, T)).astype(np.float32),
             "advantages": r.normal(size=(rows, T)).astype(np.float32)}

    def median_ms(fn):
        ts = []
        for _ in range(20):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))

    return {"rows": rows, "T": T, "max_tokens": budget,
            "microbatches": len(best_fit_decreasing(lengths, budget)),
            "partition_ms": median_ms(lambda: best_fit_decreasing(lengths, budget)),
            "pack_ms": median_ms(lambda: pack_microbatches(batch, lengths, budget))}


def runner_phase(kerns, gpu, peaks, seed):
    """Three GRPO steps through ``main_grpo.main`` on grpo_math_qwen05b.yaml
    at full width and depth (random weights from ``seed``, the byte
    tokenizer, main_grpo's 512 synthetic additions, the math verifier), the
    launch gate on that run, step 1's logprob drift, a shadow step on the
    run's state (which moves the params), auto-resume from that state and
    step 5, a two-step ``run_pipelined``, then the path's kernels at its
    shapes -> (launches, {kernel name: figures at the runner's shapes})."""
    import copy
    import shutil

    from rlinf_tpu_torch import main_grpo
    from rlinf_tpu_torch.config import load_config
    from rlinf_tpu_torch.data.io_struct import build_train_batch
    from rlinf_tpu_torch.data.tokenizers import ByteTokenizer
    from rlinf_tpu_torch.models.llm.model import init_params
    from rlinf_tpu_torch.runners import ReasoningRunner

    t_phase = time.perf_counter()
    work = HERE / "build" / "runner_smoke"
    shutil.rmtree(work, ignore_errors=True)
    yaml = str(HERE / RUNNER_YAML)
    overrides = [*RUNNER_REDUCED, *RUNNER_CUT, f"runner.seed={seed}",
                 f"runner.log_dir={work / 'logs'}", f"runner.checkpoint_dir={work / 'ckpt'}"]
    record = {}
    torch.cuda.reset_peak_memory_stats()
    with watching_runner(record):
        history, secs, counts = run_counted(
            kerns, lambda: main_grpo.main(["--config", yaml, *overrides]))
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    r1, result = record["runner"], record["result"]
    peak_tflops = peaks[1] / 1e12
    steps = [{**{k: h[k] for k in RUNNER_METRICS if k in h}, "recompute_s": rs,
              "mfu": h["perf/train_tflops_per_s"] / peak_tflops}
             for h, rs in zip(history, record["recompute_s"])]
    drift = {"kernels": behaviour_drift(r1, result, lp=record["lp"]),
             "plain": record["drift_plain"], "bar": DRIFT_BAR}
    cfg = r1.cfg
    out = {"phase": "runner", "gpu": gpu, "config": RUNNER_YAML, "model": "qwen2_0_5b",
           "layers": cfg.model.num_layers, "reduced": {**RUNNER_REDUCED, **RUNNER_CUT},
           "entry": "rlinf_tpu_torch.main_grpo.main", "attn_impl": cfg.attn_impl,
           "recompute_logprobs": r1.recompute_logprobs,
           "pack_microbatches": pack_ms(load_config(yaml), seed),
           "rows": len(result.prompt_lengths), "seconds": secs, "steps": steps,
           "peak_tflops": peak_tflops, "max_memory_allocated_gb": peak_gb,
           "launches": counts, "logprob_drift_step1": drift}
    emit(out)
    bad = [k for k in RUNNER_KERNELS if not counts[k]]
    bad += [f"{k} launched" for k, c in counts.items() if c and k not in RUNNER_KERNELS]
    bad += [f"step {i + 1} {k}" for i, s in enumerate(steps) for k, v in s.items()
            if not np.isfinite(v)]
    if len(history) != 3 or r1.ckpt.latest_step() != 3:
        bad.append(f"{len(history)} steps, checkpoint at {r1.ckpt.latest_step()}")
    if not abs(history[0]["actor/approx_kl"]) < 1e-3:
        bad.append(f"step-1 approx_kl {history[0]['actor/approx_kl']}")
    bad += [f"drift {side} {k}" for side in ("kernels", "plain")
            for k, bar in DRIFT_BAR.items() if not drift[side][k] < bar]
    if bad:
        raise AssertionError(f"runner phase failed: {bad}")

    # the shadow step on the run's state; the runner keeps the kernels' run
    # (step 4, params moved), saves it, and a second runner on the same
    # checkpoint directory resumes from it
    shadow, start = shadow_step(r1, result, kerns)
    r1.save_checkpoint()
    fresh = init_params(cfg.model, seed, device="cuda")
    resume = {"params_moved_from_fresh_init": moved_share(r1.state.params, fresh),
              "steps_1_3_left_params_at_init": not state_differences(start.params, fresh)}
    del start, fresh
    r2 = ReasoningRunner(load_config(yaml, overrides), ByteTokenizer(),
                         main_grpo.synthetic_dataset(), device="cuda")
    prompts = lambda it: [e.prompt for e in copy.deepcopy(it).next_batch()]
    resume.update({"global_step": r2.global_step,
                   "state_differs_at": state_differences(r1.state, r2.state),
                   "iterator_state": r2.iterator.state_dict(),
                   "iterator_equal": r2.iterator.state_dict() == r1.iterator.state_dict(),
                   "next_batch_equal": prompts(r2.iterator) == prompts(r1.iterator)})
    record.clear()
    del r1
    gc.collect()
    torch.cuda.empty_cache()
    if not (resume["global_step"] == 4 and not resume["state_differs_at"]
            and resume["params_moved_from_fresh_init"] > 0
            and resume["iterator_equal"] and resume["next_batch_equal"]):
        raise AssertionError(f"auto-resume failed: {resume}")
    (step5,) = r2.run(5)
    resume["step5"] = {k: step5[k] for k in RUNNER_METRICS if k in step5}
    if not (r2.global_step == 5 and np.isfinite(step5["actor/loss"])):
        raise AssertionError(f"resumed runner's step 5: {step5}")
    emit({"phase": "runner_shadow_and_resume", "shadow": shadow, "resume": resume})
    train_mask = build_train_batch(result, np.zeros(result.response_ids.shape, np.float32),
                                   pad_id=cfg.sampling.pad_token_id).attention_mask[:16]
    del r2
    gc.collect()
    torch.cuda.empty_cache()

    # pipelined: rollout of step N+1 beside the update of step N
    r3 = ReasoningRunner(load_config(yaml, [*RUNNER_REDUCED, *RUNNER_CUT, f"runner.seed={seed}",
                                            "runner.log_dir=null", "runner.checkpoint_dir=null"]),
                         ByteTokenizer(), main_grpo.synthetic_dataset(), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hp = r3.run_pipelined(2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pipelined = {"steps": 2, "seconds": wall, "step_s": wall / 2,
                 "run_step_s": [h["time/rollout"] + h["time/step"] for h in history],
                 "history": [{k: h[k] for k in RUNNER_METRICS if k in h} for h in hp]}
    del r3
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "runner_pipelined", **pipelined})
    if not (len(hp) == 2 and all(set(h) == set(history[0]) for h in hp)
            and all(np.isfinite(h["actor/loss"]) for h in hp)):
        raise AssertionError(f"run_pipelined: {pipelined}")

    # the path's kernels at its shapes (Hd=64, G=7)
    figs = runner_kernels(cfg.model, result, train_mask, peaks, seed)
    shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "runner_kernels", "gpu": gpu, "results": figs,
          "seconds": time.perf_counter() - t_phase})
    return counts, figs


# ---------------------------------------------------------------------------
# Phases 14-16: server mode, online coding RL, the agent loop and the eval
# ---------------------------------------------------------------------------

#: what a served request launches: K1 (prefill), K4 (the fused sampler), K9
#: (the whole decode step); the per-layer decode kernels K2 and K3 never run
SERVER_KERNELS = ("flash_attention_fwd", "fused_lmhead_sample", "decode_megakernel")
#: of the long-tail mix's 128 requests, these go over loopback HTTP through
#: RouterServer -> OpenAIHTTPServer (every 8th; odd ones as chat)
SERVER_HTTP = range(7, 128, 8)
#: the greedy server checks: 64 prompts of 640 tokens, 16 new tokens. At
#: that length no prompt is padded in either layout (the engine's buckets
#: of 64, generate's left-padded rows) and generate's megakernel cache is
#: the engine's 768 slots, so both run K9 on one schedule
SWAP_PROMPT, SWAP_NEW = 640, 16
#: phase 4's bars: greedy token agreement, and the logprob error over the
#: tokens up to each row's first difference
SWAP_BARS = {"agree": 0.95, "lp_max_abs": 0.15}
#: phases 15 and 16 run the model at a sixth of its depth (as the runner
#: phase, RUNNER_CUT), so that the whole script stays inside its time limit
#: with phases 26 and 28
CODING_CUT = {"model.num_layers=4": "4 of Qwen2.5-0.5B's 24 layers: the script's time limit "
                                     "(12 until phase 26's parts came, 8 until phase 28 came)"}
AGENT_CUT = {"model.num_layers=4": "4 of Qwen2.5-0.5B's 24 layers: the script's time limit "
                                    "(12 until phase 26's parts came, 8 until phase 28 came)"}
#: the coding phase: the runner phase's traffic cut, the loss online RL needs
CODING_REDUCED = {**{k: v for k, v in RUNNER_REDUCED.items() if "save_interval" not in k},
                  "loss.loss_type=decoupled": "online RL trains against live-swapped "
                                              "weights (the yaml: ppo)"}
#: the agent phase: 64 conversations of two turns of 128 tokens, 2 steps
AGENT_REDUCED = {
    "runner.rollout_batch_size=8": "8 prompts x group_size 8 = 64 conversations a step "
                                   "(the yaml: 64 prompts, 512 rows)",
    "sampling.max_new_tokens=128": "a turn's budget (the yaml has 1024)",
    "runner.max_steps=2": "the yaml has 400",
}


def percentile_ms(secs, q) -> float:
    return float(np.percentile(np.asarray(secs) * 1e3, q)) if secs else float("nan")


def perturbed(params, seed):
    """A copy of ``params``, every floating leaf scaled elementwise by
    1 + 0.2 N(0, 1) from a generator seeded with ``seed``."""
    from rlinf_tpu_torch.training.train_state import tree_map

    g = torch.Generator(device="cuda").manual_seed(seed)

    def one(t):
        if not t.is_floating_point():
            return t.clone()
        noise = torch.randn(t.shape, generator=g, device=t.device, dtype=torch.float32)
        return (t.float() * (1 + 0.2 * noise)).to(t.dtype)

    with torch.no_grad():
        return tree_map(one, params)


def server_engine(cfg, sp):
    from rlinf_tpu_torch.rollout.continuous_engine import ContinuousBatchingEngine

    return ContinuousBatchingEngine(
        cfg, sp, num_slots=64, max_seq_len=768, prompt_bucket=64, decode_chunk=16,
        weight_quant="int8", kv_quant="int8", use_mega=True, sampler_impl="fused",
        attn_impl="pallas", device="cuda")


def timed_prepare(eng, record: list):
    """Record the seconds of each ``prepare_params`` call (the weight swap's
    re-quantization and lm-head packing), device work included."""
    real = eng.prepare_params

    def prepare(params):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(params)
        torch.cuda.synchronize()
        record.append(time.perf_counter() - t0)
        return out

    eng.prepare_params = prepare


def http_json(url, body=None, timeout=600.0):
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def server_mix(cfg, seed):
    """Phase 11's long-tail mix; the SERVER_HTTP requests' prompts become
    text of the same token count (random lowercase letters, byte tokens;
    a chat request's template tags included) -> (prompt ids, budgets,
    {index: (path, body)})."""
    from rlinf_tpu_torch.data.tokenizers import ByteTokenizer
    from rlinf_tpu_torch.rollout.server import _render_chat

    request, budgets = long_tail_mix(cfg, seed)
    ids = list(request.prompt_ids)
    r = np.random.default_rng(seed + 61)
    tags = len(_render_chat([{"role": "user", "content": ""}]))
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    bodies = {}
    for k, i in enumerate(SERVER_HTTP):
        chat = k % 2 == 1
        text = "".join(r.choice(letters, len(ids[i]) - (tags if chat else 0)))
        if chat:
            bodies[i] = ("/v1/chat/completions",
                         {"messages": [{"role": "user", "content": text}], "max_tokens": budgets[i]})
            text = _render_chat(bodies[i][1]["messages"])
        else:
            bodies[i] = ("/v1/completions", {"prompt": text, "max_tokens": budgets[i]})
        ids[i] = ByteTokenizer().encode(text)
    return ids, budgets, bodies


def serve_mix(server, router_url, ids, budgets, bodies, swap):
    """All requests at once from client threads (HTTP ones through the
    router); ``swap()`` runs once half of them are answered -> per request
    (tokens served, prompt tokens, seconds), in request order."""
    import concurrent.futures

    def call(i):
        t0 = time.perf_counter()
        if i in bodies:
            path, body = bodies[i]
            out = http_json(router_url + path, body)
            got = (out["usage"]["completion_tokens"], out["usage"]["prompt_tokens"])
        else:
            got = (len(server.generate(ids[i], budgets[i], timeout=600)["tokens"]), len(ids[i]))
        return i, got, time.perf_counter() - t0

    out = [None] * len(ids)
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(ids)) as pool:
        futures = [pool.submit(call, i) for i in range(len(ids))]
        for n, f in enumerate(concurrent.futures.as_completed(futures)):
            i, got, secs = f.result()
            out[i] = (*got, secs)
            if n + 1 == len(ids) // 2:
                swap()
    return out


def agreement(got_ids, got_lps, ref):
    """Greedy token agreement with a ``generate`` output and the logprob
    error over each row's tokens up to its first difference."""
    ref_ids, ref_lps = ref.response_ids.cpu().numpy(), ref.response_logprobs.cpu().numpy()
    same = got_ids == ref_ids
    first = np.where(same.all(1), same.shape[1], np.argmin(same, axis=1))
    err = max((float(np.abs(got_lps[b, :first[b]] - ref_lps[b, :first[b]]).max())
               for b in range(len(first)) if first[b]), default=0.0)
    return {"agree": float(same.mean()), "lp_max_abs": err,
            "rows_equal": int(same.all(1).sum())}


def greedy_server_checks(cfg, params, new_params, kerns, seed) -> dict:
    """A greedy server (16 new tokens) on 64 prompts of SWAP_PROMPT tokens:
    every kernel call against its plain version (K9 at phase 10's bar, K4
    at phase 4's, K1 at K3_TOL_REL of its largest output); then ``update_params(new_params)`` and the same
    prompts again, which must pass phase 4's bars against ``generate(mega=)``
    on the new params and fail them against it on the old ones."""
    from rlinf_tpu_torch.data.io_struct import RolloutRequest
    from rlinf_tpu_torch.models.llm.quant import quantize_params
    from rlinf_tpu_torch.models.llm.sampler import SamplingParams, generate, with_packed_lm_head
    from rlinf_tpu_torch.ops.cuda import decode_megakernel as MK
    from rlinf_tpu_torch.rollout.server import GenerationServer

    sp = SamplingParams(max_new_tokens=SWAP_NEW, greedy=True, eos_token_id=-1)
    eng = server_engine(cfg, sp)
    r = np.random.default_rng(seed + 62)
    prompts = [list(map(int, r.integers(0, cfg.vocab_size, SWAP_PROMPT))) for _ in range(64)]
    server = GenerationServer(eng, params, seed=seed)
    server.start()
    stats = {}
    try:
        with kernels_replaced(shadowed(stats), _engine_sites()):
            shadow_out = [f.result(timeout=600) for f in [server.submit(p) for p in prompts]]
        server.update_params(new_params)
        served, secs, counts = run_counted(kerns, lambda: [
            f.result(timeout=600) for f in [server.submit(p) for p in prompts]])
    finally:
        server.stop()
    if not all(len(o["tokens"]) == SWAP_NEW for o in shadow_out + served):
        raise AssertionError("greedy server: a request not answered with its budget")
    ids = np.asarray([o["tokens"] for o in served])
    lps = np.asarray([o["logprobs"] for o in served], np.float32)
    mask = np.ones((64, SWAP_PROMPT), bool)
    side = {}
    with torch.inference_mode():
        # the engine's own path on the new params (its first token from the
        # bf16 lm head, as the server's): reported beside generate's
        eng_res = eng.rollout(new_params, RolloutRequest(prompt_ids=prompts),
                              torch.Generator())
        side["engine_new"] = agreement(ids, lps, types.SimpleNamespace(
            response_ids=torch.as_tensor(eng_res.response_ids),
            response_logprobs=torch.as_tensor(eng_res.response_logprobs)))
        for name, p in (("new", new_params), ("old", params)):
            q = with_packed_lm_head(quantize_params(p))
            mega = MK.pack_decode_weights(q, cfg, eng._mega_cw)
            ref = generate(p, cfg, torch.Generator(), np.asarray(prompts), mask, sp,
                           attn_impl="pallas", decode_params=q, kv_quant="int8", mega=mega,
                           device="cuda")
            side[name] = agreement(ids, lps, ref)
            del q, mega, ref
    k9, k4 = stats.get("decode_megakernel", {}), stats.get("fused_lmhead_sample", {})
    k1 = stats.get("flash_attention_fwd", {})
    out = {"prompts": 64, "prompt_len": SWAP_PROMPT, "new_tokens": SWAP_NEW, "shadow": stats,
           "after_swap": {"seconds": secs, "launches": counts,
                          "vs_generate_mega_new_params": side["new"],
                          "vs_generate_mega_old_params": side["old"],
                          "vs_engine_rollout_new_params": side["engine_new"]},
           "bars": SWAP_BARS}
    bad = []
    if not (k9.get("calls", 0) >= SWAP_NEW and k9["max_rel_err"] < 5e-2):
        bad.append("K9 shadow")
    if not (k4.get("calls", 0) and k4["token_agree"] > 0.95 and k4["max_abs_err"] < 0.15):
        bad.append("K4 shadow")
    # K1 relative to its largest output: one bf16 step of the output is up
    # to 2^-7 of it (its absolute size grows with the prompt: 0.0156 at 640)
    if not (k1.get("calls", 0) and k1["max_rel_err"] < K3_TOL_REL):
        bad.append("K1 shadow")
    passes = {k: side[k]["agree"] > SWAP_BARS["agree"]
              and side[k]["lp_max_abs"] < SWAP_BARS["lp_max_abs"] for k in ("new", "old")}
    if not passes["new"]:
        bad.append("served tokens against generate(mega=) on the new params")
    if passes["old"]:
        bad.append("served tokens pass the bars against the old params too")
    if bad:
        raise AssertionError(f"greedy server checks failed {bad}: {out}")
    return out


def serve_openai_check(kerns) -> dict:
    """serve_openai's own server (--preset qwen2_1_5b: bf16 weights and
    cache, 32 slots) answers 8 HTTP requests, both routes, and
    APIRewardClient scores 8 payloads against it."""
    import concurrent.futures

    from rlinf_tpu_torch import serve_openai
    from rlinf_tpu_torch.algorithms.rewards.api_reward import APIRewardClient

    server, http = serve_openai.build_server(serve_openai.parse_args(
        ["--preset", "qwen2_1_5b", "--port", "0", "--max-new-tokens", "64"]))
    bodies = [("/v1/completions", {"prompt": f"Request {i}: say something.", "max_tokens": 32})
              if i % 2 == 0 else
              ("/v1/chat/completions", {"messages": [{"role": "user", "content": f"hi {i}"}],
                                        "max_tokens": 32}) for i in range(8)]
    try:
        def call(b):
            t0 = time.perf_counter()
            out = http_json(http.url + b[0], b[1])
            return out, time.perf_counter() - t0

        def run():
            with concurrent.futures.ThreadPoolExecutor(8) as pool:
                answers = list(pool.map(call, bodies))
            scores = APIRewardClient(http.url, max_workers=8).score_batch(
                [[{"role": "user", "content": f"Score answer {i}"}] for i in range(8)],
                max_tokens=16)
            return answers, scores

        (answers, scores), secs, counts = run_counted(kerns, run)
        health = http_json(http.url + "/health")
    finally:
        http.stop()
        server.stop()
    out = {"engine": "ContinuousBatchingEngine(num_slots=32), bf16 weights and cache",
           "seconds": secs, "launches": counts, "scores": scores, "health": health,
           "latency_ms": [s * 1e3 for _, s in answers]}
    want = {**dict.fromkeys(kerns, 0), "decode_attention_bf16": counts["decode_attention_bf16"]}
    if not (counts == want and counts["decode_attention_bf16"] > 0
            and all(a["usage"]["completion_tokens"] == 32 for a, _ in answers)
            and len(scores) == 8 and all(np.isfinite(scores)) and health["served"] == 16):
        raise AssertionError(f"serve_openai check failed: {out}")
    return out


def server_phase(kerns, gpu, seed, params):
    """GenerationServer over the megakernel engine at Qwen2-1.5B's full
    width and depth on ``params`` (the main path's, after the training
    phase's steps): the long-tail mix through the engine directly, then
    through the server from client threads (16 requests over HTTP), the
    weights swapped after half of them, each run's prefill/decode split;
    one short request's latency straight and over HTTP; the greedy checks;
    serve_openai's own server -> launches."""
    from rlinf_tpu_torch.data.io_struct import RolloutRequest
    from rlinf_tpu_torch.data.tokenizers import ByteTokenizer
    from rlinf_tpu_torch.models.llm.config import LLMConfig
    from rlinf_tpu_torch.models.llm.sampler import SamplingParams
    from rlinf_tpu_torch.rollout.server import GenerationServer, OpenAIHTTPServer, RouterServer

    t_phase = time.perf_counter()
    cfg = LLMConfig.qwen2_1_5b()
    new_params = perturbed(params, seed + 63)
    ids, budgets, bodies = server_mix(cfg, seed)
    tokens = int(sum(budgets))
    sp = SamplingParams(max_new_tokens=256, temperature=1.0, eos_token_id=-1)
    eng = server_engine(cfg, sp)
    total = dict.fromkeys(kerns, 0)

    # the same mix through the engine directly
    seen = watch_engine(eng)
    res, direct_s, direct_counts = run_counted(kerns, lambda: eng.rollout(
        params, RolloutRequest(prompt_ids=ids, max_new_tokens=budgets),
        torch.Generator().manual_seed(seed + 64)))
    check_answers(res, budgets, cfg.vocab_size)
    del res
    split = {"engine_direct": {k: v for k, v in seen.items() if not isinstance(v, list)}}

    prepare_s = []
    timed_prepare(eng, prepare_s)
    seen = watch_engine(eng)
    server = GenerationServer(eng, params, seed=seed)
    server.start()
    http = OpenAIHTTPServer(server, ByteTokenizer())
    http.start()
    router = RouterServer([http.url])
    router.start()
    swapped = {}

    def swap():
        swapped["after_answered"] = len(ids) // 2
        server.update_params(new_params)

    try:
        while not prepare_s:                   # the initial params prepared, pool idle
            time.sleep(0.01)
        served, secs, counts = run_counted(
            kerns, lambda: serve_mix(server, router.url, ids, budgets, bodies, swap))
        split["server"] = {k: v for k, v in seen.items() if not isinstance(v, list)}
        split["server"]["host_s"] = secs - seen["prefill_s"] - seen["decode_s"]
        health = {"router": http_json(router.url + "/health"),
                  "server": http_json(http.url + "/health")}
        # one request of 128 tokens for 1 new token on the idle server, straight
        # to submit and through the router: what the two HTTP hops add
        text = "x" * 128
        single = {"direct": [], "http": []}
        for _ in range(8):
            t0 = time.perf_counter()
            server.generate(ByteTokenizer().encode(text), 1)
            single["direct"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            http_json(router.url + "/v1/completions", {"prompt": text, "max_tokens": 1})
            single["http"].append(time.perf_counter() - t0)
    finally:
        router.stop()
        http.stop()
        server.stop()
    for k in kerns:
        total[k] += counts[k]
    lat = {kind: [s for i, (_, _, s) in enumerate(served) if (i in bodies) == (kind == "http")]
           for kind in ("http", "direct")}
    out = {"phase": "server", "gpu": gpu, "model": "qwen2_1_5b", "layers": cfg.num_layers,
           "engine": "ContinuousBatchingEngine(num_slots=64, max_seq_len=768, weight_quant="
                     "'int8', kv_quant='int8', use_mega=True, sampler_impl='fused', "
                     "attn_impl='pallas')",
           "requests": len(ids), "http_requests": len(bodies), "generated_tokens": tokens,
           "seconds": secs, "served_tokens_per_s": tokens / secs,
           "engine_direct": {"seconds": direct_s, "generated_tokens_per_s": tokens / direct_s,
                             "launches": direct_counts},
           "latency_ms": {f"{kind}_p{q}": percentile_ms(v, q) for kind, v in lat.items()
                          for q in (50, 95)},
           "swap": {**swapped, "prepare_params_ms": [s * 1e3 for s in prepare_s]},
           "time_split_s": split,
           "single_request_ms": {k: percentile_ms(v, 50) for k, v in single.items()},
           "health": health, "launches": counts}
    emit(out)
    bad = [i for i, (n, p, _) in enumerate(served) if n != budgets[i] or p != len(ids[i])]
    bad += [f"{k} not launched" for k in SERVER_KERNELS if not counts[k]]
    bad += [f"{k} launched" for k, c in counts.items() if c and k not in SERVER_KERNELS]
    if len(prepare_s) != 2 or health["server"]["served"] != len(ids):
        bad.append(f"{len(prepare_s)} prepare_params calls, {health['server']['served']} served")
    if bad:
        raise AssertionError(f"server phase failed on {bad}")
    del eng
    torch.cuda.empty_cache()

    greedy = greedy_server_checks(cfg, params, new_params, kerns, seed)
    for k in kerns:
        total[k] += greedy["after_swap"]["launches"][k]
    emit({"phase": "server_greedy_checks", **greedy})
    del new_params
    gc.collect()
    torch.cuda.empty_cache()

    openai = serve_openai_check(kerns)
    for k in kerns:
        total[k] += openai["launches"][k]
    emit({"phase": "serve_openai", **openai, "seconds_phase": time.perf_counter() - t_phase})
    gc.collect()
    torch.cuda.empty_cache()
    return total


def coding_online_phase(kerns, gpu, seed):
    """CodingOnlineRunner on grpo_math_qwen05b.yaml with the decoupled loss
    at full width and depth, the runner phase's traffic (64 rows, 256 new
    tokens), 64 coding tasks with I/O tests, 3 overlapped online steps; the
    reward is the exec verifier plus ``text_rule`` (a rule on the token
    ids: whether a response holds any byte token) -> launches."""
    from rlinf_tpu_torch.algorithms.rewards import code_verifier as CV
    from rlinf_tpu_torch.config import load_config
    from rlinf_tpu_torch.data.tokenizers import ByteTokenizer
    from rlinf_tpu_torch.runners.coding_online_runner import CodingOnlineRunner, CodingTask

    if CV.code_reward("```python\nprint(sum(map(int, input().split())))\n```",
                      [{"input": "2 3\n", "output": "5"}]) != 1.0:
        raise AssertionError("the code verifier failed a right program beside a CUDA context")
    r = np.random.default_rng(seed + 65)
    tasks = []
    for _ in range(64):
        a, b = (int(x) for x in r.integers(2, 100, 2))
        tasks.append(CodingTask(
            prompt=f"Write a Python program that reads two integers and prints their sum. "
                   f"Example: {a} {b} -> ",
            test_cases=[{"input": f"{a} {b}\n", "output": str(a + b)},
                        {"input": f"{b} {a + 1}\n", "output": str(a + b + 1)}]))
    calls = {"code_reward": 0, "run_test_case": 0}
    real_reward, real_case = CV.code_reward, CV.run_test_case

    def code_reward(*a, **kw):
        calls["code_reward"] += 1
        return real_reward(*a, **kw)

    def run_test_case(*a, **kw):
        calls["run_test_case"] += 1
        return real_case(*a, **kw)

    def reward_fn(texts, answers):
        ex = CV.batch_code_rewards(texts, answers, timeout_s=2.0, partial_credit=True)
        return [0.5 * e + 0.5 * t for e, t in zip(ex, text_rule(texts, answers))]

    overrides = [*CODING_REDUCED, *CODING_CUT, f"runner.seed={seed}", "runner.log_dir=null",
                 "runner.checkpoint_dir=null"]
    t0 = time.perf_counter()
    runner = CodingOnlineRunner(load_config(str(HERE / RUNNER_YAML), overrides), ByteTokenizer(),
                                tasks, reward_fn=reward_fn, device="cuda")
    build_s = time.perf_counter() - t0
    start = clone_tree(runner.state.params)
    CV.code_reward, CV.run_test_case = code_reward, run_test_case
    torch.cuda.reset_peak_memory_stats()
    try:
        history, secs, counts = run_counted(kerns, lambda: runner.run(3))
    finally:
        CV.code_reward, CV.run_test_case = real_reward, real_case
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    online = ("online/param_version", "online/version_lag")
    steps = [{k: h[k] for k in (*RUNNER_METRICS, *online) if k in h} for h in history]
    out = {"phase": "coding_online", "gpu": gpu, "config": RUNNER_YAML, "model": "qwen2_0_5b",
           "layers": runner.cfg.model.num_layers, "reduced": {**CODING_REDUCED, **CODING_CUT},
           "entry": "rlinf_tpu_torch.runners.CodingOnlineRunner.run", "tasks": len(tasks),
           "attn_impl": runner.cfg.attn_impl, "recompute_logprobs": runner.recompute_logprobs,
           "runner_build_s": build_s, "seconds": secs, "steps": steps, "verifier": calls,
           "params_moved_share": moved_share(runner.state.params, start),
           "max_memory_allocated_gb": peak_gb, "launches": counts}
    emit(out)
    bad = [k for k in RUNNER_KERNELS if not counts[k]]
    bad += [f"{k} launched" for k, c in counts.items() if c and k not in RUNNER_KERNELS]
    bad += [f"step {i + 1} {k}" for i, s in enumerate(steps) for k, v in s.items()
            if not np.isfinite(v)]
    if len(history) != 3 or history[-1]["online/param_version"] != 4.0:
        bad.append(f"{len(history)} steps, param version {history[-1]['online/param_version']}")
    if not all(h["online/version_lag"] <= 2.0 for h in history):
        bad.append("version lag above 2")
    if calls["code_reward"] != 3 * 64:
        bad.append(f"the verifier ran on {calls['code_reward']} of {3 * 64} responses")
    if not out["params_moved_share"] > 0:
        bad.append("params unmoved")
    if bad:
        raise AssertionError(f"coding_online phase failed: {bad}")
    del runner, start
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def agent_rule(texts, answers):
    """The agent phase's rewards, a rule on the token ids through the byte
    tokenizer: 1.0 where a conversation's text (its byte tokens decoded,
    the observation included) has an odd number of characters."""
    return [float(len(t) % 2 == 1) for t in texts]


def scripted_first_call(runner, record: list):
    """The agent phase's parse: a calc(1+1) call on each conversation's
    first turn, cut where its decoded text ends (random weights never write
    a tag), none on the second; each step's rollouts go to ``record``."""
    from rlinf_tpu_torch.algorithms.toolcall_parsers import ToolCall

    loop, state = runner.loop, {"left": 0}
    real_run = loop.run

    def run(params, prompt_ids, generator):
        state["left"] = len(prompt_ids)
        out = real_run(params, prompt_ids, generator)
        record.append(out)
        return out

    def parse(text):
        if state["left"] == 0:
            return None
        state["left"] -= 1
        return ToolCall(tool="calc", args="1+1", raw=text, end_pos=len(text))

    loop.run, loop.parse = run, parse


def conversation_faults(r, tok, obs) -> list:
    """What is wrong with one two-turn conversation: its turns, its masks,
    its observation tokens (masked off, logprob 0)."""
    bad = []
    if not (r.num_turns == 2 and r.num_tool_calls == 1 and r.turn_errors == [False, False]):
        bad.append(f"turns {r.num_turns}, calls {r.num_tool_calls}, errors {r.turn_errors}")
        return bad
    (s0, e0), (s1, e1) = r.turn_spans
    if not (s0 == r.prompt_len and e1 == len(r.token_ids) and e0 < s1):
        bad.append(f"spans {r.turn_spans}")
    if not all(r.loss_mask[s0:e0]) or not all(r.loss_mask[s1:e1]) or any(r.loss_mask[:s0]):
        bad.append("model tokens masked off or prompt on")
    if any(r.loss_mask[e0:s1]) or any(r.logprobs[e0:s1]) or tok.decode(r.token_ids[e0:s1]) != obs:
        bad.append("observation tokens")
    return bad


def agent_phase(kerns, gpu, seed):
    """AgentRunner at Qwen2.5-0.5B's widths and depth
    (grpo_math_qwen05b.yaml): CalculatorTool, a scripted call in turn 1,
    max_turns=2, 64 conversations, 2 steps, ``agent_rule`` rewards; then
    ``evaluate_reasoning`` greedy on the trained params over 64 of
    main_grpo's synthetic additions -> launches."""
    from rlinf_tpu_torch import main_grpo
    from rlinf_tpu_torch.agents import AgentLoopConfig, CalculatorTool, ToolRegistry
    from rlinf_tpu_torch.config import load_config
    from rlinf_tpu_torch.data.tokenizers import ByteTokenizer
    from rlinf_tpu_torch.models.llm.sampler import SamplingParams
    from rlinf_tpu_torch.runners.agent_runner import AgentRunner
    from rlinf_tpu_torch.runners.eval_runner import evaluate_reasoning

    overrides = [*AGENT_REDUCED, *AGENT_CUT, f"runner.seed={seed}", "runner.log_dir=null",
                 "runner.checkpoint_dir=null"]
    loop_cfg = AgentLoopConfig(max_turns=2, max_total_len=512)
    runner = AgentRunner(load_config(str(HERE / RUNNER_YAML), overrides), ByteTokenizer(),
                         main_grpo.synthetic_dataset(), ToolRegistry([CalculatorTool()]),
                         agent_rule, loop_cfg=loop_cfg, device="cuda")
    record = []
    scripted_first_call(runner, record)
    start = clone_tree(runner.state.params)
    torch.cuda.reset_peak_memory_stats()
    history, secs, counts = run_counted(kerns, lambda: runner.run(2))
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    tok = ByteTokenizer()
    obs = loop_cfg.tool_result_template.format("2")
    faults = {(s, i): f for s, rolls in enumerate(record) for i, r in enumerate(rolls)
              if (f := conversation_faults(r, tok, obs))}
    lens = [len(r.token_ids) for rolls in record for r in rolls]
    keys = ("time/rollout", "time/reward", "time/training", "time/step", "actor/loss",
            "actor/grad_norm", "actor/approx_kl", "agent/reward_mean", "agent/num_turns_mean",
            "agent/tool_calls_mean")
    out = {"phase": "agent", "gpu": gpu, "config": RUNNER_YAML, "model": "qwen2_0_5b",
           "layers": runner.cfg.model.num_layers, "reduced": {**AGENT_REDUCED, **AGENT_CUT},
           "entry": "rlinf_tpu_torch.runners.AgentRunner.run", "attn_impl": runner.cfg.attn_impl,
           "conversations": [len(r) for r in record], "seconds": secs,
           "tokens_per_conversation": {"min": min(lens), "mean": float(np.mean(lens)),
                                       "max": max(lens)},
           "steps": [{k: h[k] for k in keys if k in h} for h in history],
           "params_moved_share": moved_share(runner.state.params, start),
           "max_memory_allocated_gb": peak_gb, "launches": counts}
    emit(out)
    bad = [k for k in RUNNER_KERNELS if not counts[k]]
    bad += [f"{k} launched" for k, c in counts.items() if c and k not in RUNNER_KERNELS]
    bad += [f"step {i + 1} {k}" for i, s in enumerate(out["steps"]) for k, v in s.items()
            if not np.isfinite(v)]
    if runner.cfg.attn_impl != "pallas" or out["conversations"] != [64, 64]:
        bad.append(f"attn_impl {runner.cfg.attn_impl}, conversations {out['conversations']}")
    if faults:
        bad.append(f"conversations {dict(list(faults.items())[:4])}")
    if not out["params_moved_share"] > 0:
        bad.append("params unmoved")
    if bad:
        raise AssertionError(f"agent phase failed: {bad}")

    # the eval runner, greedy, on the trained params
    data = main_grpo.synthetic_dataset(64, seed)
    res, eval_s, eval_counts = run_counted(kerns, lambda: evaluate_reasoning(
        runner.state.params, runner.cfg.model, tok, data,
        sampling=SamplingParams(max_new_tokens=64, greedy=True, eos_token_id=-1),
        batch_size=64, attn_impl=runner.cfg.attn_impl, device="cuda"))
    ev = {"phase": "eval", "gpu": gpu, "entry": "rlinf_tpu_torch.runners.eval_runner."
          "evaluate_reasoning", "examples": res.num_examples, "accuracy": res.accuracy,
          "mean_response_len": res.mean_response_len, "seconds": eval_s,
          "generated_tokens_per_s": res.mean_response_len * res.num_examples / eval_s,
          "launches": eval_counts}
    emit(ev)
    want = {**dict.fromkeys(kerns, 0), "flash_attention_fwd": eval_counts["flash_attention_fwd"],
            "decode_attention_bf16": eval_counts["decode_attention_bf16"]}
    if not (res.num_examples == len(res.per_example) == 64 and eval_counts == want
            and eval_counts["flash_attention_fwd"] and eval_counts["decode_attention_bf16"]
            and res.mean_response_len == 64):
        raise AssertionError(f"eval failed: {ev}")
    del runner, start
    gc.collect()
    torch.cuda.empty_cache()
    return {k: counts[k] + eval_counts[k] for k in kerns}


#: the shadowed Qwen2-7B-width run's depth: the script's time limit (4
#: until phase 26's expert-axis parts came; K9 at these widths is also held
#: against plain at 2 layers in phase 9)
QWEN2_7B_SHADOW_LAYERS = 2


def mega_generate_qwen2_7b(seed) -> dict:
    """A 16-token greedy ``generate(kv_quant="int8", mega=)`` at Qwen2-7B's
    widths, ``QWEN2_7B_SHADOW_LAYERS`` of its 28 layers (random weights from the seed), 16 prompts of
    32-128 tokens, with every K9 call shadowed by its plain version on the
    same inputs (relative error < 5e-2, phase 10's bar): K9 once a step."""
    import dataclasses

    from rlinf_tpu_torch.models.llm import model as M
    from rlinf_tpu_torch.models.llm.config import LLMConfig
    from rlinf_tpu_torch.models.llm.quant import quantize_params
    from rlinf_tpu_torch.models.llm.sampler import SamplingParams, generate
    from rlinf_tpu_torch.ops.cuda import decode_megakernel as MK

    cfg = dataclasses.replace(LLMConfig.qwen2_7b(), num_layers=QWEN2_7B_SHADOW_LAYERS)
    params = M.init_params(cfg, seed + 9, device="cuda")
    qparams = quantize_params(params)
    mega = MK.pack_decode_weights(qparams, cfg, chunk_width=cfg.hidden_size)
    B, P, N = 16, 128, 16
    r = np.random.default_rng(seed + 9)
    plen = r.integers(32, P + 1, B)
    mask = np.arange(P)[None, :] >= (P - plen)[:, None]
    ids = np.where(mask, r.integers(0, cfg.vocab_size, (B, P)), 0)
    sp = SamplingParams(max_new_tokens=N, greedy=True, eos_token_id=-1)
    stats = {}
    t0 = time.perf_counter()
    with kernels_replaced(shadowed(stats), _engine_sites()):
        out = generate(params, cfg, torch.Generator(), ids, mask, sp, attn_impl="pallas",
                       decode_params=qparams, kv_quant="int8", mega=mega, device="cuda")
    secs = time.perf_counter() - t0
    check_output(out.response_ids.cpu(), out.response_logprobs.cpu(), out.response_mask.cpu(),
                 B, N, cfg.vocab_size)
    k9 = stats.get("decode_megakernel", {})
    if not (k9.get("calls") == N - 1 and k9["max_rel_err"] < 5e-2):
        raise AssertionError(f"K9 shadow check at Qwen2-7B's widths failed: {stats}")
    return {"model": "qwen2_7b widths, 4 layers", "batch": B, "new_tokens": N,
            "seconds_shadowed": secs, "shadow": stats}


def check_output(ids, lps, mask, B, N, V):
    ids, lps, mask = map(torch.as_tensor, (ids, lps, mask))
    if tuple(ids.shape) != (B, N) or tuple(lps.shape) != (B, N) or tuple(mask.shape) != (B, N):
        raise AssertionError(f"output shapes {ids.shape} {lps.shape} {mask.shape}")
    if not torch.isfinite(lps).all() or not (lps <= 0).all():
        raise AssertionError("logprobs must be finite and <= 0")
    if not ((ids >= 0) & (ids < V)).all() or not mask.all():
        raise AssertionError("token ids out of range or rows stopped without an eos")


# ---------------------------------------------------------------------------
# Phase 18: the default runs that no kernel took before
# ---------------------------------------------------------------------------

TINY_YAML = "examples/reasoning/config/grpo_demo_tiny.yaml"
PPO_YAML = "examples/reasoning/config/ppo_separate_critic.yaml"
# the kernels a small model's GRPO or PPO step launches on the card: the
# lm head's logprobs and their gradient (K5, K6) always; the prefill and
# train attention (K1, K7, K8) only from T = 128 on (resolve_attn_impl)
SMALL_TRAIN_KERNELS = ("linear_ce_fwd", "linear_ce_bwd")
# the decode kernels one of which a rollout launches
DECODE_KERNELS = ("decode_attention_bf16", "decode_attention_q8", "decode_megakernel",
                  "paged_attention")


def finite_steps(history, keys=None) -> list:
    """The metrics of each step that are not finite (all, or ``keys``)."""
    return [f"step {i + 1} {k}" for i, h in enumerate(history) for k, v in h.items()
            if (keys is None or k in keys) and not np.isfinite(v)]


def small_defaults_phase(kerns, gpu) -> dict:
    """Phase 18: on the card, through their entry points, the default runs
    whose model (heads of 16, f32) no kernel took before: ``main_grpo`` on
    grpo_demo_tiny.yaml as shipped for 2 steps, ``main_agent_grpo`` at its
    default ``--preset tiny`` for 2 steps, and ``serve_openai`` at its
    default ``--preset tiny`` answering 8 HTTP requests. Gates: finite
    metrics, K5 and K6 and a decode kernel launched by each training run,
    every request answered with its budget."""
    import concurrent.futures
    import tempfile

    from rlinf_tpu_torch import main_agent_grpo, main_grpo, serve_openai

    out = {"phase": "small_defaults", "gpu": gpu}
    bad = []
    with tempfile.TemporaryDirectory() as tmp:
        runs = {
            "main_grpo grpo_demo_tiny.yaml": lambda: main_grpo.main(
                ["--config", str(HERE / TINY_YAML), "runner.max_steps=2",
                 f"runner.log_dir={tmp}/grpo", "runner.checkpoint_dir=null"]),
            "main_agent_grpo --preset tiny": lambda: main_agent_grpo.main(
                ["runner.max_steps=2", f"runner.log_dir={tmp}/agent"]),
        }
        for name, fn in runs.items():
            history, secs, counts = run_counted(kerns, fn)
            out[name] = {"seconds": secs, "launches": counts,
                         "steps": [{k: v for k, v in h.items() if k.startswith(("time/", "actor/"))}
                                   for h in history]}
            bad += [f"{name}: {b}" for b in finite_steps(history)]
            bad += [f"{name}: {k} not launched" for k in SMALL_TRAIN_KERNELS if not counts[k]]
            if not any(counts[k] for k in DECODE_KERNELS):
                bad.append(f"{name}: no decode kernel launched")
    server, http = serve_openai.build_server(serve_openai.parse_args(
        ["--port", "0", "--max-new-tokens", "32"]))
    bodies = [("/v1/completions", {"prompt": f"Request {i}", "max_tokens": 16}) if i % 2 == 0
              else ("/v1/chat/completions",
                    {"messages": [{"role": "user", "content": f"hi {i}"}], "max_tokens": 16})
              for i in range(8)]
    try:
        def run():
            with concurrent.futures.ThreadPoolExecutor(8) as pool:
                return list(pool.map(lambda b: http_json(http.url + b[0], b[1]), bodies))

        answers, secs, counts = run_counted(kerns, run)
        health = http_json(http.url + "/health")
    finally:
        http.stop()
        server.stop()
    out["serve_openai --preset tiny"] = {"seconds": secs, "launches": counts, "health": health}
    if not (all(a["usage"]["completion_tokens"] == 16 for a in answers)
            and any(counts[k] for k in DECODE_KERNELS)):
        bad.append(f"serve_openai: {answers}, {counts}")
    emit(out)
    if bad:
        raise AssertionError(f"small default runs failed: {bad}")
    launches = {k: 0 for k in kerns}
    for v in out.values():
        if isinstance(v, dict) and "launches" in v:
            for k, c in v["launches"].items():
                launches[k] += c
    return launches


# ---------------------------------------------------------------------------
# Phase 19: PPO with a learned critic
# ---------------------------------------------------------------------------

# grpo_math_qwen05b.yaml turned into PPO with a learned critic, then the
# runner phase's cut: each override and why
CRITIC_OVERRIDES = {
    "algorithm.adv_type=gae": "PPO: GAE over a learned critic's values",
    "algorithm.group_size=1": "PPO: no response groups",
    "algorithm.critic_warmup_steps=1": "step 1 trains the critic alone, steps 2-3 both",
    "loss.max_tokens_per_mb=0": "the token-budget path never steps the critic (as in the JAX "
                                "runner): static minibatches",
}
CRITIC_REDUCED = {
    "runner.rollout_batch_size=64": "64 prompts x group_size 1 = 64 rows a step, the runner "
                                    "phase's rows (the yaml: 512)",
    "sampling.max_new_tokens=256": "the yaml has 1024",
    "rollout.num_slots=64": "one wave: a slot for every row",
    "runner.max_steps=3": "the yaml has 400",
    "runner.save_interval=3": "one checkpoint, at the last step (the yaml: every 50)",
}
#: the critic runs at a sixth of the model's depth (the runner phase runs
#: half, RUNNER_CUT), so that the whole script stays inside its time limit
CRITIC_CUT = {"model.num_layers=4": "4 of Qwen2.5-0.5B's 24 layers: the script's time limit "
                                     "(12 until phase 26 came, 6 until its parts came)"}
CRITIC_KERNELS = ("flash_attention_fwd", "decode_attention_bf16", "linear_ce_fwd",
                  "linear_ce_bwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
# the shadow steps: one critic step (separate) and one actor-critic step
# (shared head) from one state on one batch, with the kernels and with
# their plain versions. values: max-abs error over max |plain| of the value
# fn's values (24 bf16 layers apart); the critic's value loss and the grad
# norm, relative; the actor-critic's total loss, absolute; the f32 updates
# handed to the params, norm of the difference over the plain run's. The
# bars are about 2x (values) and 3x or more (the rest) the readings of the
# phase's first run on an H100 at seed 0 (values 1.92%, 2.12%; value loss
# 5.7e-4, 5.7e-4; grad norm 3.1e-5, 3.2e-4; loss 2.3e-4; updates 0.38%,
# 0.86%; PERF.md, Findings)
CRITIC_SHADOW_BARS = {"values_rel": 4e-2, "value_loss_rel": 5e-3, "loss_abs": 1e-3,
                      "grad_norm_rel": 5e-3, "update_rel": 3e-2}


def critic_shadow(runner, result, kerns) -> dict:
    """One critic update (separate) or actor-critic update (shared head)
    on the first minibatch of ``result``'s batch (rewards of ``text_rule``,
    GAE on the runner's critic), from the runner's state, with every
    training kernel replaced by its plain version and then with the
    kernels; the runner's state is left as it was."""
    from rlinf_tpu_torch.data.io_struct import build_train_batch

    sep = runner.separate_critic
    rewards = np.asarray(text_rule(result.response_texts(runner.tokenizer), result.answers),
                         np.float32)
    tb = build_train_batch(result, np.zeros_like(result.response_logprobs),
                           pad_id=runner.cfg.sampling.pad_token_id)
    runs = {}
    for mode in ("plain", "kernels"):
        with (kernels_replaced(plain_only, _training_sites()) if mode == "plain"
              else contextlib.nullcontext()):
            extra = runner._gae_token_advantages(tb, rewards)
            batch = runner._put_batch({**tb.to_dict(), "advantages": extra["advantages"],
                                       "returns": extra["returns"],
                                       "prev_values": extra["prev_values"]})
            if runner.logprob_fn is not None:
                lp, _ = runner.logprob_fn(runner.state.params, batch)
                batch["old_logprobs"] = torch.where(batch["loss_mask"], lp, 0.0)
            rows = batch["input_ids"].shape[0] // runner.cfg.runner.num_mini_batches
            mb = {k: v[:rows] for k, v in batch.items()}
            state = clone_tree(runner.critic_state if sep else runner.state)
            updates = []
            with summing_updates(updates):
                (_, m), secs, counts = run_counted(
                    kerns, lambda: (runner.critic_step if sep else runner.train_step)(state, mb))
            runs[mode] = dict(values=torch.as_tensor(extra["prev_values"]), m=m,
                              updates=updates[0], counts=counts, seconds=secs)
            del state
    k, p = runs["kernels"], runs["plain"]
    out = {
        "step": "make_critic_train_step" if sep else "make_actor_critic_train_step",
        "reward_mean": float(rewards.mean()),
        "values_rel": rel_err(k["values"], p["values"]),
        "value_loss": [float(k["m"]["critic/value_loss"]), float(p["m"]["critic/value_loss"])],
        "value_loss_rel": abs(float(k["m"]["critic/value_loss"] - p["m"]["critic/value_loss"]))
                          / max(abs(float(p["m"]["critic/value_loss"])), 1e-30),
        "update_rel": norm_rel(k["updates"], p["updates"]),
        "update_norm": [tree_norm(k["updates"]), tree_norm(p["updates"])],
        "seconds": [k["seconds"], p["seconds"]], "kernel_launches": k["counts"],
        "bars": CRITIC_SHADOW_BARS,
    }
    gn = "critic/grad_norm" if sep else "actor/grad_norm"
    out["grad_norm"] = [float(k["m"][gn]), float(p["m"][gn])]
    out["grad_norm_rel"] = abs(out["grad_norm"][0] - out["grad_norm"][1]) / max(out["grad_norm"][1], 1e-30)
    out["loss_abs"] = 0.0 if sep else abs(float(k["m"]["actor/loss"] - p["m"]["actor/loss"]))
    bad = [n for n, bar in CRITIC_SHADOW_BARS.items() if not out[n] < bar]
    if any(p["counts"].values()) or not k["counts"]["flash_attention_fwd"]:
        bad.append(f"launches {k['counts']} / plain {p['counts']}")
    if not sep and not (k["counts"]["linear_ce_fwd"] and k["counts"]["linear_ce_bwd"]):
        bad.append("the actor-critic step did not launch K5 and K6")
    out["bad"] = bad
    return out


def critic_phase(kerns, gpu, seed) -> dict:
    """Phase 19. (a) ppo_separate_critic.yaml as shipped (Hd=32, bf16, the
    continuous engine) through ``main_grpo.main`` for 3 steps with
    ``critic_warmup_steps=1``: step 1 skips the actor, steps 2 and 3 train
    it. (b) grpo_math_qwen05b.yaml's model at full width, CRITIC_CUT's
    depth, with CRITIC_OVERRIDES and CRITIC_REDUCED, once
    with a separate critic and
    once with the shared value head: 3 steps each, then a shadow step
    (``critic_shadow``) on step 1's rollout. Gates: K1, K2 and K5-K8
    launched; the critic's params moved; ``critic/*`` metrics finite; the
    shadow bars (CRITIC_SHADOW_BARS)."""
    import shutil

    from rlinf_tpu_torch import main_grpo
    from rlinf_tpu_torch.models.llm.value_head import init_value_head
    from rlinf_tpu_torch.training.critic import init_critic_params

    t_phase = time.perf_counter()
    work = HERE / "build" / "critic_smoke"
    shutil.rmtree(work, ignore_errors=True)
    out = {"phase": "critic", "gpu": gpu}
    bad, launches = [], {k: 0 for k in kerns}

    ppo = [f"runner.log_dir={work / 'ppo_logs'}", "runner.max_steps=3",
           "algorithm.critic_warmup_steps=1", f"runner.seed={seed}"]
    history, secs, counts = run_counted(
        kerns, lambda: main_grpo.main(["--config", str(HERE / PPO_YAML), *ppo]))
    out["ppo_separate_critic.yaml"] = {
        "overrides": ppo, "seconds": secs, "launches": counts,
        "steps": [{k: v for k, v in h.items() if k.startswith(("time/", "actor/", "critic/"))}
                  for h in history]}
    bad += [f"ppo yaml {b}" for b in finite_steps(history)]
    if not ([h.get("actor/warmup_skipped") for h in history] == [1.0, None, None]
            and all("critic/value_loss" in h for h in history)):
        bad.append("ppo yaml: the warmup step and the actor steps")
    bad += [f"ppo yaml: {k} not launched" for k in SMALL_TRAIN_KERNELS if not counts[k]]
    for k, c in counts.items():
        launches[k] += c

    for critic in ("separate", "shared"):
        overrides = [*CRITIC_OVERRIDES, *CRITIC_REDUCED, *CRITIC_CUT, f"algorithm.critic={critic}",
                     f"runner.seed={seed}", f"runner.log_dir={work / critic / 'logs'}",
                     f"runner.checkpoint_dir={work / critic / 'ckpt'}"]
        record = {}
        torch.cuda.reset_peak_memory_stats()
        with watching_runner(record):
            history, secs, counts = run_counted(
                kerns, lambda: main_grpo.main(["--config", str(HERE / RUNNER_YAML), *overrides]))
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        r, result = record["runner"], record["result"]
        if critic == "separate":    # the critic's init, drawn again from its seed
            start = init_critic_params(r.cfg.model, r.cfg.runner.seed + 104729, device="cuda")
            moved = moved_share(r.critic_state.params, start)
            del start
        else:
            moved = moved_share({"v": r.state.params["value_head"]},
                                {"v": init_value_head(r.cfg.model, r.cfg.runner.seed + 7,
                                                      device="cuda")})
        row = {"config": RUNNER_YAML, "critic": critic, "overrides": CRITIC_OVERRIDES,
               "reduced": {**CRITIC_REDUCED, **CRITIC_CUT}, "layers": r.cfg.model.num_layers,
               "rows": len(result.prompt_lengths), "seconds": secs, "launches": counts,
               "max_memory_allocated_gb": peak_gb, "critic_params_moved_share": moved,
               "critic_step_s": list(record["critic_step_s"]),
               "recompute_s": list(record["recompute_s"]),
               "logprob_drift_step1": {"kernels": behaviour_drift(r, result, lp=record["lp"]),
                                       "plain": record["drift_plain"]},
               "steps": [{k: v for k, v in h.items() if k.startswith(("time/", "actor/", "critic/", "perf/"))}
                         for h in history]}
        shadow = critic_shadow(r, result, kerns)
        row["shadow"] = shadow
        out[f"qwen2_0_5b {critic}"] = row
        bad += [f"{critic}: {k} not launched" for k in CRITIC_KERNELS if not counts[k]]
        bad += [f"{critic}: {b}" for b in finite_steps(
            history, [k for h in history for k in h if k.startswith("critic/")])]
        if not any(k.startswith("critic/") for k in history[-1]):
            bad.append(f"{critic}: no critic metrics")
        if not moved:
            bad.append(f"{critic}: the critic's params did not move")
        if [h.get("actor/warmup_skipped") for h in history][:1] != ([1.0] if critic == "separate" else [None]):
            bad.append(f"{critic}: warmup step")
        bad += [f"{critic} shadow: {b}" for b in shadow["bad"]]
        for k, c in counts.items():
            launches[k] += c
        del r, record, result
        gc.collect()
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    if bad:
        raise AssertionError(f"critic phase failed: {bad}")
    return launches

# ---------------------------------------------------------------------------
# Phase 20: adafactor, under remat=True and remat="dots"
# ---------------------------------------------------------------------------

#: the two recompute forms phase 20 trains under
REMAT_FORMS = (True, "dots")


def tree_bytes(tree) -> int:
    """Bytes of the tensors of a tree (dicts, lists, tuples, NamedTuples)."""
    from rlinf_tpu_torch.utils.checkpoint import flatten

    return sum(t.numel() * t.element_size() for t in flatten(tree).values()
               if isinstance(t, torch.Tensor))


def remat_grads_check(cfg, params, loss_cfg, mb, global_valid, kerns) -> dict:
    """One microbatch's gradients through ``learner._grads`` under
    remat=True and remat="dots" from the same params: K1's launches in the
    forward and backward (the kernel runs inside an autograd Function that
    the selective policy cannot keep, so each form recomputes it: 2 a
    layer), and the two forms' gradients, bitwise or apart by the shadow
    bars (grad norm; the gradients' direction by the first-moment bar)."""
    from rlinf_tpu_torch.training.learner import _grads, microbatch_loss_with_moe

    grads, out = {}, {}
    for remat in REMAT_FORMS:
        def run():
            return _grads(params, lambda p: microbatch_loss_with_moe(
                p, cfg, loss_cfg, mb, global_valid, attn_impl="pallas", remat=remat))
        (g, loss, _), secs, counts = run_counted(kerns, run)
        grads[remat] = g
        out[str(remat)] = {"loss": float(loss), "seconds": secs,
                           "k1_launches": counts["flash_attention_fwd"],
                           "launches": {k: c for k, c in counts.items() if c}}
    a, b = grads["dots"], grads[True]
    out["bitwise_equal"] = not state_differences(a, b)
    out["grad_norm"] = [tree_norm(a), tree_norm(b)]
    out["grad_norm_rel"] = abs(out["grad_norm"][0] - out["grad_norm"][1]) / max(out["grad_norm"][1], 1e-30)
    out["grads_rel"] = norm_rel(a, b)
    out["k1_launches_wanted"] = 2 * cfg.num_layers
    return out


def adafactor_remat_phase(kerns, gpu, batch, adamw_state_bytes, seed) -> dict:
    """Phase 20: the training phase's batch (B=64, T=768, 4 microbatches,
    entropy bonus 1e-3) at Qwen2-1.5B's full width and depth with adafactor
    at lr 1e-6 and no master copy (bench.py's optimizer for presets above
    1e9 parameters), TRAIN_STEPS steps under remat=True and TRAIN_STEPS
    under remat="dots", each from a fresh init: the median of steps 2-4,
    peak memory, the optimizer state's bytes beside the training phase's
    adamw with master weights. Gates: K1 and K5-K8 launched under each
    form, finite loss and grad norm, K1 twice a layer in one microbatch's
    forward and backward under each form, and the two forms' gradients on
    one microbatch bitwise equal or within the shadow bars."""
    from rlinf_tpu_torch.models.llm import model as M
    from rlinf_tpu_torch.models.llm.config import LLMConfig
    from rlinf_tpu_torch.training.learner import PolicyLossConfig, make_policy_train_step
    from rlinf_tpu_torch.training.train_state import OptimizerConfig, TrainState, make_optimizer

    t_phase = time.perf_counter()
    cfg = LLMConfig.qwen2_1_5b()
    loss_cfg = PolicyLossConfig(entropy_bonus=1e-3)
    opt = OptimizerConfig(name="adafactor", lr=1e-6)
    tx = make_optimizer(opt)
    host = batch.to_dict()
    B, T = host["input_ids"].shape
    out = {"phase": "adafactor_remat", "gpu": gpu, "model": "qwen2_1_5b",
           "layers": cfg.num_layers, "batch": B, "seq_len": T, "num_microbatches": 4,
           "optimizer": dataclasses.asdict(opt),
           "adamw_master_state_gb": adamw_state_bytes / 1e9}
    bad, launches = [], {k: 0 for k in kerns}

    # one init (about as long as a whole form's steps): each form starts
    # from a copy of it
    params0 = M.init_params(cfg, seed, device="cuda")
    dev = {k: torch.as_tensor(v).cuda() for k, v in host.items()}
    mb = {k: v[:B // 4] for k, v in dev.items()}
    gv = dev["loss_mask"].float().sum().clamp_min(1.0)
    check = remat_grads_check(cfg, params0, loss_cfg, mb, gv, kerns)
    out["grads_check"] = check
    del dev, mb
    for form in REMAT_FORMS:
        if check[str(form)]["k1_launches"] != check["k1_launches_wanted"]:
            bad.append(f"remat={form}: K1 launched {check[str(form)]['k1_launches']} times in "
                       f"one microbatch's forward and backward")
    if not check["bitwise_equal"] and not (
            check["grad_norm_rel"] < SHADOW_BARS["grad_norm_rel"]
            and check["grads_rel"] < SHADOW_BARS["first_moment_rel"]):
        bad.append(f"remat='dots' gradients against remat=True's: {check}")

    for form in REMAT_FORMS:
        params = clone_tree(params0)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step_fn = make_policy_train_step(cfg, loss_cfg, tx, num_microbatches=4, remat=form,
                                         attn_impl="pallas", device="cuda")
        state = TrainState(0, params, tx.init(params))
        state_bytes = tree_bytes(state.opt_state)
        steps, metrics = [], []
        watch = StepWatch()

        def run(state=state):
            for _ in range(TRAIN_STEPS):
                (state, m), rec = watch.step(lambda: step_fn(state, host))
                steps.append(rec)
                metrics.append({k: float(v) for k, v in m.items()})
            return state

        state, secs, counts = run_counted(kerns, run)
        watch.close()
        peak = torch.cuda.max_memory_allocated() / 1e9
        later = sorted(r["seconds"] for r in steps[1:])
        moved = moved_share(state.params, params0)
        out[f"remat={form}"] = {
            "seconds": secs, "steps": steps, "step_s_median": later[len(later) // 2],
            "step_s_min": later[0], "max_memory_allocated_gb": peak,
            "optimizer_state_gb": state_bytes / 1e9,
            "params_moved_share": moved, "metrics": metrics, "launches": counts}
        bad += [f"remat={form}: {k} not launched" for k in TRAIN_KERNELS if not counts[k]]
        bad += [f"remat={form}: step {i + 1} {k}" for i, m in enumerate(metrics)
                for k in ("actor/loss", "actor/grad_norm") if not np.isfinite(m[k])]
        for k, c in counts.items():
            launches[k] += c
        del state, params, step_fn
    del params0
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    if bad:
        raise AssertionError(f"adafactor/remat phase failed: {bad}")
    return launches


# ---------------------------------------------------------------------------
# Phase 21: LoRA through main_grpo
# ---------------------------------------------------------------------------

# the runner phase's yaml and cut, in LoRA mode: each override and why
LORA_OVERRIDES = {
    "lora.enabled=true": "rank-16 adapters (alpha 32) on the default targets (wq, wk, wv, "
                         "wo, gate, up, down); the base frozen",
    "loss.max_tokens_per_mb=0": "LoRA refuses the token budget (as the JAX runner): "
                                "static minibatches",
}
LORA_HEAD_TARGETS = "lora.targets=[wq,wk,wv,wo,gate,up,down,lm_head]"
#: the LoRA runs at a sixth of the model's depth (the runner phase runs
#: half, RUNNER_CUT), so that the whole script stays inside its time limit
LORA_CUT = {"model.num_layers=4": "4 of Qwen2.5-0.5B's 24 layers: the script's time limit "
                                   "(12 until phase 26 came, 6 until its parts came)"}


@contextlib.contextmanager
def weight_grad_always():
    """K6's wrapper as it was before it skipped the lm head's dw product for
    a frozen head: dw from the saved dz whether the weight needs it or not."""
    from rlinf_tpu_torch.ops.cuda import linear_ce as LCE

    orig = LCE.LinearCE.backward

    def backward(ctx, g_lp, g_ent):
        h2, w, tgt, lse, ent = ctx.saved_tensors
        g_lp = torch.zeros_like(lse) if g_lp is None else g_lp.float().contiguous()
        g_ent = torch.zeros_like(lse) if g_ent is None else g_ent.float().contiguous()
        dz, dh = LCE.ce_backward(h2, w, tgt, lse, lse - ent, g_lp, g_ent, ctx.inv_temp,
                                 ctx.w_layout)
        dw = LCE.weight_grad(h2, dz, ctx.w_layout, LCE._vocab(w, ctx.w_layout), w.dtype)
        return dh, dw, None, None, None

    LCE.LinearCE.backward = staticmethod(backward)
    try:
        yield
    finally:
        LCE.LinearCE.backward = orig


def lora_minibatch(runner, result) -> dict:
    """The first minibatch of ``result``'s train batch as the runner's
    step takes it: rewards of ``text_rule``, GRPO advantages, the recompute
    as old logprobs (on the merged params)."""
    from rlinf_tpu_torch.data.io_struct import build_train_batch

    rewards = np.asarray(text_rule(result.response_texts(runner.tokenizer), result.answers),
                         np.float32)
    tb = build_train_batch(result, runner._compute_advantages(result, rewards),
                           pad_id=runner.cfg.sampling.pad_token_id)
    batch = runner._put_batch(tb.to_dict())
    lp, _ = runner.logprob_fn(runner._policy_params(), batch)
    batch["old_logprobs"] = torch.where(batch["loss_mask"], lp, 0.0)
    rows = batch["input_ids"].shape[0] // runner.cfg.runner.num_mini_batches
    return {k: v[:rows] for k, v in batch.items()}


def lora_phase(kerns, gpu, seed) -> dict:
    """Phase 21. (a) ``main_grpo.main`` on grpo_math_qwen05b.yaml in LoRA
    mode (LORA_OVERRIDES, the runner phase's RUNNER_REDUCED, LORA_CUT's
    depth): 3 steps with
    the math verifier. (b) A ReasoningRunner on the same config with
    ``text_rule`` rewards (non-zero advantages) for 3 steps, then the gates:
    the base params bitwise the init's, the adapters' b moved from 0, each
    rollout's params bitwise ``merge_lora(base, adapters)`` of its step, a
    shadow step (kernels against plain, SHADOW_BARS), a ``resume=auto``
    runner and a ``lora.path`` runner holding the adapters bitwise, K1, K2
    and K5-K8 launched; the train step on one minibatch with K6's dw
    product skipped (a frozen head) and computed, in turns. (c) One step
    with "lm_head" among the targets (K5 and K6 on the explicit untied
    head)."""
    import shutil

    from rlinf_tpu_torch import main_grpo
    from rlinf_tpu_torch.config import load_config
    from rlinf_tpu_torch.data.tokenizers import ByteTokenizer
    from rlinf_tpu_torch.models.llm.lora import lora_num_params, merge_lora
    from rlinf_tpu_torch.models.llm.model import init_params
    from rlinf_tpu_torch.models.llm.quant import quantize_params
    from rlinf_tpu_torch.runners import ReasoningRunner
    from rlinf_tpu_torch.training.train_state import tree_leaves
    from rlinf_tpu_torch.utils.checkpoint import flatten

    t_phase = time.perf_counter()
    work = HERE / "build" / "lora_smoke"
    shutil.rmtree(work, ignore_errors=True)
    yaml = str(HERE / RUNNER_YAML)
    base_ov = [*LORA_OVERRIDES, *RUNNER_REDUCED, *LORA_CUT, f"runner.seed={seed}"]
    out = {"phase": "lora", "gpu": gpu, "config": RUNNER_YAML, "overrides": LORA_OVERRIDES,
           "reduced": {**RUNNER_REDUCED, **LORA_CUT}}
    bad, launches = [], {k: 0 for k in kerns}
    steps_of = lambda history: [{k: v for k, v in h.items()
                                 if k.startswith(("time/", "actor/", "perf/"))} for h in history]

    # (a) through the entry point
    record = {}
    torch.cuda.reset_peak_memory_stats()
    with watching_runner(record):
        history, secs, counts = run_counted(kerns, lambda: main_grpo.main(
            ["--config", yaml, *base_ov, f"runner.log_dir={work / 'logs'}",
             "runner.checkpoint_dir=null"]))
    r0 = record["runner"]
    trainable = lora_num_params(r0.state.params)
    total = sum(t.numel() for t in tree_leaves(r0.base_params))
    out["main_grpo"] = {"seconds": secs, "launches": counts, "steps": steps_of(history),
                        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
                        "recompute_s": list(record["recompute_s"]),
                        "logprob_drift_step1": {"kernels": behaviour_drift(r0, record["result"],
                                                                           lp=record["lp"]),
                                                "plain": record["drift_plain"]}}
    out["trainable_params"], out["base_params"] = trainable, total
    out["trainable_share"] = trainable / total
    bad += [f"main_grpo: {k} not launched" for k in RUNNER_KERNELS if not counts[k]]
    bad += [f"main_grpo: {b}" for b in finite_steps(history)]
    for k, c in counts.items():
        launches[k] += c
    del record, r0
    gc.collect()
    torch.cuda.empty_cache()

    # (b) rule rewards, the gates
    ov = [*base_ov, "runner.log_dir=null", f"runner.checkpoint_dir={work / 'ckpt'}"]
    record = {}
    torch.cuda.reset_peak_memory_stats()
    r1 = ReasoningRunner(load_config(yaml, ov), ByteTokenizer(), main_grpo.synthetic_dataset(),
                         reward_fn=text_rule, device="cuda")
    seen = []
    engine_rollout = r1.engine.rollout

    def rollout(params, request, generator, **kw):
        seen.append((params, clone_tree(r1.state.params)))
        return engine_rollout(params, request, generator, **kw)

    r1.engine.rollout = rollout
    with watching_runner(record):
        history, secs, counts = run_counted(kerns, lambda: r1.run(3))
    peak = torch.cuda.max_memory_allocated() / 1e9
    result = record["result"]
    row = {"seconds": secs, "launches": counts, "steps": steps_of(history),
           "max_memory_allocated_gb": peak, "recompute_s": list(record["recompute_s"])}
    fresh = init_params(r1.cfg.model, seed, device="cuda")
    row["base_differs_from_init_at"] = state_differences(r1.base_params, fresh)
    del fresh
    row["b_nonzero"] = {k: bool(v.any()) for k, v in flatten(r1.state.params).items()
                        if k.endswith("/b")}
    row["engine_params_differ_from_merge_at"] = [
        state_differences(params, merge_lora(r1.base_params, adapters, r1.cfg.lora))
        for params, adapters in seen]
    del seen
    r1.engine.rollout = engine_rollout
    with torch.no_grad():
        row["merge_ms"] = cuda_ms(r1._policy_params, 3, warmup=1)
        row["quantize_params_ms"] = cuda_ms(lambda: quantize_params(r1._policy_params()), 3,
                                            warmup=1)
    bad += [f"rule run: {k} not launched" for k in RUNNER_KERNELS if not counts[k]]
    bad += [f"rule run: {b}" for b in finite_steps(history)]
    if row["base_differs_from_init_at"]:
        bad.append(f"the base params changed: {row['base_differs_from_init_at'][:5]}")
    if not all(row["b_nonzero"].values()):
        bad.append(f"adapters' b still zero: {row['b_nonzero']}")
    if len(row["engine_params_differ_from_merge_at"]) != 3 or any(
            row["engine_params_differ_from_merge_at"]):
        bad.append(f"engine params vs merge: {row['engine_params_differ_from_merge_at']}")
    for k, c in counts.items():
        launches[k] += c

    # K6's dw product skipped for the frozen tied head, and computed, in turns
    mb = lora_minibatch(r1, result)
    start = clone_tree(r1.state)
    step = lambda: r1.train_step(clone_tree(start), mb)
    dw = {"skip": [], "dw": []}
    for mode in ("skip", "dw", "dw", "skip", "skip", "dw"):
        with weight_grad_always() if mode == "dw" else contextlib.nullcontext():
            dw[mode].append(cuda_ms(step, 5, warmup=1))
    row["train_step_ms_frozen_head"] = {"dw_skipped": dw["skip"], "dw_computed": dw["dw"],
                                        "rows": int(mb["input_ids"].shape[0]),
                                        "seq_len": int(mb["input_ids"].shape[1])}
    del mb, start

    # shadow step on step 1's rollout; the runner keeps the kernels' run (step 4)
    shadow, _ = shadow_step(r1, result, kerns)
    row["shadow"] = shadow
    r1.save_checkpoint()
    r2 = ReasoningRunner(load_config(yaml, ov), ByteTokenizer(), main_grpo.synthetic_dataset(),
                         device="cuda")
    r3 = ReasoningRunner(load_config(yaml, [*base_ov, "runner.log_dir=null",
                                            "runner.checkpoint_dir=null",
                                            f"lora.path={work / 'ckpt'}"]),
                         ByteTokenizer(), main_grpo.synthetic_dataset(), device="cuda")
    row["resume"] = {"global_step": r2.global_step,
                     "state_differs_at": state_differences(r1.state, r2.state)}
    row["lora_path"] = {"global_step": r3.global_step,
                        "adapters_differ_at": state_differences(r1.state.params, r3.state.params)}
    if not (r2.global_step == 4 and not row["resume"]["state_differs_at"]):
        bad.append(f"resume=auto: {row['resume']}")
    if not (r3.global_step == 0 and not row["lora_path"]["adapters_differ_at"]):
        bad.append(f"lora.path: {row['lora_path']}")
    out["rule_rewards"] = row
    del r1, r2, r3, record, result
    gc.collect()
    torch.cuda.empty_cache()

    # (c) an lm_head target: K5/K6 on the explicit [D, V] head
    r4 = ReasoningRunner(load_config(yaml, [*base_ov, LORA_HEAD_TARGETS, "runner.log_dir=null",
                                            "runner.checkpoint_dir=null"]),
                         ByteTokenizer(), main_grpo.synthetic_dataset(), reward_fn=text_rule,
                         device="cuda")
    history, secs, counts = run_counted(kerns, lambda: r4.run(1))
    head = {"seconds": secs, "launches": counts, "steps": steps_of(history),
            "trainable_params": lora_num_params(r4.state.params),
            "lm_head_b_moved": bool(r4.state.params["lm_head"]["b"].any())}
    out["lm_head_target"] = head
    if not (counts["linear_ce_fwd"] and counts["linear_ce_bwd"] and head["lm_head_b_moved"]):
        bad.append(f"lm_head target: {head}")
    for k, c in counts.items():
        launches[k] += c
    del r4
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    if bad:
        raise AssertionError(f"LoRA phase failed: {bad}")
    return launches


# ---------------------------------------------------------------------------
# Phase 22: SFT through main_sft
# ---------------------------------------------------------------------------

# grpo_math_qwen05b.yaml's model and optimizer as SFT, cut to a short run:
# each override and why
SFT_REDUCED = {
    "runner.rollout_batch_size=64": "64 rows a batch",
    "runner.max_steps=3": "the yaml has 400",
    "runner.save_interval=3": "one checkpoint, at the last step (the yaml: every 50)",
}
SFT_EXAMPLES = 512


@contextlib.contextmanager
def watching_sft(record: dict):
    """For one main_sft run: keep the runner and each batch's shape."""
    from rlinf_tpu_torch.runners import sft_runner as SR

    orig = SR.SFTRunner._build_batch

    def build_batch(self, examples):
        record["runner"] = self
        batch = orig(self, examples)
        record.setdefault("batches", []).append(batch)
        return batch

    SR.SFTRunner._build_batch = build_batch
    try:
        yield
    finally:
        SR.SFTRunner._build_batch = orig


def sft_shadow(runner, batch, kerns) -> dict:
    """One SFT step from the runner's state on ``batch``, with every training
    kernel replaced by its plain version and then with the kernels; the
    runner's state is left as it was."""
    runs = {}
    for mode in ("plain", "kernels"):
        state, updates = clone_tree(runner.state), []
        with (kernels_replaced(plain_only, _training_sites()) if mode == "plain"
              else contextlib.nullcontext()), summing_updates(updates):
            (state, m), secs, counts = run_counted(kerns, lambda: runner.train_step(state, batch))
        runs[mode] = dict(m={k: float(v) for k, v in m.items()}, state=state,
                          updates=updates[0], counts=counts, seconds=secs)
        del state
    k, p = runs["kernels"], runs["plain"]
    out = {"loss": [k["m"]["sft/loss"], p["m"]["sft/loss"]],
           "loss_abs": abs(k["m"]["sft/loss"] - p["m"]["sft/loss"]),
           "grad_norm": [k["m"]["sft/grad_norm"], p["m"]["sft/grad_norm"]],
           "grad_norm_rel": abs(k["m"]["sft/grad_norm"] - p["m"]["sft/grad_norm"])
                            / max(p["m"]["sft/grad_norm"], 1e-30),
           "first_moment_rel": norm_rel(k["state"].opt_state["mu"], p["state"].opt_state["mu"]),
           "update_rel": norm_rel(k["updates"], p["updates"]),
           "update_norm": [tree_norm(k["updates"]), tree_norm(p["updates"])],
           "seconds": [k["seconds"], p["seconds"]], "kernel_launches": k["counts"],
           "bars": {n: SHADOW_BARS[n] for n in ("loss_abs", "grad_norm_rel",
                                                "first_moment_rel", "update_rel")}}
    out["bad"] = [n for n, bar in out["bars"].items() if not out[n] < bar]
    if [n for n in TRAIN_KERNELS if k["counts"][n]] != list(TRAIN_KERNELS) or any(
            p["counts"].values()):
        out["bad"].append(f"launches {k['counts']} / plain {p['counts']}")
    return out


def sft_phase(kerns, gpu, seed) -> dict:
    """Phase 22: ``main_sft.main`` on a jsonl of SFT_EXAMPLES synthetic
    GSM8K-style problems with chain-of-thought answers (the port's copy of
    gsm_synth, seeded), grpo_math_qwen05b.yaml's model at full width and
    depth (byte tokenizer, random weights), cut as SFT_REDUCED. Gates: each
    batch's T reaches ATTN_KERNELS_FROM_T (so K1, K7 and K8 run, not the
    plain attention), finite sft/loss, K1 and K5-K8 launched, a runner with
    resume=auto holding the run's state bitwise at step 3, and a shadow
    step (kernels against plain, SHADOW_BARS) on the last batch."""
    import tempfile

    from rlinf_tpu_torch import main_sft
    from rlinf_tpu_torch.config import ATTN_KERNELS_FROM_T, load_config
    from rlinf_tpu_torch.data.datasets import PromptDataset
    from rlinf_tpu_torch.data.gsm_synth import build_sft_examples
    from rlinf_tpu_torch.data.tokenizers import ByteTokenizer
    from rlinf_tpu_torch.runners import SFTRunner

    t_phase = time.perf_counter()
    yaml = str(HERE / RUNNER_YAML)
    out = {"phase": "sft", "gpu": gpu, "config": RUNNER_YAML, "reduced": SFT_REDUCED,
           "examples": SFT_EXAMPLES}
    bad = []
    with tempfile.TemporaryDirectory() as tmp:
        data = Path(tmp) / "sft.jsonl"
        data.write_text("\n".join(json.dumps({"prompt": e.prompt, "answer": e.answer})
                                  for e in build_sft_examples(SFT_EXAMPLES, seed)))
        ov = [*SFT_REDUCED, f"runner.seed={seed}", f"runner.log_dir={tmp}/logs",
              f"runner.checkpoint_dir={tmp}/ckpt"]
        record = {}
        torch.cuda.reset_peak_memory_stats()
        with watching_sft(record):
            history, secs, counts = run_counted(kerns, lambda: main_sft.main(
                ["--config", yaml, "--data-path", str(data), *ov]))
        r = record["runner"]
        T = [int(b["input_ids"].shape[1]) for b in record["batches"]]
        out.update({"seconds": secs, "launches": counts, "attn_impl": r.cfg.attn_impl,
                    "seq_len": T, "rows": [int(b["input_ids"].shape[0]) for b in record["batches"]],
                    "loss_tokens": [int(b["loss_mask"].sum()) for b in record["batches"]],
                    "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "steps": history})
        if min(T) < ATTN_KERNELS_FROM_T:
            bad.append(f"T {T} under {ATTN_KERNELS_FROM_T}: the plain attention ran")
        bad += [f"{k} not launched" for k in TRAIN_KERNELS if not counts[k]]
        bad += [b for b in finite_steps(history)]
        r2 = SFTRunner(load_config(yaml, ov), ByteTokenizer(), PromptDataset.from_jsonl(str(data)),
                       device="cuda")
        out["resume"] = {"global_step": r2.global_step,
                         "state_differs_at": state_differences(r.state, r2.state),
                         "iterator_equal": r2.iterator.state_dict() == r.iterator.state_dict()}
        if not (r2.global_step == 3 and not out["resume"]["state_differs_at"]
                and out["resume"]["iterator_equal"]):
            bad.append(f"resume: {out['resume']}")
        del r2
        shadow = sft_shadow(r, record["batches"][-1], kerns)
        out["shadow"] = shadow
        bad += [f"shadow: {b}" for b in shadow["bad"]]
        del r, record
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds_phase"] = time.perf_counter() - t_phase
    emit(out)
    if bad:
        raise AssertionError(f"SFT phase failed: {bad}")
    return counts


# ---------------------------------------------------------------------------
# Phases 23-24: Hugging Face checkpoints, the MoE model family
# ---------------------------------------------------------------------------

#: the tokenizer fixture (a Qwen2-style byte-level BPE with ChatML) that the
#: checkpoints written here carry
TOKENIZER_FIXTURE = "tests/fixtures/hf_tokenizer"
#: the published widths of the two checkpoints phase 23 writes, as
#: config.json holds them (random weights from --seed)
#: the checkpoints' depth (their widths are the published ones): the
#: script's time limit (all 24 and 28 layers until phase 26's expert-axis
#: parts came)
HF_CUT = {"num_hidden_layers=4": "4 of Qwen2.5-0.5B's 24 and Qwen3-0.6B's 28 layers: the "
                                 "script's time limit (whole until phase 26's expert-axis "
                                 "parts came, 8 until phase 28 came)"}
HF_CHECKPOINTS = {
    "qwen2_5_0_5b": ("qwen2_0_5b", {"model_type": "qwen2", "architectures": ["Qwen2ForCausalLM"],
                                    "max_position_embeddings": 32768}),
    "qwen3_0_6b": ("qwen3_0_6b", {"model_type": "qwen3", "architectures": ["Qwen3ForCausalLM"],
                                  "max_position_embeddings": 40960}),
}
HF_GRPO_REDUCED = {**{k: v for k, v in RUNNER_REDUCED.items()
                      if not k.startswith(("runner.max_steps", "runner.save_interval"))},
                   "runner.max_steps=2": "the yaml has 400"}
HF_SFT_REDUCED = {**{k: v for k, v in SFT_REDUCED.items()
                     if not k.startswith(("runner.max_steps", "runner.save_interval"))},
                  "runner.max_steps=2": "the yaml has 400"}
#: the Qwen3-0.6B forward, kernels against plain (K1 at Hd=128, G=2 with
#: qk-norm): the logits' max-abs error over the plain run's max |logit|,
#: and the log-softmax at random targets (SHADOW_BARS' logprob bar)
QWEN3_FORWARD_BARS = {"logits_rel": 5e-2, "logprob_max_abs": 0.1}


def hf_packages() -> dict:
    """Whether this machine has the Hugging Face packages (found, not
    imported: the port reads the files itself)."""
    import importlib.util

    return {m: importlib.util.find_spec(m) is not None
            for m in ("transformers", "safetensors", "tokenizers", "jinja2")}


def write_hf_checkpoint(path: Path, preset: str, extra: dict, seed: int):
    """A bf16 HF checkpoint of ``LLMConfig.<preset>()`` at ``path``:
    random weights from ``seed`` through ``params_to_hf_state_dict`` and the
    port's safetensors writer (a tied model's ``lm_head.weight`` left out,
    as published checkpoints leave it), its ``config.json`` and the
    tokenizer fixture -> (cfg, params on the card, seconds)."""
    import shutil

    from rlinf_tpu_torch.models.llm.config import LLMConfig
    from rlinf_tpu_torch.models.llm.hf_files import write_safetensors
    from rlinf_tpu_torch.models.llm.hf_import import params_to_hf_state_dict
    from rlinf_tpu_torch.models.llm.model import init_params

    t0 = time.perf_counter()
    cfg = dataclasses.replace(getattr(LLMConfig, preset)(),
                              max_seq_len=extra["max_position_embeddings"],
                              num_layers=int(next(iter(HF_CUT)).split("=")[1]))
    params = init_params(cfg, seed, device="cuda")
    sd = params_to_hf_state_dict(params, cfg)
    if cfg.tie_word_embeddings:
        sd.pop("lm_head.weight")
    path.mkdir(parents=True, exist_ok=True)
    write_safetensors(str(path / "model.safetensors"),
                      {k: v.to(torch.bfloat16) for k, v in sd.items()}, {"format": "pt"})
    del sd
    config = {**extra, "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
              "intermediate_size": cfg.intermediate_size, "num_hidden_layers": cfg.num_layers,
              "num_attention_heads": cfg.num_heads, "num_key_value_heads": cfg.num_kv_heads,
              "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_eps,
              "tie_word_embeddings": cfg.tie_word_embeddings, "torch_dtype": "bfloat16"}
    if cfg.head_dim is not None:      # Qwen3's configs name it; Qwen2's do not
        config["head_dim"] = cfg.head_dim
    (path / "config.json").write_text(json.dumps(config, indent=2))
    for f in (HERE / TOKENIZER_FIXTURE).iterdir():
        shutil.copy(f, path / f.name)
    return cfg, params, time.perf_counter() - t0


def timed_load(path: Path) -> tuple:
    """``load_hf_pretrained`` of ``path`` on the card -> (cfg, params,
    seconds, peak GB of the load)."""
    from rlinf_tpu_torch.models.llm.hf_import import load_hf_pretrained

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params = load_hf_pretrained(str(path), dtype="bfloat16", device="cuda")
    torch.cuda.synchronize()
    return cfg, params, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 1e9


def qwen3_forward_check(kerns, cfg, params, seed) -> dict:
    """One forward of the Qwen3-0.6B checkpoint (4 rows of 256 tokens, one
    left-padded to 200) through the kernels and through their plain
    versions: the logits' error and the logprobs at random targets."""
    from rlinf_tpu_torch.models.llm.model import forward_hidden, lm_head_logits

    g = torch.Generator(device="cuda").manual_seed(seed + 230)
    B, T = 4, 256
    ids = torch.randint(0, cfg.vocab_size, (B, T), generator=g, device="cuda")
    mask = torch.ones(B, T, dtype=torch.bool, device="cuda")
    mask[1, :56] = False
    targets = torch.randint(0, cfg.vocab_size, (B, T), generator=g, device="cuda")

    def run():
        with torch.inference_mode():
            h, _ = forward_hidden(params, cfg, ids, attention_mask=mask, attn_impl="pallas")
            logits = lm_head_logits(params, cfg, h)
        return logits, torch.log_softmax(logits, -1).gather(-1, targets[..., None])[..., 0]

    (lk, pk), secs, counts = run_counted(kerns, run)
    with kernels_replaced(plain_only, _training_sites()):
        lp_plain, pp = run()
    valid = mask[..., None]
    err = ((lk - lp_plain).abs() * valid).max().item()
    out = {"rows": B, "T": T, "launches": {k: c for k, c in counts.items() if c},
           "logits_max_abs_err": err, "logits_max_abs": lp_plain.abs().max().item(),
           "logits_rel": err / max(lp_plain.abs().max().item(), 1e-30),
           "logprob_max_abs": ((pk - pp).abs() * mask).max().item(),
           "seconds": secs, "bars": QWEN3_FORWARD_BARS}
    out["bad"] = [n for n, bar in QWEN3_FORWARD_BARS.items() if not out[n] < bar]
    if counts["flash_attention_fwd"] != cfg.num_layers or sum(counts.values()) != cfg.num_layers:
        out["bad"].append(f"launches {counts}")
    return out


def serve_hf_check(kerns, path: Path) -> dict:
    """``serve_openai --model`` on the checkpoint: one completion and one chat
    request over loopback; the engine decodes on K2 (its prefill runs the
    plain attention, as in the JAX example)."""
    from rlinf_tpu_torch import serve_openai

    t0 = time.perf_counter()
    server, http = serve_openai.build_server(serve_openai.parse_args(
        ["--model", str(path), "--port", "0", "--max-new-tokens", "32"]))
    start_s = time.perf_counter() - t0
    try:
        def run():
            return [http_json(http.url + "/v1/completions",
                              {"prompt": "Tom has 5 apples. He buys 3 more.", "max_tokens": 16}),
                    http_json(http.url + "/v1/chat/completions",
                              {"messages": [{"role": "user", "content": "How many apples?"}],
                               "max_tokens": 16})]
        answers, secs, counts = run_counted(kerns, run)
        health = http_json(http.url + "/health")
    finally:
        http.stop()
        server.stop()
    out = {"start_s": start_s, "seconds": secs, "launches": {k: c for k, c in counts.items() if c},
           "usage": [a["usage"] for a in answers],
           "texts": [a["choices"][0].get("text", a["choices"][0].get("message", {}).get("content"))
                     for a in answers], "health": health}
    out["bad"] = []
    if not (counts["decode_attention_bf16"] > 0 and sum(counts.values()) == counts["decode_attention_bf16"]):
        out["bad"].append(f"launches {counts}")
    if not all(1 <= a["usage"]["completion_tokens"] <= 16 for a in answers) or health["served"] != 2:
        out["bad"].append("answers")
    return out


def hf_checkpoints_phase(kerns, gpu, seed) -> dict:
    """Phase 23: Qwen2.5-0.5B and Qwen3-0.6B checkpoints written at their
    published widths (bf16, random weights from ``seed``, the tokenizer
    fixture), read back by ``load_hf_pretrained`` (gate: bitwise the written
    tensors); ``main_grpo --model-path`` on the Qwen2.5 one at the runner
    phase's cut for 2 steps (gates: K1, K2 and K5-K8 launched and no other
    kernel, finite metrics, step-1 drift under ``DRIFT_BAR``);
    ``main_sft --model-path`` on the Qwen3 one for 2 steps (gates: K1 and
    K5-K8 launched, finite loss) and one Qwen3 forward, kernels against
    plain (``QWEN3_FORWARD_BARS``); ``serve_openai --model`` on the Qwen2.5
    one (gate: K2 alone launched, both requests answered)."""
    import shutil
    import tempfile

    from rlinf_tpu_torch import main_grpo, main_sft
    from rlinf_tpu_torch.data.gsm_synth import build_sft_examples
    from rlinf_tpu_torch.data.tokenizers import HFTokenizer

    t_phase = time.perf_counter()
    work = HERE / "build" / "hf_smoke"
    shutil.rmtree(work, ignore_errors=True)
    out = {"phase": "hf_checkpoints", "gpu": gpu, "hf_packages": hf_packages(), "checkpoints": {}}
    bad, launches = [], dict.fromkeys(kerns, 0)
    loaded = {}
    for name, (preset, extra) in HF_CHECKPOINTS.items():
        cfg, written, write_s = write_hf_checkpoint(work / name, preset, extra, seed)
        lcfg, params, load_s, load_gb = timed_load(work / name)
        differs = [k for k, a in (("embed", written["embed"]), ("final_norm", written["final_norm"]))
                   if not torch.equal(params[k], a)]
        differs += [f"blocks/{k}" for k, a in written["blocks"].items()
                    if not torch.equal(params["blocks"][k], a)]
        if set(params["blocks"]) != set(written["blocks"]) or "lm_head" in params:
            differs.append("leaves")
        if dataclasses.asdict(lcfg) != dataclasses.asdict(cfg):
            differs.append(f"config {dataclasses.asdict(lcfg)}")
        out["checkpoints"][name] = {
            "bytes": (work / name / "model.safetensors").stat().st_size, "write_s": write_s,
            "load_s": load_s, "load_peak_gb": load_gb, "differs_at": differs,
            "params": sum(t.numel() for t in [params["embed"], params["final_norm"],
                                               *params["blocks"].values()])}
        bad += [f"{name} reload differs at {d}" for d in differs]
        loaded[name] = (lcfg, params)
        del written
    gc.collect()
    torch.cuda.empty_cache()

    # main_grpo --model-path on Qwen2.5-0.5B
    yaml = str(HERE / RUNNER_YAML)
    q25 = str(work / "qwen2_5_0_5b")
    record = {}
    torch.cuda.reset_peak_memory_stats()
    with watching_runner(record):
        history, secs, counts = run_counted(kerns, lambda: main_grpo.main(
            ["--config", yaml, "--model-path", q25, *HF_GRPO_REDUCED, f"runner.seed={seed}",
             f"runner.log_dir={work / 'grpo_logs'}", "runner.checkpoint_dir=null"]))
    r1 = record["runner"]
    drift = {"kernels": behaviour_drift(r1, record["result"], lp=record["lp"]),
             "plain": record["drift_plain"], "bar": DRIFT_BAR}
    out["main_grpo"] = {"model_path": "qwen2_5_0_5b", "reduced": HF_GRPO_REDUCED,
                        "tokenizer": type(r1.tokenizer).__name__, "seconds": secs,
                        "max_seq_len": r1.cfg.model.max_seq_len,
                        "steps": [{k: h[k] for k in RUNNER_METRICS if k in h} for h in history],
                        "launches": counts, "logprob_drift_step1": drift,
                        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    bad += [f"main_grpo: {k} not launched" for k in RUNNER_KERNELS if not counts[k]]
    bad += [f"main_grpo: {k} launched" for k, c in counts.items() if c and k not in RUNNER_KERNELS]
    bad += [f"main_grpo: {b}" for b in finite_steps(history)]
    if len(history) != 2 or not isinstance(r1.tokenizer, HFTokenizer):
        bad.append("main_grpo: steps or tokenizer")
    bad += [f"main_grpo drift {side} {k}" for side in ("kernels", "plain")
            for k, b in DRIFT_BAR.items() if not drift[side][k] < b]
    for k, c in counts.items():
        launches[k] += c
    record.clear()
    del r1
    gc.collect()
    torch.cuda.empty_cache()

    # main_sft --model-path on Qwen3-0.6B, then its forward against plain
    q3 = work / "qwen3_0_6b"
    with tempfile.TemporaryDirectory() as tmp:
        data = Path(tmp) / "sft.jsonl"
        data.write_text("\n".join(json.dumps({"prompt": e.prompt, "answer": e.answer})
                                  for e in build_sft_examples(SFT_EXAMPLES, seed)))
        rec = {}
        torch.cuda.reset_peak_memory_stats()
        with watching_sft(rec):
            sft_hist, secs, counts = run_counted(kerns, lambda: main_sft.main(
                ["--config", yaml, "--data-path", str(data), "--model-path", str(q3),
                 *HF_SFT_REDUCED, f"runner.seed={seed}", f"runner.log_dir={tmp}/logs",
                 "runner.checkpoint_dir=null"]))
        T = [int(b["input_ids"].shape[1]) for b in rec["batches"]]
        out["main_sft"] = {"model_path": "qwen3_0_6b", "reduced": HF_SFT_REDUCED, "seconds": secs,
                           "seq_len": T, "steps": sft_hist, "launches": counts,
                           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
        bad += [f"main_sft: {k} not launched" for k in TRAIN_KERNELS if not counts[k]]
        bad += [f"main_sft: {b}" for b in finite_steps(sft_hist)]
        if len(sft_hist) != 2:
            bad.append(f"main_sft: {len(sft_hist)} steps")
        for k, c in counts.items():
            launches[k] += c
        del rec
    gc.collect()
    torch.cuda.empty_cache()
    fwd = qwen3_forward_check(kerns, *loaded["qwen3_0_6b"], seed)
    out["qwen3_forward"] = fwd
    bad += [f"qwen3 forward: {b}" for b in fwd["bad"]]
    del loaded
    gc.collect()
    torch.cuda.empty_cache()

    serve = serve_hf_check(kerns, work / "qwen2_5_0_5b")
    out["serve_openai"] = serve
    bad += [f"serve_openai: {b}" for b in serve["bad"]]
    for k, c in serve["launches"].items():
        launches[k] += c
    shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    if bad:
        raise AssertionError(f"HF checkpoint phase failed: {bad}")
    return launches


#: grpo_math_qwen05b.yaml's model section replaced by LLMConfig.qwen3_moe_2b's
#: widths (32 experts, top-2, expert ffn 768, D=1024) at the depth of MOE_CUT
#: (the model has 24 layers)
MOE_CUT = {"model.num_layers=2": "2 of qwen3_moe_2b's 24 layers, so that the whole script "
                                 "stays inside its time limit (12 until phase 26 came, 4 "
                                 "until its expert-axis parts came)"}
MOE_OVERRIDES = (
    "model.vocab_size=151936", "model.hidden_size=1024", "model.intermediate_size=768",
    *MOE_CUT, "model.num_heads=16", "model.num_kv_heads=4", "model.head_dim=64",
    "model.rope_theta=1e6", "model.tie_word_embeddings=true", "model.qkv_bias=false",
    "model.qk_norm=true", "model.num_experts=32", "model.num_experts_per_token=2",
)


def capacity_overflow(runner, result, rows: int = 16) -> dict:
    """``capacity_overflow_frac`` of every layer's MoE input on the run's
    params: at the rollout's decode shape (one token of each of the 64 rows,
    at the first response position, N = 64) and at a training microbatch
    (``rows`` whole rows) -> per-layer fractions and their mean."""
    from rlinf_tpu_torch.data.io_struct import build_train_batch
    from rlinf_tpu_torch.models.llm import model as M
    from rlinf_tpu_torch.ops.moe import capacity_of, capacity_overflow_frac

    tb = build_train_batch(result, np.zeros(result.response_ids.shape, np.float32),
                           pad_id=runner.cfg.sampling.pad_token_id)
    ids = torch.as_tensor(tb.input_ids, device="cuda")
    mask = torch.as_tensor(tb.attention_mask, device="cuda")
    first = torch.as_tensor(np.asarray(result.prompt_lengths), device="cuda")
    moe = runner.cfg.model.moe_config
    seen = {"decode": [], "train": []}
    orig = M.moe_layer

    def recording(params, x, cfg, tp=None, ep=None):
        rowsel = torch.arange(x.shape[0], device=x.device)
        seen["decode"].append(float(capacity_overflow_frac(params, x[rowsel, first][:, None], moe)))
        seen["train"].append(float(capacity_overflow_frac(params, x[:rows], moe)))
        return orig(params, x, cfg, tp, ep)

    M.moe_layer = recording
    try:
        with torch.inference_mode():
            M.forward_hidden(runner._policy_params(), runner.cfg.model, ids, attention_mask=mask,
                             attn_impl=runner.cfg.attn_impl)
    finally:
        M.moe_layer = orig
    return {"decode_shape": f"N={ids.shape[0]} (one token a row)",
            "train_shape": f"N={rows}x{ids.shape[1]}",
            "decode_capacity": capacity_of(ids.shape[0], moe),
            "decode_by_layer": seen["decode"], "train_by_layer": seen["train"],
            "decode_mean": float(np.mean(seen["decode"])), "train_mean": float(np.mean(seen["train"]))}


#: the MoE shadow check's bars, held with the routing pinned to the plain
#: run's: SHADOW_BARS' loss and grad-norm bars, and a bar for the gradients'
#: direction set as SHADOW_BARS' were, at 1.5x the reading on an H100
#: (4.48% at seed 0; the dense runner's first moment reads 2.7-3.0%: each
#: expert's gradient sums fewer tokens, so bf16 differences average out
#: less). The whole optimizer step of ``shadow_step`` is not run: its
#: copies of adamw's f32 moments (16 GB a copy at 2.0 B parameters, three
#: copies) do not fit beside the run.
MOE_SHADOW_BARS = {"loss_abs": SHADOW_BARS["loss_abs"],
                   "grad_norm_rel": SHADOW_BARS["grad_norm_rel"],
                   "grads_rel": 6.7e-2}


@contextlib.contextmanager
def recorded_routing(log: list, replay=None):
    """Append every top-k expert choice of ``ops/moe._route`` to ``log``;
    with ``replay`` (an earlier run's log), take its choices in call order in
    place of this run's, the gates then the renormalised router
    probabilities at those experts."""
    from rlinf_tpu_torch.ops import moe as MOE

    orig = MOE._route
    it = iter(replay) if replay is not None else None

    def route(params, tokens, moe):
        probs, topk_probs, topk_idx = orig(params, tokens, moe)
        if it is not None:
            topk_idx = next(it)
            topk_probs = probs.gather(-1, topk_idx)
            topk_probs = topk_probs / topk_probs.sum(dim=-1, keepdim=True).clamp_min(1e-9)
        log.append(topk_idx.detach().clone())
        return probs, topk_probs, topk_idx

    MOE._route = route
    try:
        yield
    finally:
        MOE._route = orig


def moe_shadow(runner, result, kerns, seed, rows: int = 32) -> dict:
    """One microbatch's loss and gradients (``microbatch_loss_with_moe``
    through ``learner._grads``) on the runner's params, ``rows`` rows of the
    run's rollout with seeded per-row advantages: with the plain versions of
    the training kernels, with the kernels, and with the kernels on the plain
    run's routing. A top-k choice that the kernels' rounding flips moves, on
    the capacity path, every later claim on both experts, so the free runs
    are reported (the flipped share, the gradients apart) and the pinned run
    is held to ``MOE_SHADOW_BARS``."""
    from rlinf_tpu_torch.data.io_struct import build_train_batch
    from rlinf_tpu_torch.training.learner import _grads, microbatch_loss_with_moe

    cfg = runner.cfg
    r = np.random.default_rng(seed + 240)
    adv = np.broadcast_to(r.normal(size=(result.batch_size, 1)),
                          result.response_ids.shape).astype(np.float32)
    tb = build_train_batch(result, adv, pad_id=cfg.sampling.pad_token_id).to_dict()
    mb = {k: torch.as_tensor(np.asarray(v)[:rows], device="cuda") for k, v in tb.items()}
    gv = mb["loss_mask"].float().sum().clamp_min(1.0)
    params = runner._policy_params()
    runs, routes = {}, {}
    for mode in ("plain", "kernels", "pinned"):
        def run():
            return _grads(params, lambda p: microbatch_loss_with_moe(
                p, cfg.model, cfg.loss, mb, gv, attn_impl=cfg.attn_impl, remat=cfg.remat))
        routes[mode] = []
        with (kernels_replaced(plain_only, _training_sites()) if mode == "plain"
              else contextlib.nullcontext()), recorded_routing(
                routes[mode], routes["plain"] if mode == "pinned" else None):
            (g, loss, m), secs, counts = run_counted(kerns, run)
        runs[mode] = dict(g=g, loss=float(loss), aux=float(m["actor/moe_aux_loss"]),
                          counts=counts, seconds=secs, norm=tree_norm(g))
    p = runs["plain"]

    def apart(k):
        return {"loss": k["loss"], "loss_abs": abs(k["loss"] - p["loss"]),
                "moe_aux_loss": k["aux"], "grad_norm": k["norm"],
                "grad_norm_rel": abs(k["norm"] - p["norm"]) / max(p["norm"], 1e-30),
                "grads_rel": norm_rel(k["g"], p["g"]),
                "moe_grads_rel": {n: norm_rel(k["g"]["blocks"][n], p["g"]["blocks"][n])
                                  for n in ("moe_router", "moe_gate", "moe_up", "moe_down")},
                "seconds": k["seconds"]}

    flipped = sum(int((a != b).sum()) for a, b in zip(routes["kernels"], routes["plain"]))
    out = {"rows": rows, "tokens": int(mb["attention_mask"].sum()),
           "plain": {"loss": p["loss"], "moe_aux_loss": p["aux"], "grad_norm": p["norm"],
                     "seconds": p["seconds"]},
           "kernels_free": apart(runs["kernels"]), "kernels_pinned": apart(runs["pinned"]),
           "route_calls": len(routes["plain"]),
           "choices_flipped_share": flipped / max(sum(a.numel() for a in routes["plain"]), 1),
           "kernel_launches": runs["pinned"]["counts"], "bars": MOE_SHADOW_BARS}
    pinned = out["kernels_pinned"]
    out["bad"] = [n for n, bar in MOE_SHADOW_BARS.items() if not pinned[n] < bar]
    for mode in ("kernels", "pinned"):
        if [n for n in TRAIN_KERNELS if runs[mode]["counts"][n]] != list(TRAIN_KERNELS):
            out["bad"].append(f"{mode} launches {runs[mode]['counts']}")
    if any(p["counts"].values()) or len(routes["pinned"]) != len(routes["plain"]):
        out["bad"].append(f"plain launches {p['counts']} or route calls")
    return out


def moe_phase(kerns, gpu, peaks, seed) -> dict:
    """Phase 24: ``main_grpo`` on grpo_math_qwen05b.yaml with the model of
    ``LLMConfig.qwen3_moe_2b`` (``MOE_OVERRIDES``: full width, the depth of
    ``MOE_CUT``, random weights from ``seed``, the byte tokenizer), cut as
    the runner phase (``HF_GRPO_REDUCED``): capacity routing for 2 steps, then a
    shadow check on its params (``moe_shadow``), then dropless routing for
    1 step. Gates: K1, K2 and K5-K8 launched and no other kernel in each
    run, finite metrics with ``actor/moe_aux_loss`` among them, the shadow
    check within ``MOE_SHADOW_BARS``. Reported: ``capacity_overflow_frac`` at the rollout's
    decode shape and at a training microbatch, every step's times."""
    import shutil

    from rlinf_tpu_torch import main_grpo
    from rlinf_tpu_torch.training.train_state import tree_leaves

    t_phase = time.perf_counter()
    work = HERE / "build" / "moe_smoke"
    shutil.rmtree(work, ignore_errors=True)
    yaml = str(HERE / RUNNER_YAML)
    out = {"phase": "moe", "gpu": gpu, "config": RUNNER_YAML, "model": "qwen3_moe_2b",
           "overrides": list(MOE_OVERRIDES), "reduced": {**HF_GRPO_REDUCED, **MOE_CUT}}
    bad, launches = [], dict.fromkeys(kerns, 0)
    peak_tflops = peaks[1] / 1e12
    reduced = [k for k in HF_GRPO_REDUCED if not k.startswith("runner.max_steps")]
    for impl, steps in (("capacity", 2), ("dropless", 1)):
        ov = [*MOE_OVERRIDES, f"model.moe_impl={impl}", *reduced,
              f"runner.max_steps={steps}", f"runner.seed={seed}",
              f"runner.log_dir={work / impl}", "runner.checkpoint_dir=null"]
        record = {}
        torch.cuda.reset_peak_memory_stats()
        with watching_runner(record):
            history, secs, counts = run_counted(kerns, lambda: main_grpo.main(["--config", yaml, *ov]))
        r = record["runner"]
        run = {"seconds": secs, "launches": counts,
               "params": sum(t.numel() for t in tree_leaves(r.state.params)),
               "steps": [{**{k: h[k] for k in (*RUNNER_METRICS, "actor/moe_aux_loss") if k in h},
                          "mfu": h["perf/train_tflops_per_s"] / peak_tflops} for h in history],
               "logprob_drift_step1": {"kernels": behaviour_drift(r, record["result"], lp=record["lp"]),
                                       "plain": record["drift_plain"]},
               "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
               "capacity_overflow": capacity_overflow(r, record["result"])}
        bad += [f"{impl}: {k} not launched" for k in RUNNER_KERNELS if not counts[k]]
        bad += [f"{impl}: {k} launched" for k, c in counts.items() if c and k not in RUNNER_KERNELS]
        bad += [f"{impl}: {b}" for b in finite_steps(history)]
        if len(history) != steps or not all("actor/moe_aux_loss" in h for h in history):
            bad.append(f"{impl}: {len(history)} steps or no actor/moe_aux_loss")
        for k, c in counts.items():
            launches[k] += c
        if impl == "capacity":
            run["shadow"] = moe_shadow(r, record["result"], kerns, seed)
            bad += [f"shadow: {b}" for b in run["shadow"]["bad"]]
        out[impl] = run
        record.clear()
        del r
        gc.collect()
        torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    if bad:
        raise AssertionError(f"MoE phase failed: {bad}")
    return launches


# ---------------------------------------------------------------------------
# Phase 25: the agent recipes and the AgentLightning runner
# ---------------------------------------------------------------------------

#: phase 25 runs the model at a sixth of its depth (as the runner phase,
#: RUNNER_CUT), so that the whole script stays inside its time limit with
#: phases 26 and 28
RECIPES_CUT = {"model.num_layers=4": "4 of Qwen2.5-0.5B's 24 layers: the script's time limit "
                                     "(8 until phase 28 came)"}
#: the AgentLightning runner's traffic, cut to a short run of
#: grpo_math_qwen05b.yaml: each override and why
RECIPES_REDUCED = {
    "runner.rollout_batch_size=2": "2 prompts x group_size 4 = 8 tasks a step "
                                   "(the yaml: 64 prompts, 512 rows)",
    "algorithm.group_size=4": "the yaml has 8",
    "sampling.max_new_tokens=16": "a completion's budget (the yaml has 1024): a B=1 "
                                  "completion is host-bound at 25-40 ms a decode step",
    "runner.max_steps=2": "the yaml has 400",
    "data.max_prompt_len=540": "drops the longer of the rStar2 dataset's templated prompts "
                               "(the yaml: 512)",
}
#: the rStar2 dataset: gsm_synth problems, templated with the python tool's
#: schema on the tokenizer fixture under RECIPES_TOOLS_TEMPLATE
RECIPES_ROWS = 32
#: a ChatML template that renders ``tools`` as Qwen2.5's does (a system turn
#: listing each schema as JSON), cut to its tool block; the fixture's own
#: template renders no tools
RECIPES_TOOLS_TEMPLATE = (
    "{%- if tools %}{{- '<|im_start|>system\\nYou are a helpful assistant.\\n\\n# Tools\\n<tools>' }}"
    "{%- for tool in tools %}{{- '\\n' }}{{- tool | tojson }}{%- endfor %}"
    "{{- '\\n</tools><|im_end|>\\n' }}"
    "{%- elif messages[0]['role'] != 'system' %}"
    "{{- '<|im_start|>system\\nYou are a helpful assistant.<|im_end|>\\n' }}{%- endif %}"
    "{%- for message in messages %}"
    "{{- '<|im_start|>' + message['role'] + '\\n' + message['content'] + '<|im_end|>\\n' }}"
    "{%- endfor %}"
    "{%- if add_generation_prompt %}{{- '<|im_start|>assistant\\n' }}{%- endif %}"
)
#: the retrieval corpus: passages made in code, one a country
RECIPES_PASSAGES = 300
#: the rStar2 conversations' second turns (the first assigns x = 7 (i + 1)):
#: six read the carried state, one raises, one loops past the timeout
RSTAR2_SECOND_TURNS = ["print(x)"] * 6 + ["1/0", "while True: pass"]
#: K1 and K2 in a torch.profiler trace, by their __global__ names in
#: csrc/flash_attention_fwd.cu and csrc/decode_attention.cu
PROFILED_KERNELS = {"flash_attention_fwd": "flash_fwd_kernel",
                    "decode_attention_bf16": "decode_bf16_split_kernel"}


def recipes_corpus() -> dict:
    return {f"country-{i:03d}": f"Country-{i:03d}'s capital is City{i}; its river is River{i} "
                                f"and it has {i * 37 % 1000} towns."
            for i in range(RECIPES_PASSAGES)}


def scripted_calls(plan):
    """A parse for random weights (which never write a tool tag): its k-th
    use calls ``plan(k)`` -> (tool, args) or None; a call keeps the turn's
    whole text."""
    from rlinf_tpu_torch.algorithms.toolcall_parsers import ToolCall

    seen = {"k": 0}

    def parse(text):
        k = seen["k"]
        seen["k"] += 1
        call = plan(k)
        return None if call is None else ToolCall(tool=call[0], args=call[1], raw=text,
                                                  end_pos=len(text))
    return parse


def recipes_dataset(work: Path, cfg, seed) -> tuple:
    """Step 1: a jsonl of RECIPES_ROWS gsm_synth problems through
    ``create_rl_dataset(type="rstar2")`` on the tokenizer fixture (its chat
    template swapped for one that renders tools), templated and filtered by
    length -> (dataset, tokenizer, figures)."""
    import random
    import shutil

    from rlinf_tpu_torch.data.datasets import create_rl_dataset
    from rlinf_tpu_torch.data.gsm_synth import make_problem
    from rlinf_tpu_torch.data.hf_tokenizer import HFTokenizer

    tok_dir = work / "tokenizer"
    tok_dir.mkdir(parents=True)
    for f in (HERE / TOKENIZER_FIXTURE).iterdir():
        shutil.copy(f, tok_dir / f.name)
    tcfg = json.loads((tok_dir / "tokenizer_config.json").read_text())
    tcfg["chat_template"] = RECIPES_TOOLS_TEMPLATE
    (tok_dir / "tokenizer_config.json").write_text(json.dumps(tcfg))
    tok = HFTokenizer(str(tok_dir))
    rng = random.Random(seed)
    rows = []
    for _ in range(RECIPES_ROWS):
        q, _, a = make_problem(rng)
        rows.append({"prompt": q, "question": q, "answer": a})
    (work / "train.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))
    data_cfg = dataclasses.replace(cfg.data, type="rstar2", train_data_paths=str(work / "train.jsonl"),
                                   apply_chat_template=True, filter_prompt_by_length=True)
    t0 = time.perf_counter()
    train, _ = create_rl_dataset(data_cfg, tok)
    lens = [len(tok.encode(e.prompt, add_special_tokens=False)) for e in train.examples]
    return train, tok, {"type": "rstar2", "rows": len(rows), "kept": len(train),
                        "dropped_by_length": len(rows) - len(train),
                        "max_prompt_len": data_cfg.max_prompt_len,
                        "kept_prompt_tokens": {"min": min(lens), "max": max(lens)},
                        "tools_in_every_prompt": all("python_code_with_standard_io" in e.prompt
                                                     for e in train.examples),
                        "answers_are_lists": all(isinstance(e.answer, list)
                                                 for e in train.examples),
                        "seconds": time.perf_counter() - t0}


def searchr1_step(runner, params, gen) -> dict:
    """Step 2: Search-R1 over a RetrievalServer (BM25 over RECIPES_PASSAGES
    passages on 127.0.0.1): 8 questions, up to 3 turns, a scripted search in
    each conversation's first turn."""
    from rlinf_tpu_torch.agents.recipes import SearchR1Recipe
    from rlinf_tpu_torch.agents.retrieval import RetrievalServer
    from rlinf_tpu_torch.data.tokenizers import ByteTokenizer

    ids = [3, 41, 77, 120, 159, 201, 250, 299]
    questions = [f"What is the capital of country-{i:03d}?" for i in ids]
    answers = [f"City{i}" for i in ids]
    server = RetrievalServer(recipes_corpus()).start()
    served = {"requests": 0}
    search = server.index.search

    def counted(query, topk=3):
        served["requests"] += 1
        return search(query, topk=topk)

    server.index.search = counted
    tok = ByteTokenizer()
    recipe = SearchR1Recipe(max_turns=3, max_total_len=1024)
    try:
        loop = recipe.make_loop(runner.engine, tok, {}, search_url=server.url)
        loop.parse = scripted_calls(lambda k: ("search", questions[k]) if k < 8 else None)
        t0 = time.perf_counter()
        rolls = loop.run(params, [tok.encode(f"Question: {q}\n") for q in questions], gen)
        secs = time.perf_counter() - t0
    finally:
        server.stop()
    out = {"url_host": server.url.split("//")[1].split(":")[0], "passages": RECIPES_PASSAGES,
           "conversations": len(rolls), "seconds": secs,
           "tool_calls": sum(r.num_tool_calls for r in rolls),
           "server_requests": served["requests"],
           "turns": [r.num_turns for r in rolls],
           "tokens": [len(r.token_ids) for r in rolls],
           "results_in_rollouts": sum(f"Doc 1: Country-{i:03d}'s capital is City{i}" in r.final_text
                                      for i, r in zip(ids, rolls)),
           "em": SearchR1Recipe(reward_metric="em").batch_rewards(rolls, answers),
           "f1": SearchR1Recipe(reward_metric="f1").batch_rewards(rolls, answers)}
    out["bad"] = [] if (out["tool_calls"] == out["server_requests"] == 8
                        and out["results_in_rollouts"] == 8
                        and all(t == 2 for t in out["turns"])) else ["search-r1"]
    return out


def rstar2_step(runner, params, gen) -> dict:
    """Step 3: rStar2's loop and its Python tool over 8 conversations of 3
    turns (a scripted call in turns 1 and 2: x = 7 (i + 1), then
    RSTAR2_SECOND_TURNS), scored by ``rstar2_reward``; then the forked
    ``SessionPythonTool`` (this process holds a CUDA context): state across
    calls in 8 sessions, a timeout, an error."""
    from rlinf_tpu_torch.agents.recipes import RStar2Recipe
    from rlinf_tpu_torch.agents.rstar2 import SessionPythonTool
    from rlinf_tpu_torch.algorithms.rewards.rstar2_score import rstar2_reward
    from rlinf_tpu_torch.data.tokenizers import ByteTokenizer

    if not torch.cuda.is_initialized():
        raise AssertionError("the rStar2 step must run after CUDA is initialised")
    tok = ByteTokenizer()
    recipe = RStar2Recipe(max_turns=3, max_total_len=512, timeout_s=1.0)
    loop = recipe.make_loop(runner.engine, tok)
    n = len(RSTAR2_SECOND_TURNS)

    def plan(k):
        if k < n:
            return "python", f"x = {7 * (k + 1)}"
        return ("python", RSTAR2_SECOND_TURNS[k - n]) if k < 2 * n else None

    loop.parse = scripted_calls(plan)
    t0 = time.perf_counter()
    rolls = loop.run(params, [tok.encode(f"Compute {i + 1} * 7 with python.\n")
                              for i in range(n)], gen)
    secs = time.perf_counter() - t0
    answers = [str(7 * (i + 1)) for i in range(n)]
    carried = ["<result>(no output)</result>" in r.final_text
               and f"<result>{a}</result>" in r.final_text for r, a in zip(rolls[:6], answers)]
    out = {"conversations": len(rolls), "seconds": secs, "turns": [r.num_turns for r in rolls],
           "turn_errors": [r.turn_errors for r in rolls], "state_carried": carried,
           "error_turn": "<result>error: ZeroDivisionError" in rolls[6].final_text,
           "timeout_turn": "<result>error: execution timed out</result>" in rolls[7].final_text,
           "rstar2_reward": [rstar2_reward(r.final_text, a) for r, a in zip(rolls, answers)],
           "recipe_reward": recipe.batch_rewards(rolls, answers)}
    tool = SessionPythonTool(timeout_s=2.0)
    t0 = time.perf_counter()
    first = [tool(f"x = {i} * 6", session=i) for i in range(n)]
    second = [tool("x + 1", session=i) for i in range(n)]
    fork_s = (time.perf_counter() - t0) / (2 * n)
    timeout = tool("while True: pass", session=0)
    error = tool("1/0", session=1)
    after = tool("x", session=0)
    out["session_tool"] = {"start_method": "fork", "cuda_initialized": torch.cuda.is_initialized(),
                           "first": first, "second": second, "timeout": timeout,
                           "error": error, "after_timeout": after, "seconds_a_call": fork_s}
    bad = []
    if not (all(carried) and out["error_turn"] and out["timeout_turn"]
            and out["turns"] == [3] * n):
        bad.append("rstar2 loop")
    if not (first == [""] * n and second == [str(6 * i + 1) for i in range(n)]
            and timeout == "error: timeout" and error.startswith("error: ZeroDivisionError")
            and after == "0"):
        bad.append("session tool")
    out["bad"] = bad
    return out


def wideseek_step(runner, params, gen, kerns) -> dict:
    """Step 4: ``WideSeekR1Recipe.run_team`` with 2 searchers over 4
    questions (a scripted search in each searcher's first turn, every third
    one of an unknown tool: a failed turn), ``build_team_batch`` with 2
    teams a question, then one ``make_policy_train_step`` call on that
    batch from a copy of the runner's state (its launches read as the
    difference of the counts, which go on counting for the phase)."""
    from rlinf_tpu_torch.agents import agent_loop
    from rlinf_tpu_torch.agents.recipes import WideSeekR1Recipe
    from rlinf_tpu_torch.data.tokenizers import ByteTokenizer

    ids = [12, 12, 140, 140]
    questions = [f"What is the capital of country-{i:03d}?" for i in ids]
    answers = [f"City{i}" for i in ids]
    recipe = WideSeekR1Recipe(num_searchers=2, max_total_len=1024)
    # parses 0-3 are the planners' (one turn: no call); 4-11 the searchers'
    # first turns, two a question
    parse = scripted_calls(lambda k: ("nope" if k % 3 == 2 else "search",
                                      f"capital of country-{ids[(k - 4) // 2 % 4]:03d}"))
    real = agent_loop.get_toolcall_parser
    agent_loop.get_toolcall_parser = lambda name: parse
    try:
        t0 = time.perf_counter()
        team = recipe.run_team(runner.engine, ByteTokenizer(), params, questions,
                               recipes_corpus(), gen)
        team_s = time.perf_counter() - t0
    finally:
        agent_loop.get_toolcall_parser = real
    batch, roles, metrics = recipe.build_team_batch(team, answers, group_size=2,
                                                    pad_id=runner.cfg.sampling.pad_token_id)
    batch_dict = {k: torch.as_tensor(v).to("cuda") for k, v in batch.to_dict().items()}
    state = clone_tree(runner.state)
    before = {name: kern.launches for name, kern in kerns.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = runner.train_step(state, batch_dict)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {name: kern.launches - before[name] for name, kern in kerns.items()}
    m = {k: float(v) for k, v in m.items()}
    out = {"questions": len(questions), "rows": {r: roles.count(r) for r in dict.fromkeys(roles)},
           "run_team_seconds": team_s, "metrics": metrics, "batch_shape": list(batch.input_ids.shape),
           "searcher_results": sum("<result>" in r.final_text for r in team["searcher"]),
           "searcher_turn_errors": sum(sum(r.turn_errors) for r in team["searcher"]),
           "train_step": {"seconds": secs, "launches": counts,
                          **{k: m[k] for k in ("actor/loss", "actor/grad_norm") if k in m}}}
    del state
    bad = [k for k in TRAIN_KERNELS if not counts[k]]
    if not (out["rows"] == {"planner": 4, "searcher": 8, "summarizer": 4}
            and metrics["agent/failed_turns_masked"] > 0 and out["searcher_results"] > 0):
        bad.append("team")
    bad += [k for k in ("actor/loss", "actor/grad_norm") if not np.isfinite(m.get(k, np.nan))]
    out["bad"] = bad
    return out


@contextlib.contextmanager
def watching_train_steps(runner, record: dict):
    """Keep the runner's first train step's batch and a copy of the state
    it started from, and every step's batch shape."""
    real = runner.train_step

    def step(state, batch):
        if "batch" not in record:
            record["batch"], record["state"] = batch, clone_tree(state)
        record.setdefault("shapes", []).append(tuple(batch["input_ids"].shape))
        return real(state, batch)

    runner.train_step = step
    try:
        yield
    finally:
        runner.train_step = real


def recipes_shadow(runner, record: dict, kerns) -> dict:
    """Step 6: the runner's first batch, with every training kernel replaced
    by its plain version and then with the kernels: its logprobs on the
    params that rolled it out, and their drift from the engine's behaviour
    logprobs (``DRIFT_BAR``); a train step on it from the runner's last
    state, both ways from one copy (``SHADOW_BARS``). The last state, not
    the first: the yaml's warmup gives the first update a learning rate of
    0, which would leave the updates' bar nothing to compare."""
    from rlinf_tpu_torch.training.learner import make_logprob_fn

    batch, start, params1 = record["batch"], clone_tree(runner.state), record["state"].params
    mask = batch["loss_mask"].bool()
    old = batch["old_logprobs"].float()
    logprob_fn = make_logprob_fn(runner.cfg.model, attn_impl=runner.cfg.attn_impl, device="cuda")
    runs = {}
    for mode in ("plain", "kernels"):
        state, updates = clone_tree(start), []
        with (kernels_replaced(plain_only, _training_sites()) if mode == "plain"
              else contextlib.nullcontext()):
            lp = logprob_fn(params1, batch)[0].float()
            with summing_updates(updates):
                (state, m), secs, counts = run_counted(kerns, lambda: runner.train_step(state, batch))
        d = (lp - old).abs()[mask]
        runs[mode] = dict(m={k: float(v) for k, v in m.items()}, state=state, lp=lp,
                          updates=updates[0], counts=counts, seconds=secs,
                          drift={"mean_abs": d.mean().item(), "max_abs": d.max().item(),
                                 "tokens": int(mask.sum())})
        del state
    k, p = runs["kernels"], runs["plain"]
    out = {"rows": int(batch["input_ids"].shape[0]), "T": int(batch["input_ids"].shape[1]),
           "logprob_max_abs": (k["lp"] - p["lp"]).abs()[mask].max().item(),
           "loss": [k["m"]["actor/loss"], p["m"]["actor/loss"]],
           "loss_abs": abs(k["m"]["actor/loss"] - p["m"]["actor/loss"]),
           "grad_norm": [k["m"]["actor/grad_norm"], p["m"]["actor/grad_norm"]],
           "grad_norm_rel": abs(k["m"]["actor/grad_norm"] - p["m"]["actor/grad_norm"])
                            / max(p["m"]["actor/grad_norm"], 1e-30),
           "first_moment_rel": norm_rel(k["state"].opt_state["mu"], p["state"].opt_state["mu"]),
           "update_rel": norm_rel(k["updates"], p["updates"]),
           "update_norm": [tree_norm(k["updates"]), tree_norm(p["updates"])],
           "seconds": [k["seconds"], p["seconds"]], "kernel_launches": k["counts"],
           "logprob_drift_step1": {"kernels": k["drift"], "plain": p["drift"], "bar": DRIFT_BAR},
           "bars": SHADOW_BARS}
    bad = [n for n, bar in SHADOW_BARS.items() if not out[n] < bar]
    bad += [f"drift {side} {n}" for side in ("kernels", "plain")
            for n, bar in DRIFT_BAR.items() if not out["logprob_drift_step1"][side][n] < bar]
    if [n for n in TRAIN_KERNELS if k["counts"][n]] != list(TRAIN_KERNELS) or any(
            p["counts"].values()):
        bad.append(f"launches {k['counts']} / plain {p['counts']}")
    if not (p["m"]["actor/grad_norm"] > 0 and min(out["update_norm"]) > 0):
        bad.append("zero gradient or update")
    out["bad"] = bad
    return out


#: a kernel's record in a torch.profiler (Kineto) Chrome trace: its name
#: and its device duration in us
TRACE_KERNEL = re.compile(rb'"cat": "kernel",\s*"name": "([^"]*)".*?"dur": ([0-9.eE+-]+)', re.S)


def traced_kernels(path: str) -> dict:
    """K1's and K2's launches and device ms in a Chrome trace file, by their
    source names, and the kernels it holds. The file is scanned as bytes:
    the profile's ``key_averages()`` would first build a Python event for
    each of the trace's hundreds of thousands of records."""
    import mmap

    out = {name: {"kernel": src, "launches_traced": 0, "device_ms": 0.0}
           for name, src in PROFILED_KERNELS.items()}
    total = 0
    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        for m in TRACE_KERNEL.finditer(mm):
            total += 1
            for name, src in PROFILED_KERNELS.items():
                if src.encode() in m.group(1):
                    out[name]["launches_traced"] += 1
                    out[name]["device_ms"] += float(m.group(2)) / 1e3
    out["kernels_traced"] = total
    return out


def agent_recipes_phase(kerns, gpu, seed) -> dict:
    """Phase 25: the agent recipes and the AgentLightning runner at
    Qwen2.5-0.5B's full width and depth (grpo_math_qwen05b.yaml, random
    weights from ``seed``), steps 1-5 with the launch counts zeroed before
    them and read after, then the kernels-against-plain step -> launches."""
    import shutil

    from rlinf_tpu_torch.algorithms.rewards.qa_metrics import batch_f1_rewards
    from rlinf_tpu_torch.config import load_config
    from rlinf_tpu_torch.runners.agentlightning_runner import AgentLightningRunner
    from rlinf_tpu_torch.utils.flops import ChipSpec, train_mfu
    from rlinf_tpu_torch.utils.profiler import ProfilerConfig, StepProfiler

    t_phase = time.perf_counter()
    work = HERE / "build" / "agent_recipes"
    shutil.rmtree(work, ignore_errors=True)
    cfg = load_config(str(HERE / RUNNER_YAML), [*RECIPES_REDUCED, *RECIPES_CUT,
                                                f"runner.seed={seed}",
                                                "runner.log_dir=null", "runner.checkpoint_dir=null"])
    try:
        import sympy  # noqa: F401  (the math verifier's symbolic rung)
        has_sympy = True
    except ImportError:
        has_sympy = False
    out = {"phase": "agent_recipes", "gpu": gpu, "config": RUNNER_YAML, "model": "qwen2_0_5b",
           "reduced": {**RECIPES_REDUCED, **RECIPES_CUT}, "sympy": has_sympy}
    for kern in kerns.values():
        kern.launches = 0
    torch.cuda.synchronize()
    t_main = time.perf_counter()

    # 1. the rStar2 dataset, and the runner (its engine and params serve
    # every recipe)
    data, hf_tok, out["dataset"] = recipes_dataset(work, cfg, seed)
    calls = []

    def agent_fn(complete, task):
        """The user's agent: two completions a task (a templated prompt of
        500+ tokens, then a check), a reward for two tasks in three, None
        for the third (the fallback reward_fn scores it)."""
        n = len(calls)
        a = complete(task.prompt)
        b = complete("Check the answer to: " + task.meta["question"])
        calls.append((len(a), len(b)))
        return None if n % 3 == 2 else float(n % 2)

    def fallback(texts, answers):
        # the dataset's answers are lists (the reference's coercion)
        return batch_f1_rewards(texts, [a[0] if isinstance(a, list) else a for a in answers])

    runner = AgentLightningRunner(cfg, hf_tok, data, agent_fn, reward_fn=fallback, device="cuda")
    out["runner"] = {"layers": runner.cfg.model.num_layers, "attn_impl": runner.cfg.attn_impl,
                     "entry": "rlinf_tpu_torch.runners.agentlightning_runner."
                              "AgentLightningRunner.run_step"}
    gen = torch.Generator().manual_seed(seed)
    params = runner.state.params

    # 2-4. Search-R1, rStar2, WideSeek-R1 on the runner's engine and params
    out["searchr1"] = searchr1_step(runner, params, gen)
    out["rstar2"] = rstar2_step(runner, params, gen)
    out["wideseek"] = wideseek_step(runner, params, gen, kerns)

    # 5. two runner steps, the second under the StepProfiler
    record = {}
    prof = StepProfiler(ProfilerConfig(enabled=True, output_dir=str(work / "profile"),
                                       start_step=1, num_steps=1))
    steps = []
    chip = ChipSpec.h100()
    with watching_train_steps(runner, record):
        for i in range(2):
            prof.step_start()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h = runner.run_step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            t0 = time.perf_counter()
            prof.step_end()
            stop_s = time.perf_counter() - t0
            B, T = record["shapes"][i]
            steps.append({**{k: h[k] for k in sorted(h) if k.startswith(("agent/", "time/", "actor/"))},
                          "wall_s": wall, "profiled": i == 1, "batch_shape": [B, T],
                          "train_mfu_h100": train_mfu(runner.cfg.model, chip, B, T,
                                                      h["time/training"])})
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t_main
    main_counts = {name: kern.launches for name, kern in kerns.items()}
    t0 = time.perf_counter()
    trace = traced_kernels(prof.trace_path)
    out["agentlightning"] = {"steps": steps, "tasks_a_step": len(calls) // 2,
                             "completions": 2 * len(calls),
                             "trace": {"file": Path(prof.trace_path).name,
                                       "megabytes": Path(prof.trace_path).stat().st_size / 1e6,
                                       "stop_and_write_s": stop_s,
                                       "read_s": time.perf_counter() - t0, **trace}}
    out["launches"] = main_counts
    out["main_seconds"] = main_s

    # 6. the first runner step's batch again, kernels against plain
    t0 = time.perf_counter()
    out["shadow"] = recipes_shadow(runner, record, kerns)
    out["shadow"].update(optimizer_step_from=runner.global_step,
                         seconds_all=time.perf_counter() - t0)
    del record, prof
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    bad = [f"{k}: {b}" for k in ("searchr1", "rstar2", "wideseek", "shadow") for b in out[k]["bad"]]
    bad += [f"{k} not launched" for k in RUNNER_KERNELS if not main_counts[k]]
    bad += [f"{k} launched" for k, c in main_counts.items() if c and k not in RUNNER_KERNELS]
    ds = out["dataset"]
    if not (0 < ds["kept"] < ds["rows"] and ds["tools_in_every_prompt"]
            and ds["kept_prompt_tokens"]["min"] >= 128):
        bad.append(f"dataset {ds}")
    al = out["agentlightning"]
    if not (len(steps) == 2 and al["tasks_a_step"] == 8
            and all(s["agent/llm_calls_mean"] == 2.0 for s in steps)
            and all(s["agent/external_reward_rate"] < 1.0 for s in steps)
            and all(np.isfinite(s["actor/loss"]) and np.isfinite(s["actor/grad_norm"])
                    for s in steps)):
        bad.append("agentlightning steps")
    if not all(v["launches_traced"] > 0 for k, v in al["trace"].items() if k in PROFILED_KERNELS):
        bad.append(f"trace {al['trace']}")
    del runner, params
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    if bad:
        raise AssertionError(f"agent_recipes phase failed: {bad}")
    return main_counts


# ---------------------------------------------------------------------------
# Phase 17: head dims 16 and 32, f16 and f32
# ---------------------------------------------------------------------------

#: max-abs error over max |plain| a kernel's output may show, by dtype: twice
#: the operands' unit roundoff, bf16 2^-8 and f16 2^-11; f32 operands run
#: as split bf16 parts (about 2^-16 a product) and are held to tf32's 2^-11
DTYPE_BARS = {torch.bfloat16: 2 * 2.0**-8, torch.float16: 2 * 2.0**-11, torch.float32: 2.0**-11}
#: the card's peak rate of each operand type over bf16's (H100 data sheet,
#: dense: bf16 and f16 989, TF32 495 TFLOP/s), for the bounds
DTYPE_FLOPS = {torch.bfloat16: 1.0, torch.float16: 1.0, torch.float32: 495 / 989}
DT = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32"}
DTYPES = tuple(DT)
#: (H, Kv) of the shipped small models: grpo_demo_tiny.yaml and the tiny
#: preset (Hd=16), ppo_separate_critic.yaml (Hd=32)
SMALL_HEADS = (4, 2)
#: the runner's model (grpo_math_qwen05b.yaml): the main-path shape of
#: the f16 and f32 checks
QWEN05 = {"H": 14, "Kv": 2, "Hd": 64, "D": 896, "V": 151936}


def dt_bound(nb, flops, peaks, dt):
    return bound(nb, flops, (peaks[0], peaks[1] * DTYPE_FLOPS[dt]))


def held(name, key, rel, dt, extra=None) -> dict:
    """{rel_err, bar} of one variant; raise if it misses its dtype's bar."""
    r = {"rel_err": rel, "bar": DTYPE_BARS[dt], **(extra or {})}
    if not rel < DTYPE_BARS[dt]:
        raise AssertionError(f"{name} at {key} disagrees with its plain version: {r}")
    return r


def flash_variant(g, B, T, H, Kv, Hd, dt, peaks, timed) -> dict:
    """K1, K7 and K8 at (B, T, H, Kv, Hd) in dtype dt, right-padded rows,
    against their plain versions; with ``timed`` each kernel's time (K7
    and K8 launched apart), the plain versions' and SDPA's."""
    from rlinf_tpu_torch.ops.cuda import flash_attention as FA

    randn = lambda *shape: (torch.randn(shape, generator=g, device="cuda") * 0.5).to(dt)
    valid, pos = ragged_rows(B, T, left=False)
    vu8 = valid.to(torch.uint8)
    q, k, v, do = randn(B, T, H, Hd), randn(B, T, Kv, Hd), randn(B, T, Kv, Hd), randn(B, T, H, Hd)
    scale = Hd**-0.5
    o, lse = FA.flash_attention_fwd(q, k, v, pos, pos, vu8, scale)
    o_r, lse_r = FA.flash_attention_fwd_plain(q, k, v, pos, pos, vu8, scale)
    args = (q, k, v, pos, pos, vu8, o, lse, do, scale)
    got = FA.flash_attention_bwd(*args)
    want = FA.flash_attention_bwd_plain(*args)
    torch.cuda.synchronize()
    key = f"B={B} T={T} H={H} Kv={Kv} Hd={Hd} {DT[dt]}"
    if o.dtype != dt or any(t.dtype != dt for t in got):
        raise AssertionError(f"K1/K7/K8 at {key}: outputs not in {dt}")
    out = {"flash_attention_fwd": held("K1", key, rel_err(o, o_r), dt,
                                       {"lse_max_abs_err": (lse - lse_r).abs().max().item()}),
           "flash_attention_bwd_dq": held("K7", key, rel_err(got[0], want[0]), dt),
           "flash_attention_bwd_dkv": held("K8", key, max(rel_err(got[1], want[1]),
                                                          rel_err(got[2], want[2])), dt)}
    if not timed:
        return out
    mask4 = ((pos[:, None, :] <= pos[:, :, None]) & valid[:, None, :])[:, None]
    pairs = int(mask4.sum().item())
    G = H // Kv
    qt, kt, vt = (q.transpose(1, 2), k.repeat_interleave(G, 2).transpose(1, 2),
                  v.repeat_interleave(G, 2).transpose(1, 2))
    fwd_ms = cuda_ms(lambda: FA.flash_attention_fwd(q, k, v, pos, pos, vu8, scale), 20, warmup=3)
    dq, dk, dv = got
    delta = torch.empty((B, H, T), dtype=torch.float32, device="cuda")
    dq_call, dkv_call = flash_bwd_launches(args, delta, got)
    dq_call()
    bwd_plain = cuda_ms(lambda: FA.flash_attention_bwd_plain(*args), 3)
    qg = qt.detach().requires_grad_()
    kg, vg = kt.detach().requires_grad_(), vt.detach().requires_grad_()
    sd = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask4)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(sd, (qg, kg, vg), do.transpose(1, 2),
                                                  retain_graph=True), 5)
    io = nbytes(q, k, v, pos, pos, vu8)
    fb, fby = dt_bound(io + nbytes(o, lse), 4.0 * Hd * H * pairs, peaks, dt)
    qb, qby = dt_bound(io + nbytes(o, do, lse, delta, dq), 8.0 * Hd * H * pairs, peaks, dt)
    kb, kby = dt_bound(io + nbytes(do, lse, delta, dk, dv), 12.0 * Hd * H * pairs, peaks, dt)
    out["flash_attention_fwd"].update(
        ms=fwd_ms, plain_ms=cuda_ms(lambda: FA.flash_attention_fwd_plain(q, k, v, pos, pos, vu8, scale), 3),
        library_ms=cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask4), 10, warmup=3), bound_ms=fb, bound_by=fby)
    out["flash_attention_bwd_dq"].update(ms=cuda_ms(dq_call, 20, warmup=3), plain_ms=bwd_plain,
                                         library_ms=lib_bwd, bound_ms=qb, bound_by=qby)
    out["flash_attention_bwd_dkv"].update(ms=cuda_ms(dkv_call, 20, warmup=3), plain_ms=bwd_plain,
                                          library_ms=lib_bwd, bound_ms=kb, bound_by=kby)
    return out


def decode_variants(g, B, S, H, Kv, Hd, dt, peaks, timed) -> dict:
    """K2 (cache in dt), K3 (q in dt, int8 cache) and K10 (pages in dt, 16
    tokens a page) at q [B, H, Hd], ragged intervals with an empty row,
    against their plain versions; with ``timed``, graph-replay times beside
    the plain versions' and SDPA's."""
    from rlinf_tpu_torch.ops.cuda import decode_attention as DA
    from rlinf_tpu_torch.ops.cuda import paged_attention as PA

    dev = "cuda"
    KD = Kv * Hd
    randn = lambda *shape: (torch.randn(shape, generator=g, device=dev) * 0.5).to(dt)
    lengths = torch.randint(S // 2, S + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    starts = torch.randint(0, S // 4, (B,), generator=g, device=dev, dtype=torch.int32)
    lengths[0], starts[0] = 0, 0
    q, kc, vc = randn(B, H, Hd), randn(B, S, KD), randn(B, S, KD)
    kq = torch.randint(-127, 128, (B, S, KD), generator=g, device=dev, dtype=torch.int8)
    vq = torch.randint(-127, 128, (B, S, KD), generator=g, device=dev, dtype=torch.int8)
    ks = torch.rand((B, S), generator=g, device=dev) * 0.02 + 0.005
    vs = torch.rand((B, S), generator=g, device=dev) * 0.02 + 0.005
    Pg, max_pages = 16, -(-S // 16)
    table = (torch.arange(B * max_pages, device=dev, dtype=torch.int32).reshape(B, max_pages) + 1)
    kp, vp = randn(1 + B * max_pages, Kv, Pg, Hd), randn(1 + B * max_pages, Kv, Pg, Hd)
    plen = lengths.clone()
    calls = {
        "decode_attention_bf16": (lambda: DA.decode_attention_packed(q, kc, vc, starts, lengths, num_kv=Kv),
                                  lambda: DA.decode_attention_packed_xla(q, kc, vc, starts, lengths, num_kv=Kv),
                                  nbytes(q, q, kc, vc) * 1.0),
        "decode_attention_q8": (lambda: DA.decode_attention_packed_q8(q, kq, vq, ks, vs, starts, lengths, num_kv=Kv),
                                lambda: DA.decode_attention_packed_q8_xla(q, kq, vq, ks, vs, starts, lengths, num_kv=Kv),
                                nbytes(q, q, kq, vq, ks, vs) * 1.0),
        "paged_attention": (lambda: PA.paged_attention(q, kp, vp, table, plen),
                            lambda: PA.paged_attention_xla(q, kp, vp, table, plen),
                            nbytes(q, q, table) + 2.0 * B * max_pages * Pg * KD * q.element_size()),
    }
    out = {}
    slots = int((lengths - starts).clamp_min(0).sum().item())
    for name, (call, plain, moved) in calls.items():
        got, ref = call(), plain()
        torch.cuda.synchronize()
        key = f"q[{B},{H},{Hd}] {DT[dt]} S={S}"
        if got.dtype != dt:
            raise AssertionError(f"{name} at {key}: output {got.dtype}, expected {dt}")
        r = held(name, key, head_rel_err(got, ref), dt,
                 {"empty_row_max_abs": got[0].float().abs().max().item()})
        if r["empty_row_max_abs"] != 0.0:
            raise AssertionError(f"{name} at {key}: the empty row is not 0: {r}")
        if timed:
            n_keys = int(plen.sum().item()) if name == "paged_attention" else slots
            if name == "paged_attention":
                kd_ = kp[table.long()].permute(0, 1, 3, 2, 4).reshape(B, max_pages * Pg, KD)
                vd_ = vp[table.long()].permute(0, 1, 3, 2, 4).reshape(B, max_pages * Pg, KD)
                st_ = torch.zeros_like(plen)
            else:
                kd_, vd_, st_ = kc, vc, starts
            pos_s = torch.arange(kd_.shape[1], device=dev)
            smask = ((pos_s[None, :] >= st_[:, None]) & (pos_s[None, :] < (plen if name == "paged_attention" else lengths)[:, None]))[:, None, None, :]
            r.update(ms=graph_ms(call), plain_ms=cuda_ms(plain, 5),
                     library_ms=graph_ms(sdpa_decode(q, kd_, vd_, Kv, smask)))
            frac = n_keys / (B * S)
            r["bound_ms"], r["bound_by"] = dt_bound(nbytes(q, q) + (moved - nbytes(q, q)) * frac,
                                                    4.0 * Hd * H * n_keys, peaks, dt)
        out[name] = r
    return out


def mega_variant(g, Hd, peaks, seed) -> dict:
    """K9 at a shipped small model's geometry (Hd=16: grpo_demo_tiny.yaml
    and the tiny preset, D=64; Hd=32: ppo_separate_critic.yaml, D=128) on
    packed random int8 weights and a random int8 cache, B=16, S=288,
    against its plain version (MEGA_BARS), timed beside its bound."""
    from rlinf_tpu_torch.models.llm import model as M
    from rlinf_tpu_torch.models.llm.config import LLMConfig
    from rlinf_tpu_torch.models.llm.quant import quantize_params
    from rlinf_tpu_torch.ops.cuda import decode_megakernel as MK

    D, F, L = (64, 128, 2) if Hd == 16 else (128, 256, 4)
    cfg = LLMConfig(vocab_size=258, hidden_size=D, intermediate_size=F, num_layers=L,
                    num_heads=D // Hd, num_kv_heads=2, max_seq_len=512, rope_theta=1e4,
                    dtype="bfloat16")
    qparams = quantize_params(M.init_params(cfg, seed, device="cuda"))
    plan, mw = MK.pack_decode_weights(qparams, cfg)
    B, S = 16, 288
    dev = "cuda"
    wp = torch.randint(S // 2, S, (B,), generator=g, device=dev, dtype=torch.int32)
    starts = torch.zeros((B,), dtype=torch.int32, device=dev)
    errs, cache, args = mega_case(MK, plan, mw, cfg, qparams, B, S, wp, wp.clone(), starts, g)
    bad = mega_bad({"k9": errs})
    if bad:
        raise AssertionError(f"K9 at Hd={Hd}: {errs}")
    call = lambda: MK.decode_step_mega(plan, mw, args[0], *cache, *args[1:])
    ms = cuda_ms(call, 20, warmup=3)
    plain_ms = cuda_ms(lambda: MK.decode_step_mega_plain(plan, mw, args[0], *[t.clone() for t in cache],
                                                         *args[1:]), 3)
    b_ms, b_by = mega_bound(plan, mw, B, int((wp - starts).sum().item()), peaks)
    return {**errs, "shapes": f"D={D} H={cfg.num_heads} Kv=2 Hd={Hd} L={L} B={B} S={S}",
            "ms": ms, "plain_ms": plain_ms, "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}


def lmhead_variants(g, n, D, V, dt, peaks, timed) -> dict:
    """K5 and K6 (tied [V, D] weight; also the untied [D, V] one when not
    timed) and K4 (hidden in dt, int8 head, greedy and sampled) at n rows,
    depth D, V columns, against their plain versions."""
    from rlinf_tpu_torch.ops.cuda import linear_ce as LCE
    from rlinf_tpu_torch.ops.cuda import sampler_kernel as SK

    dev = "cuda"
    h = (torch.randn((n, D), generator=g, device=dev)).to(dt)
    w = (torch.randn((V, D), generator=g, device=dev) * D**-0.5).to(dt)
    tgt = torch.randint(0, V, (n,), generator=g, device=dev, dtype=torch.int32)
    g_lp = torch.randn((n,), generator=g, device=dev)
    g_ent = torch.randn((n,), generator=g, device=dev) * 1e-3
    key = f"n={n} D={D} V={V} {DT[dt]}"
    out = {}
    for layout in ("vd",) if timed else ("vd", "dv"):
        wl = w if layout == "vd" else w.t().contiguous()
        lp, ent, lse = LCE.ce_forward(h, wl, tgt, 1.0, layout)
        lp_r, ent_r, lse_r = LCE.ce_forward_plain(h, wl, tgt, 1.0, layout)
        dz, dh = LCE.ce_backward(h, wl, tgt, lse, lse - ent, g_lp, g_ent, 1.0, layout)
        dz_r, dh_r = LCE.ce_backward_plain(h, wl, tgt, lse_r, lse_r - ent_r, g_lp, g_ent, 1.0, layout)
        torch.cuda.synchronize()
        if dh.dtype != dt:
            raise AssertionError(f"K6 at {key}: dh {dh.dtype}, expected {dt}")
        sfx = "" if layout == "vd" else "_untied"
        out["linear_ce_fwd" + sfx] = held("K5", key, max(rel_err(lp, lp_r), rel_err(ent, ent_r)), dt)
        out["linear_ce_bwd" + sfx] = held("K6", key, max(rel_err(dz, dz_r), rel_err(dh, dh_r)), dt)
    B = min(n, 64)
    lm_q = torch.randint(-127, 128, (D, V), generator=g, device=dev, dtype=torch.int8)
    lm_s = torch.rand((V,), generator=g, device=dev) * 0.01 + 1e-3
    head = SK.pack_lm_head(lm_q, lm_s)
    hid = h[:B].contiguous()
    tok, lp4 = SK.fused_lmhead_sample_packed(hid, head, 7, greedy=True)
    tok_r, lp4_r = SK.fused_lmhead_sample_packed_plain(hid, head, 7, greedy=True)
    stok, slp = SK.fused_lmhead_sample_packed(hid, head, 7, temperature=1.0)
    stok_r, slp_r = SK.fused_lmhead_sample_packed_plain(hid, head, 7, temperature=1.0)
    torch.cuda.synchronize()
    k4 = {"greedy_token_agree": (tok == tok_r).float().mean().item(),
          "greedy_lp_max_abs": (lp4 - lp4_r).abs().max().item(),
          "sampled_token_agree": (stok == stok_r).float().mean().item(),
          "sampled_lp_max_abs": (slp - slp_r).abs().max().item(), "bar_agree": 0.95,
          "bar_lp_max_abs": 0.15}
    if not (k4["greedy_token_agree"] > 0.95 and k4["sampled_token_agree"] > 0.95
            and k4["greedy_lp_max_abs"] < 0.15 and k4["sampled_lp_max_abs"] < 0.15):
        raise AssertionError(f"K4 at B={B} {key}: {k4}")
    out["fused_lmhead_sample"] = k4
    if not timed:
        return out
    flops = 2.0 * n * D * V
    b5 = dt_bound(nbytes(h, w, tgt) + 12 * n, flops, peaks, dt)
    b6 = dt_bound(nbytes(h, w, tgt, g_lp, g_ent, dz, dh) + 8 * n, 2 * flops, peaks, dt)
    hf = h.float() if dt == torch.float32 else h

    def lib_fwd():
        x = (hf @ w.t()).float()
        ls = torch.log_softmax(x, -1)
        return ls.gather(1, tgt.long()[:, None]), -(ls.exp() * ls).sum(-1)

    def lib_bwd():
        x = (hf @ w.t()).float()
        p = torch.softmax(x, -1)
        return (p.to(dt) @ w)

    out["linear_ce_fwd"].update(ms=cuda_ms(lambda: LCE.ce_forward(h, w, tgt, 1.0, "vd"), 3, warmup=1),
                                plain_ms=cuda_ms(lambda: LCE.ce_forward_plain(h, w, tgt, 1.0, "vd"), 2, warmup=1),
                                library_ms=cuda_ms(lib_fwd, 3, warmup=1), bound_ms=b5[0], bound_by=b5[1])
    out["linear_ce_bwd"].update(
        ms=cuda_ms(lambda: LCE.ce_backward(h, w, tgt, lse, lse - ent, g_lp, g_ent, 1.0, "vd"), 3, warmup=1),
        plain_ms=cuda_ms(lambda: LCE.ce_backward_plain(h, w, tgt, lse, lse - ent, g_lp, g_ent, 1.0, "vd"), 2,
                         warmup=1),
        library_ms=cuda_ms(lib_bwd, 3, warmup=1), bound_ms=b6[0], bound_by=b6[1])
    hq = hid.float() if dt == torch.float32 else hid
    wq = lm_q.to(hq.dtype)
    k4["ms"] = cuda_ms(lambda: SK.fused_lmhead_sample_packed(hid, head, 7, temperature=1.0), 20, warmup=3)
    k4["plain_ms"] = cuda_ms(lambda: SK.fused_lmhead_sample_packed_plain(hid, head, 7, temperature=1.0), 3)
    k4["library_ms"] = cuda_ms(lambda: torch.log_softmax((hq @ wq).float() * lm_s, -1).argmax(-1), 5)
    k4["bound_ms"], k4["bound_by"] = dt_bound(nbytes(hid, lm_q, lm_s) + 8 * B, 2.0 * B * D * V, peaks, dt)
    return out


def variant_checks(peaks, seed) -> dict:
    """Phase 17. Every attention kernel at head dims 16 and 32 (the shipped
    small models' heads, SMALL_HEADS) in bf16, f16 and f32, and at 64 and
    128 in f16 and f32; K4-K6 in f16 and f32 at the small models' widths
    (D=64, V=258); each against its plain version with its dtype's bar
    (DTYPE_BARS). Timed, beside the plain versions, the library calls and
    the bounds at each dtype's peak: the shipped small models' variants
    (Hd=16 in f32, Hd=32 in bf16, B=16, T=256) and one main-path shape per
    dtype at the runner's Qwen2.5-0.5B widths (f16 and f32: K1, K7, K8 at
    its training microbatch, B=16, T=768; K2, K3, K10 at B=64, S=768; K4 at
    B=64 and K5, K6 at 2048 rows of its [151936, 896] head). K9 at Hd 16
    and 32 (the small models' widths; it computes in bf16 whatever the
    model's dtype)."""
    g = torch.Generator(device="cuda").manual_seed(seed + 17)
    H, Kv = SMALL_HEADS
    res = {"bars": {DT[k]: v for k, v in DTYPE_BARS.items()}, "checks": {}, "timed": {}}
    shipped = {(16, torch.float32), (32, torch.bfloat16)}
    for Hd in (16, 32, 64, 128):
        for dt in DTYPES:
            if Hd >= 64 and dt == torch.bfloat16:
                continue  # the Hopper designs: phases 2 and 5
            timed = (Hd, dt) in shipped
            tag = f"Hd={Hd} {DT[dt]}"
            fl = flash_variant(g, 16 if Hd < 128 else 2, 256, H, Kv, Hd, dt, peaks, timed)
            de = decode_variants(g, 16, 288, H, Kv, Hd, dt, peaks, timed)
            (res["timed"] if timed else res["checks"])[f"small {tag}"] = {**fl, **de}
    for dt in DTYPES[1:]:
        res["checks"][f"lm head small {DT[dt]}"] = lmhead_variants(g, 256, 64, 258, dt, peaks, False)
    for Hd in (16, 32):
        res["timed"][f"small Hd={Hd} megakernel"] = {"decode_megakernel": mega_variant(g, Hd, peaks, seed)}
    for dt in DTYPES[1:]:
        tag = f"qwen2_0_5b {DT[dt]}"
        row = flash_variant(g, 16, 768, QWEN05["H"], QWEN05["Kv"], QWEN05["Hd"], dt, peaks, True)
        row.update(decode_variants(g, 64, 768, QWEN05["H"], QWEN05["Kv"], QWEN05["Hd"], dt, peaks, True))
        row.update(lmhead_variants(g, 2048, QWEN05["D"], QWEN05["V"], dt, peaks, True))
        res["timed"][tag] = row
        torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# Phase 26: the mesh across processes (the multi-process runner drill)
# ---------------------------------------------------------------------------

#: phase 26 runs grpo_math_qwen05b.yaml's model (LLMConfig.qwen2_0_5b) at
#: its full widths and this depth: four processes share the card, and every
#: collective is a gloo all-reduce through the host
DRILL_CUT = {"--num-layers=2": "2 of Qwen2.5-0.5B's 24 layers: the script's time limit (at 4 "
                               "layers the phase took 127-143 s and whole runs 1,030-1,140 s)"}
#: the kernels every rank of the collocated phases (A, B) must launch: K2
#: is the static engine's bf16 cache (the drill's rollout.kv_quant is none)
DRILL_KERNELS = ("flash_attention_fwd", "decode_attention_bf16", "fused_lmhead_sample",
                 "linear_ce_fwd", "linear_ce_bwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")
#: the parts of phase 26 after its phase C, and the kernels each must
#: launch (summed over its ranks): the ring's attention is plain PyTorch,
#: so the ring parts train through K5/K6 alone and decode through K2; the
#: sharded steps of (c) take K1/K7/K8 and K5/K6; the engines of (d) their
#: decode kernels (int8 KV: K3; the megakernel K9; the paged engine K10)
_TRAIN = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
          "linear_ce_fwd", "linear_ce_bwd")
PART_KERNELS = {
    "ring_step": ("linear_ce_fwd", "linear_ce_bwd"),
    "ring_runner": ("linear_ce_fwd", "linear_ce_bwd", "decode_attention_bf16"),
    "sft": _TRAIN, "lora": _TRAIN, "budget": _TRAIN, "adafactor": _TRAIN, "moe": _TRAIN,
    "continuous": ("decode_attention_q8",), "continuous_mega": ("decode_megakernel",),
    "paged": ("paged_attention",),
    # (e) the MoE runner at fsdp=2 x expert=2: its rollout (K2, K4), the
    # recompute and the sharded step; (f) the expert-parallel dropless
    # layer is plain PyTorch with collectives (no TPU kernel); (g) the ring
    # step of the MoE model, its attention plain as (a)'s; (h) the step
    # after the migration
    "moe_ep": _TRAIN + ("decode_attention_bf16", "fused_lmhead_sample"),
    "moe_ep_dropless": (),
    "moe_context": ("linear_ce_fwd", "linear_ce_bwd"),
    "migrate": _TRAIN,
}
#: the parts' cuts, beside DRILL_CUT (which cuts every part's depth)
DRILL_PARTS_REDUCED = {
    "ring_step": "B=2 rows of T=8,192 (the preset's max_seq_len raised to it), 3 steps",
    "moe": "qwen3_moe_2b's widths (32 experts, top-2, capacity) at DRILL_CUT's depth, "
           "max_seq_len 128, 1 step",
    "runners": "4 prompts x 4, 8 new tokens, 1 step a configuration (the ring runner 2)",
    "engines": "12 requests, 16 new tokens, 8 slots",
    "moe_ep": "qwen3_moe_2b's widths (32 experts, top-2, capacity) at DRILL_CUT's depth, "
              "4 prompts x 4, 8 new tokens, 1 step",
    "moe_ep_dropless": "one layer at qwen3_moe_2b's widths, 4 rows x 512 tokens a rank, f32",
    "moe_context": "qwen3_moe_2b's widths at DRILL_CUT's depth, B=2 rows of T=2,048, 1 step",
    "migrate": "Qwen2.5-0.5B's widths at DRILL_CUT's depth, 8 rows x 128 tokens, 1 step",
}


def drill_local_kernels(seed) -> dict:
    """K1, K7 + K8, K2 and K3 against their plain versions at the local
    shapes a rank of the drill gives them: the heads of a tensor=2 shard of
    Qwen2.5-0.5B (7 query heads on 1 kv head, Hd 64), a batch rank's rows of
    the drill's rollout, its prompt bucket plus its new tokens. The bars are
    the main checks' (phases 2 and 4); each case has a row with nothing
    valid, which must give exactly 0."""
    from rlinf_tpu_torch.multiprocess_runner_drill import mesh_config, trainer_config

    cfg = trainer_config({"device": "cuda", "model": "qwen2_0_5b"}, None, 1)
    mesh, m = mesh_config(4), cfg.model
    H, Kv, Hd = m.num_heads // mesh.tensor, m.num_kv_heads // mesh.tensor, m.head_dim_
    B = cfg.runner.rollout_batch_size * cfg.algorithm.group_size // (4 // mesh.tensor)
    T = cfg.rollout.prompt_bucket + cfg.sampling.max_new_tokens
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)

    attention = ((B, T, H, Kv, Hd, True),)               # left-padded prompts
    # decode intervals [start, length) in a cache of T slots; the last row empty
    starts = [int(x) for x in np.random.default_rng(seed).integers(0, T // 2, B - 1)] + [T]
    lengths = [min(st + 1 + 2 * i, T) for i, st in enumerate(starts[:-1])] + [T]
    decode = ((B, T, H, Kv, Hd, starts, lengths),)
    return {"shapes": f"q[{B},{T},{H},{Hd}] k/v[{B},{T},{Kv},{Hd}] bf16",
            "K1": flash_fwd_ragged(randn, attention), "K7_K8": flash_bwd_ragged(randn, attention),
            "K2": decode_ragged(randn, decode, q8=False), "K3": decode_ragged(randn, decode, q8=True)}


def mesh_drill_phase(kerns, gpu, seed) -> dict:
    """Phase 26 (see the module docstring). Returns the launches of every
    rank of phases A, B and C, summed."""
    from rlinf_tpu_torch.config import load_config
    from rlinf_tpu_torch.models.llm.config import LLMConfig

    t_phase = time.perf_counter()
    # the kernels at the ranks' shapes first, in this process (these
    # launches are the checks', not the main path's: the drill counts its own)
    local = drill_local_kernels(seed)
    yaml_model = load_config(str(HERE / RUNNER_YAML), []).model
    preset = LLMConfig.qwen2_0_5b()
    if dataclasses.replace(yaml_model, max_seq_len=preset.max_seq_len) != preset:
        raise AssertionError(f"qwen2_0_5b {preset} is not {RUNNER_YAML}'s model {yaml_model}")
    work = HERE / "build" / "mesh_drill"
    work.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, "-m", "rlinf_tpu_torch.multiprocess_runner_drill",
           "--device", "cuda", "--num-processes", "4", "--model", "qwen2_0_5b",
           *DRILL_CUT, "--workdir", str(work)]
    # its own process group, so that a timeout ends the ranks it spawned too
    proc = subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError("the multi-process drill did not end within 600 s")
    if proc.returncode != 0:
        print(stdout[-4000:], stderr[-8000:], file=sys.stderr, flush=True)
        raise AssertionError(f"the multi-process drill failed (rc {proc.returncode})")
    summary = json.loads([ln for ln in stdout.splitlines() if ln.startswith("{")][-1])
    if not summary.get("ok"):
        raise AssertionError(f"the drill reported failure: {summary}")
    launches = dict.fromkeys(kerns, 0)
    missing = {}
    for part, info in summary["parts"].items():
        print(f"mesh drill part {part}: {info['seconds']:.1f} s, launches "
              f"{json.dumps(info['launches'])}, collectives {json.dumps(info['collectives'])}",
              flush=True)
        if part in ("moe_ep", "moe_context", "migrate", "moe_ep_dropless"):
            keep = ("loss", "grad_norm", "world1", "step_s", "exchange", "exchange_s_per_rank",
                    "forward_s", "backward_s", "rel_err", "aux_rel_err", "migrations",
                    "migrate_and_step_s", "prepare_wait_s", "direct_loss", "direct_grad_norm",
                    "peak_gib")
            print(f"mesh drill part {part} figures: "
                  f"{json.dumps({k: v for k, v in info.items() if k in keep})}", flush=True)
        lacking = [k for k in PART_KERNELS[part] if info["launches"].get(k, 0) == 0]
        if lacking:
            missing[f"part {part}"] = lacking
        for k, c in info["launches"].items():
            launches[k] += c
    for phase in ("launches_a", "launches_b"):
        for rank, counts in summary[phase].items():
            lacking = [k for k in DRILL_KERNELS if counts.get(k, 0) == 0]
            if lacking:
                missing[f"{phase}/{rank}"] = lacking
            for k, c in counts.items():
                launches[k] += c
    for rank, (_role, counts) in summary["launches_c"].items():
        for k, c in counts.items():
            launches[k] += c
    out = {"phase": "mesh_drill", "gpu": gpu, "config": RUNNER_YAML, "model": "qwen2_0_5b",
           "reduced": {**DRILL_CUT, **DRILL_PARTS_REDUCED},
           "transport": "gloo, 4 processes on one card",
           "command": " ".join(cmd[1:]), "local_kernel_checks": local,
           **{k: v for k, v in summary.items()
                                           if not k.startswith("launches_")},
           "launches": {k: summary[k] for k in ("launches_a", "launches_b", "launches_c")},
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    if missing:
        raise AssertionError(f"ranks that did not launch a kernel of the mesh path: {missing}")
    return launches


# ---------------------------------------------------------------------------
# Phase 27: the VLM reasoning stack
# ---------------------------------------------------------------------------

#: the vision tower at the widths of CLIP ViT-L/14 at 224 px
#: (openai/clip-vit-large-patch14: 24 layers of 1024, 16 heads, MLP ratio 4,
#: 256 patches of 14 px and a class token), timm-style blocks
VLM_VIT = dict(image_size=224, patch_size=14, hidden=1024, layers=24, heads=16,
               timm_style=True, cls_token=True)
#: 4 prompts x the example's group of 8 = 32 rows, 32 new tokens; 2 SFT
#: steps, then 2 GRPO steps from the SFT'd params (the example: 8 prompts,
#: 8 new tokens, 40 and 60 steps)
VLM_RUN = dict(rollout_batch_size=4, max_new_tokens=32, sft_steps=2, grpo_steps=2)
#: behaviour logprobs (bf16 KV-cached decode) against forward's recompute
#: (bf16 full-sequence forward) on step 1's response tokens: the runner
#: phase's bar for the same bf16 gap (phase 4's per-token bar is 0.15)
VLM_GAP_BAR = DRIFT_BAR


class IdTextTokenizer:
    """The byte tokenizer, whose decode also renders every id past the
    byte range as "<id>": with Qwen's 151,936 ids and random weights the
    byte tokenizer decodes ~0.17% of the tokens, so nearly every 32-token
    text would be empty and no reward rule on texts could tell the rows
    apart."""

    def __init__(self):
        from rlinf_tpu_torch.data.tokenizers import ByteTokenizer

        self._bytes = ByteTokenizer()
        self.pad_id, self.eos_id = self._bytes.pad_id, self._bytes.eos_id

    def encode(self, text):
        return self._bytes.encode(text)

    def decode(self, ids):
        return "".join(self._bytes.decode([i]) if 2 <= i < 258 else f"<{i}>" for i in ids)


def vlm_rule(texts, answers):
    """crc32 of the text mod 2: about half the rows score 1, so nearly every
    group of 8 is mixed (with random weights the VQA reward scores every
    response 0 and the update would be vacuous)."""
    import zlib

    return [float(zlib.crc32(t.encode("utf-8")) % 2) for t in texts]


def off_card(tree) -> list:
    """Paths of the tensors of ``tree`` that do not lie on the card."""
    from rlinf_tpu_torch.utils.checkpoint import flatten

    return [k for k, v in flatten(tree).items()
            if isinstance(v, torch.Tensor) and v.device.type != "cuda"]


@contextlib.contextmanager
def watching_vlm(record: dict):
    """For one main_vlm_grpo run: keep each train step's batch placement,
    the share of mixed groups and, before GRPO step 1's update, the gap
    between the behaviour logprobs and forward's recompute on the response
    tokens; clone the params before the first SFT step."""
    from rlinf_tpu_torch.runners.vlm_reasoning_runner import VLMReasoningRunner
    from rlinf_tpu_torch.runners.vlm_sft_runner import VLMSFTRunner

    orig = {R: R._train_step for R in (VLMSFTRunner, VLMReasoningRunner)}

    def sft_step(self, state, batch):
        if "params0" not in record:
            record["params0"] = clone_tree(state.params)
        record.setdefault("off_card", []).extend(f"sft batch {k}" for k in off_card(batch))
        return orig[VLMSFTRunner](self, state, batch)

    def grpo_step(self, state, batch):
        record.setdefault("off_card", []).extend(f"grpo batch {k}" for k in off_card(batch))
        G = self.cfg.algorithm.group_size
        adv = batch["advantages"].abs().reshape(-1, G * batch["advantages"].shape[1])
        record.setdefault("mixed_group_share", []).append(
            float((adv.amax(dim=1) > 0).float().mean()))
        if "gap" not in record:
            with torch.no_grad():
                lp, _ = self.model.forward(
                    state.params, batch["images"], batch["prompt_ids"], batch["prompt_mask"],
                    batch["response_ids"], batch["loss_mask"],
                    temperature=self.cfg.sampling.temperature)
            m = batch["loss_mask"]
            d = (lp - batch["old_logprobs"]).abs()[m]
            record["gap"] = {"mean_abs": float(d.mean()), "max_abs": float(d.max()),
                             "tokens": int(m.sum()), "bar": VLM_GAP_BAR}
        return orig[VLMReasoningRunner](self, state, batch)

    VLMSFTRunner._train_step, VLMReasoningRunner._train_step = sft_step, grpo_step
    try:
        yield
    finally:
        for R, fn in orig.items():
            R._train_step = fn


def vlm_phase(kerns, gpu, seed) -> dict:
    """Phase 27 (see the module docstring). Returns the launches of the run
    (all 0: the path takes the plain versions, as the JAX package's VLM
    takes XLA)."""
    from rlinf_tpu_torch import main_vlm_grpo
    from rlinf_tpu_torch.models.embodiment.vit import ViTConfig
    from rlinf_tpu_torch.models.llm.config import LLMConfig

    t_phase = time.perf_counter()
    model, vit = LLMConfig.qwen2_0_5b(), ViTConfig(**VLM_VIT)
    record = {}
    torch.cuda.reset_peak_memory_stats()
    with watching_vlm(record):
        res, secs, counts = run_counted(kerns, lambda: main_vlm_grpo.main(
            "cuda", VLM_RUN["sft_steps"], VLM_RUN["grpo_steps"], model=model, vit=vit,
            rollout_batch_size=VLM_RUN["rollout_batch_size"],
            max_new_tokens=VLM_RUN["max_new_tokens"], tokenizer=IdTextTokenizer(),
            reward_fn=vlm_rule, seed=seed, log_dir=None))
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    sft, grpo, runner = res["sft"], res["grpo"], res["runner"]
    time_keys = ("time/rollout", "time/reward", "time/training", "time/step")
    out = {"phase": "vlm", "gpu": gpu, "entry": "rlinf_tpu_torch.main_vlm_grpo.main",
           "decoder": f"qwen2_0_5b ({model.dtype}, {model.num_layers} layers, D="
                      f"{model.hidden_size}, V={model.vocab_size})", "vision_tower": VLM_VIT,
           "projector": f"2-layer tanh-GELU MLP {vit.hidden} -> {model.hidden_size} -> "
                        f"{model.hidden_size}, f32",
           "rows": VLM_RUN["rollout_batch_size"] * runner.cfg.algorithm.group_size,
           "prefix_tokens": vit.num_patches + len("what color?"), **VLM_RUN,
           "seconds": secs, "sft_step_s": [h["time/step"] for h in sft],
           "grpo_history": [{k: h[k] for k in (*time_keys, "actor/loss", "actor/grad_norm",
                                             "actor/approx_kl", "rollout/reward_mean")}
                          for h in grpo],
           "sft_history": [{k: h[k] for k in ("sft/loss", "sft/grad_norm", "time/step")}
                         for h in sft],
           "step1_approx_kl": grpo[0]["actor/approx_kl"],
           "logprob_gap_step1": record["gap"],
           "mixed_group_share": record["mixed_group_share"],
           "params_moved_share": moved_share(runner.state.params, record["params0"]),
           "max_memory_allocated_gib": peak_gb, "launches": counts,
           "launches_why_zero": "the path runs no hand-written kernel: the ViT's and the "
                                "decoder's attention take the plain causal_attention "
                                "(impl='xla'), the decode the plain decode_attention on the "
                                "unpacked cache, the logprobs an f32 matmul + log_softmax, "
                                "as the JAX package's VLM takes XLA"}
    bad = [b for b in finite_steps(sft) + finite_steps(grpo)]
    bad += record["off_card"]
    bad += [f"state {k} off the card" for r in (res["sft_runner"], runner)
            for k in off_card(r.state)]
    bad += [f"{k} launched {c}" for k, c in counts.items() if c]
    if not (len(sft) == VLM_RUN["sft_steps"] and len(grpo) == VLM_RUN["grpo_steps"]):
        bad.append(f"{len(sft)} SFT and {len(grpo)} GRPO steps")
    if not out["params_moved_share"] > 0:
        bad.append("params did not move")
    bad += [f"logprob gap {k} {record['gap'][k]} over {bar}" for k, bar in VLM_GAP_BAR.items()
            if not record["gap"][k] < bar]
    if not min(record["mixed_group_share"]) >= 0.5:
        bad.append(f"mixed groups {record['mixed_group_share']}: the update is near vacuous")
    del res, runner, record
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds_phase"] = time.perf_counter() - t_phase
    emit(out)
    if bad:
        raise AssertionError(f"VLM phase failed: {bad}")
    return counts


# ---------------------------------------------------------------------------
# Phase 28: the embodied PPO stack
# ---------------------------------------------------------------------------

#: part (a): examples/embodiment/train_ppo_point_reach.py's settings (256
#: envs, 32 chunk steps a rollout, 2 epochs x 4 minibatches), 2 steps, once
#: with 1 stage of 256 envs and once with 2 stages of 128
POINT_REACH_RUN = dict(num_envs=256, steps=2, stages=(1, 2))
#: parts (b)-(c): examples/embodiment/image_reach_tpu_proof.py's settings
#: (128 envs, the goal only in the image, 2-step action chunks, 8 chunk
#: steps a rollout, 2 epochs x 4 minibatches), 2 steps each
IMAGE_REACH_ENV = dict(num_envs=128, max_episode_steps=16, goal_radius=0.3, dt=0.3)
IMAGE_REACH_CHUNK = 2
IMAGE_REACH_RUN = dict(num_chunk_steps=8, num_epochs=2, num_mini_batches=4, gamma=0.9,
                       gae_lambda=0.95, max_steps=2)
#: (b) the Nature-CNN takes 36 px at least (its three VALID convolutions):
#: the proof's 32-px images are too small for it, so the CNN's env renders 36
CNN_IMAGE = 36
#: (c) the proof's OFT-style VLA
OFT_VLA = dict(image_size=32, patch_size=8, action_dim=2, action_chunk=IMAGE_REACH_CHUNK,
               proprio_dim=2, hidden=128, trunk_layers=3, vit_layers=2, heads=4,
               init_logstd=-0.5)
#: (d) OpenVLA's second tower at DINOv2-L/14's widths (facebook/dinov2-large:
#: 24 layers of 1024, 16 heads, MLP ratio 4, patch 14, a class token), the
#: same timm-style blocks; the first tower is phase 27's ``VLM_VIT``
OPENVLA_TOWER2 = dict(image_size=224, patch_size=14, hidden=1024, layers=24, heads=16,
                      timm_style=True, cls_token=True)
#: (d) 2 stages x 8 envs x 8 chunk steps = 128 samples a rollout, 1 PPO epoch
#: over 4 minibatches of 32, 2 runner steps, then one deterministic eval
#: epoch of 8 chunk steps on 8 envs
OPENVLA_RUN = dict(stages=2, envs_per_stage=8, num_chunk_steps=8, num_epochs=1,
                   num_mini_batches=4, steps=2, eval_envs=8, eval_steps=8, action_bins=256,
                   lr=1e-5)
#: behaviour logprobs (bf16 KV-cached bin decode) against the learner's
#: recompute (bf16 teacher-forced forward) on step 1's first minibatch: the
#: runner phase's bar for the same bf16 gap, as phase 27's
OPENVLA_GAP_BAR = DRIFT_BAR
EMBODIED_WHY_ZERO = ("the embodied path runs no hand-written kernel: the MLP and CNN "
                     "policies are plain matmuls and convolutions, the towers' and the "
                     "trunks' attention take the plain causal_attention (impl='xla'), "
                     "OpenVLA's bin decode the plain decode_attention on the unpacked cache "
                     "and its bin logprobs an f32 matmul + log_softmax, as the JAX "
                     "package's embodied path takes XLA")
EMBODIED_METRICS = ("time/rollout", "time/training", "time/step", "perf/env_steps_per_s",
                    "actor/loss", "actor/grad_norm", "actor/approx_kl",
                    "critic/value_loss", "rollout/reward_mean")


def pos_only_image_reach():
    """image_reach_tpu_proof.py's env: ImageReach whose state vector holds
    the agent's position only, so the goal is seen only in the image."""
    from rlinf_tpu_torch.envs.toy import ImageReachEnv

    class PosOnlyImageReach(ImageReachEnv):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.obs_spec = {"states": (2,), "images": (self.size, self.size, 3)}

        def _obs(self):
            o = super()._obs()
            o["states"] = o["states"][:, :2]
            return o

    return PosOnlyImageReach


def embodied_steps(history) -> list:
    return [{k: h[k] for k in EMBODIED_METRICS if k in h} for h in history]


def image_reach_part(kerns, policy, image_size, lr, seed) -> dict:
    """Parts (b)-(c): ``policy`` trained 2 steps on the proof's chunked
    pos-only ImageReach at ``image_size`` px."""
    from rlinf_tpu_torch.envs.wrappers import ActionChunkWrapper
    from rlinf_tpu_torch.runners.embodied_runner import EmbodiedRunner, EmbodiedRunnerConfig
    from rlinf_tpu_torch.training.train_state import OptimizerConfig

    env = ActionChunkWrapper(pos_only_image_reach()(seed=seed, size=image_size,
                                                    **IMAGE_REACH_ENV), IMAGE_REACH_CHUNK)
    runner = EmbodiedRunner(EmbodiedRunnerConfig(seed=seed, **IMAGE_REACH_RUN), [env], policy,
                            optimizer=OptimizerConfig(lr=lr, clip_grad=1.0), device="cuda")
    params0 = clone_tree(runner.state.params)
    hist, secs, counts = run_counted(kerns, runner.run)
    out = {"seconds": secs, "image_px": image_size, "steps": embodied_steps(hist),
           "launches": counts, "params_moved_share": moved_share(runner.state.params, params0)}
    bad = finite_steps(hist, EMBODIED_METRICS) + [f"{k} launched {c}"
                                                  for k, c in counts.items() if c]
    bad += [f"state {k} off the card" for k in off_card(runner.state)]
    if len(hist) != IMAGE_REACH_RUN["max_steps"] or not out["params_moved_share"] > 0:
        bad.append(f"{len(hist)} steps, params moved {out['params_moved_share']}")
    return out, bad


def openvla_part(kerns, seed) -> tuple:
    """Part (d): EmbodiedRunner with OpenVLAPolicy at Qwen2.5-0.5B's widths
    and depth and two fused towers on ImageReachEnv(size=224)."""
    from rlinf_tpu_torch.envs.toy import ImageReachEnv
    from rlinf_tpu_torch.models.embodiment.openvla import OpenVLAConfig, OpenVLAPolicy
    from rlinf_tpu_torch.models.embodiment.vit import ViTConfig
    from rlinf_tpu_torch.models.llm.config import LLMConfig
    from rlinf_tpu_torch.runners.embodied_runner import EmbodiedRunner, EmbodiedRunnerConfig
    from rlinf_tpu_torch.training.train_state import OptimizerConfig
    from rlinf_tpu_torch.utils.checkpoint import flatten

    run = OPENVLA_RUN
    model, vit, vit2 = LLMConfig.qwen2_0_5b(), ViTConfig(**VLM_VIT), ViTConfig(**OPENVLA_TOWER2)
    policy = OpenVLAPolicy(OpenVLAConfig(action_dim=2, action_bins=run["action_bins"]),
                           vlm_cfg=model, vit_cfg=vit, vit2_cfg=vit2)
    envs = [ImageReachEnv(run["envs_per_stage"], seed=seed + s, size=224)
            for s in range(run["stages"])]
    cfg = EmbodiedRunnerConfig(num_chunk_steps=run["num_chunk_steps"],
                               num_epochs=run["num_epochs"],
                               num_mini_batches=run["num_mini_batches"], max_steps=run["steps"],
                               eval_interval=run["steps"], eval_steps=run["eval_steps"],
                               seed=seed)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner = EmbodiedRunner(cfg, envs, policy,
                            optimizer=OptimizerConfig(lr=run["lr"], clip_grad=1.0),
                            eval_envs=[ImageReachEnv(run["eval_envs"], seed=999, size=224)],
                            device="cuda")
    init_s = time.perf_counter() - t0
    n_params = sum(v.numel() for v in flatten(runner.state.params).values())
    params0 = clone_tree(runner.state.params)
    record, step = {}, runner.train_step

    def watched(state, mb):
        # before the first update: the learner's recompute of the rollout's bins
        if "gap" not in record:
            with torch.no_grad():
                obs = {k[len("obs/"):]: v for k, v in mb.items() if k.startswith("obs/")}
                lp = policy.default_forward(state.params, obs, mb["actions"])["logprobs"]
            d = (lp - mb["old_logprobs"]).abs()
            record["gap"] = {"mean_abs": float(d.mean()), "max_abs": float(d.max()),
                             "bins": int(d.numel()), "bar": OPENVLA_GAP_BAR}
            record["off_card"] = [k for k, v in mb.items() if v.device.type != "cuda"]
        return step(state, mb)

    runner.train_step = watched
    hist, secs, counts = run_counted(kerns, runner.run)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    out = {"entry": "rlinf_tpu_torch.runners.embodied_runner.EmbodiedRunner",
           "policy": "OpenVLAPolicy", "env": "ImageReachEnv(size=224)",
           "decoder": f"qwen2_0_5b ({model.dtype}, {model.num_layers} layers, D="
                      f"{model.hidden_size}, V={model.vocab_size}, the last "
                      f"{run['action_bins']} ids the bins)",
           "tower1": VLM_VIT, "tower2": OPENVLA_TOWER2,
           "projector": f"2-layer erf-GELU MLP {vit.hidden + vit2.hidden} -> "
                        f"{model.hidden_size} -> {model.hidden_size}, f32",
           "prefix_tokens": vit.num_patches, "params": n_params, **run,
           "samples_per_rollout": run["stages"] * run["envs_per_stage"] * run["num_chunk_steps"],
           "init_s": init_s, "seconds": secs, "steps": embodied_steps(hist),
           "eval": {k: v for k, v in hist[-1].items() if k.startswith("eval/")},
           "logprob_gap_step1": record["gap"],
           "params_moved_share": moved_share(runner.state.params, params0),
           "max_memory_allocated_gib": peak_gib, "launches": counts,
           "not_expressed": "ViTConfig has one MLP ratio and no register tokens or "
                            "LayerScale: SigLIP-so400m's widths (1152, MLP 4304) and "
                            "DINOv2's register tokens cannot be set, so tower 1 takes "
                            "CLIP ViT-L/14's widths and tower 2 DINOv2-L/14's without "
                            "registers"}
    bad = finite_steps(hist, EMBODIED_METRICS) + record["off_card"]
    bad += [f"{k} launched {c}" for k, c in counts.items() if c]
    bad += [f"state {k} off the card" for k in off_card(runner.state)]
    if len(hist) != run["steps"] or not out["eval"]:
        bad.append(f"{len(hist)} steps, eval {out['eval']}")
    if not out["params_moved_share"] > 0:
        bad.append("params did not move")
    bad += [f"logprob gap {k} {record['gap'][k]} over {b}" for k, b in OPENVLA_GAP_BAR.items()
            if not record["gap"][k] < b]
    return out, bad


def embodied_phase(kerns, gpu, seed) -> dict:
    """Phase 28 (see the module docstring). Returns the launches of its runs
    (all 0: the embodied path takes the plain versions, as the JAX
    package's takes XLA)."""
    from rlinf_tpu_torch import main_embodied_ppo
    from rlinf_tpu_torch.models.embodiment import CNNGaussianPolicy
    from rlinf_tpu_torch.models.embodiment.vla_policy import VLAPolicy

    t_phase = time.perf_counter()
    out = {"phase": "embodied", "gpu": gpu, "launches_why_zero": EMBODIED_WHY_ZERO}
    bad, total = [], {name: 0 for name in kerns}

    def add(counts):
        for k, c in counts.items():
            total[k] += c

    # (a) main_embodied_ppo on point_reach, 1 stage then 2 at the same envs
    out["a_point_reach"] = {"entry": "rlinf_tpu_torch.main_embodied_ppo.main",
                            "num_envs": POINT_REACH_RUN["num_envs"]}
    for stages in POINT_REACH_RUN["stages"]:
        res, secs, counts = run_counted(kerns, lambda: main_embodied_ppo.main(
            "cuda", num_envs=POINT_REACH_RUN["num_envs"], stages=stages,
            steps=POINT_REACH_RUN["steps"], log_dir=None))
        hist = res["history"]
        out["a_point_reach"][f"stages_{stages}"] = {
            "seconds": secs, "steps": embodied_steps(hist), "launches": counts}
        bad += [f"(a) {stages} stages {b}" for b in finite_steps(hist, EMBODIED_METRICS)]
        bad += [f"(a) {k} launched {c}" for k, c in counts.items() if c]
        if len(hist) != POINT_REACH_RUN["steps"]:
            bad.append(f"(a) {len(hist)} steps")
        add(counts)
    # the rollout's seconds at step 2 (step 1 carries the first calls)
    one, two = (out["a_point_reach"][f"stages_{s}"]["steps"][-1]["time/rollout"]
                for s in POINT_REACH_RUN["stages"])
    out["a_point_reach"]["rollout_s_step2_1_vs_2_stages"] = [one, two]

    # (b) the CNN policy and (c) the OFT-style VLA on the proof's ImageReach
    chunk_a = 2 * IMAGE_REACH_CHUNK
    for part, policy, px, lr in (
            ("b_cnn", CNNGaussianPolicy(image_shape=(CNN_IMAGE, CNN_IMAGE, 3), action_dim=chunk_a,
                                        proprio_dim=2, init_logstd=-0.5), CNN_IMAGE, 2e-3),
            ("c_oft_vla", VLAPolicy(**OFT_VLA), OFT_VLA["image_size"], 2e-3)):
        res, part_bad = image_reach_part(kerns, policy, px, lr, seed)
        out[part] = res
        bad += [f"({part[0]}) {b}" for b in part_bad]
        add(res["launches"])

    # (d) OpenVLA at full width and depth with two fused towers
    res, part_bad = openvla_part(kerns, seed)
    out["d_openvla"] = res
    bad += [f"(d) {b}" for b in part_bad]
    add(res["launches"])
    gc.collect()
    torch.cuda.empty_cache()
    out["launches"] = total
    out["seconds_phase"] = time.perf_counter() - t_phase
    emit(out)
    if bad:
        raise AssertionError(f"embodied phase failed: {bad}")
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_start = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the GPU",
              file=sys.stderr)
        return 1
    import rlinf_tpu_torch
    if Path(rlinf_tpu_torch.__file__).resolve().parents[1] != HERE:
        raise RuntimeError("chip_smoke.py must run from the checkout that holds rlinf_tpu_torch")
    from rlinf_tpu_torch.config import RolloutConfig
    from rlinf_tpu_torch.data.io_struct import RolloutRequest
    from rlinf_tpu_torch.models.llm import model as M
    from rlinf_tpu_torch.models.llm.config import LLMConfig
    from rlinf_tpu_torch.models.llm.quant import QTensor, quantize_params
    from rlinf_tpu_torch.models.llm.sampler import (
        SamplingParams, generate, with_packed_lm_head,
    )
    from rlinf_tpu_torch.ops.cuda import build, kernels
    from rlinf_tpu_torch.rollout import build_rollout_engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    name = torch.cuda.get_device_name(0)
    peak_name, peaks = card_peaks(name)
    emit({"phase": "device", "gpu": gpu, "torch": torch.__version__,
          "cuda": torch.version.cuda, "peaks_from": peak_name, "hf_packages": hf_packages()})

    # 1. build
    emit({"phase": "build", "seconds": build()})
    reports = kernel_reports()
    emit({"phase": "kernel_reports", **reports})
    check_reports(reports)

    cfg = LLMConfig.qwen2_1_5b()
    B, N, bucket = 64, 256, 64
    rng = np.random.default_rng(args.seed)
    prompt_lens = rng.integers(128, 513, B)
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, n))) for n in prompt_lens]
    P = -(-int(prompt_lens.max()) // bucket) * bucket

    # 2. kernels
    with torch.inference_mode():
        results = check_kernels(cfg, B, P, N, prompt_lens, peaks, args.seed)
    emit({"phase": "kernels", "gpu": gpu, "results": results})
    torch.cuda.empty_cache()

    # 3. main path
    kerns = kernels()
    t0 = time.perf_counter()
    params = M.init_params(cfg, args.seed, device="cuda")
    init_s = time.perf_counter() - t0
    sp = SamplingParams(max_new_tokens=N, temperature=1.0, eos_token_id=-1)
    trainer_cfg = types.SimpleNamespace(
        model=cfg, sampling=sp, attn_impl="pallas",
        rollout=RolloutConfig(engine="static", weight_quant="int8", prompt_bucket=bucket),
        data=types.SimpleNamespace(max_prompt_len=512),
        algorithm=types.SimpleNamespace(recompute_logprobs=None),
    )
    engine = build_rollout_engine(trainer_cfg, device="cuda")
    request = RolloutRequest(prompt_ids=prompts)
    L = cfg.num_layers
    runs = {}

    res, secs, counts = run_counted(
        kerns, lambda: engine.rollout(params, request, torch.Generator().manual_seed(args.seed)))
    check_output(res.response_ids, res.response_logprobs, res.response_mask, B, N, cfg.vocab_size)
    want = {**dict.fromkeys(kerns, 0), "flash_attention_fwd": L,
            "decode_attention_bf16": L * (N - 1), "fused_lmhead_sample": N}
    if counts != want:
        raise AssertionError(f"rollout launch counts {counts}, expected {want}")
    runs["rollout_bf16_kv"] = (secs, counts)

    ids, mask = request.left_padded(sp.pad_token_id, bucket=bucket)
    with torch.inference_mode():
        qparams = quantize_params(params)
        out, secs, counts = run_counted(kerns, lambda: generate(
            params, cfg, torch.Generator().manual_seed(args.seed + 1), ids, mask, sp,
            attn_impl="pallas", decode_params=qparams, decode_attn_impl="pallas",
            kv_quant="int8", device="cuda"))
    check_output(out.response_ids.cpu(), out.response_logprobs.cpu(), out.response_mask.cpu(),
                 B, N, cfg.vocab_size)
    want = {**dict.fromkeys(kerns, 0), "flash_attention_fwd": L,
            "decode_attention_q8": L * (N - 1), "fused_lmhead_sample": N}
    if counts != want:
        raise AssertionError(f"generate(kv_quant='int8') launch counts {counts}, expected {want}")
    runs["generate_int8_kv"] = (secs, counts)
    launches = {k: sum(c[k] for _, c in runs.values()) for k in kerns}

    # the parts of a run, timed alone with CUDA events
    with torch.inference_mode():
        ids_t = torch.as_tensor(ids, device="cuda")
        mask_t = torch.as_tensor(mask, device="cuda")
        prefill_ms = cuda_ms(lambda: M.prefill(params, cfg, ids_t, mask_t, P + N,
                                               attn_impl="pallas"), 2, warmup=1)
        quantize_ms = cuda_ms(lambda: quantize_params(params), 2, warmup=1)
        qleaves = [w for w in qparams["blocks"].values() if isinstance(w, QTensor)]
        upcast_ms = cuda_ms(lambda: [w.q.to(torch.bfloat16) for w in qleaves], 5)
    main = {"phase": "main_path", "gpu": gpu, "model": "qwen2_1_5b", "layers": L,
            "batch": B, "prompt_bucket": P, "new_tokens": N,
            "prompt_len_min": int(prompt_lens.min()), "prompt_len_max": int(prompt_lens.max()),
            "init_params_s": init_s, "prefill_ms": prefill_ms, "quantize_params_ms": quantize_ms,
            "int8_weight_upcast_ms_per_step": upcast_ms}
    for run, (secs, counts) in runs.items():
        decode_total = secs * 1e3 - prefill_ms - (quantize_ms if run == "rollout_bf16_kv" else 0)
        main[run] = {"seconds": secs, "generated_tokens_per_s": B * N / secs,
                     "decode_ms_per_step": decode_total / (N - 1), "launches": counts}
    emit(main)
    del engine, out
    torch.cuda.empty_cache()

    # 4. greedy check. Gate: every kernel call of a 16-token greedy run
    # against its plain version on the same inputs (shadow mode). Reported:
    # free-running agreement of whole runs, where bf16 rounding differences
    # grow through the 28 random-weight layers (PERF.md, Findings).
    greedy = SamplingParams(max_new_tokens=16, greedy=True)
    check = {"phase": "greedy_check", "new_tokens": 16}
    with torch.inference_mode():
        for kv in ("none", "int8"):
            def run(impl="pallas"):
                return generate(params, cfg, torch.Generator(), ids, mask, greedy,
                                attn_impl=impl, decode_params=qparams, decode_attn_impl=impl,
                                kv_quant=kv, sampler_impl=None if impl == "pallas" else "xla",
                                device="cuda")
            stats = {}
            with kernels_replaced(shadowed(stats)):
                fast = run()
            with kernels_replaced(plain_only):
                plain, _, counts = run_counted(kerns, run)
            if any(counts.values()):
                raise AssertionError(f"plain run launched kernels: {counts}")
            xla = run("xla")

            def agree(a, b):
                return (a.response_ids == b.response_ids).float().mean().item()

            sampler = stats["fused_lmhead_sample"]
            attn = [v["max_abs_err"] for k, v in stats.items() if k != "fused_lmhead_sample"]
            check[f"kv_{kv}"] = {
                "shadow": stats,
                "free_running_agree": {"kernels_vs_plain": agree(fast, plain),
                                       "plain_vs_xla_path": agree(plain, xla)},
            }
            if not (sampler["token_agree"] > 0.95 and sampler["max_abs_err"] < 0.15
                    and max(attn) < 2e-2 and len(stats) == 3):
                emit(check)
                raise AssertionError(f"greedy kernel-vs-plain check failed (kv {kv}): {stats}")
        check["free_running_small"] = free_running_check(kerns, args.seed)
    emit(check)

    # where a decode step's time goes: generate with 9 new tokens minus
    # generate with 1 (prefill and the first sample) leaves 8 decode steps
    with torch.inference_mode():
        windows = {n: profile_window(lambda: generate(
            params, cfg, torch.Generator(), ids, mask, SamplingParams(max_new_tokens=n),
            attn_impl="pallas", decode_params=qparams, decode_attn_impl="pallas",
            kv_quant="int8", device="cuda")) for n in (1, 9)}
    steps = {k: (windows[9][k] - windows[1][k]) / 8 for k in ("wall_ms", "device_busy_ms")}
    emit({"phase": "profile", "what": "generate(kv_quant='int8'), 1 and 9 new tokens",
          "decode_step_wall_ms": steps["wall_ms"],
          "decode_step_device_busy_ms": steps["device_busy_ms"],
          "decode_step_device_idle_share": 1 - steps["device_busy_ms"] / steps["wall_ms"],
          "windows": windows})

    del qleaves
    torch.cuda.empty_cache()

    # 8. K10 and K9 against their plain versions at the new paths' shapes
    with torch.inference_mode():
        new_results, mega = check_new_kernels(cfg, qparams, peaks, args.seed)
    emit({"phase": "engine_kernels", "gpu": gpu, "results": new_results})
    torch.cuda.empty_cache()

    # 9. generate(mega=): phase 3's prompts, the whole decode step in one launch,
    # on decode weights whose lm head is packed once (as the engines make them)
    with torch.inference_mode():
        mqparams = with_packed_lm_head(qparams)

        def mega_generate(sampling, seed=args.seed + 1):
            return generate(params, cfg, torch.Generator().manual_seed(seed), ids, mask, sampling,
                            attn_impl="pallas", decode_params=mqparams, kv_quant="int8",
                            mega=mega, device="cuda")
        out, secs, counts = run_counted(kerns, lambda: mega_generate(sp))
        check_output(out.response_ids.cpu(), out.response_logprobs.cpu(), out.response_mask.cpu(),
                     B, N, cfg.vocab_size)
        want = {**dict.fromkeys(kerns, 0), "flash_attention_fwd": L, "decode_megakernel": N - 1,
                "fused_lmhead_sample": N}
        if counts != want:
            raise AssertionError(f"generate(mega=) launch counts {counts}, expected {want}")
        for k, c in counts.items():
            launches[k] += c
        windows = {n: profile_window(lambda: mega_generate(SamplingParams(max_new_tokens=n)))
                   for n in (1, 9)}
    mega_step = {k: (windows[9][k] - windows[1][k]) / 8 for k in ("wall_ms", "device_busy_ms")}
    emit({"phase": "megakernel_generate", "gpu": gpu, "model": "qwen2_1_5b", "layers": L,
          "batch": B, "new_tokens": N, "cache_len": -(-(P + N) // 128) * 128, "seconds": secs,
          "generated_tokens_per_s": B * N / secs,
          "decode_ms_per_step": (secs * 1e3 - prefill_ms) / (N - 1),
          "per_layer_int8_kv": main["generate_int8_kv"], "launches": counts,
          "decode_step_wall_ms": mega_step["wall_ms"],
          "decode_step_device_busy_ms": mega_step["device_busy_ms"],
          "decode_step_device_idle_share": 1 - mega_step["device_busy_ms"] / mega_step["wall_ms"],
          "by_kernel_ms_9_tokens": windows[9]["by_kernel_ms"]})
    del out

    # 10. shadow mode for K9 and K10 at full size: every kernel call of a
    # 16-token greedy run against its plain version on the same inputs
    from rlinf_tpu_torch.rollout.paged_engine import PagedContinuousEngine
    shadow = {"phase": "engine_shadow", "new_tokens": 16}
    with torch.inference_mode():
        stats = {}
        with kernels_replaced(shadowed(stats), _engine_sites()):
            mega_generate(greedy, 0)
            PagedContinuousEngine(cfg, greedy, num_slots=B, max_seq_len=P + 16, prompt_bucket=bucket,
                                  decode_chunk=15, page_size=16, attn_impl="pallas", device="cuda"
                                  ).rollout(params, request, torch.Generator())
    shadow["shadow"] = stats
    emit(shadow)
    if not (stats["decode_megakernel"]["calls"] == 15
            and stats["decode_megakernel"]["max_rel_err"] < 5e-2
            and stats["paged_attention"]["calls"] == L * 15
            and stats["paged_attention"]["max_abs_err"] < 1e-2):
        raise AssertionError(f"K9/K10 shadow check failed: {stats}")
    del qparams, mqparams, mega
    torch.cuda.empty_cache()

    # 10b. generate(mega=) at Qwen2-7B's widths, every K9 call shadowed
    with torch.inference_mode():
        emit({"phase": "engine_shadow_qwen2_7b", **mega_generate_qwen2_7b(args.seed)})
    torch.cuda.empty_cache()

    # 11. the continuous engine (per-layer and hybrid) and the paged engine
    engine_counts = engine_phases(cfg, params, kerns, gpu, args.seed)
    for k, c in engine_counts.items():
        launches[k] += c
    torch.cuda.empty_cache()

    # 12. whole greedy runs at small size, kernels against plain paths
    with torch.inference_mode():
        emit({"phase": "engine_small_checks", **small_engine_checks(kerns, args.seed)})

    # 5. the training kernels against their plain versions, at one row
    # chunk and one microbatch of the training batch
    from rlinf_tpu_torch.data.io_struct import build_train_batch

    train_mask = build_train_batch(res, np.zeros(res.response_ids.shape, np.float32),
                                   pad_id=0).attention_mask[:16]
    train_results, k1_train = check_training_kernels(cfg, train_mask, peaks, args.seed)
    results[0]["train_microbatch"] = k1_train
    results += train_results
    emit({"phase": "training_kernels", "gpu": gpu, "k1_train_microbatch": k1_train,
          "results": train_results})
    torch.cuda.empty_cache()

    # 5b. K4 and K6 against their plain versions at ragged shapes
    with torch.inference_mode():
        emit({"phase": "ragged_shapes", **ragged_shapes(args.seed)})
    torch.cuda.empty_cache()

    # 5c. where the kernels overtake the plain attention path
    emit({"phase": "attn_impl_threshold", "gpu": gpu, **attn_impl_crossover(cfg, args.seed)})
    torch.cuda.empty_cache()

    # 6. the training path on the rollout, then one more step under the profiler
    state, batch, step_fn, train_counts = training_path(cfg, params, res, kerns, gpu, args.seed)
    emit(profile_train_step(state, batch, step_fn))
    adamw_state_bytes = tree_bytes(state.opt_state)
    del state, step_fn
    torch.cuda.empty_cache()
    for k, c in train_counts.items():
        launches[k] += c

    # 7. a whole train step, kernels against plain, at a small configuration
    emit({"phase": "whole_step_check", **whole_step_check(kerns, args.seed)})
    gc.collect()
    torch.cuda.empty_cache()

    # 13. the reasoning runner: whole GRPO steps through main_grpo
    runner_counts, runner_figs = runner_phase(kerns, gpu, peaks, args.seed)
    for k, c in runner_counts.items():
        launches[k] += c
    for r in results:
        if r["name"] in runner_figs:
            r["runner_qwen2_0_5b"] = runner_figs[r["name"]]

    # 14-16. server mode (on the main path's weights), online coding RL,
    # the agent loop and the eval
    server_counts = server_phase(kerns, gpu, args.seed, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    for counts in (server_counts, coding_online_phase(kerns, gpu, args.seed),
                   agent_phase(kerns, gpu, args.seed)):
        for k, c in counts.items():
            launches[k] += c

    # 17. every kernel at head dims 16 and 32 and in f16 and f32 (grad mode
    # on: the library call of K7/K8 is SDPA's autograd backward)
    variants = variant_checks(peaks, args.seed)
    emit({"phase": "dtypes_and_head_dims", "gpu": gpu, **variants})
    torch.cuda.empty_cache()

    # 18-19. the small models' default runs, and PPO with a learned critic
    for counts in (small_defaults_phase(kerns, gpu), critic_phase(kerns, gpu, args.seed)):
        for k, c in counts.items():
            launches[k] += c

    # 20-22. adafactor under remat=True and "dots" on the training phase's
    # batch, LoRA through main_grpo, SFT through main_sft
    for counts in (adafactor_remat_phase(kerns, gpu, batch, adamw_state_bytes, args.seed),
                   lora_phase(kerns, gpu, args.seed), sft_phase(kerns, gpu, args.seed)):
        for k, c in counts.items():
            launches[k] += c

    # 23-24. HF checkpoints through --model-path and --model, and the MoE
    # model family through main_grpo
    for counts in (hf_checkpoints_phase(kerns, gpu, args.seed),
                   moe_phase(kerns, gpu, peaks, args.seed)):
        for k, c in counts.items():
            launches[k] += c

    # 25. the agent recipes (Search-R1, rStar2, WideSeek-R1) and the
    # AgentLightning runner
    for k, c in agent_recipes_phase(kerns, gpu, args.seed).items():
        launches[k] += c
    gc.collect()
    torch.cuda.empty_cache()

    # 26. the mesh: ReasoningRunner(mesh=) and the disaggregated runner,
    # 4 processes on the card
    for k, c in mesh_drill_phase(kerns, gpu, args.seed).items():
        launches[k] += c

    # 27. the VLM reasoning stack through main_vlm_grpo (SFT, then GRPO)
    for k, c in vlm_phase(kerns, gpu, args.seed).items():
        launches[k] += c

    # 28. the embodied PPO stack: main_embodied_ppo, the CNN and OFT-style
    # VLA policies, and OpenVLA at full width
    for k, c in embodied_phase(kerns, gpu, args.seed).items():
        launches[k] += c

    results += new_results
    for r in results:
        r["launches"] = launches[r["name"]]
        r["variants"] = {tag: row[r["name"]] for tag, row in variants["timed"].items()
                         if r["name"] in row}
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(gpu, flush=True)
    print(json.dumps({"kernels": results}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
