"""Continuous-batching generation engine: slot refill + chunked decode.

Port of ``rlinf_tpu/rollout/continuous_engine.py``. The engine keeps a FIXED
pool of B slots:

  * each slot owns a PACKED cache row ([B, S_max, Kv*Hd] per layer, the
    serving layout of models/llm/model.decode_step_packed), bf16 or int8
    with one f32 scale per (slot, token);
  * finished slots are refilled from the pending-prompt queue by a BATCHED
    prefill (refill rounds are cut into power-of-two groups, longest prompts
    first, as in the JAX package, so both packages prefill the same shapes);
  * decode runs K steps per host round with per-slot ragged write positions
    and ONE host sync per round, optionally on int8 weight-only decode
    params (models/llm/quant.py);
  * sequences exceeding their budget or hitting EOS free their slot;
  * once the pending queue drains the pool is compacted to a power of two
    over the live slots.

``use_mega`` runs the decode step as ONE kernel launch over all layers
(ops/cuda/decode_megakernel.py, per-row write positions) on a stacked
[L, B, S, KD] int8 cache: True = always; "auto" = hybrid, per-layer kernels
while the pool is larger than ``mega_threshold`` and the megakernel once
compaction has shrunk it (the cache is relaid into the stacked arrays inside
the compaction gather). The default of ``mega_threshold`` is the JAX
package's, kept so that one configuration drives both packages; where the
two paths cross on this card is to be measured.

Where the JAX package jitted ``_refill_impl`` / ``_decode_impl`` with donated
buffers, these run eagerly and update the pool's tensors IN PLACE.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from rlinf_tpu_torch.data.io_struct import RolloutRequest, RolloutResult
from rlinf_tpu_torch.models.llm import model as M
from rlinf_tpu_torch.models.llm.config import LLMConfig
from rlinf_tpu_torch.models.llm.quant import quantize_params
from rlinf_tpu_torch.models.llm.sampler import (
    SamplingParams, _sample_hidden, sample_from_logits,
)
from rlinf_tpu_torch.ops.cuda.decode_megakernel import (
    decode_step_mega, make_plan, pack_decode_weights,
)
from rlinf_tpu_torch.ops.norm import rms_norm
from rlinf_tpu_torch.ops.rope import rope_frequencies
from rlinf_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class _Slot:
    request_idx: int = -1         # which request occupies this slot (-1 free)
    prompt_len: int = 0
    budget: int = 0               # max new tokens for this request
    tokens: List[int] = dataclasses.field(default_factory=list)
    logprobs: List[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Pool:
    """Device + host state for the slot pool."""

    kv_layers: tuple                 # per-layer tuples, or 4 stacked [L, B, ...] tensors
    lengths: torch.Tensor            # [B] int32 valid cache interval end
    done: torch.Tensor               # [B] bool
    cur_tokens: torch.Tensor         # [B] int32 next input token per slot
    slots: List[_Slot]

    @property
    def num_active(self) -> int:
        return sum(1 for s in self.slots if s.request_idx >= 0)

    @property
    def size(self) -> int:
        return len(self.slots)


@dataclasses.dataclass
class _Finished:
    request_idx: int
    tokens: List[int]
    logprobs: List[float]


class ContinuousBatchingEngine:
    def __init__(
        self,
        cfg: LLMConfig,
        sampling: SamplingParams,
        *,
        num_slots: int = 32,
        max_seq_len: Optional[int] = None,
        prompt_bucket: int = 64,
        decode_chunk: int = 16,
        weight_quant: str = "none",
        kv_quant: str = "none",
        decode_attn_impl: Optional[str] = None,
        attn_impl: str = "xla",
        compact: bool = True,
        use_mega=False,
        sampler_impl: Optional[str] = None,
        mega_chunk_width: Optional[int] = None,
        mega_threshold: int = 128,
        device="cuda",
    ):
        """``kv_quant='int8'``: the packed KV cache is stored int8 with one
        f32 scale per (slot, token), quantized on write, the scales folded
        into the attention kernel's score/prob rows. Behaviour logprobs come
        from the quantized policy; the runner's recompute-logprobs invariant
        keeps training unbiased."""
        self.cfg = cfg
        self.sampling = sampling
        self.num_slots = num_slots
        self.max_seq_len = max_seq_len or cfg.max_seq_len
        self.prompt_bucket = prompt_bucket
        self.decode_chunk = decode_chunk
        self.weight_quant = weight_quant
        self.kv_quant = kv_quant
        self.decode_attn_impl = decode_attn_impl
        self.attn_impl = attn_impl
        #: shrink the slot pool to a power-of-two over the live set once the
        #: pending queue drains (long-tail decode compaction)
        self.compact = compact
        self.use_mega = use_mega
        #: None = plain lm-head + sample; "fused" = the fused lm-head sampler
        #: kernel (never materializes [B, V] logits)
        self.sampler_impl = sampler_impl
        #: "auto" hybrid switch point: pools of this size or smaller decode
        #: through the megakernel
        self.mega_threshold = mega_threshold
        self.device = resolve_device(device)
        if not (use_mega is False or use_mega is True or use_mega == "auto"):
            raise ValueError(f"use_mega must be False, True or 'auto', got {use_mega!r}")
        if sampler_impl == "fused" and weight_quant != "int8":
            raise ValueError("sampler_impl='fused' needs weight_quant='int8' "
                             "(the fused sampler reads an int8 lm_head)")
        if use_mega:
            if weight_quant != "int8" or kv_quant != "int8":
                raise ValueError(
                    "use_mega needs weight_quant='int8' and kv_quant='int8'")
            if num_slots % 8:
                raise ValueError("use_mega needs num_slots % 8 == 0")
            if self.max_seq_len % 128:
                raise ValueError("use_mega needs max_seq_len % 128 == 0")
            cw = mega_chunk_width or max(2048, cfg.hidden_size)
            self._plan = make_plan(cfg, cw)
            self._mega_cw = cw
        #: packed megakernel weights of the current decode params, made at the
        #: first decode round on a stacked cache
        self._mega_mw = None

    # -- device internals --------------------------------------------------
    def _refill_impl(self, params, pool: _Pool, slot_ids, prompt_ids, prompt_mask, generator):
        """Prefill R prompts (right-padded [R, P], occupying cache [0, plen))
        into rows ``slot_ids`` of the packed cache; sample each row's first
        token. Junk KV in [plen, P) never enters a valid interval: decode
        overwrites position ``lengths`` before extending the interval."""
        R, P = prompt_ids.shape
        hidden, kv = M.forward_hidden(
            params, self.cfg, prompt_ids, attention_mask=prompt_mask,
            return_kv=True, attn_impl=self.attn_impl,
        )
        kd = self.cfg.kv_dim
        kv_layers = pool.kv_layers
        if self.use_mega and self._is_stacked(kv_layers):
            kc, vc, ksc, vsc = kv_layers
            for i in range(self.cfg.num_layers):
                kq, ks = M.quantize_packed_kv(kv.k[i].reshape(R, P, kd))
                vq, vs = M.quantize_packed_kv(kv.v[i].reshape(R, P, kd))
                kc[i, slot_ids, :P] = kq
                vc[i, slot_ids, :P] = vq
                ksc[i, slot_ids, :P] = ks
                vsc[i, slot_ids, :P] = vs
        elif self.kv_quant == "int8":
            for i, (kc, vc, ksc, vsc) in enumerate(kv_layers):
                kq, ks = M.quantize_packed_kv(kv.k[i].reshape(R, P, kd))
                vq, vs = M.quantize_packed_kv(kv.v[i].reshape(R, P, kd))
                kc[slot_ids, :P] = kq
                vc[slot_ids, :P] = vq
                ksc[slot_ids, :P] = ks
                vsc[slot_ids, :P] = vs
        else:
            for i, (kc, vc) in enumerate(kv_layers):
                kc[slot_ids, :P] = kv.k[i].reshape(R, P, kd).to(kc.dtype)
                vc[slot_ids, :P] = kv.v[i].reshape(R, P, kd).to(vc.dtype)

        plens = prompt_mask.to(torch.int32).sum(dim=-1, dtype=torch.int32)   # [R]
        last = (plens - 1).clamp_min(0).long()
        last_hidden = hidden[torch.arange(R, device=hidden.device), last]    # [R, D]
        logits = M.lm_head_logits(params, self.cfg, last_hidden)
        tok, lp = sample_from_logits(generator, logits, self.sampling)

        pool.lengths[slot_ids] = plens
        pool.done[slot_ids] = tok == self.sampling.eos_token_id
        pool.cur_tokens[slot_ids] = tok
        return tok, lp

    def _decode_impl(self, dparams, pool: _Pool, generator, n_steps: int):
        """K decode steps for all slots on the packed cache. Free slots
        (done=True, lengths=0) decode junk that the host never harvests.
        Returns (toks, lps, was_done), each [K, B], still on the device."""
        sp = self.sampling
        kv_layers, lengths, done, tok = pool.kv_layers, pool.lengths, pool.done, pool.cur_tokens
        B = lengths.shape[0]          # pool may be compacted below num_slots
        S = self.max_seq_len
        dev = lengths.device
        starts = torch.zeros((B,), dtype=torch.int32, device=dev)
        mega_now = bool(self.use_mega) and self._is_stacked(kv_layers)
        if mega_now:
            if self._mega_mw is None:
                self._mega_mw = pack_decode_weights(dparams, self.cfg, self._mega_cw)[1]
            cos_tab, sin_tab = rope_frequencies(
                self.cfg.head_dim_, self.cfg.max_seq_len, self.cfg.rope_theta, dev)
        step_fn = (
            M.decode_step_packed_q8 if self.kv_quant == "int8" else M.decode_step_packed
        )
        use_fused = self.sampler_impl == "fused"

        toks, lps, was_done = [], [], []
        for _ in range(n_steps):
            write_pos = lengths.clamp(max=S - 1)
            if mega_now:
                x0 = dparams["embed"][tok.long()].to(self.cfg.compute_dtype)
                hidden, *kv_layers = decode_step_mega(
                    self._plan, self._mega_mw, x0, *kv_layers, write_pos, write_pos,
                    starts, cos_tab, sin_tab)
                hidden = rms_norm(hidden, dparams["final_norm"], self.cfg.rms_eps)
                kv_layers = tuple(kv_layers)
            else:
                hidden, kv_layers = step_fn(
                    dparams, self.cfg, tok, kv_layers, write_pos,
                    positions=write_pos, starts=starts, lengths=write_pos + 1,
                    attn_impl=self.decode_attn_impl,
                )
            if use_fused:
                new_tok, lp = _sample_hidden(dparams, self.cfg, generator, hidden, sp, True)
            else:
                logits = M.lm_head_logits(dparams, self.cfg, hidden)
                new_tok, lp = sample_from_logits(generator, logits, sp)
            new_done = done | (new_tok == sp.eos_token_id)
            new_tok = torch.where(done, sp.pad_token_id, new_tok).to(torch.int32)
            lp = torch.where(done, 0.0, lp)
            lengths = torch.where(done, lengths, (lengths + 1).clamp(max=S))
            toks.append(new_tok)
            lps.append(lp)
            was_done.append(done)
            done, tok = new_done, new_tok
        pool.kv_layers, pool.lengths, pool.done, pool.cur_tokens = kv_layers, lengths, done, tok
        return torch.stack(toks), torch.stack(lps), torch.stack(was_done)

    # -- pool core ---------------------------------------------------------
    @staticmethod
    def _is_stacked(kv_layers) -> bool:
        """Stacked [L, B, S, KD] megakernel layout vs per-layer tuples."""
        return torch.is_tensor(kv_layers[0])

    def init_pool(self) -> _Pool:
        dev = self.device
        mega_now = self.use_mega is True or (
            self.use_mega == "auto" and self.num_slots <= self.mega_threshold
        )
        if mega_now:
            L = self.cfg.num_layers
            shape = (L, self.num_slots, self.max_seq_len, self.cfg.kv_dim)
            cache = (
                torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.ones(shape[:3], dtype=torch.float32, device=dev),
                torch.ones(shape[:3], dtype=torch.float32, device=dev),
            )
        else:
            init_cache = (
                M.init_kv_cache_packed_q8 if self.kv_quant == "int8"
                else M.init_kv_cache_packed
            )
            cache = init_cache(self.cfg, self.num_slots, self.max_seq_len, device=dev)
        return _Pool(
            kv_layers=cache,
            lengths=torch.zeros((self.num_slots,), dtype=torch.int32, device=dev),
            done=torch.ones((self.num_slots,), dtype=torch.bool, device=dev),     # all free
            cur_tokens=torch.zeros((self.num_slots,), dtype=torch.int32, device=dev),
            slots=[_Slot() for _ in range(self.num_slots)],
        )

    def prepare_params(self, params):
        """Returns (prefill_params, decode_params): identical unless int8
        weight-only decode quantization is enabled. Fresh learner params are
        re-quantized per rollout; the megakernel's packed copy of them is
        made only when a decode round first runs on a stacked cache."""
        if params["embed"].device.type != self.device.type:
            raise ValueError(
                f"params live on {params['embed'].device}, the engine runs on {self.device}")
        self._mega_mw = None
        if self.weight_quant == "int8":
            return params, quantize_params(params)
        return params, params

    def trim_prompt(self, ids: Sequence[int], budget: int) -> List[int]:
        keep = self.max_seq_len - budget
        return list(ids)[-keep:] if keep > 0 else list(ids)[-1:]

    def refill(
        self,
        pool: _Pool,
        params,
        entries: List[Tuple[int, Sequence[int], int]],
        generator: torch.Generator,
    ) -> int:
        """Assign free slots to ``entries`` [(request_idx, prompt_ids,
        budget)]. Refills are grouped into power-of-two batches (longest
        prompts first). Returns the number of entries admitted (all of them,
        given enough free slots)."""
        free = [s for s in range(pool.size) if pool.slots[s].request_idx < 0]
        entries = entries[: len(free)]
        if not entries:
            return 0
        # longest-first keeps same-magnitude prompts in one bucket
        order = sorted(range(len(entries)), key=lambda i: -len(entries[i][1]))
        queue = [
            (free[k], entries[i][0], self.trim_prompt(entries[i][1], entries[i][2]),
             entries[i][2])
            for k, i in enumerate(order)
        ]
        admitted = len(queue)
        dev = self.device
        while queue:
            r = 1
            while r * 2 <= len(queue):
                r *= 2
            group, queue = queue[:r], queue[r:]
            P = max(len(ids) for _, _, ids, _ in group)
            P = ((P + self.prompt_bucket - 1) // self.prompt_bucket) * self.prompt_bucket
            # Short-cache configs: the bucketed prefill width must never
            # exceed the packed cache length (prompts are already trimmed).
            P = min(P, self.max_seq_len)
            prompt = np.zeros((r, P), np.int32)
            mask = np.zeros((r, P), bool)
            slot_ids = np.zeros((r,), np.int64)
            for j, (s, _, ids, _) in enumerate(group):
                prompt[j, : len(ids)] = ids
                mask[j, : len(ids)] = True
                slot_ids[j] = s
            tok, lp = self._refill_impl(
                params, pool, torch.as_tensor(slot_ids, device=dev),
                torch.as_tensor(prompt, device=dev), torch.as_tensor(mask, device=dev),
                generator,
            )
            tok_np = tok.cpu().numpy()
            lp_np = lp.cpu().numpy()
            for j, (s, req_idx, ids, budget) in enumerate(group):
                pool.slots[s] = _Slot(
                    request_idx=req_idx, prompt_len=len(ids), budget=budget,
                    tokens=[int(tok_np[j])], logprobs=[float(lp_np[j])],
                )
        return admitted

    def decode_and_harvest(
        self, pool: _Pool, decode_params, generator: torch.Generator
    ) -> List[_Finished]:
        """One K-step decode chunk + host-side harvest. Returns finished
        requests; their slots are freed for the next refill round."""
        sp = self.sampling
        K = self.decode_chunk
        toks, lps, was_done = self._decode_impl(decode_params, pool, generator, K)
        # one host sync for the whole chunk; per-slot appends are numpy slices
        toks_np = toks.cpu().numpy()             # [K, B]
        lps_np = lps.cpu().numpy()
        was_done_np = was_done.cpu().numpy()     # done BEFORE each step
        done_np = pool.done.cpu().numpy()
        any_done = was_done_np.any(axis=0)               # [B]
        first_done = np.where(any_done, np.argmax(was_done_np, axis=0), K)   # [B]

        finished: List[_Finished] = []
        free_mask = np.zeros((pool.size,), bool)
        for s in range(pool.size):
            sl = pool.slots[s]
            if sl.request_idx < 0:
                continue
            take = min(int(first_done[s]), sl.budget - len(sl.tokens))
            if take > 0:
                sl.tokens.extend(toks_np[:take, s].tolist())
                sl.logprobs.extend(lps_np[:take, s].tolist())
            if (
                bool(done_np[s])
                or len(sl.tokens) >= sl.budget
                or sl.prompt_len + len(sl.tokens) >= self.max_seq_len
            ):
                tokens, lp_list = sl.tokens, sl.logprobs
                if sp.eos_token_id in tokens:
                    cut = tokens.index(sp.eos_token_id) + 1
                    tokens, lp_list = tokens[:cut], lp_list[:cut]
                finished.append(_Finished(
                    sl.request_idx, tokens[: sl.budget], lp_list[: sl.budget]
                ))
                pool.slots[s] = _Slot()
                free_mask[s] = True
        if free_mask.any():
            # freed slots must stop decoding (their lengths would keep
            # growing into garbage): mark done, reset interval
            fm = torch.as_tensor(free_mask, device=pool.done.device)
            pool.done = pool.done | fm
            pool.lengths = torch.where(fm, 0, pool.lengths).to(torch.int32)
        return finished

    # -- batch rollout loop ------------------------------------------------
    def compact_pool(self, pool: _Pool) -> _Pool:
        """Shrink the pool to the next power-of-two that holds the live
        slots. A decode step's cost is dominated by flat per-step terms
        (weight stream, lm-head matmul + sampling over the whole slot axis),
        so a tail with few live slots in a large pool wastes most of every
        step. Live cache rows are gathered to the front (one row gather per
        cache array)."""
        live = [s for s in range(pool.size) if pool.slots[s].request_idx >= 0]
        n_live = max(len(live), 1)
        new_size = max(8, 1 << (n_live - 1).bit_length())
        if new_size >= pool.size:
            return pool
        dead = [s for s in range(pool.size)
                if pool.slots[s].request_idx < 0][: new_size - len(live)]
        perm = torch.as_tensor(live + dead, dtype=torch.long, device=pool.lengths.device)
        if self._is_stacked(pool.kv_layers):
            # stacked [L, B, ...] arrays: gather rows along the slot axis
            kv = tuple(arr[:, perm] for arr in pool.kv_layers)
        elif self.use_mega == "auto" and new_size <= self.mega_threshold:
            # hybrid switch point: relayout the per-layer q8 tuples into the
            # megakernel's stacked arrays inside the compaction gather (one
            # copy of the already-compacted cache)
            kv = tuple(
                torch.stack([layer[i][perm] for layer in pool.kv_layers])
                for i in range(4)
            )
        else:
            kv = tuple(
                tuple(arr[perm] for arr in layer) for layer in pool.kv_layers
            )
        return _Pool(
            kv_layers=kv,
            lengths=pool.lengths[perm],
            done=pool.done[perm],
            cur_tokens=pool.cur_tokens[perm],
            slots=[pool.slots[int(s)] for s in (live + dead)],
        )

    @torch.inference_mode()
    def generate(
        self, params, request: RolloutRequest, generator: torch.Generator
    ) -> RolloutResult:
        n_req = len(request.prompt_ids)
        sp = self.sampling
        pending = list(range(n_req))
        results_tokens: List[List[int]] = [[] for _ in range(n_req)]
        results_lps: List[List[float]] = [[] for _ in range(n_req)]
        pparams, dparams = self.prepare_params(params)
        pool = self.init_pool()

        n_done = 0
        while n_done < n_req:
            if pending:
                entries = [
                    (i, request.prompt_ids[i], request.budget_for(i, sp.max_new_tokens))
                    for i in pending[: pool.size]
                ]
                admitted = self.refill(pool, pparams, entries, generator)
                pending = pending[admitted:]
            if pool.num_active == 0:
                break
            for fin in self.decode_and_harvest(pool, dparams, generator):
                results_tokens[fin.request_idx] = fin.tokens
                results_lps[fin.request_idx] = fin.logprobs
                n_done += 1
            if (
                self.compact
                and not pending
                and pool.num_active
                and pool.num_active * 2 <= pool.size
                and pool.size > 8
            ):
                pool = self.compact_pool(pool)

        return self._pack_results(request, results_tokens, results_lps)

    def rollout(
        self, params, request: RolloutRequest, generator: torch.Generator, *, mesh=None
    ) -> RolloutResult:
        """Runner-facing API (matches rollout.engine.RolloutEngine.rollout).
        The slot pool is single-program."""
        if mesh is not None:
            raise NotImplementedError(
                "sharded rollout (mesh=...) comes with the port's parallel slice")
        return self.generate(params, request, generator)

    def _pack_results(self, request, results_tokens, results_lps) -> RolloutResult:
        n = len(request.prompt_ids)
        sp = self.sampling
        P = max(len(p) for p in request.prompt_ids)
        P = ((P + self.prompt_bucket - 1) // self.prompt_bucket) * self.prompt_bucket
        N = sp.max_new_tokens
        prompt_ids = np.full((n, P), sp.pad_token_id, np.int32)
        prompt_mask = np.zeros((n, P), bool)
        response_ids = np.full((n, N), sp.pad_token_id, np.int32)
        response_mask = np.zeros((n, N), bool)
        response_lps = np.zeros((n, N), np.float32)
        for i, p in enumerate(request.prompt_ids):
            prompt_ids[i, P - len(p):] = p  # left-padded (train-layout ready)
            prompt_mask[i, P - len(p):] = True
            toks = results_tokens[i]
            response_ids[i, : len(toks)] = toks
            response_mask[i, : len(toks)] = True
            response_lps[i, : len(toks)] = results_lps[i]
        return RolloutResult(
            prompt_ids=prompt_ids,
            prompt_mask=prompt_mask,
            response_ids=response_ids,
            response_mask=response_mask,
            response_logprobs=response_lps,
            answers=request.answers,
        )
