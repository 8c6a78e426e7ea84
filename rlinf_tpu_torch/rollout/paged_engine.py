"""Paged continuous-batching engine: page-pool KV + slot refill decode.

Port of ``rlinf_tpu/rollout/paged_engine.py``, the paged upgrade of
``continuous_engine.ContinuousBatchingEngine``: instead of a dense per-slot
cache, KV lives in global page pools [num_pages, Kv, P, Hd] per layer,
managed by the host-side ``PagePool``. Slot turnover is O(1) page-table
writes; the pools hold only ~sum(lengths) tokens of KV instead of B*S_max.

Decode attention goes to the paged-attention kernel K10
(``attn_impl="pallas"``, ops/cuda/paged_attention.py) or to its plain gather
version (``"xla"``). As in the JAX package, the prefill runs the model's
plain attention and the engine decodes on the unquantized params. Under
``rollout(mesh=)`` the pools hold this rank's kv heads and every layer is
the tensor-parallel one of the model's decode steps (the base engine's
docstring says how the pool runs under a mesh).

Chunk-ahead allocation: before each K-step decode chunk the host allocates
K token positions for every occupied slot (pages as needed). Slots that
finish mid-chunk are freed wholesale at harvest, so no rollback is needed:
over-allocated pages return to the pool with the slot.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from rlinf_tpu_torch.data.io_struct import RolloutRequest, RolloutResult
from rlinf_tpu_torch.models.llm import model as M
from rlinf_tpu_torch.models.llm.config import LLMConfig
from rlinf_tpu_torch.models.llm.sampler import SamplingParams, sample_from_logits
from rlinf_tpu_torch.ops.cuda.geometry import check_kernel_geometry
from rlinf_tpu_torch.ops.cuda.paged_attention import paged_attention, paged_attention_xla
from rlinf_tpu_torch.ops.norm import rms_norm
from rlinf_tpu_torch.ops.rope import apply_rope, rope_frequencies
from rlinf_tpu_torch.parallel import collectives as C
from rlinf_tpu_torch.parallel.mesh import AxisNames as Ax, current_mesh
from rlinf_tpu_torch.rollout.continuous_engine import ContinuousBatchingEngine, _Slot
from rlinf_tpu_torch.rollout.paged_cache import PagePool, paged_cache_write


class PagedContinuousEngine(ContinuousBatchingEngine):
    """Same host scheduling loop and results contract as the dense engine;
    only the KV representation and the prefill/decode differ."""

    def __init__(
        self,
        cfg: LLMConfig,
        sampling: SamplingParams,
        *,
        num_slots: int = 32,
        max_seq_len: Optional[int] = None,
        prompt_bucket: int = 64,
        decode_chunk: int = 16,
        page_size: int = 16,
        num_pages: Optional[int] = None,
        attn_impl: str = "xla",
        device="cuda",
    ):
        assert prompt_bucket % page_size == 0
        super().__init__(
            cfg, sampling, num_slots=num_slots, max_seq_len=max_seq_len,
            prompt_bucket=prompt_bucket, decode_chunk=decode_chunk, device=device,
        )
        self.page_size = page_size
        self.max_pages_per_slot = -(-self.max_seq_len // page_size)
        self.num_pages = num_pages or (1 + num_slots * self.max_pages_per_slot)
        #: the DECODE attention: "pallas" = kernel K10, "xla" = its plain version
        self.attn_impl = attn_impl
        self._check_kernel_paths()

    def _check_kernel_paths(self):
        """On the card, refuse a model or page size that K10 does not take
        (the prefill runs plain attention). The base constructor's call
        comes before the decode attention is set and checks nothing."""
        if self.device.type == "cuda" and self.attn_impl == "pallas":
            check_kernel_geometry(self.cfg, "paged", page_size=self.page_size)

    # -- state ---------------------------------------------------------------
    def _init_pools(self):
        c = M.local_config(self.cfg, current_mesh())
        shape = (self.num_pages, c.num_kv_heads, self.page_size, c.head_dim_)
        make = lambda: tuple(
            torch.zeros(shape, dtype=c.compute_dtype, device=self.device)
            for _ in range(c.num_layers))
        return make(), make()

    # -- device internals ------------------------------------------------------
    def _prefill_paged_impl(self, params, k_layers, v_layers, prompt_ids, prompt_mask, page_ids):
        """BATCHED prefill [R, Pb] (Pb a multiple of page_size), scattering
        each row's KV into its ``page_ids`` row ([R, Pb/page_size]) of every
        layer's pool, in place. Returns the [R, V] fp32 logits of each row's
        last prompt token."""
        hidden, kv = M.forward_hidden(
            params, self.cfg, prompt_ids, attention_mask=prompt_mask, return_kv=True,
        )
        R, Pb = prompt_ids.shape
        n_pages = Pb // self.page_size
        lc = M.local_config(self.cfg, current_mesh())
        Kv, Hd = lc.num_kv_heads, lc.head_dim_
        for i in range(self.cfg.num_layers):
            # kv.k[i]: [R, Pb, Kv, Hd] -> [R, n_pages, Kv, P, Hd]
            kk = kv.k[i].reshape(R, n_pages, self.page_size, Kv, Hd)
            vv = kv.v[i].reshape(R, n_pages, self.page_size, Kv, Hd)
            k_layers[i][page_ids] = kk.transpose(2, 3)
            v_layers[i][page_ids] = vv.transpose(2, 3)
        last = prompt_mask.to(torch.int32).sum(dim=1).long() - 1            # [R]
        last_h = hidden[torch.arange(R, device=hidden.device), last]
        w_lm = M.lm_head_weight(params, self.cfg)
        return (last_h @ w_lm).float()                                       # [R, V]

    def _attend(self, q, k_pool, v_pool, page_table, lengths):
        if self.attn_impl == "pallas":
            return paged_attention(q, k_pool, v_pool, page_table, lengths)
        return paged_attention_xla(q, k_pool, v_pool, page_table, lengths)

    def _decode_paged_impl(
        self, params, k_layers, v_layers, page_table, base_len,
        write_pages, write_offsets, done, cur_tokens, generator, pad_mask, n_steps,
    ):
        """K decode steps over the page pools (updated in place).

        page_table [B, max_pages] (post chunk-ahead allocation),
        base_len [B] real tokens before this chunk,
        write_pages/write_offsets [K, B] per-step write positions,
        pad_mask [B] True for UNOCCUPIED slots (excluded from length math).
        Returns (done, cur_tokens, toks, lps, was_done) on the device.
        """
        c = self.cfg
        mesh = current_mesh()
        lc = M.local_config(c, mesh)          # this rank's heads under a tensor axis
        tp = mesh.get_group(Ax.TENSOR) if mesh is not None else None
        sp = self.sampling
        B = cur_tokens.shape[0]
        cos, sin = rope_frequencies(c.head_dim_, c.max_seq_len, c.rope_theta, cur_tokens.device)
        w_lm = M.lm_head_weight(params, c)
        layers = M._layers(params["blocks"], c.num_layers)
        tok = cur_tokens
        toks, lps, was_done = [], [], []
        for k_idx in range(n_steps):
            pos = base_len + k_idx          # [B] rope position of this token
            lengths = torch.where(pad_mask, 0, pos + 1).to(torch.int32)
            x = M.embed_tokens(params, c, tok)[:, None, :]
            for i, layer in enumerate(layers):
                h = rms_norm(x, layer["attn_norm"], c.rms_eps)
                q, kk, vv = M._project_qkv(lc, layer, h, B, 1)
                q, kk = apply_rope(q, kk, cos, sin, pos[:, None])
                paged_cache_write(k_layers[i], v_layers[i], kk[:, 0], vv[:, 0],
                                  write_pages[k_idx], write_offsets[k_idx])
                attn = self._attend(q[:, 0], k_layers[i], v_layers[i], page_table, lengths)
                x = x + C.all_reduce(attn.reshape(B, 1, lc.q_dim) @ layer["wo"], tp)
                x, _ = M._mlp_or_moe(c, x, layer, tp)
            x = rms_norm(x, params["final_norm"], c.rms_eps)
            logits = (x[:, 0] @ w_lm).float()
            new_tok, lp = sample_from_logits(generator, logits, sp)
            new_done = done | (new_tok == sp.eos_token_id)
            new_tok = torch.where(done, sp.pad_token_id, new_tok).to(torch.int32)
            lp = torch.where(done, 0.0, lp)
            toks.append(new_tok)
            lps.append(lp)
            was_done.append(done)
            done, tok = new_done, new_tok
        return done, tok, torch.stack(toks), torch.stack(lps), torch.stack(was_done)

    # -- host engine loop ------------------------------------------------------
    @torch.inference_mode()
    def generate(self, params, request: RolloutRequest, generator: torch.Generator
                 ) -> RolloutResult:
        if params["embed"].device.type != self.device.type:
            raise ValueError(
                f"params live on {params['embed'].device}, the engine runs on {self.device}")
        dev = self.device
        n_req = len(request.prompt_ids)
        sp = self.sampling
        pending = list(range(n_req))
        results_tokens: List[List[int]] = [[] for _ in range(n_req)]
        results_lps: List[List[float]] = [[] for _ in range(n_req)]
        slots = [_Slot() for _ in range(self.num_slots)]
        pool = PagePool(self.num_pages, self.page_size, self.num_slots,
                        self.max_pages_per_slot)
        k_layers, v_layers = self._init_pools()
        done_np = np.ones((self.num_slots,), bool)
        cur_tok_np = np.zeros((self.num_slots,), np.int32)

        def bucket(n):
            b = self.prompt_bucket
            return ((n + b - 1) // b) * b

        active = 0
        while pending or active > 0:
            # 1. refill free slots: admit prompts (page backpressure), then
            # prefill in BATCHED groups by bucketed length (power-of-two
            # group sizes, like the dense engine)
            admitted = []        # (slot, req, ids, Pb, budget)
            free_slots = [s for s in range(self.num_slots) if slots[s].request_idx < 0]
            for s in free_slots:
                if not pending:
                    break
                req = pending[0]
                budget = request.budget_for(req, sp.max_new_tokens)
                ids = request.prompt_ids[req][-(self.max_seq_len - budget):]
                Pb = bucket(len(ids))
                if not pool.can_alloc(Pb):
                    break  # backpressure: wait for slots to free pages
                pending.pop(0)
                pool.alloc_slot(s, Pb)          # claim the padded region
                pool.lengths[s] = len(ids)      # but only real tokens count
                admitted.append((s, req, ids, Pb, budget))

            by_pb = {}
            for entry in admitted:
                by_pb.setdefault(entry[3], []).append(entry)
            for Pb, entries in by_pb.items():
                while entries:
                    r = 1
                    while r * 2 <= len(entries):
                        r *= 2
                    group, entries = entries[:r], entries[r:]
                    n_pg = Pb // self.page_size
                    prompt = np.zeros((r, Pb), np.int32)
                    mask = np.zeros((r, Pb), bool)
                    page_ids = np.zeros((r, n_pg), np.int64)
                    for j, (s, req, ids, _, _) in enumerate(group):
                        prompt[j, : len(ids)] = ids
                        mask[j, : len(ids)] = True
                        page_ids[j] = pool.page_table[s, :n_pg]
                    logits = self._prefill_paged_impl(
                        params, k_layers, v_layers,
                        torch.as_tensor(prompt, device=dev), torch.as_tensor(mask, device=dev),
                        torch.as_tensor(page_ids, device=dev),
                    )
                    tok, lp = sample_from_logits(generator, logits, sp)
                    tok_np = tok.cpu().numpy()
                    lp_np = lp.cpu().numpy()
                    for j, (s, req, ids, _, budget) in enumerate(group):
                        tok_i, lp_i = int(tok_np[j]), float(lp_np[j])
                        slots[s] = _Slot(
                            request_idx=req, prompt_len=len(ids), budget=budget,
                            tokens=[tok_i], logprobs=[lp_i],
                        )
                        done_np[s] = tok_i == sp.eos_token_id or budget <= 1
                        cur_tok_np[s] = tok_i
                        active += 1

            if active == 0:
                break

            # 2. chunk-ahead page allocation for K steps
            K = self.decode_chunk
            base_len = pool.lengths.copy()
            pad_mask = np.array([sl.request_idx < 0 for sl in slots])
            write_pages, write_offsets = pool.append_tokens_chunk(~pad_mask, K)
            page_table_snapshot = pool.page_table.copy()

            # 3. K-step decode, one host sync for the chunk
            done_t, cur_t, toks, lps, was_done = self._decode_paged_impl(
                params, k_layers, v_layers,
                torch.as_tensor(page_table_snapshot, device=dev),
                torch.as_tensor(base_len, device=dev),
                torch.as_tensor(write_pages, device=dev),
                torch.as_tensor(write_offsets, device=dev),
                torch.as_tensor(done_np, device=dev), torch.as_tensor(cur_tok_np, device=dev),
                generator, torch.as_tensor(pad_mask, device=dev), K,
            )
            toks_np = toks.cpu().numpy()
            lps_np = lps.cpu().numpy()
            was_done_np = was_done.cpu().numpy()
            done_np = done_t.cpu().numpy().copy()
            cur_tok_np = cur_t.cpu().numpy().copy()
            any_done = was_done_np.any(axis=0)
            first_done = np.where(any_done, np.argmax(was_done_np, axis=0), K)

            # 4. harvest (vectorized like the dense engine)
            for s in range(self.num_slots):
                sl = slots[s]
                if sl.request_idx < 0:
                    continue
                take = min(int(first_done[s]), sl.budget - len(sl.tokens))
                if take > 0:
                    sl.tokens.extend(toks_np[:take, s].tolist())
                    sl.logprobs.extend(lps_np[:take, s].tolist())
                finished = (
                    bool(done_np[s])
                    or len(sl.tokens) >= sl.budget
                    or sl.prompt_len + len(sl.tokens) >= self.max_seq_len
                )
                if finished:
                    tokens, lps_list = sl.tokens, sl.logprobs
                    if sp.eos_token_id in tokens:
                        cut = tokens.index(sp.eos_token_id) + 1
                        tokens, lps_list = tokens[:cut], lps_list[:cut]
                    results_tokens[sl.request_idx] = tokens[: sl.budget]
                    results_lps[sl.request_idx] = lps_list[: sl.budget]
                    slots[s] = _Slot()
                    pool.free_slot(s)
                    done_np[s] = True
                    active -= 1

        return self._pack_results(request, results_tokens, results_lps)
