"""Ring attention: causal attention with the sequence split over the
context mesh axis.

Port of ``rlinf_tpu/ops/ring_attention.py``. The JAX package runs its ring
inside ``shard_map`` with ``lax.ppermute``; here each rank holds its
contiguous chunk of the sequence (the JAX layout ``P(None, context)``:
rank i of the context group holds positions [i*S/cp, (i+1)*S/cp)) and the
K/V blocks go round the context group with ``collectives.ring_shift``, one
hop a step (rank i -> i+1), so that after step s a rank holds the block of
rank ``my - s``. Each block's partial attention is merged into the running
result with the online-softmax rule in f32, the local block first, then
the blocks as they arrive, as in JAX; the output is cast to ``q.dtype``.

Plain PyTorch, as the JAX ring is XLA einsums outside any Pallas kernel.
Masked scores take the finite ``NEG_INF`` of the JAX package, not -inf: a
block with no visible key gives p = 1 and m = NEG_INF, which the merge
weighs to 0 against any finite maximum, and a row with no valid key at all
(an all-padding row) ends as the mean of the values it visited, where -inf
would give NaN.

The positions and the key-valid mask of every block are gathered over the
context group once (ints and bools, no gradient); only K and V travel the
ring, in one tensor a hop. The backward of each hop is the hop the other
way (``ring_shift``'s autograd), so a key's gradient returns to the rank
that holds it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rlinf_tpu_torch.parallel import collectives as C

NEG_INF = -2.0**30


def _block_attention(q, k, v, pos_q, pos_kv, kv_valid, scale
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partial attention of the local q against one k/v block.

    q: [B, Sq, H, D]; k/v: [B, Sk, K, D]. Returns (numerator [B, Sq, H, D],
    running max m [B, Sq, H], running denominator l [B, Sq, H]) in f32."""
    B, Sq, H, D = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, D).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    mask = (pos_kv[:, None, :] <= pos_q[:, :, None]) & kv_valid[:, None, :]
    s = s.masked_fill(~mask[:, None, None], NEG_INF)
    m = s.amax(dim=-1)                                   # [B,K,G,Sq]
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    num = torch.einsum("bkgqs,bskd->bkgqd", p, v.float())
    num = num.reshape(B, K * G, Sq, D).transpose(1, 2)
    m = m.reshape(B, K * G, Sq).transpose(1, 2)
    l = l.reshape(B, K * G, Sq).transpose(1, 2)
    return num, m, l


def _merge(acc, new):
    """Online-softmax merge of two partial results."""
    num1, m1, l1 = acc
    num2, m2, l2 = new
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    return num1 * a1[..., None] + num2 * a2[..., None], m, l1 * a1 + l2 * a2


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group,
    positions: Optional[torch.Tensor] = None,
    kv_valid_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal GQA attention over the sequence split across ``group`` (the
    context group of the mesh), on this rank's chunk.

    q: [B, Sc, H, D]; k/v: [B, Sc, K, D]; positions / kv_valid_mask:
    [B, Sc], the rank's chunk of the row's absolute positions (default:
    the chunk's offsets in the whole sequence) and of its key-valid mask.
    Returns this rank's chunk of the output [B, Sc, H, D] in q.dtype."""
    B, Sc, H, D = q.shape
    cp = C.group_size(group)
    me = 0 if group is None else torch.distributed.get_rank(group)
    if scale is None:
        scale = D**-0.5
    if positions is None:
        positions = (me * Sc + torch.arange(Sc, device=q.device)).expand(B, Sc)
    if kv_valid_mask is None:
        kv_valid_mask = torch.ones((B, Sc), dtype=torch.bool, device=q.device)
    kv_valid_mask = kv_valid_mask.bool()
    # every block's positions and valid mask: [B, cp * Sc], block j at j*Sc
    all_pos = C.gather_tensor(positions.to(torch.int32).contiguous(), 1, group)
    all_valid = C.gather_tensor(kv_valid_mask.to(torch.int32), 1, group).bool()

    acc = _block_attention(q, k, v, positions, positions, kv_valid_mask, scale)
    kv = torch.cat([k, v], dim=2)
    Kh = k.shape[2]
    for step in range(1, cp):
        kv = C.ring_shift(kv, group)                  # now rank (me - step)'s block
        src = (me - step) % cp
        blk = slice(src * Sc, (src + 1) * Sc)
        new = _block_attention(q, kv[:, :, :Kh], kv[:, :, Kh:], positions,
                               all_pos[:, blk], all_valid[:, blk], scale)
        acc = _merge(acc, new)
    num, _, l = acc
    return (num / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)
