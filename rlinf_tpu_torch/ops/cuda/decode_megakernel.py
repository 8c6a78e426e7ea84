"""Kernel K9: one whole decode step over all layers in one launch, and its
plain version.

Port of ``rlinf_tpu/ops/pallas/decode_megakernel.py``. ``make_plan`` keeps
the JAX package's fields and asserts; ``pack_decode_weights`` turns the fused
int8 decode params (``quantize_params(fuse=True)``) into the port's own
stream: per layer ``wqkv | wo | gate_up | down``, each matrix ``[K, N]``
stored as tiles ``[N/64][K/64][4096]`` of 64 output columns by 64 depths,
laid out as the wgmma A fragments of a warpgroup (``_pack_matrix``), with
the gate and up projections interleaved by 64-column units (unit 2j is
gate columns 64j.., unit 2j + 1 the same up columns) so that one work item
of the kernel holds both halves of a SiLU product. The JAX package's
``[L*17, D, CW]`` chunk stream (zero-padded tiles, a transposed
down-projection, a phase->chunk table) is a Mosaic pipelining device and is
not kept.

``mega_schedule`` plans a launch on the host: the K-slices of each product
(``pick_slices``) and attention's split-KV; ``cta_tiles`` lists the weight
tiles one CTA multiplies, in the order its producer warp streams them.

``decode_step_mega`` computes what the TPU kernel computes (see
``csrc/decode_megakernel.cu``) and writes slot ``write_pos`` of the four
cache arrays IN PLACE, where the JAX function returned updated copies; the
same tensors are returned. ``decode_step_mega_plain`` is the same step in
tensor ops on the same packed weights.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import TYPE_CHECKING, NamedTuple, Optional, Tuple

import torch

from rlinf_tpu_torch.ops.cuda._build import (
    F, I, P, CudaKernel, check_cuda_tensor, sm_count, stream_handle,
)
from rlinf_tpu_torch.ops.cuda.decode_attention import NEG_INF
from rlinf_tpu_torch.ops.cuda.geometry import LIMITS, check_heads

if TYPE_CHECKING:  # models/llm imports this module (sampler.generate(mega=))
    from rlinf_tpu_torch.models.llm.config import LLMConfig

KERNEL = CudaKernel(
    "decode_megakernel.cu", "decode_megakernel",
    [I] + [P] * 25 + [I] * 16 + [F, F, P],
)

# constants of csrc/decode_megakernel.cu
UNIT = 64        # UNIT: output columns of a packed weight tile, the M of a wgmma
K_BLOCK = 64     # KBLK: depth of a packed weight tile and of a staged activation block
ROWS = 64        # ROWS: batch rows of a row block, the N of a wgmma
TILE_BYTES = UNIT * K_BLOCK
RING_TILES = 16  # RING: weight tiles of a CTA's shared-memory ring
KBS_MAX = 16     # KBS_MAX: most k-blocks of a K-slice (its staged activations)
CONSUMER_WARPS = 8  # NCW: the warps that multiply and run attention
KEY_BLOCK = 16   # KEYS: keys of an attention block
MIN_SPLIT_BLOCKS = 2  # fewest 16-key blocks of an attention split
MAX_SPLITS = 32  # most attention splits a row: one lane of the merging warp each
MAX_GROUP = LIMITS["decode_megakernel"][1]  # query heads per kv head (MAXG of the CUDA source)
#: the kernel's phases within a layer, in order, a grid-wide barrier after each
PHASES = ("qkv", "qkv_sum", "attention", "o_proj", "o_sum", "gate_up", "gate_up_sum", "down",
          "down_sum")


@dataclasses.dataclass(frozen=True)
class MegaPlan:
    """Static layout for one model geometry. The first fourteen fields are
    the JAX package's (``CW``, ``Hp`` and the chunk counts describe its TPU
    chunk stream and are kept so that one plan reads the same in both
    packages); the properties below them describe the port's stream."""

    D: int          # hidden == num_heads * head_dim
    QD: int
    KVD: int        # num_kv_heads * head_dim
    H: int
    Kv: int
    Hd: int
    Hp: int         # head count padded to a multiple of 8
    F: int
    L: int
    CW: int         # chunk width of the TPU stream
    eps: float
    n_qkv: int
    n_wo: int
    n_f: int

    @property
    def w_qkv(self) -> int:
        return self.QD + 2 * self.KVD

    @property
    def attn_p(self) -> int:
        return self.n_qkv

    @property
    def wo_p0(self) -> int:
        return self.n_qkv + 1

    @property
    def gate_p0(self) -> int:
        return self.wo_p0 + self.n_wo

    @property
    def up_p0(self) -> int:
        return self.gate_p0 + self.n_f

    @property
    def down_p0(self) -> int:
        return self.up_p0 + self.n_f

    @property
    def nph(self) -> int:
        return self.down_p0 + self.n_f

    @property
    def nchk(self) -> int:
        return self.nph - 1

    # -- the port's packed stream ----------------------------------------
    @property
    def matrices(self) -> Tuple[Tuple[str, int, int], ...]:
        """(name, K, N) of a layer's matrices in stream order; gate_up holds
        the gate and up projections interleaved by 64-column units."""
        return (("wqkv", self.D, self.w_qkv), ("wo", self.QD, self.D),
                ("gate_up", self.D, 2 * self.F), ("down", self.F, self.D))

    @property
    def layer_bytes(self) -> int:
        return sum(k * n for _, k, n in self.matrices)

    @property
    def scale_width(self) -> int:
        return sum(n for _, _, n in self.matrices)


def make_plan(cfg: LLMConfig, chunk_width: int = 2048) -> MegaPlan:
    D = cfg.hidden_size
    Hd = cfg.head_dim_
    QD = cfg.num_heads * Hd
    KVD = cfg.num_kv_heads * Hd
    if cfg.is_moe:
        raise ValueError("decode_megakernel is dense-MLP only: an MoE model decodes on the "
                         "per-layer kernels (use_mega=False)")
    assert QD == D, "megakernel requires num_heads*head_dim == hidden_size"
    assert not cfg.qk_norm, "megakernel does not support qk-norm models"
    assert chunk_width >= D, (
        f"megakernel chunk_width {chunk_width} must be >= hidden {D}")
    CW = chunk_width
    return MegaPlan(
        D=D, QD=QD, KVD=KVD, H=cfg.num_heads, Kv=cfg.num_kv_heads, Hd=Hd,
        Hp=-(-cfg.num_heads // 8) * 8, F=cfg.intermediate_size,
        L=cfg.num_layers,
        CW=CW, eps=cfg.rms_eps,
        n_qkv=math.ceil((QD + 2 * KVD) / CW),
        n_wo=math.ceil(D / CW),
        n_f=math.ceil(cfg.intermediate_size / CW),
    )


class MegaWeights(NamedTuple):
    stream: torch.Tensor    # [L, layer_bytes] int8, packed tiles
    scales: torch.Tensor    # [L, scale_width] f32 per-output-channel scales
    norms: torch.Tensor     # [L, 2, D] f32 (attn_norm, mlp_norm)
    bias: torch.Tensor      # [L, w_qkv] f32 qkv bias (zeros without one)


def _pack_matrix(q: torch.Tensor) -> torch.Tensor:
    """[L, K, N] int8 -> [L, K*N] as tiles [N/64][K/64][4096]. A tile is
    the wgmma A operand of 64 columns x 64 depths for the 128 threads of a
    warpgroup (K4's layout, csrc/sampler.cu): thread 32 w + 4 g + t finds,
    as word 2 j + r of its 32 bytes, the depths 16 j + 2 t + {0, 1, 8, 9} of
    column 16 w + g + 8 r; its bytes for k16 steps 0-1 lie at 16 * thread,
    those for steps 2-3 at 2048 + 16 * thread, so that every 16-byte
    shared-memory load of a warp is contiguous."""
    L, K, N = q.shape
    #             1        2  3  4  5  6  7        8  9  10
    t = q.reshape(L, K // K_BLOCK, 2, 2, 2, 4, 2, N // UNIT, 4, 2, 8)   # (kb, jh, jl, hi, t, e, m, w, r, g)
    return t.permute(0, 7, 1, 2, 8, 10, 5, 3, 9, 4, 6).reshape(L, K * N)


def _unpack_matrix(flat: torch.Tensor, K: int, N: int) -> torch.Tensor:
    """One layer's packed tiles [K*N] -> [K, N] (the inverse of _pack_matrix)."""
    t = flat.reshape(N // UNIT, K // K_BLOCK, 2, 4, 8, 4, 2, 2, 2, 2)   # (m, kb, jh, w, g, t, jl, r, hi, e)
    return t.permute(1, 2, 6, 8, 5, 9, 0, 3, 7, 4).reshape(K, N)


def _interleave_units(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """[..., F] gate and up -> [..., 2F]: unit 2j is gate columns 64j..64j+63,
    unit 2j + 1 the same up columns."""
    *lead, Fd = gate.shape
    g, u = gate.reshape(*lead, Fd // UNIT, 1, UNIT), up.reshape(*lead, Fd // UNIT, 1, UNIT)
    return torch.cat([g, u], dim=-2).reshape(*lead, 2 * Fd)


def _split_units(gu: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inverse of _interleave_units -> (gate, up)."""
    *lead, F2 = gu.shape
    t = gu.reshape(*lead, F2 // (2 * UNIT), 2, UNIT)
    return t[..., 0, :].reshape(*lead, F2 // 2), t[..., 1, :].reshape(*lead, F2 // 2)


def pack_decode_weights(qparams: dict, cfg: LLMConfig,
                        chunk_width: int = 2048) -> Tuple[MegaPlan, MegaWeights]:
    """Fused int8 decode params (quantize_params(fuse=True)) -> packed stream.

    Weights on the card are packed only for a model the kernel takes
    (``_check_geometry`` raises before anything is packed); on the CPU the
    plain version runs any geometry whose widths the packing takes."""
    plan = make_plan(cfg, chunk_width)
    b = qparams["blocks"]
    assert "wqkv" in b and "wgu" in b, (
        "megakernel needs fused decode weights (quantize_params fuse=True)")
    if b["wqkv"].q.device.type == "cuda":
        _check_geometry(plan)
    for name, k, n in plan.matrices:
        if k % K_BLOCK or n % UNIT:
            raise ValueError(
                f"megakernel packing needs the depth of {name} ({k}) to be a multiple "
                f"of {K_BLOCK} and its width ({n}) a multiple of {UNIT}")
    Fd, L = plan.F, plan.L
    wgu = b["wgu"]
    parts = (
        (b["wqkv"].q, b["wqkv"].scale), (b["wo"].q, b["wo"].scale),
        (_interleave_units(wgu.q[..., :Fd], wgu.q[..., Fd:]),
         _interleave_units(wgu.scale[..., :Fd], wgu.scale[..., Fd:])),
        (b["down"].q, b["down"].scale),
    )
    stream = torch.cat([_pack_matrix(q) for q, _ in parts], dim=1).contiguous()
    scales = torch.cat([s.reshape(L, -1).float() for _, s in parts], dim=1).contiguous()
    norms = torch.stack([b["attn_norm"].float(), b["mlp_norm"].float()], dim=1).contiguous()
    if "bq" in b:
        bias = torch.cat([b["bq"], b["bk"], b["bv"]], dim=-1).float().contiguous()
    else:
        bias = torch.zeros((L, plan.w_qkv), dtype=torch.float32, device=stream.device)
    return plan, MegaWeights(stream, scales, norms, bias)


def _check_geometry(plan: MegaPlan) -> None:
    """Raise for a model the kernel does not take. Its limits: the heads of
    ``geometry.LIMITS`` (head dims 16, 32, 64 and 128, at most MAX_GROUP query heads
    per kv head) and widths the 64 x 64 weight tiles cut (hidden,
    intermediate and qkv widths multiples of 64). The hidden size has no
    bound of its own: every product is K-sliced, and a slice of at most
    KBS_MAX k-blocks is staged at a time. Called where the kernel's path is
    built on the card (``pack_decode_weights``, the continuous engine with
    ``use_mega``, ``generate(mega=)``) and again at each launch."""
    check_heads("decode_megakernel", plan.H, plan.Kv, plan.Hd)
    bad = [f"{name} {n}" for name, n in (("hidden", plan.D), ("intermediate", plan.F),
                                        ("qkv width", plan.w_qkv)) if n % UNIT]
    if bad:
        raise ValueError(
            f"decode megakernel: {', '.join(bad)} not a multiple of its {UNIT}-column weight "
            "tiles")


# ---------------------------------------------------------------------------
# The launch schedule
# ---------------------------------------------------------------------------

class MegaSchedule(NamedTuple):
    """One launch's plan: the K-slices of the four products (in PRODUCTS
    order), attention's 16-key blocks a split and splits a row, the CTAs."""

    ks: Tuple[int, int, int, int]
    bps: int
    ns: int
    grid: int


#: the products of a layer in the kernel's order: (name, matrix of plan.matrices)
PRODUCTS = (("qkv", "wqkv"), ("o_proj", "wo"), ("gate_up", "gate_up"), ("down", "down"))


def product_shapes(plan: MegaPlan) -> Tuple[Tuple[int, int], ...]:
    """(k-blocks of the depth, 64-column units) of each product."""
    mats = {name: (k, n) for name, k, n in plan.matrices}
    return tuple((mats[m][0] // K_BLOCK, mats[m][1] // UNIT) for _, m in PRODUCTS)


def cta_slice(KB: int, KS: int, grid: int, cta: int) -> Tuple[int, int, int, int, int]:
    """(slice, rank, peers, first k-block, k-blocks) of CTA ``cta`` in a
    product of KB k-blocks cut into KS slices (csrc slice_of): slice
    cta % KS; its unit pairs rank, rank + peers, ..."""
    s, rank = cta % KS, cta // KS
    peers = (grid - s + KS - 1) // KS
    kb0 = s * KB // KS
    return s, rank, peers, kb0, (s + 1) * KB // KS - kb0


def pick_slices(KB: int, units: int, grid: int) -> int:
    """K-slices of a product of KB k-blocks and ``units`` 64-column units on
    ``grid`` CTAs: the count with the least estimated cost in bytes a CTA
    moves: the weights the busiest CTA streams, a CTA's share of the partial
    sums written and read back, and the activations (f32 x at most) the
    busiest CTA stages. Slices of more than KBS_MAX k-blocks do not fit the
    staging."""
    pairs = -(-units // 2)
    best, best_cost = 0, 0.0
    for ks in range(1, min(KB, grid) + 1):
        if -(-KB // ks) > KBS_MAX:
            continue
        busiest = 0
        for s in range(ks):
            _, _, peers, _, kbs = cta_slice(KB, ks, grid, s)
            busiest = max(busiest, -(-pairs // peers) * kbs)
        weights = busiest * min(2, units) * TILE_BYTES
        partials = 2 * ks * units * ROWS * UNIT * 4 / grid
        staged = -(-KB // ks) * K_BLOCK * ROWS * 4
        cost = weights + partials + staged
        if best == 0 or cost < best_cost:
            best, best_cost = ks, cost
    if best == 0:
        raise ValueError(f"decode megakernel: a depth of {KB} k-blocks does not fit "
                         f"{grid} slices of at most {KBS_MAX}")
    return best


@functools.lru_cache(maxsize=None)
def mega_schedule(plan: MegaPlan, B: int, S: int, grid: int) -> MegaSchedule:
    """The schedule of a launch at B rows, S cache slots on ``grid`` CTAs.
    Attention's splits: at most one item (row, kv head, split) for each
    consumer warp (a row's splits wait for each other, so all must be
    resident), at least MIN_SPLIT_BLOCKS blocks a split and at most
    MAX_SPLITS splits. Cached: a decode loop asks at every step."""
    ks = tuple(pick_slices(KB, units, grid) for KB, units in product_shapes(plan))
    max_blocks = -(-S // KEY_BLOCK)
    want = max(1, grid * CONSUMER_WARPS // max(B * plan.Kv, 1))
    bps = min(max_blocks, max(MIN_SPLIT_BLOCKS, -(-max_blocks // want),
                              -(-max_blocks // MAX_SPLITS)))
    return MegaSchedule(ks, bps, -(-max_blocks // bps), grid)


def cta_tiles(plan: MegaPlan, sched: MegaSchedule, B: int, cta: int):
    """The weight tiles CTA ``cta`` multiplies in one layer, in the order its
    producer warp streams them (csrc producer): (product, row block, unit,
    k-block), a unit pair's two units alternating at every k-block."""
    out = []
    for p, (KB, units) in enumerate(product_shapes(plan)):
        _, rank, peers, kb0, kbs = cta_slice(KB, sched.ks[p], sched.grid, cta)
        for rb in range(-(-B // ROWS)):
            for pair in range(rank, -(-units // 2), peers):
                for kb in range(kbs):
                    for u in range(2 * pair, min(2 * pair + 2, units)):
                        out.append((p, rb, u, kb0 + kb))
    return out


def workspace_floats(plan: MegaPlan, sched: MegaSchedule, B: int) -> Tuple[int, int, int]:
    """Sizes of a launch's scratch: the products' partial sums (f32), the
    attention splits' states (f32: o, m, l, two unused) and the sync words
    (the grid barrier, then a count for each (row, kv head))."""
    nrb = -(-B // ROWS)
    shapes = product_shapes(plan)
    part = nrb * max(ks * units for ks, (_, units) in zip(sched.ks, shapes)) * UNIT * ROWS
    apart = B * plan.H * sched.ns * (plan.Hd + 4)
    return part, apart, 1 + B * plan.Kv


def _row_slots(write_pos, B: int, device) -> torch.Tensor:
    """``write_pos`` (int, 0-d tensor or [B]) as a [B] int32 tensor."""
    if torch.is_tensor(write_pos) and write_pos.ndim == 1:
        return write_pos.to(device=device, dtype=torch.int32)
    return torch.full((B,), int(write_pos), dtype=torch.int32, device=device)


def _rope_packed(x: torch.Tensor, cos_p: torch.Tensor, sin_p: torch.Tensor, hd: int) -> torch.Tensor:
    """rope per head band of a packed [B, n*hd] f32 row: x*cos + rot_half(x)*sin."""
    B = x.shape[0]
    xh = x.reshape(B, -1, hd)
    x1, x2 = xh.chunk(2, dim=-1)
    rot = torch.cat([-x2, x1], dim=-1)
    return (xh * cos_p[:, None, :] + rot * sin_p[:, None, :]).reshape(B, -1)


def _quantize_row(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    s = (x.abs().amax(dim=1, keepdim=True) / 127.0).clamp_min(1e-8)
    return torch.round(x / s).clamp(-127, 127).to(torch.int8), s[:, 0]


def decode_step_mega_plain(
    plan: MegaPlan, mw: MegaWeights, x0, kc, vc, ks, vs, write_pos, positions, starts,
    cos_tab, sin_tab,
):
    """Plain version of K9 on the packed weights: the same bf16 roundings,
    f32 residual stream and f32 accumulation, written with tensor ops. The
    cache arrays are updated in place and returned."""
    Pn = plan
    B, S = x0.shape[0], kc.shape[2]
    dev = x0.device
    G = Pn.H // Pn.Kv
    scale = Pn.Hd ** -0.5
    bf = torch.bfloat16
    wps = _row_slots(write_pos, B, dev).long()
    slot = wps.clamp(0, S - 1)
    rows = torch.arange(B, device=dev)
    cos_p, sin_p = cos_tab[positions.long()].float(), sin_tab[positions.long()].float()
    pos = torch.arange(S, device=dev)[None, :]
    valid = (pos >= starts.long()[:, None]) & (pos < wps[:, None])        # [B, S]

    def rms(x, w):
        var = x.square().mean(dim=1, keepdim=True)
        return (x * torch.rsqrt(var + Pn.eps)) * w[None, :]

    x = x0.to(bf).float()
    for l in range(Pn.L):
        mats, scs, off_w, off_s = {}, {}, 0, 0
        for name, k, n in Pn.matrices:
            mats[name] = _unpack_matrix(mw.stream[l, off_w:off_w + k * n], k, n).float()
            scs[name] = mw.scales[l, off_s:off_s + n]
            off_w += k * n
            off_s += n
        hn = rms(x, mw.norms[l, 0]).to(bf).float()
        qkv = (hn @ mats["wqkv"]) * scs["wqkv"] + mw.bias[l]
        q, k, v = qkv[:, :Pn.QD], qkv[:, Pn.QD:Pn.QD + Pn.KVD], qkv[:, Pn.QD + Pn.KVD:]
        q = _rope_packed(q, cos_p, sin_p, Pn.Hd)
        k = _rope_packed(k, cos_p, sin_p, Pn.Hd)
        kq, ksv = _quantize_row(k)
        vq, vsv = _quantize_row(v)

        qg = q.reshape(B, Pn.Kv, G, Pn.Hd)
        kh, vh = k.reshape(B, Pn.Kv, Pn.Hd), v.reshape(B, Pn.Kv, Pn.Hd)
        s_cur = torch.einsum("bkgd,bkd->bkg", qg, kh) * scale             # [B, Kv, G]
        kcf = kc[l].float().reshape(B, S, Pn.Kv, Pn.Hd)
        vcf = vc[l].float().reshape(B, S, Pn.Kv, Pn.Hd)
        s_past = torch.einsum("bkgd,bskd->bkgs", qg, kcf) * scale * ks[l][:, None, None, :]
        vmask = valid[:, None, None, :]
        s_past = s_past.masked_fill(~vmask, NEG_INF)
        m = torch.maximum(s_past.amax(dim=-1), s_cur)
        p_past = torch.where(vmask, torch.exp(s_past - m[..., None]), 0.0)
        p_cur = torch.exp(s_cur - m)
        denom = (p_past.sum(dim=-1) + p_cur).clamp_min(1e-30)
        acc = torch.einsum("bkgs,bskd->bkgd", p_past * vs[l][:, None, None, :], vcf)
        acc = acc + p_cur[..., None] * vh[:, :, None, :]
        att = (acc / denom[..., None]).reshape(B, Pn.D).to(bf).float()

        x = x + (att @ mats["wo"]) * scs["wo"]
        hn = rms(x, mw.norms[l, 1]).to(bf).float()
        w_gate, w_up = _split_units(mats["gate_up"])
        s_gate, s_up = _split_units(scs["gate_up"])
        g = ((hn @ w_gate) * s_gate).to(bf).float()
        u = (hn @ w_up) * s_up
        gu = (g * torch.sigmoid(g) * u).to(bf).float()
        x = x + (gu @ mats["down"]) * scs["down"]

        kc[l, rows, slot] = kq
        vc[l, rows, slot] = vq
        ks[l, rows, slot] = ksv
        vs[l, rows, slot] = vsv
    return x.to(bf), kc, vc, ks, vs


def decode_step_mega(
    plan: MegaPlan,
    mw: MegaWeights,
    x0: torch.Tensor,          # [B, D] bf16 embedded current token
    kc: torch.Tensor,          # [L, B, S, KVD] int8
    vc: torch.Tensor,
    ks: torch.Tensor,          # [L, B, S] f32
    vs: torch.Tensor,
    write_pos,                 # cache slot: int / 0-d (one slot for every row) or [B]
    positions: torch.Tensor,   # [B] int32 rope positions
    starts: torch.Tensor,      # [B] int32 first valid slot
    cos_tab: torch.Tensor,     # [S_rope, Hd] f32
    sin_tab: torch.Tensor,
    *,
    phase_clock: Optional[torch.Tensor] = None,
):
    """One whole decode step -> (hidden [B, D] bf16, kc, vc, ks, vs): the
    caches are the inputs with slot ``write_pos`` filled in place. The final
    rms_norm and the lm-head run outside (see models/llm/sampler.py). CPU
    tensors run the plain version; CUDA tensors launch K9 once.

    ``phase_clock``: an int64 CUDA tensor of ``L * len(PHASES) + 2``
    entries that the kernel fills with the device's nanosecond timer as CTA
    0 sees it: at the start, after the prologue (x = x0) and after every
    phase of every layer (a measuring aid: see PHASES)."""
    if x0.device.type == "cpu":
        return decode_step_mega_plain(
            plan, mw, x0, kc, vc, ks, vs, write_pos, positions, starts, cos_tab, sin_tab)
    Pn = plan
    B, S = x0.shape[0], kc.shape[2]
    dev = x0.device
    x0 = x0.to(torch.bfloat16).contiguous()
    _check_geometry(Pn)
    check_cuda_tensor("stream", mw.stream, torch.int8, (Pn.L, Pn.layer_bytes))
    check_cuda_tensor("scales", mw.scales, torch.float32, (Pn.L, Pn.scale_width))
    check_cuda_tensor("norms", mw.norms, torch.float32, (Pn.L, 2, Pn.D))
    check_cuda_tensor("bias", mw.bias, torch.float32, (Pn.L, Pn.w_qkv))
    check_cuda_tensor("x0", x0, torch.bfloat16, (B, Pn.D))
    for name, t in (("kc", kc), ("vc", vc)):
        check_cuda_tensor(name, t, torch.int8, (Pn.L, B, S, Pn.KVD))
    for name, t in (("ks", ks), ("vs", vs)):
        check_cuda_tensor(name, t, torch.float32, (Pn.L, B, S))
    S_rope = cos_tab.shape[0]
    check_cuda_tensor("cos_tab", cos_tab, torch.float32, (S_rope, Pn.Hd))
    check_cuda_tensor("sin_tab", sin_tab, torch.float32, (S_rope, Pn.Hd))
    wps = _row_slots(write_pos, B, dev).contiguous()
    positions = positions.to(torch.int32).contiguous()
    starts = starts.to(torch.int32).contiguous()
    for name, t in (("write_pos", wps), ("positions", positions), ("starts", starts)):
        check_cuda_tensor(name, t, torch.int32, (B,))
    if phase_clock is not None:
        check_cuda_tensor("phase_clock", phase_clock, torch.int64, (Pn.L * len(PHASES) + 2,))

    sched = mega_schedule(Pn, B, S, sm_count(dev.index))
    n_part, n_apart, n_sync = workspace_floats(Pn, sched, B)
    f32 = dict(dtype=torch.float32, device=dev)
    bf16 = dict(dtype=torch.bfloat16, device=dev)
    out, att, gu = torch.empty((B, Pn.D), **bf16), torch.empty((B, Pn.D), **bf16), \
        torch.empty((B, Pn.F), **bf16)
    x, qkv = torch.empty((B, Pn.D), **f32), torch.empty((B, Pn.w_qkv), **f32)
    kvmax = torch.empty((B, Pn.Kv, 4), **f32)
    ssq = torch.empty((Pn.D // UNIT, B), **f32)
    part, apart = torch.empty((n_part,), **f32), torch.empty((n_apart,), **f32)
    sync = torch.empty((n_sync,), dtype=torch.int32, device=dev)   # zeroed by the C entry
    KERNEL(
        dev.index, mw.stream.data_ptr(), mw.scales.data_ptr(), mw.norms.data_ptr(),
        mw.bias.data_ptr(), x0.data_ptr(), cos_tab.data_ptr(), sin_tab.data_ptr(),
        kc.data_ptr(), vc.data_ptr(), ks.data_ptr(), vs.data_ptr(),
        wps.data_ptr(), positions.data_ptr(), starts.data_ptr(), out.data_ptr(),
        x.data_ptr(), qkv.data_ptr(), kvmax.data_ptr(), att.data_ptr(), gu.data_ptr(), ssq.data_ptr(),
        part.data_ptr(), apart.data_ptr(), sync.data_ptr(),
        None if phase_clock is None else phase_clock.data_ptr(),
        B, S, Pn.L, Pn.D, Pn.H, Pn.Kv, Pn.Hd, Pn.F, S_rope, *sched.ks, sched.bps, sched.ns,
        sched.grid, float(Pn.eps), float(Pn.Hd ** -0.5), stream_handle(),
    )
    return out, kc, vc, ks, vs
