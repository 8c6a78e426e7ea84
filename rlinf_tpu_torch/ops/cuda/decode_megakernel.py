"""Kernel K9: one whole decode step over all layers in one launch, and its
plain version.

Port of ``rlinf_tpu/ops/pallas/decode_megakernel.py``. ``make_plan`` keeps
the JAX package's fields and asserts; ``pack_decode_weights`` turns the fused
int8 decode params (``quantize_params(fuse=True)``) into the port's own
stream: per layer ``wqkv | wo | gate | up | down``, each matrix ``[K, N]``
stored as ``[N/8][K/64][8][64]`` int8 (8 output columns by 64 of the depth,
the depths of a row in the order of the tensor-core fragments, see
``_pack_matrix``), so that a warp of the kernel reads 512 contiguous bytes
and a thread's 16 bytes are its fragments of four k-steps. The JAX
package's ``[L*17, D, CW]`` chunk stream (zero-padded tiles, a transposed
down-projection, a phase->chunk table) is a Mosaic pipelining device and is
not kept.

``decode_step_mega`` computes what the TPU kernel computes (see
``csrc/decode_megakernel.cu``) and writes slot ``write_pos`` of the four
cache arrays IN PLACE, where the JAX function returned updated copies; the
same tensors are returned. ``decode_step_mega_plain`` is the same step in
tensor ops on the same packed weights.
"""

from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, NamedTuple, Optional, Tuple

import torch

from rlinf_tpu_torch.ops.cuda._build import (
    F, I, P, CudaKernel, check_cuda_tensor, stream_handle,
)
from rlinf_tpu_torch.ops.cuda.decode_attention import NEG_INF
from rlinf_tpu_torch.ops.cuda.geometry import LIMITS, check_heads

if TYPE_CHECKING:  # models/llm imports this module (sampler.generate(mega=))
    from rlinf_tpu_torch.models.llm.config import LLMConfig

KERNEL = CudaKernel(
    "decode_megakernel.cu", "decode_megakernel",
    [I] + [P] * 22 + [I] * 9 + [F, F, P],
)

N_TILE = 8     # output columns of one packed weight tile
K_BLOCK = 64   # depth of one packed weight tile
ITEM_COLS = 16  # output columns of one work item of the kernel
MAX_SLICES = 16  # most K-slices of a product (KS_MAX of the CUDA source)
MAX_STAGED_DEPTH = 1536  # deepest slice of 64 activation rows that fits beside the reduce buffer
MAX_GROUP = LIMITS["decode_megakernel"][1]  # query heads per kv head (MAXG of the CUDA source)
#: the kernel's phases within a layer, in order, a grid-wide barrier after each
PHASES = ("norm1", "qkv", "attention", "o_proj", "norm2", "gate_up", "down")


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
        """(name, K, N) of a layer's matrices in stream order."""
        return (("wqkv", self.D, self.w_qkv), ("wo", self.QD, self.D),
                ("gate", self.D, self.F), ("up", self.D, self.F),
                ("down", self.F, self.D))

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
    assert QD == D, "megakernel requires num_heads*head_dim == hidden_size"
    assert not cfg.qk_norm, "megakernel does not support qk-norm models"
    assert not cfg.is_moe, "megakernel is dense-MLP only"
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
    """[L, K, N] int8 -> [L, K*N] as tiles [N/8][K/64][8][64]. Within a
    tile row the 64 depths are ordered for the tensor-core fragments: byte
    16*t + 4*j + 2*h + e holds depth 16*j + 8*h + 2*t + e, so that the 16
    bytes thread t of a quad loads are its B fragments of the tile's four
    k-steps j in the standard fragment order."""
    L, K, N = q.shape
    #            0  1            2  3  4  5  6            7
    t = q.reshape(L, K // K_BLOCK, 4, 2, 4, 2, N // N_TILE, N_TILE)   # depth = (j, h, t, e)
    return t.permute(0, 6, 1, 7, 4, 2, 3, 5).reshape(L, K * N)


def _unpack_matrix(flat: torch.Tensor, K: int, N: int) -> torch.Tensor:
    """One layer's packed tiles [K*N] -> [K, N] (the inverse of _pack_matrix)."""
    t = flat.reshape(N // N_TILE, K // K_BLOCK, N_TILE, 4, 4, 2, 2)   # (.., n, t, j, h, e)
    return t.permute(1, 4, 5, 3, 6, 0, 2).reshape(K, N)


def pack_decode_weights(qparams: dict, cfg: LLMConfig,
                        chunk_width: int = 2048) -> Tuple[MegaPlan, MegaWeights]:
    """Fused int8 decode params (quantize_params(fuse=True)) -> packed stream.

    Weights on the card are packed only for a model the kernel takes
    (``_check_geometry`` raises before anything is packed); on the CPU the
    plain version runs any geometry."""
    plan = make_plan(cfg, chunk_width)
    b = qparams["blocks"]
    assert "wqkv" in b and "wgu" in b, (
        "megakernel needs fused decode weights (quantize_params fuse=True)")
    if b["wqkv"].q.device.type == "cuda":
        _check_geometry(plan)
    for name, k, n in plan.matrices:
        if k % K_BLOCK or n % ITEM_COLS:
            raise ValueError(
                f"megakernel packing needs the depth of {name} ({k}) to be a multiple "
                f"of {K_BLOCK} and its width ({n}) a multiple of {ITEM_COLS}")
    Fd, L = plan.F, plan.L
    wgu = b["wgu"]
    parts = (
        (b["wqkv"].q, b["wqkv"].scale), (b["wo"].q, b["wo"].scale),
        (wgu.q[..., :Fd], wgu.scale[..., :Fd]), (wgu.q[..., Fd:], wgu.scale[..., Fd:]),
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
    """Raise for a model the kernel does not take: its heads (the limits of
    ``geometry.LIMITS``), and the activations it stages: a K-slice of 64
    rows in shared memory, whole for the products out of the hidden state
    (gate/up apply SiLU to the finished sum). Called where the kernel's
    path is built on the card (``pack_decode_weights``, the continuous
    engine with ``use_mega``) and again at each launch."""
    check_heads("decode_megakernel", plan.H, plan.Kv, plan.Hd)
    blocks_f = plan.F // K_BLOCK
    fits = any(blocks_f % ks == 0 and blocks_f // ks * K_BLOCK <= MAX_STAGED_DEPTH
               for ks in range(1, MAX_SLICES + 1))
    if plan.D > MAX_STAGED_DEPTH or not fits:
        raise ValueError(
            f"decode megakernel: hidden {plan.D} / intermediate {plan.F} do not fit its "
            f"staged activations (hidden up to {MAX_STAGED_DEPTH}; the intermediate size "
            f"in at most {MAX_SLICES} equal slices of 64-blocks, each up to {MAX_STAGED_DEPTH})")


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
        g = ((hn @ mats["gate"]) * scs["gate"]).to(bf).float()
        u = (hn @ mats["up"]) * scs["up"]
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

    ``phase_clock``: an int64 CUDA tensor of ``L * 7 + 2`` entries that the
    kernel fills with the device's nanosecond timer at every phase edge of
    one CTA (a measuring aid: see PHASES)."""
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

    # workspaces of the launch: residual stream, activations, K-slice partials
    out = torch.empty((B, Pn.D), dtype=torch.bfloat16, device=dev)
    x = torch.empty((B, Pn.D), dtype=torch.float32, device=dev)
    hn = torch.empty((B, Pn.D), dtype=torch.bfloat16, device=dev)
    att = torch.empty((B, Pn.D), dtype=torch.bfloat16, device=dev)
    gu = torch.empty((B, Pn.F), dtype=torch.bfloat16, device=dev)
    part = torch.empty((MAX_SLICES, B, max(Pn.w_qkv, Pn.D)), dtype=torch.float32, device=dev)
    bar = torch.empty((1,), dtype=torch.int32, device=dev)
    if phase_clock is not None:
        check_cuda_tensor("phase_clock", phase_clock, torch.int64, (Pn.L * len(PHASES) + 2,))
    KERNEL(
        dev.index, mw.stream.data_ptr(), mw.scales.data_ptr(), mw.norms.data_ptr(),
        mw.bias.data_ptr(), x0.data_ptr(), cos_tab.data_ptr(), sin_tab.data_ptr(),
        kc.data_ptr(), vc.data_ptr(), ks.data_ptr(), vs.data_ptr(),
        wps.data_ptr(), positions.data_ptr(), starts.data_ptr(), out.data_ptr(),
        x.data_ptr(), hn.data_ptr(), att.data_ptr(), gu.data_ptr(), part.data_ptr(),
        bar.data_ptr(), None if phase_clock is None else phase_clock.data_ptr(),
        B, S, Pn.L, Pn.D, Pn.H, Pn.Kv, Pn.Hd, Pn.F, S_rope,
        float(Pn.eps), float(Pn.Hd ** -0.5), stream_handle(),
    )
    return out, kc, vc, ks, vs
