// Kernels K2 and K3: one-token decode attention over a packed KV cache.
//
// K2 (bf16 cache) replaces the Pallas TPU kernel _kernel of
// rlinf_tpu/ops/pallas/decode_attention.py (decode_attention_packed);
// K3 (int8 cache with one f32 scale per (row, slot)) replaces _kernel_q8
// (decode_attention_packed_q8). Same function: for every batch row b and
// query head h, softmax over the slots start[b] <= s < length[b] of
// (q . k_s) * scale [* k_scale_s], then the sum of p_s [* v_scale_s] * v_s.
// The int8 cache is never dequantized: the scales fold into the score and
// the probability. An empty interval gives 0.
//
// What bounds it on an H100: bytes. Each cache byte is read once and used
// for 2*G flops (G = 6 query heads per kv head at Qwen2-1.5B), far left of
// the ridge point, so the target is the memory rate over the valid slots.
//
// K2 and K3 share one design, after K10's (paged_attention.cu); K2 on the
// bf16 cache takes up to 16 query heads per kv head, K3 up to 8:
//  * Split-KV. The grid is (row, kv head, split). A row's valid interval
//    covers its 16-key blocks [start / 16, ceil(end / 16)); a split is a
//    run of BPS of them from the row's first block, BPS chosen on the host
//    so that the grid covers the SMs several times (ops/cuda/
//    decode_attention.py split_plan). A split past the row's last block
//    returns at once. Each split writes its partial state (row max m in
//    log2 units, sum l, the unnormalised f32 output of its G heads) to
//    scratch, and a second small kernel merges the used splits of each
//    (row, query head) and writes bf16; one C entry launches both.
//    decode_attention.py split_plan makes both kernels' plans.
//  * Staging. One kv head's row of a slot is Hd values at a stride of
//    Kv * Hd. A CTA has four warps; warp w takes blocks w, w + 4, ... of
//    the split into a ring of its own by cp.async, 16 bytes a copy: each
//    lane copies exactly the bytes it reads (K and V rows g and g + 8 of
//    the block, 16 depths of each 64-depth chunk: 16 bytes of int8, 32 of
//    bf16; K3 also the k and v scales of its four score columns), so a
//    lane's own cp.async.wait_group makes its stage ready, with no barrier
//    and no mbarrier. A TMA box would have needed a map per call and a
//    whole warp to wait on one barrier for data each lane reads alone.
//    Blocks are aligned to 16 slots, so a block's scales are whole; slots
//    past S are filled with zeros, never read. K3's ring has three stages,
//    K2's two (a bf16 stage holds twice the bytes).
//  * Products on the tensor cores, per 16 keys. The query heads are the
//    rows of mma.sync m16n8k16: K3's G <= 8 heads rows 0-7 (rows 8-15
//    zero), K2's G <= 16 heads all 16 rows. K3 widens the int8 values to
//    bf16 in registers, exactly (|x| <= 128 fits bf16's 8-bit
//    significand; a byte permute builds the float 2^23 + 128 + x); K2's
//    bf16 rows are B fragments as they stand. A lane's 16 depths of a key
//    row are consecutive, and the Q fragments (held in registers for the
//    whole split) take the depths in the same order. k_scale multiplies
//    each key's score column after the product. P (* v_scale) enters P V
//    as hi + lo bf16 parts (an f32 P, as the plain version), and V's rows
//    are turned into B fragments by movmatrix.trans. One max and one sum
//    reduction a 16-key block and head, over the four lanes of a row.
//  * The four warps' states are merged through shared memory at the end of
//    the split.

#include "hopper.cuh"

#include <atomic>

namespace {

constexpr int MAXG = 8;     // K3: most query heads per kv head
constexpr int MAXG_BF = 16;  // K2: most query heads per kv head

// ---------------------------------------------------------------------------
// K2 and K3: split-KV over 16-key blocks, cp.async rings, mma.sync
// ---------------------------------------------------------------------------

constexpr int Q8_NW = 4;       // warps per CTA, each with its own blocks (K2 and K3)
constexpr int KEYS = 16;       // keys of a block: two score n-tiles, the k of P V
constexpr int Q8_RING = 3;     // stages of each warp's ring
constexpr int CHUNK = 32 * 16;  // one 16-byte chunk of each lane
constexpr float LOG2E = 1.4426950408889634f;

// A stage holds each lane's chunks, chunk-major ([chunk][lane][16 bytes]):
// K rows g, g + 8 (NC chunks each), V rows g, g + 8, then the k scales and
// the v scales of keys 2t, 2t + 1, 8 + 2t, 9 + 2t (t = lane % 4).
__host__ __device__ constexpr int q8_chunks(int HD) { return 4 * (HD / 64) + 2; }
__host__ __device__ constexpr int q8_smem(int HD) {
  return Q8_NW * Q8_RING * q8_chunks(HD) * CHUNK > Q8_NW * MAXG * (HD + 2) * 4
             ? Q8_NW * Q8_RING * q8_chunks(HD) * CHUNK
             : Q8_NW * MAXG * (HD + 2) * 4;
}

// The arguments of both kernels and of their merge.
struct SplitArgs {
  const __nv_bfloat16* q;
  const void *kc, *vc;      // int8 (K3) or bf16 (K2)
  const float *ks, *vs;      // K3 only
  const int *starts, *lengths;
  float *part_o, *part_ml;  // [B * KV, NS, G, HD] and [B * KV, NS, G, 2] f32
  __nv_bfloat16* out;
  int B, H, KV, S, BPS, NS;
  float scale;
};

// A row's valid slots [start, end) and their 16-key blocks [blk0, blk0 + nblk).
struct Interval {
  int start, end, blk0, nblk;
};

__device__ __forceinline__ Interval row_interval(const SplitArgs& a, int b) {
  Interval v;
  v.start = max(a.starts[b], 0);
  v.end = min(a.lengths[b], a.S);
  v.blk0 = v.start / KEYS;
  v.nblk = v.end > v.start ? (v.end + KEYS - 1) / KEYS - v.blk0 : 0;
  return v;
}

// cp.async of `bytes` (16 or 4) from src, or zeros where !ok (src is not read).
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool ok) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                 "r"(ok ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 int8 -> 8 bf16 pairs in order (w[i] holds bytes 2i, 2i + 1), exactly:
// byte x becomes the float with bits 0x4B000000 | (x ^ 0x80), that is
// 2^23 + 128 + x, less 2^23 + 128.
__device__ __forceinline__ void widen16(const uint4& c, uint32_t (&w)[8]) {
  const uint32_t words[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t u = words[k] ^ 0x80808080u;
    float f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(__byte_perm(u, 0x4B00u, 0x5440u | i)) - 8388736.f;
    w[2 * k] = pack_bf16(f[0], f[1]);
    w[2 * k + 1] = pack_bf16(f[2], f[3]);
  }
}

template <int HD>
__global__ void __launch_bounds__(Q8_NW * 32, 3) decode_q8_split_kernel(const SplitArgs a) {
  constexpr int NC = HD / 64;  // 64-depth chunks of a row: 16 bytes of each a lane
  constexpr int STAGE = q8_chunks(HD) * CHUNK;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int sp = blockIdx.x % a.NS, bk = blockIdx.x / a.NS;
  const int b = bk / a.KV, kvh = bk % a.KV, G = a.H / a.KV;
  const Interval iv = row_interval(a, b);
  const int s0 = sp * a.BPS;  // the split's first block, counted from blk0
  if (s0 >= iv.nblk) return;  // past the row's last block: no work, no partial
  const int s1 = min(s0 + a.BPS, iv.nblk);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int n_mine = s1 - s0 > warp ? (s1 - s0 - warp + Q8_NW - 1) / Q8_NW : 0;
  const int8_t* kc = static_cast<const int8_t*>(a.kc);
  const int8_t* vc = static_cast<const int8_t*>(a.vc);
  const unsigned char* ring = smem_raw + warp * Q8_RING * STAGE + lane * 16;
  const uint32_t ring_s = smem_u32(ring);
  auto key0_of = [&](int i) { return (iv.blk0 + s0 + warp + Q8_NW * i) * KEYS; };

  auto fetch = [&](int i) {  // block i of this warp into stage i % Q8_RING
    const int key0 = key0_of(i);
    const uint32_t dst = ring_s + (i % Q8_RING) * STAGE;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int key = key0 + g + 8 * rr;
      const bool ok = key < a.S;
      const size_t at = (((size_t)b * a.S + (ok ? key : 0)) * a.KV + kvh) * HD + 16 * t;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        cp_async<16>(dst + (rr * NC + cc) * CHUNK, kc + at + cc * 64, ok);
        cp_async<16>(dst + ((2 + rr) * NC + cc) * CHUNK, vc + at + cc * 64, ok);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = key0 + 8 * (j / 2) + 2 * t + j % 2;
      const bool ok = key < a.S;
      const size_t at = (size_t)b * a.S + (ok ? key : 0);
      cp_async<4>(dst + 4 * NC * CHUNK + 4 * j, a.ks + at, ok);
      cp_async<4>(dst + (4 * NC + 1) * CHUNK + 4 * j, a.vs + at, ok);
    }
  };
#pragma unroll
  for (int i = 0; i < Q8_RING; ++i) {
    if (i < n_mine) fetch(i);
    cp_async_commit();
  }

  // Q fragments of head g (heads g + 8 do not exist: G <= 8): chunk cc,
  // words w = depths cc * 64 + 16 t + 2 w, + 1; k-step j of the chunk takes
  // words 2 j and 2 j + 1, as the K rows below
  uint32_t qf[NC][8];
#pragma unroll
  for (int cc = 0; cc < NC; ++cc) {
    uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
    if (g < G) {
      const __nv_bfloat16* qp = a.q + ((size_t)b * a.H + kvh * G + g) * HD + cc * 64 + 16 * t;
      lo = *reinterpret_cast<const uint4*>(qp);
      hi = *reinterpret_cast<const uint4*>(qp + 8);
    }
    const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) qf[cc][i] = w[i];
  }
  const float scale2 = a.scale * LOG2E;
  // head g; o[cc][w] is the P V n-tile whose column 2 t + e holds depth
  // cc * 64 + 16 t + 2 w + e (entries 2, 3: the zero rows g + 8)
  float m = RLINF_NEG_INF, l = 0.f;
  float o[NC][8][4];
#pragma unroll
  for (int cc = 0; cc < NC; ++cc)
#pragma unroll
    for (int w = 0; w < 8; ++w)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[cc][w][e] = 0.f;

  for (int i = 0; i < n_mine; ++i) {
    cp_async_wait<Q8_RING - 1>();  // this lane's copies of block i have landed
    const unsigned char* st = ring + (i % Q8_RING) * STAGE;
    auto chunk = [&](int c) { return *reinterpret_cast<const uint4*>(st + c * CHUNK); };
    const int key0 = key0_of(i);
    // S = Q K^T: s[nt][e] is head g, key key0 + 8 nt + 2 t + e
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        uint32_t kw[8];
        widen16(chunk(nt * NC + cc), kw);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t af[4] = {qf[cc][2 * j], 0u, qf[cc][2 * j + 1], 0u};
          mma_bf16(s[nt], af, kw[2 * j], kw[2 * j + 1]);
        }
      }
    const float4 ksc = *reinterpret_cast<const float4*>(st + 4 * NC * CHUNK);
    const float4 vsc = *reinterpret_cast<const float4*>(st + (4 * NC + 1) * CHUNK);
    const float kscale[4] = {ksc.x, ksc.y, ksc.z, ksc.w};
    const float vscale[4] = {vsc.x, vsc.y, vsc.z, vsc.w};
    // mask (slots outside [start, end)), the scales (selected, never
    // multiplied in where masked), and the online softmax of the block
    float mx = m;
    bool ok[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + 8 * nt + 2 * t + e;
        ok[nt][e] = key >= iv.start && key < iv.end;
        float& x = s[nt][e];
        x = ok[nt][e] ? x * scale2 * kscale[2 * nt + e] : RLINF_NEG_INF;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(RLINF_FULL_MASK, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(RLINF_FULL_MASK, mx, 2));
    const float alpha = exp2f(m - mx);
    m = mx;
    l *= alpha;
    float pv[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = ok[nt][e] ? exp2f(s[nt][e] - m) : 0.f;
        l += p;
        pv[nt][e] = ok[nt][e] ? p * vscale[2 * nt + e] : 0.f;
      }
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        o[cc][w][0] *= alpha;
        o[cc][w][1] *= alpha;
      }
    // P v_scale as the A fragment (keys 2 t, + 1 from n-tile 0, 8 + 2 t, + 1
    // from n-tile 1; rows g + 8 zero), in hi and lo bf16 parts
    uint32_t ph[4] = {0u, 0u, 0u, 0u}, pl[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const __nv_bfloat162 hv = __floats2bfloat162_rn(pv[nt][0], pv[nt][1]);
      const float2 hf = __bfloat1622float2(hv);
      ph[2 * nt] = *reinterpret_cast<const uint32_t*>(&hv);
      pl[2 * nt] = pack_bf16(pv[nt][0] - hf.x, pv[nt][1] - hf.y);
    }
    // V: word w of the lane's widened 16 bytes of key rows g and g + 8 is
    // an 8 x 8 matrix (rows keys, columns depth pairs); transposed, it is
    // the B fragment of n-tile w
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      uint32_t v0[8], v1[8];
      widen16(chunk(2 * NC + cc), v0);
      widen16(chunk(3 * NC + cc), v1);
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        const uint32_t b0 = movmatrix_t(v0[w]), b1 = movmatrix_t(v1[w]);
        mma_bf16(o[cc][w], ph, b0, b1);
        mma_bf16(o[cc][w], pl, b0, b1);
      }
    }
    if (i + Q8_RING < n_mine) fetch(i + Q8_RING);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // merge the four warps' states through shared memory (the rings are done)
  l += __shfl_xor_sync(RLINF_FULL_MASK, l, 1);
  l += __shfl_xor_sync(RLINF_FULL_MASK, l, 2);
  __syncthreads();
  float* mo = reinterpret_cast<float*>(smem_raw);  // [Q8_NW][MAXG][HD]
  float* mm = mo + Q8_NW * MAXG * HD;              // [Q8_NW][MAXG]
  float* ml = mm + Q8_NW * MAXG;                   // [Q8_NW][MAXG]
  {
    float* row = mo + (warp * MAXG + g) * HD + 16 * t;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
#pragma unroll
      for (int w = 0; w < 8; ++w)
        *reinterpret_cast<float2*>(row + cc * 64 + 2 * w) = make_float2(o[cc][w][0], o[cc][w][1]);
    if (t == 0) {
      mm[warp * MAXG + g] = m;
      ml[warp * MAXG + g] = l;
    }
  }
  __syncthreads();
  const size_t part = (size_t)bk * a.NS + sp;
  for (int idx = threadIdx.x; idx < G * HD; idx += Q8_NW * 32) {
    const int gg = idx / HD, d = idx % HD;
    float M = RLINF_NEG_INF;
#pragma unroll
    for (int w = 0; w < Q8_NW; ++w) M = fmaxf(M, mm[w * MAXG + gg]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < Q8_NW; ++w) {
      const float e = exp2f(mm[w * MAXG + gg] - M);
      L = fmaf(ml[w * MAXG + gg], e, L);
      A = fmaf(mo[(w * MAXG + gg) * HD + d], e, A);
    }
    a.part_o[(part * G + gg) * HD + d] = A;
    if (d == 0) *reinterpret_cast<float2*>(a.part_ml + (part * G + gg) * 2) = make_float2(M, L);
  }
}

// K2's split kernel: the bf16 cache, up to 16 query heads as the rows of
// the products (head g and head g + 8 in a lane's rows g and g + 8). Two
// CTAs an SM: the two heads' states need more registers than three allow.
constexpr int BF_RING = 2;  // stages of each warp's ring
// A stage ([chunk][lane][16 bytes]): K rows g, g + 8, then V rows g, g + 8,
// each as 2 NC chunks (the lane's 16 depths of every 64-depth block).
__host__ __device__ constexpr int bf_chunks(int HD) { return 8 * (HD / 64); }
__host__ __device__ constexpr int bf_smem(int HD) {
  return Q8_NW * BF_RING * bf_chunks(HD) * CHUNK > Q8_NW * MAXG_BF * (HD + 2) * 4
             ? Q8_NW * BF_RING * bf_chunks(HD) * CHUNK
             : Q8_NW * MAXG_BF * (HD + 2) * 4;
}

template <int HD>
__global__ void __launch_bounds__(Q8_NW * 32, 2) decode_bf16_split_kernel(const SplitArgs a) {
  constexpr int NC = HD / 64;
  constexpr int STAGE = bf_chunks(HD) * CHUNK;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int sp = blockIdx.x % a.NS, bk = blockIdx.x / a.NS;
  const int b = bk / a.KV, kvh = bk % a.KV, G = a.H / a.KV;
  const Interval iv = row_interval(a, b);
  const int s0 = sp * a.BPS;
  if (s0 >= iv.nblk) return;  // past the row's last block: no work, no partial
  const int s1 = min(s0 + a.BPS, iv.nblk);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int n_mine = s1 - s0 > warp ? (s1 - s0 - warp + Q8_NW - 1) / Q8_NW : 0;
  const __nv_bfloat16* kc = static_cast<const __nv_bfloat16*>(a.kc);
  const __nv_bfloat16* vc = static_cast<const __nv_bfloat16*>(a.vc);
  const unsigned char* ring = smem_raw + warp * BF_RING * STAGE + lane * 16;
  const uint32_t ring_s = smem_u32(ring);
  auto key0_of = [&](int i) { return (iv.blk0 + s0 + warp + Q8_NW * i) * KEYS; };

  auto fetch = [&](int i) {  // block i of this warp into stage i % BF_RING
    const int key0 = key0_of(i);
    const uint32_t dst = ring_s + (i % BF_RING) * STAGE;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int key = key0 + g + 8 * rr;
      const bool ok = key < a.S;
      const size_t at = (((size_t)b * a.S + (ok ? key : 0)) * a.KV + kvh) * HD + 16 * t;
#pragma unroll
      for (int c = 0; c < 2 * NC; ++c) {  // 64-depth block c / 2, depths 8 (c % 2) on
        const int off = (c / 2) * 64 + (c % 2) * 8;
        cp_async<16>(dst + (rr * 2 * NC + c) * CHUNK, kc + at + off, ok);
        cp_async<16>(dst + ((2 + rr) * 2 * NC + c) * CHUNK, vc + at + off, ok);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < BF_RING; ++i) {
    if (i < n_mine) fetch(i);
    cp_async_commit();
  }

  // Q fragments of heads g (h = 0) and g + 8 (h = 1): chunk cc, words w =
  // depths cc * 64 + 16 t + 2 w, + 1; k-step j takes words 2 j, 2 j + 1
  uint32_t qf[2][NC][8];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
      if (g + 8 * h < G) {
        const __nv_bfloat16* qp =
            a.q + ((size_t)b * a.H + kvh * G + g + 8 * h) * HD + cc * 64 + 16 * t;
        lo = *reinterpret_cast<const uint4*>(qp);
        hi = *reinterpret_cast<const uint4*>(qp + 8);
      }
      const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) qf[h][cc][i] = w[i];
    }
  const float scale2 = a.scale * LOG2E;
  // o[cc][w][e]: head g (e = 0, 1) or g + 8 (e = 2, 3), depth cc * 64 + 16 t + 2 w + e % 2
  float m[2] = {RLINF_NEG_INF, RLINF_NEG_INF}, l[2] = {0.f, 0.f};
  float o[NC][8][4];
#pragma unroll
  for (int cc = 0; cc < NC; ++cc)
#pragma unroll
    for (int w = 0; w < 8; ++w)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[cc][w][e] = 0.f;

  for (int i = 0; i < n_mine; ++i) {
    cp_async_wait<BF_RING - 1>();  // this lane's copies of block i have landed
    const unsigned char* st = ring + (i % BF_RING) * STAGE;
    auto chunk = [&](int c) { return *reinterpret_cast<const uint4*>(st + c * CHUNK); };
    const int key0 = key0_of(i);
    // S = Q K^T: s[nt][2 h + e] is head g + 8 h, key key0 + 8 nt + 2 t + e
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const uint4 k0 = chunk(nt * 2 * NC + 2 * cc), k1 = chunk(nt * 2 * NC + 2 * cc + 1);
        const uint32_t kw[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t af[4] = {qf[0][cc][2 * j], qf[1][cc][2 * j], qf[0][cc][2 * j + 1],
                                  qf[1][cc][2 * j + 1]};
          mma_bf16(s[nt], af, kw[2 * j], kw[2 * j + 1]);
        }
      }
    // mask (slots outside [start, end)) and the online softmax of each head
    float pv[2][2][2];  // [head][n-tile][e]
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
      bool ok[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = key0 + 8 * nt + 2 * t + e;
          ok[nt][e] = key >= iv.start && key < iv.end;
          float& x = s[nt][2 * h + e];
          x = ok[nt][e] ? x * scale2 : RLINF_NEG_INF;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(RLINF_FULL_MASK, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(RLINF_FULL_MASK, mx, 2));
      alpha[h] = exp2f(m[h] - mx);
      m[h] = mx;
      l[h] *= alpha[h];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ok[nt][e] ? exp2f(s[nt][2 * h + e] - mx) : 0.f;
          l[h] += p;
          pv[h][nt][e] = p;
        }
    }
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        o[cc][w][0] *= alpha[0];
        o[cc][w][1] *= alpha[0];
        o[cc][w][2] *= alpha[1];
        o[cc][w][3] *= alpha[1];
      }
    // P as the A fragment (rows g and g + 8: the two heads; keys 2 t, + 1 of
    // n-tile 0, then 8 + 2 t, + 1 of n-tile 1), in hi and lo bf16 parts
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const __nv_bfloat162 hv = __floats2bfloat162_rn(pv[h][nt][0], pv[h][nt][1]);
        const float2 hf = __bfloat1622float2(hv);
        ph[2 * nt + h] = *reinterpret_cast<const uint32_t*>(&hv);
        pl[2 * nt + h] = pack_bf16(pv[h][nt][0] - hf.x, pv[h][nt][1] - hf.y);
      }
    // V: word w of the lane's 16 depths of key rows g and g + 8 is an 8 x 8
    // matrix (rows keys, columns depth pairs); transposed, the B fragment
    // of n-tile w
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const uint4 a0 = chunk(4 * NC + 2 * cc), a1 = chunk(4 * NC + 2 * cc + 1);
      const uint4 c0 = chunk(6 * NC + 2 * cc), c1 = chunk(6 * NC + 2 * cc + 1);
      const uint32_t v0[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const uint32_t v1[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        const uint32_t b0 = movmatrix_t(v0[w]), b1 = movmatrix_t(v1[w]);
        mma_bf16(o[cc][w], ph, b0, b1);
        mma_bf16(o[cc][w], pl, b0, b1);
      }
    }
    if (i + BF_RING < n_mine) fetch(i + BF_RING);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // merge the four warps' states through shared memory (the rings are done)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(RLINF_FULL_MASK, l[h], 1);
    l[h] += __shfl_xor_sync(RLINF_FULL_MASK, l[h], 2);
  }
  __syncthreads();
  float* mo = reinterpret_cast<float*>(smem_raw);  // [Q8_NW][MAXG_BF][HD]
  float* mm = mo + Q8_NW * MAXG_BF * HD;           // [Q8_NW][MAXG_BF]
  float* ml = mm + Q8_NW * MAXG_BF;                // [Q8_NW][MAXG_BF]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* row = mo + (warp * MAXG_BF + g + 8 * h) * HD + 16 * t;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
#pragma unroll
      for (int w = 0; w < 8; ++w)
        *reinterpret_cast<float2*>(row + cc * 64 + 2 * w) =
            make_float2(o[cc][w][2 * h], o[cc][w][2 * h + 1]);
    if (t == 0) {
      mm[warp * MAXG_BF + g + 8 * h] = m[h];
      ml[warp * MAXG_BF + g + 8 * h] = l[h];
    }
  }
  __syncthreads();
  const size_t part = (size_t)bk * a.NS + sp;
  for (int idx = threadIdx.x; idx < G * HD; idx += Q8_NW * 32) {
    const int gg = idx / HD, d = idx % HD;
    float M = RLINF_NEG_INF;
#pragma unroll
    for (int w = 0; w < Q8_NW; ++w) M = fmaxf(M, mm[w * MAXG_BF + gg]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < Q8_NW; ++w) {
      const float e = exp2f(mm[w * MAXG_BF + gg] - M);
      L = fmaf(ml[w * MAXG_BF + gg], e, L);
      A = fmaf(mo[(w * MAXG_BF + gg) * HD + d], e, A);
    }
    a.part_o[(part * G + gg) * HD + d] = A;
    if (d == 0) *reinterpret_cast<float2*>(a.part_ml + (part * G + gg) * 2) = make_float2(M, L);
  }
}

// Head dims 16 and 32, and f16 and f32 queries and caches: the same
// split-KV over 16-key blocks and the same merge, the split on
// hopper.cuh's any_decode_split (mma.sync on tiles of any element type,
// each warp staging its block's K and V rows in shared memory). The 16-byte
// lane chunks of 64-depth blocks above do not cut a shorter row, and hold 4
// f32 depths where the bf16 and int8 designs need 8 or 16. C is the
// cache's element type: T (K2) or int8 (K3, with its per-slot scales).
template <class T, class C, int HD>
__global__ void __launch_bounds__(ANY_NW * 32) decode_any_split_kernel(const SplitArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sp = blockIdx.x % a.NS, bk = blockIdx.x / a.NS;
  const int b = bk / a.KV, kvh = bk % a.KV, G = a.H / a.KV;
  const Interval iv = row_interval(a, b);
  const int s0 = sp * a.BPS;
  if (s0 >= iv.nblk) return;  // past the row's last block: no work, no partial
  const int s1 = min(s0 + a.BPS, iv.nblk);
  auto rows = [&](const void* cache) {
    const C* base = static_cast<const C*>(cache);
    return [=](int key) -> const C* {
      return key < a.S ? base + (((size_t)b * a.S + key) * a.KV + kvh) * HD : nullptr;
    };
  };
  const float* ks = a.ks;
  const float* vs = a.vs;
  const size_t srow = (size_t)b * a.S;
  auto scales = [=](int key) {
    return ks != nullptr ? make_float2(ks[srow + key], vs[srow + key]) : make_float2(1.f, 1.f);
  };
  const size_t part = (size_t)bk * a.NS + sp;
  any_decode_split<T, C, HD>(reinterpret_cast<const T*>(a.q) + ((size_t)b * a.H + kvh * G) * HD, G,
                             (iv.blk0 + s0) * KEYS, (iv.blk0 + s1) * KEYS, iv.start, iv.end,
                             rows(a.kc), rows(a.vc), scales, a.scale, a.part_o + part * G * HD,
                             a.part_ml + part * G * 2, smem_raw);
}

// One CTA per (row, kv head, query head), a thread per depth: the used
// splits' partial states merged into out [B, H, HD] of element type T; a
// row with an empty interval has none and gives 0.
template <class T>
__global__ void decode_merge_kernel(const SplitArgs a, int HD) {
  const int G = a.H / a.KV, bk = blockIdx.x / G, gg = blockIdx.x % G, d = threadIdx.x;
  const int b = bk / a.KV, kvh = bk % a.KV;
  const int used = (row_interval(a, b).nblk + a.BPS - 1) / a.BPS;
  const float* ml = a.part_ml + ((size_t)bk * a.NS * G + gg) * 2;       // split s at + 2 G s
  const float* po = a.part_o + ((size_t)bk * a.NS * G + gg) * HD + d;  // at + G HD s
  float M = RLINF_NEG_INF;
  for (int s = 0; s < used; ++s) M = fmaxf(M, ml[(size_t)2 * G * s]);
  float L = 0.f, A = 0.f;
  for (int s = 0; s < used; ++s) {
    const float e = exp2f(ml[(size_t)2 * G * s] - M);
    L = fmaf(ml[(size_t)2 * G * s + 1], e, L);
    A = fmaf(po[(size_t)G * HD * s], e, A);
  }
  reinterpret_cast<T*>(a.out)[((size_t)b * a.H + kvh * G + gg) * HD + d] =
      Elem<T>::put(A / fmaxf(L, 1e-30f));
}

template <class T, class C, int HD>
cudaError_t launch_any(const SplitArgs& a, cudaStream_t st) {
  constexpr int smem = any_decode_smem<C, HD>();
  cudaError_t err = cudaFuncSetAttribute(decode_any_split_kernel<T, C, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  decode_any_split_kernel<T, C, HD><<<a.B * a.KV * a.NS, ANY_NW * 32, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<T><<<a.B * a.H, HD, 0, st>>>(a, HD);
  return cudaGetLastError();
}

// Query type T, cache element C (T, or int8 for K3), head dim HD: 16 and 32
// for every type, 64 and 128 for f16 and f32 (bf16 takes the kernels above).
template <class T, bool Q8>
cudaError_t run_any(const SplitArgs& a, int HD, cudaStream_t st) {
  using C = typename std::conditional<Q8, int8_t, T>::type;
  if (HD == 16) return launch_any<T, C, 16>(a, st);
  if (HD == 32) return launch_any<T, C, 32>(a, st);
  if constexpr (!std::is_same<T, __nv_bfloat16>::value) {
    if (HD == 64) return launch_any<T, C, 64>(a, st);
    if (HD == 128) return launch_any<T, C, 128>(a, st);
  }
  return cudaErrorInvalidValue;
}

template <bool Q8>
cudaError_t run_any_dtype(const SplitArgs& a, int HD, int dtype, cudaStream_t st) {
  if (dtype == 0) return run_any<__nv_bfloat16, Q8>(a, HD, st);
  if (dtype == 1) return run_any<__half, Q8>(a, HD, st);
  if (dtype == 2) return run_any<float, Q8>(a, HD, st);
  return cudaErrorInvalidValue;
}

// The split kernel's shared-memory limit, raised once for each device (the
// attribute holds for the function on the current device): a decode step
// calls K3 once a layer, and the host's time per call is what a host-bound
// step pays.
template <int HD>
cudaError_t q8_raise_smem(int device) {
  static std::atomic<unsigned long long> raised{0};
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if (bit & raised.load(std::memory_order_relaxed)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      decode_q8_split_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, q8_smem(HD));
  if (err == cudaSuccess) raised.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

template <int HD>
cudaError_t launch_q8(const SplitArgs& a, int device, cudaStream_t st) {
  constexpr int smem = q8_smem(HD);
  cudaError_t err = q8_raise_smem<HD>(device);
  if (err != cudaSuccess) return err;
  decode_q8_split_kernel<HD><<<a.B * a.KV * a.NS, Q8_NW * 32, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<__nv_bfloat16><<<a.B * a.H, HD, 0, st>>>(a, HD);
  return cudaGetLastError();
}

template <int HD>
cudaError_t bf16_raise_smem(int device) {
  static std::atomic<unsigned long long> raised{0};
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if (bit & raised.load(std::memory_order_relaxed)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      decode_bf16_split_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bf_smem(HD));
  if (err == cudaSuccess) raised.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

template <int HD>
cudaError_t launch_bf16(const SplitArgs& a, int device, cudaStream_t st) {
  cudaError_t err = bf16_raise_smem<HD>(device);
  if (err != cudaSuccess) return err;
  decode_bf16_split_kernel<HD><<<a.B * a.KV * a.NS, Q8_NW * 32, bf_smem(HD), st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<__nv_bfloat16><<<a.B * a.H, HD, 0, st>>>(a, HD);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// K2. q [B, H, HD] and k_cache/v_cache [B, S, KV * HD] of element type
// `dtype` (0 bf16, 1 f16, 2 f32); starts, lengths [B] int32; part f32
// scratch of B * KV * NS * (H / KV) * (HD + 2) floats laid out as K3's; out
// [B, H, HD] in q's type. HD is 16, 32, 64 or 128 (bf16 at 64 and 128: the
// kernel above; else any_decode_split), H / KV at most 16; the splits as
// K3's.
extern "C" int decode_attention_bf16(int device, const void* q, const void* kc, const void* vc,
                                     const void* starts, const void* lengths, void* part,
                                     void* out, int B, int H, int KV, int S, int HD,
                                     int dtype, int BPS, int NS, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 || H / KV > MAXG_BF || BPS < 1 ||
      (long long)BPS * NS < (S + KEYS - 1) / KEYS || !aligned16(q) || !aligned16(kc) ||
      !aligned16(vc) || !aligned16(part))
    return cudaErrorInvalidValue;
  float* part_o = static_cast<float*>(part);
  float* part_ml = part_o + (size_t)B * H * NS * HD;
  const SplitArgs a{static_cast<const __nv_bfloat16*>(q), kc, vc, nullptr, nullptr,
                    static_cast<const int*>(starts), static_cast<const int*>(lengths), part_o,
                    part_ml, static_cast<__nv_bfloat16*>(out), B, H, KV, S, BPS, NS, scale};
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 || (HD != 64 && HD != 128)) return run_any_dtype<false>(a, HD, dtype, st);
  if (HD == 128) return launch_bf16<128>(a, device, st);
  return launch_bf16<64>(a, device, st);
}

// K3. q [B, H, HD] of element type `dtype` (0 bf16, 1 f16, 2 f32; out in
// the same type); k_cache/v_cache [B, S, KV * HD] int8 and their
// scales k_scale/v_scale [B, S] f32; starts, lengths [B] int32; part f32
// scratch of B * KV * NS * (H / KV) * (HD + 2) floats, the splits' o
// [B * KV, NS, H / KV, HD] then their (m, l) [B * KV, NS, H / KV, 2];
// out [B, H, HD]. HD is 16, 32, 64 or 128 (bf16 at 64 and 128: the kernel
// above; else any_decode_split), H / KV at most 8; the splits are runs of
// BPS 16-key blocks, NS of them covering ceil(S / 16).
extern "C" int decode_attention_q8(int device, const void* q, const void* kc, const void* vc,
                                   const void* k_scale, const void* v_scale, const void* starts,
                                   const void* lengths, void* part, void* out,
                                   int B, int H, int KV, int S, int HD, int dtype,
                                   int BPS, int NS, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 || H / KV > MAXG || BPS < 1 ||
      (long long)BPS * NS < (S + KEYS - 1) / KEYS || !aligned16(q) || !aligned16(kc) ||
      !aligned16(vc) || !aligned16(part))
    return cudaErrorInvalidValue;
  float* part_o = static_cast<float*>(part);
  float* part_ml = part_o + (size_t)B * H * NS * HD;  // B KV NS G HD floats: 16-byte aligned
  const SplitArgs a{static_cast<const __nv_bfloat16*>(q), kc, vc,
                 static_cast<const float*>(k_scale),
                 static_cast<const float*>(v_scale), static_cast<const int*>(starts),
                 static_cast<const int*>(lengths), part_o, part_ml,
                 static_cast<__nv_bfloat16*>(out), B, H, KV, S, BPS, NS, scale};
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 || (HD != 64 && HD != 128)) return run_any_dtype<true>(a, HD, dtype, st);
  if (HD == 128) return launch_q8<128>(a, device, st);
  return launch_q8<64>(a, device, st);
}
