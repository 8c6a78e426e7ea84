// Kernels K7 and K8: causal grouped-query flash-attention backward.
//
// K7 replaces the Pallas TPU kernel _bwd_dq_kernel and K8 _bwd_dkv_kernel
// of rlinf_tpu/ops/pallas/flash_attention.py (pallas_calls in _flash_bwd).
// Same function: with s = q k^T * scale under the mask (pos_kv <= pos_q)
// AND kv_valid, p = exp(s - lse) where unmasked and 0 elsewhere (lse is
// what K1 wrote), dp = do v^T, ds = p (dp - delta) * scale with
// delta = rowsum(o * do):
//   K7: delta, and dq = ds k           (written in q's dtype)
//   K8: dk = ds^T q, dv = p^T do       (f32, summed over the query heads of
//                                       each kv head, cast to k's dtype)
//
// What bounds them on an H100: operations. At the training shapes (B=16,
// T=768, H=12, Kv=2, Hd=128) K7 does three and K8 four T x T x Hd products
// per (row, head), halved by causality: 43 and 58 GFLOP against ~0.2 GB of
// operands. As in flash-attention 2 and 3, s, dp, p and ds are formed in
// f32, and p and ds are rounded to bf16 only as operands of the second
// products (dq, dk, dv).
//
// Design, in the way of flash-attention 3's backward. Every product runs on
// wgmma (m64nNk16, bf16 in, f32 sums in registers); every tile comes in by
// TMA under mbarriers. A consumer warpgroup owns 64 rows; a producer warp
// streams tiles through a ring of stages in shared memory.
//  * K7: one CTA per (batch row, query head, 64-row query tile): one
//    consumer warpgroup and a lone producer warp (160 threads, two CTAs an
//    SM, a ring of two stages). Q and dO of the tile are loaded once; the
//    producer streams the (K, V) tiles of 64 keys of the kv head. The
//    consumer runs S = Q K^T and dP = dO V^T (both operands K-major in
//    shared memory; p is formed while dP still runs), then dQ += dS K with
//    dS as the register A operand (the bf16-packed accumulator fragment is
//    exactly wgmma's A fragment) and K as the MN-major B, read with the
//    transpose bit: dS never passes through shared memory. delta is fused
//    into the prologue: the consumer forms rowsum(o * do) in f32 for its
//    rows from o in device memory and dO in shared memory, and writes it to
//    a [B, H, Sq] buffer that K8 reads.
//  * K8: one CTA per (batch row, kv head, 128-key tile): two consumer
//    warpgroups of 64 keys and a producer warpgroup (384 threads, setmaxnreg
//    40 / 232, one CTA an SM, a ring of three stages), the keys the M rows
//    of every product. K and V of the tile are loaded once; the producer
//    streams (Q, dO, and per row the position, lse and delta) of 64 query
//    rows over the G query heads of the group and the query tiles. The
//    consumers compute the transposed forms S^T = K Q^T and dP^T = V dO^T
//    (K-major operands), p^T and dS^T in registers with lse and delta
//    broadcast along columns, then dV += P^T dO and dK += dS^T Q with P^T
//    and dS^T as register A operands and dO and Q as MN-major B. The GQA
//    group sum stays in the accumulators (two 64 x 128 f32 tiles, 128
//    registers a thread): no [B, H, Sk, Hd] intermediate and no atomics, so
//    dk and dv are deterministic.
//  * Tiles are loaded from 3-D tensor maps (head columns, sequence, batch
//    row), in boxes of 64 columns (128 bytes, the swizzle span), so a
//    ragged last tile reads zeros and not the next batch row; rows past the
//    sequence are masked as well (position INT_MIN for a query, INT_MAX for
//    a key, which also marks an invalid key).
//  * A pair of tiles is skipped when the key tile's least valid position
//    exceeds the query tile's greatest position, the rule K1 uses: the
//    producer loads no such tile, and in K8 a consumer whose own 64 keys
//    need none of a stage only hands it back. The producer reads the next
//    tile's positions while it waits for a free stage.
//  * Heavy tiles first: the grid is one-dimensional and launches K7's late
//    query tiles (which see the most keys) and K8's early key tiles (seen by
//    the most queries) first, so the light ones fill the last wave.
//  * f16 operands run the same kernels on the f16 form of the same wgmma
//    instructions (<HD, true>: f16 tensor maps, p and dS rounded to f16,
//    f16 outputs). Heads of 16 and 32, and f32 operands, take the mma.sync
//    kernels further down (flash_bwd_dq_any_kernel, flash_bwd_dkv_any_kernel).
//
// Measured at the training microbatch (B=16, T=768, H=12, Kv=2, Hd=128) on
// an H100 80GB HBM3 at 700 W, each variant of this file built beside these
// kernels and timed in turns with them in one run (three rounds, ms): K7
// 0.1488-0.1498, K8 0.1604-0.1614. What did not help:
//  * K7 with 128-row CTAs of two consumer warpgroups (one CTA an SM):
//    0.1611-0.1625.
//  * K8 with 64-key CTAs of one consumer warpgroup (two an SM, no
//    setmaxnreg): 168 registers a thread hold the two accumulators and
//    S^T, dP^T only with spills, and ptxas then serialises every wgmma (one
//    wait a product in the SASS): 0.2906-0.2913.
//  * K8 with flash-attention 3's register split, producer 24 / consumers
//    240: 0.1626-0.1641.
//  * K8 consumers computing every stage the producer streams, instead of
//    handing back the ones their 64 keys do not need: 0.1712-0.1726.
//  * Any extra live state in the consumer loop: a clock-based timeout in
//    the mbarrier wait alone pushes K8 past the register budget and
//    serialises its wgmma: 0.2882-0.2907.

#include "hopper.cuh"

namespace {

constexpr int STEP = 64;         // K7: keys of a stage; K8: query rows of a stage
constexpr int BOX = GMMA_BOX;    // bytes of a 64-row x 64-column bf16 box
constexpr float LOG2E = 1.4426950408889634f;
// K7: one consumer warpgroup of 64 query rows and a lone producer warp, two
// CTAs an SM, a ring of two stages.
constexpr int DQ_ROWS = 64, DQ_THREADS = 160, DQ_RING = 2;
// K8: two consumer warpgroups of 64 keys each and a producer warpgroup
// (setmaxnreg 40 / 232), one CTA an SM, a ring of three stages.
constexpr int DKV_ROWS = 128, DKV_THREADS = 384, DKV_RING = 3;

// Bytes of dynamic shared memory: the resident pair of tiles of `rows` rows
// (Q and dO in K7, K and V in K8), then the ring, each stage a pair of
// 64-row tiles; and room to align to 1024 bytes (the swizzle atom).
template <int HD, int ROWS, int RING>
constexpr int smem_bytes() {
  return 1024 + 2 * (HD / 64) * (ROWS / 64) * BOX + RING * 2 * (HD / 64) * BOX;
}

struct DqMeta {
  uint64_t full[DQ_RING], empty[DQ_RING], resident;
  int kpos[DQ_RING][STEP];  // key position, INT_MAX where invalid or past Sk
  int tile[DQ_RING];        // key tile of the stage; -1 ends the stream
  float delta[DQ_ROWS];
  int qpos[DQ_ROWS];
};

struct DkvMeta {
  uint64_t full[DKV_RING], empty[DKV_RING], resident;
  int qpos[DKV_RING][STEP];    // query position, INT_MIN past Sq
  float lse2[DKV_RING][STEP];  // lse * log2(e)
  float delta[DKV_RING][STEP];
  int qmax[DKV_RING];
  int flag[DKV_RING];          // 1, or -1 to end the stream
  int wmin[8];                 // least key position of each consumer warp
};

// The elements of a 64 x 64 accumulator that a thread holds: d[4 j + 2 r +
// e] is row 16 warp + g + 8 r, column 8 j + 2 t + e (g = lane / 4, t =
// lane % 4). KEYS_ARE_ROWS (K8): rows are keys, columns queries, and the
// row values (lse, delta) come per column from the stage; else (K7) the
// other way round.
//
// s -> p = exp(s * scale - lse) where the key is visible to the query, else 0.
template <bool KEYS_ARE_ROWS>
__device__ __forceinline__ void probs(float (&s)[32], const int (&rpos)[2], const float (&rlse2)[2],
                                      const int* cpos, const float* clse2, float scale2, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * t;
    const int2 cp = *reinterpret_cast<const int2*>(cpos + c);
    float2 cl = make_float2(0.f, 0.f);
    if (KEYS_ARE_ROWS) cl = *reinterpret_cast<const float2*>(clse2 + c);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * r + e, colpos = e ? cp.y : cp.x;
        const bool ok = KEYS_ARE_ROWS ? rpos[r] <= colpos : colpos <= rpos[r];
        const float l2 = KEYS_ARE_ROWS ? (e ? cl.y : cl.x) : rlse2[r];
        s[i] = ok ? exp2f(s[i] * scale2 - l2) : 0.f;
      }
  }
}

// dp -> ds = p (dp - delta) * scale.
template <bool KEYS_ARE_ROWS>
__device__ __forceinline__ void grads(const float (&p)[32], float (&dp)[32],
                                      const float (&rdelta)[2], const float* cdelta, float scale,
                                      int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float2 cd = make_float2(0.f, 0.f);
    if (KEYS_ARE_ROWS) cd = *reinterpret_cast<const float2*>(cdelta + 8 * j + 2 * t);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * r + e;
        const float dl = KEYS_ARE_ROWS ? (e ? cd.y : cd.x) : rdelta[r];
        dp[i] = p[i] * (dp[i] - dl) * scale;
      }
  }
}

// The accumulator layout is wgmma's A fragment: k16 step u of the next
// product takes the columns 16 u.. (accumulator groups j = 2 u, 2 u + 1),
// rounded to pairs of T (bf16 or f16).
template <class T>
__device__ __forceinline__ void to_frag(const float (&x)[32], uint32_t (&f)[4][4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int q = 0; q < 4; ++q) f[u][q] = Elem<T>::pack(x[8 * u + 2 * q], x[8 * u + 2 * q + 1]);
}

// Two elements of T (bf16 or f16) packed in a word, as floats.
template <class T>
__device__ __forceinline__ float2 unpack2(uint32_t w) {
  if constexpr (std::is_same<T, __half>::value)
    return __half22float2(*reinterpret_cast<const __half2*>(&w));
  else
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

struct Args {
  const __nv_bfloat16 *q, *k, *v, *o, *dO;
  const int *pos_q, *pos_kv;
  const uint8_t* valid;
  const float* lse;
  float* delta;
  __nv_bfloat16 *dq, *dk, *dv;
  int B, Sq, Sk, H, KV;
  float scale;
};

// ---------------------------------------------------------------------------
// K7: dq (and delta)
// ---------------------------------------------------------------------------

template <int HD, bool F16>
__global__ void __launch_bounds__(DQ_THREADS, 2) flash_bwd_dq_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
    const Args a) {
  using T = typename std::conditional<F16, __half, __nv_bfloat16>::type;
  constexpr int NB = HD / 64;               // 64-column boxes of a row
  constexpr int ROWS = DQ_ROWS, RING = DQ_RING;
  constexpr int TILE = NB * BOX;            // bytes of a 64-row tile (Q, dO, K or V)
  extern __shared__ unsigned char smem_raw[];
  __shared__ DqMeta meta;
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, do_s = base + TILE, ring = base + 2 * TILE;
  const int n_qt = (a.Sq + ROWS - 1) / ROWS, n_kt = (a.Sk + STEP - 1) / STEP;
  const int rest = a.H * a.B;
  const int qt = n_qt - 1 - blockIdx.x / rest;  // heavy (late) query tiles first
  const int h = blockIdx.x % rest % a.H, b = blockIdx.x % rest / a.H;
  const int kvh = h / (a.H / a.KV), q0 = qt * ROWS;
  const int warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(smem_u32(&meta.full[s]), 1);
      mbar_init(smem_u32(&meta.empty[s]), 4);  // one arrival per consumer warp
    }
    mbar_init(smem_u32(&meta.resident), 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer warp
    int qmax = INT_MIN;
    for (int r = lane; r < ROWS; r += 32) qmax = max(qmax, query_pos(a.pos_q, b, q0 + r, a.Sq));
    qmax = warp_max(qmax);
    if (lane == 0) {
      const uint32_t bar = smem_u32(&meta.resident);
      mbar_expect_tx(bar, 2 * TILE);
      for (int j = 0; j < NB; ++j) {
        tma_load_3d(q_s + j * BOX, &tm_q, bar, h * HD + 64 * j, q0, b);
        tma_load_3d(do_s + j * BOX, &tm_do, bar, h * HD + 64 * j, q0, b);
      }
    }
    int e0 = key_pos(a.pos_kv, a.valid, b, lane, a.Sk);
    int e1 = key_pos(a.pos_kv, a.valid, b, lane + 32, a.Sk);
    int it = 0;
    for (int kt = 0; kt < n_kt; ++kt) {
      const int c0 = e0, c1 = e1;
      if (kt + 1 < n_kt) {  // the next tile's positions, read while this one waits
        e0 = key_pos(a.pos_kv, a.valid, b, (kt + 1) * STEP + lane, a.Sk);
        e1 = key_pos(a.pos_kv, a.valid, b, (kt + 1) * STEP + lane + 32, a.Sk);
      }
      const int kmin = warp_min(min(c0, c1));
      if (kmin > qmax) continue;
      const int st = it % RING;
      mbar_wait(smem_u32(&meta.empty[st]), ((it / RING) & 1) ^ 1);
      meta.kpos[st][lane] = c0;
      meta.kpos[st][lane + 32] = c1;
      if (lane == 0) meta.tile[st] = kt;
      __syncwarp();
      if (lane == 0) {
        const uint32_t bar = smem_u32(&meta.full[st]), k_s = ring + st * 2 * TILE;
        mbar_expect_tx(bar, 2 * TILE);
        for (int j = 0; j < NB; ++j) {
          tma_load_3d(k_s + j * BOX, &tm_k, bar, kvh * HD + 64 * j, kt * STEP, b);
          tma_load_3d(k_s + TILE + j * BOX, &tm_v, bar, kvh * HD + 64 * j, kt * STEP, b);
        }
      }
      ++it;
    }
    const int st = it % RING;
    mbar_wait(smem_u32(&meta.empty[st]), ((it / RING) & 1) ^ 1);
    if (lane == 0) {
      meta.tile[st] = -1;
      mbar_arrive(smem_u32(&meta.full[st]));
    }
    return;
  }

  const int g = lane / 4, t = lane % 4;
  const float scale2 = a.scale * LOG2E;
  const size_t head_row = (size_t)b * a.H + h;  // row of lse and delta

  // delta = rowsum(o * do) for the tile's 64 rows: two threads a row, each
  // half of its columns; o from device memory, dO from the tile
  mbar_wait(smem_u32(&meta.resident), 0);
  {
    const int rc = threadIdx.x / 2, half = threadIdx.x % 2, s = q0 + rc;
    float d = 0.f;
    if (s < a.Sq) {
      const T* orow = reinterpret_cast<const T*>(a.o) + (((size_t)b * a.Sq + s) * a.H + h) * HD;
      const unsigned char* drow = smem_raw + (do_s - smem_u32(smem_raw)) + rc * 128;
#pragma unroll
      for (int i = 0; i < HD / 16; ++i) {
        const int cc = half * (HD / 16) + i, box = cc / 8, c8 = cc % 8;
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + cc * 8);
        const uint4 dv = *reinterpret_cast<const uint4*>(  // the 128-byte swizzle
            drow + box * BOX + ((c8 ^ (rc & 7)) << 4));
        const uint32_t o2[4] = {ov.x, ov.y, ov.z, ov.w}, d2[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = unpack2<T>(o2[e]), df = unpack2<T>(d2[e]);
          d += of.x * df.x + of.y * df.y;
        }
      }
    }
    d += __shfl_xor_sync(RLINF_FULL_MASK, d, 1);
    const int qp = query_pos(a.pos_q, b, s, a.Sq);
    if (half == 0) {
      meta.delta[rc] = d;
      meta.qpos[rc] = qp;
      if (s < a.Sq) a.delta[head_row * a.Sq + s] = d;
    }
  }
  wg_sync(0);
  int rpos[2];
  float rlse2[2], rdelta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rc = 16 * warp + g + 8 * r, s = q0 + rc;
    rpos[r] = meta.qpos[rc];
    rdelta[r] = meta.delta[rc];
    rlse2[r] = s < a.Sq ? a.lse[head_row * a.Sq + s] * LOG2E : 0.f;
  }

  float dq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
  for (int it = 0;; ++it) {
    const int st = it % RING;
    mbar_wait(smem_u32(&meta.full[st]), (it / RING) & 1);
    if (meta.tile[st] < 0) break;
    const uint32_t k_s = ring + st * 2 * TILE, v_s = k_s + TILE;
    float s[32], dp[32];
    const uint64_t desc_q = kmajor(q_s, 0), desc_k = kmajor(k_s, 0);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<64, 0, F16>(s, desc_q + kstep(ROWS, kk), desc_k + kstep(STEP, kk), kk > 0);
    wgmma_commit();
    const uint64_t desc_do = kmajor(do_s, 0), desc_v = kmajor(v_s, 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<64, 0, F16>(dp, desc_do + kstep(ROWS, kk), desc_v + kstep(STEP, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // S is in; dP may still run while p is formed
    fence_regs(s);
    probs<false>(s, rpos, rlse2, meta.kpos[st], nullptr, scale2, t);
    wgmma_wait<0>();
    fence_regs(dp);
    grads<false>(s, dp, rdelta, nullptr, a.scale, t);
    uint32_t as[4][4];
    to_frag<T>(dp, as);
    const uint64_t desc_kt = mnmajor(k_s);
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < 4; ++u) wgmma_rs<HD, 1, F16>(dq, as[u], desc_kt + mnstep(u), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(as);
    if (lane == 0) mbar_arrive(smem_u32(&meta.empty[st]));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = q0 + 16 * warp + g + 8 * r;
    if (s >= a.Sq) continue;
    T* out = reinterpret_cast<T*>(a.dq) + (((size_t)b * a.Sq + s) * a.H + h) * HD + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) = Elem<T>::pack(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// K8: dk, dv
// ---------------------------------------------------------------------------

template <int HD, bool F16>
__global__ void __launch_bounds__(DKV_THREADS, 1) flash_bwd_dkv_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
    const Args a) {
  using T = typename std::conditional<F16, __half, __nv_bfloat16>::type;
  constexpr int NB = HD / 64;
  constexpr int ROWS = DKV_ROWS, RING = DKV_RING;
  constexpr int RES = NB * 2 * BOX;         // bytes of the K (or V) tile
  constexpr int TILE = NB * BOX;            // bytes of a 64-row Q (or dO) tile of a stage
  extern __shared__ unsigned char smem_raw[];
  __shared__ DkvMeta meta;
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = base, v_s = base + RES, ring = base + 2 * RES;
  const int n_qt = (a.Sq + STEP - 1) / STEP;
  const int G = a.H / a.KV, rest = a.KV * a.B;
  const int kt = blockIdx.x / rest;  // heavy (early) key tiles first
  const int kvh = blockIdx.x % rest % a.KV, b = blockIdx.x % rest / a.KV;
  const int k0 = kt * ROWS;
  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(smem_u32(&meta.full[s]), 1);
      mbar_init(smem_u32(&meta.empty[s]), 8);  // one arrival per consumer warp
    }
    mbar_init(smem_u32(&meta.resident), 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // the producer warpgroup; its first warp streams
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp != 0) return;
    int kmin = INT_MAX;
    for (int r = lane; r < ROWS; r += 32) kmin = min(kmin, key_pos(a.pos_kv, a.valid, b, k0 + r, a.Sk));
    kmin = warp_min(kmin);
    if (lane == 0) {
      const uint32_t bar = smem_u32(&meta.resident);
      mbar_expect_tx(bar, 2 * RES);
      for (int j = 0; j < NB; ++j) {
        tma_load_3d(k_s + j * ROWS * 128, &tm_k, bar, kvh * HD + 64 * j, k0, b);
        tma_load_3d(v_s + j * ROWS * 128, &tm_v, bar, kvh * HD + 64 * j, k0, b);
      }
    }
    // stage x = (query head gi, query tile qt) = (x / n_qt, x % n_qt); the
    // next stage's row values are read while this one waits
    const int n_x = G * n_qt;
    int p0, p1;
    float l0, l1, d0, d1;
    auto fetch = [&](int x) {
      const int h = kvh * G + x / n_qt, s0 = (x % n_qt) * STEP + lane, s1 = s0 + 32;
      const size_t row = ((size_t)b * a.H + h) * a.Sq;
      p0 = query_pos(a.pos_q, b, s0, a.Sq);
      p1 = query_pos(a.pos_q, b, s1, a.Sq);
      l0 = s0 < a.Sq ? a.lse[row + s0] * LOG2E : 0.f;
      l1 = s1 < a.Sq ? a.lse[row + s1] * LOG2E : 0.f;
      d0 = s0 < a.Sq ? a.delta[row + s0] : 0.f;
      d1 = s1 < a.Sq ? a.delta[row + s1] : 0.f;
    };
    fetch(0);
    int it = 0;
    for (int x = 0; x < n_x; ++x) {
      const int cp0 = p0, cp1 = p1;
      const float cl0 = l0, cl1 = l1, cd0 = d0, cd1 = d1;
      if (x + 1 < n_x) fetch(x + 1);
      const int qmax = warp_max(max(cp0, cp1));
      if (qmax < kmin) continue;
      const int st = it % RING;
      mbar_wait(smem_u32(&meta.empty[st]), ((it / RING) & 1) ^ 1);
      meta.qpos[st][lane] = cp0;
      meta.qpos[st][lane + 32] = cp1;
      meta.lse2[st][lane] = cl0;
      meta.lse2[st][lane + 32] = cl1;
      meta.delta[st][lane] = cd0;
      meta.delta[st][lane + 32] = cd1;
      if (lane == 0) {
        meta.qmax[st] = qmax;
        meta.flag[st] = 1;
      }
      __syncwarp();
      if (lane == 0) {
        const int h = kvh * G + x / n_qt, q0 = (x % n_qt) * STEP;
        const uint32_t bar = smem_u32(&meta.full[st]), q_st = ring + st * 2 * TILE;
        mbar_expect_tx(bar, 2 * TILE);
        for (int j = 0; j < NB; ++j) {
          tma_load_3d(q_st + j * BOX, &tm_q, bar, h * HD + 64 * j, q0, b);
          tma_load_3d(q_st + TILE + j * BOX, &tm_do, bar, h * HD + 64 * j, q0, b);
        }
      }
      ++it;
    }
    const int st = it % RING;
    mbar_wait(smem_u32(&meta.empty[st]), ((it / RING) & 1) ^ 1);
    if (lane == 0) {
      meta.flag[st] = -1;
      mbar_arrive(smem_u32(&meta.full[st]));
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1, g = lane / 4, t = lane % 4;
  const float scale2 = a.scale * LOG2E;
  int rpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    rpos[r] = key_pos(a.pos_kv, a.valid, b, k0 + 64 * c + 16 * warp + g + 8 * r, a.Sk);
  const int wm = warp_min(min(rpos[0], rpos[1]));
  if (lane == 0) meta.wmin[4 * c + warp] = wm;
  wg_sync(c);
  const int kmin = min(min(meta.wmin[4 * c], meta.wmin[4 * c + 1]),
                       min(meta.wmin[4 * c + 2], meta.wmin[4 * c + 3]));
  const float none[2] = {0.f, 0.f};
  mbar_wait(smem_u32(&meta.resident), 0);

  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
  for (int it = 0;; ++it) {
    const int st = it % RING;
    mbar_wait(smem_u32(&meta.full[st]), (it / RING) & 1);
    if (meta.flag[st] < 0) break;
    const uint32_t q_st = ring + st * 2 * TILE, do_st = q_st + TILE;
    if (meta.qmax[st] >= kmin) {
      float s[32], dp[32];
      const uint64_t desc_k = kmajor(k_s, 64 * c), desc_q = kmajor(q_st, 0);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<64, 0, F16>(s, desc_k + kstep(ROWS, kk), desc_q + kstep(STEP, kk), kk > 0);
      wgmma_commit();
      const uint64_t desc_v = kmajor(v_s, 64 * c), desc_do = kmajor(do_st, 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<64, 0, F16>(dp, desc_v + kstep(ROWS, kk), desc_do + kstep(STEP, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // S^T is in; dP^T may still run while p^T is formed
      fence_regs(s);
      probs<true>(s, rpos, none, meta.qpos[st], meta.lse2[st], scale2, t);
      wgmma_wait<0>();
      fence_regs(dp);
      grads<true>(s, dp, none, meta.delta[st], a.scale, t);
      uint32_t ap[4][4], as[4][4];
      to_frag<T>(s, ap);
      to_frag<T>(dp, as);
      const uint64_t desc_dot = mnmajor(do_st), desc_qt = mnmajor(q_st);
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < 4; ++u) wgmma_rs<HD, 1, F16>(dv, ap[u], desc_dot + mnstep(u), 1);
#pragma unroll
      for (int u = 0; u < 4; ++u) wgmma_rs<HD, 1, F16>(dk, as[u], desc_qt + mnstep(u), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(ap);
      fence_regs(as);
    }
    if (lane == 0) mbar_arrive(smem_u32(&meta.empty[st]));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = k0 + 64 * c + 16 * warp + g + 8 * r;
    if (s >= a.Sk) continue;
    const size_t at = (((size_t)b * a.Sk + s) * a.KV + kvh) * HD + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<uint32_t*>(reinterpret_cast<T*>(a.dk) + at + 8 * j) =
          Elem<T>::pack(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
      *reinterpret_cast<uint32_t*>(reinterpret_cast<T*>(a.dv) + at + 8 * j) =
          Elem<T>::pack(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Head dims 16 and 32, and f16 and f32 operands: mma.sync
// ---------------------------------------------------------------------------
//
// The same two kernels on mma.sync (hopper.cuh's tiles of any element
// type), for what the TMA boxes and wgmma descriptors above do not take
// (see flash_attention_fwd.cu). Four warps of 16 rows a CTA; every operand
// tile is staged in shared memory (rows padded against bank conflicts) and
// read as fragments there, so a thread's registers hold only its
// accumulators.
//  * K7: a CTA per (batch row, query head, 64 query rows). It forms delta
//    from o and dO, writes it, then per 64-key tile S = Q K^T,
//    p = exp(s - lse), dP = dO V^T, dS = p (dP - delta) scale and
//    dQ += dS K (dS as hi and lo parts).
//  * K8: a CTA per (batch row, kv head, 64 keys). Over the group's query
//    heads and 64-row query tiles: S^T = K Q^T, P^T, dV += P^T dO,
//    dP^T = V dO^T, dS^T, dK += dS^T Q.
// Tiles where no key is visible to any query are skipped.
constexpr int ANY_ROWS = 64, ANY_THREADS = 128;

template <class T>
struct AnyArgs {
  const T *q, *k, *v, *o, *dO;
  const int *pos_q, *pos_kv;
  const uint8_t* valid;
  const float* lse;
  float* delta;
  T *dq, *dk, *dv;
  int B, Sq, Sk, H, KV;
  float scale;
};

template <class T, int HD>
constexpr int any_smem() {
  return 4 * ANY_ROWS * tile_ld<T, HD>() * (int)sizeof(T);
}

template <class T, int HD>
__global__ void __launch_bounds__(ANY_THREADS) flash_bwd_dq_any_kernel(const AnyArgs<T> a) {
  constexpr int LD = tile_ld<T, HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* dos = qs + ANY_ROWS * LD;
  T* ks = dos + ANY_ROWS * LD;
  T* vs = ks + ANY_ROWS * LD;
  __shared__ int kpos[ANY_ROWS];
  __shared__ float rdel[ANY_ROWS];
  __shared__ int lim[3];  // greatest query position; least key position by tile parity
  const int n_qt = (a.Sq + ANY_ROWS - 1) / ANY_ROWS, n_kt = (a.Sk + ANY_ROWS - 1) / ANY_ROWS;
  const int rest = a.H * a.B;
  const int qt = n_qt - 1 - blockIdx.x / rest;
  const int h = blockIdx.x % rest % a.H, b = blockIdx.x % rest / a.H;
  const int kvh = h / (a.H / a.KV), q0 = qt * ANY_ROWS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int row0 = 16 * warp;
  const size_t head_row = (size_t)b * a.H + h;
  auto qrow = [&](const T* base) {
    return [=](int r) {
      return q0 + r < a.Sq ? base + (((size_t)b * a.Sq + q0 + r) * a.H + h) * HD : nullptr;
    };
  };

  if (tid == 0) lim[0] = INT_MIN;
  stage_rows<T>(qs, LD, ANY_ROWS, HD, qrow(a.q), tid, ANY_THREADS);
  stage_rows<T>(dos, LD, ANY_ROWS, HD, qrow(a.dO), tid, ANY_THREADS);
  __syncthreads();
  if (tid < ANY_ROWS) atomicMax(&lim[0], query_pos(a.pos_q, b, q0 + tid, a.Sq));
  // delta = rowsum(o * dO) in f32: two threads a row
  {
    const int r = tid / 2, sq = q0 + r;
    float d = 0.f;
    if (sq < a.Sq) {
      const T* orow = a.o + (((size_t)b * a.Sq + sq) * a.H + h) * HD;
      for (int c = tid % 2; c < HD; c += 2) d = fmaf(to_f32(orow[c]), to_f32(dos[r * LD + c]), d);
    }
    d += __shfl_xor_sync(RLINF_FULL_MASK, d, 1);
    if (tid % 2 == 0) {
      rdel[r] = d;
      if (sq < a.Sq) a.delta[head_row * a.Sq + sq] = d;
    }
  }
  int rpos[2];
  float rlse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int sq = q0 + row0 + g + 8 * r;
    rpos[r] = query_pos(a.pos_q, b, sq, a.Sq);
    rlse2[r] = sq < a.Sq ? a.lse[head_row * a.Sq + sq] * LOG2E : 0.f;
  }
  __syncthreads();
  const int qmax = lim[0];
  const float rdelta[2] = {rdel[row0 + g], rdel[row0 + g + 8]};
  const float scale2 = a.scale * LOG2E;
  float dq[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * ANY_ROWS;
    int* kmin = &lim[1 + (kt & 1)];
    if (tid == 0) *kmin = INT_MAX;
    __syncthreads();  // the previous tile is read
    if (tid < ANY_ROWS) {
      kpos[tid] = key_pos(a.pos_kv, a.valid, b, k0 + tid, a.Sk);
      atomicMin(kmin, kpos[tid]);
    }
    __syncthreads();
    if (*kmin > qmax) continue;
    auto krow = [&](const T* base) {
      return [=](int r) {
        return k0 + r < a.Sk ? base + (((size_t)b * a.Sk + k0 + r) * a.KV + kvh) * HD : nullptr;
      };
    };
    stage_rows<T>(ks, LD, ANY_ROWS, HD, krow(a.k), tid, ANY_THREADS);
    stage_rows<T>(vs, LD, ANY_ROWS, HD, krow(a.v), tid, ANY_THREADS);
    __syncthreads();
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const FragA qa = frag_a<T>(qs, LD, row0, 16 * kk, lane);
      const FragA da = frag_a<T>(dos, LD, row0, 16 * kk, lane);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        mma_ab<T>(s[nt], qa, frag_bt<T>(ks, LD, 8 * nt, 16 * kk, lane));
        mma_ab<T>(dp[nt], da, frag_bt<T>(vs, LD, 8 * nt, 16 * kk, lane));
      }
    }
    // s[nt][2 r + e]: row g + 8 r, key 8 nt + 2 t + e -> ds
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * r + e;
          const float p = kpos[8 * nt + 2 * t + e] <= rpos[r] ? exp2f(s[nt][i] * scale2 - rlse2[r]) : 0.f;
          s[nt][i] = p * (dp[nt][i] - rdelta[r]) * a.scale;
        }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const FragA df = frag_acc<T>(s[2 * u], s[2 * u + 1]);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) mma_pb<T>(dq[n], df, frag_b<T>(ks, LD, 16 * u, 8 * n, lane));
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int sq = q0 + row0 + g + 8 * r;
    if (sq >= a.Sq) continue;
    T* out = a.dq + (((size_t)b * a.Sq + sq) * a.H + h) * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      out[8 * n] = Elem<T>::put(dq[n][2 * r]);
      out[8 * n + 1] = Elem<T>::put(dq[n][2 * r + 1]);
    }
  }
}

template <class T, int HD>
__global__ void __launch_bounds__(ANY_THREADS) flash_bwd_dkv_any_kernel(const AnyArgs<T> a) {
  constexpr int LD = tile_ld<T, HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + ANY_ROWS * LD;
  T* qs = vs + ANY_ROWS * LD;
  T* dos = qs + ANY_ROWS * LD;
  __shared__ int qpos[ANY_ROWS];
  __shared__ float qlse2[ANY_ROWS], qdel[ANY_ROWS];
  __shared__ int lim[3];  // least key position; greatest query position by tile parity
  const int n_kt = (a.Sk + ANY_ROWS - 1) / ANY_ROWS, n_qt = (a.Sq + ANY_ROWS - 1) / ANY_ROWS;
  const int G = a.H / a.KV, kt = blockIdx.x % n_kt;
  const int kvh = blockIdx.x / n_kt % a.KV, b = blockIdx.x / n_kt / a.KV;
  const int k0 = kt * ANY_ROWS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int row0 = 16 * warp;
  auto krow = [&](const T* base) {
    return [=](int r) {
      return k0 + r < a.Sk ? base + (((size_t)b * a.Sk + k0 + r) * a.KV + kvh) * HD : nullptr;
    };
  };
  if (tid == 0) lim[0] = INT_MAX;
  stage_rows<T>(ks, LD, ANY_ROWS, HD, krow(a.k), tid, ANY_THREADS);
  stage_rows<T>(vs, LD, ANY_ROWS, HD, krow(a.v), tid, ANY_THREADS);
  __syncthreads();
  if (tid < ANY_ROWS) atomicMin(&lim[0], key_pos(a.pos_kv, a.valid, b, k0 + tid, a.Sk));
  int cpos[2];  // the warp's rows g, g + 8 are keys
#pragma unroll
  for (int r = 0; r < 2; ++r) cpos[r] = key_pos(a.pos_kv, a.valid, b, k0 + row0 + g + 8 * r, a.Sk);
  __syncthreads();
  const int kmin = lim[0];
  const float scale2 = a.scale * LOG2E;
  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  int it = 0;
  for (int hg = 0; hg < G; ++hg) {
    const int h = kvh * G + hg;
    const size_t head_row = (size_t)b * a.H + h;
    for (int qt = 0; qt < n_qt; ++qt, ++it) {
      const int q0 = qt * ANY_ROWS;
      int* qmax = &lim[1 + (it & 1)];
      if (tid == 0) *qmax = INT_MIN;
      __syncthreads();  // the previous tile is read
      if (tid < ANY_ROWS) {
        const int sq = q0 + tid;
        qpos[tid] = query_pos(a.pos_q, b, sq, a.Sq);
        qlse2[tid] = sq < a.Sq ? a.lse[head_row * a.Sq + sq] * LOG2E : 0.f;
        qdel[tid] = sq < a.Sq ? a.delta[head_row * a.Sq + sq] : 0.f;
        atomicMax(qmax, qpos[tid]);
      }
      __syncthreads();
      if (*qmax < kmin) continue;
      auto qrow = [&](const T* base) {
        return [=](int r) {
          return q0 + r < a.Sq ? base + (((size_t)b * a.Sq + q0 + r) * a.H + h) * HD : nullptr;
        };
      };
      stage_rows<T>(qs, LD, ANY_ROWS, HD, qrow(a.q), tid, ANY_THREADS);
      stage_rows<T>(dos, LD, ANY_ROWS, HD, qrow(a.dO), tid, ANY_THREADS);
      __syncthreads();
      // S^T = K Q^T and dP^T = V dO^T: rows keys, columns queries
      float s[8][4], dp[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const FragA ka = frag_a<T>(ks, LD, row0, 16 * kk, lane);
        const FragA va = frag_a<T>(vs, LD, row0, 16 * kk, lane);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          mma_ab<T>(s[nt], ka, frag_bt<T>(qs, LD, 8 * nt, 16 * kk, lane));
          mma_ab<T>(dp[nt], va, frag_bt<T>(dos, LD, 8 * nt, 16 * kk, lane));
        }
      }
      // s[nt][2 r + e]: key g + 8 r, query 8 nt + 2 t + e -> p^T in s, dS^T in dp
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 2 * r + e, c = 8 * nt + 2 * t + e;
            const float p = cpos[r] <= qpos[c] ? exp2f(s[nt][i] * scale2 - qlse2[c]) : 0.f;
            s[nt][i] = p;
            dp[nt][i] = p * (dp[nt][i] - qdel[c]) * a.scale;
          }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const FragA pf = frag_acc<T>(s[2 * u], s[2 * u + 1]);
        const FragA df = frag_acc<T>(dp[2 * u], dp[2 * u + 1]);
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          mma_pb<T>(dv[n], pf, frag_b<T>(dos, LD, 16 * u, 8 * n, lane));
          mma_pb<T>(dk[n], df, frag_b<T>(qs, LD, 16 * u, 8 * n, lane));
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int sk = k0 + row0 + g + 8 * r;
    if (sk >= a.Sk) continue;
    const size_t at = (((size_t)b * a.Sk + sk) * a.KV + kvh) * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      a.dk[at + 8 * n] = Elem<T>::put(dk[n][2 * r]);
      a.dk[at + 8 * n + 1] = Elem<T>::put(dk[n][2 * r + 1]);
      a.dv[at + 8 * n] = Elem<T>::put(dv[n][2 * r]);
      a.dv[at + 8 * n + 1] = Elem<T>::put(dv[n][2 * r + 1]);
    }
  }
}

template <class T, int HD>
cudaError_t launch_any(const AnyArgs<T>& a, bool dq, cudaStream_t st) {
  constexpr int smem = any_smem<T, HD>();
  auto kernel = dq ? flash_bwd_dq_any_kernel<T, HD> : flash_bwd_dkv_any_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles = dq ? (a.Sq + ANY_ROWS - 1) / ANY_ROWS * a.H : (a.Sk + ANY_ROWS - 1) / ANY_ROWS * a.KV;
  kernel<<<tiles * a.B, ANY_THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

// Element type T at head dim HD: 16 and 32 for every type, 64 and 128 for
// f32 (bf16 and f16 take the wgmma kernels there).
template <class T>
cudaError_t run_any(const Args& raw, int HD, bool dq, cudaStream_t st) {
  const AnyArgs<T> a{reinterpret_cast<const T*>(raw.q), reinterpret_cast<const T*>(raw.k),
                     reinterpret_cast<const T*>(raw.v), reinterpret_cast<const T*>(raw.o),
                     reinterpret_cast<const T*>(raw.dO), raw.pos_q, raw.pos_kv, raw.valid,
                     raw.lse, raw.delta, reinterpret_cast<T*>(raw.dq),
                     reinterpret_cast<T*>(raw.dk), reinterpret_cast<T*>(raw.dv), raw.B, raw.Sq,
                     raw.Sk, raw.H, raw.KV, raw.scale};
  if (HD == 16) return launch_any<T, 16>(a, dq, st);
  if (HD == 32) return launch_any<T, 32>(a, dq, st);
  if constexpr (std::is_same<T, float>::value) {
    if (HD == 64) return launch_any<T, 64>(a, dq, st);
    if (HD == 128) return launch_any<T, 128>(a, dq, st);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// K7 (DQ) or K8 with the maps of its tiles: the resident ones a CTA's rows
// a box, the streamed ones STEP.
template <int HD, bool DQ, bool F16>
cudaError_t launch(const Args& a, cudaStream_t st) {
  using T = typename std::conditional<F16, __half, __nv_bfloat16>::type;
  constexpr CUtensorMapDataType type = Elem<T>::MAP;
  constexpr int ROWS = DQ ? DQ_ROWS : DKV_ROWS;
  const int q_rows = DQ ? ROWS : STEP, kv_rows = DQ ? STEP : ROWS;
  CUtensorMap tq, tdo, tk, tv;
  if (!head_map(&tq, a.q, a.B, a.Sq, a.H, HD, q_rows, type) ||
      !head_map(&tdo, a.dO, a.B, a.Sq, a.H, HD, q_rows, type) ||
      !head_map(&tk, a.k, a.B, a.Sk, a.KV, HD, kv_rows, type) ||
      !head_map(&tv, a.v, a.B, a.Sk, a.KV, HD, kv_rows, type))
    return cudaErrorInvalidValue;
  auto kernel = [] {
    if constexpr (DQ) return flash_bwd_dq_kernel<HD, F16>;
    else return flash_bwd_dkv_kernel<HD, F16>;
  }();
  constexpr int smem = DQ ? smem_bytes<HD, DQ_ROWS, DQ_RING>() : smem_bytes<HD, DKV_ROWS, DKV_RING>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles = DQ ? (a.Sq + ROWS - 1) / ROWS * a.H : (a.Sk + ROWS - 1) / ROWS * a.KV;
  kernel<<<tiles * a.B, DQ ? DQ_THREADS : DKV_THREADS, smem, st>>>(tq, tdo, tk, tv, a);
  return cudaGetLastError();
}

int run(const Args& a, int HD, int dtype, bool dq, void* stream) {
  if (a.B < 1 || a.Sq < 1 || a.Sk < 1 || a.KV < 1 || a.H % a.KV || !aligned16(a.q) ||
      !aligned16(a.k) || !aligned16(a.v) || !aligned16(a.dO) || (dq && !aligned16(a.o)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype < 0 || dtype > 2) return cudaErrorInvalidValue;
  if (dtype == 2) return run_any<float>(a, HD, dq, st);
  if (HD != 64 && HD != 128)
    return dtype == 1 ? run_any<__half>(a, HD, dq, st) : run_any<__nv_bfloat16>(a, HD, dq, st);
  if (dtype == 1) {
    if (HD == 128) return dq ? launch<128, true, true>(a, st) : launch<128, false, true>(a, st);
    return dq ? launch<64, true, true>(a, st) : launch<64, false, true>(a, st);
  }
  if (HD == 128) return dq ? launch<128, true, false>(a, st) : launch<128, false, false>(a, st);
  return dq ? launch<64, true, false>(a, st) : launch<64, false, false>(a, st);
}

}  // namespace

// K7. q, o, dO [B, Sq, H, HD]; k, v [B, Sk, KV, HD], all of element type
// `dtype` (0 bf16, 1 f16, 2 f32); pos_q [B, Sq], pos_kv [B, Sk] int32;
// valid [B, Sk] uint8; lse [B, H, Sq] f32. Writes delta [B, H, Sq] f32
// (K8's input) and dq [B, Sq, H, HD] in the same type. HD is 16, 32, 64 or
// 128 (bf16 and f16 at 64 and 128: the wgmma kernels, f16 on their f16
// form; else mma.sync); tensors contiguous and 16-byte aligned.
extern "C" int flash_attention_bwd_dq(int device, const void* q, const void* k, const void* v,
                                      const void* pos_q, const void* pos_kv, const void* valid,
                                      const void* o, const void* dO, const void* lse,
                                      void* delta, void* dq, int B, int Sq, int Sk, int H,
                                      int KV, int HD, int dtype, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
         static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(o),
         static_cast<const __nv_bfloat16*>(dO), static_cast<const int*>(pos_q),
         static_cast<const int*>(pos_kv), static_cast<const uint8_t*>(valid),
         static_cast<const float*>(lse), static_cast<float*>(delta),
         static_cast<__nv_bfloat16*>(dq), nullptr, nullptr, B, Sq, Sk, H, KV, scale};
  return run(a, HD, dtype, true, stream);
}

// K8. As K7, with delta [B, H, Sq] f32 as K7 wrote it (launched after K7 on
// the same stream); dk, dv [B, Sk, KV, HD] in the inputs' type.
extern "C" int flash_attention_bwd_dkv(int device, const void* q, const void* k, const void* v,
                                       const void* pos_q, const void* pos_kv,
                                       const void* valid, const void* dO, const void* lse,
                                       const void* delta, void* dk, void* dv, int B, int Sq,
                                       int Sk, int H, int KV, int HD, int dtype,
                                       float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
         static_cast<const __nv_bfloat16*>(v), nullptr,
         static_cast<const __nv_bfloat16*>(dO), static_cast<const int*>(pos_q),
         static_cast<const int*>(pos_kv), static_cast<const uint8_t*>(valid),
         static_cast<const float*>(lse), const_cast<float*>(static_cast<const float*>(delta)),
         nullptr, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), B, Sq, Sk,
         H, KV, scale};
  return run(a, HD, dtype, false, stream);
}
