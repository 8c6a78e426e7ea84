// Kernel K1: causal grouped-query flash-attention forward (prefill and the
// forward of training).
//
// Replaces the Pallas TPU kernel _fwd_kernel of
// rlinf_tpu/ops/pallas/flash_attention.py (pallas_call in _fwd_call), the
// forward of flash_attention(). Same function: out = softmax(q k^T * scale)
// v under the mask (pos_kv <= pos_q) AND kv_valid, online softmax in f32,
// and the log-sum-exp of every query row (the backward, K7/K8, reads it).
// Masked keys get probability 0 explicitly, so a query row with no valid
// key gives 0 (the Pallas kernel averages the blocks it visited); rows
// with a valid key agree. Positions are arbitrary [B, S] int32: left-padded
// prompts give pad slots position 0.
//
// What bounds it on an H100: bytes. At the prefill shapes (B=64, S=512,
// H=12, Kv=2, Hd=128) and the training microbatch (B=16, T=768) q and o
// dominate the traffic (k and v are 1/6 of q under GQA), and the products
// of the unmasked pairs, 4 Hd operations a pair and head, take less time at
// the tensor cores' peak than those bytes at the memory's. So the design
// keeps the memory busy from the first cycle: nothing is loaded by a
// thread, every tile comes in by TMA while the products of the previous
// one run, and the softmax of one warpgroup runs under the other's
// products.
//
// Design, in the way of flash-attention 3's forward (and of K7/K8 in
// flash_attention_bwd.cu, whose tile layouts and descriptors it shares):
//  * One CTA per (batch row, query head, 128-row query tile): two consumer
//    warpgroups of 64 query rows and a producer warpgroup (384 threads,
//    setmaxnreg 40 / 232, one CTA an SM). The grid launches the late query
//    tiles, which see the most keys, first.
//  * The producer loads the Q tile once (3-D tensor maps over (head
//    columns, sequence, batch row), boxes of 64 columns in the 128-byte
//    swizzle: a ragged tile reads zeros, never the next batch row) and
//    streams the (K, V) tiles of 64 keys of the kv head (h / (H / Kv): GQA
//    shares k/v through the cache) through a ring of four stages under
//    mbarriers. A CTA's first microseconds are a chain of waits, so the
//    producer issues Q's copy first, loads the query positions and the
//    first tile's key positions (position and validity) all at once, and
//    reads each next tile's while it waits for a free stage; the tensor
//    maps are prefetched. A key tile whose least valid position exceeds the
//    query tile's greatest position is never loaded (the _block_bounds rule
//    of the Pallas kernel). Both warpgroups compute every stage: each
//    step's wgmma sequence is then the same straight line (the first step
//    issues no P V, the last no S), which ptxas keeps asynchronous.
//  * A consumer runs S = Q K^T as SS wgmma m64n64k16 (both K-major in
//    shared memory), the masked online softmax in its registers (exp2, the
//    row max over the four lanes of a row, the row sum kept per lane until
//    the end), and O += P V as RS wgmma m64nHDk16: P is the register A
//    operand (the accumulator fragment of S is wgmma's A fragment) and V
//    the ring's tile read MN-major with the transpose bit.
//  * Intra- and inter-warpgroup overlap: each step issues S of key tile j
//    and P V of tile j - 1 together, and forms p of tile j while P V still
//    runs. Two named barriers order the two warpgroups' issues (ping-pong):
//    one warpgroup's softmax runs while the other's products use the
//    tensor cores.
//  * Accuracy: P enters P V as two bf16 parts, hi = bf16(p) and lo =
//    bf16(p - hi), two RS products a step, so the forward keeps the
//    accuracy of an f32 P (on an H100, rounding P to bf16 alone doubled the
//    error against the plain version and moved a small whole train step's
//    update by 9% of its norm). The second product runs under the memory
//    time at the path's shapes.
//  * The epilogue reduces each row's sum over its four lanes, scales by 1/l
//    and writes o in bf16 and lse = m ln 2 + ln l in f32.
//  * f16 operands run the same design on the f16 form of the same wgmma
//    instructions (flash_fwd_kernel<HD, true>: f16 tensor maps, P in f16
//    parts, o in f16). Heads of 16 and 32, and f32 operands, take the
//    mma.sync kernel further down (flash_fwd_any_kernel).

#include "hopper.cuh"

namespace {

constexpr int BQ = 128;       // query rows of a CTA: two consumer warpgroups of 64
constexpr int BK = 64;        // keys of a stage
constexpr int RING = 4;       // stages of (K, V)
constexpr int THREADS = 384;  // a producer warpgroup and two consumer warpgroups
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Bytes of dynamic shared memory: the Q tile (boxes of 64 columns x BQ
// rows), then the ring, each stage a K and a V tile of BK rows; and room to
// align to 1024 bytes (the swizzle atom).
template <int HD>
constexpr int smem_bytes() {
  return 1024 + (HD / 64) * (BQ / 64) * GMMA_BOX + RING * 2 * (HD / 64) * GMMA_BOX;
}

struct Meta {
  uint64_t full[RING], empty[RING], resident;
  int kpos[RING][BK];  // key position, INT_MAX where invalid or past Sk
  int tile[RING];      // key tile of the stage; -1 ends the stream
};

// Scheduler barriers of the ping-pong: warpgroup c waits on 3 + c until the
// other has issued its products, and lets the other go with an arrival on
// 3 + (1 - c). 256 threads: the waiting warpgroup and the arriving one.
__device__ __forceinline__ void sched_wait(int c) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(3 + c) : "memory");
}

__device__ __forceinline__ void sched_pass(int c) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(3 + (1 - c)) : "memory");
}

// p = x as pairs of T (bf16 or f16) hi = T(x) and lo = T(x - hi), in
// wgmma's A fragment order (k16 step u takes accumulator groups j = 2 u,
// 2 u + 1).
template <class T>
__device__ __forceinline__ void split_frag(const float (&x)[32], uint32_t (&hi)[4][4],
                                           uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      Elem<T>::parts(x[8 * u + 2 * q], x[8 * u + 2 * q + 1], hi[u][q], lo[u][q]);
}

// The masked online softmax of one key tile, in place: s (the 64 x 64
// accumulator, d[4 j + 2 r + e] = row 16 warp + g + 8 r, key 8 j + 2 t + e)
// -> p = exp2(s scale2 - m) where the key is visible to the row, else 0; m
// and the lane's part of l move on, alpha = exp2(m_old - m_new) is what O
// must be scaled by.
__device__ __forceinline__ void online_softmax(float (&s)[32], const int* kp, const int (&rpos)[2],
                                               float (&m)[2], float (&l)[2], float scale2, int t,
                                               float (&alpha)[2]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int2 cp = *reinterpret_cast<const int2*>(kp + 8 * j + 2 * t);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * r + e;
        s[i] = (e ? cp.y : cp.x) <= rpos[r] ? s[i] * scale2 : RLINF_NEG_INF;
        mx[r] = fmaxf(mx[r], s[i]);
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(RLINF_FULL_MASK, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(RLINF_FULL_MASK, mx[r], 2));
    alpha[r] = exp2f(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int2 cp = *reinterpret_cast<const int2*>(kp + 8 * j + 2 * t);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * r + e;
        s[i] = (e ? cp.y : cp.x) <= rpos[r] ? exp2f(s[i] - m[r]) : 0.f;
        l[r] += s[i];
      }
  }
}

struct Args {
  const __nv_bfloat16 *q, *k, *v;
  const int *pos_q, *pos_kv;
  const uint8_t* valid;
  __nv_bfloat16* out;
  float* lse;
  int B, Sq, Sk, H, KV;
  float scale;
};

// F16: f16 operands and output on the f16 form of the same wgmma
// instructions (the same fragment layouts), else bf16.
template <int HD, bool F16>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const Args a) {
  using T = typename std::conditional<F16, __half, __nv_bfloat16>::type;
  constexpr int NB = HD / 64;                  // 64-column boxes of a row
  constexpr int QTILE = NB * (BQ / 64) * GMMA_BOX;
  constexpr int TILE = NB * GMMA_BOX;          // bytes of a 64-row K or V tile
  extern __shared__ unsigned char smem_raw[];
  __shared__ Meta meta;
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, ring = base + QTILE;
  const int n_qt = (a.Sq + BQ - 1) / BQ, n_kt = (a.Sk + BK - 1) / BK;
  const int rest = a.H * a.B;
  const int qt = n_qt - 1 - blockIdx.x / rest;  // heavy (late) query tiles first
  const int h = blockIdx.x % rest % a.H, b = blockIdx.x % rest / a.H;
  const int kvh = h / (a.H / a.KV), q0 = qt * BQ;
  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (const CUtensorMap* m : {&tm_q, &tm_k, &tm_v})
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(m)) : "memory");
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
    if (lane == 0) {  // Q first: it waits on nothing
      const uint32_t bar = smem_u32(&meta.resident);
      mbar_expect_tx(bar, QTILE);
      for (int j = 0; j < NB; ++j) tma_load_3d(q_s + j * BQ * 128, &tm_q, bar, h * HD + 64 * j, q0, b);
    }
    // a key's position with both loads in flight at once (INT_MAX where
    // invalid or past Sk); the query and first key positions load together
    auto key_at = [&](int s) {
      if (s >= a.Sk) return INT_MAX;
      const size_t at = (size_t)b * a.Sk + s;
      const int p = a.pos_kv[at];
      return a.valid[at] ? p : INT_MAX;
    };
    int e0 = key_at(lane), e1 = key_at(lane + 32);
    int qmax = INT_MIN;
    for (int r = lane; r < BQ; r += 32) qmax = max(qmax, query_pos(a.pos_q, b, q0 + r, a.Sq));
    qmax = warp_max(qmax);
    int it = 0;
    for (int kt = 0; kt < n_kt; ++kt) {
      const int c0 = e0, c1 = e1;
      if (kt + 1 < n_kt) {  // the next tile's positions, read while this one waits
        e0 = key_at((kt + 1) * BK + lane);
        e1 = key_at((kt + 1) * BK + lane + 32);
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
          tma_load_3d(k_s + j * GMMA_BOX, &tm_k, bar, kvh * HD + 64 * j, kt * BK, b);
          tma_load_3d(k_s + TILE + j * GMMA_BOX, &tm_v, bar, kvh * HD + 64 * j, kt * BK, b);
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

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1, g = lane / 4, t = lane % 4;
  const float scale2 = a.scale * LOG2E;
  int rpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) rpos[r] = query_pos(a.pos_q, b, q0 + 64 * c + 16 * warp + g + 8 * r, a.Sq);
  mbar_wait(smem_u32(&meta.resident), 0);

  // rows 16 warp + g (index 0) and + 8 (index 1) of the warpgroup's 64
  float m[2] = {RLINF_NEG_INF, RLINF_NEG_INF}, l[2] = {0.f, 0.f};
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  uint32_t ph[4][4], pl[4][4];  // p of the held stage, hi and lo parts
  float s[32];
  const uint64_t desc_q = kmajor(q_s, 64 * c);
  auto issue_s = [&](int st) {  // S = Q K^T of stage st
    const uint64_t desc_k = kmajor(ring + st * 2 * TILE, 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<64, 0, F16>(s, desc_q + kstep(BQ, kk), desc_k + kstep(BK, kk), kk > 0);
    wgmma_commit();
  };
  auto issue_pv = [&](int st) {  // O += P V of stage st, p in two parts
    const uint64_t desc_v = mnmajor(ring + st * 2 * TILE + TILE);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      wgmma_rs<HD, 1, F16>(o, ph[u], desc_v + mnstep(u), 1);
      wgmma_rs<HD, 1, F16>(o, pl[u], desc_v + mnstep(u), 1);
    }
    wgmma_commit();
  };
  auto pv_done = [&](int st) {  // after the wait: O is in, stage st is free
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);
    if (lane == 0) mbar_arrive(smem_u32(&meta.empty[st]));
  };

  mbar_wait(smem_u32(&meta.full[0]), 0);
  if (meta.tile[0] >= 0) {  // else no key tile: o stays 0
    if (c == 1) sched_pass(c);  // warpgroup 0 issues first
    sched_wait(c);
    wgmma_fence();
    issue_s(0);
    sched_pass(c);
    wgmma_wait<0>();
    fence_regs(s);
    float alpha[2];  // o is still 0
    online_softmax(s, meta.kpos[0], rpos, m, l, scale2, t, alpha);
    split_frag<T>(s, ph, pl);
    int pend = 0;  // the stage whose V the held p multiplies
    for (int it = 1;; ++it) {
      const int st = it % RING;
      mbar_wait(smem_u32(&meta.full[st]), (it / RING) & 1);
      if (meta.tile[st] < 0) break;
      sched_wait(c);
      wgmma_fence();
      issue_s(st);
      issue_pv(pend);
      sched_pass(c);
      wgmma_wait<1>();  // S is in; P V may still run while p is formed
      fence_regs(s);
      online_softmax(s, meta.kpos[st], rpos, m, l, scale2, t, alpha);
      wgmma_wait<0>();
      pv_done(pend);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          o[4 * j + 2 * r] *= alpha[r];
          o[4 * j + 2 * r + 1] *= alpha[r];
        }
      split_frag<T>(s, ph, pl);
      pend = st;
    }
    sched_wait(c);
    wgmma_fence();
    issue_pv(pend);
    if (c == 0) sched_pass(c);  // warpgroup 1's last arrival would have no waiter
    wgmma_wait<0>();
    pv_done(pend);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(RLINF_FULL_MASK, sum, 1);
    sum += __shfl_xor_sync(RLINF_FULL_MASK, sum, 2);
    const int sq = q0 + 64 * c + 16 * warp + g + 8 * r;
    if (sq >= a.Sq) continue;
    const float ls = fmaxf(sum, 1e-30f), inv = 1.f / ls;
    T* orow = reinterpret_cast<T*>(a.out) + (((size_t)b * a.Sq + sq) * a.H + h) * HD + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          Elem<T>::pack(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    // a row that saw no valid key keeps m = NEG_INF, as the plain version's max
    if (t == 0)
      a.lse[((size_t)b * a.H + h) * a.Sq + sq] =
          (m[r] == RLINF_NEG_INF ? RLINF_NEG_INF : m[r] * LN2) + logf(ls);
  }
}

// ---------------------------------------------------------------------------
// Head dims 16 and 32, and f16 and f32 operands: mma.sync
// ---------------------------------------------------------------------------
//
// The TMA boxes and wgmma descriptors above cut a row into 64-column boxes
// in the 128-byte swizzle of bf16; a row of 16 or 32 bf16 columns, or of
// f32, does not fit them. This kernel computes the same function on
// mma.sync (hopper.cuh's tiles of any element type): one CTA per (batch
// row, query head, 64-row query tile), four warps of 16 query rows, each
// holding its rows' Q fragments in registers. Per 64-key tile the CTA
// stages K and V in shared memory (16-byte loads, rows padded against bank
// conflicts), each warp forms S = Q K^T, the same masked online softmax in
// f32, and O += P V with P as hi and lo parts. Key tiles whose least valid
// position exceeds the query tile's greatest are skipped, as above.
constexpr int ANY_BQ = 64, ANY_BK = 64, ANY_THREADS = 128;

template <class T>
struct AnyArgs {
  const T *q, *k, *v;
  const int *pos_q, *pos_kv;
  const uint8_t* valid;
  T* out;
  float* lse;
  int B, Sq, Sk, H, KV;
  float scale;
};

template <class T, int HD>
constexpr int any_smem() {
  return 3 * ANY_BK * tile_ld<T, HD>() * (int)sizeof(T);
}

template <class T, int HD>
__global__ void __launch_bounds__(ANY_THREADS) flash_fwd_any_kernel(const AnyArgs<T> a) {
  constexpr int LD = tile_ld<T, HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + ANY_BQ * LD;
  T* vs = ks + ANY_BK * LD;
  __shared__ int kpos[ANY_BK];
  // the query tile's greatest position; the key tile's least, in two slots
  // by tile parity (a thread may still read the last tile's)
  __shared__ int lim[3];
  const int n_qt = (a.Sq + ANY_BQ - 1) / ANY_BQ, n_kt = (a.Sk + ANY_BK - 1) / ANY_BK;
  const int rest = a.H * a.B;
  const int qt = n_qt - 1 - blockIdx.x / rest;  // heavy (late) query tiles first
  const int h = blockIdx.x % rest % a.H, b = blockIdx.x % rest / a.H;
  const int kvh = h / (a.H / a.KV), q0 = qt * ANY_BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int row0 = 16 * warp;

  if (tid == 0) lim[0] = INT_MIN;
  stage_rows<T>(qs, LD, ANY_BQ, HD, [&](int r) {
    return q0 + r < a.Sq ? a.q + (((size_t)b * a.Sq + q0 + r) * a.H + h) * HD : nullptr;
  }, tid, ANY_THREADS);
  __syncthreads();
  if (tid < ANY_BQ) atomicMax(&lim[0], query_pos(a.pos_q, b, q0 + tid, a.Sq));
  FragA qf[HD / 16];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) qf[kk] = frag_a<T>(qs, LD, row0, 16 * kk, lane);
  int rpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) rpos[r] = query_pos(a.pos_q, b, q0 + row0 + g + 8 * r, a.Sq);
  __syncthreads();
  const int qmax = lim[0];

  const float scale2 = a.scale * LOG2E;
  float m[2] = {RLINF_NEG_INF, RLINF_NEG_INF}, l[2] = {0.f, 0.f};
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * ANY_BK;
    int* kmin = &lim[1 + (kt & 1)];
    if (tid == 0) *kmin = INT_MAX;
    __syncthreads();  // the previous tile is read
    if (tid < ANY_BK) {
      kpos[tid] = key_pos(a.pos_kv, a.valid, b, k0 + tid, a.Sk);
      atomicMin(kmin, kpos[tid]);
    }
    __syncthreads();
    if (*kmin > qmax) continue;  // no key of the tile is visible to any row
    auto krow = [&](const T* base) {
      return [=](int r) {
        return k0 + r < a.Sk ? base + (((size_t)b * a.Sk + k0 + r) * a.KV + kvh) * HD : nullptr;
      };
    };
    stage_rows<T>(ks, LD, ANY_BK, HD, krow(a.k), tid, ANY_THREADS);
    stage_rows<T>(vs, LD, ANY_BK, HD, krow(a.v), tid, ANY_THREADS);
    __syncthreads();
    float s[ANY_BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < ANY_BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) mma_ab<T>(s[nt], qf[kk], frag_bt<T>(ks, LD, 8 * nt, 16 * kk, lane));
    }
    // s[nt][2 r + e]: row g + 8 r, key 8 nt + 2 t + e
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int nt = 0; nt < ANY_BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nt][2 * r + e];
          x = kpos[8 * nt + 2 * t + e] <= rpos[r] ? x * scale2 : RLINF_NEG_INF;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(RLINF_FULL_MASK, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(RLINF_FULL_MASK, mx, 2));
      const float alpha = exp2f(m[r] - mx);
      m[r] = mx;
      l[r] *= alpha;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
#pragma unroll
      for (int nt = 0; nt < ANY_BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nt][2 * r + e];
          x = kpos[8 * nt + 2 * t + e] <= rpos[r] ? exp2f(x - mx) : 0.f;
          l[r] += x;
        }
    }
#pragma unroll
    for (int u = 0; u < ANY_BK / 16; ++u) {
      const FragA pf = frag_acc<T>(s[2 * u], s[2 * u + 1]);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) mma_pb<T>(o[n], pf, frag_b<T>(vs, LD, 16 * u, 8 * n, lane));
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(RLINF_FULL_MASK, sum, 1);
    sum += __shfl_xor_sync(RLINF_FULL_MASK, sum, 2);
    const int sq = q0 + row0 + g + 8 * r;
    if (sq >= a.Sq) continue;
    const float ls = fmaxf(sum, 1e-30f), inv = 1.f / ls;
    T* orow = a.out + (((size_t)b * a.Sq + sq) * a.H + h) * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      orow[8 * n] = Elem<T>::put(o[n][2 * r] * inv);
      orow[8 * n + 1] = Elem<T>::put(o[n][2 * r + 1] * inv);
    }
    if (t == 0)
      a.lse[((size_t)b * a.H + h) * a.Sq + sq] =
          (m[r] == RLINF_NEG_INF ? RLINF_NEG_INF : m[r] * LN2) + logf(ls);
  }
}

template <class T, int HD>
cudaError_t launch_any(const AnyArgs<T>& a, cudaStream_t st) {
  constexpr int smem = any_smem<T, HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_any_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (a.Sq + ANY_BQ - 1) / ANY_BQ * a.H;
  flash_fwd_any_kernel<T, HD><<<tiles * a.B, ANY_THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

// Element type T at head dim HD: 16 and 32 for every type, 64 and 128 for
// f32 (bf16 and f16 take the wgmma kernel there).
template <class T>
cudaError_t launch_any_hd(const AnyArgs<T>& a, int HD, cudaStream_t st) {
  if (HD == 16) return launch_any<T, 16>(a, st);
  if (HD == 32) return launch_any<T, 32>(a, st);
  if constexpr (std::is_same<T, float>::value) {
    if (HD == 64) return launch_any<T, 64>(a, st);
    if (HD == 128) return launch_any<T, 128>(a, st);
  }
  return cudaErrorInvalidValue;
}

template <class T>
cudaError_t run_any(const void* q, const void* k, const void* v, const void* pos_q,
                    const void* pos_kv, const void* valid, void* out, void* lse, int B, int Sq,
                    int Sk, int H, int KV, int HD, float scale, cudaStream_t st) {
  const AnyArgs<T> a{static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                     static_cast<const int*>(pos_q), static_cast<const int*>(pos_kv),
                     static_cast<const uint8_t*>(valid), static_cast<T*>(out),
                     static_cast<float*>(lse), B, Sq, Sk, H, KV, scale};
  return launch_any_hd<T>(a, HD, st);
}

template <int HD, bool F16>
cudaError_t launch(const Args& a, cudaStream_t st) {
  using T = typename std::conditional<F16, __half, __nv_bfloat16>::type;
  constexpr CUtensorMapDataType type = Elem<T>::MAP;
  CUtensorMap tq, tk, tv;
  if (!head_map(&tq, a.q, a.B, a.Sq, a.H, HD, BQ, type) ||
      !head_map(&tk, a.k, a.B, a.Sk, a.KV, HD, BK, type) ||
      !head_map(&tv, a.v, a.B, a.Sk, a.KV, HD, BK, type))
    return cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<HD, F16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (a.Sq + BQ - 1) / BQ * a.H;
  flash_fwd_kernel<HD, F16><<<tiles * a.B, THREADS, smem, st>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// q [B, Sq, H, HD], k/v [B, Sk, KV, HD] of element type `dtype` (0 bf16,
// 1 f16, 2 f32; 16-byte aligned); pos_q [B, Sq], pos_kv [B, Sk] int32;
// valid [B, Sk] uint8. Writes out [B, Sq, H, HD] in the same type and lse
// [B, H, Sq] f32. HD is 16, 32, 64 or 128: bf16 and f16 at 64 and 128 run
// the wgmma kernel (its f16 form for f16), everything else the mma.sync
// kernel.
extern "C" int flash_attention_fwd(int device, const void* q, const void* k,
                                   const void* v, const void* pos_q,
                                   const void* pos_kv, const void* valid,
                                   void* out, void* lse, int B, int Sq, int Sk,
                                   int H, int KV, int HD, int dtype, float scale,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV != 0 || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(out))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype < 0 || dtype > 2) return cudaErrorInvalidValue;
  if (dtype == 2 || (HD != 64 && HD != 128)) {
    if (dtype == 1)
      return run_any<__half>(q, k, v, pos_q, pos_kv, valid, out, lse, B, Sq, Sk, H, KV, HD, scale, st);
    if (dtype == 2)
      return run_any<float>(q, k, v, pos_q, pos_kv, valid, out, lse, B, Sq, Sk, H, KV, HD, scale, st);
    return run_any<__nv_bfloat16>(q, k, v, pos_q, pos_kv, valid, out, lse, B, Sq, Sk, H, KV, HD,
                                  scale, st);
  }
  const Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
               static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(pos_q),
               static_cast<const int*>(pos_kv), static_cast<const uint8_t*>(valid),
               static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), B, Sq, Sk, H, KV,
               scale};
  if (dtype == 1) return HD == 128 ? launch<128, true>(a, st) : launch<64, true>(a, st);
  return HD == 128 ? launch<128, false>(a, st) : launch<64, false>(a, st);
}
