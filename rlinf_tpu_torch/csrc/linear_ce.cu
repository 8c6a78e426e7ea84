// Kernels K5 and K6: fused linear cross-entropy, forward and backward.
//
// K5 replaces the Pallas TPU kernel _ce_fwd_kernel of
// rlinf_tpu/ops/pallas/linear_ce.py (pallas_call in _fused_ce_fwd_impl):
// per row of h [n, D] and the lm-head W ([D, V] "dv" or the tied [V, D]
// "vd"), the target logprob, the entropy and the log-sum-exp of
// softmax(h W / T), without writing the [n, V] logits. Pad columns are
// masked with the finite -2^30, as there.
//
// K6 replaces _ce_bwd_kernel (pallas_call in _fused_ce_bwd): it recomputes
// each logits tile, forms p = exp(x - lse) and
//   dx = g_lp (onehot - p) - g_ent p (x - mu),   mu = lse - entropy,
// writes dz = dx / T in bf16 [n, V_pad], and dh = dz W^T with an f32
// accumulator, emitted in bf16. The weight gradient dw = dz^T h stays a
// plain matrix product in the wrapper, as the JAX package leaves it to XLA.
//
// What bounds them on an H100: operations. At the training shapes (4096
// rows, D = 1536, V = 151936) K5 is one 1.91 TFLOP product against 0.47 GB
// of W; K6 is two such products plus 1.24 GB of dz written.
//
// K5 runs its products as warp-level mma.sync m16n8k16 bf16 tiles with f32
// accumulation: 8 warps of a CTA each own 32 x 32 outputs of a 64 x 128
// tile, fed from shared memory one 32-deep stage at a time while the next
// stage's global loads are in flight in registers. It gives each CTA 64 rows
// and one slice of the vocab: it walks the slice's 128-column tiles, keeps
// per-thread online statistics (max, sum of exp, sum of exp * x, target
// logit) in registers, merges them across the 4 lanes and the 4 warps that
// share a row at the end and writes one partial per (slice, row); a second
// pass merges the slices (the scheme of K4 in sampler.cu). Rows are the
// fastest grid dimension, so the CTAs in flight read the same W tiles and W
// comes from device memory about once.
//
// K6 runs on Hopper's asynchronous tensor cores: wgmma.mma_async
// m64n128k16 bf16 with f32 sums, both operands in shared memory in the
// 128-byte swizzle, brought in by TMA (cp.async.bulk.tensor.2d on a
// CUtensorMap) and tracked by mbarriers. One persistent CTA on each SM has a
// producer warpgroup and two consumer warpgroups (setmaxnreg 40 / 232); a
// consumer owns whole 128 x 128 output tiles, two m64 halves with 64 f32
// sums a thread each, and has its own three-stage ring fed by its own
// producer thread, so each (producer, consumer) pair is a plain pipeline.
// The CTA's tiles alternate between the two consumers: while one runs its
// epilogue the other's products keep the tensor cores busy. Two passes, as
// dw needs dz:
//   pass A: dz for each (128-row, 128-vocab-column) tile over K = D, rows
//     the fastest tile index so that the CTAs in flight share W tiles (W is
//     read from device memory about once, h stays in the L2); the epilogue
//     works on the accumulators and stores dz in bf16.
//   pass B: dh = dz W over K = V_pad, thin (4096 x 1536, 384 tiles) and
//     deep: the vocabulary is cut into s slices of whole 64-blocks
//     (ops/cuda/linear_ce.py dh_slices picks s so that tiles x s fill whole
//     rounds of the 264 consumers), each writes f32 partials, and a small
//     third launch adds them in slice order: deterministic, no atomics.
// The tied "vd" weight is k-contiguous as pass A's B operand and n-
// contiguous as pass B's, "dv" the other way round; an n-contiguous B tile
// is loaded as two 64-column TMA boxes and read with wgmma's transpose bit,
// not transposed by hand. TMA fills rows past n and columns past V with
// zeros; the epilogues mask them. TMA row strides are multiples of 16
// bytes, so the wrapper zero-pads the depth D to a multiple of 8 (a zero
// depth column changes no logit) and, for an untied [D, V] weight with
// V % 8 != 0, copies W into rows of a multiple of 8 and passes that row
// stride as ldw: the maps still read only V columns, so pad columns stay
// masked. The TMA, mbarrier and wgmma primitives are in hopper.cuh.

#include "hopper.cuh"

namespace {

constexpr int BM = 64;        // rows per CTA (the wrapper pads rows to a multiple)
constexpr int BN = 128;       // output columns per tile
constexpr int BK = 32;        // depth of one shared-memory stage (two k16 steps)
constexpr int NT = 256;       // 8 warps: 2 along M x 4 along N, 32 x 32 outputs each
constexpr int LDS = BK + 8;   // bf16 per shared row: fragment loads hit distinct banks

struct Tiles {
  __nv_bfloat16 a[BM][LDS];   // A tile, k contiguous
  __nv_bfloat16 b[BN][LDS];   // B tile as [n][k] (the "col" operand of mma)
};

// Per thread: acc[mi][ni][e] holds C(row, col) with
//   row = wm * 32 + mi * 16 + g + 8 * (e / 2),  col = wn * 32 + ni * 8 + 2 * t + e % 2,
// warp = wm * 4 + wn, g = lane / 4, t = lane % 4 (the m16n8 C fragment).
using Acc = float[2][4][4];

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

__device__ __forceinline__ int acc_row(int mi, int e) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp / 4) * 32 + mi * 16 + lane / 4 + 8 * (e / 2);
}

__device__ __forceinline__ int acc_col(int ni, int e) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp % 4) * 32 + ni * 8 + 2 * (lane % 4) + e % 2;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Eight consecutive bf16 of x starting at element i of a run of `avail`
// valid ones; 16-byte load when the run allows it and `vec` says the
// address is aligned.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* __restrict__ x, size_t i,
                                       int avail, bool vec) {
  if (vec && avail >= 8) return *reinterpret_cast<const uint4*>(x + i);
  __align__(16) __nv_bfloat16 v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = j < avail ? x[i + j] : __float2bfloat16(0.f);
  return *reinterpret_cast<const uint4*>(v);
}

// One stage held in registers: 8 bf16 of A and 2 x 8 bf16 of B per thread.
struct Stage {
  uint4 a, b[2];
};

// acc += A(m0.., k) B(k, n0..) over k < K. A(m, k) = A[(m0 + m) * lda + k]
// (every row valid). B(k, n) = KC ? Bp[n * ldb + k] : Bp[k * ldb + n],
// zero for n >= N or k >= K. vec: lda and ldb are multiples of 8 and the
// bases 16-byte aligned.
template <bool KC>
__device__ __forceinline__ void load_stage(Stage& st, const __nv_bfloat16* __restrict__ A,
                                           int lda, int m0, const __nv_bfloat16* __restrict__ Bp,
                                           int ldb, int n0, int N, int K, int k0, bool vec) {
  const int tid = threadIdx.x;
  {
    const int r = tid >> 2, c8 = (tid & 3) * 8;
    st.a = load8(A, (size_t)(m0 + r) * lda + k0 + c8, K - k0 - c8, vec);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int e = tid + NT * j;
    if (KC) {  // 128 rows n x 4 chunks along k
      const int n = e >> 2, c8 = (e & 3) * 8, col = n0 + n;
      st.b[j] = col < N ? load8(Bp, (size_t)col * ldb + k0 + c8, K - k0 - c8, vec)
                        : make_uint4(0, 0, 0, 0);
    } else {   // 32 rows k (lanes along k) x 16 chunks along n
      const int k = e & 31, n8 = (e >> 5) * 8, kk = k0 + k;
      st.b[j] = kk < K ? load8(Bp, (size_t)kk * ldb + n0 + n8, N - n0 - n8, vec)
                       : make_uint4(0, 0, 0, 0);
    }
  }
}

template <bool KC>
__device__ __forceinline__ void store_stage(const Stage& st, Tiles& sm) {
  const int tid = threadIdx.x;
  *reinterpret_cast<uint4*>(&sm.a[tid >> 2][(tid & 3) * 8]) = st.a;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int e = tid + NT * j;
    if (KC) {
      *reinterpret_cast<uint4*>(&sm.b[e >> 2][(e & 3) * 8]) = st.b[j];
    } else {
      const int k = e & 31, n8 = (e >> 5) * 8;
      const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&st.b[j]);
#pragma unroll
      for (int i = 0; i < 8; ++i) sm.b[n8 + i][k] = v[i];
    }
  }
}

__device__ __forceinline__ void mma_stage(const Tiles& sm, Acc& acc) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t af[2][4], bfr[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = wm * 32 + mi * 16 + g;
      af[mi][0] = *reinterpret_cast<const uint32_t*>(&sm.a[r][kk + 2 * t]);
      af[mi][1] = *reinterpret_cast<const uint32_t*>(&sm.a[r + 8][kk + 2 * t]);
      af[mi][2] = *reinterpret_cast<const uint32_t*>(&sm.a[r][kk + 2 * t + 8]);
      af[mi][3] = *reinterpret_cast<const uint32_t*>(&sm.a[r + 8][kk + 2 * t + 8]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int n = wn * 32 + ni * 8 + g;
      bfr[ni][0] = *reinterpret_cast<const uint32_t*>(&sm.b[n][kk + 2 * t]);
      bfr[ni][1] = *reinterpret_cast<const uint32_t*>(&sm.b[n][kk + 2 * t + 8]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni]);
  }
}

// The next stage's global loads are in flight while the tensor cores work
// on the current one (register double buffering).
template <bool KC>
__device__ __forceinline__ void tile_gemm(const __nv_bfloat16* __restrict__ A, int lda, int m0,
                                          const __nv_bfloat16* __restrict__ Bp, int ldb, int n0,
                                          int N, int K, bool vec, Tiles& sm, Acc& acc) {
  Stage st;
  load_stage<KC>(st, A, lda, m0, Bp, ldb, n0, N, K, 0, vec);
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // the previous stage is consumed
    store_stage<KC>(st, sm);
    __syncthreads();
    if (k0 + BK < K) load_stage<KC>(st, A, lda, m0, Bp, ldb, n0, N, K, k0 + BK, vec);
    mma_stage(sm, acc);
  }
}

// Online softmax statistics of one row: max m, s1 = sum e^(x-m),
// s2 = sum e^(x-m) x, and the target logit tl.
struct Stats {
  float m, s1, s2, tl;
};

__device__ __forceinline__ void merge(Stats& a, const Stats& b) {
  const float m = fmaxf(a.m, b.m);
  const float ea = expf(a.m - m), eb = expf(b.m - m);
  a.s1 = a.s1 * ea + b.s1 * eb;
  a.s2 = a.s2 * ea + b.s2 * eb;
  a.tl += b.tl;
  a.m = m;
}

template <bool KC>
__global__ void __launch_bounds__(NT) ce_fwd_kernel(
    const __nv_bfloat16* __restrict__ h, const __nv_bfloat16* __restrict__ w,
    const int* __restrict__ tgt, float* __restrict__ part, int n, int D, int V,
    int ldw, int n_vt, int n_split, float inv_temp, bool vec) {
  __shared__ __align__(16) Tiles sm;
  __shared__ Stats red[4][BM];  // per warp column, per row
  const int m0 = blockIdx.x * BM, split = blockIdx.y;
  const int t_begin = (int)((long long)split * n_vt / n_split);
  const int t_end = (int)((long long)(split + 1) * n_vt / n_split);

  // this thread's 4 rows: (mi, e / 2)
  int tg[2][2];
  Stats st[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      tg[mi][hh] = tgt[m0 + acc_row(mi, 2 * hh)];
      st[mi][hh] = Stats{RLINF_NEG_INF, 0.f, 0.f, 0.f};
    }
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int n0 = tile * BN;
    Acc acc;
    zero(acc);
    tile_gemm<KC>(h, D, m0, w, ldw, n0, V, D, vec, sm, acc);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        Stats& s = st[mi][hh];
        float x[8];
        float mx = s.m;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = n0 + acc_col(ni, c);
            const float v = col < V ? acc[mi][ni][2 * hh + c] * inv_temp : RLINF_NEG_INF;
            x[2 * ni + c] = v;
            mx = fmaxf(mx, v);
          }
        const float alpha = expf(s.m - mx);
        float e1 = 0.f, e2 = 0.f;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = n0 + acc_col(ni, c);
            if (col >= V) continue;
            const float v = x[2 * ni + c];
            const float ex = expf(v - mx);
            e1 += ex;
            e2 += ex * v;
            if (col == tg[mi][hh]) s.tl += v;
          }
        s.s1 = s.s1 * alpha + e1;
        s.s2 = s.s2 * alpha + e2;
        s.m = mx;
      }
  }
  // merge the 4 lanes of a row (t = lane % 4), then the 4 warps along N
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      Stats& s = st[mi][hh];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        Stats o;
        o.m = __shfl_xor_sync(RLINF_FULL_MASK, s.m, off);
        o.s1 = __shfl_xor_sync(RLINF_FULL_MASK, s.s1, off);
        o.s2 = __shfl_xor_sync(RLINF_FULL_MASK, s.s2, off);
        o.tl = __shfl_xor_sync(RLINF_FULL_MASK, s.tl, off);
        merge(s, o);
      }
      if (lane % 4 == 0) red[warp % 4][acc_row(mi, 2 * hh)] = s;
    }
  __syncthreads();
  if (threadIdx.x < BM) {
    const int r = threadIdx.x;
    Stats s = red[0][r];
    for (int wn = 1; wn < 4; ++wn) merge(s, red[wn][r]);
    const size_t plane = (size_t)n_split * n;
    const size_t at = (size_t)split * n + m0 + r;
    part[at] = s.m;
    part[plane + at] = s.s1;
    part[2 * plane + at] = s.s2;
    part[3 * plane + at] = s.tl;
  }
}

__global__ void __launch_bounds__(NT) ce_fwd_combine_kernel(
    const float* __restrict__ part, float* __restrict__ lp, float* __restrict__ ent,
    float* __restrict__ lse, int n, int n_split) {
  const int row = blockIdx.x * NT + threadIdx.x;
  if (row >= n) return;
  const size_t plane = (size_t)n_split * n;
  Stats st{RLINF_NEG_INF, 0.f, 0.f, 0.f};
  for (int s = 0; s < n_split; ++s) {
    const size_t at = (size_t)s * n + row;
    merge(st, Stats{part[at], part[plane + at], part[2 * plane + at], part[3 * plane + at]});
  }
  const float s1 = fmaxf(st.s1, 1e-30f);
  const float l = st.m + logf(s1);
  lp[row] = st.tl - l;
  ent[row] = l - st.s2 / s1;
  lse[row] = l;
}

// ---------------------------------------------------------------------------
// K6: wgmma with TMA-fed rings
// ---------------------------------------------------------------------------

constexpr int GM = 128;        // rows of a K6 tile (two m64 wgmma halves)
constexpr int GN = 128;        // columns of a K6 tile
constexpr int GK = 64;         // depth of a stage: 128 bytes of bf16, the swizzle span
constexpr int RING = 3;        // stages of each consumer's ring
constexpr int TILE_BYTES = GM * GK * 2;     // 16 KB: the A or the B tile of a stage
constexpr int STAGE_BYTES = 2 * TILE_BYTES;
constexpr int G_THREADS = 384;              // producer warpgroup + two consumer warpgroups
constexpr int G_SMEM = 2 * RING * STAGE_BYTES + 1024;  // + room to align the rings to 1024
constexpr int MERGE_NT = 256;

struct GemmArgs {
  int n, D, V, Vp;
  int n_items, n_mt, n_nt, n_kb, n_slices;
  float inv_temp;
  const int* tgt;
  const float *lse, *mu, *g_lp, *g_ent;
  __nv_bfloat16* dz;  // pass A's output [n, Vp]
  float* part;        // pass B's output [n_slices, n, D]
};

// A tile index -> its rows m0, columns n0, k-blocks [kb0, kb1) and slice.
template <int PASS>
__device__ __forceinline__ void decode_item(const GemmArgs& a, int item, int& m0, int& n0,
                                            int& kb0, int& kb1, int& slice) {
  if (PASS == 0) {  // dz: rows fastest
    m0 = (item % a.n_mt) * GM;
    n0 = (item / a.n_mt) * GN;
    kb0 = 0;
    kb1 = a.n_kb;
    slice = 0;
  } else {          // dh partials: hidden columns fastest, then rows, then slices
    n0 = (item % a.n_nt) * GN;
    const int rest = item / a.n_nt;
    m0 = (rest % a.n_mt) * GM;
    slice = rest / a.n_mt;
    kb0 = static_cast<int>(static_cast<long long>(slice) * a.n_kb / a.n_slices);
    kb1 = static_cast<int>(static_cast<long long>(slice + 1) * a.n_kb / a.n_slices);
  }
}

// The accumulators of one consumer: acc[h][4 * j + 2 * r + e] holds row
// m0 + 64 h + 16 warp + lane / 4 + 8 r, column n0 + 8 j + 2 (lane % 4) + e.
template <int PASS>
__device__ __forceinline__ void gemm_epilogue(const GemmArgs& a, float (&acc)[2][64], int m0,
                                              int n0, int slice, int warp, int lane) {
  const int rq = warp * 16 + lane / 4, cq = 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + 64 * h + rq + 8 * r;
      if (row >= a.n) continue;
      if (PASS == 0) {
        const float l = a.lse[row], u = a.mu[row], gl = a.g_lp[row], ge = a.g_ent[row];
        const int tg = a.tgt[row];
        __nv_bfloat16* out = a.dz + (size_t)row * a.Vp + n0 + cq;
#pragma unroll
        for (int j = 0; j < GN / 8; ++j) {
          float d[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = n0 + 8 * j + cq + e;
            d[e] = 0.f;
            if (col < a.V) {
              const float x = acc[h][4 * j + 2 * r + e] * a.inv_temp;
              const float p = expf(x - l);
              const float onehot = col == tg ? 1.f : 0.f;
              d[e] = (gl * (onehot - p) - ge * (p * (x - u))) * a.inv_temp;
            }
          }
          *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(d[0], d[1]);
        }
      } else {
        float* out = a.part + ((size_t)slice * a.n + row) * a.D + n0 + cq;
#pragma unroll
        for (int j = 0; j < GN / 8; ++j)
          if (n0 + 8 * j + cq < a.D)
            *reinterpret_cast<float2*>(out + 8 * j) =
                make_float2(acc[h][4 * j + 2 * r], acc[h][4 * j + 2 * r + 1]);
      }
    }
}

// PASS 0: dz tiles (A = h [n, D], B = W as (k = d, n = v)); PASS 1: dh
// partials (A = dz [n, Vp], B = W as (k = v, n = d)). B_MN: B is
// n-contiguous in memory.
template <int PASS, bool B_MN>
__global__ void __launch_bounds__(G_THREADS, 1) ce_bwd_gemm_kernel(
    const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
    const GemmArgs a) {
  extern __shared__ unsigned char g_smem[];
  __shared__ __align__(8) uint64_t bars[2][2][RING];  // [consumer][full, empty][stage]
  const uint32_t base = (smem_u32(g_smem) + 1023u) & ~1023u;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int c = 0; c < 2; ++c)
      for (int s = 0; s < RING; ++s) {
        mbar_init(smem_u32(&bars[c][0][s]), 1);  // the producer's expect_tx
        mbar_init(smem_u32(&bars[c][1][s]), 4);  // one arrival per consumer warp
      }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    // lane 0 of warp c feeds consumer c: the CTA's tiles il = c, c + 2, ...
    if (warp < 2 && lane == 0) {
      const int c = warp;
      const uint32_t ring = base + c * RING * STAGE_BYTES;
      int k = 0;  // stages issued into this ring
      for (int il = c;; il += 2) {
        const int item = blockIdx.x + il * gridDim.x;
        if (item >= a.n_items) break;
        int m0, n0, kb0, kb1, slice;
        decode_item<PASS>(a, item, m0, n0, kb0, kb1, slice);
        for (int kb = kb0; kb < kb1; ++kb, ++k) {
          const int s = k % RING;
          const uint32_t full = smem_u32(&bars[c][0][s]), empty = smem_u32(&bars[c][1][s]);
          mbar_wait(empty, ((k / RING) & 1) ^ 1);
          mbar_expect_tx(full, STAGE_BYTES);
          const uint32_t sa = ring + s * STAGE_BYTES, sb = sa + TILE_BYTES;
          tma_load(sa, &tm_a, full, kb * GK, m0);
          if (B_MN) {  // two boxes of 64 k-rows x 64 columns
            tma_load(sb, &tm_b, full, n0, kb * GK);
            tma_load(sb + TILE_BYTES / 2, &tm_b, full, n0 + 64, kb * GK);
          } else {     // one box of 128 rows x 64 k
            tma_load(sb, &tm_b, full, kb * GK, n0);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;
    const uint32_t ring = base + c * RING * STAGE_BYTES;
    float acc[2][64];
    int k = 0;  // stages consumed from this ring
    for (int il = c;; il += 2) {
      const int item = blockIdx.x + il * gridDim.x;
      if (item >= a.n_items) break;
      int m0, n0, kb0, kb1, slice;
      decode_item<PASS>(a, item, m0, n0, kb0, kb1, slice);
      const int nk = kb1 - kb0;
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      for (int kk = 0; kk < nk; ++kk, ++k) {
        const int s = k % RING;
        mbar_wait(smem_u32(&bars[c][0][s]), (k / RING) & 1);
        const uint32_t sa = ring + s * STAGE_BYTES, sb = sa + TILE_BYTES;
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < GK / 16; ++j) {
          const uint32_t on = (kk > 0 || j > 0) ? 1u : 0u;
          // K-major tiles: 128-byte rows, 8-row groups 1024 B apart, k16 = 32 B.
          // n-contiguous B: 64-column halves 8 KB apart, 8-k groups 1024 B
          // apart, k16 = 16 rows of 128 B.
          const uint64_t db = B_MN ? gmma_desc(sb + j * 2048, TILE_BYTES / 2, 1024)
                                   : gmma_desc(sb + j * 32, 16, 1024);
          wgmma_ss<GN, B_MN ? 1 : 0>(acc[0], gmma_desc(sa + j * 32, 16, 1024), db, on);
          wgmma_ss<GN, B_MN ? 1 : 0>(acc[1], gmma_desc(sa + 8192 + j * 32, 16, 1024), db, on);
        }
        wgmma_commit();
        // the stage before this one is read: give it back to the producer
        wgmma_wait<1>();
        if (kk > 0 && lane == 0) mbar_arrive(smem_u32(&bars[c][1][(k + RING - 1) % RING]));
      }
      wgmma_wait<0>();
      if (nk > 0 && lane == 0) mbar_arrive(smem_u32(&bars[c][1][(k + RING - 1) % RING]));
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      gemm_epilogue<PASS>(a, acc, m0, n0, slice, warp, lane);
    }
  }
}

// dh = bf16(sum over slices, in slice order, of part[slice]).
__global__ void __launch_bounds__(MERGE_NT) dh_merge_kernel(const float* __restrict__ part,
                                                            __nv_bfloat16* __restrict__ dh,
                                                            size_t count, int n_slices) {
  const size_t i = ((size_t)blockIdx.x * MERGE_NT + threadIdx.x) * 4;
  if (i >= count) return;
  float4 s = *reinterpret_cast<const float4*>(part + i);
  for (int k = 1; k < n_slices; ++k) {
    const float4 v = *reinterpret_cast<const float4*>(part + (size_t)k * count + i);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  *reinterpret_cast<__nv_bfloat162*>(dh + i) = __floats2bfloat162_rn(s.x, s.y);
  *reinterpret_cast<__nv_bfloat162*>(dh + i + 2) = __floats2bfloat162_rn(s.z, s.w);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int PASS, bool B_MN>
cudaError_t launch_gemm(const CUtensorMap& ta, const CUtensorMap& tb, const GemmArgs& a, int grid,
                        cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(ce_bwd_gemm_kernel<PASS, B_MN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, G_SMEM);
  if (err != cudaSuccess) return err;
  const int blocks = grid < a.n_items ? grid : a.n_items;
  ce_bwd_gemm_kernel<PASS, B_MN><<<blocks, G_THREADS, G_SMEM, st>>>(ta, tb, a);
  return cudaGetLastError();
}


}  // namespace

// K5. h [n, D] bf16 (n a multiple of 64), w [V, D] (vd = 1) or [D, V]
// (vd = 0) bf16, tgt [n] int32; part f32 [4, n_split, n] scratch; lp, ent,
// lse f32 [n].
extern "C" int linear_ce_fwd(int device, const void* h, const void* w, const void* tgt,
                             void* part, void* lp, void* ent, void* lse, int n, int D,
                             int V, int vd, int n_split, float inv_temp, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n % BM != 0 || n_split < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_vt = (V + BN - 1) / BN;
  if (n_split > n_vt) return cudaErrorInvalidValue;
  const dim3 grid(n / BM, n_split);
  const auto* hb = static_cast<const __nv_bfloat16*>(h);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  float* pf = static_cast<float*>(part);
  const int ldw = vd ? D : V;
  const bool vec = aligned16(h) && aligned16(w) && D % 8 == 0 && ldw % 8 == 0;
  if (vd)
    ce_fwd_kernel<true><<<grid, NT, 0, st>>>(hb, wb, static_cast<const int*>(tgt), pf, n, D,
                                              V, ldw, n_vt, n_split, inv_temp, vec);
  else
    ce_fwd_kernel<false><<<grid, NT, 0, st>>>(hb, wb, static_cast<const int*>(tgt), pf, n, D,
                                               V, ldw, n_vt, n_split, inv_temp, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_fwd_combine_kernel<<<(n + NT - 1) / NT, NT, 0, st>>>(
      pf, static_cast<float*>(lp), static_cast<float*>(ent), static_cast<float*>(lse), n,
      n_split);
  return cudaGetLastError();
}

// K6. As K5, plus lse, mu, g_lp, g_ent f32 [n]; dz bf16 [n, Vp] (Vp a
// multiple of 128, pad columns written 0); dh bf16 [n, D]; part f32
// [n_slices, n, D] scratch. W's rows are ldw elements apart (ldw >= D for
// vd, >= V for dv); D and ldw are multiples of 8, as TMA row strides are
// multiples of 16 bytes (ops/cuda/linear_ce.py pads them). grid: CTAs, at
// most one an SM.
extern "C" int linear_ce_bwd(int device, const void* h, const void* w, const void* tgt,
                             const void* lse, const void* mu, const void* g_lp,
                             const void* g_ent, void* dz, void* dh, void* part, int n, int D,
                             int V, int Vp, int ldw, int vd, int n_slices, int grid,
                             float inv_temp, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  // W as a matrix: vd [V rows of D], dv [D rows of V]. As B it is k-contiguous
  // in pass A and n-contiguous in pass B for vd, the other way round for dv.
  const int w_inner = vd ? D : V, w_outer = vd ? V : D;
  if (n < 1 || D % 8 || Vp < V || Vp % GN || ldw % 8 || ldw < w_inner || n_slices < 1 ||
      n_slices > Vp / GK || grid < 1 || !aligned16(h) || !aligned16(w) || !aligned16(dz))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // The maps read W's real extent (TMA fills what lies past it with zeros),
  // so pad columns of a padded row stride are never read.
  CUtensorMap tm_h, tm_dz, tm_wa, tm_wb;
  if (!make_map(&tm_h, h, D, n, D, GM) || !make_map(&tm_dz, dz, Vp, n, Vp, GM) ||
      !make_map(&tm_wa, w, w_inner, w_outer, ldw, vd ? GN : 64) ||
      !make_map(&tm_wb, w, w_inner, w_outer, ldw, vd ? 64 : GN))
    return cudaErrorInvalidValue;
  GemmArgs a{n, D, V, Vp, 0, (n + GM - 1) / GM, Vp / GN, (D + GK - 1) / GK, 1, inv_temp,
             static_cast<const int*>(tgt), static_cast<const float*>(lse),
             static_cast<const float*>(mu), static_cast<const float*>(g_lp),
             static_cast<const float*>(g_ent), static_cast<__nv_bfloat16*>(dz),
             static_cast<float*>(part)};
  a.n_items = a.n_mt * a.n_nt;
  err = vd ? launch_gemm<0, false>(tm_h, tm_wa, a, grid, st)
           : launch_gemm<0, true>(tm_h, tm_wa, a, grid, st);
  if (err != cudaSuccess) return err;
  a.n_nt = (D + GN - 1) / GN;
  a.n_kb = Vp / GK;
  a.n_slices = n_slices;
  a.n_items = a.n_nt * a.n_mt * n_slices;
  err = vd ? launch_gemm<1, true>(tm_dz, tm_wb, a, grid, st)
           : launch_gemm<1, false>(tm_dz, tm_wb, a, grid, st);
  if (err != cudaSuccess) return err;
  const size_t count = (size_t)n * D;
  const unsigned blocks = static_cast<unsigned>((count / 4 + MERGE_NT - 1) / MERGE_NT);
  dh_merge_kernel<<<blocks, MERGE_NT, 0, st>>>(static_cast<const float*>(part),
                                               static_cast<__nv_bfloat16*>(dh), count, n_slices);
  return cudaGetLastError();
}
