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
// of W; K6 is two such products plus 1.24 GB of dz written. The products
// run on the tensor cores as warp-level mma.sync m16n8k16 bf16 tiles with
// f32 accumulation: 8 warps of a CTA each own 32 x 32 outputs of a 64 x 128
// tile, fed from shared memory one 32-deep stage at a time while the next
// stage's global loads are in flight in registers. wgmma, TMA and a deeper
// pipeline are later work.
//
// Design. A GPU has no sequential grid to carry the running softmax
// statistics across vocab tiles. K5 gives each CTA 64 rows and one slice
// of the vocab: it walks the slice's 128-column tiles, keeps per-thread
// online statistics (max, sum of exp, sum of exp * x, target logit) in
// registers, merges them across the 4 lanes and the 4 warps that share a
// row at the end and writes one partial per (slice, row); a second pass merges the slices
// (the scheme of K4 in sampler.cu). Rows are the fastest grid dimension,
// so the CTAs in flight read the same W tiles and W comes from device
// memory about once. K6 runs two passes: pass A writes dz one (64-row,
// 128-column) tile per CTA; pass B is the product dh = dz W over the
// whole vocab, one (64-row, 128-column-of-D) tile per CTA, so dh needs no
// atomics and no cross-CTA reduction.

#include "common.cuh"

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

// K6 pass A: dz for one (64-row, 128-column) tile.
template <bool KC>
__global__ void __launch_bounds__(NT) ce_dz_kernel(
    const __nv_bfloat16* __restrict__ h, const __nv_bfloat16* __restrict__ w,
    const int* __restrict__ tgt, const float* __restrict__ lse,
    const float* __restrict__ mu, const float* __restrict__ g_lp,
    const float* __restrict__ g_ent, __nv_bfloat16* __restrict__ dz, int D, int V,
    int Vp, int ldw, float inv_temp, bool vec) {
  __shared__ __align__(16) Tiles sm;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  Acc acc;
  zero(acc);
  tile_gemm<KC>(h, D, m0, w, ldw, n0, V, D, vec, sm, acc);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + acc_row(mi, 2 * hh);
      const float l = lse[row], u = mu[row], gl = g_lp[row], ge = g_ent[row];
      const int tg = tgt[row];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        float d[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = n0 + acc_col(ni, c);
          d[c] = 0.f;
          if (col < V) {
            const float x = acc[mi][ni][2 * hh + c] * inv_temp;
            const float p = expf(x - l);
            const float onehot = col == tg ? 1.f : 0.f;
            d[c] = (gl * (onehot - p) - ge * (p * (x - u))) * inv_temp;
          }
        }
        const int col = n0 + acc_col(ni, 0);  // even; Vp is even
        if (col < Vp)
          *reinterpret_cast<__nv_bfloat162*>(&dz[(size_t)row * Vp + col]) =
              __floats2bfloat162_rn(d[0], d[1]);
      }
    }
}

// K6 pass B: dh = dz[:, :V] W^T for one (64-row, 128-column-of-D) tile.
template <bool KC>
__global__ void __launch_bounds__(NT) ce_dh_kernel(
    const __nv_bfloat16* __restrict__ dz, const __nv_bfloat16* __restrict__ w,
    __nv_bfloat16* __restrict__ dh, int D, int V, int Vp, int ldw, bool vec) {
  __shared__ __align__(16) Tiles sm;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  Acc acc;
  zero(acc);
  tile_gemm<KC>(dz, Vp, m0, w, ldw, n0, D, V, vec, sm, acc);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + acc_row(mi, 2 * hh);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = n0 + acc_col(ni, c);
          if (col < D) dh[(size_t)row * D + col] = __float2bfloat16(acc[mi][ni][2 * hh + c]);
        }
    }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

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

// K6. As K5, plus lse, mu, g_lp, g_ent f32 [n]; dz bf16 [n, Vp] (Vp >= V,
// pad columns written 0); dh bf16 [n, D].
extern "C" int linear_ce_bwd(int device, const void* h, const void* w, const void* tgt,
                             const void* lse, const void* mu, const void* g_lp,
                             const void* g_ent, void* dz, void* dh, int n, int D, int V,
                             int Vp, int vd, float inv_temp, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n % BM != 0 || Vp < V || Vp % 8 != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* hb = static_cast<const __nv_bfloat16*>(h);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  auto* dzb = static_cast<__nv_bfloat16*>(dz);
  const int* tg = static_cast<const int*>(tgt);
  const float* l = static_cast<const float*>(lse);
  const float* u = static_cast<const float*>(mu);
  const float* gl = static_cast<const float*>(g_lp);
  const float* ge = static_cast<const float*>(g_ent);
  const dim3 grid_a(n / BM, (Vp + BN - 1) / BN);
  const int ldw = vd ? D : V;
  const bool vec = aligned16(h) && aligned16(w) && aligned16(dz) && D % 8 == 0 && ldw % 8 == 0;
  if (vd)
    ce_dz_kernel<true><<<grid_a, NT, 0, st>>>(hb, wb, tg, l, u, gl, ge, dzb, D, V, Vp, ldw,
                                               inv_temp, vec);
  else
    ce_dz_kernel<false><<<grid_a, NT, 0, st>>>(hb, wb, tg, l, u, gl, ge, dzb, D, V, Vp, ldw,
                                                inv_temp, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_b((D + BN - 1) / BN, n / BM);
  auto* dhb = static_cast<__nv_bfloat16*>(dh);
  // dh = dz W^T: B(k = vocab, n = hidden) is row-major for vd, k-contiguous for dv
  if (vd)
    ce_dh_kernel<false><<<grid_b, NT, 0, st>>>(dzb, wb, dhb, D, V, Vp, ldw, vec);
  else
    ce_dh_kernel<true><<<grid_b, NT, 0, st>>>(dzb, wb, dhb, D, V, Vp, ldw, vec);
  return cudaGetLastError();
}
