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
// Both run on Hopper's asynchronous tensor cores, through one kernel
// template (ce_gemm_kernel<PASS, B_MN>) and so one mainloop: wgmma.mma_async
// m64n128k16 bf16 with f32 sums, both operands in shared memory in the
// 128-byte swizzle, brought in by TMA (cp.async.bulk.tensor.2d on a
// CUtensorMap) and tracked by mbarriers. One persistent CTA on each SM has a
// producer warpgroup and two consumer warpgroups (setmaxnreg 40 / 232); a
// consumer owns whole 128 x 128 output tiles, two m64 halves with 64 f32
// sums a thread each, and has its own three-stage ring fed by its own
// producer thread, so each (producer, consumer) pair is a plain pipeline.
// The CTA's tiles alternate between the two consumers: while one runs its
// epilogue the other's products keep the tensor cores busy. The passes
// differ in their tiles and their epilogue:
//   pass F (K5, PASS 2): logits h W for each (128-row, 128-vocab-column)
//     tile over K = D, rows the fastest tile index so that the CTAs in
//     flight share W tiles (W is read from device memory about once, h
//     stays in the L2). The epilogue works on the accumulators in
//     registers: it scales by 1/T, masks columns >= V, and reduces each
//     row's 128 logits to its statistics (max m, s1 = sum e^(x-m), s2 =
//     sum e^(x-m) x, the target logit) over the 4 lanes that hold the row
//     with quad shuffles. Each tile writes its rows' statistics as f32
//     partials [4][ceil(V / 128)][n] (78 MB at 4096 rows and V = 151936,
//     written once and read once); a combine launch merges each row's
//     tiles in a fixed order (a CTA holds 32 rows x 8 segments of tiles;
//     each thread merges its segment's tiles in order, then the segments
//     are merged in order): deterministic, no atomics. Carrying the
//     statistics across a vocabulary slice in registers instead would save
//     the scratch but give the forward a mainloop of its own.
//   pass A (K6, PASS 0): dz for the same tiles in the same order; the
//     epilogue stores dz in bf16.
//   pass B (K6, PASS 1): dh = dz W over K = V_pad, thin (4096 x 1536, 384
//     tiles) and deep: the vocabulary is cut into s slices of whole
//     64-blocks (ops/cuda/linear_ce.py dh_slices picks s so that tiles x s
//     fill whole rounds of the 264 consumers), each writes f32 partials, and
//     a small third launch adds them in slice order: deterministic, no
//     atomics.
// The tied "vd" weight is k-contiguous as the B operand of passes F and A
// and n-contiguous as pass B's, "dv" the other way round; an n-contiguous B
// tile is loaded as two 64-column TMA boxes and read with wgmma's transpose
// bit, not transposed by hand. TMA fills rows past n and columns past V
// with zeros; the epilogues mask them. TMA row strides are multiples of 16
// bytes, so the wrapper zero-pads the depth D to a multiple of 8 (a zero
// depth column changes no logit) and, for an untied [D, V] weight with
// V % 8 != 0, copies W into rows of a multiple of 8 and passes that row
// stride as ldw: the maps still read only V columns, so pad columns stay
// masked. The TMA, mbarrier and wgmma primitives are in hopper.cuh.

#include "hopper.cuh"

namespace {

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

// ---------------------------------------------------------------------------
// K5 and K6: wgmma with TMA-fed rings
// ---------------------------------------------------------------------------

constexpr int GM = 128;        // rows of a tile (two m64 wgmma halves)
constexpr int GN = 128;        // columns of a tile
constexpr int GK = 64;         // depth of a stage: 128 bytes of bf16, the swizzle span
constexpr int RING = 3;        // stages of each consumer's ring
constexpr int TILE_BYTES = GM * GK * 2;     // 16 KB: the A or the B tile of a stage
constexpr int STAGE_BYTES = 2 * TILE_BYTES;
constexpr int G_THREADS = 384;              // producer warpgroup + two consumer warpgroups
constexpr int G_SMEM = 2 * RING * STAGE_BYTES + 1024;  // + room to align the rings to 1024
constexpr int MERGE_NT = 256;
constexpr int COMBINE_ROWS = 32;  // rows of a K5 combine CTA
constexpr int COMBINE_SEGS = 8;   // segments of a row's tiles, merged in order
constexpr float LOG2E = 1.4426950408889634f;

struct GemmArgs {
  int n, D, V, Vp;
  int n_items, n_mt, n_nt, n_kb, n_slices;
  float inv_temp;
  const int* tgt;
  const float *lse, *mu, *g_lp, *g_ent;
  __nv_bfloat16* dz;  // pass A's output [n, Vp]
  float* part;        // pass B's output [n_slices, n, D]; pass F's [4, n_nt, n]
};

// A tile index -> its rows m0, columns n0, k-blocks [kb0, kb1) and slice.
template <int PASS>
__device__ __forceinline__ void decode_item(const GemmArgs& a, int item, int& m0, int& n0,
                                            int& kb0, int& kb1, int& slice) {
  if (PASS != 1) {  // logits tiles (F, A): rows fastest
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
//
// Pass F: the statistics of each row's 128 columns of the tile, reduced
// over the 4 lanes (lane % 4) that hold the row; every lane takes part in
// the shuffles, and lane % 4 == 0 writes rows below n. Every tile holds at
// least one column below V, so m is finite.
__device__ __forceinline__ void stats_epilogue(const GemmArgs& a, const float (&acc)[2][64],
                                               int m0, int n0, int warp, int lane) {
  const int rq = warp * 16 + lane / 4, cq = 2 * (lane % 4);
  const size_t plane = (size_t)a.n_nt * a.n;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + 64 * h + rq + 8 * r;
      const int tg = row < a.n ? a.tgt[row] : -1;
      float m = RLINF_NEG_INF;
#pragma unroll
      for (int j = 0; j < GN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (n0 + 8 * j + cq + e < a.V) m = fmaxf(m, acc[h][4 * j + 2 * r + e] * a.inv_temp);
      m = fmaxf(m, __shfl_xor_sync(RLINF_FULL_MASK, m, 1));
      m = fmaxf(m, __shfl_xor_sync(RLINF_FULL_MASK, m, 2));
      float s1 = 0.f, s2 = 0.f, tl = 0.f;
#pragma unroll
      for (int j = 0; j < GN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + 8 * j + cq + e;
          if (col >= a.V) continue;
          const float x = acc[h][4 * j + 2 * r + e] * a.inv_temp;
          const float ex = exp2f((x - m) * LOG2E);
          s1 += ex;
          s2 = fmaf(ex, x, s2);
          if (col == tg) tl = x;
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        s1 += __shfl_xor_sync(RLINF_FULL_MASK, s1, off);
        s2 += __shfl_xor_sync(RLINF_FULL_MASK, s2, off);
        tl += __shfl_xor_sync(RLINF_FULL_MASK, tl, off);
      }
      if (lane % 4 == 0 && row < a.n) {
        const size_t at = (size_t)(n0 / GN) * a.n + row;
        a.part[at] = m;
        a.part[plane + at] = s1;
        a.part[2 * plane + at] = s2;
        a.part[3 * plane + at] = tl;
      }
    }
}

// Passes A and B.
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

// PASS 2 (F): K5's statistics tiles and PASS 0 (A): dz tiles, both with
// A = h [n, D], B = W as (k = d, n = v); PASS 1 (B): dh partials (A = dz
// [n, Vp], B = W as (k = v, n = d)). B_MN: B is n-contiguous in memory.
template <int PASS, bool B_MN, bool F16>
__device__ __forceinline__ void ce_gemm(const CUtensorMap& tm_a, const CUtensorMap& tm_b,
                                        const GemmArgs& a) {
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
          wgmma_ss<GN, B_MN ? 1 : 0, F16>(acc[0], gmma_desc(sa + j * 32, 16, 1024), db, on);
          wgmma_ss<GN, B_MN ? 1 : 0, F16>(acc[1], gmma_desc(sa + 8192 + j * 32, 16, 1024), db, on);
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
      if constexpr (PASS == 2)
        stats_epilogue(a, acc, m0, n0, warp, lane);
      else
        gemm_epilogue<PASS>(a, acc, m0, n0, slice, warp, lane);
    }
  }
}

template <int PASS, bool B_MN>
__global__ void __launch_bounds__(G_THREADS, 1) ce_gemm_kernel(
    const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
    const GemmArgs a) {
  ce_gemm<PASS, B_MN, false>(tm_a, tm_b, a);
}

// The same on f16 operands: the f16 form of the same wgmma (K5, K6's pass A).
template <int PASS, bool B_MN>
__global__ void __launch_bounds__(G_THREADS, 1) ce_gemm_f16_kernel(
    const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
    const GemmArgs a) {
  ce_gemm<PASS, B_MN, true>(tm_a, tm_b, a);
}

// K5's combine: lp, ent and lse of each row from its tiles' statistics
// part [4][n_tiles][n]. Thread (segment sg, row) merges the tiles
// [sg n_tiles / COMBINE_SEGS, (sg + 1) n_tiles / COMBINE_SEGS) in order,
// then the row's thread of segment 0 merges the segments in order
// (ops/cuda/linear_ce.py combine_segments).
__global__ void __launch_bounds__(COMBINE_ROWS * COMBINE_SEGS) ce_fwd_combine_kernel(
    const float* __restrict__ part, float* __restrict__ lp, float* __restrict__ ent,
    float* __restrict__ lse, int n, int n_tiles) {
  __shared__ Stats seg[COMBINE_SEGS][COMBINE_ROWS];
  const int r = threadIdx.x % COMBINE_ROWS, sg = threadIdx.x / COMBINE_ROWS;
  const int row = blockIdx.x * COMBINE_ROWS + r;
  const size_t plane = (size_t)n_tiles * n;
  Stats st{RLINF_NEG_INF, 0.f, 0.f, 0.f};
  if (row < n) {
    const int t1 = (int)((long long)(sg + 1) * n_tiles / COMBINE_SEGS);
    for (int t = (int)((long long)sg * n_tiles / COMBINE_SEGS); t < t1; ++t) {
      const size_t at = (size_t)t * n + row;
      merge(st, Stats{part[at], part[plane + at], part[2 * plane + at], part[3 * plane + at]});
    }
  }
  seg[sg][r] = st;
  __syncthreads();
  if (sg != 0 || row >= n) return;
  for (int k = 1; k < COMBINE_SEGS; ++k) merge(st, seg[k][r]);
  const float s1 = fmaxf(st.s1, 1e-30f);
  const float l = st.m + logf(s1);
  lp[row] = st.tl - l;
  ent[row] = l - st.s2 / s1;
  lse[row] = l;
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

// ---------------------------------------------------------------------------
// f16 and f32 operands: three bf16 products in one mainloop
// ---------------------------------------------------------------------------
//
// f16 operands run the same mainloop on the f16 form of its wgmma
// (ce_gemm_f16_kernel, f16 tensor maps): K5 and K6's pass A.
// An f32 operand x is split into bf16 parts hi = bf16(x) and
// lo = bf16(x - hi) (2^-16 of x), and the product h W becomes
// h_hi W_hi + h_hi W_lo + h_lo W_hi: one product of depth 3 D over
// h' = [h_hi | h_hi | h_lo] and W' = [W_hi; W_lo; W_hi] (the dropped
// h_lo W_lo is about 2^-16 of the product). So the same mainloop, tiles and
// epilogues run on the parts, which split_kernel writes to bf16 scratch
// first (a pass over h and W at the memory rate). K6's pass B multiplies
// the bf16 dz (the reference's dtype) by W; one wgmma takes one operand
// type, so for f16 and f32 it multiplies dz by the first two blocks of W'
// (f16 splits exactly), each into its own columns, and dh_fold_kernel adds
// them: dh = dz (W_hi + W_lo)^T.

// x [R, C] (element type T, contiguous) -> three bf16 blocks of its parts,
// block k the lo part where bit k of lo_mask is set, else hi: column blocks
// (out [R, 3 C]) or row blocks (out [3 R, C]).
template <class T>
__global__ void split_kernel(const T* __restrict__ x, __nv_bfloat16* __restrict__ out, size_t R,
                             size_t C, int col_blocks, int lo_mask) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R * C) return;
  const size_t r = i / C, c = i % C;
  const float v = to_f32(x[i]);
  const __nv_bfloat16 hi = __float2bfloat16(v);
  const __nv_bfloat16 lo = __float2bfloat16(v - __bfloat162float(hi));
#pragma unroll
  for (int k = 0; k < 3; ++k)
    out[col_blocks ? (r * 3 + k) * C + c : (k * R + r) * C + c] = (lo_mask >> k) & 1 ? lo : hi;
}

// dh [n, D] of element type T = sum over slices, in slice order, of
// part[slice] [n, 2 D], columns c and D + c added.
template <class T>
__global__ void __launch_bounds__(MERGE_NT) dh_fold_kernel(const float* __restrict__ part,
                                                           T* __restrict__ dh, int n, int D,
                                                           int n_slices) {
  const size_t i = (size_t)blockIdx.x * MERGE_NT + threadIdx.x;
  if (i >= (size_t)n * D) return;
  const size_t row = i / D, c = i % D, count = (size_t)n * 2 * D;
  const float* p = part + row * 2 * D + c;
  float s = 0.f;
  for (int k = 0; k < n_slices; ++k) s += p[(size_t)k * count] + p[(size_t)k * count + D];
  dh[i] = Elem<T>::put(s);
}

template <class T>
cudaError_t split(const void* x, void* out, size_t R, size_t C, int col_blocks, int lo_mask,
                  cudaStream_t st) {
  const size_t count = R * C;
  split_kernel<T><<<static_cast<unsigned>((count + 255) / 256), 256, 0, st>>>(
      static_cast<const T*>(x), static_cast<__nv_bfloat16*>(out), R, C, col_blocks, lo_mask);
  return cudaGetLastError();
}

// W' of an f16 (dtype 1) or f32 (dtype 2) W ([V, D] vd, or [D, ldw]) into
// ws ([V, 3 D] or [3 D, ldw]) bf16, and with hs h' of h [n, D] into hs
// [n, 3 D] bf16.
cudaError_t split_operands(int dtype, const void* h, const void* w, void* hs, void* ws, int n,
                           int D, int V, int ldw, int vd, cudaStream_t st) {
  auto run = [&](auto tag) {
    using T = decltype(tag);
    if (hs != nullptr) {
      const cudaError_t err = split<T>(h, hs, n, D, 1, 4, st);
      if (err != cudaSuccess) return err;
    }
    return vd ? split<T>(w, ws, V, D, 1, 2, st) : split<T>(w, ws, D, ldw, 0, 2, st);
  };
  if (dtype == 1) return run(__half{});
  if (dtype == 2) return run(0.f);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int PASS, bool B_MN, bool F16 = false>
cudaError_t launch_gemm(const CUtensorMap& ta, const CUtensorMap& tb, const GemmArgs& a, int grid,
                        cudaStream_t st) {
  const auto kernel = F16 ? ce_gemm_f16_kernel<PASS, B_MN> : ce_gemm_kernel<PASS, B_MN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G_SMEM);
  if (err != cudaSuccess) return err;
  const int blocks = grid < a.n_items ? grid : a.n_items;
  kernel<<<blocks, G_THREADS, G_SMEM, st>>>(ta, tb, a);
  return cudaGetLastError();
}

// Pass PASS (F or A: logits tiles, B's layout by vd) on bf16 or f16 operands.
template <int PASS>
cudaError_t launch_logits(const CUtensorMap& ta, const CUtensorMap& tb, const GemmArgs& a,
                          int grid, int vd, bool f16, cudaStream_t st) {
  if (f16) return vd ? launch_gemm<PASS, false, true>(ta, tb, a, grid, st)
                     : launch_gemm<PASS, true, true>(ta, tb, a, grid, st);
  return vd ? launch_gemm<PASS, false>(ta, tb, a, grid, st) : launch_gemm<PASS, true>(ta, tb, a, grid, st);
}


}  // namespace

// K5. h [n, D], w [V, D] (vd = 1) or [D, V] (vd = 0) with rows ldw
// elements apart, both of element type `dtype` (0 bf16, 1 f16, 2 f32); tgt
// [n] int32; part f32 [4, ceil(V / 128), n] scratch; lp, ent, lse f32 [n];
// for f32, hs bf16 [n, 3 D] and ws bf16 (vd [V, 3 D], else [3 D, ldw])
// scratch for the split operands (else unused). D and ldw are multiples
// of 8, as TMA row strides are multiples of 16 bytes (ops/cuda/linear_ce.py
// pads them). grid: CTAs, at most one an SM.
extern "C" int linear_ce_fwd(int device, const void* h, const void* w, const void* tgt,
                             void* part, void* lp, void* ent, void* lse, void* hs, void* ws,
                             int n, int D, int V, int ldw, int vd, int dtype, int grid,
                             float inv_temp, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n < 1 || V < 1 || D % 8 || ldw % 8 || ldw < (vd ? D : V) || grid < 1 || !aligned16(h) ||
      !aligned16(w) || dtype < 0 || dtype > 2 ||
      (dtype == 2 && (!aligned16(hs) || !aligned16(ws))))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 2) {
    if ((err = split_operands(dtype, h, w, hs, ws, n, D, V, ldw, vd, st)) != cudaSuccess) return err;
    h = hs;
    w = ws;
    if (vd) ldw = 3 * D;
    D *= 3;
  }
  const CUtensorMapDataType type =
      dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const int w_inner = vd ? D : V, w_outer = vd ? V : D;
  CUtensorMap tm_h, tm_w;
  if (!make_map(&tm_h, h, D, n, D, GM, type) ||
      !make_map(&tm_w, w, w_inner, w_outer, ldw, vd ? GN : 64, type))
    return cudaErrorInvalidValue;
  GemmArgs a{n, D, V, 0, 0, (n + GM - 1) / GM, (V + GN - 1) / GN, (D + GK - 1) / GK, 1,
             inv_temp, static_cast<const int*>(tgt), nullptr, nullptr, nullptr, nullptr,
             nullptr, static_cast<float*>(part)};
  a.n_items = a.n_mt * a.n_nt;
  err = launch_logits<2>(tm_h, tm_w, a, grid, vd, dtype == 1, st);
  if (err != cudaSuccess) return err;
  ce_fwd_combine_kernel<<<(n + COMBINE_ROWS - 1) / COMBINE_ROWS, COMBINE_ROWS * COMBINE_SEGS, 0,
                          st>>>(static_cast<const float*>(part), static_cast<float*>(lp),
                                static_cast<float*>(ent), static_cast<float*>(lse), n, a.n_nt);
  return cudaGetLastError();
}

// K6. h, w, tgt, D, ldw, dtype and grid as K5, plus lse, mu, g_lp, g_ent
// f32 [n]; dz bf16 [n, Vp] (Vp a multiple of 128, pad columns written 0);
// dh [n, D] in h's type; part f32 [n_slices, n, D] scratch ([n_slices, n,
// 2 D] for f16 and f32); ws for f16 and f32, hs for f32, as K5's.
extern "C" int linear_ce_bwd(int device, const void* h, const void* w, const void* tgt,
                             const void* lse, const void* mu, const void* g_lp,
                             const void* g_ent, void* dz, void* dh, void* part, void* hs,
                             void* ws, int n, int D, int V, int Vp, int ldw, int vd, int dtype,
                             int n_slices, int grid, float inv_temp, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n < 1 || D % 8 || Vp < V || Vp % GN || ldw % 8 || ldw < (vd ? D : V) || n_slices < 1 ||
      n_slices > Vp / GK || grid < 1 || !aligned16(h) || !aligned16(w) || !aligned16(dz) ||
      dtype < 0 || dtype > 2 || (dtype && !aligned16(ws)) || (dtype == 2 && !aligned16(hs)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int D_out = D;  // dh's columns
  // pass A's operands (h, w at depth Da, rows of W lda apart) and pass B's
  // W (wb at depth Db, ldb): f16 runs pass A as it is and pass B on W's
  // parts, f32 both on the parts
  const void *ha = h, *wa = w, *wb = w;
  int Da = D, lda = ldw, Db = D, ldb = ldw;
  if (dtype != 0) {
    err = split_operands(dtype, h, w, dtype == 2 ? hs : nullptr, ws, n, D, V, ldw, vd, st);
    if (err != cudaSuccess) return err;
    wb = ws;
    Db = 3 * D;
    ldb = vd ? 3 * D : ldw;
    if (dtype == 2) {
      ha = hs;
      wa = ws;
      Da = Db;
      lda = ldb;
    }
  }
  const CUtensorMapDataType type_a =
      dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // W as a matrix: vd [V rows of D], dv [D rows of V]. As B it is k-contiguous
  // in pass A and n-contiguous in pass B for vd, the other way round for dv.
  // The maps read W's real extent (TMA fills what lies past it with zeros),
  // so pad columns of a padded row stride are never read.
  CUtensorMap tm_h, tm_dz, tm_wa, tm_wb;
  if (!make_map(&tm_h, ha, Da, n, Da, GM, type_a) || !make_map(&tm_dz, dz, Vp, n, Vp, GM) ||
      !make_map(&tm_wa, wa, vd ? Da : V, vd ? V : Da, lda, vd ? GN : 64, type_a) ||
      !make_map(&tm_wb, wb, vd ? Db : V, vd ? V : Db, ldb, vd ? 64 : GN))
    return cudaErrorInvalidValue;
  GemmArgs a{n, Da, V, Vp, 0, (n + GM - 1) / GM, Vp / GN, (Da + GK - 1) / GK, 1, inv_temp,
             static_cast<const int*>(tgt), static_cast<const float*>(lse),
             static_cast<const float*>(mu), static_cast<const float*>(g_lp),
             static_cast<const float*>(g_ent), static_cast<__nv_bfloat16*>(dz),
             static_cast<float*>(part)};
  a.n_items = a.n_mt * a.n_nt;
  err = launch_logits<0>(tm_h, tm_wa, a, grid, vd, dtype == 1, st);
  if (err != cudaSuccess) return err;
  a.D = dtype ? 2 * D_out : D;  // pass B's columns: W' blocks hi and lo only when split
  a.n_nt = (a.D + GN - 1) / GN;
  a.n_kb = Vp / GK;
  a.n_slices = n_slices;
  a.n_items = a.n_nt * a.n_mt * n_slices;
  err = vd ? launch_gemm<1, true>(tm_dz, tm_wb, a, grid, st)
           : launch_gemm<1, false>(tm_dz, tm_wb, a, grid, st);
  if (err != cudaSuccess) return err;
  if (dtype != 0) {
    const unsigned blocks = static_cast<unsigned>(((size_t)n * D_out + MERGE_NT - 1) / MERGE_NT);
    if (dtype == 1)
      dh_fold_kernel<__half><<<blocks, MERGE_NT, 0, st>>>(static_cast<const float*>(part),
                                                           static_cast<__half*>(dh), n, D_out, n_slices);
    else
      dh_fold_kernel<float><<<blocks, MERGE_NT, 0, st>>>(static_cast<const float*>(part),
                                                          static_cast<float*>(dh), n, D_out, n_slices);
    return cudaGetLastError();
  }
  const size_t count = (size_t)n * D;
  const unsigned blocks = static_cast<unsigned>((count / 4 + MERGE_NT - 1) / MERGE_NT);
  dh_merge_kernel<<<blocks, MERGE_NT, 0, st>>>(static_cast<const float*>(part),
                                               static_cast<__nv_bfloat16*>(dh), count, n_slices);
  return cudaGetLastError();
}
