// Kernel K4: fused int8 lm-head + temperature sampling for one decode step.
//
// Replaces the Pallas TPU kernel _sample_kernel of
// rlinf_tpu/ops/pallas/sampler_kernel.py (fused_lmhead_sample). Same
// function: z = (hidden @ lm_q) * lm_scale / T over the vocabulary, with no
// [B, V] tensor in device memory; the token is the Gumbel-max draw
// argmax(z + g) and its logprob is z_tok - logsumexp(z). Greedy mode takes
// the argmax of the raw logits (T = 1) and its logprob. Columns >= V are
// excluded. Ties go to the lowest column, as torch.argmax does.
//
// What bounds it on an H100: bytes. At Qwen2-1.5B (D=1536, V=151936, B=64)
// the int8 lm-head is 233 MB and the product is 30 GFLOP, left of the
// tensor-core ridge point. This first version computes the product with
// scalar fp32 FMAs from shared memory, which makes it bound by operations
// instead (the fp32 non-tensor rate); moving the product to the tensor
// cores (int8 -> bf16 mma) is later work.
//
// Design. The TPU kernel walks vocab tiles sequentially and carries the
// running statistics in VMEM scratch; CTAs here run in no order, so the
// statistics go through device memory in two passes. Pass 1: one CTA per
// (128-column vocab tile, 64-row batch tile) stages the hidden rows and the
// int8 columns through shared memory in 32-deep chunks of D (the whole
// [64, 1536] bf16 hidden block would not fit beside the weights), forms
// its [64, 128] logit tile, and writes per row: max and sum of exp of z,
// and the best score with its column and z. Pass 2: one CTA per row
// combines the tiles' partials. The noise is a counter-based Philox4x32-10
// keyed by (seed, row, column), so it does not depend on the tiling, and
// ops/cuda/sampler_kernel.py reproduces it bit for bit in torch; the
// uniform takes 23 mantissa bits, as the TPU kernel does.

#include "common.cuh"

namespace {

constexpr int VT = 128;  // vocab columns per CTA
constexpr int RT = 64;   // batch rows per CTA
constexpr int DC = 32;   // hidden dims staged per step
constexpr int NT = 256;  // threads: a 16 x 16 grid, 4 rows x 8 columns each

struct Partial {
  float m;   // max of z
  float se;  // sum of exp(z - m)
  float bs;  // best score (z + gumbel, or z when greedy)
  float bz;  // z of the best column
  int bi;    // best column
};

__device__ __forceinline__ Partial empty_partial() {
  return Partial{RLINF_NEG_INF, 0.f, -INFINITY, RLINF_NEG_INF, INT_MAX};
}

__device__ __forceinline__ void combine(Partial& a, const Partial& b) {
  const float m = fmaxf(a.m, b.m);
  a.se = a.se * expf(a.m - m) + b.se * expf(b.m - m);
  a.m = m;
  if (b.bs > a.bs || (b.bs == a.bs && b.bi < a.bi)) {
    a.bs = b.bs;
    a.bz = b.bz;
    a.bi = b.bi;
  }
}

__device__ __forceinline__ Partial shfl_xor(const Partial& p, int off) {
  return Partial{__shfl_xor_sync(RLINF_FULL_MASK, p.m, off),
                 __shfl_xor_sync(RLINF_FULL_MASK, p.se, off),
                 __shfl_xor_sync(RLINF_FULL_MASK, p.bs, off),
                 __shfl_xor_sync(RLINF_FULL_MASK, p.bz, off),
                 __shfl_xor_sync(RLINF_FULL_MASK, p.bi, off)};
}

__device__ __forceinline__ uint32_t philox_bits(uint32_t seed, uint32_t row, uint32_t col) {
  uint32_t c0 = col, c1 = row, c2 = 0u, c3 = 0u;
  uint32_t k0 = seed, k1 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint64_t p0 = static_cast<uint64_t>(0xD2511F53u) * c0;
    const uint64_t p1 = static_cast<uint64_t>(0xCD9E8D57u) * c2;
    const uint32_t n0 = static_cast<uint32_t>(p1 >> 32) ^ c1 ^ k0;
    const uint32_t n2 = static_cast<uint32_t>(p0 >> 32) ^ c3 ^ k1;
    c1 = static_cast<uint32_t>(p1);
    c3 = static_cast<uint32_t>(p0);
    c0 = n0;
    c2 = n2;
  }
  return c0;
}

__device__ __forceinline__ float gumbel(uint32_t bits) {
  float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  u = fmaxf(u, 1e-10f);
  return -logf(-logf(u));
}

__global__ void __launch_bounds__(NT) sample_tile_kernel(
    const __nv_bfloat16* __restrict__ hidden,  // [B, D]
    const int8_t* __restrict__ w,              // [D, V]
    const float* __restrict__ wscale,          // [V]
    float* __restrict__ part_f,                // [4, n_tiles, B]: m, se, bs, bz
    int* __restrict__ part_i,                  // [n_tiles, B]: best column
    int B, int D, int V, float inv_temp, int greedy, uint32_t seed) {
  __shared__ float hs[RT][DC + 1];
  __shared__ float ws[DC][VT];
  const int tile = blockIdx.x, n_tiles = gridDim.x;
  const int row0 = blockIdx.y * RT, col0 = tile * VT;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int d0 = 0; d0 < D; d0 += DC) {
    for (int i = tid; i < RT * DC; i += NT) {
      const int r = i / DC, dd = i % DC, row = row0 + r, d = d0 + dd;
      hs[r][dd] = (row < B && d < D) ? __bfloat162float(hidden[(size_t)row * D + d]) : 0.f;
    }
    for (int i = tid; i < DC * VT; i += NT) {
      const int dd = i / VT, c = i % VT, d = d0 + dd, col = col0 + c;
      ws[dd][c] = (d < D && col < V) ? static_cast<float>(w[(size_t)d * V + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int dd = 0; dd < DC; ++dd) {
      float hv[4], wv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) hv[i] = hs[ty + 16 * i][dd];
#pragma unroll
      for (int j = 0; j < 8; ++j) wv[j] = ws[dd][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(hv[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    float z[8];
    float mx = RLINF_NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + tx + 16 * j;
      z[j] = col < V ? acc[i][j] * wscale[col] * inv_temp : RLINF_NEG_INF;
      mx = fmaxf(mx, z[j]);
    }
    Partial p = empty_partial();
    p.m = mx;
    p.se = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col >= V) continue;
      p.se += expf(z[j] - mx);
      const float sc = greedy ? z[j] : z[j] + gumbel(philox_bits(seed, row, col));
      if (sc > p.bs) {
        p.bs = sc;
        p.bz = z[j];
        p.bi = col;
      }
    }
    // the 16 threads of one row strip are one half-warp
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) combine(p, shfl_xor(p, off));
    if (tx == 0 && row < B) {
      const size_t at = (size_t)tile * B + row;
      const size_t plane = (size_t)n_tiles * B;
      part_f[at] = p.m;
      part_f[plane + at] = p.se;
      part_f[2 * plane + at] = p.bs;
      part_f[3 * plane + at] = p.bz;
      part_i[at] = p.bi;
    }
  }
}

__global__ void __launch_bounds__(NT) sample_reduce_kernel(
    const float* __restrict__ part_f, const int* __restrict__ part_i,
    int* __restrict__ tok, float* __restrict__ lp, int B, int n_tiles) {
  __shared__ Partial sm[NT / 32];
  const int row = blockIdx.x;
  const size_t plane = (size_t)n_tiles * B;
  Partial p = empty_partial();
  for (int t = threadIdx.x; t < n_tiles; t += NT) {
    const size_t at = (size_t)t * B + row;
    combine(p, Partial{part_f[at], part_f[plane + at], part_f[2 * plane + at],
                       part_f[3 * plane + at], part_i[at]});
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) combine(p, shfl_xor(p, off));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) sm[warp] = p;
  __syncthreads();
  if (threadIdx.x == 0) {
    Partial r = sm[0];
    for (int w_ = 1; w_ < NT / 32; ++w_) combine(r, sm[w_]);
    tok[row] = r.bi;
    lp[row] = r.bz - (r.m + logf(fmaxf(r.se, 1e-30f)));
  }
}

}  // namespace

extern "C" int fused_lmhead_sample(int device, const void* hidden, const void* w,
                                   const void* wscale, void* part_f, void* part_i,
                                   void* tok, void* lp, int B, int D, int V,
                                   float inv_temp, int greedy, uint32_t seed,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (V + VT - 1) / VT;
  const dim3 grid(n_tiles, (B + RT - 1) / RT);
  sample_tile_kernel<<<grid, NT, 0, st>>>(
      static_cast<const __nv_bfloat16*>(hidden), static_cast<const int8_t*>(w),
      static_cast<const float*>(wscale), static_cast<float*>(part_f),
      static_cast<int*>(part_i), B, D, V, inv_temp, greedy, seed);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sample_reduce_kernel<<<B, NT, 0, st>>>(
      static_cast<const float*>(part_f), static_cast<const int*>(part_i),
      static_cast<int*>(tok), static_cast<float*>(lp), B, n_tiles);
  return cudaGetLastError();
}
