// Kernel K4: fused int8 lm-head + temperature sampling for one decode step.
//
// Replaces the Pallas TPU kernel _sample_kernel of
// rlinf_tpu/ops/pallas/sampler_kernel.py (fused_lmhead_sample). Same
// function: z = (hidden @ lm_q) * lm_scale / T over the vocabulary, the int8
// weight widened to bf16 (f16 for an f16 hidden state; an f32 one runs as
// two bf16 parts, split_smem_bytes) and the products summed in f32, with no [B, V]
// tensor in device memory; the token is the Gumbel-max draw argmax(z + g)
// and its logprob is z_tok - logsumexp(z). Greedy mode takes the argmax of
// the raw logits (T = 1) and its logprob. Columns >= V are excluded. Ties go
// to the lowest column, as torch.argmax does.
//
// What bounds it on an H100: bytes. At Qwen2-1.5B (D = 1536, V = 151936,
// B = 64) the int8 lm-head is 233 MB and the product 30 GFLOP: 129 FLOP a
// byte, under the bf16 ridge point of about 295. Beside the product, every
// (row, column) takes a Philox draw and two logarithms when sampling.
//
// Design: the product runs on wgmma with the operands swapped, z^T = W^T
// h^T, so that the weight is the A operand, which wgmma takes from
// registers, and the hidden block is B, in shared memory.
//  * The head arrives packed once per set of decode weights
//    (ops/cuda/sampler_kernel.py pack_lm_head): for each 64-column group and
//    64-deep k-block, 4 KB in which each thread of a warpgroup finds its A
//    fragments of the four k16 steps as 32 contiguous bytes. A thread loads
//    them with two 16-byte loads straight into registers and widens them to
//    bf16 there (exactly); the weight never passes through shared memory,
//    which holds the hidden block instead.
//  * The grid is persistent, one CTA of two warpgroups on each SM. The CTA
//    stages up to 64 hidden rows (the whole depth, N = 16, 32 or 64 rows) in
//    the 128-byte swizzle once, and each warpgroup walks the groups slot,
//    slot + slots, ... of the vocabulary: per k-block one wgmma m64nNk16 per
//    k16 step, the fragments of the next k-block widened while the current
//    products run (two fragment buffers, wait_group 1). N follows the batch,
//    so a small batch does little wasted work on the tensor cores.
//  * The weight stream stays in flight from registers: each thread keeps
//    U = 8 k-blocks of loads outstanding (64 KB an SM), and the loads of its
//    next group are issued before the epilogue of this one. The other choice,
//    a TMA producer warp with a ring in shared memory, has no room here (the
//    hidden block takes 192 KB of the 227 KB at N = 64), and the int8 data
//    has to pass through registers for the conversion anyway.
//  * The epilogue is the real work at B = 64 (9.7 M draws, each ten Philox
//    rounds and two logarithms). The accumulators go through a small
//    transposed tile in shared memory, so that each thread then owns one
//    batch row and 64 / (128 / N) ascending columns of it: one running
//    partial per thread, Philox counters for eight columns at a time (their
//    multiplies overlap). While one warpgroup is in its epilogue the other's
//    products and loads keep the tensor cores and the memory busy.
//
// Statistics cross warpgroups through device memory: every thread keeps the
// running max, sum of exp, best score, its z and column of its row, the
// threads of a row merge by shuffles and write one partial per (warpgroup
// slot, row); a second small launch merges the slots in slot order, so the
// result does not depend on the scheduling. The noise is a counter-based
// Philox4x32-10 keyed by (seed, row, column), so it does not depend on the
// tiling, and ops/cuda/sampler_kernel.py reproduces it bit for bit in torch;
// the uniform takes 23 mantissa bits, as the TPU kernel does.

#include "hopper.cuh"

namespace {

constexpr int WG = 2;              // warpgroups of a CTA, each a partial slot
constexpr int NT = WG * 128;
constexpr int KBLK = 64;           // depth of a k-block: 128 bytes of bf16, the swizzle span
constexpr int GROUP = 64;          // vocab columns of a group: the M of the wgmma
constexpr int U = 8;               // k-blocks of weights a thread keeps in flight
constexpr int ZLD = 68;            // f32 row stride of the transposed logits tile
constexpr int SMEM_CAP = 232448;   // shared memory a CTA can have on sm_90
constexpr int RED_NT = 256;        // threads of the merge launch

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

// Philox4x32-10, first output word for the counters (col, row, 0, 0) and key
// (seed, 0), for N columns of one row at once: the rounds run over all N
// counters, so that their multiplies overlap.
template <int N>
__device__ __forceinline__ void philox_bits_n(uint32_t seed, uint32_t row, const int (&col)[N],
                                              uint32_t (&out)[N]) {
  uint32_t c0[N], c1[N], c2[N], c3[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    c0[i] = static_cast<uint32_t>(col[i]);
    c1[i] = row;
    c2[i] = 0u;
    c3[i] = 0u;
  }
  uint32_t k0 = seed, k1 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const uint64_t p0 = static_cast<uint64_t>(0xD2511F53u) * c0[i];
      const uint64_t p1 = static_cast<uint64_t>(0xCD9E8D57u) * c2[i];
      const uint32_t n0 = static_cast<uint32_t>(p1 >> 32) ^ c1[i] ^ k0;
      const uint32_t n2 = static_cast<uint32_t>(p0 >> 32) ^ c3[i] ^ k1;
      c1[i] = static_cast<uint32_t>(p1);
      c3[i] = static_cast<uint32_t>(p0);
      c0[i] = n0;
      c2[i] = n2;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = c0[i];
}

__device__ __forceinline__ float gumbel(uint32_t bits) {
  float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  u = fmaxf(u, 1e-10f);
  return -logf(-logf(u));
}

// Four int8 (k, k+1, k+2, k+3 in ascending bytes) -> two bf16x2 registers,
// exactly: byte b + 128 dropped into the mantissa of 2^23 gives the float
// 2^23 + 128 + b; the subtraction leaves b (the megakernel's conversion).
__device__ __forceinline__ void cvt_i8x4(uint32_t w, uint32_t (&b)[2]) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
  const __nv_bfloat162 lo = __floats2bfloat162_rn(f0, f1);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(f2, f3);
  b[0] = *reinterpret_cast<const uint32_t*>(&lo);
  b[1] = *reinterpret_cast<const uint32_t*>(&hi);
}

// The same for f16 (an f16 hidden state): byte b + 128 in the mantissa of
// 1024 gives the half 1024 + 128 + b, exactly; the subtraction leaves b.
__device__ __forceinline__ void cvt_i8x4_f16(uint32_t w, uint32_t (&b)[2]) {
  const uint32_t u = w ^ 0x80808080u;
  const __half2 bias = __float2half2_rn(1152.f);
  const uint32_t lo = __byte_perm(u, 0x64646464u, 0x4140), hi = __byte_perm(u, 0x64646464u, 0x4342);
  const __half2 l = __hsub2(*reinterpret_cast<const __half2*>(&lo), bias);
  const __half2 h = __hsub2(*reinterpret_cast<const __half2*>(&hi), bias);
  b[0] = *reinterpret_cast<const uint32_t*>(&l);
  b[1] = *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

struct SampleArgs {
  const void* hidden;           // [B, D] bf16, f16 or f32 (hdt 0, 1, 2)
  const int8_t* w;              // packed [Vp/64][Dp/64][4096]
  const float* scale;           // [Vp], 0 beyond V
  float* part_f;                // [4, slots, B]: m, se, bs, bz
  int* part_i;                  // [slots, B]: best column
  int B, D, Dp, V, Vp;
  float inv_temp;
  int greedy;
  uint32_t seed;
  int hdt;
};

template <int N>
constexpr size_t smem_bytes(int Dp) {
  return (size_t)WG * N * ZLD * 4 + 1024 + (size_t)N * Dp * 2;
}

// HT, the hidden state's type: 0 bf16; 1 f16, staged as it is and
// multiplied by the weight widened to f16 on the f16 form of the wgmma; 2
// f32, staged as two bf16 blocks, hi = bf16(x) and lo = bf16(x - hi), each
// multiplied by the (exactly widened) weight. Either product keeps the
// hidden state's precision, as the Pallas kernel's product in the hidden
// dtype does. The lo block follows the hi block.
template <int N, int HT>
constexpr size_t split_smem_bytes(int Dp) {
  return smem_bytes<N>(Dp) + (HT == 2 ? (size_t)N * Dp * 2 : 0);
}

// Eight f32 hidden values of row `row` from depth c8 on.
__device__ __forceinline__ void hidden8(const SampleArgs& a, int row, int c8, float (&x)[8]) {
  const float4* p = reinterpret_cast<const float4*>(static_cast<const float*>(a.hidden) +
                                                    (size_t)row * a.D + c8);
  const float4 u = p[0], v = p[1];
  x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
  x[4] = v.x; x[5] = v.y; x[6] = v.z; x[7] = v.w;
}

template <int N, int HT>
__global__ void __launch_bounds__(NT, 1) sample_kernel(const SampleArgs a) {
  constexpr int TPR = 128 / N;      // threads of a warpgroup that share a row in the epilogue
  constexpr int CPT = GROUP / TPR;  // ... and the columns each of them takes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [WG][N][ZLD] f32 logits tiles, then the hidden block, 1024-aligned:
  // k-block kb, row n, 16-byte chunk c at kb * N * 128 + n * 128 + ((c ^ n % 8) * 16)
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t hid = (base + WG * N * ZLD * 4 + 1023u) & ~1023u;
  unsigned char* hid_ptr = smem_raw + (hid - base);
  const int wg = threadIdx.x / 128, tw = threadIdx.x % 128;
  const int warp = tw / 32, lane = tw % 32, g = lane / 4, t = lane % 4;
  float* zs = reinterpret_cast<float*>(smem_raw) + wg * N * ZLD;
  const int KB = a.Dp / KBLK;
  const int n_groups = a.Vp / GROUP;
  const int n_slots = gridDim.x * WG;
  // warpgroup-major slots: the groups left over after whole rounds fall on
  // the first warpgroup of every CTA, so each SM streams about the same bytes
  const int slot = wg * gridDim.x + blockIdx.x;
  const int my_groups = slot < n_groups ? (n_groups - 1 - slot) / n_slots + 1 : 0;
  const int total = my_groups * KB;
  const size_t plane = (size_t)n_slots * a.B;
  const int en = tw / TPR, ec0 = (tw % TPR) * CPT;  // epilogue: row and first column

  uint4 wv[U][2];
  // k-block `it` of this warpgroup's walk (group it / KB, depth block it % KB)
  auto load = [&](int it, uint4 (&dst)[2]) {
    const int grp = slot + (it / KB) * n_slots, kb = it % KB;
    const uint4* src = reinterpret_cast<const uint4*>(
        a.w + ((size_t)grp * KB + kb) * 4096 + warp * 1024 + lane * 32);
    dst[0] = __ldcs(src);
    dst[1] = __ldcs(src + 1);
  };

  for (int r0 = 0; r0 < a.B; r0 += N) {
    const int rows = min(N, a.B - r0);
    __syncthreads();  // the previous row block's hidden tile is read
    const int cpr = a.Dp / 8;  // 16-byte chunks a staged row
    for (int idx = threadIdx.x; idx < N * cpr; idx += NT) {
      const int n = idx / cpr, c = idx % cpr;
      const size_t off = (size_t)(c / 8) * N * 128 + n * 128 + ((c % 8) ^ (n % 8)) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if constexpr (HT == 2) {
        uint4 lo = v;
        if (n < rows && c * 8 < a.D) {
          float x[8];
          hidden8(a, r0 + n, c * 8, x);
          uint32_t h[4], l[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) Elem<__nv_bfloat16>::parts(x[2 * i], x[2 * i + 1], h[i], l[i]);
          v = make_uint4(h[0], h[1], h[2], h[3]);
          lo = make_uint4(l[0], l[1], l[2], l[3]);
        }
        *reinterpret_cast<uint4*>(hid_ptr + (size_t)N * a.Dp * 2 + off) = lo;
      } else if (n < rows && c * 8 < a.D) {  // bf16 or f16: 8 elements a chunk
        v = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(a.hidden) +
                                            (size_t)(r0 + n) * a.D + c * 8);
      }
      *reinterpret_cast<uint4*>(hid_ptr + off) = v;
    }
    // the tile is written by ordinary stores and read by wgmma (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    Partial st = empty_partial();
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (u < total) load(u, wv[u]);

    float acc[N / 2];
    uint32_t af[2][4][4];  // [buffer][k16 step][fragment register]
    for (int gi = 0; gi < my_groups; ++gi) {
      for (int kb0 = 0; kb0 < KB; kb0 += U) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int kb = kb0 + u;
          uint32_t(&f)[4][4] = af[u & 1];
          // the 32 bytes of a thread: word 2j + r holds depths 16j + 2t + {0, 1, 8, 9}
          // of column 16 warp + g + 8r of the group
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            uint32_t r0w[2], r1w[2];
            if constexpr (HT == 1) {
              cvt_i8x4_f16(word(wv[u][j / 2], 2 * (j % 2)), r0w);
              cvt_i8x4_f16(word(wv[u][j / 2], 2 * (j % 2) + 1), r1w);
            } else {
              cvt_i8x4(word(wv[u][j / 2], 2 * (j % 2)), r0w);
              cvt_i8x4(word(wv[u][j / 2], 2 * (j % 2) + 1), r1w);
            }
            f[j][0] = r0w[0];
            f[j][1] = r1w[0];
            f[j][2] = r0w[1];
            f[j][3] = r1w[1];
          }
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            wgmma_rs<N, 0, HT == 1>(acc, f[j], gmma_desc(hid + kb * N * 128 + j * 32, 16, 1024),
                                    (kb > 0 || j > 0) ? 1u : 0u);
            if constexpr (HT == 2)
              wgmma_rs<N, 0>(acc, f[j],
                             gmma_desc(hid + N * a.Dp * 2 + kb * N * 128 + j * 32, 16, 1024), 1u);
          }
          wgmma_commit();
          // the previous k-block's products are done: its fragments may change
          wgmma_wait<1>();
          fence_regs(af[(u & 1) ^ 1]);
          // refill this slot: U k-blocks ahead, into the next group once this
          // one's depth is issued
          const int nxt = gi * KB + kb + U;
          if (nxt < total) load(nxt, wv[u]);
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(af[0]);
      fence_regs(af[1]);

      // the scaled logits into this warpgroup's tile as [row][column]:
      // accumulator 4 jj + 2 r + e is column 16 warp + g + 8 r, row 8 jj + 2 t + e
      const int col0 = (slot + gi * n_slots) * GROUP;
      wg_barrier(wg);  // the previous group's tile is read
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int vl = 16 * warp + g + 8 * r;
        const float sc = a.scale[col0 + vl] * a.inv_temp;
#pragma unroll
        for (int jj = 0; jj < N / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) zs[(8 * jj + 2 * t + e) * ZLD + vl] = acc[4 * jj + 2 * r + e] * sc;
      }
      wg_barrier(wg);

      // epilogue: row en, columns col0 + ec0 ... in ascending order (ties
      // keep the lowest column); only the last group has columns >= V
      if (en < rows) {
        const bool full = col0 + GROUP <= a.V;
        const uint32_t row = static_cast<uint32_t>(r0 + en);
#pragma unroll
        for (int c8 = 0; c8 < CPT; c8 += 8) {
          const float4 x0 = *reinterpret_cast<const float4*>(zs + en * ZLD + ec0 + c8);
          const float4 x1 = *reinterpret_cast<const float4*>(zs + en * ZLD + ec0 + c8 + 4);
          float z[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
          int cols[8];
          float mx = st.m;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            cols[i] = col0 + ec0 + c8 + i;
            if (!full && cols[i] >= a.V) z[i] = RLINF_NEG_INF;
            mx = fmaxf(mx, z[i]);
          }
          float se = st.se * __expf(st.m - mx);
#pragma unroll
          for (int i = 0; i < 8; ++i) se += __expf(z[i] - mx);  // masked: exp(-2^30) = 0
          float sco[8];
          if (a.greedy) {
#pragma unroll
            for (int i = 0; i < 8; ++i) sco[i] = z[i];
          } else {
            uint32_t bits[8];
            philox_bits_n(a.seed, row, cols, bits);
#pragma unroll
            for (int i = 0; i < 8; ++i) sco[i] = z[i] + gumbel(bits[i]);
          }
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (sco[i] > st.bs && (full || cols[i] < a.V)) {
              st.bs = sco[i];
              st.bz = z[i];
              st.bi = cols[i];
            }
          st.m = mx;
          st.se = se;
        }
      }
    }

    // the TPR threads of a row, then one partial per (slot, row)
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1) combine(st, shfl_xor(st, off));
    if (tw % TPR == 0 && en < rows) {
      const size_t at = (size_t)slot * a.B + r0 + en;
      a.part_f[at] = st.m;
      a.part_f[plane + at] = st.se;
      a.part_f[2 * plane + at] = st.bs;
      a.part_f[3 * plane + at] = st.bz;
      a.part_i[at] = st.bi;
    }
  }
}

__global__ void __launch_bounds__(RED_NT) sample_reduce_kernel(
    const float* __restrict__ part_f, const int* __restrict__ part_i,
    int* __restrict__ tok, float* __restrict__ lp, int B, int n_slots) {
  __shared__ Partial sm[RED_NT / 32];
  const int row = blockIdx.x;
  const size_t plane = (size_t)n_slots * B;
  Partial p = empty_partial();
  for (int s = threadIdx.x; s < n_slots; s += RED_NT) {
    const size_t at = (size_t)s * B + row;
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
    for (int w_ = 1; w_ < RED_NT / 32; ++w_) combine(r, sm[w_]);
    tok[row] = r.bi;
    lp[row] = r.bz - (r.m + logf(fmaxf(r.se, 1e-30f)));
  }
}

template <int N, int HT>
cudaError_t launch_sample(const SampleArgs& a, int grid, cudaStream_t st) {
  const size_t smem = split_smem_bytes<N, HT>(a.Dp);
  if (smem > SMEM_CAP) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(sample_kernel<N, HT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  sample_kernel<N, HT><<<grid, NT, smem, st>>>(a);
  return cudaGetLastError();
}

template <int HT>
cudaError_t launch_rows(const SampleArgs& a, int rows, int grid, cudaStream_t st) {
  return rows == 16 ? launch_sample<16, HT>(a, grid, st)
         : rows == 32 ? launch_sample<32, HT>(a, grid, st)
                      : launch_sample<64, HT>(a, grid, st);
}

}  // namespace

// hidden [B, D] of element type hdt (0 bf16, 1 f16, 2 f32; D % 8 == 0);
// w the packed head [Vp/64][Dp/64][4096]
// int8 (Vp % 64 == 0, Dp % 512 == 0, zeros beyond D and V); wscale [Vp] f32;
// part_f f32 [4, grid * 2, B] and part_i int32 [grid * 2, B] scratch; tok
// int32 [B], lp f32 [B]. rows: hidden rows staged at once, the N of the
// wgmma (16, 32 or 64). grid: CTAs, at most one an SM.
extern "C" int fused_lmhead_sample(int device, const void* hidden, const void* w,
                                   const void* wscale, void* part_f, void* part_i,
                                   void* tok, void* lp, int B, int D, int Dp, int V, int Vp,
                                   int grid, int rows, float inv_temp, int greedy,
                                   uint32_t seed, int hdt, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B < 1 || D % 8 || D > Dp || Dp % (KBLK * U) || V > Vp || Vp % GROUP || grid < 1 ||
      !(rows == 16 || rows == 32 || rows == 64) || hdt < 0 || hdt > 2)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  SampleArgs a{hidden, static_cast<const int8_t*>(w),
               static_cast<const float*>(wscale), static_cast<float*>(part_f),
               static_cast<int*>(part_i), B, D, Dp, V, Vp, inv_temp, greedy, seed, hdt};
  err = hdt == 0   ? launch_rows<0>(a, rows, grid, st)
        : hdt == 1 ? launch_rows<1>(a, rows, grid, st)
                   : launch_rows<2>(a, rows, grid, st);
  if (err != cudaSuccess) return err;
  sample_reduce_kernel<<<B, RED_NT, 0, st>>>(
      static_cast<const float*>(part_f), static_cast<const int*>(part_i),
      static_cast<int*>(tok), static_cast<float*>(lp), B, grid * WG);
  return cudaGetLastError();
}
