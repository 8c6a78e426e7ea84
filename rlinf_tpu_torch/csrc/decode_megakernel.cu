// Kernel K9: one whole decode step over all layers in a single launch.
//
// Replaces the Pallas TPU kernel _mega_kernel of
// rlinf_tpu/ops/pallas/decode_megakernel.py (decode_step_mega). Same
// function, per layer: rms-norm, int8 qkv product + bias, rope on the packed
// [B, H*Hd] layout, int8 quantization of the new k/v from the f32 rope
// output, attention over the int8 cache on [starts, write_pos) plus the
// current token exactly in f32 (seeded as m = s_cur, l = 1, acc = v),
// o-projection + residual, rms-norm, gate/up + SiLU, down + residual. The
// residual stream is f32 from the first layer to the last; the normed
// activations, the attention output and the gate/up activations are rounded
// to bf16 where the Pallas body rounds them; every product accumulates in
// f32 and is scaled per output channel afterwards. Slot write_pos[row] of
// the four cache arrays is written in place (past-key reads exclude it).
//
// What bounds it on an H100: bytes. One step reads every int8 weight once
// (1.31 GB at Qwen2-1.5B) and the valid part of the int8 cache, for 2*B
// flops a weight byte (B <= 64 rows), far left of the ridge point.
//
// Design. The TPU kernel is a sequential (layer, phase) grid on one core
// with the activations of the whole batch in VMEM scratch and one weight
// window streamed under the MXU. One SM has neither the memory for the
// batch's activations nor the bandwidth for the weights, so this is a
// persistent cooperative grid, one CTA on every SM (all resident, launched
// with cudaLaunchCooperativeKernel), that walks the layers together:
// activations live in global memory (they stay in the 50 MB L2), each phase
// spreads its work items over all CTAs, and a grid-wide barrier (one atomic
// counter) separates the phases, seven per layer:
//
//   1 rows   x += down partials of the layer before (x = x0 at layer 0);
//            hn = bf16(rms_norm(x))
//   2 gemm   qkv partials = hn @ Wqkv
//   3 attn   one CTA per (row, kv head): sum partials + bias, rope, quantize
//            and write the new k/v, then the cache in chunks of 512 keys on
//            the tensor cores: scores^T = K Q^T, softmax state, out^T += V^T P^T
//   4 gemm   o partials = att @ Wo
//   5 rows   x += o partials; hn = bf16(rms_norm(x))
//   6 gemm   gu = bf16(silu(bf16(hn @ Wgate)) * (hn @ Wup))
//   7 gemm   down partials = gu @ Wdown
//
// A gemm phase cuts the depth into KS contiguous slices. A CTA stages its
// slice of the activations (all 64 rows, up to 1536 deep) in shared memory
// once and then walks 16-column output tiles; the 8 warps of a tile split
// the slice's 64-deep k-blocks, multiply on the tensor cores (mma.sync
// m16n8k16 bf16, A fragments by ldmatrix, int8 -> bf16 converted in
// registers, which is exact) and add their partial tiles up through shared
// memory in warp order, so the result does not change from run to run. The
// slices make enough work items for the products with few output columns
// and keep the staged activations small; their partial sums are added, in
// slice order, by the phase that consumes them. The weights are packed by
// pack_decode_weights as [N/8][K/64][8][64] with the 64 depths of a row
// ordered for the mma B fragments: one warp load is 512 contiguous bytes,
// and the 16 bytes a thread holds are its fragments of four k-steps.
// Activations are read with ld.global.cg: they were written by other CTAs
// before the last barrier and must not come from a stale L1 line. The
// attention phase multiplies the int8 cache rows as fp16 (exact) against q
// and p split into fp16 high and low parts, f32 sums: f32-class products on
// the tensor cores, a quarter of the instructions of the scalar form it
// replaced. Measured and not kept (no gain): L2 prefetch of the next
// phase's weights and of the layer's cache, weight loads one tile ahead,
// more loads in flight in the attention loops. wgmma, a TMA weight stream,
// warp specialization and fewer barriers are later work.

#include "common.cuh"

#include <cuda_fp16.h>

namespace {

constexpr int NW = 8;         // warps per CTA
constexpr int NTHREADS = NW * 32;
constexpr int MAXG = 8;       // most query heads per kv head
constexpr int KBLK = 64;      // k-block depth of the packed weights
constexpr int NTILE = 16;     // output columns of a gemm work item
constexpr int MROWS = 64;     // batch rows per row block
constexpr int KS_MAX = 16;    // most K-slices of a product (MAX_SLICES of the wrapper, which sizes `part`)
constexpr int APAD = 8;       // bf16 of padding after a staged row of A (no bank conflicts)
constexpr int SMEM_CAP = 232448;  // shared memory a CTA can have on sm_90

struct MegaArgs {
  const int8_t* stream;        // [L, layer_bytes] packed int8 weights
  const float* scales;         // [L, Wqkv + D + F + F + D]
  const float* norms;          // [L, 2, D]
  const float* bias;           // [L, Wqkv]
  const __nv_bfloat16* x0;     // [B, D]
  const float* cos_tab;        // [S_rope, HD]
  const float* sin_tab;
  int8_t* kc;                  // [L, B, S, KVD]
  int8_t* vc;
  float* ks;                   // [L, B, S]
  float* vs;
  const int* wps;              // [B]
  const int* positions;        // [B]
  const int* starts;           // [B]
  __nv_bfloat16* out;          // [B, D]
  float* x;                    // [B, D] residual stream
  __nv_bfloat16* hn;           // [B, D]
  __nv_bfloat16* att;          // [B, D]
  __nv_bfloat16* gu;           // [B, F]
  float* part;                 // [KS_MAX, B, max(Wqkv, D)]
  unsigned* bar;               // grid barrier counter, 0 at launch
  unsigned long long* clock;   // [L * 7 + 2] %globaltimer at every phase edge, or null
  int B, S, L, D, H, KV, HD, F, S_rope;
  int ks_qkv, ks_o, ks_down;
  float eps, scale;
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Phase edge `edge` as CTA 0 sees it (only where the caller asked for it).
__device__ __forceinline__ void stamp(unsigned long long* clock, int edge) {
  if (clock != nullptr && blockIdx.x == 0 && threadIdx.x == 0) clock[edge] = global_ns();
}

// Every CTA of the (co-resident) grid arrives; `target` counts arrivals.
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned& target) {
  target += gridDim.x;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    while (ld_acquire(bar) < target) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_f16(float (&c)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// (x, y) as an fp16 pair plus the fp16 pair of what that rounding lost: the
// two together carry the f32 values to ~2^-22, so a product fed with both
// parts is as good as an f32 one.
__device__ __forceinline__ void split_h2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __half2 h = __floats2half2_rn(x, y);
  const float2 back = __half22float2(h);
  const __half2 l = __floats2half2_rn(x - back.x, y - back.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Two int8, each already xor 0x80 and sitting in bytes 0 and 2 of `packed`
// (the other bytes are ignored) -> an fp16 pair, exact: byte u in the
// mantissa of 1024 gives 1024 + u, less 1152 leaves the int8 value.
__device__ __forceinline__ uint32_t h2_from_u8(uint32_t packed) {
  const uint32_t v = (packed & 0x00FF00FFu) | 0x64006400u;
  const __half2 r = __hsub2(*reinterpret_cast<const __half2*>(&v), __float2half2_rn(1152.f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Four int8 (k, k+1, k+2, k+3 in ascending bytes) -> two bf16x2 registers.
// Byte b + 128 is dropped into the mantissa of 2^23, which gives the float
// 2^23 + 128 + b exactly; the subtraction leaves b.
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

__device__ __forceinline__ float block_sum(float v, float* sm) {
  v = rlinf_warp_sum(v);
  __syncthreads();
  if (threadIdx.x % 32 == 0) sm[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) t += sm[w];
  return t;
}

__device__ __forceinline__ float block_max(float v, float* sm) {
  v = rlinf_warp_max(v);
  __syncthreads();
  if (threadIdx.x % 32 == 0) sm[threadIdx.x / 32] = v;
  __syncthreads();
  float t = sm[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) t = fmaxf(t, sm[w]);
  return t;
}

// Phases 1 and 5 (and the last pass): one CTA per batch row.
//   x[row] = first ? x0[row] : x[row] + sum_s part[s][row]
//   norm_w ? hn[row] = bf16(rms_norm(x[row]) * norm_w) : out[row] = bf16(x[row])
__device__ void rows_phase(const MegaArgs& a, bool first, int n_part, const float* norm_w,
                           float* smem) {
  const int D = a.D;
  for (int row = blockIdx.x; row < a.B; row += gridDim.x) {
    float* xr = a.x + (size_t)row * D;
    float ss = 0.f;
    for (int i = threadIdx.x; i < D; i += NTHREADS) {
      float v;
      if (first) {
        v = __bfloat162float(a.x0[(size_t)row * D + i]);
      } else {
        v = __ldcg(xr + i);
        for (int s = 0; s < n_part; ++s) v += __ldcg(a.part + ((size_t)s * a.B + row) * D + i);
      }
      xr[i] = v;
      ss = fmaf(v, v, ss);
      if (norm_w == nullptr) a.out[(size_t)row * D + i] = __float2bfloat16(v);
    }
    if (norm_w != nullptr) {
      const float var = block_sum(ss, smem) / static_cast<float>(D);
      const float rstd = rsqrtf(var + a.eps);
      for (int i = threadIdx.x; i < D; i += NTHREADS)  // each thread re-reads its own writes
        a.hn[(size_t)row * D + i] = __float2bfloat16((xr[i] * rstd) * norm_w[i]);
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Gemm phases. The depth K is cut into KS contiguous slices; CTA c works on
// slice c % KS: it stages that slice of A (all rows) in shared memory once,
// then walks the 16-column tiles c / KS, c / KS + peers, ... of the output.
// NB = 1: part[s][row][n] = (A[:, slice s] @ W[slice s])[row][n] * scale[n].
// NB = 2 (gate and up share A, KS = 1):
// gu[row][n] = bf16(silu(bf16(A @ Wg * sg)) * (A @ Wu * su)).
template <int NB>
__device__ void gemm_phase(const MegaArgs& a, const __nv_bfloat16* A, int K, int N,
                           const int8_t* W0, const int8_t* W1, const float* sc0,
                           const float* sc1, int KS, float* smem) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int KBn = K / KBLK, KBs = KBn / KS, KW = KBs * KBLK, LDA = KW + APAD;
  const int n_tiles = N / NTILE;
  const int s = blockIdx.x % KS, rank = blockIdx.x / KS;
  const int peers = (gridDim.x - s + KS - 1) / KS;  // CTAs that work on slice s
  constexpr int U = 3;                              // k-blocks a warp has in flight
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [MROWS][LDA]
  float* red = reinterpret_cast<float*>(As + (size_t)MROWS * LDA);  // [2][NW][16][32]
  // ldmatrix: lanes 0-7 rows 0-7, 8-15 rows 8-15 (k 0-7); 16-31 the same rows at k 8-15
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lcol = (lane >> 4) * 8;
  int par = 0;

  for (int r0 = 0; r0 < a.B; r0 += MROWS) {
    const int rows = min(MROWS, a.B - r0);
    const int MT = (rows + 15) / 16;
    // a warp's weights of k-blocks kb0, kb0 + NW, ... of tile nt (U in flight)
    uint4 wv[NB][2][U];
    auto load_w = [&](int nt, int kb0) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kbl = kb0 + u * NW;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int8_t* W = nb == 0 ? W0 : W1;
            const size_t at =
                ((((size_t)(nt * 2 + h)) * KBn + s * KBs + kbl) * 8 + g) * KBLK + 16 * t;
            wv[nb][h][u] = kbl < KBs ? __ldg(reinterpret_cast<const uint4*>(W + at))
                                     : make_uint4(0u, 0u, 0u, 0u);
          }
      }
    };
    const int cpr = KW / 8;  // 16-byte chunks a row
    for (int idx = threadIdx.x; idx < MT * 16 * cpr; idx += NTHREADS) {
      const int row = idx / cpr, c = idx % cpr;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row < rows)
        v = __ldcg(reinterpret_cast<const uint4*>(A + (size_t)(r0 + row) * K + (size_t)s * KW + c * 8));
      *reinterpret_cast<uint4*>(As + (size_t)row * LDA + c * 8) = v;
    }
    __syncthreads();

    for (int nt = rank; nt < n_tiles; nt += peers) {
      // this thread's output column in the reduce rounds below, and its scales
      const int n = nt * NTILE + (warp >> 2) * 8 + 2 * t + (warp & 1);
      const float scale0 = sc0[n];
      const float scale1 = NB == 2 ? sc1[n] : 0.f;
      float acc[NB][2][4][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[nb][h][mt][e] = 0.f;

      // the slice's k-blocks: the i-th goes to warp i % NW
      for (int kb0 = warp; kb0 < KBs; kb0 += NW * U) {
        load_w(nt, kb0);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int kbl = kb0 + u * NW;
          if (kbl >= KBs) break;  // uniform across the warp
          // the B fragments of this k-block's four mma steps, converted once
          uint32_t bf[NB][2][4][2];
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint4 w4 = wv[nb][h][u];
              cvt_i8x4(w4.x, bf[nb][h][0]);
              cvt_i8x4(w4.y, bf[nb][h][1]);
              cvt_i8x4(w4.z, bf[nb][h][2]);
              cvt_i8x4(w4.w, bf[nb][h][3]);
            }
          // A fragments of k-step j + 1 are fetched before the mma of step j
          // (the asm statements keep their order, so the order is set here)
          uint32_t af[2][4][4];
          const __nv_bfloat16* a_at = As + (size_t)lrow * LDA + kbl * KBLK + lcol;
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
            if (mt < MT) ldmatrix_x4(af[0][mt], a_at + (size_t)mt * 16 * LDA);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j + 1 < 4) {
#pragma unroll
              for (int mt = 0; mt < 4; ++mt)
                if (mt < MT)
                  ldmatrix_x4(af[(j + 1) & 1][mt], a_at + (size_t)mt * 16 * LDA + (j + 1) * 16);
            }
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) {
              if (mt >= MT) break;  // uniform across the CTA
#pragma unroll
              for (int nb = 0; nb < NB; ++nb)
#pragma unroll
                for (int h = 0; h < 2; ++h) mma_bf16(acc[nb][h][mt], af[j & 1][mt], bf[nb][h][j]);
            }
          }
        }
      }

      // the 8 warps' partial tiles, 16 rows a round: every warp writes its
      // fragments, then warp w adds up fragment register w (and w + 8, the
      // up-projection's) of all warps in warp order and finishes it
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt >= MT) break;
        float* buf = red + (size_t)par * NW * 16 * 32;
        par ^= 1;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              buf[(warp * 16 + nb * 8 + h * 4 + e) * 32 + lane] = acc[nb][h][mt][e];
        __syncthreads();
        float sum[NB];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          sum[nb] = 0.f;
#pragma unroll
          for (int w = 0; w < NW; ++w) sum[nb] += buf[(w * 16 + nb * 8 + warp) * 32 + lane];
        }
        const int row = mt * 16 + g + (warp & 2 ? 8 : 0);
        if (row < rows) {
          if constexpr (NB == 1) {
            a.part[((size_t)s * a.B + r0 + row) * N + n] = sum[0] * scale0;
          } else {
            const float gate = __bfloat162float(__float2bfloat16(sum[0] * scale0));
            const float up = sum[1] * scale1;
            const float act = gate * (1.f / (1.f + expf(-gate))) * up;
            a.gu[(size_t)(r0 + row) * N + n] = __float2bfloat16(act);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this row block's A
  }
}

constexpr int CH = 512;      // past keys handled per softmax chunk (a multiple of 16)

// Phase 3: attention of layer `layer`, one CTA per (batch row, kv head), on
// the tensor cores. The past keys go by in chunks of CH; a warp takes 16
// keys at a time. Per chunk: (1) scores^T [keys x heads] = K [keys x dims]
// Q^T: A fragments straight from the int8 key rows (thread (g, t) loads 16
// contiguous bytes of keys g and g + 8; which dim sits in which k-slot only
// has to agree with Q^T, which is laid out to match), B fragments q as fp16
// high + low parts; (2) one warp a query head takes the chunk's max,
// rescales the running state and turns the scores into probabilities times
// the value scale; (3) out^T [dims x heads] += V^T [dims x keys] P^T: A
// fragments from the int8 value rows (thread (g, t) loads the 16 dims
// 16 g ... of keys 4 t ... 4 t + 3 and pairs bytes of two keys), B fragments
// p as fp16 high + low. int8 -> fp16 is exact and the sums are f32, so the
// result is that of f32 products. The current token enters exactly in f32
// as the initial state (m = s_cur, l = 1, acc = v).
template <int DPL>
__device__ void attn_phase(const MegaArgs& a, int layer, float* smem) {
  constexpr int HD = DPL * 32;
  constexpr int NV = HD / 64;   // 64-dim blocks of a head
  constexpr int MT = HD / 16;   // 16-dim tiles of out^T
  const int B = a.B, S = a.S, H = a.H, KV = a.KV, D = a.D;
  const int G = H / KV, KVD = KV * HD, QD = H * HD, W = QD + 2 * KVD;
  const int half = HD / 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // shared: acc [NW][MAXG][HD] | m, l, alpha [MAXG] each | scratch [NW] | row [W]
  //         | scores [MAXG][CH] | value scales [CH]
  float* sm_acc = smem;
  float* sm_m = sm_acc + NW * MAXG * HD;
  float* sm_l = sm_m + MAXG;
  float* sm_alpha = sm_l + MAXG;
  float* sm_red = sm_alpha + MAXG;
  float* row = sm_red + NW;
  float* sc = row + W;
  float* vsm = sc + (size_t)MAXG * CH;
  const float* bias = a.bias + (size_t)layer * W;

  for (int item = blockIdx.x; item < B * KV; item += gridDim.x) {
    const int b = item / KV, kvh = item % KV;
    // qkv row: K-slice partials in slice order, then the bias
    for (int i = threadIdx.x; i < W; i += NTHREADS) {
      float v = 0.f;
      for (int s = 0; s < a.ks_qkv; ++s) v += __ldcg(a.part + ((size_t)s * B + b) * W + i);
      row[i] = v + bias[i];
    }
    __syncthreads();
    // rope in place on the head bands: this group's q heads and every k head
    const int pos = min(max(a.positions[b], 0), a.S_rope - 1);
    const float* cs = a.cos_tab + (size_t)pos * HD;
    const float* sn = a.sin_tab + (size_t)pos * HD;
    for (int i = threadIdx.x; i < (G + KV) * half; i += NTHREADS) {
      const int hh = i / half, d = i % half;
      const int at = (hh < G ? (kvh * G + hh) * HD : QD + (hh - G) * HD) + d;
      const float x1 = row[at], x2 = row[at + half];
      row[at] = x1 * cs[d] + (-x2) * sn[d];
      row[at + half] = x2 * cs[d + half] + x1 * sn[d + half];
    }
    __syncthreads();
    // per-token scales over the whole packed k and v rows
    float kmax = 0.f, vmax = 0.f;
    for (int i = threadIdx.x; i < KVD; i += NTHREADS) {
      kmax = fmaxf(kmax, fabsf(row[QD + i]));
      vmax = fmaxf(vmax, fabsf(row[QD + KVD + i]));
    }
    const float ksv = fmaxf(block_max(kmax, sm_red) / 127.f, 1e-8f);
    const float vsv = fmaxf(block_max(vmax, sm_red) / 127.f, 1e-8f);
    const int wp_raw = a.wps[b];
    const int wp = min(max(wp_raw, 0), S - 1);
    const size_t slot = ((size_t)layer * B + b) * S + wp;
    for (int d = threadIdx.x; d < HD; d += NTHREADS) {
      const float kq8 = fminf(fmaxf(rintf(row[QD + kvh * HD + d] / ksv), -127.f), 127.f);
      const float vq8 = fminf(fmaxf(rintf(row[QD + KVD + kvh * HD + d] / vsv), -127.f), 127.f);
      a.kc[slot * KVD + kvh * HD + d] = static_cast<int8_t>(kq8);
      a.vc[slot * KVD + kvh * HD + d] = static_cast<int8_t>(vq8);
    }
    if (kvh == 0 && threadIdx.x == 0) {
      a.ks[slot] = ksv;
      a.vs[slot] = vsv;
    }

    // Q^T as B fragments: thread (g, t) holds head g; k-step j of block v puts
    // dims 64 v + 16 t + 4 j + {0, 1} in slots 2t, 2t + 1 and + {2, 3} in
    // slots 2t + 8, 2t + 9, as the key bytes a thread loads fall
    uint32_t qh[NV][4][2], ql[NV][4][2];
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float4 q4 = make_float4(0.f, 0.f, 0.f, 0.f);
        if (g < G)
          q4 = *reinterpret_cast<const float4*>(row + (kvh * G + g) * HD + 64 * v + 16 * t + 4 * j);
        split_h2(q4.x, q4.y, qh[v][j][0], ql[v][j][0]);
        split_h2(q4.z, q4.w, qh[v][j][1], ql[v][j][1]);
      }
    // the current token (exact f32): the state every chunk then rescales
    if (warp < G) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        d = fmaf(row[(kvh * G + warp) * HD + lane * DPL + i], row[QD + kvh * HD + lane * DPL + i], d);
      d = rlinf_warp_sum(d) * a.scale;
      if (lane == 0) {
        sm_m[warp] = d;
        sm_l[warp] = 1.f;
      }
    }
    // out^T fragments: thread (g, t) holds heads 2t, 2t + 1 of the dims
    // (HD / 8) g + 2 mt (c0, c1) and + 2 mt + 1 (c2, c3)
    float acc[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int head = 2 * t + (e & 1), dim = (HD / 8) * g + 2 * mt + (e >> 1);
        acc[mt][e] = (warp == 0 && head < G) ? row[QD + KVD + kvh * HD + dim] : 0.f;
      }
    __syncthreads();

    const int start = max(a.starts[b], 0);
    const int end = min(wp_raw, S);
    const int8_t* kcb = a.kc + ((size_t)layer * B + b) * S * KVD + kvh * HD;
    const int8_t* vcb = a.vc + ((size_t)layer * B + b) * S * KVD + kvh * HD;
    const float* ksb = a.ks + ((size_t)layer * B + b) * S;
    const float* vsb = a.vs + ((size_t)layer * B + b) * S;
    for (int c0 = start; c0 < end; c0 += CH) {
      const int n_c = min(CH, end - c0);
      // (1) scores: warp w takes the 16-key groups w, w + 8, ...
      for (int kb = warp * 16; kb < n_c; kb += NW * 16) {
        const int klA = kb + g, klB = kb + g + 8;
        const size_t keyA = (size_t)(c0 + min(klA, n_c - 1)), keyB = (size_t)(c0 + min(klB, n_c - 1));
        uint4 kwA[NV], kwB[NV];
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          kwA[v] = __ldcg(reinterpret_cast<const uint4*>(kcb + keyA * KVD) + v * 4 + t);
          kwB[v] = __ldcg(reinterpret_cast<const uint4*>(kcb + keyB * KVD) + v * 4 + t);
        }
        const float fA = a.scale * __ldcg(ksb + keyA), fB = a.scale * __ldcg(ksb + keyB);
        const float vsA = __ldcg(vsb + keyA), vsB = __ldcg(vsb + keyB);
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const uint32_t wa[4] = {kwA[v].x ^ 0x80808080u, kwA[v].y ^ 0x80808080u,
                                  kwA[v].z ^ 0x80808080u, kwA[v].w ^ 0x80808080u};
          const uint32_t wb[4] = {kwB[v].x ^ 0x80808080u, kwB[v].y ^ 0x80808080u,
                                  kwB[v].z ^ 0x80808080u, kwB[v].w ^ 0x80808080u};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t af[4] = {h2_from_u8(__byte_perm(wa[j], 0u, 0x0100)),
                                    h2_from_u8(__byte_perm(wb[j], 0u, 0x0100)),
                                    h2_from_u8(__byte_perm(wa[j], 0u, 0x0302)),
                                    h2_from_u8(__byte_perm(wb[j], 0u, 0x0302))};
            mma_f16(c, af, qh[v][j]);
            mma_f16(c, af, ql[v][j]);
          }
        }
        // c0, c1: key A, heads 2t, 2t + 1; c2, c3: key B
        if (klA < n_c) {
          if (2 * t < G) sc[(2 * t) * CH + klA] = c[0] * fA;
          if (2 * t + 1 < G) sc[(2 * t + 1) * CH + klA] = c[1] * fA;
          if (t == 0) vsm[klA] = vsA;
        }
        if (klB < n_c) {
          if (2 * t < G) sc[(2 * t) * CH + klB] = c[2] * fB;
          if (2 * t + 1 < G) sc[(2 * t + 1) * CH + klB] = c[3] * fB;
          if (t == 0) vsm[klB] = vsB;
        }
      }
      __syncthreads();
      // (2) one warp a query head: the chunk's max, the running state, p * v_scale
      if (warp < G) {
        float* sh = sc + warp * CH;
        float mx = RLINF_NEG_INF;
        for (int k = lane; k < n_c; k += 32) mx = fmaxf(mx, sh[k]);
        mx = rlinf_warp_max(mx);
        const float m_old = sm_m[warp];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int k = lane; k < ((n_c + 15) & ~15); k += 32) {
          float pv = 0.f;  // the tail of the last 16-key group counts for nothing
          if (k < n_c) {
            const float p = expf(sh[k] - m_new);
            sum += p;
            pv = p * vsm[k];
          }
          sh[k] = pv;
        }
        sum = rlinf_warp_sum(sum);
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          sm_alpha[warp] = alpha;
          sm_l[warp] = sm_l[warp] * alpha + sum;
          sm_m[warp] = m_new;
        }
      }
      __syncthreads();
      // (3) values
      {
        const float al0 = 2 * t < G ? sm_alpha[2 * t] : 0.f;
        const float al1 = 2 * t + 1 < G ? sm_alpha[2 * t + 1] : 0.f;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          acc[mt][0] *= al0;
          acc[mt][1] *= al1;
          acc[mt][2] *= al0;
          acc[mt][3] *= al1;
        }
      }
      for (int kb = warp * 16; kb < n_c; kb += NW * 16) {
        // keys 4t ... 4t + 3 of the group, the thread's HD / 8 dims of each
        uint32_t vw[4][HD / 32];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const size_t key = (size_t)(c0 + min(kb + 4 * t + i, n_c - 1));
          const int8_t* p = vcb + key * KVD + (HD / 8) * g;
          if constexpr (HD == 128) {
            const uint4 v4 = __ldcg(reinterpret_cast<const uint4*>(p));
            vw[i][0] = v4.x ^ 0x80808080u;
            vw[i][1] = v4.y ^ 0x80808080u;
            vw[i][2] = v4.z ^ 0x80808080u;
            vw[i][3] = v4.w ^ 0x80808080u;
          } else {
            const uint2 v2 = __ldcg(reinterpret_cast<const uint2*>(p));
            vw[i][0] = v2.x ^ 0x80808080u;
            vw[i][1] = v2.y ^ 0x80808080u;
          }
        }
        // P^T as B fragments: head g, keys 4t, 4t + 1 (slots 2t, 2t + 1) and
        // 4t + 2, 4t + 3 (slots 2t + 8, 2t + 9)
        float4 p4 = make_float4(0.f, 0.f, 0.f, 0.f);
        if (g < G) p4 = *reinterpret_cast<const float4*>(sc + g * CH + kb + 4 * t);
        uint32_t ph[2], pl[2];
        split_h2(p4.x, p4.y, ph[0], pl[0]);
        split_h2(p4.z, p4.w, ph[1], pl[1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          // rows g and g + 8 of the tile: bytes 2 mt and 2 mt + 1 of the thread's dims
          constexpr uint32_t SEL[4] = {0x0400, 0x0501, 0x0602, 0x0703};
          const int w = (2 * mt) / 4, r = (2 * mt) % 4;
          const uint32_t af[4] = {h2_from_u8(__byte_perm(vw[0][w], vw[1][w], SEL[r])),
                                  h2_from_u8(__byte_perm(vw[0][w], vw[1][w], SEL[r + 1])),
                                  h2_from_u8(__byte_perm(vw[2][w], vw[3][w], SEL[r])),
                                  h2_from_u8(__byte_perm(vw[2][w], vw[3][w], SEL[r + 1]))};
          mma_f16(acc[mt], af, ph);
          mma_f16(acc[mt], af, pl);
        }
      }
      __syncthreads();  // the next chunk's scores overwrite this one's
    }

#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int head = 2 * t + (e & 1), dim = (HD / 8) * g + 2 * mt + (e >> 1);
        if (head < G) sm_acc[(warp * MAXG + head) * HD + dim] = acc[mt][e];
      }
    __syncthreads();
    for (int idx = threadIdx.x; idx < G * HD; idx += NTHREADS) {
      const int gi = idx / HD, d = idx % HD;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) sum += sm_acc[(w * MAXG + gi) * HD + d];
      a.att[(size_t)b * D + (kvh * G + gi) * HD + d] =
          __float2bfloat16(sum / fmaxf(sm_l[gi], 1e-30f));
    }
    __syncthreads();
  }
}

template <int DPL>
__global__ void __launch_bounds__(NTHREADS, 1) mega_kernel(const MegaArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int D = a.D, F = a.F;
  const int W = (a.H + 2 * a.KV) * a.HD;
  const size_t off_o = (size_t)D * W, off_gate = off_o + (size_t)D * D;
  const size_t off_up = off_gate + (size_t)D * F, off_down = off_up + (size_t)D * F;
  const size_t layer_bytes = off_down + (size_t)F * D;
  const int sc_stride = W + D + F + F + D;
  unsigned target = 0;

  stamp(a.clock, 0);
  for (int layer = 0; layer < a.L; ++layer) {
    const int8_t* w = a.stream + (size_t)layer * layer_bytes;
    const float* sc = a.scales + (size_t)layer * sc_stride;
    const float* nw = a.norms + (size_t)layer * 2 * D;
    const int e = layer * 7;

    rows_phase(a, layer == 0, a.ks_down, nw, smem);
    grid_barrier(a.bar, target);
    stamp(a.clock, e + 1);
    gemm_phase<1>(a, a.hn, D, W, w, nullptr, sc, nullptr, a.ks_qkv, smem);
    grid_barrier(a.bar, target);
    stamp(a.clock, e + 2);
    attn_phase<DPL>(a, layer, smem);
    grid_barrier(a.bar, target);
    stamp(a.clock, e + 3);
    gemm_phase<1>(a, a.att, D, D, w + off_o, nullptr, sc + W, nullptr, a.ks_o, smem);
    grid_barrier(a.bar, target);
    stamp(a.clock, e + 4);
    rows_phase(a, false, a.ks_o, nw + D, smem);
    grid_barrier(a.bar, target);
    stamp(a.clock, e + 5);
    gemm_phase<2>(a, a.hn, D, F, w + off_gate, w + off_up, sc + W + D, sc + W + D + F, 1, smem);
    grid_barrier(a.bar, target);
    stamp(a.clock, e + 6);
    gemm_phase<1>(a, a.gu, F, D, w + off_down, nullptr, sc + W + D + 2 * F, nullptr, a.ks_down,
                  smem);
    grid_barrier(a.bar, target);
    stamp(a.clock, e + 7);
  }
  rows_phase(a, false, a.ks_down, nullptr, smem);
  stamp(a.clock, a.L * 7 + 1);
}

constexpr size_t RED_BYTES = sizeof(float) * 2 * NW * 16 * 32;

size_t gemm_smem(int k_blocks) { return (size_t)MROWS * (k_blocks * KBLK + APAD) * 2 + RED_BYTES; }

// K-slices of a product with `n_tiles` 16-column tiles and `k_blocks` 64-deep
// blocks on `grid` CTAs: among the divisors of k_blocks whose slice of A fits
// in shared memory, the one with the least estimated time, counted in
// k-blocks of weights a warp streams: waves of tiles times blocks a warp,
// plus staging the slice of A (8 times the bytes of a weight block, from L2,
// shared by 8 warps). 0 if none fits.
int pick_slices(int grid, int n_tiles, int k_blocks, int ks_most) {
  int best = 0;
  float best_cost = 0.f;
  for (int ks = 1; ks <= ks_most && ks <= k_blocks; ++ks) {
    if (k_blocks % ks != 0) continue;
    const int kbs = k_blocks / ks;
    if (gemm_smem(kbs) > (size_t)SMEM_CAP) continue;
    const int waves = (n_tiles * ks + grid - 1) / grid;
    const float cost = (float)waves * (float)((kbs + NW - 1) / NW) + 0.625f * (float)kbs;
    if (best == 0 || cost < best_cost) {
      best = ks;
      best_cost = cost;
    }
  }
  return best;
}

template <int DPL>
int launch(MegaArgs& a, int device, cudaStream_t st) {
  const int W = (a.H + 2 * a.KV) * a.HD;
  cudaError_t err;
  int coop = 0, sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const int grid = sms;  // one persistent CTA on every SM
  const int kb_d = a.D / KBLK, kb_f = a.F / KBLK;
  a.ks_qkv = pick_slices(grid, W / NTILE, kb_d, KS_MAX);
  a.ks_o = pick_slices(grid, a.D / NTILE, kb_d, KS_MAX);
  a.ks_down = pick_slices(grid, a.D / NTILE, kb_f, KS_MAX);
  // gate/up need the whole depth in one CTA (SiLU follows the sum): one slice
  if (a.ks_qkv == 0 || a.ks_o == 0 || a.ks_down == 0 || pick_slices(grid, a.F / NTILE, kb_d, 1) != 1)
    return cudaErrorInvalidValue;
  size_t smem = sizeof(float) * ((size_t)NW * MAXG * a.HD + 3 * MAXG + NW + W +
                                 (size_t)CH * (MAXG + 1));
  const size_t gemm_bytes = gemm_smem(kb_d) > gemm_smem(kb_f / a.ks_down) ? gemm_smem(kb_d)
                                                                            : gemm_smem(kb_f / a.ks_down);
  if (gemm_bytes > smem) smem = gemm_bytes;
  err = cudaFuncSetAttribute(mega_kernel<DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mega_kernel<DPL>, NTHREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  if ((err = cudaMemsetAsync(a.bar, 0, sizeof(unsigned), st)) != cudaSuccess) return err;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(mega_kernel<DPL>), dim3(grid),
                                    dim3(NTHREADS), params, smem, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" int decode_megakernel(
    int device, const void* stream_w, const void* scales, const void* norms, const void* bias,
    const void* x0, const void* cos_tab, const void* sin_tab, void* kc, void* vc, void* ks,
    void* vs, const void* wps, const void* positions, const void* starts, void* out, void* x,
    void* hn, void* att, void* gu, void* part, void* bar, void* clock, int B, int S, int L, int D,
    int H,
    int KV, int HD, int F, int S_rope, float eps, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int W = (H + 2 * KV) * HD;
  if (B <= 0 || KV <= 0 || H % KV != 0 || H / KV > MAXG || H * HD != D || D % KBLK != 0 ||
      F % KBLK != 0 || W % NTILE != 0 || D % NTILE != 0 || F % NTILE != 0)
    return cudaErrorInvalidValue;
  MegaArgs a;
  a.stream = static_cast<const int8_t*>(stream_w);
  a.scales = static_cast<const float*>(scales);
  a.norms = static_cast<const float*>(norms);
  a.bias = static_cast<const float*>(bias);
  a.x0 = static_cast<const __nv_bfloat16*>(x0);
  a.cos_tab = static_cast<const float*>(cos_tab);
  a.sin_tab = static_cast<const float*>(sin_tab);
  a.kc = static_cast<int8_t*>(kc);
  a.vc = static_cast<int8_t*>(vc);
  a.ks = static_cast<float*>(ks);
  a.vs = static_cast<float*>(vs);
  a.wps = static_cast<const int*>(wps);
  a.positions = static_cast<const int*>(positions);
  a.starts = static_cast<const int*>(starts);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.x = static_cast<float*>(x);
  a.hn = static_cast<__nv_bfloat16*>(hn);
  a.att = static_cast<__nv_bfloat16*>(att);
  a.gu = static_cast<__nv_bfloat16*>(gu);
  a.part = static_cast<float*>(part);
  a.bar = static_cast<unsigned*>(bar);
  a.clock = static_cast<unsigned long long*>(clock);
  a.B = B; a.S = S; a.L = L; a.D = D; a.H = H; a.KV = KV; a.HD = HD; a.F = F;
  a.S_rope = S_rope;
  a.ks_qkv = a.ks_o = a.ks_down = 1;
  a.eps = eps;
  a.scale = scale;
  const auto st = static_cast<cudaStream_t>(stream);
  if (HD == 128) return launch<4>(a, device, st);
  if (HD == 64) return launch<2>(a, device, st);
  return cudaErrorInvalidValue;
}
