// Kernel K10: one-token GQA decode attention over a paged KV pool.
//
// Replaces the Pallas TPU kernel _kernel of
// rlinf_tpu/ops/pallas/paged_attention.py (paged_attention). Same function:
// the KV cache is a global pool of pages [num_pages, Kv, P, Hd]; row b owns
// the pages page_table[b, 0..], and attends its one query token over the
// first lengths[b] token positions of that chain (online softmax, f32).
// A row with lengths[b] == 0 (an unoccupied slot) gives 0. Table entries
// past ceil(lengths[b] / P) are padding and are never read.
//
// What bounds it on an H100: bytes, those of the valid pages. Each byte is
// used for 2 G operations (G = 6 at Qwen2-1.5B); at the paged engine's
// shapes (B=64, Kv=2, up to 48 pages of 16) one CTA per (row, kv head)
// would be 128 CTAs on 132 SMs, one wave of long dependent chains. The TPU
// kernel hides its page copies behind a sequential grid (the Mosaic
// pipeline double-buffers them); here the work is cut finer and every page
// is in flight before it is needed:
//  * Split-KV (flash-decoding). The grid is (row, kv head, split); a split
//    is a run of `pps` whole pages, with pps chosen on the host so that the
//    grid covers the SMs several times (ops/cuda/paged_attention.py
//    split_plan). A split past the row's last page returns at once. Each
//    split writes its partial state (row max m in log2 units, sum l, and
//    the unnormalised f32 output of its G heads) to scratch; a second
//    small kernel merges the splits of each (row, query head) and writes
//    bf16.
//  * Staging. One kv head's slice of a page is P x Hd contiguous bf16
//    (4 KB at P=16, Hd=128). A CTA has four warps; warp w takes pages w,
//    w + 4, ... of the split, each page's K and V slices brought into a
//    ring of two stages of its own by two 1-D bulk asynchronous copies
//    completing on an mbarrier: the next page lands while this one is used.
//  * Products on the tensor cores, per 16 keys rather than per token. The
//    G <= 16 query heads are the 16 rows of mma.sync m16n8k16 (zero rows
//    past G). S = Q K^T reads a K row's 16 bytes a lane with the depth
//    permuted the same way in the Q fragments (held in registers for the
//    whole split); P V takes P as hi + lo bf16 parts (an f32 P, as the
//    plain version) and V's B fragments from 16-byte loads turned by
//    movmatrix.trans, so neither needs a padded or swizzled stage. One
//    max and one sum reduction a 16-key block, over the four lanes of a row.
//  * The four warps' states are merged through shared memory at the end of
//    the split.

#include "hopper.cuh"

namespace {

constexpr int NW = 4;    // warps per CTA, each with its own pages
constexpr int MAXG = 16;  // query heads per kv head: the 16 rows of the products
constexpr float LOG2E = 1.4426950408889634f;

// Dynamic shared memory: the warps' rings (two stages of a K and a V page
// slice each), reused at the end for the merge of the warps' states.
__host__ __device__ constexpr int ring_bytes(int P, int HD) { return NW * 2 * 2 * P * HD * 2; }
__host__ __device__ constexpr int merge_bytes(int HD) { return NW * MAXG * (HD + 2) * 4; }

struct Args {
  const __nv_bfloat16 *q, *k_pages, *v_pages;
  const int *page_table, *lengths;
  float *part_ml, *part_o;  // [B * KV, NS, G, 2] and [B * KV, NS, G, HD] f32
  __nv_bfloat16* out;
  int B, H, KV, P, MAXP, PPS, NS;
  float scale;
};

__device__ __forceinline__ int row_pages(const Args& a, int b) {
  const int len = min(max(a.lengths[b], 0), a.MAXP * a.P);
  return (len + a.P - 1) / a.P;
}

template <int HD>
__global__ void __launch_bounds__(NW * 32, 3) paged_split_kernel(const Args a) {
  constexpr int NC = HD / 32;  // 32-column chunks of a row
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ uint64_t full[NW][2];
  const int sp = blockIdx.x % a.NS, bk = blockIdx.x / a.NS;
  const int b = bk / a.KV, kvh = bk % a.KV, G = a.H / a.KV;
  const int len = min(max(a.lengths[b], 0), a.MAXP * a.P);
  const int npg = (len + a.P - 1) / a.P;
  const int p0 = sp * a.PPS;
  if (p0 >= npg) return;  // past the row's last page: no work, no partial
  const int p1 = min(p0 + a.PPS, npg);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const uint32_t page_bytes = a.P * HD * 2;
  const uint32_t ring = smem_u32(smem_raw) + warp * 4 * page_bytes;
  const int n_mine = p1 - p0 > warp ? (p1 - p0 - warp + NW - 1) / NW : 0;

  if (lane == 0) {
    mbar_init(smem_u32(&full[warp][0]), 1);
    mbar_init(smem_u32(&full[warp][1]), 1);
    mbar_init_fence();
  }
  __syncwarp();
  auto issue = [&](int i) {  // page i of this warp into stage i % 2
    const int page = a.page_table[(size_t)b * a.MAXP + p0 + warp + NW * i];
    const size_t at = ((size_t)page * a.KV + kvh) * a.P * HD;
    const uint32_t bar = smem_u32(&full[warp][i & 1]), dst = ring + (i & 1) * 2 * page_bytes;
    mbar_expect_tx(bar, 2 * page_bytes);
    bulk_load(dst, a.k_pages + at, page_bytes, bar);
    bulk_load(dst + page_bytes, a.v_pages + at, page_bytes, bar);
  };
  if (lane == 0)
    for (int i = 0; i < min(2, n_mine); ++i) issue(i);

  // Q fragments: chunk cc, row g (r = 0) and g + 8 (r = 1), the lane's 8
  // depths cc * 32 + 8 t ..; k-step 2 cc takes words 0, 1 and 2 cc + 1
  // words 2, 3 (the K rows below are read in the same order)
  uint32_t qf[NC][2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int head = g + 8 * r;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      uint4 w = make_uint4(0, 0, 0, 0);
      if (head < G)
        w = *reinterpret_cast<const uint4*>(a.q + ((size_t)b * a.H + kvh * G + head) * HD +
                                            cc * 32 + 8 * t);
      qf[cc][r][0] = w.x;
      qf[cc][r][1] = w.y;
      qf[cc][r][2] = w.z;
      qf[cc][r][3] = w.w;
    }
  }
  const float scale2 = a.scale * LOG2E;
  // heads g (index 0) and g + 8 (index 1); o[cc][w] is the product's n-tile
  // whose column 2 t + e holds depth cc * 32 + 8 t + 2 w + e
  float m[2] = {RLINF_NEG_INF, RLINF_NEG_INF}, l[2] = {0.f, 0.f};
  float o[NC][4][4];
#pragma unroll
  for (int cc = 0; cc < NC; ++cc)
#pragma unroll
    for (int w = 0; w < 4; ++w)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[cc][w][e] = 0.f;

  for (int i = 0; i < n_mine; ++i) {
    mbar_wait(smem_u32(&full[warp][i & 1]), (i >> 1) & 1);
    const unsigned char* stage = smem_raw + (warp * 4 + (i & 1) * 2) * page_bytes;
    const __nv_bfloat16* ks = reinterpret_cast<const __nv_bfloat16*>(stage);
    const __nv_bfloat16* vs = reinterpret_cast<const __nv_bfloat16*>(stage + page_bytes);
    const int tok0 = (p0 + warp + NW * i) * a.P;
    for (int c0 = 0; c0 < a.P; c0 += 16) {
      const bool two = c0 + 16 <= a.P;  // a last block of 8 keys where P % 16 == 8
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        if (nt == 1 && !two) break;
        const __nv_bfloat16* krow = ks + (c0 + 8 * nt + g) * HD + 8 * t;
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const uint4 kw = *reinterpret_cast<const uint4*>(krow + cc * 32);
          const uint32_t a0[4] = {qf[cc][0][0], qf[cc][1][0], qf[cc][0][1], qf[cc][1][1]};
          const uint32_t a1[4] = {qf[cc][0][2], qf[cc][1][2], qf[cc][0][3], qf[cc][1][3]};
          mma_bf16(s[nt], a0, kw.x, kw.y);
          mma_bf16(s[nt], a1, kw.z, kw.w);
        }
      }
      // mask (token past the row's length, or past a half block) and the
      // online softmax of the block; s[nt][2 r + e] is head g + 8 r, key
      // c0 + 8 nt + 2 t + e
      float mx[2] = {m[0], m[1]};
      bool ok[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          ok[nt][e] = (nt == 0 || two) && tok0 + c0 + 8 * nt + 2 * t + e < len;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float& x = s[nt][2 * r + e];
            x = ok[nt][e] ? x * scale2 : RLINF_NEG_INF;
            mx[r] = fmaxf(mx[r], x);
          }
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(RLINF_FULL_MASK, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(RLINF_FULL_MASK, mx[r], 2));
        alpha[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float& x = s[nt][2 * r + e];
            x = ok[nt][e] ? exp2f(x - m[r]) : 0.f;
            l[r] += x;
          }
#pragma unroll
      for (int cc = 0; cc < NC; ++cc)
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          o[cc][w][0] *= alpha[0];
          o[cc][w][1] *= alpha[0];
          o[cc][w][2] *= alpha[1];
          o[cc][w][3] *= alpha[1];
        }
      // P as the A fragment (keys 0..7 of the block from n-tile 0, 8..15
      // from n-tile 1), in hi and lo bf16 parts
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float x0 = s[q >> 1][2 * (q & 1)], x1 = s[q >> 1][2 * (q & 1) + 1];
        const __nv_bfloat162 hv = __floats2bfloat162_rn(x0, x1);
        const float2 hf = __bfloat1622float2(hv);
        ph[q] = *reinterpret_cast<const uint32_t*>(&hv);
        pl[q] = pack_bf16(x0 - hf.x, x1 - hf.y);
      }
      // V: the lane's 16 bytes of key rows g and g + 8 are word w of four
      // 8 x 8 matrices (rows keys, columns depth pairs); transposed, word w
      // is the B fragment of n-tile w
      const __nv_bfloat16* vrow = vs + (c0 + g) * HD + 8 * t;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const uint4 v0 = *reinterpret_cast<const uint4*>(vrow + cc * 32);
        uint4 v1 = make_uint4(0, 0, 0, 0);
        if (two) v1 = *reinterpret_cast<const uint4*>(vrow + 8 * HD + cc * 32);
        const uint32_t w0[4] = {v0.x, v0.y, v0.z, v0.w};
        const uint32_t w1[4] = {v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const uint32_t b0 = movmatrix_t(w0[w]), b1 = two ? movmatrix_t(w1[w]) : 0u;
          mma_bf16(o[cc][w], ph, b0, b1);
          mma_bf16(o[cc][w], pl, b0, b1);
        }
      }
    }
    __syncwarp();  // every lane is done with the stage before it is refilled
    if (lane == 0 && i + 2 < n_mine) issue(i + 2);
  }

  // merge the four warps' states through shared memory (the rings are done)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(RLINF_FULL_MASK, l[r], 1);
    l[r] += __shfl_xor_sync(RLINF_FULL_MASK, l[r], 2);
  }
  __syncthreads();
  float* mo = reinterpret_cast<float*>(smem_raw);  // [NW][MAXG][HD]
  float* mm = mo + NW * MAXG * HD;                 // [NW][MAXG]
  float* ml = mm + NW * MAXG;                      // [NW][MAXG]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int head = g + 8 * r;
    float* row = mo + (warp * MAXG + head) * HD + 8 * t;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
#pragma unroll
      for (int w = 0; w < 4; ++w)
        *reinterpret_cast<float2*>(row + cc * 32 + 2 * w) =
            make_float2(o[cc][w][2 * r], o[cc][w][2 * r + 1]);
    if (t == 0) {
      mm[warp * MAXG + head] = m[r];
      ml[warp * MAXG + head] = l[r];
    }
  }
  __syncthreads();
  const size_t part = (size_t)bk * a.NS + sp;
  for (int idx = threadIdx.x; idx < G * HD; idx += NW * 32) {
    const int gg = idx / HD, d = idx % HD;
    float M = RLINF_NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, mm[w * MAXG + gg]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float e = exp2f(mm[w * MAXG + gg] - M);
      L = fmaf(ml[w * MAXG + gg], e, L);
      A = fmaf(mo[(w * MAXG + gg) * HD + d], e, A);
    }
    a.part_o[(part * G + gg) * HD + d] = A;
    if (d == 0) *reinterpret_cast<float2*>(a.part_ml + (part * G + gg) * 2) = make_float2(M, L);
  }
}

// Head dims 16 and 32, and f16 and f32 pages: the same split over whole
// pages and the same merge, the split on hopper.cuh's any_decode_split
// (mma.sync on tiles of any element type, each warp staging 16 keys' rows
// at a time from their pages). The page-stage layout above cuts rows into
// 32-column chunks of bf16, which a shorter row or an f32 row does not fill.
template <class T, int HD>
__global__ void __launch_bounds__(ANY_NW * 32) paged_any_split_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sp = blockIdx.x % a.NS, bk = blockIdx.x / a.NS;
  const int b = bk / a.KV, kvh = bk % a.KV, G = a.H / a.KV;
  const int len = min(max(a.lengths[b], 0), a.MAXP * a.P);
  const int npg = (len + a.P - 1) / a.P;
  const int p0 = sp * a.PPS;
  if (p0 >= npg) return;  // past the row's last page: no work, no partial
  const int p1 = min(p0 + a.PPS, npg);
  const int* table = a.page_table + (size_t)b * a.MAXP;
  auto rows = [&](const __nv_bfloat16* pages) {
    const T* base = reinterpret_cast<const T*>(pages);
    return [=](int key) -> const T* {
      const int page = table[key / a.P];
      return base + (((size_t)page * a.KV + kvh) * a.P + key % a.P) * HD;
    };
  };
  auto scales = [](int) { return make_float2(1.f, 1.f); };
  const size_t part = (size_t)bk * a.NS + sp;
  any_decode_split<T, T, HD>(reinterpret_cast<const T*>(a.q) + ((size_t)b * a.H + kvh * G) * HD, G,
                             p0 * a.P, min(p1 * a.P, len), 0, len, rows(a.k_pages),
                             rows(a.v_pages), scales, a.scale, a.part_o + part * G * HD,
                             a.part_ml + part * G * 2, smem_raw);
}

// One CTA per (row, kv head, query head), a thread per depth: the used
// splits' partial states merged into out [B, H, HD] of element type T; a
// row of length 0 has none and gives 0.
template <class T>
__global__ void paged_merge_kernel(const Args a, int HD) {
  const int G = a.H / a.KV, bk = blockIdx.x / G, gg = blockIdx.x % G, d = threadIdx.x;
  const int b = bk / a.KV, kvh = bk % a.KV;
  const int used = (row_pages(a, b) + a.PPS - 1) / a.PPS;
  const float* ml = a.part_ml + ((size_t)bk * a.NS * G + gg) * 2;  // split s at + 2 G s
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

template <class T, int HD>
cudaError_t launch_any(const Args& a, cudaStream_t st) {
  constexpr int smem = any_decode_smem<T, HD>();
  cudaError_t err = cudaFuncSetAttribute(paged_any_split_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  paged_any_split_kernel<T, HD><<<a.B * a.KV * a.NS, ANY_NW * 32, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_merge_kernel<T><<<a.B * a.H, HD, 0, st>>>(a, HD);
  return cudaGetLastError();
}

// Element type T at head dim HD: 16 and 32 for every type, 64 and 128 for
// f16 and f32 (bf16 takes the kernel above).
template <class T>
cudaError_t run_any(const Args& a, int HD, cudaStream_t st) {
  if (HD == 16) return launch_any<T, 16>(a, st);
  if (HD == 32) return launch_any<T, 32>(a, st);
  if constexpr (!std::is_same<T, __nv_bfloat16>::value) {
    if (HD == 64) return launch_any<T, 64>(a, st);
    if (HD == 128) return launch_any<T, 128>(a, st);
  }
  return cudaErrorInvalidValue;
}

template <int HD>
cudaError_t launch(const Args& a, cudaStream_t st) {
  const int smem = ring_bytes(a.P, HD) > merge_bytes(HD) ? ring_bytes(a.P, HD) : merge_bytes(HD);
  cudaError_t err = cudaFuncSetAttribute(paged_split_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  paged_split_kernel<HD><<<a.B * a.KV * a.NS, NW * 32, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_merge_kernel<__nv_bfloat16><<<a.B * a.H, HD, 0, st>>>(a, HD);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// q [B, H, HD] and k_pages/v_pages [NP, KV, P, HD] of element type `dtype`
// (0 bf16, 1 f16, 2 f32; 16-byte aligned); page_table [B, MAXP], lengths
// [B] int32; part_ml [B * KV, NS, H / KV, 2] and part_o
// [B * KV, NS, H / KV, HD] f32 scratch; out [B, H, HD] in q's type. HD is
// 16, 32, 64 or 128 (bf16 at 64 and 128: the kernel above; else
// any_decode_split), H / KV at most 16, P a multiple of 8 with
// P * HD <= 4096; the splits are runs of PPS pages, NS of them covering
// MAXP.
extern "C" int paged_attention_bf16(int device, const void* q, const void* k_pages,
                                    const void* v_pages, const void* page_table,
                                    const void* lengths, void* part_ml, void* part_o, void* out,
                                    int B, int H, int KV, int P, int MAXP, int HD, int dtype,
                                    int PPS, int NS, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B < 1 || KV < 1 || H % KV != 0 || H / KV > MAXG || P < 8 || P % 8 != 0 ||
      P * HD > 4096 || MAXP < 1 || PPS < 1 || (long long)PPS * NS < MAXP ||
      !aligned16(q) || !aligned16(k_pages) || !aligned16(v_pages) || !aligned16(part_ml))
    return cudaErrorInvalidValue;
  const Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pages),
               static_cast<const __nv_bfloat16*>(v_pages), static_cast<const int*>(page_table),
               static_cast<const int*>(lengths), static_cast<float*>(part_ml),
               static_cast<float*>(part_o), static_cast<__nv_bfloat16*>(out), B, H, KV, P, MAXP,
               PPS, NS, scale};
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return run_any<__half>(a, HD, st);
  if (dtype == 2) return run_any<float>(a, HD, st);
  if (dtype != 0) return cudaErrorInvalidValue;
  if (HD != 64 && HD != 128) return run_any<__nv_bfloat16>(a, HD, st);
  if (HD == 128) return launch<128>(a, st);
  return launch<64>(a, st);
}
