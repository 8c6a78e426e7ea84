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
// What bounds it on an H100: bytes. Each valid page byte is read once and
// used for 2*G flops (G = 6 at Qwen2-1.5B), so the target is the memory
// rate over the valid pages.
//
// Design. The TPU kernel makes the page the innermost, sequential grid
// dimension, lets the BlockSpec index map pick the page to DMA from the
// scalar-prefetched table, and carries the softmax state in VMEM scratch
// across grid steps. Here one CTA of 8 warps owns one (row, kv head), as
// K2/K3 do (decode_attention.cu): warp w walks token positions w, w+8, ...
// of the row, looks each position's page up in the table, keeps an online
// softmax per query head in registers, and the 8 partial states are merged
// through shared memory. One kv head's slice of a page is P*Hd contiguous
// bf16 (4 KB at P=16, Hd=128), so the 8 warps of a CTA stream two pages at
// a time. At B=64, Kv=2 that is 128 CTAs on 132 SMs; splitting a row's
// chain over more CTAs is later work.

#include "common.cuh"

namespace {

constexpr int NW = 8;    // warps per CTA
constexpr int MAXG = 8;  // most query heads per kv head

template <int DPL>
__global__ void __launch_bounds__(NW * 32) paged_attn_kernel(
    const __nv_bfloat16* __restrict__ q,        // [B, H, HD]
    const __nv_bfloat16* __restrict__ k_pages,  // [NP, KV, P, HD]
    const __nv_bfloat16* __restrict__ v_pages,  // [NP, KV, P, HD]
    const int* __restrict__ page_table,         // [B, MAXP]
    const int* __restrict__ lengths,            // [B]
    __nv_bfloat16* __restrict__ out,            // [B, H, HD]
    int H, int KV, int P, int MAXP, float scale) {
  constexpr int HD = DPL * 32;
  __shared__ float sm_acc[NW][MAXG][HD];
  __shared__ float sm_m[NW][MAXG];
  __shared__ float sm_l[NW][MAXG];

  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int G = H / KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  float qr[MAXG][DPL], acc[MAXG][DPL], m[MAXG], l[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = RLINF_NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      acc[g][i] = 0.f;
      qr[g][i] = g < G ? __bfloat162float(q[((size_t)b * H + kvh * G + g) * HD + lane * DPL + i]) : 0.f;
    }
  }

  const int end = min(max(lengths[b], 0), MAXP * P);
  for (int s = warp; s < end; s += NW) {
    const int page = page_table[(size_t)b * MAXP + s / P];
    const size_t at = (((size_t)page * KV + kvh) * P + s % P) * HD + lane * DPL;
    float kf[DPL], vf[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      kf[i] = __bfloat162float(k_pages[at + i]);
      vf[i] = __bfloat162float(v_pages[at + i]);
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;  // uniform across the CTA
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) d = fmaf(qr[g][i], kf[i], d);
      const float sc = rlinf_warp_sum(d) * scale;
      const float m_new = fmaxf(m[g], sc);
      const float alpha = expf(m[g] - m_new);
      const float p = expf(sc - m_new);
      l[g] = l[g] * alpha + p;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[g][i] = fmaf(p, vf[i], acc[g][i] * alpha);
      m[g] = m_new;
    }
  }

#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int i = 0; i < DPL; ++i) sm_acc[warp][g][lane * DPL + i] = acc[g][i];
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < G * HD; idx += NW * 32) {
    const int g = idx / HD, d = idx % HD;
    float mx = RLINF_NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float e = expf(sm_m[w][g] - mx);
      L = fmaf(sm_l[w][g], e, L);
      A = fmaf(sm_acc[w][g][d], e, A);
    }
    out[((size_t)b * H + kvh * G + g) * HD + d] = __float2bfloat16(A / fmaxf(L, 1e-30f));
  }
}

}  // namespace

extern "C" int paged_attention_bf16(int device, const void* q, const void* k_pages,
                                    const void* v_pages, const void* page_table,
                                    const void* lengths, void* out, int B, int H,
                                    int KV, int P, int MAXP, int HD, float scale,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (KV <= 0 || H % KV != 0 || H / KV > MAXG || P <= 0) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k_pages);
  const auto* vp = static_cast<const __nv_bfloat16*>(v_pages);
  const auto* tp = static_cast<const int*>(page_table);
  const auto* lp = static_cast<const int*>(lengths);
  auto* op = static_cast<__nv_bfloat16*>(out);
  const dim3 grid(B * KV);
  if (HD == 128)
    paged_attn_kernel<4><<<grid, NW * 32, 0, st>>>(qp, kp, vp, tp, lp, op, H, KV, P, MAXP, scale);
  else if (HD == 64)
    paged_attn_kernel<2><<<grid, NW * 32, 0, st>>>(qp, kp, vp, tp, lp, op, H, KV, P, MAXP, scale);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
