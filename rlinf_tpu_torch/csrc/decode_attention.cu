// Kernels K2 and K3: one-token decode attention over a packed KV cache.
//
// K2 (bf16 cache) replaces the Pallas TPU kernel _kernel of
// rlinf_tpu/ops/pallas/decode_attention.py (decode_attention_packed);
// K3 (int8 cache with one f32 scale per (row, slot)) replaces _kernel_q8
// (decode_attention_packed_q8). Same function: for every batch row b and
// query head h, softmax over the slots start[b] <= s < length[b] of
// (q . k_s) * scale [* k_scale_s], then the sum of p_s [* v_scale_s] * v_s.
// The int8 cache is never dequantized: the scales fold into the score and
// the probability. An empty interval gives 0.
//
// What bounds it on an H100: bytes. Each cache byte is read once and used
// for 2*G flops (G = 6 query heads per kv head at Qwen2-1.5B), far left of
// the ridge point, so the target is the memory rate over the valid slots.
//
// Design. The TPU kernel packs all kv heads into one lane-dense block and
// masks the other heads' lanes with a zero-banded q (a Mosaic layout
// device) and unpacks with an einsum diagonal; none of that carries over.
// Here one CTA of 8 warps owns one (batch row, kv head) and serves that
// head's G query heads, each lane holding Hd/32 dims of every query. Warp
// w walks slots start+w, start+w+8, ... of the valid interval only, keeps
// an online softmax per query head in registers, and the 8 partial states
// are merged through shared memory. At B=64, Kv=2 that is only 128 CTAs
// on 132 SMs, one wave with 8 warps each: too few bytes in flight to reach
// the memory rate. Splitting the interval over more CTAs (split-KV with a
// combine pass) is later work.

#include "common.cuh"

namespace {

constexpr int NW = 8;    // warps per CTA
constexpr int MAXG = 8;  // most query heads per kv head

__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float load_f(const int8_t* p) { return static_cast<float>(*p); }

template <typename T, int DPL, bool Q8>
__global__ void __launch_bounds__(NW * 32) decode_attn_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, H, HD]
    const T* __restrict__ kc,             // [B, S, KV * HD]
    const T* __restrict__ vc,             // [B, S, KV * HD]
    const float* __restrict__ ks,         // [B, S] (Q8 only)
    const float* __restrict__ vs,         // [B, S] (Q8 only)
    const int* __restrict__ starts,       // [B]
    const int* __restrict__ lengths,      // [B]
    __nv_bfloat16* __restrict__ out,      // [B, H, HD]
    int H, int KV, int S, float scale) {
  constexpr int HD = DPL * 32;
  __shared__ float sm_acc[NW][MAXG][HD];
  __shared__ float sm_m[NW][MAXG];
  __shared__ float sm_l[NW][MAXG];

  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int G = H / KV;
  const int KD = KV * HD;
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

  const int start = max(starts[b], 0);
  const int end = min(lengths[b], S);
  for (int s = start + warp; s < end; s += NW) {
    const size_t at = ((size_t)b * S + s) * KD + kvh * HD + lane * DPL;
    float kf[DPL], vf[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      kf[i] = load_f(kc + at + i);
      vf[i] = load_f(vc + at + i);
    }
    const float k_s = Q8 ? ks[(size_t)b * S + s] : 1.f;
    const float v_s = Q8 ? vs[(size_t)b * S + s] : 1.f;
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;  // uniform across the CTA
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) d = fmaf(qr[g][i], kf[i], d);
      float sc = rlinf_warp_sum(d) * scale;
      if (Q8) sc *= k_s;
      const float m_new = fmaxf(m[g], sc);
      const float alpha = expf(m[g] - m_new);
      const float p = expf(sc - m_new);
      l[g] = l[g] * alpha + p;
      const float pv = Q8 ? p * v_s : p;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[g][i] = fmaf(pv, vf[i], acc[g][i] * alpha);
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

template <typename T, bool Q8>
int launch(const void* q, const void* kc, const void* vc, const void* ks,
           const void* vs, const void* starts, const void* lengths, void* out,
           int B, int H, int KV, int S, int HD, float scale, cudaStream_t st) {
  if (KV <= 0 || H % KV != 0 || H / KV > MAXG) return cudaErrorInvalidValue;
  const dim3 grid(B * KV);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const T*>(kc);
  const auto* vp = static_cast<const T*>(vc);
  const auto* ksp = static_cast<const float*>(ks);
  const auto* vsp = static_cast<const float*>(vs);
  const auto* sp = static_cast<const int*>(starts);
  const auto* lp = static_cast<const int*>(lengths);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (HD == 128)
    decode_attn_kernel<T, 4, Q8><<<grid, NW * 32, 0, st>>>(qp, kp, vp, ksp, vsp, sp, lp, op, H, KV, S, scale);
  else if (HD == 64)
    decode_attn_kernel<T, 2, Q8><<<grid, NW * 32, 0, st>>>(qp, kp, vp, ksp, vsp, sp, lp, op, H, KV, S, scale);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

extern "C" int decode_attention_bf16(int device, const void* q, const void* kc,
                                     const void* vc, const void* starts,
                                     const void* lengths, void* out, int B,
                                     int H, int KV, int S, int HD, float scale,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch<__nv_bfloat16, false>(q, kc, vc, nullptr, nullptr, starts, lengths, out,
                                      B, H, KV, S, HD, scale, static_cast<cudaStream_t>(stream));
}

extern "C" int decode_attention_q8(int device, const void* q, const void* kc,
                                   const void* vc, const void* k_scale,
                                   const void* v_scale, const void* starts,
                                   const void* lengths, void* out, int B, int H,
                                   int KV, int S, int HD, float scale,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch<int8_t, true>(q, kc, vc, k_scale, v_scale, starts, lengths, out,
                              B, H, KV, S, HD, scale, static_cast<cudaStream_t>(stream));
}
