// Kernel K1: causal grouped-query flash-attention forward (prefill).
//
// Replaces the Pallas TPU kernel _fwd_kernel of
// rlinf_tpu/ops/pallas/flash_attention.py (pallas_call in _fwd_call), the
// forward of flash_attention(). Same function: out = softmax(q k^T * scale)
// v under the mask (pos_kv <= pos_q) AND kv_valid, online softmax in fp32,
// and the log-sum-exp of every query row (the backward of a later slice
// reads it).
//
// What bounds it on an H100: operations. At the prefill shapes (B=64,
// S=512, H=12, Kv=2, Hd=128) the two products are ~50 GFLOP after causal
// skipping against ~0.2 GB of bf16 operands, far right of the ridge point.
// This first version computes the products with scalar fp32 FMAs from
// shared memory, so it runs at a fraction of the tensor-core peak; moving
// them to mma/wgmma is later work.
//
// Design. The TPU kernel walks a sequential grid with 512-row tiles in
// VMEM; here one CTA of 256 threads owns one (batch row, query head,
// 64-row query tile) and loops over 64-key tiles staged in shared memory,
// so 6144 CTAs fill the card at the prefill shape. The kv head is
// h / (H / Kv): GQA shares k/v tiles through the cache, no replication.
// A key tile whose least valid position exceeds the tile's greatest query
// position is skipped (the _block_bounds rule, evaluated per tile). Unlike
// the Pallas kernel, masked keys get probability 0 explicitly, so a query
// row with no valid key gives 0; rows with a valid key agree.
// Positions are arbitrary [B, S] int32: left-padded prompts give pad
// slots position 0.

#include "common.cuh"

namespace {

constexpr int BQ = 64;   // query rows per CTA
constexpr int BK = 64;   // keys per shared-memory tile (= 2 x warp width)
constexpr int NT = 256;  // threads per CTA: a 16 x 16 grid of 4-row strips

template <int HD>
struct Smem {
  __nv_bfloat162 q[BQ][HD / 2 + 1];  // +1 word: rows land on distinct banks
  __nv_bfloat162 k[BK][HD / 2 + 1];
  __nv_bfloat162 v[BK][HD / 2];
  float p[BQ][BK + 1];               // scores, then probabilities
  float m[BQ], l[BQ], alpha[BQ];     // running max, sum, rescale per row
  int pos_q[BQ];
  int pos_kv[BK];
  int valid[BK];
  int qmax, kmin;
};

template <int HD>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q,   // [B, Sq, H, HD]
    const __nv_bfloat16* __restrict__ k,   // [B, Sk, KV, HD]
    const __nv_bfloat16* __restrict__ v,   // [B, Sk, KV, HD]
    const int* __restrict__ pos_q,         // [B, Sq]
    const int* __restrict__ pos_kv,        // [B, Sk]
    const uint8_t* __restrict__ valid,     // [B, Sk]
    __nv_bfloat16* __restrict__ out,       // [B, Sq, H, HD]
    float* __restrict__ lse,               // [B, H, Sq]
    int Sq, int Sk, int H, int KV, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<HD>& sm = *reinterpret_cast<Smem<HD>*>(smem_raw);
  constexpr int HP = HD / 2;   // bf16 pairs per head vector
  constexpr int CP = HP / 16;  // column pairs per thread in the P.V product

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;

  const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(q);
  const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(k);
  const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(v);
  const __nv_bfloat162 zero2 = __floats2bfloat162_rn(0.f, 0.f);

  if (tid == 0) sm.qmax = INT_MIN;
  __syncthreads();
  for (int i = tid; i < BQ * HP; i += NT) {
    const int r = i / HP, c = i % HP, s = q0 + r;
    sm.q[r][c] = s < Sq ? q2[((size_t)(b * Sq + s) * H + h) * HP + c] : zero2;
  }
  if (tid < BQ) {
    const int s = q0 + tid;
    const int pq = s < Sq ? pos_q[(size_t)b * Sq + s] : INT_MIN;
    sm.pos_q[tid] = pq;
    if (s < Sq) atomicMax(&sm.qmax, pq);
    sm.m[tid] = RLINF_NEG_INF;
    sm.l[tid] = 0.f;
  }

  float acc[4][2 * CP];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2 * CP; ++j) acc[i][j] = 0.f;

  const int n_kt = (Sk + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's p and v are consumed
    if (tid == 0) sm.kmin = INT_MAX;
    __syncthreads();
    if (tid < BK) {
      const int s = k0 + tid;
      const int ok = s < Sk && valid[(size_t)b * Sk + s] != 0;
      const int pk = s < Sk ? pos_kv[(size_t)b * Sk + s] : 0;
      sm.pos_kv[tid] = pk;
      sm.valid[tid] = ok;
      if (ok) atomicMin(&sm.kmin, pk);
    }
    __syncthreads();
    if (sm.kmin > sm.qmax) continue;  // no (query, key) pair of the tiles is unmasked

    for (int i = tid; i < BK * HP; i += NT) {
      const int r = i / HP, c = i % HP, s = k0 + r;
      const size_t off = ((size_t)(b * Sk + s) * KV + kvh) * HP + c;
      sm.k[r][c] = s < Sk ? k2[off] : zero2;
      sm.v[r][c] = s < Sk ? v2[off] : zero2;
    }
    __syncthreads();

    // scores: thread (ty, tx) owns rows ty + 16i and keys tx + 16j
    float s_acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s_acc[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < HP; ++c) {
      float2 qf[4], kf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qf[i] = __bfloat1622float2(sm.q[ty + 16 * i][c]);
#pragma unroll
      for (int j = 0; j < 4; ++j) kf[j] = __bfloat1622float2(sm.k[tx + 16 * j][c]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s_acc[i][j] = fmaf(qf[i].y, kf[j].y, fmaf(qf[i].x, kf[j].x, s_acc[i][j]));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok = sm.valid[c] && sm.pos_kv[c] <= sm.pos_q[r];
        sm.p[r][c] = ok ? s_acc[i][j] * scale : RLINF_NEG_INF;
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows 8w .. 8w+7, each lane two keys
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int r = warp * (BQ / 8) + rr;
      const float s0 = sm.p[r][lane], s1 = sm.p[r][lane + 32];
      const bool ok0 = sm.valid[lane] && sm.pos_kv[lane] <= sm.pos_q[r];
      const bool ok1 = sm.valid[lane + 32] && sm.pos_kv[lane + 32] <= sm.pos_q[r];
      const float m_old = sm.m[r];
      const float m_new = fmaxf(m_old, rlinf_warp_max(fmaxf(s0, s1)));
      const float p0 = ok0 ? expf(s0 - m_new) : 0.f;
      const float p1 = ok1 ? expf(s1 - m_new) : 0.f;
      const float sum = rlinf_warp_sum(p0 + p1);
      sm.p[r][lane] = p0;
      sm.p[r][lane + 32] = p1;
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        sm.alpha[r] = a;
        sm.l[r] = sm.l[r] * a + sum;
        sm.m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P.V: thread owns rows ty + 16i, pairs tx + 16j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = sm.alpha[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 2 * CP; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sm.p[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < CP; ++j) {
        const float2 vf = __bfloat1622float2(sm.v[kk][tx + 16 * j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][2 * j] = fmaf(pv[i], vf.x, acc[i][2 * j]);
          acc[i][2 * j + 1] = fmaf(pv[i], vf.y, acc[i][2 * j + 1]);
        }
      }
    }
  }
  __syncthreads();

  __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, s = q0 + r;
    if (s >= Sq) continue;
    const float l = fmaxf(sm.l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < CP; ++j)
      o2[((size_t)(b * Sq + s) * H + h) * HP + tx + 16 * j] =
          __floats2bfloat162_rn(acc[i][2 * j] / l, acc[i][2 * j + 1] / l);
    if (tx == 0) lse[((size_t)b * H + h) * Sq + s] = sm.m[r] + logf(l);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* pos_q,
           const void* pos_kv, const void* valid, void* out, void* lse, int B,
           int Sq, int Sk, int H, int KV, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(Smem<HD>);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<HD><<<grid, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(pos_q),
      static_cast<const int*>(pos_kv), static_cast<const uint8_t*>(valid),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), Sq, Sk, H, KV, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_fwd(int device, const void* q, const void* k,
                                   const void* v, const void* pos_q,
                                   const void* pos_kv, const void* valid,
                                   void* out, void* lse, int B, int Sq, int Sk,
                                   int H, int KV, int HD, float scale,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (HD == 128) return launch<128>(q, k, v, pos_q, pos_kv, valid, out, lse, B, Sq, Sk, H, KV, scale, st);
  if (HD == 64) return launch<64>(q, k, v, pos_q, pos_kv, valid, out, lse, B, Sq, Sk, H, KV, scale, st);
  return cudaErrorInvalidValue;
}
