// Flash-attention forward for Hopper (sm_90a): softmax(q k^T d^-1/2) v on
// (N, H, L, d) tensors, without materialising the (L, L) score matrix.
//
// Replaces the TPU kernel video_features_tpu/ops/pallas/flash_attention.py
// (`_kernel`, :36; its pallas_call at :118). Same arithmetic: fp32 scores
// scaled by d^-1/2, KV positions >= kv_len set to -1e30 before the row max,
// an online softmax with a running max, running sum and fp32 accumulator,
// p rounded to v's type before the p.v product (the TPU kernel's
// p.astype(v.dtype)), and the output divided by max(l, 1e-30).
//
// Design. The TPU grid (N*H, Lq/bq, Lk/bk) runs in order and carries the
// softmax state in scratch across its KV axis. Hopper runs blocks in no
// order, so each CTA owns one (batch*head, 16-row Q tile) and walks the KV
// tiles itself, keeping (m, l, acc) in registers. One warp owns four query
// rows: lane j scores KV row j of a 32-row tile, and lane c accumulates
// output columns c, c+32, ... of each of its rows. The ragged edge is
// masked in the kernel: Q rows >= Lq are computed and not stored, KV tiles
// past kv_len are never visited, so nothing is padded or copied first.
//
// Bound at the CLIP-ViT-B/32 uni_12 shapes (fp32, N=16, H=12, L=50, d=64):
// q, k, v and o are 2.46 MB each, 9.8 MB in all, about 2.9 us at 3.35 TB/s;
// the two products are 0.12 GFLOP, about 1.8 us at 67 TFLOP/s of fp32. So
// the kernel is bound by memory and, at 12 launches per video (one per
// layer), by launch latency. This first version reads each tile once into
// shared memory and does its products on the CUDA cores with fp32 FMAs;
// wgmma, TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 16;  // query rows per CTA
constexpr int kBlockK = 32;  // KV rows per tile: one per lane
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kBlockQ / kWarps;
constexpr float kMaskValue = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int lq, int lk,
                       int kv_len, int n_q_tiles, float scale) {
  constexpr int kPerLane = (D + 31) / 32;
  __shared__ float qs[kBlockQ][D];
  __shared__ float ks[kBlockK][D + 1];  // +1: lane j reads row j, no bank conflicts
  __shared__ float vs[kBlockK][D];
  __shared__ float ps[kBlockQ][kBlockK];

  const int bh = blockIdx.x / n_q_tiles;
  const int q0 = (blockIdx.x % n_q_tiles) * kBlockQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t q_base = static_cast<size_t>(bh) * lq * D;
  const size_t kv_base = static_cast<size_t>(bh) * lk * D;

  for (int i = tid; i < kBlockQ * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    qs[r][c] = q0 + r < lq ? to_float(q[q_base + static_cast<size_t>(q0 + r) * D + c]) : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kMaskValue;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) acc[r][e] = 0.f;
  }

  const int n_kv_tiles = (kv_len + kBlockK - 1) / kBlockK;
  for (int t = 0; t < n_kv_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile's reads of ks/vs are done
    for (int i = tid; i < kBlockK * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < lk;
      const size_t off = kv_base + static_cast<size_t>(k0 + r) * D + c;
      ks[r][c] = in ? to_float(k[off]) : 0.f;
      vs[r][c] = in ? to_float(v[off]) : 0.f;
    }
    __syncthreads();

    const bool valid = k0 + lane < kv_len;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp * kRowsPerWarp + r;
      float s = 0.f;
#pragma unroll 16
      for (int c = 0; c < D; ++c) s = fmaf(qs[row][c], ks[lane][c], s);
      s = valid ? s * scale : kMaskValue;
      const float m_new = fmaxf(m[r], warp_max(s));
      const float corr = expf(m[r] - m_new);
      const float p = expf(s - m_new);
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
      ps[row][lane] = to_float(from_float<T>(p));
      __syncwarp();
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) {
        const int c = lane + 32 * e;
        float pv = 0.f;
        if (c < D) {
#pragma unroll 8
          for (int j = 0; j < kBlockK; ++j) pv = fmaf(ps[row][j], vs[j][c], pv);
        }
        acc[r][e] = acc[r][e] * corr + pv;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + warp * kRowsPerWarp + r;
    if (row >= lq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      const int c = lane + 32 * e;
      if (c < D) o[q_base + static_cast<size_t>(row) * D + c] = from_float<T>(acc[r][e] / denom);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int lq, int lk,
           int kv_len, float scale, cudaStream_t stream) {
  const int n_q_tiles = (lq + kBlockQ - 1) / kBlockQ;
  flash_attention_kernel<T, D><<<bh * n_q_tiles, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lq, lk, kv_len, n_q_tiles, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int bh, int lq, int lk,
               int kv_len, int d, float scale, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, o, bh, lq, lk, kv_len, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, bh, lq, lk, kv_len, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, bh, lq, lk, kv_len, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (bh, lq, d), k and v (bh, lk, d), o (bh, lq, d), all contiguous, fp32
// (is_bf16 = 0) or bf16 (is_bf16 = 1). Requires 1 <= kv_len <= lk and d in
// {32, 64, 128}. Launches on `stream` and returns cudaGetLastError().
extern "C" int vft_flash_attention_forward(const void* q, const void* k, const void* v, void* o,
                                           int bh, int lq, int lk, int kv_len, int d,
                                           int is_bf16, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return dispatch_d<__nv_bfloat16>(q, k, v, o, bh, lq, lk, kv_len, d, scale, s);
  return dispatch_d<float>(q, k, v, o, bh, lq, lk, kv_len, d, scale, s);
}
