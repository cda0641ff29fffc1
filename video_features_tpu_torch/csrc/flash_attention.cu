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
// What bounds it on this card. At the CLIP-ViT-B/32 uni_12 shapes (fp32,
// N=16, H=12, L=50, d=64) q, k, v and o are 9.8 MB in all, 2.9 us at
// 3.35 TB/s, against 0.12 GFLOP of products: bytes set the bound, and at
// 12 launches per video one launch is a few microseconds, so what counts
// is latency: few, wide copies per thread, each head's K and V read by one
// CTA, and products with independent work for the tensor cores rather
// than long dependent FMA chains.
//
// Design (the FlashAttention-2 layout). One CTA of 4 warps owns one
// (batch*head, 64-row Q tile); each warp owns 16 query rows. At L <= 64 one
// CTA covers a head, so its Q, K and V are read once. KV moves in 64-row
// tiles staged with 16-byte cp.async (zero-fill form for rows >= kv_len);
// above 64 rows two stages alternate, so tile t+1 loads while tile t
// computes. Both products run on the tensor cores with mma.sync:
//   - bf16: m16n8k16 with fp32 accumulation. The score accumulator
//     fragment is, two n-tiles at a time, the A fragment of p.v, so p goes
//     from registers to the tensor cores rounded to bf16 (p.astype(v.dtype)).
//   - fp32: m16n8k8 TF32 with the three-product split x = big + small
//     (both TF32), big*big + big*small + small*big accumulated in fp32,
//     which keeps fp32 agreement. The score C fragment holds keys 2t, 2t+1
//     where the A fragment wants k = t, t+4: p.v therefore takes its 8 keys
//     in the order (0, 2, 4, 6, 1, 3, 5, 7), reading V's rows in that order,
//     so p never leaves registers.
// Each row's (m, l) lives in the 4 lanes of a quad: a row max is 2
// __shfl_xor_sync steps, the row sum is kept per lane and reduced once at
// the end. Q rows >= Lq are computed and not stored; KV tiles past kv_len
// are not visited. Shared-memory rows are padded (fp32 by 4 words, bf16 by
// 8 elements) so that every fragment load is free of bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kBlockQ = 64;  // query rows per CTA: 16 per warp
constexpr int kBlockK = 64;  // KV rows per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKeyTiles = kBlockK / 8;  // 8-key n-tiles of a warp's scores
constexpr float kMaskValue = -1e30f;

template <typename T>
struct Layout;
template <>
struct Layout<float> {
  static constexpr int kPad = 4;  // row stride = 4 mod 32 words
};
template <>
struct Layout<__nv_bfloat16> {
  static constexpr int kPad = 8;  // row stride = 4 mod 16 words
};

template <typename T, int D>
__host__ __device__ constexpr int row_stride() {
  return D + Layout<T>::kPad;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 64 rows from row0 of a (rows, D) matrix into shared memory; rows >= limit
// are written as zeros.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int row0, int limit) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;  // 16-byte pieces per row
  constexpr int kStride = row_stride<T, D>();
  for (int i = threadIdx.x; i < 64 * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * kVec;
    const bool in = row0 + r < limit;
    const T* g = in ? src + static_cast<size_t>(row0 + r) * D + c : src;
    cp_async16(dst + r * kStride + c, g, in ? 16 : 0);
  }
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b to fp32 accuracy: three TF32 products of the split operands
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4], float b0, float b1) {
  uint32_t b_big[2], b_small[2];
  split_tf32(b0, b_big[0], b_small[0]);
  split_tf32(b1, b_big[1], b_small[1]);
  mma_tf32(c, a_small, b_big);
  mma_tf32(c, a_big, b_small);
  mma_tf32(c, a_big, b_big);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The two products of one warp for one KV tile. `qw` is the warp's 16 Q
// rows, `kt`/`vt` the tile's K and V, all in shared memory; g = lane / 4,
// t = lane % 4 (the mma fragment coordinates).
template <typename T, int D>
struct Products;

template <int D>
struct Products<float, D> {
  static constexpr int S = row_stride<float, D>();

  __device__ __forceinline__ static void scores(float (&s)[kKeyTiles][4], const float* qw,
                                                const float* kt, int g, int t) {
#pragma unroll
    for (int kk = 0; kk < D; kk += 8) {
      uint32_t a_big[4], a_small[4];
      split_tf32(qw[g * S + kk + t], a_big[0], a_small[0]);
      split_tf32(qw[(g + 8) * S + kk + t], a_big[1], a_small[1]);
      split_tf32(qw[g * S + kk + t + 4], a_big[2], a_small[2]);
      split_tf32(qw[(g + 8) * S + kk + t + 4], a_big[3], a_small[3]);
#pragma unroll
      for (int n = 0; n < kKeyTiles; ++n) {
        const float* kr = kt + (n * 8 + g) * S + kk;
        mma_3xtf32(s[n], a_big, a_small, kr[t], kr[t + 4]);
      }
    }
  }

  // A fragment k = t is key 2t and k = t + 4 is key 2t + 1 of each 8-key
  // group, matching the score C fragment; V's rows are read in that order.
  __device__ __forceinline__ static void pv(float (&o)[D / 8][4], const float (&p)[kKeyTiles][4],
                                            const float* vt, int g, int t) {
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      uint32_t a_big[4], a_small[4];
      split_tf32(p[j][0], a_big[0], a_small[0]);
      split_tf32(p[j][2], a_big[1], a_small[1]);
      split_tf32(p[j][1], a_big[2], a_small[2]);
      split_tf32(p[j][3], a_big[3], a_small[3]);
      const float* v0 = vt + (j * 8 + 2 * t) * S;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        mma_3xtf32(o[n], a_big, a_small, v0[n * 8 + g], v0[S + n * 8 + g]);
      }
    }
  }
};

template <int D>
struct Products<__nv_bfloat16, D> {
  static constexpr int S = row_stride<__nv_bfloat16, D>();

  __device__ __forceinline__ static void scores(float (&s)[kKeyTiles][4],
                                                const __nv_bfloat16* qw,
                                                const __nv_bfloat16* kt, int g, int t) {
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      const uint32_t a[4] = {ld32(qw + g * S + kk + 2 * t), ld32(qw + (g + 8) * S + kk + 2 * t),
                             ld32(qw + g * S + kk + 2 * t + 8),
                             ld32(qw + (g + 8) * S + kk + 2 * t + 8)};
#pragma unroll
      for (int n = 0; n < kKeyTiles; ++n) {
        const __nv_bfloat16* kr = kt + (n * 8 + g) * S + kk;
        const uint32_t b[2] = {ld32(kr + 2 * t), ld32(kr + 2 * t + 8)};
        mma_bf16(s[n], a, b);
      }
    }
  }

  // two 8-key score tiles make one k16 A fragment; p is rounded to bf16
  __device__ __forceinline__ static void pv(float (&o)[D / 8][4], const float (&p)[kKeyTiles][4],
                                            const __nv_bfloat16* vt, int g, int t) {
    const uint16_t* v = reinterpret_cast<const uint16_t*>(vt);
#pragma unroll
    for (int j = 0; j < kKeyTiles / 2; ++j) {
      const uint32_t a[4] = {pack_bf16(p[2 * j][0], p[2 * j][1]),
                             pack_bf16(p[2 * j][2], p[2 * j][3]),
                             pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
                             pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
      const uint16_t* v0 = v + (j * 16 + 2 * t) * S;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int c = n * 8 + g;
        const uint32_t b[2] = {
            static_cast<uint32_t>(v0[c]) | (static_cast<uint32_t>(v0[S + c]) << 16),
            static_cast<uint32_t>(v0[8 * S + c]) | (static_cast<uint32_t>(v0[9 * S + c]) << 16)};
        mma_bf16(o[n], a, b);
      }
    }
  }
};

__device__ __forceinline__ void store_pair(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// a / b correctly rounded, from inv_b = 1/b (correctly rounded) and one
// FMA residual step: the compiler's IEEE division takes a called slow path
// that serialises a thread's divisions
__device__ __forceinline__ float div_rn(float a, float b, float inv_b) {
  const float q = a * inv_b;
  return fmaf(fmaf(-q, b, a), inv_b, q);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int lq, int lk,
                       int kv_len, int n_q_tiles, float scale) {
  constexpr int S = row_stride<T, D>();
  constexpr int kTile = kBlockK * S;  // elements of one staged K or V tile
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* kv = qs + kBlockQ * S;  // stage s: K at kv + 2 s kTile, V after it

  const int bh = blockIdx.x / n_q_tiles;
  const int q0 = (blockIdx.x % n_q_tiles) * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const T* qh = q + static_cast<size_t>(bh) * lq * D;
  const T* kh = k + static_cast<size_t>(bh) * lk * D;
  const T* vh = v + static_cast<size_t>(bh) * lk * D;
  const int n_tiles = (kv_len + kBlockK - 1) / kBlockK;

  stage_rows<T, D>(qs, qh, q0, lq);
  stage_rows<T, D>(kv, kh, 0, kv_len);
  stage_rows<T, D>(kv + kTile, vh, 0, kv_len);
  cp_async_commit();

  float m[2] = {kMaskValue, kMaskValue};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const T* qw = qs + warp * 16 * S;
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      T* next = kv + ((it + 1) & 1) * 2 * kTile;
      stage_rows<T, D>(next, kh, (it + 1) * kBlockK, kv_len);
      stage_rows<T, D>(next + kTile, vh, (it + 1) * kBlockK, kv_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kt = kv + (it & 1) * 2 * kTile;
    const T* vt = kt + kTile;

    float s[kKeyTiles][4];
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    Products<T, D>::scores(s, qw, kt, g, t);

    // s[n][e]: row g (e < 2) or g + 8, key k0 + 8n + 2t + (e & 1)
    const int key0 = it * kBlockK + 2 * t;
    float mx[2] = {kMaskValue, kMaskValue};
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = key0 + n * 8 + (e & 1) < kv_len ? s[n][e] * scale : kMaskValue;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        l[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    Products<T, D>::pv(acc, s, vt, g, t);
    __syncthreads();  // this stage's reads are done before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float denom = fmaxf(quad_sum(l[r]), 1e-30f);
    const float inv = 1.f / denom;
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= lq) continue;
    T* orow = o + (static_cast<size_t>(bh) * lq + row) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      store_pair(orow + n * 8, div_rn(acc[n][2 * r], denom, inv),
                 div_rn(acc[n][2 * r + 1], denom, inv));
    }
  }
}

// Let flash_attention_kernel<T, D> take `smem` bytes of dynamic shared
// memory (above 48 KB it must ask). The limit is one value per kernel and
// device, so it is only ever raised, to the largest launch seen.
template <typename T, int D>
cudaError_t allow_smem(size_t smem) {
  constexpr int kDevices = 64;
  static std::mutex lock;
  static size_t granted[kDevices] = {};
  if (smem <= 48 * 1024) return cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(lock);
  if (device >= kDevices) return cudaErrorInvalidDevice;
  if (granted[device] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_attention_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) granted[device] = smem;
  return err;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int lq, int lk,
           int kv_len, float scale, cudaStream_t stream) {
  constexpr int S = row_stride<T, D>();
  const int n_q_tiles = (lq + kBlockQ - 1) / kBlockQ;
  const int stages = kv_len > kBlockK ? 2 : 1;
  const size_t smem = static_cast<size_t>(kBlockQ + stages * 2 * kBlockK) * S * sizeof(T);
  const cudaError_t err = allow_smem<T, D>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_kernel<T, D><<<bh * n_q_tiles, kThreads, smem, stream>>>(
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

// q (bh, lq, d), k and v (bh, lk, d), o (bh, lq, d), all contiguous and
// 16-byte aligned, fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1). Requires
// 1 <= kv_len <= lk and d in {32, 64, 128}. Launches on `stream` and
// returns cudaGetLastError().
extern "C" int vft_flash_attention_forward(const void* q, const void* k, const void* v, void* o,
                                           int bh, int lq, int lk, int kv_len, int d,
                                           int is_bf16, float scale, void* stream) {
  if (bh < 1 || lq < 1 || kv_len < 1 || kv_len > lk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return dispatch_d<__nv_bfloat16>(q, k, v, o, bh, lq, lk, kv_len, d, scale, s);
  return dispatch_d<float>(q, k, v, o, bh, lq, lk, kv_len, d, scale, s);
}
