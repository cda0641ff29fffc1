// PWC-Net's 81-channel cost volume for Hopper (sm_90a):
//   out[n, (dy+4)*9 + (dx+4), y, x] = (1/C) * sum_c f1[n,c,y,x] * f2[n,c,y+dy,x+dx]
// for dy, dx in [-4, 4], with f2 read as zero outside its (H, W) plane.
// (N, C, H, W) x2 -> (N, 81, H, W), in the inputs' dtype.
//
// Replaces the TPU kernel video_features_tpu/ops/pallas/correlation_kernel.py
// (`_kernel`, :39; its pallas_call at :95, wrapper `local_correlation_pallas`
// :70). Same arithmetic: each product in the input dtype (a bf16 product is
// rounded to bf16, as `f1 * f2` is there), the C-wide sum in fp32, divided
// (not multiplied by 1/C) by C, cast to the input dtype on the store.
//
// What bounds it. Each input is read once and the output written once: at
// PWC's level 2 on the I3D main path (N=64 pairs, C=32, 64x96, fp32) that
// is 101 MB in and 127 MB out, 68 us at 3.35 TB/s, against 2.0 GFLOP of
// fp32 multiply-adds, 30 us at 67 TFLOP/s. So the bound is bytes, and the
// point of the design is that every f2 byte crosses device memory once
// although 81 displacements use it.
//
// Design. The TPU kernel stages f2's halo'd row tile (C, TH+8, W+8) in VMEM
// once per grid step and reads all 81 shifted windows from it. Here one CTA
// owns one (n, 8-row, 32-column) output tile and one thread one output
// pixel with its 81 sums in fp32 registers. f2's tile plus a 4-pixel border,
// (16 channels, 16, 40), is staged in shared memory 16 channels at a time
// (40 KB, so two CTAs fit on an SM), zero where the border leaves the
// plane; f1's pixel is read from global memory once per channel. The 81
// shifted reads of a channel then come from shared memory, conflict-free
// (the 32 lanes of a warp read 32 neighbouring words). The ragged H and W
// edges are masked in the kernel: threads outside the plane help stage the
// tile and store nothing, so the wrapper pads and copies nothing. Stores go
// one displacement plane at a time, coalesced along W.
//
// This first version is about 7x its byte bound over PWC's five levels on
// an H100 (N=64, fp32): each thread does one shared-memory load per
// multiply-add, and at the small levels (W = 12 and 6) most threads of a
// 32-wide tile fall outside the plane while each CTA walks 128-196
// channels. Staging with cp.async or TMA, f2 rows reused across output
// pixels held in registers, and tiles shaped by W are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kDisp = 4;                      // max displacement d
constexpr int kSide = 2 * kDisp + 1;          // 9 displacements per axis
constexpr int kPlanes = kSide * kSide;        // 81 output channels
constexpr int kTileW = 32;                    // output columns per CTA: one warp
constexpr int kTileH = 8;                     // output rows per CTA
constexpr int kHaloW = kTileW + 2 * kDisp;    // 40
constexpr int kHaloH = kTileH + 2 * kDisp;    // 16
constexpr int kChunk = 16;                    // channels staged per pass
constexpr int kThreads = kTileW * kTileH;     // 256: one output pixel each

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

// f1 * f2 as the input dtype computes it, widened back to fp32
template <typename T>
__device__ __forceinline__ float product(float a, float b) {
  return to_float(from_float<T>(a * b));
}
template <>
__device__ __forceinline__ float product<float>(float a, float b) { return a * b; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
local_correlation_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                         T* __restrict__ out, int C, int H, int W) {
  __shared__ float tile[kChunk][kHaloH][kHaloW];

  const int tx = threadIdx.x % kTileW;
  const int ty = threadIdx.x / kTileW;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int x = x0 + tx;
  const int y = y0 + ty;
  const bool inside = x < W && y < H;
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t base = static_cast<size_t>(blockIdx.z) * C * plane;
  const T* f1p = f1 + base + (inside ? static_cast<size_t>(y) * W + x : 0);

  float acc[kPlanes];
#pragma unroll
  for (int k = 0; k < kPlanes; ++k) acc[k] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    const int cc = min(kChunk, C - c0);
    __syncthreads();  // the previous chunk's reads of `tile` are done
    for (int i = threadIdx.x; i < cc * kHaloH * kHaloW; i += kThreads) {
      const int c = i / (kHaloH * kHaloW);
      const int r = (i / kHaloW) % kHaloH;
      const int col = i % kHaloW;
      const int gy = y0 - kDisp + r;
      const int gx = x0 - kDisp + col;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        v = to_float(f2[base + static_cast<size_t>(c0 + c) * plane +
                        static_cast<size_t>(gy) * W + gx]);
      }
      tile[c][r][col] = v;
    }
    __syncthreads();

    for (int c = 0; c < cc; ++c) {
      const float a = inside ? to_float(f1p[static_cast<size_t>(c0 + c) * plane]) : 0.f;
#pragma unroll
      for (int dy = 0; dy < kSide; ++dy) {
#pragma unroll
        for (int dx = 0; dx < kSide; ++dx) {
          acc[dy * kSide + dx] += product<T>(a, tile[c][ty + dy][tx + dx]);
        }
      }
    }
  }

  if (!inside) return;
  T* o = out + static_cast<size_t>(blockIdx.z) * kPlanes * plane +
         static_cast<size_t>(y) * W + x;
  const float count = static_cast<float>(C);
#pragma unroll
  for (int k = 0; k < kPlanes; ++k) o[static_cast<size_t>(k) * plane] = from_float<T>(acc[k] / count);
}

template <typename T>
int launch(const void* f1, const void* f2, void* out, int n, int c, int h, int w,
           cudaStream_t stream) {
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, n);
  local_correlation_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2), static_cast<T*>(out), c, h, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f1 and f2 (n, c, h, w), out (n, 81, h, w), all contiguous, fp32
// (is_bf16 = 0) or bf16 (is_bf16 = 1); max displacement 4. Requires
// n <= 65535 (the grid's z extent). Launches on `stream` and returns
// cudaGetLastError().
extern "C" int vft_local_correlation_forward(const void* f1, const void* f2, void* out, int n,
                                             int c, int h, int w, int is_bf16, void* stream) {
  if (n < 1 || n > 65535 || c < 1 || h < 1 || w < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(f1, f2, out, n, c, h, w, s);
  return launch<float>(f1, f2, out, n, c, h, w, s);
}
