// PWC-Net's 81-channel cost volume for Hopper (sm_90a):
//   out[n, (dy+4)*9 + (dx+4), y, x] = (1/C) * sum_c f1[n,c,y,x] * f2[n,c,y+dy,x+dx]
// for dy, dx in [-4, 4], with f2 read as zero outside its (H, W) plane.
// (N, C, H, W) x2 -> (N, 81, H, W), in the inputs' dtype.
//
// Replaces the TPU kernel video_features_tpu/ops/pallas/correlation_kernel.py
// (`_kernel`, :39; its pallas_call at :95, wrapper `local_correlation_pallas`
// :70). Same arithmetic: each product in the input dtype (a bf16 product is
// rounded to bf16, as `f1 * f2` is there), the C-wide sum in fp32, divided
// by C (correctly rounded, as a true division is), cast to the input dtype
// on the store.
//
// What bounds it. Each input is read once and the output written once: at
// PWC's level 2 on the I3D main path (N=64 pairs, C=32, 64x96, fp32) that
// is 101 MB in and 127 MB out, 68 us at 3.35 TB/s, against 2.0 GFLOP of
// fp32 multiply-adds: about 9 FLOP a byte there and 17 at level 6, under the
// fp32 ridge. So it stays on the CUDA cores (bf16 tensor-core products
// would not round each product to bf16 either), and the design is about
// bytes and the cost of moving them: shared-memory loads per multiply-add,
// copies per thread, and, at the small levels (8x12 and 4x6 planes of
// 128-196 channels), enough threads inside the plane.
//
// Design. A CTA owns a (tile_h, tile_w) output tile of one pair, with the
// tile, the channel split and the chunk chosen from the shape by the
// wrapper (ops/correlation_kernel.py::launch_shape). A thread owns a row
// segment of 4 output pixels for one dy and keeps their 9 dx sums (36 fp32
// registers); per channel it reads its 4 f1 values and the 12 f2 values of
// row y+dy from shared memory (4 vector loads for 36 FMAs, where the first
// version did 36 loads). bf16 products are taken two at a time
// (fma.rn.bf16x2 with a -0 addend: each exact product rounded to bf16
// once). Where one plane cannot fill the card, the channel
// loop is split across groups of the CTA's threads; the partial sums meet
// in shared memory and are added in group order, so the result is
// deterministic with no atomics and no second launch. Threads whose row
// y+dy lies outside the plane skip the products (they would all read the
// zero border). Stores go one displacement plane at a time, coalesced
// along W; ragged H and W edges are masked in the kernel.
//
// Staging. CTAs are persistent: each walks tiles blockIdx.x + k gridDim.x
// in channel chunks through a ring of 3 shared-memory stages, staged two
// chunks ahead across tile boundaries, so loads overlap products and
// stores. Measured on an H100, per-thread copies (cp.async) of the halo'd
// tile kept CTAs stalled issuing copies whether the data sat in L2 or
// not, so the stages are filled by the copy engine where the shape
// allows, one thread issuing and an mbarrier per stage:
//   - tensor: two TMA boxes per chunk (f1's tile, f2's tile plus its
//     border; the border outside the plane comes back as zeros), for rows
//     and tile widths of a multiple of 16 bytes (PWC's levels 2-5: W = 96,
//     48, 24, 12 in fp32); a box starts on 16 bytes, so f2's border is 16
//     bytes wide on the left;
//   - planes: where a tile is a whole plane whose size is a multiple of 16
//     bytes (level 6, 4x6), one bulk copy of the chunk's contiguous planes
//     of each input, read with masks (no border) by the products;
//   - copies: otherwise (the ragged 67x121, bf16 rows of 12, misaligned
//     inputs), cp.async 16-, 8- or 4-byte copies by all threads (plain
//     loads for bf16 rows of odd width), zeros written for the border, and
//     rows no product reads skipped.

#include <cuda.h>  // CUtensorMap; the encoder comes from cudaGetDriverEntryPoint
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kDisp = 4;              // max displacement d
constexpr int kSide = 2 * kDisp + 1;  // 9 displacements per axis
constexpr int kPlanes = kSide * kSide;
constexpr int kSeg = 4;  // output pixels per thread
constexpr int kMaxThreads = 512;
constexpr int kStages = 3;  // staging ring: two chunks in flight
constexpr int kAlign = 128;  // bytes: each staged block starts on a line

enum Staging { kCopies = 0, kTensor = 1, kPlaneBulk = 2 };

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

// Two bf16 products at once: fma.rn.bf16x2 with a -0 addend rounds each
// exact product to bf16 once, as `f1 * f2` does in bf16.
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(0x80008000u));
  return d;
}

// One channel of a thread's bf16 sums from its 4 f1 values at `a` and the
// 12 f2 values at `b` (staged, 8-byte aligned), the products taken in
// pairs of pixels: pixel pair p and displacement dx need f2 words at
// element 2p + dx, whole 32-bit words for even dx, the words shifted by
// one element for odd dx.
__device__ __forceinline__ void accumulate_bf16(float (&acc)[9][4], const __nv_bfloat16* a,
                                                const __nv_bfloat16* b) {
  const uint2 av = *reinterpret_cast<const uint2*>(a);
  const uint32_t pa[2] = {av.x, av.y};
  uint32_t w[6], sh[5];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const uint2 v = *reinterpret_cast<const uint2*>(b + 4 * k);
    w[2 * k] = v.x;
    w[2 * k + 1] = v.y;
  }
#pragma unroll
  for (int k = 0; k < 5; ++k) sh[k] = __byte_perm(w[k], w[k + 1], 0x5432);
#pragma unroll
  for (int dx = 0; dx < 9; ++dx) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const uint32_t prod = mul_bf16x2(pa[p], dx & 1 ? sh[p + (dx >> 1)] : w[p + (dx >> 1)]);
      acc[dx][2 * p] += __uint_as_float(prod << 16);
      acc[dx][2 * p + 1] += __uint_as_float(prod & 0xffff0000u);
    }
  }
}

// a / b correctly rounded, from inv_b = 1/b (correctly rounded) and one
// FMA residual step: the compiler's IEEE division takes a called slow path
// that serialises dozens of divisions a thread
__device__ __forceinline__ float div_rn(float a, float b, float inv_b) {
  const float q = a * inv_b;
  return fmaf(fmaf(-q, b, a), inv_b, q);
}

// n consecutive fp32 values from shared memory, n a multiple of 4
template <int N>
__device__ __forceinline__ void load_row(float (&x)[N], const float* p) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    x[i] = v.x;
    x[i + 1] = v.y;
    x[i + 2] = v.z;
    x[i + 3] = v.w;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// kVec elements from global memory to shared memory (cp.async for 4, 8 or
// 16 bytes, a plain copy for 2), or zeros written by the thread itself
// where `in` is false
template <typename T, int kVec>
__device__ __forceinline__ void stage_copy(T* dst, const T* src, bool in) {
  constexpr int kBytes = kVec * static_cast<int>(sizeof(T));
  if (!in) {
    if constexpr (kBytes == 16) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    } else if constexpr (kBytes == 8) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(0, 0);
    } else if constexpr (kBytes == 4) {
      *reinterpret_cast<uint32_t*>(dst) = 0;
    } else {
      *reinterpret_cast<uint16_t*>(dst) = 0;
    }
    return;
  }
  if constexpr (kBytes >= 4) {
    if constexpr (kBytes == 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
                   : "memory");
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                   "n"(kBytes)
                   : "memory");
    }
  } else {
    *reinterpret_cast<uint16_t*>(dst) = *reinterpret_cast<const uint16_t*>(src);
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}
// one TMA box of a (W, H, C, N) tensor at (x, y, c, n); outside it, zeros
// `map` is the generic address of a __grid_constant__ CUtensorMap
__device__ __forceinline__ void tma_box(void* dst, uint64_t map, int x, int y, int c, int n,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(x), "r"(y), "r"(c), "r"(n), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

template <typename T>
__device__ __forceinline__ void store4(T* o, const float (&v)[kSeg], int n_valid, bool vec);
template <>
__device__ __forceinline__ void store4<float>(float* o, const float (&v)[kSeg], int n_valid,
                                              bool vec) {
  if (vec && n_valid == kSeg) {
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kSeg; ++i) {
      if (i < n_valid) o[i] = v[i];
    }
  }
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* o, const float (&v)[kSeg],
                                                      int n_valid, bool vec) {
  if (vec && n_valid == kSeg) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(o) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                              *reinterpret_cast<const uint32_t*>(&hi));
  } else {
#pragma unroll
    for (int i = 0; i < kSeg; ++i) {
      if (i < n_valid) o[i] = __float2bfloat16(v[i]);
    }
  }
}

// The launch and the staged layout, in elements. A stage holds `splits *
// chunk` channels: f1's block of f1_chan per channel (rows of f1_row), then
// at f2_off f2's block of f2_chan per channel (rows of f2_row). Tiled
// stagings (copies, tensor) hold f1's tile and f2's tile plus its border,
// 4 rows above and below, 4 columns right and `left` columns left (16
// bytes: TMA's boxes start on 16 bytes), with f2's element (y0 - 4, x0 -
// left) first; plane staging holds whole compact planes.
struct Geometry {
  int N, C, H, W;
  float count, inv_count;  // C and 1/C as floats
  int tile_h, tile_w, tiles_w, tiles;  // tiles: of all pairs
  int splits, chunk;  // channel groups of the CTA, channels per group per stage
  int left, f1_row, f2_row, f1_chan, f2_chan, f2_off, stage_elems;
};

// Copy staging: channels [c0, c0 + splits * chunk) of the tile at (x0, y0)
// by all threads. Only rows inside the plane are staged; a channel is
// f1_rows + f2_rows row slots of f2_row / kVec copies (f1's rows use the
// first tile_w / kVec); the threads walk (channel, row slot, copy) in
// order, each stepping by blockDim, with no division in the loop.
template <typename T, int kVec>
__device__ __forceinline__ void stage_copies(T* dst, const T* f1n, const T* f2n, int c0, int x0,
                                             int y0, const Geometry& g) {
  const size_t plane = static_cast<size_t>(g.H) * g.W;
  const int copies = g.f2_row / kVec;
  const int f1_rows = min(g.tile_h, g.H - y0);
  const int f2_lo = max(0, y0 - kDisp);
  const int rows = f1_rows + min(g.H, y0 + g.tile_h + kDisp) - f2_lo;
  const int channels = min(g.splits * g.chunk, g.C - c0);
  const int step_rows = blockDim.x / copies;
  const int step_cols = blockDim.x % copies;
  int col = threadIdx.x % copies;
  int rr = threadIdx.x / copies;
  int j = 0;
  while (rr >= rows) {
    rr -= rows;
    ++j;
  }
  while (j < channels) {
    const int x = col * kVec;
    if (rr < f1_rows) {
      if (x < g.tile_w) {
        const int gx = x0 + x;
        const bool in = gx < g.W;
        const T* src = f1n + static_cast<size_t>(c0 + j) * plane;
        stage_copy<T, kVec>(dst + j * g.f1_chan + rr * g.f1_row + x,
                            in ? src + static_cast<size_t>(y0 + rr) * g.W + gx : src, in);
      }
    } else if (x < g.left + g.tile_w + kDisp) {
      const int gy = f2_lo + rr - f1_rows;
      const int gx = x0 - g.left + x;
      // kVec divides W and x0 - left, so a copy lies wholly inside or outside
      const bool in = gx >= 0 && gx < g.W;
      const T* src = f2n + static_cast<size_t>(c0 + j) * plane;
      stage_copy<T, kVec>(dst + g.f2_off + j * g.f2_chan + (gy - y0 + kDisp) * g.f2_row + x,
                          in ? src + static_cast<size_t>(gy) * g.W + gx : src, in);
    }
    col += step_cols;
    rr += step_rows;
    if (col >= copies) {
      col -= copies;
      ++rr;
    }
    while (rr >= rows) {
      rr -= rows;
      ++j;
    }
  }
}

template <typename T, int kMode, int kVec>
__global__ void __launch_bounds__(kMaxThreads)
local_correlation_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                         T* __restrict__ out, const __grid_constant__ CUtensorMap map1,
                         const __grid_constant__ CUtensorMap map2, Geometry g) {
  extern __shared__ __align__(kAlign) unsigned char smem[];
  const int seg_row = g.tile_w / kSeg;
  const int per_split = kSide * g.tile_h * seg_row;
  const int per_stage = g.splits * g.chunk;
  T* ring = reinterpret_cast<T*>(smem);
  const size_t ring_bytes = static_cast<size_t>(kStages) * g.stage_elems * sizeof(T);
  // groups 1.. hand their sums to group 0 here: part[(group - 1) * per_split + lt][9]
  float4* part = reinterpret_cast<float4*>(smem + ring_bytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      smem + ring_bytes + static_cast<size_t>(g.splits - 1) * per_split * kSide * sizeof(float4));
  const size_t plane = static_cast<size_t>(g.H) * g.W;
  const int pair_tiles = g.tiles / g.N;
  const int n_chunks = (g.C + per_stage - 1) / per_stage;
  const int my_tiles =
      static_cast<int>(blockIdx.x) < g.tiles ? (g.tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int items = my_tiles * n_chunks;

  // this thread: channel group, then (dy, row, segment) within a tile
  const int split = threadIdx.x / per_split;
  const int lt = threadIdx.x - split * per_split;
  const int seg = lt % seg_row;
  const int r = (lt / seg_row) % g.tile_h;
  const int dy = lt / (seg_row * g.tile_h);  // displacement dy - 4
  const uint64_t map1_at = reinterpret_cast<uint64_t>(&map1);
  const uint64_t map2_at = reinterpret_cast<uint64_t>(&map2);

  if (kMode != kCopies && threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // (pair, tile origin) of item i: chunk i % n_chunks of the CTA's
  // (i / n_chunks)-th tile
  auto locate = [&](int i, int& n, int& x0, int& y0) {
    const int t = blockIdx.x + gridDim.x * (i / n_chunks);
    n = t / pair_tiles;
    const int in_pair = t - n * pair_tiles;
    const int ty = in_pair / g.tiles_w;
    y0 = ty * g.tile_h;
    x0 = (in_pair - ty * g.tiles_w) * g.tile_w;
  };
  auto issue = [&](int i) {
    if (i < items) {
      int n, x0, y0;
      locate(i, n, x0, y0);
      const int c0 = (i % n_chunks) * per_stage;
      T* dst = ring + (i % kStages) * g.stage_elems;
      if constexpr (kMode == kCopies) {
        const size_t base = static_cast<size_t>(n) * g.C * plane;
        stage_copies<T, kVec>(dst, f1 + base, f2 + base, c0, x0, y0, g);
      } else if (threadIdx.x == 0) {
        uint64_t* bar = bars + i % kStages;
        if constexpr (kMode == kTensor) {
          mbar_expect(bar, static_cast<uint32_t>(per_stage * (g.f1_chan + g.f2_chan) * sizeof(T)));
          tma_box(dst, map1_at, x0, y0, c0, n, bar);
          tma_box(dst + g.f2_off, map2_at, x0 - g.left, y0 - kDisp, c0, n, bar);
        } else {
          const size_t at = (static_cast<size_t>(n) * g.C + c0) * plane;
          const uint32_t bytes = static_cast<uint32_t>(min(per_stage, g.C - c0) * plane * sizeof(T));
          mbar_expect(bar, 2 * bytes);
          bulk_copy(dst, f1 + at, bytes, bar);
          bulk_copy(dst + g.f2_off, f2 + at, bytes, bar);
        }
      }
    }
    if constexpr (kMode == kCopies) cp_async_commit();  // an empty group keeps the count
  };

  float acc[kSide][kSeg];
#pragma unroll
  for (int dx = 0; dx < kSide; ++dx)
#pragma unroll
    for (int q = 0; q < kSeg; ++q) acc[dx][q] = 0.f;

  for (int i = 0; i < kStages - 1; ++i) issue(i);
  for (int i = 0; i < items; ++i) {
    issue(i + kStages - 1);
    if constexpr (kMode == kCopies) {
      cp_async_wait<kStages - 1>();  // item i has landed
      __syncthreads();
    } else {
      mbar_wait(bars + i % kStages, (i / kStages) & 1);
    }
    int n, x0, y0;
    locate(i, n, x0, y0);
    const int k = i % n_chunks;
    const int y2 = y0 + r + dy - kDisp;
    if (y2 >= 0 && y2 < g.H) {
      const T* stage = ring + (i % kStages) * g.stage_elems;
      const T* s1 = stage + split * g.chunk * g.f1_chan;
      const T* s2 = stage + g.f2_off + split * g.chunk * g.f2_chan;
      const int cn = min(g.chunk, g.C - k * per_stage - split * g.chunk);
      if constexpr (kMode == kPlaneBulk) {
        // compact planes, no border: f1 row y0 + r, f2 row y2, masked by x
        const int x = x0 + seg * kSeg;
        const int y = min(y0 + r, g.H - 1);  // rows past the plane compute and store nothing
        s1 += y * g.W + x;
        s2 += y2 * g.W + x - kDisp;
        for (int j = 0; j < cn; ++j) {
          float a[kSeg], b[kSeg + 2 * kDisp];
#pragma unroll
          for (int q = 0; q < kSeg; ++q) {
            a[q] = x + q < g.W ? to_float(s1[j * g.f1_chan + q]) : 0.f;
          }
#pragma unroll
          for (int m = 0; m < kSeg + 2 * kDisp; ++m) {
            const int xm = x - kDisp + m;
            b[m] = xm >= 0 && xm < g.W ? to_float(s2[j * g.f2_chan + m]) : 0.f;
          }
#pragma unroll
          for (int dx = 0; dx < kSide; ++dx)
#pragma unroll
            for (int q = 0; q < kSeg; ++q) acc[dx][q] += product<T>(a[q], b[q + dx]);
        }
      } else {
        s1 += r * g.f1_row + seg * kSeg;
        s2 += (r + dy) * g.f2_row + seg * kSeg + g.left - kDisp;
        if constexpr (sizeof(T) == 2) {
          for (int j = 0; j < cn; ++j) accumulate_bf16(acc, s1 + j * g.f1_chan, s2 + j * g.f2_chan);
        } else {
          for (int j = 0; j < cn; ++j) {
            float a[kSeg], b[kSeg + 2 * kDisp];
            load_row(a, s1 + j * g.f1_chan);
            load_row(b, s2 + j * g.f2_chan);
#pragma unroll
            for (int dx = 0; dx < kSide; ++dx)
#pragma unroll
              for (int q = 0; q < kSeg; ++q) acc[dx][q] += product<T>(a[q], b[q + dx]);
          }
        }
      }
    }
    if (k == n_chunks - 1) {  // the tile's last chunk: sum the groups, store
      if (g.splits > 1) {
        if (split > 0) {
          float4* p = part + ((split - 1) * per_split + lt) * kSide;
#pragma unroll
          for (int dx = 0; dx < kSide; ++dx) {
            p[dx] = make_float4(acc[dx][0], acc[dx][1], acc[dx][2], acc[dx][3]);
          }
        }
        __syncthreads();
        if (split == 0) {
          for (int sp = 1; sp < g.splits; ++sp) {
            const float4* p = part + ((sp - 1) * per_split + lt) * kSide;
#pragma unroll
            for (int dx = 0; dx < kSide; ++dx) {
              const float4 v = p[dx];
              acc[dx][0] += v.x;
              acc[dx][1] += v.y;
              acc[dx][2] += v.z;
              acc[dx][3] += v.w;
            }
          }
        }
      }
      // one displacement plane at a time, a warp's lanes on neighbouring
      // 4-pixel segments of a row
      const int y = y0 + r;
      const int x = x0 + seg * kSeg;
      if (split == 0 && y < g.H && x < g.W) {
        const int n_valid = min(kSeg, g.W - x);
        const bool vec = g.W % kSeg == 0;
        T* o = out + (static_cast<size_t>(n) * kPlanes + dy * kSide) * plane +
               static_cast<size_t>(y) * g.W + x;
#pragma unroll
        for (int dx = 0; dx < kSide; ++dx) {
          float v[kSeg];
#pragma unroll
          for (int q = 0; q < kSeg; ++q) v[q] = div_rn(acc[dx][q], g.count, g.inv_count);
          store4(o + static_cast<size_t>(dx) * plane, v, n_valid, vec);
        }
      }
#pragma unroll
      for (int dx = 0; dx < kSide; ++dx)
#pragma unroll
        for (int q = 0; q < kSeg; ++q) acc[dx][q] = 0.f;
    }
    __syncthreads();  // this stage's reads are done before it is refilled
  }
  if constexpr (kMode == kCopies) cp_async_wait<0>();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// the (W, H, C, N) tensor at `base` as boxes of (box_w, box_h, box_c, 1)
template <typename T>
bool tensor_map(CUtensorMap* map, const void* base, const Geometry& g, int box_w, int box_h,
                int box_c) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t e = sizeof(T);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(g.W), static_cast<cuuint64_t>(g.H),
                              static_cast<cuuint64_t>(g.C), static_cast<cuuint64_t>(g.N)};
  const cuuint64_t strides[3] = {g.W * e, static_cast<cuuint64_t>(g.H) * g.W * e,
                                 static_cast<cuuint64_t>(g.C) * g.H * g.W * e};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_w), static_cast<cuuint32_t>(box_h),
                             static_cast<cuuint32_t>(box_c), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  // the copy engine moves bits: values travel as 16- or 32-bit words
  // (a zero fill is +0.0 either way)
  const CUtensorMapDataType type = sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16
                                                  : CU_TENSOR_MAP_DATA_TYPE_UINT32;
  return encode(map, type, 4, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// How many CTAs of local_correlation_kernel<T, kMode, kVec> with `threads`
// and `smem` fit on the current device at once. The kernel's shared-memory
// limit (above 48 KB it must ask) is one value per kernel and device, so
// it is only ever raised, to the largest launch seen; the occupancy is
// asked once per device and launch shape (PWC's levels use a handful).
template <typename T, int kMode, int kVec>
cudaError_t resident_ctas(int threads, size_t smem, int* resident) {
  struct Entry {
    int device, threads;
    size_t smem;
    int ctas;
  };
  constexpr int kDevices = 64;
  constexpr int kEntries = 16;
  static std::mutex lock;
  static size_t granted[kDevices] = {};
  static Entry cache[kEntries];
  static int filled = 0;
  auto kernel = local_correlation_kernel<T, kMode, kVec>;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(lock);
  if (smem > 48 * 1024 && smem > granted[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    granted[device] = smem;
  }
  for (int i = 0; i < (filled < kEntries ? filled : kEntries); ++i) {
    const Entry& e = cache[i];
    if (e.device == device && e.threads == threads && e.smem == smem) {
      *resident = e.ctas;
      return cudaSuccess;
    }
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  }
  if (err != cudaSuccess) return err;
  *resident = per_sm * sms;
  cache[filled++ % kEntries] = Entry{device, threads, smem, *resident};
  return cudaSuccess;
}

template <typename T, int kMode, int kVec>
int launch(const void* f1, const void* f2, void* out, Geometry g, int threads,
           cudaStream_t stream) {
  // the staged layout (see Geometry); rows and blocks start on 16 bytes
  // (TMA's box rows) and 128 bytes (a block) respectively
  const int per_stage = g.splits * g.chunk;
  const int row_unit = 16 / static_cast<int>(sizeof(T));
  const int block_unit = kAlign / static_cast<int>(sizeof(T));
  if (kMode == kPlaneBulk) {
    g.f1_row = g.f2_row = g.W;
    g.f1_chan = g.f2_chan = g.H * g.W;
  } else {
    g.left = row_unit > kDisp ? row_unit : kDisp;
    g.f1_row = round_up(g.tile_w, row_unit);
    g.f2_row = round_up(g.left + g.tile_w + kDisp, row_unit);
    g.f1_chan = g.tile_h * g.f1_row;
    g.f2_chan = (g.tile_h + 2 * kDisp) * g.f2_row;
  }
  g.f2_off = round_up(per_stage * g.f1_chan, block_unit);
  g.stage_elems = round_up(g.f2_off + per_stage * g.f2_chan, block_unit);
  const size_t smem = static_cast<size_t>(kStages) * g.stage_elems * sizeof(T) +
                      static_cast<size_t>(g.splits - 1) * (threads / g.splits) * kSide *
                          sizeof(float4) +
                      kStages * sizeof(uint64_t);

  CUtensorMap map1 = {}, map2 = {};
  if (kMode == kTensor &&
      !(tensor_map<T>(&map1, f1, g, g.f1_row, g.tile_h, per_stage) &&
        tensor_map<T>(&map2, f2, g, g.f2_row, g.tile_h + 2 * kDisp, per_stage))) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  auto kernel = local_correlation_kernel<T, kMode, kVec>;
  int resident = 0;
  const cudaError_t err = resident_ctas<T, kMode, kVec>(threads, smem, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // persistent CTAs: as many as fit on the card at once, at most one a tile
  const int grid = g.tiles < resident ? g.tiles : resident;
  kernel<<<grid, threads, smem, stream>>>(static_cast<const T*>(f1), static_cast<const T*>(f2),
                                          static_cast<T*>(out), map1, map2, g);
  return static_cast<int>(cudaGetLastError());
}

// The staging the shape allows (see the header): the copy engine where rows
// and tiles (tensor) or whole planes (planes) are multiples of 16 bytes at
// 16-byte aligned bases, else copies of the widest width (4, 2 or 1 elements) that
// W and the bases allow.
template <typename T>
int dispatch(const void* f1, const void* f2, void* out, const Geometry& g, int threads,
             cudaStream_t stream) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(f1) | reinterpret_cast<uintptr_t>(f2);
  const size_t plane_bytes = static_cast<size_t>(g.H) * g.W * sizeof(T);
  if (bases % 16 == 0) {
    if (g.tiles == g.N && plane_bytes % 16 == 0) {
      return launch<T, kPlaneBulk, 4>(f1, f2, out, g, threads, stream);
    }
    if ((g.W * sizeof(T)) % 16 == 0 && (g.tile_w * sizeof(T)) % 16 == 0) {
      return launch<T, kTensor, 4>(f1, f2, out, g, threads, stream);
    }
  }
  if (g.W % 4 == 0 && bases % (4 * sizeof(T)) == 0) {
    return launch<T, kCopies, 4>(f1, f2, out, g, threads, stream);
  }
  if (g.W % 2 == 0 && bases % (2 * sizeof(T)) == 0) {
    return launch<T, kCopies, 2>(f1, f2, out, g, threads, stream);
  }
  return launch<T, kCopies, 1>(f1, f2, out, g, threads, stream);
}

}  // namespace

// f1 and f2 (n, c, h, w), out (n, 81, h, w), all contiguous, fp32
// (is_bf16 = 0) or bf16 (is_bf16 = 1); max displacement 4. The CTA tile
// (tile_h rows, tile_w columns, tile_w a multiple of 4), the channel
// groups (splits) and the channels a group stages at a time (chunk) come
// from the wrapper's launch_shape; the CTA has 9 * tile_h * tile_w / 4 *
// splits <= 512 threads. Requires n <= 65535. Launches on `stream` and
// returns cudaGetLastError() (cudaErrorNotSupported where a TMA descriptor
// cannot be made).
extern "C" int vft_local_correlation_forward(const void* f1, const void* f2, void* out, int n,
                                             int c, int h, int w, int tile_h, int tile_w,
                                             int splits, int chunk, int is_bf16,
                                             void* stream) {
  if (n < 1 || n > 65535 || c < 1 || h < 1 || w < 1 || tile_h < 1 || tile_w < kSeg ||
      tile_w % kSeg != 0 || splits < 1 || chunk < 1 || splits * chunk > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = kSide * tile_h * (tile_w / kSeg) * splits;
  if (threads > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_w = (w + tile_w - 1) / tile_w;
  Geometry g{};
  g.N = n;
  g.C = c;
  g.H = h;
  g.W = w;
  g.count = static_cast<float>(c);
  g.inv_count = 1.f / static_cast<float>(c);
  g.tile_h = tile_h;
  g.tile_w = tile_w;
  g.tiles_w = tiles_w;
  g.tiles = n * tiles_w * ((h + tile_h - 1) / tile_h);
  g.splits = splits;
  g.chunk = chunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return dispatch<__nv_bfloat16>(f1, f2, out, g, threads, s);
  return dispatch<float>(f1, f2, out, g, threads, s);
}
