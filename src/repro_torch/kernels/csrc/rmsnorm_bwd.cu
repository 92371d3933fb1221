// Row RMSNorm, backward, for Hopper (sm_90a).
//
// The TPU kernel (src/repro/kernels/rmsnorm.py, rmsnorm_pallas) is forward
// only; this is the gradient of the port's forward (csrc/rmsnorm.cu), the
// math of kernels/ref.py rmsnorm_bwd_ref. With r = rsqrt(mean(x^2) + eps)
// per row:
//   dx = r * (w * dy) - x * r^3 * mean(x * w * dy)     (written in x's type)
//   dw = sum over rows of dy * x * r                   (fp32, then w's type)
//
// Bound on the H100: memory. x and dy are read once and dx written once,
// 3*T*H*bytes / 3.35 TB/s (plus w, and the dw partials, blocks*H fp32 each
// way); ~10 flops an element are far below the card's flop/byte balance.
//
// Two versions of the first launch, picked by kernels/rmsnorm.py
// bwd_kernel_path, then one reduction:
//  * rows (bf16 at the widths the models train at: H 1536, 1600, 2560,
//    3200, 4096, 5120, kernels/rmsnorm.py BWD_ROW_GROUPS): a row is spread
//    over 128 threads (4 warps), each holding its columns of x and dy in
//    registers (8-byte vectors, a warp on 256 contiguous bytes; where H / 4
//    is not a multiple of 128, the last vector of a thread is predicated
//    off past the row), so x, w and dy are read once. A CTA runs G such
//    row groups, one CTA an SM, each group striding over rows: G = 8 at
//    1536 and 1600, where a row is small and more rows must be in flight
//    to cover the memory latency; 4 elsewhere. Sums of x^2 and x*w*dy go
//    through shuffles, then across the group's 4 warps through a few
//    floats of shared memory (double-buffered by row, one named barrier a
//    row). A thread owns the same columns on every row, so its dw partial
//    stays in fp32 registers across all its rows; w is staged once in
//    shared memory. At the end the CTA sums its G groups' partials in
//    order into one row of partial[blocks, H]: about one partial row per SM.
//  * loop (fp32, and bf16 at any other H): a block of W warps (W = 4, or 1
//    for wide rows) takes a contiguous run of rows; each warp one row at a
//    time, with 16-byte vectors, a lane every 32nd. Pass one sums x^2 and
//    x*w*dy; pass two re-reads the row (from L1) and writes dx. Each warp
//    adds its rows' dy*x*r into its own fp32 slice of shared memory; the
//    block sums its W slices in order into one row of partial.
//  * reduce: 8 warps a block of 128 columns; warp i sums partial rows i,
//    i + 8, ... in order, then the block sums its warps in order and casts.
// No atomics anywhere, so dw is the same from run to run.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kRowThreads = 128;   // threads a row, register version
constexpr int kReduceWarps = 8;

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ float4 bf16x4(uint2 u) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// H bf16 columns (a multiple of 4), G row groups a CTA; thread `tid` of a
// row group holds the 4-column vectors tid, tid + 128, ... of its row, the
// last of them only where it lies inside the row
template <int H, int G>
__global__ void __launch_bounds__(kRowThreads * G, 1)
rmsnorm_bwd_rows_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                        const __nv_bfloat16* __restrict__ dy, __nv_bfloat16* __restrict__ dx,
                        float* __restrict__ partial, int rows, float eps) {
  static_assert(H % 4 == 0, "rows of whole 4-column vectors");
  constexpr int kVecs = H / 4;
  constexpr int V = (kVecs + kRowThreads - 1) / kRowThreads;   // vectors a thread
  constexpr int kTail = kVecs - (V - 1) * kRowThreads;          // threads holding a V-th
  extern __shared__ __align__(16) float sdw[];   // [G][H]: the groups' dw at the end
  __shared__ uint2 sw[kVecs];
  __shared__ float2 red[2][G][kRowThreads / 32];
  const int g = threadIdx.x / kRowThreads, tid = threadIdx.x % kRowThreads;
  const int warp = tid / 32, lane = tid % 32;
  const auto live = [&](int k) { return k < V - 1 || kTail == kRowThreads || tid < kTail; };
  for (int i = threadIdx.x; i < kVecs; i += blockDim.x)
    sw[i] = __ldg(reinterpret_cast<const uint2*>(w) + i);
  __syncthreads();

  float acc[4 * V];
#pragma unroll
  for (int i = 0; i < 4 * V; ++i) acc[i] = 0.f;
  int parity = 0;
  for (int row = blockIdx.x * G + g; row < rows; row += gridDim.x * G) {
    const uint2* xr = reinterpret_cast<const uint2*>(x + static_cast<size_t>(row) * H);
    const uint2* gr = reinterpret_cast<const uint2*>(dy + static_cast<size_t>(row) * H);
    uint2 xv[V], gv[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      xv[k] = gv[k] = make_uint2(0u, 0u);   // a dead vector adds 0 to both sums
      if (live(k)) {
        xv[k] = __ldg(xr + tid + kRowThreads * k);
        gv[k] = __ldg(gr + tid + kRowThreads * k);
      }
    }
    float ss = 0.f, sxwg = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float4 xf = bf16x4(xv[k]), gf = bf16x4(gv[k]),
                   wf = bf16x4(live(k) ? sw[tid + kRowThreads * k] : make_uint2(0u, 0u));
      ss = fmaf(xf.x, xf.x, ss);
      ss = fmaf(xf.y, xf.y, ss);
      ss = fmaf(xf.z, xf.z, ss);
      ss = fmaf(xf.w, xf.w, ss);
      sxwg = fmaf(xf.x * wf.x, gf.x, sxwg);
      sxwg = fmaf(xf.y * wf.y, gf.y, sxwg);
      sxwg = fmaf(xf.z * wf.z, gf.z, sxwg);
      sxwg = fmaf(xf.w * wf.w, gf.w, sxwg);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      sxwg += __shfl_xor_sync(0xffffffffu, sxwg, o);
    }
    if (lane == 0) red[parity][g][warp] = make_float2(ss, sxwg);
    bar_sync(1 + g, kRowThreads);
    float2 sum = red[parity][g][0];
#pragma unroll
    for (int i = 1; i < kRowThreads / 32; ++i) {
      sum.x += red[parity][g][i].x;
      sum.y += red[parity][g][i].y;
    }
    parity ^= 1;
    const float r = rsqrtf(sum.x / static_cast<float>(H) + eps);
    const float r3c = r * r * r * (sum.y / static_cast<float>(H));
    uint2* dr = reinterpret_cast<uint2*>(dx + static_cast<size_t>(row) * H);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (!live(k)) continue;
      const float4 xf = bf16x4(xv[k]), wf = bf16x4(sw[tid + kRowThreads * k]),
                   gf = bf16x4(gv[k]);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(r * (wf.x * gf.x) - xf.x * r3c,
                                                      r * (wf.y * gf.y) - xf.y * r3c);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(r * (wf.z * gf.z) - xf.z * r3c,
                                                      r * (wf.w * gf.w) - xf.w * r3c);
      uint2 o;
      o.x = *reinterpret_cast<const uint32_t*>(&lo);
      o.y = *reinterpret_cast<const uint32_t*>(&hi);
      dr[tid + kRowThreads * k] = o;
      acc[4 * k] += gf.x * xf.x * r;
      acc[4 * k + 1] += gf.y * xf.y * r;
      acc[4 * k + 2] += gf.z * xf.z * r;
      acc[4 * k + 3] += gf.w * xf.w * r;
    }
  }
  // the CTA's dw: its groups' partials, summed in group order
  float* mine = sdw + g * H;
#pragma unroll
  for (int k = 0; k < V; ++k)
    if (live(k))
      *reinterpret_cast<float4*>(mine + 4 * (tid + kRowThreads * k)) =
          make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2], acc[4 * k + 3]);
  __syncthreads();
  float* out = partial + static_cast<size_t>(blockIdx.x) * H;
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    float s = sdw[i];
#pragma unroll
    for (int k = 1; k < G; ++k) s += sdw[k * H + i];
    out[i] = s;
  }
}

template <typename T>
__global__ void rmsnorm_bwd_loop_kernel(const T* __restrict__ x, const T* __restrict__ w,
                                        const T* __restrict__ dy, T* __restrict__ dx,
                                        float* __restrict__ partial, int rows, int H,
                                        int rows_per_block, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ __align__(16) float sdw[];  // [warps][H]
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nvec = H / kVec;
  float* my = sdw + static_cast<size_t>(warp) * H;
  for (int i = lane; i < H; i += 32) my[i] = 0.f;
  __syncwarp();  // below, lane l adds to the values of its own vectors only

  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  const uint4* wv = reinterpret_cast<const uint4*>(w);
  for (int row = r0 + warp; row < r1; row += warps) {
    const size_t off = static_cast<size_t>(row) * H;
    const uint4* xr = reinterpret_cast<const uint4*>(x + off);
    const uint4* gr = reinterpret_cast<const uint4*>(dy + off);
    float ss = 0.f, sxwg = 0.f;
    for (int i = lane; i < nvec; i += 32) {
      const uint4 xu = xr[i], wu = wv[i], gu = gr[i];
      const T* xe = reinterpret_cast<const T*>(&xu);
      const T* we = reinterpret_cast<const T*>(&wu);
      const T* ge = reinterpret_cast<const T*>(&gu);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float xf = to_f32(xe[j]);
        ss = fmaf(xf, xf, ss);
        sxwg = fmaf(xf * to_f32(we[j]), to_f32(ge[j]), sxwg);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      sxwg += __shfl_xor_sync(0xffffffffu, sxwg, o);
    }
    const float r = rsqrtf(ss / static_cast<float>(H) + eps);
    const float c = sxwg / static_cast<float>(H);
    const float r3c = r * r * r * c;
    uint4* dr = reinterpret_cast<uint4*>(dx + off);
    for (int i = lane; i < nvec; i += 32) {
      const uint4 xu = xr[i], wu = wv[i], gu = gr[i];
      const T* xe = reinterpret_cast<const T*>(&xu);
      const T* we = reinterpret_cast<const T*>(&wu);
      const T* ge = reinterpret_cast<const T*>(&gu);
      uint4 o;
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float xf = to_f32(xe[j]), gf = to_f32(ge[j]);
        oe[j] = from_f32<T>(r * (to_f32(we[j]) * gf) - xf * r3c);
        my[i * kVec + j] += gf * xf * r;
      }
      dr[i] = o;
    }
  }
  __syncthreads();
  float* out = partial + static_cast<size_t>(blockIdx.x) * H;
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < warps; ++k) s += sdw[static_cast<size_t>(k) * H + i];
    out[i] = s;
  }
}

// dw[i] = sum over the `blocks` partial rows, in row order: a block of 8
// warps takes 128 columns (a float4 a lane); warp k sums rows k, k + 8, ...
// and the block then sums its warps in order
template <typename T>
__global__ void __launch_bounds__(32 * kReduceWarps)
rmsnorm_bwd_reduce_kernel(const float* __restrict__ partial, T* __restrict__ dw, int blocks,
                          int H) {
  __shared__ float4 part[kReduceWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c4 = blockIdx.x * 32 + lane;   // float4 column
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (4 * c4 < H) {
#pragma unroll 4
    for (int b = warp; b < blocks; b += kReduceWarps) {
      const float4 v = reinterpret_cast<const float4*>(partial + static_cast<size_t>(b) * H)[c4];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || 4 * c4 >= H) return;
  for (int k = 1; k < kReduceWarps; ++k) {
    s.x += part[k][lane].x;
    s.y += part[k][lane].y;
    s.z += part[k][lane].z;
    s.w += part[k][lane].w;
  }
  dw[4 * c4] = from_f32<T>(s.x);
  dw[4 * c4 + 1] = from_f32<T>(s.y);
  dw[4 * c4 + 2] = from_f32<T>(s.z);
  dw[4 * c4 + 3] = from_f32<T>(s.w);
}

// dynamic shared memory of the register version: the groups' dw rows
template <int H, int G> constexpr int rows_smem() { return G * H * 4; }

template <int H, int G> cudaError_t rows_smem_limit() {
  return cudaFuncSetAttribute(rmsnorm_bwd_rows_kernel<H, G>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, rows_smem<H, G>());
}

template <int H, int G> int rows_info(int* out) {
  const cudaError_t e = rows_smem_limit<H, G>();
  if (e != cudaSuccess) return static_cast<int>(e);
  return kernel_info(rmsnorm_bwd_rows_kernel<H, G>, kRowThreads * G, rows_smem<H, G>(), out);
}

template <int H, int G>
cudaError_t launch_rows(const void* x, const void* w, const void* dy, void* dx, float* partial,
                        int rows, float eps, int blocks, int warps, cudaStream_t stream) {
  if (warps != 4 * G) return cudaErrorInvalidValue;   // kernels/rmsnorm.py bwd_grid
  const cudaError_t e = rows_smem_limit<H, G>();
  if (e != cudaSuccess) return e;
  rmsnorm_bwd_rows_kernel<H, G><<<blocks, kRowThreads * G, rows_smem<H, G>(), stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(dy), static_cast<__nv_bfloat16*>(dx), partial, rows, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_loop(const void* x, const void* w, const void* dy, void* dx, float* partial,
                        int rows, int H, float eps, int blocks, int warps, cudaStream_t stream) {
  const int smem = warps * H * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(rmsnorm_bwd_loop_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int per_block = (rows + blocks - 1) / blocks;
  rmsnorm_bwd_loop_kernel<T><<<blocks, 32 * warps, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(dy),
      static_cast<T*>(dx), partial, rows, H, per_block, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_reduce(const float* partial, void* dw, int blocks, int H, cudaStream_t stream) {
  rmsnorm_bwd_reduce_kernel<T><<<(H / 4 + 31) / 32, 32 * kReduceWarps, 0, stream>>>(
      partial, static_cast<T*>(dw), blocks, H);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// x, dy, dx: [rows, H] contiguous; w, dw: [H]; all of one dtype; partial:
// fp32 scratch [blocks, H]. rows != 0 picks the bf16 register version at
// the widths of kernels/rmsnorm.py BWD_ROW_GROUPS, on `blocks` CTAs of
// `warps` = 4 G warps (G row groups); rows = 0 the loop version, `warps`
// (1 or 4) warps a block. kernels/rmsnorm.py bwd_kernel_path and bwd_grid
// pick them. Returns the cudaError_t of the launches (0 on success).
extern "C" int rmsnorm_bwd_launch(const void* x, const void* w, const void* dy, void* dx,
                                  void* dw, void* partial, int rows, int H, float eps, int dtype,
                                  int row_version, int blocks, int warps, void* stream) {
  using namespace repro_torch;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || H <= 0 || H % 8 != 0 || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  float* p = static_cast<float*>(partial);
  cudaError_t e;
  if (row_version) {
    if (dtype != kBFloat16) return static_cast<int>(cudaErrorInvalidValue);
    switch (H) {
      case 1536: e = launch_rows<1536, 8>(x, w, dy, dx, p, rows, eps, blocks, warps, s); break;
      case 1600: e = launch_rows<1600, 8>(x, w, dy, dx, p, rows, eps, blocks, warps, s); break;
      case 2560: e = launch_rows<2560, 4>(x, w, dy, dx, p, rows, eps, blocks, warps, s); break;
      case 3200: e = launch_rows<3200, 4>(x, w, dy, dx, p, rows, eps, blocks, warps, s); break;
      case 4096: e = launch_rows<4096, 4>(x, w, dy, dx, p, rows, eps, blocks, warps, s); break;
      case 5120: e = launch_rows<5120, 4>(x, w, dy, dx, p, rows, eps, blocks, warps, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (warps != 1 && warps != 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else if (dtype == kFloat32) {
    e = launch_loop<float>(x, w, dy, dx, p, rows, H, eps, blocks, warps, s);
  } else if (dtype == kBFloat16) {
    e = launch_loop<__nv_bfloat16>(x, w, dy, dx, p, rows, H, eps, blocks, warps, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  e = dtype == kFloat32 ? launch_reduce<float>(p, dw, blocks, H, s)
                        : launch_reduce<__nv_bfloat16>(p, dw, blocks, H, s);
  return static_cast<int>(e);
}

// Registers a thread, local-memory bytes a thread (spills), dynamic shared
// memory bytes and CTAs an SM of the register version at width H, in four
// ints. Returns a cudaError_t.
extern "C" int rmsnorm_bwd_rows_info(int H, int* out) {
  using namespace repro_torch;
  switch (H) {
    case 1536: return rows_info<1536, 8>(out);
    case 1600: return rows_info<1600, 8>(out);
    case 2560: return rows_info<2560, 4>(out);
    case 3200: return rows_info<3200, 4>(out);
    case 4096: return rows_info<4096, 4>(out);
    case 5120: return rows_info<5120, 4>(out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
