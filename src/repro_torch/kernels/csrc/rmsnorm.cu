// Row RMSNorm for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rmsnorm.py, _rmsnorm_kernel / rmsnorm_pallas.
//   y = (x * rsqrt(mean(x^2) + eps) * w) in fp32, then cast to x's type.
//
// Bound on the H100: memory. Every element of x is read once and every
// element of y written once, so the least time is 2*T*H*bytes / 3.35 TB/s
// (w, H values, once). The arithmetic, ~4 flops per element, is far below
// the card's 295 flop/byte balance.
//
// Design: one warp per row, so any T works with no padding (the TPU kernel
// padded T to 256-row blocks). Lanes move 16 bytes per load (8 bf16 or 4
// fp32), so H must be a multiple of 8. The sum of squares stays in an fp32
// register and is reduced by warp shuffles; w multiplies in fp32 before the
// single cast, as the TPU kernel does. Two versions:
//  * rows (bf16, H = 256 * VPL for VPL 10, 16, 20: 2560, 4096 and 5120, the
//    widths of the served models): each lane holds its VPL vectors of the
//    row in registers. It issues all of its loads before the reduction, so
//    a warp has the whole row in flight and x is read from memory once; w
//    is loaded once per block into shared memory while the block's warps
//    stride over rows, on a grid sized to fill the SMs. Loads and stores
//    carry no evict-first hint: y is read by the very next operation, and
//    where x and y fit L2 the hint made the time bimodal (PERF.md).
//  * loop (fp32, and bf16 at any other H): a loop over the row's vectors,
//    then a second pass that re-reads the row (from L1 for rows of a few
//    tens of kB) and w, four rows per 128-thread block.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kWarpsPerBlock = 4;

template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
rmsnorm_loop_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                    int rows, int H, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * H);
  const uint4* wv = reinterpret_cast<const uint4*>(w);
  uint4* orow = reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * H);
  const int nvec = H / kVec;

  float ss = 0.f;
  for (int i = lane; i < nvec; i += 32) {
    const uint4 u = xr[i];
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float f = to_f32(e[j]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float inv = rsqrtf(ss / static_cast<float>(H) + eps);

  for (int i = lane; i < nvec; i += 32) {
    const uint4 u = xr[i];
    const uint4 wu = wv[i];
    uint4 o;
    const T* e = reinterpret_cast<const T*>(&u);
    const T* we = reinterpret_cast<const T*>(&wu);
    T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int j = 0; j < kVec; ++j) oe[j] = from_f32<T>(to_f32(e[j]) * inv * to_f32(we[j]));
    orow[i] = o;
  }
}

// a lane's VPL vectors of bf16 row `row` (H = 256 * VPL): lane, lane + 32, ...
template <int VPL>
__device__ __forceinline__ void load_row(uint4 (&xv)[VPL], const __nv_bfloat16* x, int row,
                                         int lane) {
  const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * (VPL * 256));
#pragma unroll
  for (int i = 0; i < VPL; ++i) xv[i] = __ldg(xr + i * 32 + lane);
}

// y = x * rsqrt(mean x^2 + eps) * w for the row a warp holds; w from
// shared memory
template <int VPL>
__device__ __forceinline__ void norm_row(uint4 (&xv)[VPL], const uint4* sw,
                                         __nv_bfloat16* out, int row, int lane, float eps) {
  constexpr int H = VPL * 256;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&xv[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(e[j]);
      ss = fmaf(f.x, f.x, ss);
      ss = fmaf(f.y, f.y, ss);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float inv = rsqrtf(ss / static_cast<float>(H) + eps);
  // Convert the row again below rather than keep the fp32 copies of the
  // sum's pass: those would double the registers a row takes (and so
  // halve the rows in flight).
#pragma unroll
  for (int i = 0; i < VPL; ++i)
    asm volatile("" : "+r"(xv[i].x), "+r"(xv[i].y), "+r"(xv[i].z), "+r"(xv[i].w));

  uint4* orow = reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * H);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const uint4 wu = sw[i * 32 + lane];
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&xv[i]);
    const __nv_bfloat162* we = reinterpret_cast<const __nv_bfloat162*>(&wu);
    uint4 o;
    __nv_bfloat162* oe = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(e[j]);
      const float2 g = __bfloat1622float2(we[j]);
      oe[j] = __floats2bfloat162_rn(f.x * inv * g.x, f.y * inv * g.y);
    }
    orow[i * 32 + lane] = o;
  }
}

// bf16 rows of H = 256 * VPL: lane `lane` holds vectors lane, lane + 32, ...
// of its warp's row. w is staged once per block in shared memory (kept in
// registers, its fp32 conversion would be hoisted out of the row loop and
// double its share); the first row's loads are issued before it.
template <int VPL>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
rmsnorm_rows_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                    __nv_bfloat16* __restrict__ out, int rows, float eps) {
  __shared__ uint4 sw[VPL * 32];
  const int lane = threadIdx.x % 32;
  const int warps = gridDim.x * kWarpsPerBlock;
  int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  uint4 xv[VPL];
  if (row < rows) load_row(xv, x, row, lane);
  for (int i = threadIdx.x; i < VPL * 32; i += 32 * kWarpsPerBlock)
    sw[i] = __ldg(reinterpret_cast<const uint4*>(w) + i);
  __syncthreads();
  while (row < rows) {
    norm_row(xv, sw, out, row, lane, eps);
    row += warps;
    if (row < rows) load_row(xv, x, row, lane);
  }
}

template <typename T>
int launch_loop(const void* x, const void* w, void* out, int rows, int H, float eps,
                cudaStream_t stream) {
  const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  rmsnorm_loop_kernel<T><<<grid, 32 * kWarpsPerBlock, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), rows, H, eps);
  return static_cast<int>(cudaGetLastError());
}

template <int VPL>
int launch_rows(const void* x, const void* w, void* out, int rows, float eps,
                cudaStream_t stream) {
  // as many blocks as stay resident at once (found once per instantiation),
  // at most one warp per row
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rmsnorm_rows_kernel<VPL>,
                                                        32 * kWarpsPerBlock, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int needed = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int blocks = needed < resident ? needed : resident;
  rmsnorm_rows_kernel<VPL><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(out), rows, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// x, out: [rows, H] contiguous; w: [H]; all of one dtype. vpl > 0 picks the
// bf16 register kernel for H = 256 * vpl (kernels/rmsnorm.py ROW_VPL lists
// the instantiations), vpl = 0 the loop kernel. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int rmsnorm_launch(const void* x, const void* w, void* out, int rows, int H,
                              float eps, int dtype, int vpl, void* stream) {
  using namespace repro_torch;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || H <= 0 || H % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (vpl > 0) {
    if (dtype != kBFloat16 || H != 256 * vpl) return static_cast<int>(cudaErrorInvalidValue);
    switch (vpl) {
      case 10: return launch_rows<10>(x, w, out, rows, eps, s);
      case 16: return launch_rows<16>(x, w, out, rows, eps, s);
      case 20: return launch_rows<20>(x, w, out, rows, eps, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype == kFloat32) return launch_loop<float>(x, w, out, rows, H, eps, s);
  if (dtype == kBFloat16) return launch_loop<__nv_bfloat16>(x, w, out, rows, H, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
