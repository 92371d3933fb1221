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
// Design, two launches:
//  1. rows: a block of W warps (W = 4, or 1 for wide rows) takes a
//     contiguous run of rows; each warp one row at a time, with the loop
//     kernel's layout (16-byte vectors, a lane every 32nd vector). Pass one
//     sums x^2 and x*w*dy in fp32 and reduces them with shuffles; pass two
//     re-reads the row (from L1) and writes dx. Each warp adds its rows'
//     dy*x*r into its own fp32 slice of shared memory, so no two threads
//     ever add to one value; at the end the block sums its W slices in
//     order and writes one row of partial[blocks, H].
//  2. reduce: a thread per column sums partial's rows in order and casts.
// No atomics anywhere, so dw is the same from run to run.
#include "common.cuh"

namespace repro_torch {
namespace {

template <typename T>
__global__ void rmsnorm_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ w,
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

template <typename T>
__global__ void rmsnorm_bwd_reduce_kernel(const float* __restrict__ partial, T* __restrict__ dw,
                                          int blocks, int H) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= H) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partial[static_cast<size_t>(b) * H + i];
  dw[i] = from_f32<T>(s);
}

template <typename T>
int launch(const void* x, const void* w, const void* dy, void* dx, void* dw, float* partial,
           int rows, int H, float eps, int blocks, int warps, cudaStream_t stream) {
  const int smem = warps * H * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(rmsnorm_bwd_rows_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int per_block = (rows + blocks - 1) / blocks;
  rmsnorm_bwd_rows_kernel<T><<<blocks, 32 * warps, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(dy),
      static_cast<T*>(dx), partial, rows, H, per_block, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  rmsnorm_bwd_reduce_kernel<T><<<(H + 255) / 256, 256, 0, stream>>>(partial, static_cast<T*>(dw),
                                                                     blocks, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// x, dy, dx: [rows, H] contiguous; w, dw: [H]; all of one dtype; partial:
// fp32 scratch [blocks, H]. `warps` (1 or 4) warps a block; kernels/rmsnorm.py
// bwd_blocks picks both. Returns the cudaError_t of the launches (0 on
// success).
extern "C" int rmsnorm_bwd_launch(const void* x, const void* w, const void* dy, void* dx,
                                  void* dw, void* partial, int rows, int H, float eps, int dtype,
                                  int blocks, int warps, void* stream) {
  using namespace repro_torch;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || H <= 0 || H % 8 != 0 || blocks <= 0 || (warps != 1 && warps != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  float* p = static_cast<float*>(partial);
  if (dtype == kFloat32) return launch<float>(x, w, dy, dx, dw, p, rows, H, eps, blocks, warps, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, w, dy, dx, dw, p, rows, H, eps, blocks, warps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
