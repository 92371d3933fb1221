// Row RMSNorm for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rmsnorm.py, _rmsnorm_kernel / rmsnorm_pallas.
//   y = (x * rsqrt(mean(x^2) + eps) * w) in fp32, then cast to x's type.
//
// Bound on the H100: memory. Every element of x is read once and every
// element of y written once, so the least time is 2*T*H*bytes / 3.35 TB/s
// (w is H values, read once per row but from L1/L2). The arithmetic,
// ~4 flops per element, is far below the card's 295 flop/byte balance.
//
// Design: one warp per row, four rows per 128-thread block, so any T
// works with no padding (the TPU kernel padded T to 256-row blocks). Each
// lane moves 16 bytes per load (8 bf16 or 4 fp32): H must be a multiple
// of 8. The sum of squares stays in an fp32 register and is reduced by
// warp shuffles, with no shared memory and no block barrier. The second
// pass re-reads the row, which a row of at most a few tens of kB finds in
// L1; it multiplies by w in fp32 before the single cast, as the TPU
// kernel does.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kRowsPerBlock = 4;

template <typename T>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
               int rows, int H, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
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

template <typename T>
int launch(const void* x, const void* w, void* out, int rows, int H, float eps,
           cudaStream_t stream) {
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  rmsnorm_kernel<T><<<grid, 32 * kRowsPerBlock, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), rows, H, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// x, out: [rows, H] contiguous; w: [H]; all of one dtype. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int rmsnorm_launch(const void* x, const void* w, void* out, int rows, int H,
                              float eps, int dtype, void* stream) {
  using namespace repro_torch;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || H <= 0 || H % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kFloat32) return launch<float>(x, w, out, rows, H, eps, s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(x, w, out, rows, H, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
