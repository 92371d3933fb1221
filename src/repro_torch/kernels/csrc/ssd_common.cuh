// Pieces shared by the wgmma SSD kernels, forward (ssd_scan.cu) and
// backward (ssd_scan_bwd_wgmma.cu): the chunk geometry, bf16 pair helpers,
// the per-chunk cumulative decay, and C.B^T of each 64-token chunk, which
// does not depend on the head and is computed once per (b, chunk) for all
// of them.
#pragma once

#include <math.h>

#include "hopper.cuh"

namespace repro_torch {
namespace {

constexpr int kQ = 64;                 // tokens per chunk
constexpr int kHP = 64;                // head dim served
constexpr int kThreads = 128;          // one warpgroup
constexpr int kBox = kQ * 128;         // a [64 rows][64 bf16] box: 8 KB
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, float lo, float hi) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return pack_bf16(f.x * lo, f.y * hi);
}

// a ~ hi + lo and b likewise, as bf16 pairs: hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - f.x, b - f.y);
}

// dt of tokens r0 + 2 lane and r0 + 2 lane + 1, 0 at or past S
__device__ __forceinline__ void load_dt(const float* dtg, long long ss, int r0, int S, int lane,
                                        float& d0, float& d1) {
  const int t0 = r0 + 2 * lane;
  d0 = t0 < S ? __ldg(dtg + t0 * ss) : 0.f;
  d1 = t0 + 1 < S ? __ldg(dtg + (t0 + 1) * ss) : 0.f;
}

// One warp: a = dt * A over the chunk, its inclusive cumsum acs, the state
// weights w_j = exp(acs_last - acs_j) dt_j and exp(acs_i); two rows a lane.
__device__ __forceinline__ void scan_chunk(float d0, float d1, float A, int lane, float* sDt,
                                           float* sAcs, float* sW, float* sEa) {
  const float a0 = d0 * A, a1 = d1 * A;
  float incl = a0 + a1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  const float c0 = excl + a0, c1 = c0 + a1;
  const float last = __shfl_sync(0xffffffffu, c1, 31);
  sDt[2 * lane] = d0;
  sDt[2 * lane + 1] = d1;
  sAcs[2 * lane] = c0;
  sAcs[2 * lane + 1] = c1;
  sW[2 * lane] = expf(last - c0) * d0;
  sW[2 * lane + 1] = expf(last - c1) * d1;
  sEa[2 * lane] = expf(c0);
  sEa[2 * lane + 1] = expf(c1);
}

// C.B^T per (b, chunk), grid (chunk, b): wgmma m64n64, K = N, fp32 sums,
// into fp32 scratch [B, nc, 8, 128, 4] in the order of the wgmma
// accumulator (float4 q of thread tid at q*128 + tid), so a consumer reads
// it back coalesced into the same registers. With kTransposed the CTA also
// writes B.C^T (rows j, columns i) into a second block of the same shape
// ([B, nc, 2, 8, 128, 4]): the backward forms its products both ways.
template <int N, bool kTransposed>
__global__ void __launch_bounds__(kThreads)
ssd_cb_kernel(const __grid_constant__ CUtensorMap tb, const __grid_constant__ CUtensorMap tc,
              float* cb, int nc) {
  constexpr int kNB = N / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sC = base, sB = base + kNB * kBox, full = sB + kNB * kBox;
  const int c = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(full, 2 * kNB * kBox);
#pragma unroll
    for (int i = 0; i < kNB; ++i) {
      tma_load(sC + i * kBox, &tc, full, 64 * i, c * kQ, b);
      tma_load(sB + i * kBox, &tb, full, 64 * i, c * kQ, b);
    }
  }
  mbar_wait_or_trap(full, 0);
  __syncwarp();
  constexpr int kOut = kTransposed ? 2 : 1;
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    float d[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) d[i] = 0.f;
    const uint64_t da = sw128_desc(o ? sB : sC, 16, 1024), db = sw128_desc(o ? sC : sB, 16, 1024);
    fence_regs(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint32_t step = ((kk / 4) * kBox + (kk % 4) * 32) >> 4;
      wgmma_ss_n64(d, da + step, db + step, kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(d);
    float4* out = reinterpret_cast<float4*>(cb) +
                  (static_cast<size_t>(b * nc + c) * kOut + o) * 8 * kThreads + tid;
#pragma unroll
    for (int q = 0; q < 8; ++q)
      out[q * kThreads] = make_float4(d[4 * q], d[4 * q + 1], d[4 * q + 2], d[4 * q + 3]);
  }
}

template <int N> constexpr int cb_smem_bytes() { return 2 * (N / 64) * kBox + 16 + 1024; }

}  // namespace
}  // namespace repro_torch
