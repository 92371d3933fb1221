// Pieces shared by the wgmma SSD kernels, forward (ssd_scan.cu) and
// backward (ssd_scan_bwd_wgmma.cu): the chunk geometry, bf16 pair helpers,
// the per-chunk cumulative decay, C.B^T of each 64-token chunk, which
// does not depend on the head and is computed once per (b, chunk) for all
// of them, and the N 16 tile path (B and C by plain loads, transposed).
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

// The A operand (s o tile)^T, [64 rows p][16 tokens] per k step, as a bf16
// pair: the swizzled [64 tokens][64] tile by ldmatrix.trans (lane: matrix
// lane/8, its row lane%8), each element scaled by its token's s in fp32.
__device__ __forceinline__ void scaled_t_fragments(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4],
                                                   uint32_t sTile, const float* s, int warp,
                                                   int lane) {
  const int m = lane / 8, rr = lane % 8, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int j = 16 * kk + 8 * (m / 2) + rr;
    const int chunk16 = 2 * warp + (m % 2);
    uint32_t r[4];
    ldmatrix_x4_trans(r, sTile + j * 128 + ((chunk16 ^ rr) * 16));
    const float2 s01 = *reinterpret_cast<const float2*>(s + 16 * kk + 2 * t);
    const float2 s23 = *reinterpret_cast<const float2*>(s + 16 * kk + 8 + 2 * t);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r[k]));
      const float2 sc = k < 2 ? s01 : s23;
      split_bf16x2(f.x * sc.x, f.y * sc.y, hi[kk][k], lo[kk][k]);
    }
  }
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

// ---- N 16 (hymba-1.5b): B and C tiles by the threads' loads, transposed ----
// A row of a [64 tokens][16] B or C tile is 32 bytes, under the 128-byte
// swizzle span of the TMA maps and wgmma descriptors. Those tiles come in
// by one 16-byte load a thread (load_tile16, a chunk ahead in registers)
// and are stored transposed, [16 state rows][64 token columns] in one
// swizzled 2 KB box (store_tile16): the K-major B operand of products over
// the chunk's tokens, and the MN-major A operand (K = N) of products over
// the state. [hp][N] state images are stored [N][hp] likewise.

// bytes of an N-wide tile of B or C ([64 tokens][N]) and of one bf16 plane of
// a [hp][N] state image: N / 64 boxes at N >= 64, one box at N 16
template <int N> constexpr int kTileBytes = kQ * N * 2;

// byte offset of (row, n) in an N-wide tile (row a token) or a state image
// (row a head-dim index): rows of N at N >= 64, transposed at N 16
template <int N> __device__ __forceinline__ uint32_t tile_offset(int row, int n) {
  return N == 16 ? sw128_offset(n, row, kBox) : sw128_offset(row, n, kBox);
}

// elements (row, n) and (row, n + 1), n even, of such a tile
template <int N>
__device__ __forceinline__ float2 ld_pair(const unsigned char* tile, int row, int n) {
  if constexpr (N == 16) {
    return make_float2(
        __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(tile + tile_offset<N>(row, n))),
        __bfloat162float(
            *reinterpret_cast<const __nv_bfloat16*>(tile + tile_offset<N>(row, n + 1))));
  } else {
    return __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(tile + tile_offset<N>(row, n)));
  }
}

template <int N>
__device__ __forceinline__ void st_pair(unsigned char* tile, int row, int n, uint32_t v) {
  if constexpr (N == 16) {
    *reinterpret_cast<uint16_t*>(tile + tile_offset<N>(row, n)) = static_cast<uint16_t>(v);
    *reinterpret_cast<uint16_t*>(tile + tile_offset<N>(row, n + 1)) =
        static_cast<uint16_t>(v >> 16);
  } else {
    *reinterpret_cast<uint32_t*>(tile + tile_offset<N>(row, n)) = v;
  }
}

// N 16: the thread's half-row (8 states of token tid / 2) of chunk c's tile
// of B or C at `base` (row stride ss), zeros at or past S
__device__ __forceinline__ uint4 load_tile16(const __nv_bfloat16* base, long long ss, int c,
                                             int S, int tid) {
  const int tok = c * kQ + tid / 2;
  if (tok >= S) return make_uint4(0u, 0u, 0u, 0u);
  return __ldg(reinterpret_cast<const uint4*>(base + tok * ss + 8 * (tid % 2)));
}

// ... into the transposed box at `img` (generic address, 1024-byte aligned),
// ordered before later wgmma reads of it
__device__ __forceinline__ void store_tile16(unsigned char* img, uint4 v, int tid) {
  const int j = tid / 2, n0 = 8 * (tid % 2);
  const uint16_t* e = reinterpret_cast<const uint16_t*>(&v);
#pragma unroll
  for (int k = 0; k < 8; ++k)
    *reinterpret_cast<uint16_t*>(img + sw128_offset(n0 + k, j, kBox)) = e[k];
  fence_async_smem();
}

// ssd_cb_kernel at N 16, grid (chunk, b): the tiles by plain loads into the
// transposed boxes, then one m64n64k16 with both operands MN-major, into
// the same scratch layout ([B, nc, 8, 128, 4]; with kTransposed B.C^T too,
// [B, nc, 2, 8, 128, 4]). Bm, Cm: [B, S, 16] with unit last stride, element
// strides (batch, seq).
template <bool kTransposed>
__global__ void __launch_bounds__(kThreads)
ssd_cb16_kernel(const __nv_bfloat16* Bm, long long b_sb, long long b_ss, const __nv_bfloat16* Cm,
                long long c_sb, long long c_ss, float* cb, int S, int nc) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_addr(smem_raw));
  const int c = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  store_tile16(gbase, load_tile16(Cm + b * c_sb, c_ss, c, S, tid), tid);
  store_tile16(gbase + kTileBytes<16>, load_tile16(Bm + b * b_sb, b_ss, c, S, tid), tid);
  __syncthreads();
  const uint64_t dc = sw128_desc(base, kBox, 1024);
  const uint64_t db = sw128_desc(base + kTileBytes<16>, kBox, 1024);
  constexpr int kOut = kTransposed ? 2 : 1;
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    float d[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) d[i] = 0.f;
    fence_regs(d);
    wgmma_fence();
    wgmma_ss_mn_n64(d, o ? db : dc, o ? dc : db, 0);
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

constexpr int kCb16Smem = 2 * kTileBytes<16> + 1024;

}  // namespace
}  // namespace repro_torch
