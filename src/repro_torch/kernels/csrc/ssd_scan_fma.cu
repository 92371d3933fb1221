// Mamba2 SSD (state-space duality) chunked scan, forward, for Hopper (sm_90a):
// the fp32-FMA kernel. It serves fp32 at every (hp, N) it is instantiated
// for, and bf16 where the wgmma kernel (ssd_scan.cu) does not: hp 16 or 32,
// or N 32 (kernels/ssd_scan.py:kernel_path). No model's bf16 path runs it;
// the fp32 gradient checks do, and timing code calls it (launch_fma).
// fp32 stays here because its gate (relative L2 1e-4 against the plain
// version) is out of reach of TF32 or bf16 tensor-core products.
//
// Replaces: src/repro/kernels/ssd_scan.py, _ssd_kernel / ssd_scan_pallas.
// Per (batch b, head h), with a = dt * A and h_t the [hp, N] state:
//   h_t = exp(a_t) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t.
// Computed chunk by chunk: inside a chunk in attention form,
//   y_i = sum_{j<=i} (C_i . B_j) exp(acs_i - acs_j) dt_j x_j + exp(acs_i) (h_prev C_i),
// with acs the cumulative sum of a from the chunk's start, then
//   h <- exp(acs_last) h + sum_j exp(acs_last - acs_j) dt_j x_j B_j^T.
// In exact arithmetic the result does not depend on the chunk length, so
// this kernel blocks by its own kQ = 64 tokens (the TPU kernel and the plain
// version use 256): the Q x Q scores, the x tile and the B/C tiles then fit
// shared memory beside the state.
//
// Bound on the H100: bytes. At mamba2-2.7b prefill (B 2, nh 80, S 2000,
// hp 64, N 128, bf16 x/y/B/C, fp32 dt) the kernel must move x and y
// (41 MB each), dt (1.3 MB) and B/C (2 MB): 85 MB, 0.025 ms at 3.35 TB/s.
// With C.B^T shared across heads the chunked work is ~21 GFLOP, 0.022 ms
// on the bf16 tensor cores. This first version computes everything in fp32
// FMAs, as the TPU kernel does, so it is bound by the fp32 rate (~17 GFLOP
// at its chunk of 64, 0.25 ms at 67 TFLOP/s) and by shared-memory traffic,
// far from the byte bound; its time is recorded, not optimised.
//
// Design:
//  * One 256-thread CTA per (h, b): 160 CTAs at the main shape. The TPU's
//    sequential chunk grid axis is a loop inside the CTA, because Hopper
//    runs blocks in no order; the fp32 state stays on chip across it, in
//    registers (each thread owns 4 columns p of a few rows n of h^T) with
//    a copy in shared memory for the C h^T product.
//  * Each chunk: stage x, B, C (converted to fp32) and dt in shared memory;
//    one warp scans a = dt * A; the Q x Q decayed scores go to shared
//    memory, masked BEFORE exp (above the diagonal acs_i - acs_j > 0 and
//    exp overflows; inf * 0 would be NaN); y = scores x + exp(acs) C h^T;
//    then the state update. Score blocks wholly above the diagonal are not
//    computed.
//  * No padding: rows at or past S are staged as x = B = C = 0, dt = 0,
//    which makes them no-ops in the recurrence, and are not stored.
//  * Strides are arguments: x and y may be [B,nh,S,hp] views of the model's
//    [B,S,nh,hp] tensors, B and C column slices of the conv output, and dt
//    a [B,nh,S] view of a [B,S,nh] tensor (read element by element).
//  * All arithmetic is fp32; bf16 inputs are widened as they are staged
//    and y is rounded once when stored.
#include <math.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kQ = 64;          // tokens per chunk
constexpr int kThreads = 256;

template <int HP, int N> struct SsdLayout {
  static constexpr int LDX = HP + 4;   // sX [kQ][LDX]: float4-aligned rows
  static constexpr int LDS = HP + 4;   // sSt [N][LDS]: the state, transposed
  static constexpr int LDN = N + 1;    // sB, sC [kQ][LDN]: odd, no bank conflicts
  static constexpr int LDP = kQ + 1;   // sP [kQ][LDP]: decayed scores
  static constexpr int kFloats = kQ * LDX + N * LDS + 2 * kQ * LDN + kQ * LDP + 4 * kQ;
  static constexpr int kBytes = kFloats * 4;
};

struct SsdParams {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  void* y;
  long long x_sb, x_sh, x_ss, dt_sb, dt_sh, dt_ss, b_sb, b_ss, c_sb, c_ss, y_sb, y_sh, y_ss;
  int S;
};

// Stage rows [0, kQ) of a [rows, W] slab (unit stride along W, rows 16-byte
// aligned) into fp32 shared memory; rows at or past nv become 0.
template <typename T, int W>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const T* src, long long stride,
                                           int nv) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = W / kVec;
  for (int i = threadIdx.x; i < kQ * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = i % kPerRow;
    float* d = dst + r * ld + c * kVec;
    if (r < nv) {
      const uint4 u = *reinterpret_cast<const uint4*>(src + r * stride + c * kVec);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int k = 0; k < kVec; ++k) d[k] = to_f32(e[k]);
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) d[k] = 0.f;
    }
  }
}

__device__ __forceinline__ void store4(float* dst, const float (&v)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float (&v)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

template <typename T, int HP, int N>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(const SsdParams p) {
  using L = SsdLayout<HP, N>;
  extern __shared__ __align__(16) float smem[];
  float* sX = smem;                   // [kQ][LDX]  x of the chunk
  float* sSt = sX + kQ * L::LDX;      // [N][LDS]   state entering the chunk, h^T
  float* sB = sSt + N * L::LDS;       // [kQ][LDN]
  float* sC = sB + kQ * L::LDN;       // [kQ][LDN]
  float* sP = sC + kQ * L::LDN;       // [kQ][LDP]  decayed scores, 0 above the diagonal
  float* sDt = sP + kQ * L::LDP;      // [kQ]
  float* sAcs = sDt + kQ;             // [kQ]  cumulative a from the chunk's start
  float* sW = sAcs + kQ;              // [kQ]  exp(acs_last - acs_j) dt_j
  float* sEa = sW + kQ;               // [kQ]  exp(acs_i)

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const float A = p.A[h];
  const T* xg = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh;
  const T* bg = static_cast<const T*>(p.Bm) + b * p.b_sb;
  const T* cg = static_cast<const T*>(p.Cm) + b * p.c_sb;
  T* yg = static_cast<T*>(p.y) + b * p.y_sb + h * p.y_sh;

  // y and state tiles: 4 columns p0..p0+3 per thread, rows strided by kRT
  constexpr int kPT = HP / 4;                  // threads across hp
  constexpr int kRT = kThreads / kPT;          // threads across rows
  constexpr int kYR = kQ / kRT;                // y rows per thread: 4, 2, 1
  constexpr int kSR = (N + kRT - 1) / kRT;     // state rows n per thread
  const int tp = tid % kPT, tr = tid / kPT;
  const int p0 = 4 * tp;
  // scores: a 16 x 16 thread grid, rows i = ti + 16 r, columns j = tj + 16 s
  const int ti = tid / 16, tj = tid % 16;

  float st[kSR][4];
#pragma unroll
  for (int s = 0; s < kSR; ++s) st[s][0] = st[s][1] = st[s][2] = st[s][3] = 0.f;
  for (int i = tid; i < N * L::LDS; i += kThreads) sSt[i] = 0.f;

  const int S = p.S;
  for (int r0 = 0; r0 < S; r0 += kQ) {
    const int nv = min(kQ, S - r0);

    // (1) stage the chunk
    stage_rows<T, HP>(sX, L::LDX, xg + r0 * p.x_ss, p.x_ss, nv);
    stage_rows<T, N>(sB, L::LDN, bg + r0 * p.b_ss, p.b_ss, nv);
    stage_rows<T, N>(sC, L::LDN, cg + r0 * p.c_ss, p.c_ss, nv);
    if (tid < kQ) sDt[tid] = tid < nv ? dtg[(r0 + tid) * p.dt_ss] : 0.f;
    __syncthreads();

    // (2) one warp: inclusive scan of a = dt * A, two rows per lane
    if (tid < 32) {
      const float a0 = sDt[2 * tid] * A, a1 = sDt[2 * tid + 1] * A;
      float incl = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += t;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
      const float c0 = excl + a0, c1 = c0 + a1;
      const float last = __shfl_sync(0xffffffffu, c1, 31);
      sAcs[2 * tid] = c0;
      sAcs[2 * tid + 1] = c1;
      sW[2 * tid] = expf(last - c0) * sDt[2 * tid];
      sW[2 * tid + 1] = expf(last - c1) * sDt[2 * tid + 1];
      sEa[2 * tid] = expf(c0);
      sEa[2 * tid + 1] = expf(c1);
    }
    __syncthreads();

    // (3) decayed scores. Block (r, s) with s > r lies wholly above the
    // diagonal (j >= 16 s > i), so only s <= r is computed.
    {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
#pragma unroll 4
      for (int k = 0; k < N; ++k) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          cv[r] = sC[(ti + 16 * r) * L::LDN + k];
          bv[r] = sB[(tj + 16 * r) * L::LDN + k];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s <= r; ++s) acc[r][s] = fmaf(cv[r], bv[s], acc[r][s]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int i = ti + 16 * r, j = tj + 16 * s;
          float v = 0.f;
          if (s <= r && j <= i) v = acc[r][s] * expf(sAcs[i] - sAcs[j]) * sDt[j];
          sP[i * L::LDP + j] = v;
        }
      }
    }
    __syncthreads();

    // (4) y = scores x + exp(acs) (C h^T), h the state entering the chunk
    {
      float acc[kYR][4], inter[kYR][4];
#pragma unroll
      for (int r = 0; r < kYR; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = inter[r][q] = 0.f;
#pragma unroll 4
      for (int j = 0; j < kQ; ++j) {
        const float4 xv = *reinterpret_cast<const float4*>(sX + j * L::LDX + p0);
#pragma unroll
        for (int r = 0; r < kYR; ++r) {
          const float pv = sP[(tr + kRT * r) * L::LDP + j];
          acc[r][0] = fmaf(pv, xv.x, acc[r][0]);
          acc[r][1] = fmaf(pv, xv.y, acc[r][1]);
          acc[r][2] = fmaf(pv, xv.z, acc[r][2]);
          acc[r][3] = fmaf(pv, xv.w, acc[r][3]);
        }
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float4 hv = *reinterpret_cast<const float4*>(sSt + n * L::LDS + p0);
#pragma unroll
        for (int r = 0; r < kYR; ++r) {
          const float cv = sC[(tr + kRT * r) * L::LDN + n];
          inter[r][0] = fmaf(cv, hv.x, inter[r][0]);
          inter[r][1] = fmaf(cv, hv.y, inter[r][1]);
          inter[r][2] = fmaf(cv, hv.z, inter[r][2]);
          inter[r][3] = fmaf(cv, hv.w, inter[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < kYR; ++r) {
        const int i = tr + kRT * r;
        if (i >= nv) continue;
        const float ea = sEa[i];
        float out[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) out[q] = fmaf(ea, inter[r][q], acc[r][q]);
        store4(yg + (r0 + i) * p.y_ss + p0, out);
      }
    }

    // (5) state update in registers: h <- exp(acs_last) h + sum_j w_j x_j B_j^T
    {
      const float decay = expf(sAcs[kQ - 1]);   // rows past nv have a = 0
#pragma unroll
      for (int s = 0; s < kSR; ++s)
#pragma unroll
        for (int q = 0; q < 4; ++q) st[s][q] *= decay;
#pragma unroll 4
      for (int j = 0; j < kQ; ++j) {
        const float4 xv = *reinterpret_cast<const float4*>(sX + j * L::LDX + p0);
        const float w = sW[j];
#pragma unroll
        for (int s = 0; s < kSR; ++s) {
          const int n = tr + kRT * s;
          if (N % kRT != 0 && n >= N) continue;
          const float bw = sB[j * L::LDN + n] * w;
          st[s][0] = fmaf(bw, xv.x, st[s][0]);
          st[s][1] = fmaf(bw, xv.y, st[s][1]);
          st[s][2] = fmaf(bw, xv.z, st[s][2]);
          st[s][3] = fmaf(bw, xv.w, st[s][3]);
        }
      }
    }
    __syncthreads();   // every thread is done reading sSt and the chunk's tiles
#pragma unroll
    for (int s = 0; s < kSR; ++s) {
      const int n = tr + kRT * s;
      if (N % kRT != 0 && n >= N) continue;
      store4(sSt + n * L::LDS + p0, st[s]);
    }
  }
}

template <typename T, int HP, int N>
int launch(const SsdParams& p, int B, int nh, cudaStream_t stream) {
  constexpr int bytes = SsdLayout<HP, N>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_kernel<T, HP, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_scan_kernel<T, HP, N><<<dim3(nh, B), kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HP>
int launch_n(const SsdParams& p, int B, int nh, int N, cudaStream_t stream) {
  switch (N) {
    case 16: return launch<T, HP, 16>(p, B, nh, stream);
    case 32: return launch<T, HP, 32>(p, B, nh, stream);
    case 64: return launch<T, HP, 64>(p, B, nh, stream);
    case 128: return launch<T, HP, 128>(p, B, nh, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_hp(const SsdParams& p, int B, int nh, int hp, int N, cudaStream_t stream) {
  switch (hp) {
    case 16: return launch_n<T, 16>(p, B, nh, N, stream);
    case 32: return launch_n<T, 32>(p, B, nh, N, stream);
    case 64: return launch_n<T, 64>(p, B, nh, N, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro_torch

// x, y: [B, nh, S, hp]; dt: [B, nh, S] fp32; A: [nh] fp32, contiguous;
// Bm, Cm: [B, S, N]. `strides` holds element strides, 13 values: x (batch,
// head, seq), dt (batch, head, seq), Bm (batch, seq), Cm (batch, seq),
// y (batch, head, seq); x, Bm, Cm and y have a unit last stride and
// 16-byte aligned rows. x, Bm, Cm and y share `dtype`. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int ssd_scan_fma_launch(const void* x, const float* dt, const float* A, const void* Bm,
                                   const void* Cm, void* y, const long long* strides, int B,
                                   int nh, int S, int hp, int N, int dtype, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || nh <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  SsdParams p;
  p.x = x;
  p.dt = dt;
  p.A = A;
  p.Bm = Bm;
  p.Cm = Cm;
  p.y = y;
  p.x_sb = strides[0]; p.x_sh = strides[1]; p.x_ss = strides[2];
  p.dt_sb = strides[3]; p.dt_sh = strides[4]; p.dt_ss = strides[5];
  p.b_sb = strides[6]; p.b_ss = strides[7];
  p.c_sb = strides[8]; p.c_ss = strides[9];
  p.y_sb = strides[10]; p.y_sh = strides[11]; p.y_ss = strides[12];
  p.S = S;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_hp<float>(p, B, nh, hp, N, s);
  if (dtype == kBFloat16) return launch_hp<__nv_bfloat16>(p, B, nh, hp, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
