// Mamba2 SSD (state-space duality) chunked scan, backward, for Hopper
// (sm_90a): dx, ddt, dA, dB, dC and the gradient of the initial state from
// dy (and the gradient of the final state, when the forward returned it).
// It serves every (hp, N) the forward kernels take, fp32 and bf16, with
// fp32 dt and A (kernels/ssd_scan.py:bwd_kernel_path).
//
// Replaces: the backward of src/repro/kernels/ssd_scan.py, _ssd_kernel /
// ssd_scan_pallas (forward-only on the TPU; the JAX package differentiates
// repro.models.layers.ssd_scan with autograd). Its math is
// kernels/ref.py:ssd_scan_bwd_ref at a chunk of kQ = 64 tokens. Per (b, h)
// and chunk, with a_j = dt_j A, acs the cumulative a from the chunk's
// start, L_ij = exp(acs_i - acs_j) for j <= i, w_j = exp(acs_last - acs_j)
// dt_j, h_c the [hp, N] state entering the chunk and dh the gradient of the
// state leaving it:
//   dh_c = exp(acs_last) dh + sum_i exp(acs_i) dy_i C_i^T
//   dx_j = dt_j sum_i (C_i.B_j) L_ij dy_i + w_j dh B_j
//   dC_i = sum_h [sum_j (dy_i.x_j) L_ij dt_j B_j + exp(acs_i) h_c^T dy_i]
//   dB_j = sum_h [sum_i (dy_i.x_j) L_ij dt_j C_i + w_j dh^T x_j]
//   d a_m = sum_{i >= m > j} P_ij + sum_{k >= m} exp(acs_k) C_k.(h_c^T dy_k)
//           + sum_{j < m} w_j B_j.(dh^T x_j) + exp(acs_last) <dh, h_c>,
//   with P_ij = (dy_i.x_j)(C_i.B_j) L_ij dt_j; ddt_j = sum_i P_ij / dt_j
//   + exp(acs_last - acs_j) B_j.(dh^T x_j) + A d a_j; dA = sum dt_j d a_j.
// d a is summed where each term lands (the pairs that straddle m), not as
// a reverse cumsum of d acs: that cancels the row and column sums of P and
// loses about a decimal digit of dA.
//
// Bound on the H100: bytes. At mamba2-2.7b training (B 1, nh 80, S 2048,
// hp 64, N 128, bf16) the function reads x, dy (21 MB each), dt, B, C and
// writes dx, ddt, dB, dC: ~65 MB, ~19.5 us at 3.35 TB/s. Its products (the
// in-chunk ones at half the Q x Q pairs, the state ones per token) are
// ~17.5 GFLOP, ~18 us on the bf16 tensor cores. This first version is
// simple and right, not fast: every product is fp32 FMAs out of shared
// memory, as in the FMA forward, so it is bound by the fp32 rate and by
// shared-memory traffic, and it writes fp32 scratch (the entering states,
// their gradients, per-head dB/dC partials: 4 x 84 MB at that shape).
//
// Design, four launches on the caller's stream, no atomics, every sum in a
// fixed order (the same bits on every call):
//  (a) ssd_bwd_states, grid (h, b): walk the chunks forward and write the
//      state entering each one, [B,nh,nc,hp,N] fp32, from initial_state or
//      zeros (the wgmma forward keeps only segment end states, so they are
//      recomputed here). Each thread owns 4 columns n of a few rows p.
//  (b) ssd_bwd_dstates, grid (h, b): walk the chunks backward and write the
//      gradient of the state leaving each one (the last from d_final or
//      zeros), then d_initial.
//  (c) ssd_bwd_chunk, grid (chunk, h, b): given h_c and dh, the in-chunk
//      gradients: C.B^T and dy.x^T on a 16 x 16 thread grid (blocks wholly
//      above the diagonal skipped; masked before exp), then dC (with h_c in
//      shared memory as [p][n]), dB (dh as [p][n]), dx (dh again as [n][p]),
//      each with 4 contiguous columns a thread; dx rounded once, ddt and the
//      chunk's dA term in fp32, dB and dC as per-head fp32 partials.
//  (d) ssd_bwd_sum_bc sums the dB and dC partials over the heads in head
//      order and rounds them once; ssd_bwd_sum_da sums dA over (b, chunk).
// Rows at or past S are staged as x = dy = B = C = 0, dt = 0: no-ops in
// the recurrence and zero in every sum. Strides are arguments, as in the
// forward: x, dy and dx may be [B,nh,S,hp] views of [B,S,nh,hp] tensors,
// B and C column slices of the conv output, dt and ddt [B,nh,S] views of
// [B,S,nh] tensors.
#include <math.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kQ = 64;          // tokens per chunk
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

struct BwdParams {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const void* dy;
  const float* init;      // [B,nh,hp,N] or null (zeros)
  const float* dfinal;    // [B,nh,hp,N] or null (zeros)
  float* states;          // [B,nh,nc,hp,N] scratch: state entering each chunk
  float* dstates;         // [B,nh,nc,hp,N] scratch: gradient of the state leaving it
  float* dBp;             // [B,nh,S,N] scratch: dB of each head
  float* dCp;             // [B,nh,S,N] scratch: dC of each head
  float* dAp;             // [B,nh,nc] scratch: dA of each chunk
  void* dx;
  float* ddt;
  float* dA;              // [nh]
  void* dBm;              // [B,S,N] dense
  void* dCm;              // [B,S,N] dense
  float* dinit;           // [B,nh,hp,N] or null
  long long x_sb, x_sh, x_ss, dt_sb, dt_sh, dt_ss, b_sb, b_ss, c_sb, c_ss, dy_sb, dy_sh, dy_ss,
      dx_sb, dx_sh, dx_ss, ddt_sb, ddt_sh, ddt_ss;
  int B, nh, S, nc;
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

// Warp 0: sAcs[i] = sum_{m <= i} dt_m A over the chunk, two rows a lane.
__device__ __forceinline__ void chunk_cumsum(const float* sDt, float A, float* sAcs) {
  const int l = threadIdx.x;
  const float a0 = sDt[2 * l] * A, a1 = sDt[2 * l + 1] * A;
  float incl = a0 + a1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(kFull, incl, off);
    if (l >= off) incl += t;
  }
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (l == 0) excl = 0.f;
  sAcs[2 * l] = excl + a0;
  sAcs[2 * l + 1] = excl + a0 + a1;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void fma4(float (&acc)[4], float s, const float4& v) {
  acc[0] = fmaf(s, v.x, acc[0]);
  acc[1] = fmaf(s, v.y, acc[1]);
  acc[2] = fmaf(s, v.z, acc[2]);
  acc[3] = fmaf(s, v.w, acc[3]);
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

// The state walks, (a) and (b): each thread owns columns n0..n0+3 of rows
// p = tr + kRT s of a [hp, N] state; threads past hp (small hp, small N)
// own nothing.
template <int HP, int N> struct StateMap {
  static constexpr int kNT = N / 4;                  // threads across n
  static constexpr int kRT = kThreads / kNT;         // threads across p
  static constexpr int kSR = (HP + kRT - 1) / kRT;   // rows p a thread
  static constexpr int LDX = HP + 4;                 // [kQ][LDX] x or dy
  static constexpr int LDN = N + 4;                  // [kQ][LDN] B or C: float4 rows
  static constexpr int kBytes = (kQ * LDX + kQ * LDN + 3 * kQ) * 4;
};

// (a) the state entering each chunk
template <typename T, int HP, int N>
__global__ void __launch_bounds__(kThreads) ssd_bwd_states(const BwdParams p) {
  using M = StateMap<HP, N>;
  extern __shared__ __align__(16) float smem[];
  float* sX = smem;                    // [kQ][LDX]
  float* sB = sX + kQ * M::LDX;        // [kQ][LDN]
  float* sDt = sB + kQ * M::LDN;       // [kQ]
  float* sAcs = sDt + kQ;              // [kQ]
  float* sW = sAcs + kQ;               // [kQ] exp(acs_last - acs_j) dt_j

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const float A = p.A[h];
  const long long hn = static_cast<long long>(HP) * N;
  const long long bh = static_cast<long long>(b) * p.nh + h;
  const T* xg = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh;
  const T* bg = static_cast<const T*>(p.Bm) + b * p.b_sb;
  float* out = p.states + bh * p.nc * hn;
  const int tn = tid % M::kNT, tr = tid / M::kNT, n0 = 4 * tn;

  float st[M::kSR][4];
#pragma unroll
  for (int s = 0; s < M::kSR; ++s) {
    const int pp = tr + M::kRT * s;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p.init != nullptr && pp < HP) v = ld4(p.init + bh * hn + pp * N + n0);
    st[s][0] = v.x; st[s][1] = v.y; st[s][2] = v.z; st[s][3] = v.w;
  }
  for (int c = 0; c < p.nc; ++c) {
#pragma unroll
    for (int s = 0; s < M::kSR; ++s) {
      const int pp = tr + M::kRT * s;
      if (pp < HP) store4(out + c * hn + pp * N + n0, st[s]);
    }
    if (c == p.nc - 1) break;
    const int r0 = c * kQ, nv = min(kQ, p.S - r0);
    stage_rows<T, HP>(sX, M::LDX, xg + r0 * p.x_ss, p.x_ss, nv);
    stage_rows<T, N>(sB, M::LDN, bg + r0 * p.b_ss, p.b_ss, nv);
    if (tid < kQ) sDt[tid] = tid < nv ? dtg[(r0 + tid) * p.dt_ss] : 0.f;
    __syncthreads();
    if (tid < 32) chunk_cumsum(sDt, A, sAcs);
    __syncthreads();
    if (tid < kQ) sW[tid] = expf(sAcs[kQ - 1] - sAcs[tid]) * sDt[tid];
    __syncthreads();
    const float decay = expf(sAcs[kQ - 1]);   // rows past nv have a = 0
#pragma unroll
    for (int s = 0; s < M::kSR; ++s)
#pragma unroll
      for (int q = 0; q < 4; ++q) st[s][q] *= decay;
#pragma unroll 4
    for (int j = 0; j < kQ; ++j) {
      const float4 bv = ld4(sB + j * M::LDN + n0);
      const float w = sW[j];
#pragma unroll
      for (int s = 0; s < M::kSR; ++s) {
        const int pp = tr + M::kRT * s;
        if (pp < HP) fma4(st[s], sX[j * M::LDX + pp] * w, bv);
      }
    }
    __syncthreads();   // every thread is done with the chunk's tiles
  }
}

// (b) the gradient of the state leaving each chunk, then d_initial
template <typename T, int HP, int N>
__global__ void __launch_bounds__(kThreads) ssd_bwd_dstates(const BwdParams p) {
  using M = StateMap<HP, N>;
  extern __shared__ __align__(16) float smem[];
  float* sDY = smem;                   // [kQ][LDX]
  float* sC = sDY + kQ * M::LDX;       // [kQ][LDN]
  float* sDt = sC + kQ * M::LDN;       // [kQ]
  float* sAcs = sDt + kQ;              // [kQ]
  float* sEa = sAcs + kQ;              // [kQ] exp(acs_i)

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const float A = p.A[h];
  const long long hn = static_cast<long long>(HP) * N;
  const long long bh = static_cast<long long>(b) * p.nh + h;
  const T* dyg = static_cast<const T*>(p.dy) + b * p.dy_sb + h * p.dy_sh;
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh;
  const T* cg = static_cast<const T*>(p.Cm) + b * p.c_sb;
  float* out = p.dstates + bh * p.nc * hn;
  const int tn = tid % M::kNT, tr = tid / M::kNT, n0 = 4 * tn;

  float st[M::kSR][4];
#pragma unroll
  for (int s = 0; s < M::kSR; ++s) {
    const int pp = tr + M::kRT * s;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p.dfinal != nullptr && pp < HP) v = ld4(p.dfinal + bh * hn + pp * N + n0);
    st[s][0] = v.x; st[s][1] = v.y; st[s][2] = v.z; st[s][3] = v.w;
  }
  for (int c = p.nc - 1; c >= 0; --c) {
#pragma unroll
    for (int s = 0; s < M::kSR; ++s) {
      const int pp = tr + M::kRT * s;
      if (pp < HP) store4(out + c * hn + pp * N + n0, st[s]);
    }
    const int r0 = c * kQ, nv = min(kQ, p.S - r0);
    stage_rows<T, HP>(sDY, M::LDX, dyg + r0 * p.dy_ss, p.dy_ss, nv);
    stage_rows<T, N>(sC, M::LDN, cg + r0 * p.c_ss, p.c_ss, nv);
    if (tid < kQ) sDt[tid] = tid < nv ? dtg[(r0 + tid) * p.dt_ss] : 0.f;
    __syncthreads();
    if (tid < 32) chunk_cumsum(sDt, A, sAcs);
    __syncthreads();
    if (tid < kQ) sEa[tid] = expf(sAcs[tid]);
    __syncthreads();
    const float decay = expf(sAcs[kQ - 1]);
#pragma unroll
    for (int s = 0; s < M::kSR; ++s)
#pragma unroll
      for (int q = 0; q < 4; ++q) st[s][q] *= decay;
#pragma unroll 4
    for (int i = 0; i < kQ; ++i) {
      const float4 cv = ld4(sC + i * M::LDN + n0);
      const float e = sEa[i];
#pragma unroll
      for (int s = 0; s < M::kSR; ++s) {
        const int pp = tr + M::kRT * s;
        if (pp < HP) fma4(st[s], sDY[i * M::LDX + pp] * e, cv);
      }
    }
    __syncthreads();
  }
  if (p.dinit != nullptr) {
#pragma unroll
    for (int s = 0; s < M::kSR; ++s) {
      const int pp = tr + M::kRT * s;
      if (pp < HP) store4(p.dinit + bh * hn + pp * N + n0, st[s]);
    }
  }
}

template <int HP, int N> struct ChunkLayout {
  static constexpr int LDX = HP + 4;     // sX, sDY [kQ][LDX]
  static constexpr int LDN = N + 4;      // sB, sC [kQ][LDN]
  static constexpr int LDP = kQ + 1;     // sS1, sT, sE [kQ][LDP]
  static constexpr int LDH = N + 4;      // sH as [hp][LDH]: h_c, then dh
  static constexpr int LDS = HP + 4;     // sH as [N][LDS]: dh transposed
  static constexpr int kH = HP * LDH > N * LDS ? HP * LDH : N * LDS;
  static constexpr int kFloats = 2 * kQ * LDX + 2 * kQ * LDN + kH + 3 * kQ * LDP + 10 * kQ + 32;
  static constexpr int kBytes = kFloats * 4;
};

// (c) the in-chunk gradients of one (chunk, head, batch)
template <typename T, int HP, int N>
__global__ void __launch_bounds__(kThreads) ssd_bwd_chunk(const BwdParams p) {
  using L = ChunkLayout<HP, N>;
  extern __shared__ __align__(16) float smem[];
  float* sX = smem;                    // [kQ][LDX]
  float* sDY = sX + kQ * L::LDX;       // [kQ][LDX]
  float* sB = sDY + kQ * L::LDX;       // [kQ][LDN]
  float* sC = sB + kQ * L::LDN;        // [kQ][LDN]
  float* sH = sC + kQ * L::LDN;        // h_c or dh
  float* sS1 = sH + L::kH;             // [kQ][LDP] (C_i.B_j) L_ij dt_j     (dx)
  float* sT = sS1 + kQ * L::LDP;       // [kQ][LDP] (dy_i.x_j) L_ij dt_j    (dB, dC)
  float* sE = sT + kQ * L::LDP;        // [kQ][LDP] (dy_i.x_j)(C_i.B_j) L_ij (ddt, da)
  float* sDt = sE + kQ * L::LDP;       // [kQ]
  float* sAcs = sDt + kQ;              // [kQ]
  float* sEa = sAcs + kQ;              // [kQ] exp(acs_i)
  float* sEl = sEa + kQ;               // [kQ] exp(acs_last - acs_j)
  float* sW = sEl + kQ;                // [kQ] w_j
  float* sQ = sW + kQ;                 // [kQ] exp(acs_i) C_i.(h_c^T dy_i)
  float* sBV = sQ + kQ;                // [kQ] B_j.(dh^T x_j)
  float* sCol = sBV + kQ;              // [kQ] sum_i E_ij
  float* sStr = sCol + kQ;             // [kQ] sum_{i >= m > j} E_ij dt_j, then dt_m d a_m
  float* sDa = sStr + kQ;              // [kQ] d a_m
  float* sRed = sDa + kQ;              // [kThreads / 32] <dh, h_c> by warp

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int r0 = c * kQ, nv = min(kQ, p.S - r0);
  const float A = p.A[h];
  const long long hn = static_cast<long long>(HP) * N;
  const long long bh = static_cast<long long>(b) * p.nh + h;
  const T* xg = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh + r0 * p.x_ss;
  const T* dyg = static_cast<const T*>(p.dy) + b * p.dy_sb + h * p.dy_sh + r0 * p.dy_ss;
  const T* bg = static_cast<const T*>(p.Bm) + b * p.b_sb + r0 * p.b_ss;
  const T* cg = static_cast<const T*>(p.Cm) + b * p.c_sb + r0 * p.c_ss;
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh + r0 * p.dt_ss;
  const float* hc = p.states + (bh * p.nc + c) * hn;
  const float* dhc = p.dstates + (bh * p.nc + c) * hn;
  constexpr int kN4 = N / 4;

  // (1) stage the chunk and h_c ([p][n])
  stage_rows<T, HP>(sX, L::LDX, xg, p.x_ss, nv);
  stage_rows<T, HP>(sDY, L::LDX, dyg, p.dy_ss, nv);
  stage_rows<T, N>(sB, L::LDN, bg, p.b_ss, nv);
  stage_rows<T, N>(sC, L::LDN, cg, p.c_ss, nv);
  if (tid < kQ) sDt[tid] = tid < nv ? dtg[tid * p.dt_ss] : 0.f;
  for (int i = tid; i < HP * kN4; i += kThreads) {
    const int pp = i / kN4, n4 = i % kN4;
    *reinterpret_cast<float4*>(sH + pp * L::LDH + 4 * n4) = ld4(hc + pp * N + 4 * n4);
  }
  __syncthreads();
  if (tid < 32) chunk_cumsum(sDt, A, sAcs);
  __syncthreads();
  if (tid < kQ) {
    const float a = sAcs[tid], el = expf(sAcs[kQ - 1] - a);
    sEa[tid] = expf(a);
    sEl[tid] = el;
    sW[tid] = el * sDt[tid];
  }

  // (2) C.B^T and dy.x^T on a 16 x 16 thread grid, rows i = ti + 16 r,
  // columns j = tj + 16 s; block (r, s) with s > r lies wholly above the
  // diagonal and is 0. Masked before exp (acs_i - acs_j > 0 above it).
  {
    const int ti = tid / 16, tj = tid % 16;
    float cb[4][4], g[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) cb[r][s] = g[r][s] = 0.f;
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
        for (int s = 0; s <= r; ++s) cb[r][s] = fmaf(cv[r], bv[s], cb[r][s]);
    }
#pragma unroll 4
    for (int k = 0; k < HP; ++k) {
      float dv[4], xv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        dv[r] = sDY[(ti + 16 * r) * L::LDX + k];
        xv[r] = sX[(tj + 16 * r) * L::LDX + k];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s <= r; ++s) g[r][s] = fmaf(dv[r], xv[s], g[r][s]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int i = ti + 16 * r, j = tj + 16 * s;
        float s1 = 0.f, t = 0.f, e = 0.f;
        if (s <= r && j <= i) {
          const float l = expf(sAcs[i] - sAcs[j]);
          const float ldt = l * sDt[j];
          s1 = cb[r][s] * ldt;
          t = g[r][s] * ldt;
          e = g[r][s] * (cb[r][s] * l);
        }
        sS1[i * L::LDP + j] = s1;
        sT[i * L::LDP + j] = t;
        sE[i * L::LDP + j] = e;
      }
    }
  }
  __syncthreads();

  // [kQ][N] outputs: columns n0..n0+3 a thread, rows trn + kRN r
  constexpr int kNT = N / 4, kRN = kThreads / kNT, kRows = kQ / kRN;
  const int tn = tid % kNT, trn = tid / kNT, n0 = 4 * tn;

  // (3) dC_i = sum_j T_ij B_j + exp(acs_i) u_i, u_i = h_c^T dy_i; and
  // Q_i = exp(acs_i) C_i.u_i (summed over the kNT lanes of a row)
  {
    float acc[kRows][4], u[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = u[r][q] = 0.f;
#pragma unroll 4
    for (int j = 0; j < kQ; ++j) {
      const float4 bv = ld4(sB + j * L::LDN + n0);
#pragma unroll
      for (int r = 0; r < kRows; ++r) fma4(acc[r], sT[(trn + kRN * r) * L::LDP + j], bv);
    }
#pragma unroll 4
    for (int pp = 0; pp < HP; ++pp) {
      const float4 hv = ld4(sH + pp * L::LDH + n0);
#pragma unroll
      for (int r = 0; r < kRows; ++r) fma4(u[r], sDY[(trn + kRN * r) * L::LDX + pp], hv);
    }
    float* dcp = p.dCp + (bh * p.S + r0) * N;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = trn + kRN * r;
      const float ea = sEa[i];
      const float4 cv = ld4(sC + i * L::LDN + n0);
      float qp = cv.x * u[r][0] + cv.y * u[r][1] + cv.z * u[r][2] + cv.w * u[r][3];
#pragma unroll
      for (int off = kNT / 2; off > 0; off >>= 1) qp += __shfl_xor_sync(kFull, qp, off);
      if (tn == 0) sQ[i] = ea * qp;
      if (i < nv) {
        float out[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) out[q] = fmaf(ea, u[r][q], acc[r][q]);
        store4(dcp + i * N + n0, out);
      }
    }
  }
  __syncthreads();   // done with h_c

  // (4) dh into sH ([p][n]), with <dh, h_c> by warp
  {
    float dot = 0.f;
    for (int i = tid; i < HP * kN4; i += kThreads) {
      const int pp = i / kN4, n4 = i % kN4;
      float* sp = sH + pp * L::LDH + 4 * n4;
      const float4 hv = ld4(sp), dv = ld4(dhc + pp * N + 4 * n4);
      dot = fmaf(hv.x, dv.x, dot);
      dot = fmaf(hv.y, dv.y, dot);
      dot = fmaf(hv.z, dv.z, dot);
      dot = fmaf(hv.w, dv.w, dot);
      *reinterpret_cast<float4*>(sp) = dv;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(kFull, dot, off);
    if (tid % 32 == 0) sRed[tid / 32] = dot;
  }
  __syncthreads();

  // (5) dB_j = sum_i T_ij C_i + w_j v_j, v_j = dh^T x_j; and B_j.v_j
  {
    float acc[kRows][4], v[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = v[r][q] = 0.f;
#pragma unroll 4
    for (int i = 0; i < kQ; ++i) {
      const float4 cv = ld4(sC + i * L::LDN + n0);
#pragma unroll
      for (int r = 0; r < kRows; ++r) fma4(acc[r], sT[i * L::LDP + trn + kRN * r], cv);
    }
#pragma unroll 4
    for (int pp = 0; pp < HP; ++pp) {
      const float4 hv = ld4(sH + pp * L::LDH + n0);
#pragma unroll
      for (int r = 0; r < kRows; ++r) fma4(v[r], sX[(trn + kRN * r) * L::LDX + pp], hv);
    }
    float* dbp = p.dBp + (bh * p.S + r0) * N;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int j = trn + kRN * r;
      const float w = sW[j];
      const float4 bv = ld4(sB + j * L::LDN + n0);
      float bp = bv.x * v[r][0] + bv.y * v[r][1] + bv.z * v[r][2] + bv.w * v[r][3];
#pragma unroll
      for (int off = kNT / 2; off > 0; off >>= 1) bp += __shfl_xor_sync(kFull, bp, off);
      if (tn == 0) sBV[j] = bp;
      if (j < nv) {
        float out[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) out[q] = fmaf(w, v[r][q], acc[r][q]);
        store4(dbp + j * N + n0, out);
      }
    }
  }
  __syncthreads();   // done with dh as [p][n]

  // (6) dh into sH as [n][p]
  for (int i = tid; i < HP * kN4; i += kThreads) {
    const int pp = i / kN4, n4 = i % kN4;
    const float4 dv = ld4(dhc + pp * N + 4 * n4);
    sH[(4 * n4 + 0) * L::LDS + pp] = dv.x;
    sH[(4 * n4 + 1) * L::LDS + pp] = dv.y;
    sH[(4 * n4 + 2) * L::LDS + pp] = dv.z;
    sH[(4 * n4 + 3) * L::LDS + pp] = dv.w;
  }
  __syncthreads();

  // (7) dx_j = sum_i S1_ij dy_i + w_j dh B_j: columns p0..p0+3 a thread
  {
    constexpr int kPT = HP / 4, kRT = kThreads / kPT, kYR = kQ / kRT;
    const int tp = tid % kPT, tr = tid / kPT, p0 = 4 * tp;
    float acc[kYR][4], st[kYR][4];
#pragma unroll
    for (int r = 0; r < kYR; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = st[r][q] = 0.f;
#pragma unroll 4
    for (int i = 0; i < kQ; ++i) {
      const float4 dv = ld4(sDY + i * L::LDX + p0);
#pragma unroll
      for (int r = 0; r < kYR; ++r) fma4(acc[r], sS1[i * L::LDP + tr + kRT * r], dv);
    }
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      const float4 hv = ld4(sH + n * L::LDS + p0);
#pragma unroll
      for (int r = 0; r < kYR; ++r) fma4(st[r], sB[(tr + kRT * r) * L::LDN + n], hv);
    }
    T* dxg = static_cast<T*>(p.dx) + b * p.dx_sb + h * p.dx_sh + r0 * p.dx_ss;
#pragma unroll
    for (int r = 0; r < kYR; ++r) {
      const int j = tr + kRT * r;
      if (j >= nv) continue;
      const float w = sW[j];
      float out[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) out[q] = fmaf(w, st[r][q], acc[r][q]);
      store4(dxg + j * p.dx_ss + p0, out);
    }
  }

  // (8) ddt and d a. Column sums of E, then each row of E dt replaced by
  // its exclusive prefix sum, then the straddle sums down each column.
  if (tid < kQ) {
    float s = 0.f;
    for (int i = 0; i < kQ; ++i) s += sE[i * L::LDP + tid];
    sCol[tid] = s;
  }
  __syncthreads();
  if (tid < kQ) {
    float run = 0.f;
    for (int j = 0; j < kQ; ++j) {
      const float v = sE[tid * L::LDP + j] * sDt[j];
      sE[tid * L::LDP + j] = run;   // sum_{j' < j} E_{i j'} dt_j'
      run += v;
    }
  }
  __syncthreads();
  if (tid < kQ) {
    float s = 0.f;
    for (int i = tid; i < kQ; ++i) s += sE[i * L::LDP + tid];
    sStr[tid] = s;
  }
  __syncthreads();
  if (tid == 0) {
    float dot = 0.f;
    for (int k = 0; k < kThreads / 32; ++k) dot += sRed[k];
    const float last = expf(sAcs[kQ - 1]) * dot;
    float suf = 0.f;
    for (int m = kQ - 1; m >= 0; --m) {
      suf += sQ[m];
      sDa[m] = suf;
    }
    float pre = 0.f;
    for (int m = 0; m < kQ; ++m) {
      sDa[m] += sStr[m] + pre + last;
      pre = fmaf(sW[m], sBV[m], pre);
    }
  }
  __syncthreads();
  if (tid < kQ) {
    const float da = sDa[tid];
    if (tid < nv)
      p.ddt[b * p.ddt_sb + h * p.ddt_sh + (r0 + tid) * p.ddt_ss] =
          sCol[tid] + sEl[tid] * sBV[tid] + A * da;
    sStr[tid] = sDt[tid] * da;
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int m = 0; m < kQ; ++m) s += sStr[m];
    p.dAp[bh * p.nc + c] = s;
  }
}

// (d) dB and dC: the per-head partials summed in head order, rounded once
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_sum_bc(const BwdParams p, int N) {
  const long long SN = static_cast<long long>(p.S) * N;
  const long long e = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * 4;
  if (e >= p.B * SN) return;
  const float* part = blockIdx.y ? p.dCp : p.dBp;
  T* out = static_cast<T*>(blockIdx.y ? p.dCm : p.dBm);
  const long long b = e / SN, rem = e % SN;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int h = 0; h < p.nh; ++h) {
    const float4 v = ld4(part + (b * p.nh + h) * SN + rem);
    acc[0] += v.x;
    acc[1] += v.y;
    acc[2] += v.z;
    acc[3] += v.w;
  }
  store4(out + e, acc);
}

// (d) dA: the per-chunk terms summed over (b, chunk) in order
__global__ void ssd_bwd_sum_da(const BwdParams p) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= p.nh) return;
  float s = 0.f;
  for (int b = 0; b < p.B; ++b)
    for (int c = 0; c < p.nc; ++c) s += p.dAp[(static_cast<long long>(b) * p.nh + h) * p.nc + c];
  p.dA[h] = s;
}

template <typename K> int set_smem(K kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <typename T, int HP, int N>
int launch(const BwdParams& p, cudaStream_t stream) {
  using M = StateMap<HP, N>;
  using L = ChunkLayout<HP, N>;
  int e = set_smem(ssd_bwd_states<T, HP, N>, M::kBytes);
  if (e) return e;
  e = set_smem(ssd_bwd_dstates<T, HP, N>, M::kBytes);
  if (e) return e;
  e = set_smem(ssd_bwd_chunk<T, HP, N>, L::kBytes);
  if (e) return e;
  ssd_bwd_states<T, HP, N><<<dim3(p.nh, p.B), kThreads, M::kBytes, stream>>>(p);
  e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  ssd_bwd_dstates<T, HP, N><<<dim3(p.nh, p.B), kThreads, M::kBytes, stream>>>(p);
  e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  ssd_bwd_chunk<T, HP, N><<<dim3(p.nc, p.nh, p.B), kThreads, L::kBytes, stream>>>(p);
  e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  const long long groups = static_cast<long long>(p.B) * p.S * N / 4;
  const unsigned blocks = static_cast<unsigned>((groups + kThreads - 1) / kThreads);
  ssd_bwd_sum_bc<T><<<dim3(blocks, 2), kThreads, 0, stream>>>(p, N);
  e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  ssd_bwd_sum_da<<<(p.nh + 127) / 128, 128, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HP>
int launch_n(const BwdParams& p, int N, cudaStream_t stream) {
  switch (N) {
    case 16: return launch<T, HP, 16>(p, stream);
    case 32: return launch<T, HP, 32>(p, stream);
    case 64: return launch<T, HP, 64>(p, stream);
    case 128: return launch<T, HP, 128>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_hp(const BwdParams& p, int hp, int N, cudaStream_t stream) {
  switch (hp) {
    case 16: return launch_n<T, 16>(p, N, stream);
    case 32: return launch_n<T, 32>(p, N, stream);
    case 64: return launch_n<T, 64>(p, N, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int HP, int N> int info(int* out) {
  using M = StateMap<HP, N>;
  using L = ChunkLayout<HP, N>;
  int e = set_smem(ssd_bwd_states<__nv_bfloat16, HP, N>, M::kBytes);
  if (!e) e = set_smem(ssd_bwd_dstates<__nv_bfloat16, HP, N>, M::kBytes);
  if (!e) e = set_smem(ssd_bwd_chunk<__nv_bfloat16, HP, N>, L::kBytes);
  if (!e) e = kernel_info(ssd_bwd_states<__nv_bfloat16, HP, N>, kThreads, M::kBytes, out);
  if (!e) e = kernel_info(ssd_bwd_dstates<__nv_bfloat16, HP, N>, kThreads, M::kBytes, out + 4);
  if (!e) e = kernel_info(ssd_bwd_chunk<__nv_bfloat16, HP, N>, kThreads, L::kBytes, out + 8);
  return e;
}

}  // namespace
}  // namespace repro_torch

// x, dy, dx: [B, nh, S, hp]; dt, ddt: [B, nh, S] fp32; A, dA: [nh] fp32
// (A contiguous); Bm, Cm: [B, S, N]; dBm, dCm: [B, S, N] dense; init,
// dfinal, dinit: [B, nh, hp, N] fp32 contiguous, each may be null (zeros;
// dinit not written). Scratch, fp32 and dense: states and dstates
// [B, nh, nc, hp, N], dBp and dCp [B, nh, S, N], dAp [B, nh, nc], with
// nc = ceil(S / 64). `strides` holds element strides, 19 values: x, dt
// (batch, head, seq), Bm, Cm (batch, seq), dy, dx, ddt (batch, head, seq);
// x, dy, dx, Bm and Cm have a unit last stride and 16-byte aligned rows,
// and x, dy, dx, Bm, Cm, dBm and dCm share `dtype`. Returns the cudaError_t
// of the first launch that failed (0 on success).
extern "C" int ssd_scan_bwd_launch(const void* x, const float* dt, const float* A, const void* Bm,
                                   const void* Cm, const void* dy, const float* init,
                                   const float* dfinal, float* states, float* dstates,
                                   float* dBp, float* dCp, float* dAp, void* dx, float* ddt,
                                   float* dA, void* dBm, void* dCm, float* dinit,
                                   const long long* strides, int B, int nh, int S, int hp, int N,
                                   int dtype, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || nh <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p;
  p.x = x; p.dt = dt; p.A = A; p.Bm = Bm; p.Cm = Cm; p.dy = dy; p.init = init; p.dfinal = dfinal;
  p.states = states; p.dstates = dstates; p.dBp = dBp; p.dCp = dCp; p.dAp = dAp;
  p.dx = dx; p.ddt = ddt; p.dA = dA; p.dBm = dBm; p.dCm = dCm; p.dinit = dinit;
  p.x_sb = strides[0]; p.x_sh = strides[1]; p.x_ss = strides[2];
  p.dt_sb = strides[3]; p.dt_sh = strides[4]; p.dt_ss = strides[5];
  p.b_sb = strides[6]; p.b_ss = strides[7];
  p.c_sb = strides[8]; p.c_ss = strides[9];
  p.dy_sb = strides[10]; p.dy_sh = strides[11]; p.dy_ss = strides[12];
  p.dx_sb = strides[13]; p.dx_sh = strides[14]; p.dx_ss = strides[15];
  p.ddt_sb = strides[16]; p.ddt_sh = strides[17]; p.ddt_ss = strides[18];
  p.B = B; p.nh = nh; p.S = S; p.nc = (S + kQ - 1) / kQ;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_hp<float>(p, hp, N, s);
  if (dtype == kBFloat16) return launch_hp<__nv_bfloat16>(p, hp, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers, local bytes (spills), dynamic shared memory and CTAs an SM of
// the bf16 (a) states, (b) dstates and (c) chunk kernels at (hp, N), into
// out[0..11]. Returns a cudaError_t.
extern "C" int ssd_scan_bwd_info(int hp, int N, int* out) {
  using namespace repro_torch;
  if (hp == 64 && N == 128) return info<64, 128>(out);
  if (hp == 64 && N == 64) return info<64, 64>(out);
  if (hp == 64 && N == 16) return info<64, 16>(out);
  if (hp == 32 && N == 16) return info<32, 16>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}
