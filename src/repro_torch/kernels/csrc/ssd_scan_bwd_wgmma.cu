// Mamba2 SSD (state-space duality) chunked scan, backward, bf16, for Hopper
// (sm_90a): the wgmma + TMA kernels at hp 64 and N 16, 64 or 128
// (mamba2-2.7b trains at hp 64, N 128; hymba-1.5b's SSM at hp 64, N 16).
// fp32, and bf16 at other (hp, N), go to the FMA kernels in
// ssd_scan_bwd.cu; kernels/ssd_scan.py:bwd_kernel_path picks.
//
// Replaces: the backward of src/repro/kernels/ssd_scan.py, _ssd_kernel /
// ssd_scan_pallas (forward-only on the TPU). The math is ssd_scan_bwd.cu's
// (kernels/ref.py:ssd_scan_bwd_ref at a 64-token chunk): per (b, h) and
// chunk, with acs the in-chunk cumsum of a = dt A, L_ij = exp(acs_i -
// acs_j) for j <= i, w_j = exp(acs_last - acs_j) dt_j, h_c the state
// entering the chunk and dh the gradient of the state leaving it,
//   G = dy x^T, S1 = (C B^T) o L dt_j, T = G o L dt_j, E = G o (C B^T) o L,
//   dx = S1^T dy + w o (B dh^T),  dC = sum_h [T B + e^acs o (dy h_c)],
//   dB = sum_h [T^T C + w o (x dh)],  dh_c = e^{acs_last} dh + (e^acs o dy)^T C,
// and d a_m summed where its terms land (pairs i >= m > j of E dt_j,
// e^{acs_k} C_k.(h_c^T dy_k) for k >= m, w_j B_j.(dh^T x_j) for j < m,
// e^{acs_last} <dh, h_c>); ddt_j = sum_i E_ij + e^{acs_last - acs_j}
// B_j.(dh^T x_j) + A d a_j; dA = sum dt_j d a_j.
//
// Bound on the H100: bytes. At mamba2-2.7b training (B 1, nh 80, S 2048,
// N 128) the function reads x, dy, dt, B, C and writes dx, ddt, dB, dC:
// ~66 MB, ~20 us at 3.35 TB/s; its products are ~17.5 GFLOP, ~18 us on
// the bf16 tensor cores (chip_smoke.py:ssd_bwd_bound). At hymba-1.5b's
// (B 1, nh 50, S 2048, N 16) ~40 MB, ~12 us.
//
// Design: five launches on the caller's stream, no atomics, every sum in a
// fixed order (two calls give the same bits).
//  1. ssd_cb_kernel<N, true> (ssd_common.cuh, shared with the forward;
//     at N 16 ssd_cb16_kernel<true>, likewise), grid (chunk, b): C.B^T
//     and B.C^T of each chunk once for all heads, fp32 scratch in wgmma
//     accumulator order (32 KB a chunk, in L2).
//  2. ssd_bwd_segment_ends, grid (2 (n_seg - 1), h, b): S is cut into
//     segments of whole chunks (kernels/ssd_scan.py:bwd_plan). The first
//     n_seg - 1 CTAs of a (h, b) walk a segment forward from a zero state,
//     h <- e^{acs_last} h + (x o w)^T B, and write its end state; the
//     others walk a segment backward from a zero gradient, g <- e^{acs_last}
//     g + (e^acs o dy)^T C, and write what reaches its start; both write
//     the segment's total log-decay. wgmma m64nN, K = 64 tokens, the fp32
//     state in registers; A from the x or dy tile by ldmatrix.trans, scaled
//     in fp32 and fed as a bf16 pair.
//  3. ssd_bwd_fold, grid (state slice, h, b): in place, the forward end
//     states become the state entering each segment (from initial_state or
//     0) and the backward ones the gradient leaving each segment (from
//     d_final or 0), each a serial fold over the segments.
//  4. ssd_bwd_chunk_kernel, grid (segment, head group, b), one warpgroup:
//     for each head of its group in head order it walks its segment
//     forward from the folded state, parking the state entering each chunk
//     in fp32 scratch of its own (L2), then backward with dh in registers
//     (parked while the products run: 254 registers, no spill), each
//     chunk's gradients on wgmma (products below); dx and ddt are stored,
//     the chunk's dA term goes to scratch, and dB, dC are added in head
//     order into the group's fp32 partial (the first head stores). The
//     next chunk's tiles, its dt and its h_c and partial rows are fetched
//     during the current one. Segment 0 writes d_initial. The chain of
//     one (chunk, head) in one warpgroup, two CTAs an SM, bounds it: 0.52
//     ms at mamba2-2.7b's training shape, 3.8% of the bound (PERF.md).
//  5. ssd_bwd_sums: dB and dC summed over the groups in group order and
//     rounded once; dA summed over (b, chunk) in order.
//  Per (chunk, head) in 4, all products wgmma with fp32 sums: G and G^T
//  (dy and x tiles, K = hp), U = dy h_c and V = x dh (h_c, dh as bf16 pair
//  images [hp][N] in shared memory, MN-major B), T B and T^T C (the scores
//  as register A operands, the B and C tiles MN-major), S1^T dy, B dh^T
//  (dh image K-major), the dh update, and the straddle sums of E dt as
//  (E dt) V01 with V01_jm = [j < m], masked column sums over i >= m. x, dy,
//  B, C are bf16 inputs and enter exactly; every derived operand (scores,
//  h_c, dh, x o w, e^acs o dy) enters as a bf16 pair hi + lo (~2^-17
//  relative): the fp32 outputs (ddt, dA, d_initial) are held to relative
//  L2 1e-4, and any one group rounded once instead misses that
//  (scripts/ssd_bwd_rounding.py). Masks apply before exp. Tiles come by TMA over the
//  caller's strides (the model's [B,S,nh,hp] views and the column slices
//  of the conv output need no copy) with rows at or past S zero-filled:
//  those rows have dt = 0, are no-ops and are never stored.
//  N 16 (hymba-1.5b): a row of a [64 tokens][16] B or C tile is 32 bytes,
//  under the 128-byte swizzle span the TMA maps and descriptors use, so
//  those tiles come in by plain 16-byte loads, a chunk ahead in registers,
//  and are stored transposed: [16 state rows][64 token columns] in one
//  swizzled 2 KB box. That box is the K-major B operand (K = tokens) of the
//  state updates, T B and T^T C, and the MN-major A operand (K = N) of
//  B dh^T and C.B^T; the h_c and dh images are stored [N][hp] likewise
//  (K-major B of dy h_c and x dh, MN-major B of B dh^T). The products with
//  N-wide outputs are m64n16k16. The state is [64,16] fp32, 8 registers a
//  thread, so segments are cheap: bwd_plan has its own costs for N 16.
#include "ssd_common.cuh"

namespace repro_torch {
namespace {

struct BwdParams {
  const __nv_bfloat16* Bm;  // [B,S,N] rows of unit stride; read by the N 16 kernels
  const __nv_bfloat16* Cm;
  const float* dt;
  const float* A;
  const float* init;      // [B,nh,hp,N] or null (zeros)
  const float* dfinal;    // [B,nh,hp,N] or null (zeros)
  float* cb;              // [B,nc,2,8,128,4]: C.B^T, B.C^T in accumulator order
  float* ends;            // [B,nh,2,n_seg-1,hp,N]: segment ends, then folded
  float* ld;              // [B,nh,n_seg] total log-decay of each segment
  float* stash;           // [B,n_groups,nc,hp,N] state entering each chunk
  float* part;            // [2,n_groups,B,nc*64,N] dB, dC of each head group
  float* dAp;             // [B,nh,nc] dA of each (chunk, head)
  void* dx;
  float* ddt;
  float* dA;              // [nh]
  void* dBm;              // [B,S,N] dense
  void* dCm;              // [B,S,N] dense
  float* dinit;           // [B,nh,hp,N] or null
  long long dt_sb, dt_sh, dt_ss, dx_sb, dx_sh, dx_ss, ddt_sb, ddt_sh, ddt_ss;
  long long b_sb, b_ss, c_sb, c_ss;
  int B, nh, S, nc, seg_chunks, n_seg, group, n_groups;
};

// acc += a M over the chunk's 64 tokens: a [64][64 tokens] bf16 A fragments,
// M the N-wide tile of B or C (MN-major in N/64 boxes; at N 16 the
// transposed box, K-major)
template <int N>
__device__ __forceinline__ void tile_product(float (&acc)[N / 2], const uint32_t (&a)[4][4],
                                             uint32_t sM) {
  if constexpr (N == 16) {
    const uint64_t dm = sw128_desc(sM, 16, 1024);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_n16(acc, a[kk], dm + 2 * kk, 1);
  } else {
    const uint64_t dm = sw128_desc(sM, kBox, 1024);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<N>(acc, a[kk], dm + ((kk * 16 * 128) >> 4));
  }
}

// acc += tile P over the head dim: the [64 tokens][64] tile K-major at
// descriptor da, P one bf16 plane [hp][N] of a state image (MN-major; at
// N 16 stored [N][hp], K-major)
template <int N>
__device__ __forceinline__ void image_product(float (&acc)[N / 2], uint64_t da, uint32_t sP) {
  if constexpr (N == 16) {
    const uint64_t dp = sw128_desc(sP, 16, 1024);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss_n16(acc, da + 2 * kk, dp + 2 * kk, 1);
  } else {
    const uint64_t dp = sw128_desc(sP, kBox, 1024);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss_tb<N>(acc, da + 2 * kk, dp + ((kk * 16 * 128) >> 4));
  }
}

// st += a^T M over the chunk's 64 tokens, a as a bf16 pair
template <int N>
__device__ __forceinline__ void state_update(float (&st)[N / 2], const uint32_t (&hi)[4][4],
                                             const uint32_t (&lo)[4][4], uint32_t sM) {
  tile_product<N>(st, hi, sM);
  tile_product<N>(st, lo, sM);
}

// A fragments of a [64 x 64] accumulator tile (rows of the thread, columns
// 8 jb + 2t + {0,1}) as bf16 pairs: v is consumed two values at a time.
// fr[kk][2 (jb % 2) + r / 2] holds columns of block jb = 2 kk + jb % 2.
__device__ __forceinline__ void put_pair(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4], int jb,
                                         int half, float a, float b) {
  split_bf16x2(a, b, hi[jb / 2][2 * (jb % 2) + half], lo[jb / 2][2 * (jb % 2) + half]);
}

// [hp][N] fp32 at `src` (row-major) <-> the accumulator layout of st: st[4q
// + 2 half + e] is row 16 warp + g + 8 half, column 8q + 2t + e.
template <int N>
__device__ __forceinline__ void load_state(float (&st)[N / 2], const float* src, int warp, int g,
                                           int t) {
#pragma unroll
  for (int q = 0; q < N / 8; ++q)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float2 v = make_float2(0.f, 0.f);
      if (src != nullptr)
        v = *reinterpret_cast<const float2*>(src + (16 * warp + g + 8 * half) * N + 8 * q + 2 * t);
      st[4 * q + 2 * half] = v.x;
      st[4 * q + 2 * half + 1] = v.y;
    }
}

template <int N>
__device__ __forceinline__ void store_state(const float (&st)[N / 2], float* dst, int warp, int g,
                                            int t) {
#pragma unroll
  for (int q = 0; q < N / 8; ++q)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<float2*>(dst + (16 * warp + g + 8 * half) * N + 8 * q + 2 * t) =
          make_float2(st[4 * q + 2 * half], st[4 * q + 2 * half + 1]);
}

// ---- 2. segment ends from zero, forward (x, B) or backward (dy, C) ----
template <int N> struct EndsSmem {
  static constexpr int kNB = N / 64;
  static constexpr int kStage = kBox + kTileBytes<N>;   // the x or dy tile, then B or C
  static constexpr int kVec = 2 * kStage;            // dt, acs, w, e^acs
  static constexpr int kBar = kVec + 4 * kQ * 4;     // full[2]
  static constexpr int kBytes = kBar + 16 + 1024;
};

template <int N>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_segment_ends(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tdy,
                     const __grid_constant__ CUtensorMap tb, const __grid_constant__ CUtensorMap tc,
                     const BwdParams p) {
  using L = EndsSmem<N>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_addr(smem_raw));
  float* vec = reinterpret_cast<float*>(gbase + L::kVec);
  const uint32_t full = base + L::kBar;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int n_ends = p.n_seg - 1;
  const bool rev = blockIdx.x >= n_ends;
  const int seg = rev ? blockIdx.x - n_ends + 1 : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int c0 = seg * p.seg_chunks, c1 = min(p.nc, c0 + p.seg_chunks), n = c1 - c0;
  const CUtensorMap* ttile = rev ? &tdy : &tx;
  const CUtensorMap* tmat = rev ? &tc : &tb;
  const float A = p.A[h];
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh;
  const float* scale = vec + (rev ? 3 * kQ : 2 * kQ);   // e^acs or w
  // N 16: B or C by plain loads, a chunk ahead
  const __nv_bfloat16* mat = rev ? p.Cm + b * p.c_sb : p.Bm + b * p.b_sb;
  const long long mat_ss = rev ? p.c_ss : p.b_ss;

  auto issue = [&](int k) {   // the k-th chunk of the walk into slot k % 2
    const int c = rev ? c1 - 1 - k : c0 + k;
    const uint32_t slot = base + (k & 1) * L::kStage, bar = full + 8 * (k & 1);
    if constexpr (N == 16) {
      mbar_expect_tx(bar, kBox);
      tma_load(slot, ttile, bar, 0, c * kQ, h, b);
    } else {
      mbar_expect_tx(bar, L::kStage);
      tma_load(slot, ttile, bar, 0, c * kQ, h, b);
#pragma unroll
      for (int i = 0; i < L::kNB; ++i)
        tma_load(slot + kBox + i * kBox, tmat, bar, 64 * i, c * kQ, b);
    }
  };
  if (tid == 0) {
    mbar_init(full, 1);
    mbar_init(full + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    issue(0);
    if (n > 1) issue(1);
  }
  float st[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) st[i] = 0.f;
  float log_decay = 0.f;
  uint4 mat_next = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (N == 16) mat_next = load_tile16(mat, mat_ss, rev ? c1 - 1 : c0, p.S, tid);
  float d0 = 0.f, d1 = 0.f;   // dt a chunk ahead
  if (warp == 0) load_dt(dtg, p.dt_ss, (rev ? c1 - 1 : c0) * kQ, p.S, lane, d0, d1);
  for (int k = 0; k < n; ++k) {
    const int c = rev ? c1 - 1 - k : c0 + k;
    if constexpr (N == 16) {   // slot k % 2 was last read two chunks ago
      store_tile16(gbase + (k & 1) * L::kStage + kBox, mat_next, tid);
      if (k + 1 < n) mat_next = load_tile16(mat, mat_ss, rev ? c - 1 : c + 1, p.S, tid);
    }
    if (warp == 0) {
      scan_chunk(d0, d1, A, lane, vec, vec + kQ, vec + 2 * kQ, vec + 3 * kQ);
      if (k + 1 < n) load_dt(dtg, p.dt_ss, (rev ? c - 1 : c + 1) * kQ, p.S, lane, d0, d1);
    }
    __syncthreads();   // the chunk's vectors
    log_decay += vec[2 * kQ - 1];
    const float decay = vec[4 * kQ - 1];
    mbar_wait_or_trap(full + 8 * (k & 1), (k >> 1) & 1);
    __syncwarp();
    const uint32_t slot = base + (k & 1) * L::kStage;
    uint32_t hi[4][4], lo[4][4];
    scaled_t_fragments(hi, lo, slot, scale, warp, lane);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) st[i] *= decay;
    fence_regs(st);
    wgmma_fence();
    state_update<N>(st, hi, lo, slot + kBox);
    wgmma_commit();
    wgmma_wait();
    fence_regs(st);
    fence_regs(hi);
    fence_regs(lo);
    __syncthreads();   // every thread is done with the slot and the vectors
    if (tid == 0 && k + 2 < n) issue(k + 2);
  }
  const size_t bh = static_cast<size_t>(b) * p.nh + h;
  const size_t hn = static_cast<size_t>(kHP) * N;
  store_state<N>(st, p.ends + ((bh * 2 + rev) * n_ends + (seg - rev)) * hn, warp, g, t);
  if (tid == 0 && (!rev || seg == p.n_seg - 1)) p.ld[bh * p.n_seg + seg] = log_decay;
}

// ---- 3. fold the segment ends, in place ----
__global__ void __launch_bounds__(kThreads) ssd_bwd_fold(const BwdParams p, int N) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int n_ends = p.n_seg - 1;
  const size_t hn = static_cast<size_t>(kHP) * N;
  const size_t bh = static_cast<size_t>(b) * p.nh + h;
  const size_t e = (static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x) * 4;
  if (e >= hn) return;
  const float* ld = p.ld + bh * p.n_seg;
  float* fwd = p.ends + bh * 2 * n_ends * hn + e;
  float* bwd = fwd + n_ends * hn;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (p.init != nullptr) v = *reinterpret_cast<const float4*>(p.init + bh * hn + e);
  for (int k = 0; k < n_ends; ++k) {   // state entering segment k + 1
    const float dec = expf(ld[k]);
    float4* slot = reinterpret_cast<float4*>(fwd + k * hn);
    const float4 u = *slot;
    v = make_float4(fmaf(dec, v.x, u.x), fmaf(dec, v.y, u.y), fmaf(dec, v.z, u.z),
                    fmaf(dec, v.w, u.w));
    *slot = v;
  }
  v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (p.dfinal != nullptr) v = *reinterpret_cast<const float4*>(p.dfinal + bh * hn + e);
  for (int k = n_ends - 1; k >= 0; --k) {   // gradient leaving segment k
    const float dec = expf(ld[k + 1]);
    float4* slot = reinterpret_cast<float4*>(bwd + k * hn);
    const float4 u = *slot;
    v = make_float4(fmaf(dec, v.x, u.x), fmaf(dec, v.y, u.y), fmaf(dec, v.z, u.z),
                    fmaf(dec, v.w, u.w));
    *slot = v;
  }
}

// ---- 4. the in-chunk gradients, per (segment, head group, b) ----
// Shared memory from a 1024-byte aligned base: two slots of tiles, x and B
// (slot 0) and dy and C (slot 1), which the forward walk uses as a ring of
// x and B; one [hp][N] image in three bf16 planes (h_c as hi + lo, then dh
// as hi + lo + lo2, which sum to dh exactly in fp32); V01 and the chunk's
// vectors. At N 16 the B and C slots and the image planes are one 2 KB box
// each (transposed; their copies are the threads').
template <int N> struct ChunkSmem {
  static constexpr int kX = 0;
  static constexpr int kB = kBox;
  static constexpr int kDY = kB + kTileBytes<N>;
  static constexpr int kC = kDY + kBox;
  static constexpr int kImg = kC + kTileBytes<N>;    // hi, lo, lo2
  static constexpr int kV = kImg + 3 * kTileBytes<N>;
  static constexpr int kVec = kV + kBox;             // 8 x [64] below, red [4][64], dot [4]
  static constexpr int kBar = kVec + (8 * kQ + 4 * kQ + 4) * 4;   // full[2]
  static constexpr int kBytes = kBar + 16 + 1024;
};
// vector offsets (floats) from kVec
constexpr int vDt = 0, vAcs = kQ, vW = 2 * kQ, vEa = 3 * kQ, vEl = 4 * kQ, vQ = 5 * kQ,
              vBV = 6 * kQ, vCol = 7 * kQ, vRed = 8 * kQ, vDot = 12 * kQ;

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

template <int N>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_chunk_kernel(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tdy,
                     const __grid_constant__ CUtensorMap tb, const __grid_constant__ CUtensorMap tc,
                     const BwdParams p) {
  using L = ChunkSmem<N>;
  constexpr int kNB = N / 64;
  constexpr int kPlane = kTileBytes<N>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_addr(smem_raw));
  float* vec = reinterpret_cast<float*>(gbase + L::kVec);
  const uint32_t sX = base + L::kX, sDY = base + L::kDY, sB = base + L::kB, sC = base + L::kC;
  const uint32_t sImg = base + L::kImg, sV = base + L::kV, full = base + L::kBar;
  const int seg = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int c0 = seg * p.seg_chunks, c1 = min(p.nc, c0 + p.seg_chunks);
  const int n_ends = p.n_seg - 1;
  const size_t hn = static_cast<size_t>(kHP) * N;
  const int r0w = 16 * warp + g, r1w = r0w + 8;   // the thread's accumulator rows

  if (tid == 0) {
    mbar_init(full, 1);
    mbar_init(full + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // V01 [j rows][m columns] = [j < m], MN-major B of the straddle sums
  for (int e = tid; e < kQ * kQ / 2; e += kThreads) {
    const int j = e / (kQ / 2), m = 2 * (e % (kQ / 2));
    *reinterpret_cast<uint32_t*>(gbase + L::kV + sw128_offset(j, m, kBox)) =
        pack_bf16(j < m ? 1.f : 0.f, j < m + 1 ? 1.f : 0.f);
  }
  fence_async_smem();
  __syncthreads();
  uint32_t phase0 = 0, phase1 = 0;   // scalars: an indexed pair would live in local memory
  // slot s (0: sX and sB, 1: sDY and sC) <- chunk c's x and B, or with
  // `dyc` its dy and C; completes on full[s]. At N 16 only x or dy: the
  // threads store B and C (load_tile16 a chunk ahead, store_tile16)
  auto issue = [&](int s, bool dyc, int c, int h) {
    const uint32_t bar = full + 8 * s;
    mbar_expect_tx(bar, kBox + (N == 16 ? 0 : kPlane));
    tma_load(s ? sDY : sX, dyc ? &tdy : &tx, bar, 0, c * kQ, h, b);
#pragma unroll
    for (int i = 0; i < kNB; ++i)
      tma_load((s ? sC : sB) + i * kBox, dyc ? &tc : &tb, bar, 64 * i, c * kQ, b);
  };
  const __nv_bfloat16* bm = p.Bm + b * p.b_sb;
  const __nv_bfloat16* cm = p.Cm + b * p.c_sb;
  auto wait_slot = [&](int s) {
    if (s) {
      mbar_wait_or_trap(full + 8, phase1);
      phase1 ^= 1;
    } else {
      mbar_wait_or_trap(full, phase0);
      phase0 ^= 1;
    }
    __syncwarp();
  };
  // st as bf16 planes hi, lo (and with `three` lo2) into the image
  auto store_image = [&](const float (&st)[N / 2], bool three) {
#pragma unroll
    for (int q = 0; q < N / 8; ++q)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = half ? r1w : r0w, col = 8 * q + 2 * t;
        const float a = st[4 * q + 2 * half], c = st[4 * q + 2 * half + 1];
        uint32_t hi, lo;
        split_bf16x2(a, c, hi, lo);
        st_pair<N>(gbase + L::kImg, row, col, hi);
        st_pair<N>(gbase + L::kImg + kPlane, row, col, lo);
        if (three) {
          const float2 h2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
          const float2 l2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&lo));
          st_pair<N>(gbase + L::kImg + 2 * kPlane, row, col,
                     pack_bf16((a - h2.x) - l2.x, (c - h2.y) - l2.y));
        }
      }
    fence_async_smem();
  };
  // st <- (hi + lo) + lo2 of the image: exactly what store_image(st, true) took
  auto load_image = [&](float (&st)[N / 2]) {
#pragma unroll
    for (int q = 0; q < N / 8; ++q)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = half ? r1w : r0w, col = 8 * q + 2 * t;
        const float2 h2 = ld_pair<N>(gbase + L::kImg, row, col);
        const float2 l2 = ld_pair<N>(gbase + L::kImg + kPlane, row, col);
        const float2 m2 = ld_pair<N>(gbase + L::kImg + 2 * kPlane, row, col);
        st[4 * q + 2 * half] = (h2.x + l2.x) + m2.x;
        st[4 * q + 2 * half + 1] = (h2.y + l2.y) + m2.y;
      }
  };
  // sum over the thread's columns of acc o M ([64 rows][N] tile in shared
  // memory) for its two rows, then over the row's four threads
  auto row_dots = [&](const float (&acc)[N / 2], int sM, float& s0, float& s1) {
    s0 = s1 = 0.f;
#pragma unroll
    for (int q = 0; q < N / 8; ++q) {
      const float2 m0 = ld_pair<N>(gbase + sM, r0w, 8 * q + 2 * t);
      const float2 m1 = ld_pair<N>(gbase + sM, r1w, 8 * q + 2 * t);
      s0 = fmaf(acc[4 * q], m0.x, fmaf(acc[4 * q + 1], m0.y, s0));
      s1 = fmaf(acc[4 * q + 2], m1.x, fmaf(acc[4 * q + 3], m1.y, s1));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    }
  };
  // the rows of chunk c in the group's partial m
  auto partial = [&](int m, int c) {
    return p.part + ((static_cast<size_t>(m) * p.n_groups + grp) * p.B + b) * p.nc * kQ * N +
           static_cast<size_t>(c) * kQ * N;
  };
  // add acc into the group's partial m at chunk c, or store it first
  auto add_partial = [&](const float (&acc)[N / 2], int m, int c, bool first) {
    float* dst = partial(m, c);
#pragma unroll
    for (int q = 0; q < N / 8; ++q)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float2* d = reinterpret_cast<float2*>(dst + (half ? r1w : r0w) * N + 8 * q + 2 * t);
        float2 v = make_float2(acc[4 * q + 2 * half], acc[4 * q + 2 * half + 1]);
        if (!first) {
          const float2 o = *d;
          v.x += o.x;
          v.y += o.y;
        }
        *d = v;
      }
  };
  // the thread's two rows of a [64][N] fp32 block into L2 (a line a thread)
  auto prefetch_rows = [&](const float* blk) {
    if (t * 32 < N) {
      prefetch_l2(blk + r0w * N + t * 32);
      prefetch_l2(blk + r1w * N + t * 32);
    }
  };

  for (int hh = 0; hh < p.group; ++hh) {
    const int h = grp * p.group + hh;
    if (h >= p.nh) break;
    const float A = p.A[h];
    const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh;
    const size_t bh = static_cast<size_t>(b) * p.nh + h;
    float* stash = p.stash + (static_cast<size_t>(b) * p.n_groups + grp) * p.nc * hn;

    // (a) forward over the segment from the state entering it, parking the
    // state entering each chunk (each thread reads back only its own); x and
    // B come through both slots as a ring, dt a chunk ahead
    {
      float st[N / 2];
      load_state<N>(st,
                    seg == 0 ? (p.init == nullptr ? nullptr : p.init + bh * hn)
                             : p.ends + (bh * 2 * n_ends + seg - 1) * hn,
                    warp, g, t);
      const int steps = c1 - c0 - 1;
      if (tid == 0) {
        if (steps > 0) issue(0, false, c0, h);
        if (steps > 1) issue(1, false, c0 + 1, h);
      }
      float d0 = 0.f, d1 = 0.f;
      if (warp == 0 && steps > 0) load_dt(dtg, p.dt_ss, c0 * kQ, p.S, lane, d0, d1);
      uint4 b_next = make_uint4(0u, 0u, 0u, 0u);
      if (N == 16 && steps > 0) b_next = load_tile16(bm, p.b_ss, c0, p.S, tid);
      for (int k = 0;; ++k) {
        const int c = c0 + k, s = k & 1;
        store_state<N>(st, stash + c * hn, warp, g, t);
        if (k == steps) break;
        if constexpr (N == 16) {   // slot s was last read two chunks ago
          store_tile16(gbase + (s ? L::kC : L::kB), b_next, tid);
          if (k + 1 < steps) b_next = load_tile16(bm, p.b_ss, c + 1, p.S, tid);
        }
        if (warp == 0) {
          scan_chunk(d0, d1, A, lane, vec + vDt, vec + vAcs, vec + vW, vec + vEa);
          if (k + 1 < steps) load_dt(dtg, p.dt_ss, (c + 1) * kQ, p.S, lane, d0, d1);
        }
        __syncthreads();
        wait_slot(s);
        uint32_t hi[4][4], lo[4][4];
        scaled_t_fragments(hi, lo, s ? sDY : sX, vec + vW, warp, lane);
        const float decay = vec[vEa + kQ - 1];
#pragma unroll
        for (int i = 0; i < N / 2; ++i) st[i] *= decay;
        fence_regs(st);
        wgmma_fence();
        state_update<N>(st, hi, lo, s ? sC : sB);
        wgmma_commit();
        wgmma_wait();
        fence_regs(st);
        fence_regs(hi);
        fence_regs(lo);
        __syncthreads();   // done with the slot and the vectors
        if (tid == 0 && k + 2 < steps) issue(s, false, c + 2, h);
      }
    }

    // (b) backward over the segment with dh, the gradient of the state
    // leaving the chunk, in registers at the chunk's start and end; between
    // them it is parked (the chunk's scratch slot, then the image), which
    // keeps the products below out of local memory. The next chunk's tiles
    // are copied in as soon as their slot is free, its dt is read a chunk
    // ahead and its h_c and partial rows are prefetched into L2.
    float dh[N / 2];
    load_state<N>(dh,
                  seg == n_ends ? (p.dfinal == nullptr ? nullptr : p.dfinal + bh * hn)
                                : p.ends + (bh * 2 * n_ends + n_ends + seg) * hn,
                  warp, g, t);
    if (tid == 0) {
      issue(0, false, c1 - 1, h);
      issue(1, true, c1 - 1, h);
    }
    if constexpr (N == 16) {   // the forward walk is done with both slots
      store_tile16(gbase + L::kB, load_tile16(bm, p.b_ss, c1 - 1, p.S, tid), tid);
      store_tile16(gbase + L::kC, load_tile16(cm, p.c_ss, c1 - 1, p.S, tid), tid);
    }
    float d0 = 0.f, d1 = 0.f;
    if (warp == 0) load_dt(dtg, p.dt_ss, (c1 - 1) * kQ, p.S, lane, d0, d1);
    for (int c = c1 - 1; c >= c0; --c) {
      const int r0 = c * kQ, nv = min(kQ, p.S - r0);
      // N 16: the next chunk's B and C, stored once this chunk is done with them
      uint4 b_next = make_uint4(0u, 0u, 0u, 0u), c_next = b_next;
      if (N == 16 && c > c0) {
        b_next = load_tile16(bm, p.b_ss, c - 1, p.S, tid);
        c_next = load_tile16(cm, p.c_ss, c - 1, p.S, tid);
      }
      float cb[32];   // C.B^T of the chunk, rows i, in flight during the start
      {
        const float4* src = reinterpret_cast<const float4*>(p.cb) +
                            static_cast<size_t>(b * p.nc + c) * 2 * 8 * kThreads + tid;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float4 v = __ldg(src + q * kThreads);
          cb[4 * q] = v.x;
          cb[4 * q + 1] = v.y;
          cb[4 * q + 2] = v.z;
          cb[4 * q + 3] = v.w;
        }
      }
      // h_c as a bf16 pair image, <dh, h_c>; dh parked in h_c's slot
      {
        float hc[N / 2];
        load_state<N>(hc, stash + c * hn, warp, g, t);
        if (c > c0) prefetch_rows(stash + (c - 1) * hn);
        if (hh > 0) {
          prefetch_rows(partial(0, c));
          prefetch_rows(partial(1, c));
        }
        if (warp == 0) {
          scan_chunk(d0, d1, A, lane, vec + vDt, vec + vAcs, vec + vW, vec + vEa);
          if (c > c0) load_dt(dtg, p.dt_ss, r0 - kQ, p.S, lane, d0, d1);
          __syncwarp();
          const float last = vec[vAcs + kQ - 1];
          vec[vEl + 2 * lane] = expf(last - vec[vAcs + 2 * lane]);
          vec[vEl + 2 * lane + 1] = expf(last - vec[vAcs + 2 * lane + 1]);
        }
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < N / 2; ++i) dot = fmaf(dh[i], hc[i], dot);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (lane == 0) vec[vDot + warp] = dot;
        store_image(hc, false);
        store_state<N>(dh, stash + c * hn, warp, g, t);
      }
      __syncthreads();   // the vectors and the h_c image
      wait_slot(0);
      wait_slot(1);
      const float acs0 = vec[vAcs + r0w], acs1 = vec[vAcs + r1w];
      const float ea0 = vec[vEa + r0w], ea1 = vec[vEa + r1w];

      // (1) rows i: G = dy x^T and C.B^T -> T (A operand of T B) and
      // F = E dt_j (A operand of the straddle sums)
      uint32_t th[4][4], tl[4][4];
      {
        uint32_t fh[4][4], fl[4][4];
        {
          float gi[32];
#pragma unroll
          for (int i = 0; i < 32; ++i) gi[i] = 0.f;
          const uint64_t da = sw128_desc(sDY, 16, 1024), db = sw128_desc(sX, 16, 1024);
          fence_regs(gi);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) wgmma_ss_n64(gi, da + 2 * kk, db + 2 * kk, 1);
          wgmma_commit();
          wgmma_wait();
          fence_regs(gi);
#pragma unroll
          for (int jb = 0; jb < 8; ++jb) {
            const float2 acs_j = *reinterpret_cast<const float2*>(vec + vAcs + 8 * jb + 2 * t);
            const float2 dt_j = *reinterpret_cast<const float2*>(vec + vDt + 8 * jb + 2 * t);
            float tv[4], fv[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int i = r < 2 ? r0w : r1w, j = 8 * jb + 2 * t + (r & 1);
              const float aj = (r & 1) ? acs_j.y : acs_j.x, dj = (r & 1) ? dt_j.y : dt_j.x;
              const float l = fast_exp2(j <= i ? ((r < 2 ? acs0 : acs1) - aj) * kLog2e : -INFINITY);
              const float gl = gi[4 * jb + r] * l;
              tv[r] = gl * dj;
              fv[r] = gl * cb[4 * jb + r] * dj;
            }
            put_pair(th, tl, jb, 0, tv[0], tv[1]);
            put_pair(th, tl, jb, 1, tv[2], tv[3]);
            put_pair(fh, fl, jb, 0, fv[0], fv[1]);
            put_pair(fh, fl, jb, 1, fv[2], fv[3]);
          }
        }
        // straddle sums: P = F V01 (P_im = sum_{j<m} E_ij dt_j), then the
        // column sums of P over rows i >= m
        float pm[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) pm[i] = 0.f;
        const uint64_t dv = sw128_desc(sV, kBox, 1024);
        fence_regs(pm);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64(pm, fh[kk], dv + ((kk * 16 * 128) >> 4), 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64(pm, fl[kk], dv + ((kk * 16 * 128) >> 4), 1);
        wgmma_commit();
        wgmma_wait();
        fence_regs(pm);
        fence_regs(fh);
        fence_regs(fl);
#pragma unroll
        for (int mb = 0; mb < 8; ++mb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int m = 8 * mb + 2 * t + e;
            float s = (r0w >= m ? pm[4 * mb + e] : 0.f) + (r1w >= m ? pm[4 * mb + 2 + e] : 0.f);
#pragma unroll
            for (int off = 4; off < 32; off <<= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
            if (g == 0) vec[vRed + warp * kQ + m] = s;
          }
      }

      // (2) dC = e^acs o (dy h_c) + T B; q_i = e^{acs_i} C_i.(h_c^T dy_i).
      // dh comes back from its slot meanwhile.
      float dpark[N / 2];
      {
        float u[N / 2];
#pragma unroll
        for (int i = 0; i < N / 2; ++i) u[i] = 0.f;
        const uint64_t da = sw128_desc(sDY, 16, 1024);
        fence_regs(u);
        wgmma_fence();
        image_product<N>(u, da, sImg);
        image_product<N>(u, da, sImg + kPlane);
        wgmma_commit();
        load_state<N>(dpark, stash + c * hn, warp, g, t);
        wgmma_wait();
        fence_regs(u);
        float s0, s1;
        row_dots(u, L::kC, s0, s1);
        if (t == 0) {
          vec[vQ + r0w] = ea0 * s0;
          vec[vQ + r1w] = ea1 * s1;
        }
#pragma unroll
        for (int q = 0; q < N / 8; ++q) {
          u[4 * q] *= ea0;
          u[4 * q + 1] *= ea0;
          u[4 * q + 2] *= ea1;
          u[4 * q + 3] *= ea1;
        }
        fence_regs(u);
        wgmma_fence();
        tile_product<N>(u, th, sB);
        tile_product<N>(u, tl, sB);
        wgmma_commit();
        wgmma_wait();
        fence_regs(u);
        fence_regs(th);
        fence_regs(tl);
        add_partial(u, 1, c, hh == 0);
      }
      float bc[32];   // B.C^T of the chunk, rows j, in flight during the dh image
      {
        const float4* src = reinterpret_cast<const float4*>(p.cb) +
                            (static_cast<size_t>(b * p.nc + c) * 2 + 1) * 8 * kThreads + tid;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float4 v = __ldg(src + q * kThreads);
          bc[4 * q] = v.x;
          bc[4 * q + 1] = v.y;
          bc[4 * q + 2] = v.z;
          bc[4 * q + 3] = v.w;
        }
      }
      __syncthreads();   // every product that read the h_c image is done
      store_image(dpark, true);
      __syncthreads();   // the dh image

      // (3) rows j: G^T = x dy^T and B.C^T -> S1^T, T^T (A operands) and
      // the column sums of E
      uint32_t sh[4][4], sl[4][4], uh[4][4], ul[4][4];
      {
        float gj[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) gj[i] = 0.f;
        const uint64_t da = sw128_desc(sX, 16, 1024), db = sw128_desc(sDY, 16, 1024);
        fence_regs(gj);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_ss_n64(gj, da + 2 * kk, db + 2 * kk, 1);
        wgmma_commit();
        wgmma_wait();
        fence_regs(gj);
        const float dt0 = vec[vDt + r0w], dt1 = vec[vDt + r1w];
        float col0 = 0.f, col1 = 0.f;
#pragma unroll
        for (int ib = 0; ib < 8; ++ib) {
          const float2 acs_i = *reinterpret_cast<const float2*>(vec + vAcs + 8 * ib + 2 * t);
          float sv[4], tv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int j = r < 2 ? r0w : r1w, i = 8 * ib + 2 * t + (r & 1);
            const float ai = (r & 1) ? acs_i.y : acs_i.x;
            const float l = fast_exp2(i >= j ? (ai - (r < 2 ? acs0 : acs1)) * kLog2e : -INFINITY);
            const float dj = r < 2 ? dt0 : dt1;
            const float bl = bc[4 * ib + r] * l;
            sv[r] = bl * dj;
            tv[r] = gj[4 * ib + r] * l * dj;
            if (r < 2) col0 = fmaf(gj[4 * ib + r], bl, col0);
            else col1 = fmaf(gj[4 * ib + r], bl, col1);
          }
          put_pair(sh, sl, ib, 0, sv[0], sv[1]);
          put_pair(sh, sl, ib, 1, sv[2], sv[3]);
          put_pair(uh, ul, ib, 0, tv[0], tv[1]);
          put_pair(uh, ul, ib, 1, tv[2], tv[3]);
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          col0 += __shfl_xor_sync(0xffffffffu, col0, off);
          col1 += __shfl_xor_sync(0xffffffffu, col1, off);
        }
        if (t == 0) {
          vec[vCol + r0w] = col0;
          vec[vCol + r1w] = col1;
        }
      }

      // (4) dB = w o (x dh) + T^T C; bv_j = B_j.(dh^T x_j)
      {
        float v[N / 2];
#pragma unroll
        for (int i = 0; i < N / 2; ++i) v[i] = 0.f;
        const uint64_t da = sw128_desc(sX, 16, 1024);
        fence_regs(v);
        wgmma_fence();
        image_product<N>(v, da, sImg);
        image_product<N>(v, da, sImg + kPlane);
        wgmma_commit();
        wgmma_wait();
        fence_regs(v);
        float s0, s1;
        row_dots(v, L::kB, s0, s1);
        if (t == 0) {
          vec[vBV + r0w] = s0;
          vec[vBV + r1w] = s1;
        }
        const float w0 = vec[vW + r0w], w1 = vec[vW + r1w];
#pragma unroll
        for (int q = 0; q < N / 8; ++q) {
          v[4 * q] *= w0;
          v[4 * q + 1] *= w0;
          v[4 * q + 2] *= w1;
          v[4 * q + 3] *= w1;
        }
        fence_regs(v);
        wgmma_fence();
        tile_product<N>(v, uh, sC);
        tile_product<N>(v, ul, sC);
        wgmma_commit();
        wgmma_wait();
        fence_regs(v);
        fence_regs(uh);
        fence_regs(ul);
        add_partial(v, 0, c, hh == 0);
      }

      // (5) dx = S1^T dy + w o (B dh^T), stored in bf16 (rows past S are not)
      {
        float x1[32], x2[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) x1[i] = x2[i] = 0.f;
        const uint64_t ddy = sw128_desc(sDY, kBox, 1024);
        fence_regs(x1);
        fence_regs(x2);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64(x1, sh[kk], ddy + ((kk * 16 * 128) >> 4), 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64(x1, sl[kk], ddy + ((kk * 16 * 128) >> 4), 1);
        if constexpr (N == 16) {   // B [j][n] and dh^T [n][p], both MN-major, K = 16
          const uint64_t da = sw128_desc(sB, kBox, 1024);
          wgmma_ss_mn_n64(x2, da, sw128_desc(sImg, kBox, 1024), 1);
          wgmma_ss_mn_n64(x2, da, sw128_desc(sImg + kPlane, kBox, 1024), 1);
        } else {
          const uint64_t da = sw128_desc(sB, 16, 1024);
          const uint64_t dhi = sw128_desc(sImg, 16, 1024);
          const uint64_t dlo = sw128_desc(sImg + kPlane, 16, 1024);
#pragma unroll
          for (int kk = 0; kk < N / 16; ++kk) {
            const uint32_t step = ((kk / 4) * kBox + (kk % 4) * 32) >> 4;
            wgmma_ss_n64(x2, da + step, dhi + step, 1);
          }
#pragma unroll
          for (int kk = 0; kk < N / 16; ++kk) {
            const uint32_t step = ((kk / 4) * kBox + (kk % 4) * 32) >> 4;
            wgmma_ss_n64(x2, da + step, dlo + step, 1);
          }
        }
        wgmma_commit();
        wgmma_wait();
        fence_regs(x1);
        fence_regs(x2);
        fence_regs(sh);
        fence_regs(sl);
        const float w0 = vec[vW + r0w], w1 = vec[vW + r1w];
        __nv_bfloat16* dxg = static_cast<__nv_bfloat16*>(p.dx) + b * p.dx_sb + h * p.dx_sh;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = half ? r1w : r0w;
          if (j >= nv) continue;
          const float w = half ? w1 : w0;
          __nv_bfloat16* row = dxg + (r0 + j) * p.dx_ss + 2 * t;
#pragma unroll
          for (int q = 0; q < 8; ++q)
            *reinterpret_cast<__nv_bfloat162*>(row + 8 * q) = __floats2bfloat162_rn(
                fmaf(w, x2[4 * q + 2 * half], x1[4 * q + 2 * half]),
                fmaf(w, x2[4 * q + 2 * half + 1], x1[4 * q + 2 * half + 1]));
        }
      }
      __syncthreads();   // every thread is done with x and B
      if (tid == 0 && c > c0) issue(0, false, c - 1, h);
      if (N == 16 && c > c0) store_tile16(gbase + L::kB, b_next, tid);

      // (6) dh <- e^{acs_last} dh + (e^acs o dy)^T C, dh exact from its image
      {
        uint32_t hi[4][4], lo[4][4];
        scaled_t_fragments(hi, lo, sDY, vec + vEa, warp, lane);
        const float decay = vec[vEa + kQ - 1];
        load_image(dh);
#pragma unroll
        for (int i = 0; i < N / 2; ++i) dh[i] *= decay;
        fence_regs(dh);
        wgmma_fence();
        state_update<N>(dh, hi, lo, sC);
        wgmma_commit();
        wgmma_wait();
        fence_regs(dh);
        fence_regs(hi);
        fence_regs(lo);
      }
      __syncthreads();   // q, bv, the column and straddle sums, <dh, h_c>; dy, C free
      if (tid == 0 && c > c0) issue(1, true, c - 1, h);
      if (N == 16 && c > c0) store_tile16(gbase + L::kC, c_next, tid);

      // (7) d a_m, ddt and the chunk's dA term: one warp, two tokens a lane
      if (warp == 0) {
        const int m0 = 2 * lane, m1 = m0 + 1;
        const float* red = vec + vRed;
        const float dot = vec[vDot] + vec[vDot + 1] + vec[vDot + 2] + vec[vDot + 3];
        const float last = vec[vEa + kQ - 1] * dot;
        // sum_{k >= m} q_k
        const float q0 = vec[vQ + m0], q1 = vec[vQ + m1];
        float suf = q0 + q1;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float o = __shfl_down_sync(0xffffffffu, suf, off);
          if (lane + off < 32) suf += o;
        }
        float above = __shfl_down_sync(0xffffffffu, suf, 1);
        if (lane == 31) above = 0.f;
        const float qs1 = q1 + above, qs0 = q0 + qs1;
        // sum_{j < m} w_j bv_j
        const float p0 = vec[vW + m0] * vec[vBV + m0], p1 = vec[vW + m1] * vec[vBV + m1];
        float pre = p0 + p1;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float o = __shfl_up_sync(0xffffffffu, pre, off);
          if (lane >= off) pre += o;
        }
        float below = __shfl_up_sync(0xffffffffu, pre, 1);
        if (lane == 0) below = 0.f;
        const float pw0 = below, pw1 = below + p0;
        const float str0 = red[m0] + red[kQ + m0] + red[2 * kQ + m0] + red[3 * kQ + m0];
        const float str1 = red[m1] + red[kQ + m1] + red[2 * kQ + m1] + red[3 * kQ + m1];
        const float da0 = str0 + qs0 + pw0 + last, da1 = str1 + qs1 + pw1 + last;
        float* ddt = p.ddt + b * p.ddt_sb + h * p.ddt_sh;
        if (m0 < nv)
          ddt[(r0 + m0) * p.ddt_ss] = vec[vCol + m0] + vec[vEl + m0] * vec[vBV + m0] + A * da0;
        if (m1 < nv)
          ddt[(r0 + m1) * p.ddt_ss] = vec[vCol + m1] + vec[vEl + m1] * vec[vBV + m1] + A * da1;
        float s = vec[vDt + m0] * da0 + vec[vDt + m1] * da1;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) p.dAp[bh * p.nc + c] = s;
      }
      __syncthreads();   // every thread is done with the image and the vectors
    }
    if (seg == 0 && p.dinit != nullptr) store_state<N>(dh, p.dinit + bh * hn, warp, g, t);
  }
}

// ---- 5. dB, dC summed over the groups in order (rounded once); dA ----
__global__ void __launch_bounds__(256) ssd_bwd_sums(const BwdParams p, int N) {
  if (blockIdx.y == 2) {
    const int h = blockIdx.x * 256 + threadIdx.x;
    if (h >= p.nh) return;
    float s = 0.f;
    for (int b = 0; b < p.B; ++b)
#pragma unroll 8   // loads in flight; the adds keep chunk order
      for (int c = 0; c < p.nc; ++c) s += p.dAp[(static_cast<size_t>(b) * p.nh + h) * p.nc + c];
    p.dA[h] = s;
    return;
  }
  const size_t rows = static_cast<size_t>(p.nc) * kQ;
  const size_t e = (static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x) * 4;
  if (e >= p.B * rows * N) return;
  const size_t b = e / (rows * N), row = (e / N) % rows;
  if (row >= static_cast<size_t>(p.S)) return;
  const size_t plane = static_cast<size_t>(p.B) * rows * N;
  const float* src = p.part + static_cast<size_t>(blockIdx.y) * p.n_groups * plane + e;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8   // loads in flight; the adds keep group order
  for (int k = 0; k < p.n_groups; ++k) {
    const float4 v = *reinterpret_cast<const float4*>(src + k * plane);
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(blockIdx.y ? p.dCm : p.dBm) +
                       (b * p.S + row) * N + e % N;
  const __nv_bfloat162 lo = __floats2bfloat162_rn(acc.x, acc.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(acc.z, acc.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(out) = u;
}

template <int N> int set_smem_limits() {
  cudaError_t e = cudaSuccess;
  if constexpr (N != 16)
    e = cudaFuncSetAttribute(ssd_cb_kernel<N, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             cb_smem_bytes<N>());
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_bwd_segment_ends<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             EndsSmem<N>::kBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             ChunkSmem<N>::kBytes);
  return static_cast<int>(e);
}

template <int N>
int launch(const CUtensorMap& tx, const CUtensorMap& tdy, const CUtensorMap& tb,
           const CUtensorMap& tc, const BwdParams& p, cudaStream_t stream) {
  int err = set_smem_limits<N>();
  if (err != 0) return err;
  if constexpr (N == 16) {
    ssd_cb16_kernel<true><<<dim3(p.nc, p.B), kThreads, kCb16Smem, stream>>>(
        p.Bm, p.b_sb, p.b_ss, p.Cm, p.c_sb, p.c_ss, p.cb, p.S, p.nc);
  } else {
    ssd_cb_kernel<N, true><<<dim3(p.nc, p.B), kThreads, cb_smem_bytes<N>(), stream>>>(tb, tc,
                                                                                     p.cb, p.nc);
  }
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  if (p.n_seg > 1) {
    ssd_bwd_segment_ends<N><<<dim3(2 * (p.n_seg - 1), p.nh, p.B), kThreads, EndsSmem<N>::kBytes,
                              stream>>>(tx, tdy, tb, tc, p);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    const int slices = kHP * N / 4 / kThreads;
    ssd_bwd_fold<<<dim3(slices, p.nh, p.B), kThreads, 0, stream>>>(p, N);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  ssd_bwd_chunk_kernel<N><<<dim3(p.n_seg, p.n_groups, p.B), kThreads, ChunkSmem<N>::kBytes,
                            stream>>>(tx, tdy, tb, tc, p);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const size_t quads = static_cast<size_t>(p.B) * p.nc * kQ * N / 4;
  const unsigned blocks = static_cast<unsigned>((quads + 255) / 256);
  ssd_bwd_sums<<<dim3(blocks, 3), 256, 0, stream>>>(p, N);
  return static_cast<int>(cudaGetLastError());
}

template <int N> int info(int* out) {
  int e = set_smem_limits<N>();
  if (!e) {
    if constexpr (N == 16) e = kernel_info(ssd_cb16_kernel<true>, kThreads, kCb16Smem, out);
    else e = kernel_info(ssd_cb_kernel<N, true>, kThreads, cb_smem_bytes<N>(), out);
  }
  if (!e) e = kernel_info(ssd_bwd_segment_ends<N>, kThreads, EndsSmem<N>::kBytes, out + 4);
  if (!e) e = kernel_info(ssd_bwd_fold, kThreads, 0, out + 8);
  if (!e) e = kernel_info(ssd_bwd_chunk_kernel<N>, kThreads, ChunkSmem<N>::kBytes, out + 12);
  if (!e) e = kernel_info(ssd_bwd_sums, 256, 0, out + 16);
  return e;
}

}  // namespace
}  // namespace repro_torch

// bf16 only, hp 64, N 16, 64 or 128. x, dy, dx: [B, nh, S, 64]; dt, ddt:
// [B, nh, S] fp32; A, dA: [nh] fp32 (A contiguous); Bm, Cm: [B, S, N];
// dBm, dCm: [B, S, N] dense; init, dfinal, dinit: [B, nh, 64, N] fp32
// contiguous, each may be null (zeros; dinit not written). `strides`
// holds 19 element strides as ssd_scan_bwd_launch takes them: x, dt
// (batch, head, seq), Bm, Cm (batch, seq), dy, dx, ddt (batch, head, seq);
// x, dy, dx, Bm, Cm have a unit last stride, strides that are multiples of
// 8 and 16-byte aligned bases. Scratch, fp32 and dense, with nc = ceil(S /
// 64), n_seg = ceil(nc / seg_chunks), n_groups = ceil(nh / group): cb
// [B, nc, 2, 4096]; ends [B, nh, 2, n_seg - 1, 64, N] and ld [B, nh, n_seg]
// (unused when n_seg is 1); stash [B, n_groups, nc, 64, N]; part [2,
// n_groups, B, nc * 64, N]; dAp [B, nh, nc]. Returns the cudaError_t of the
// launches (0 on success), or 100000 plus the CUresult of a tensor map the
// driver refused.
extern "C" int ssd_scan_bwd_wgmma_launch(
    const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
    const void* dy, const float* init, const float* dfinal, float* cb, float* ends, float* ld,
    float* stash, float* part, float* dAp, void* dx, float* ddt, float* dA, void* dBm, void* dCm,
    float* dinit, const long long* strides, int B, int nh, int S, int N, int seg_chunks, int group,
    void* stream) {
  using namespace repro_torch;
  if (B <= 0 || nh <= 0 || S <= 0 || seg_chunks <= 0 || group <= 0 ||
      (N != 16 && N != 64 && N != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tx, tdy, tb{}, tc{};   // tb, tc: N >= 64 only
  const long long xs[3] = {strides[0], strides[1], strides[2]};
  const long long ys[3] = {strides[10], strides[11], strides[12]};
  int err = make_head_map(&tx, x, kHP, S, nh, B, xs, kQ);
  if (err == 0) err = make_head_map(&tdy, dy, kHP, S, nh, B, ys, kQ);
  const cuuint64_t bcdims[3] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(S),
                                static_cast<cuuint64_t>(B)};
  const cuuint64_t bbytes[2] = {static_cast<cuuint64_t>(strides[7]) * 2,
                                static_cast<cuuint64_t>(strides[6]) * 2};
  const cuuint64_t cbytes[2] = {static_cast<cuuint64_t>(strides[9]) * 2,
                                static_cast<cuuint64_t>(strides[8]) * 2};
  const cuuint32_t bcbox[3] = {64, kQ, 1};
  if (err == 0 && N != 16) err = make_bf16_map(&tb, Bm, 3, bcdims, bbytes, bcbox);
  if (err == 0 && N != 16) err = make_bf16_map(&tc, Cm, 3, bcdims, cbytes, bcbox);
  if (err != 0) return err;
  BwdParams p;
  p.Bm = static_cast<const __nv_bfloat16*>(Bm); p.Cm = static_cast<const __nv_bfloat16*>(Cm);
  p.b_sb = strides[6]; p.b_ss = strides[7]; p.c_sb = strides[8]; p.c_ss = strides[9];
  p.dt = dt; p.A = A; p.init = init; p.dfinal = dfinal; p.cb = cb; p.ends = ends; p.ld = ld;
  p.stash = stash; p.part = part; p.dAp = dAp; p.dx = dx; p.ddt = ddt; p.dA = dA; p.dBm = dBm;
  p.dCm = dCm; p.dinit = dinit;
  p.dt_sb = strides[3]; p.dt_sh = strides[4]; p.dt_ss = strides[5];
  p.dx_sb = strides[13]; p.dx_sh = strides[14]; p.dx_ss = strides[15];
  p.ddt_sb = strides[16]; p.ddt_sh = strides[17]; p.ddt_ss = strides[18];
  p.B = B; p.nh = nh; p.S = S; p.nc = (S + kQ - 1) / kQ;
  p.seg_chunks = seg_chunks;
  p.n_seg = (p.nc + seg_chunks - 1) / seg_chunks;
  p.group = group;
  p.n_groups = (nh + group - 1) / group;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N == 16) return launch<16>(tx, tdy, tb, tc, p, s);
  return N == 128 ? launch<128>(tx, tdy, tb, tc, p, s) : launch<64>(tx, tdy, tb, tc, p, s);
}

// For N (16, 64 or 128), per kernel (C.B^T, segment ends, fold, in-chunk,
// sums) in turn, four ints: registers a thread, local-memory bytes a
// thread (spills), dynamic shared memory bytes, CTAs that fit on one SM.
// Returns a cudaError_t.
extern "C" int ssd_scan_bwd_wgmma_info(int N, int* out) {
  using namespace repro_torch;
  if (N == 128) return info<128>(out);
  if (N == 64) return info<64>(out);
  if (N == 16) return info<16>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}
