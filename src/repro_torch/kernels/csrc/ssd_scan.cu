// Mamba2 SSD (state-space duality) chunked scan, forward, bf16, for Hopper
// (sm_90a): the wgmma + TMA kernels at hp 64 and N 16, 64 or 128
// (mamba2-2.7b: hp 64, N 128; hymba-1.5b: hp 64, N 16). fp32, and bf16 at
// other (hp, N), go to the FMA kernel in ssd_scan_fma.cu;
// kernels/ssd_scan.py:kernel_path picks.
//
// Replaces: src/repro/kernels/ssd_scan.py, _ssd_kernel / ssd_scan_pallas.
// Per (batch b, head h), with a = dt * A and h_t the [hp, N] state:
//   h_t = exp(a_t) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t.
// Chunk by chunk (64 tokens), with acs the cumulative a from the chunk's start:
//   y_i = sum_{j<=i} (C_i . B_j) exp(acs_i - acs_j) dt_j x_j + exp(acs_i) (C_i . h_prev),
//   h  <- exp(acs_last) h + sum_j exp(acs_last - acs_j) dt_j x_j B_j^T.
//
// Bound on the H100: bytes. At mamba2-2.7b prefill (B 2, nh 80, S 2000)
// the scan must read x (41 MB), B/C (2 MB), dt (1.3 MB) and write y
// (41 MB): 85 MB, 0.025 ms at 3.35 TB/s; its products, with C.B^T shared
// across heads, are ~21 GFLOP, 0.022 ms on the bf16 tensor cores. At
// hymba-1.5b prefill (B 2, nh 50, S 2000, N 16) 52 MB, 0.016 ms.
//
// Design: three launches on the caller's stream.
//  1. ssd_cb_kernel (ssd_common.cuh, shared with the backward; at N 16
//     ssd_cb16_kernel), grid (chunk, b): C.B^T of each 64-token chunk, once
//     for all heads (wgmma m64n64, K = N, fp32 sums), into fp32 scratch
//     [B, nc, 64 x 64] kept in the order of the wgmma accumulator (float4
//     q of thread tid at q*128 + tid), so the scan reads it back coalesced
//     into the same registers. 1 MB at the main shape: it stays in L2.
//  2. ssd_segment_states_kernel, grid (segment, h, b) over every segment
//     but the last: S is cut into segments of whole chunks, and each CTA
//     runs its segment's state update from a zero state, h <- e^{a_last} h
//     + (x o w)^T B (wgmma m64nN, K = 64 tokens, the fp32 [hp, N] state in
//     registers; A = x o w loaded transposed with ldmatrix.trans, scaled by
//     w_j in fp32 and rounded to bf16 (at N 16 a bf16 pair, kXwPair); B =
//     the B tile, MN-major, at N 16
//     the transposed box, K-major), and writes the end state and the
//     segment's total log-decay to scratch.
//  3. ssd_chunk_scan_kernel, grid (segment, h, b): folds the end states of
//     the earlier segments into the caller's initial state (or zeros), then
//     walks its chunks: y = e^{acs} (C h^T) + P x, then the state update as
//     in 2. C h^T is a wgmma of the C tile and h in shared memory; P, the
//     masked decayed scores, is formed in registers from the C.B^T tile
//     (masked BEFORE exp: above the diagonal acs_i - acs_j > 0 and exp
//     overflows) as a register A operand. h and P go in as bf16 pairs, hi =
//     bf16(v) and lo = bf16(v - hi), two products each: rounded once, h
//     made rows where C_i . h cancels read 4-7x the pointwise limit of the
//     bf16 gate (PERF.md). The last segment's CTA writes the final state
//     when it is asked for.
//  The wrapper picks the segment length (kernels/ssd_scan.py:
//  segment_chunks): at mamba2-2.7b prefill 3 segments of 11 chunks, 480
//  scan CTAs, two an SM. Each CTA is one warpgroup. x and B tiles come by
//  TMA into a 2-slot mbarrier ring: one thread issues chunk c+2's copies
//  as soon as chunk c is done with its slot, so the copy of chunk c+1 runs
//  during chunk c. The C tile has one slot, refilled with chunk c+1's as
//  soon as C h^T of chunk c is done. The tensor maps take the caller's
//  strides (the model's [B,S,nh,hp] x and the column slices of the conv
//  output need no copy) and zero-fill rows at or past S; those rows have
//  dt = 0, so they are no-ops, and are never stored. dt ([B,nh,S] view of
//  [B,S,nh], stride nh along S) is read with plain loads one chunk ahead,
//  the C.B^T tile at the start of its chunk (a chunk ahead it costs
//  registers: spills).
//  The cumulative sums, exponentials, the state and every sum stay fp32;
//  only product operands (x o w, a hi + lo pair at N 16; P and h as hi +
//  lo pairs) are bf16.
//  Shared memory: the scan 98 KB (N 128), so two CTAs share an SM.
//  N 16 (hymba-1.5b): the 32-byte rows of B and C do not fit the 128-byte
//  swizzle of the TMA maps and descriptors, so both come in by the
//  threads' 16-byte loads during the chunk before the one that reads them
//  (in the scan past the scores) and are stored transposed, [16][64
//  tokens], into one 2 KB slot each once the earlier chunk is done with it
//  (ssd_common.cuh, the backward's tile path); x keeps its TMA ring. The
//  state update is m64n16k16 with that box as the K-major B operand; C h^T
//  is m64n64k16 with the C box as the MN-major A operand (K = N) and the h
//  pair stored [N][hp] as the MN-major B. The state is 8 registers a
//  thread and the scan 26 KB of shared memory, but the rest of the chunk's
//  registers (206 in all) keep it at two CTAs an SM: held to the 168 of
//  three, it spills. segment_chunks has costs of its own for N 16 (more,
//  shorter segments: 7 chunks each at hymba-1.5b's shapes).
#include "ssd_common.cuh"

namespace repro_torch {
namespace {

// Shared memory from a 1024-byte aligned base (the 128-byte swizzle repeats
// every 8 rows of 128 bytes). Both kernels: a 2-slot TMA ring of x [64
// tokens][64] and, at N >= 64, the B tile [64 tokens][N] (N/64 boxes). At
// N 16 the threads store B (and C) transposed into one slot each
// (ssd_common.cuh), between the chunk that last read it and the next. The
// scan adds one slot for the C tile, at N >= 64 refilled by TMA as soon as
// C h^T of its chunk is done, and h entering the chunk as a bf16 pair hi +
// lo ([hp][N] each, K-major; [N][hp] at N 16).
template <int N, bool kScan> struct Smem {
  static constexpr int kTile = kTileBytes<N>;               // B, C or a plane of h
  static constexpr bool kOwnBC = N == 16;                   // B, C by the threads' loads
  static constexpr int kX = 0;
  static constexpr int kB = kX + kBox;
  static constexpr int kStage = kB + (kOwnBC ? 0 : kTile);  // = TMA bytes of a ring slot
  static constexpr int kB16 = 2 * kStage;                   // N 16: the B slot
  static constexpr int kC = kB16 + (kOwnBC ? kTile : 0);
  static constexpr int kH = kC + (kScan ? kTile : 0);       // h hi, then h lo
  static constexpr int kVec = kH + (kScan ? 2 * kTile : 0);   // dt, acs, w, exp(acs)
  static constexpr int kBar = kVec + 4 * kQ * 4;            // full[2], full_c
  static constexpr int kBytes = kBar + 24 + 1024;           // + alignment slack
  // the B tile of the chunk in ring slot s
  static __device__ __forceinline__ uint32_t b_tile(uint32_t base, int s) {
    return kOwnBC ? base + kB16 : base + s * kStage + kB;
  }
};

struct Params {
  const __nv_bfloat16* Bm;  // [B,S,N] rows of unit stride; read by the N 16 kernels
  const __nv_bfloat16* Cm;
  const float* dt;
  const float* A;
  void* y;
  float* cb;          // [B, nc, 8, 128, 4] (C.B^T in accumulator order)
  float* states;      // [B, nh, n_seg - 1, N/8, 128, 4] end states from zero
  float* seg_decay;   // [B, nh, n_seg - 1] total log-decay of each segment
  const float* init;  // [B, nh, hp, N] or null
  float* final_state; // [B, nh, hp, N] or null
  long long dt_sb, dt_sh, dt_ss, y_sb, y_sh, y_ss, b_sb, b_ss, c_sb, c_ss;
  int B, nh, S, nc, seg_chunks, n_seg;
};

// The A operand of the state update: (x o w)^T, [hp rows][16 tokens] per
// k step, from the swizzled x tile with ldmatrix.trans (lane: matrix
// lane/8, its row lane%8), each element scaled by its token's w in fp32.
__device__ __forceinline__ void xw_fragments(uint32_t (&xa)[4][4], uint32_t sX, const float* sW,
                                             int warp, int lane) {
  const int m = lane / 8, rr = lane % 8, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int j = 16 * kk + 8 * (m / 2) + rr;
    const int chunk16 = 2 * warp + (m % 2);
    ldmatrix_x4_trans(xa[kk], sX + j * 128 + ((chunk16 ^ rr) * 16));
    const float2 w01 = *reinterpret_cast<const float2*>(sW + 16 * kk + 2 * t);
    const float2 w23 = *reinterpret_cast<const float2*>(sW + 16 * kk + 8 + 2 * t);
    xa[kk][0] = scale_bf16x2(xa[kk][0], w01.x, w01.y);
    xa[kk][1] = scale_bf16x2(xa[kk][1], w01.x, w01.y);
    xa[kk][2] = scale_bf16x2(xa[kk][2], w23.x, w23.y);
    xa[kk][3] = scale_bf16x2(xa[kk][3], w23.x, w23.y);
  }
}

// x o w, the state update's A operand: at N 64/128 rounded once to bf16
// (xw_fragments), at N 16 a bf16 pair hi + lo (ssd_common.cuh's
// scaled_t_fragments), as P and h are. Rounded once at N 16, one of
// hymba-1.5b's bf16 A_log gradients landed 1.55x as far from fp32 as the
// plain versions' (PERF.md), past chip_smoke.py's 1.5x gate
template <int N> constexpr bool kXwPair = N == 16;

// st += (x o w)^T B over the chunk's 64 tokens; B tile MN-major in N/64
// boxes, at N 16 the transposed box (K-major, K = tokens)
template <int N>
__device__ __forceinline__ void state_update(float (&st)[N / 2], const uint32_t (&xa)[4][4],
                                             uint32_t sB) {
  if constexpr (N == 16) {
    const uint64_t db = sw128_desc(sB, 16, 1024);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_n16(st, xa[kk], db + 2 * kk, 1);
  } else {
    const uint64_t db = sw128_desc(sB, kBox, 1024);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<N>(st, xa[kk], db + ((kk * 16 * 128) >> 4));
  }
}

// Copies of chunk c's x and (N >= 64) B into ring slot s.
template <int N>
__device__ __forceinline__ void issue_chunk(uint32_t base, uint32_t full, int c, int s,
                                            const CUtensorMap* tx, const CUtensorMap* tb, int h,
                                            int b) {
  using L = Smem<N, false>;
  const uint32_t slot = base + s * L::kStage, bar = full + 8 * s;
  mbar_expect_tx(bar, L::kStage);
  tma_load(slot + L::kX, tx, bar, 0, c * kQ, h, b);
#pragma unroll
  for (int i = 0; i < N / 64; ++i) tma_load(slot + L::kB + i * kBox, tb, bar, 64 * i, c * kQ, b);
}

__device__ __forceinline__ void init_barriers(uint32_t full) {
  if (threadIdx.x == 0) {
    mbar_init(full, 1);
    mbar_init(full + 8, 1);
    mbar_init(full + 16, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// ---- 1. C.B^T per (b, chunk): ssd_cb_kernel<N, false>, at N 16
// ssd_cb16_kernel<false> (ssd_common.cuh) ----

// ---- 2. end state of each segment but the last, from a zero state ----
template <int N>
__global__ void __launch_bounds__(kThreads)
ssd_segment_states_kernel(const __grid_constant__ CUtensorMap tx,
                          const __grid_constant__ CUtensorMap tb, const Params p) {
  using L = Smem<N, false>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_addr(smem_raw));
  float* sDt = reinterpret_cast<float*>(gbase + L::kVec);
  float* sAcs = sDt + kQ;
  float* sW = sAcs + kQ;
  float* sEa = sW + kQ;
  const uint32_t full = base + L::kBar;
  const int seg = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = seg * p.seg_chunks, c1 = min(p.nc, c0 + p.seg_chunks);
  const float A = p.A[h];
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh;
  const __nv_bfloat16* bm = p.Bm + b * p.b_sb;

  init_barriers(full);
  if (tid == 0) {
    issue_chunk<N>(base, full, c0, 0, &tx, &tb, h, b);
    if (c0 + 1 < c1) issue_chunk<N>(base, full, c0 + 1, 1, &tx, &tb, h, b);
  }
  float st[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) st[i] = 0.f;
  float d0 = 0.f, d1 = 0.f, log_decay = 0.f;
  if (warp == 0) load_dt(dtg, p.dt_ss, c0 * kQ, p.S, lane, d0, d1);
  uint4 b_next = make_uint4(0u, 0u, 0u, 0u);   // N 16: B a chunk ahead
  if constexpr (N == 16) b_next = load_tile16(bm, p.b_ss, c0, p.S, tid);

  for (int c = c0; c < c1; ++c) {
    const int s = (c - c0) & 1;
    const uint32_t parity = ((c - c0) >> 1) & 1;
    if constexpr (N == 16) {   // the previous chunk is done with the B slot
      store_tile16(gbase + L::kB16, b_next, tid);
      if (c + 1 < c1) b_next = load_tile16(bm, p.b_ss, c + 1, p.S, tid);
    }
    if (warp == 0) {
      scan_chunk(d0, d1, A, lane, sDt, sAcs, sW, sEa);
      if (c + 1 < c1) load_dt(dtg, p.dt_ss, (c + 1) * kQ, p.S, lane, d0, d1);
    }
    __syncthreads();   // the chunk's vectors
    log_decay += sAcs[kQ - 1];
    const float decay = sEa[kQ - 1];
    mbar_wait_or_trap(full + 8 * s, parity);
    __syncwarp();
    uint32_t xa[4][4], xl[4][4];   // x o w (and at N 16 its lo half)
    if constexpr (kXwPair<N>) {
      scaled_t_fragments(xa, xl, base + s * L::kStage + L::kX, sW, warp, lane);
    } else {
      xw_fragments(xa, base + s * L::kStage + L::kX, sW, warp, lane);
    }
#pragma unroll
    for (int i = 0; i < N / 2; ++i) st[i] *= decay;
    fence_regs(st);
    wgmma_fence();
    state_update<N>(st, xa, L::b_tile(base, s));
    if constexpr (kXwPair<N>) state_update<N>(st, xl, L::b_tile(base, s));
    wgmma_commit();
    wgmma_wait();
    fence_regs(st);
    fence_regs(xa);
    if constexpr (kXwPair<N>) fence_regs(xl);
    __syncthreads();   // every thread is done with the slot and the vectors
    if (tid == 0 && c + 2 < c1) issue_chunk<N>(base, full, c + 2, s, &tx, &tb, h, b);
  }

  const size_t idx = static_cast<size_t>(b * p.nh + h) * (p.n_seg - 1) + seg;
  float4* out = reinterpret_cast<float4*>(p.states) + idx * (N / 8) * kThreads + tid;
#pragma unroll
  for (int q = 0; q < N / 8; ++q)
    out[q * kThreads] = make_float4(st[4 * q], st[4 * q + 1], st[4 * q + 2], st[4 * q + 3]);
  if (tid == 0) p.seg_decay[idx] = log_decay;
}

// ---- 3. the scan, per (segment, h, b) ----
// Per chunk: C h^T (h as a bf16 pair hi + lo, so its rounding is ~2^-16)
// while the scores are formed; P x (P as a bf16 pair, likewise); y stored;
// then the state update with x o w rounded once to bf16 (a pair at N 16).
template <int N>
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_scan_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
                      const __grid_constant__ CUtensorMap tc, const Params p) {
  using L = Smem<N, true>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_addr(smem_raw));
  float* sDt = reinterpret_cast<float*>(gbase + L::kVec);
  float* sAcs = sDt + kQ;
  float* sW = sAcs + kQ;
  float* sEa = sW + kQ;
  const uint32_t sC = base + L::kC, sH = base + L::kH, sHlo = sH + L::kTile;
  const uint32_t full = base + L::kBar, full_c = full + 16;
  const int seg = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int c0 = seg * p.seg_chunks, c1 = min(p.nc, c0 + p.seg_chunks);
  const float A = p.A[h];
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh;
  const float4* cbg = reinterpret_cast<const float4*>(p.cb) + tid;
  const int bh = b * p.nh + h;
  const __nv_bfloat16* bm = p.Bm + b * p.b_sb;
  const __nv_bfloat16* cm = p.Cm + b * p.c_sb;

  // the C tile of chunk c into its slot (N >= 64)
  auto issue_c = [&](int c) {
    mbar_expect_tx(full_c, L::kTile);
#pragma unroll
    for (int i = 0; i < N / 64; ++i) tma_load(sC + i * kBox, &tc, full_c, 64 * i, c * kQ, b);
  };
  init_barriers(full);
  if (tid == 0) {
    issue_chunk<N>(base, full, c0, 0, &tx, &tb, h, b);
    if constexpr (N != 16) issue_c(c0);
    if (c0 + 1 < c1) issue_chunk<N>(base, full, c0 + 1, 1, &tx, &tb, h, b);
  }
  // N 16: chunk c0's B and C into their slots (published by the loop's
  // first barrier); later chunks' are loaded once the scores are formed
  if constexpr (N == 16) {
    store_tile16(gbase + L::kB16, load_tile16(bm, p.b_ss, c0, p.S, tid), tid);
    store_tile16(gbase + L::kC, load_tile16(cm, p.c_ss, c0, p.S, tid), tid);
  }

  // The state entering the segment, in the accumulator layout: st[4q + r]
  // is row p = 16 warp + g + 8 (r / 2), column n = 8q + 2t + r % 2. The
  // caller's initial state (or 0), then h <- e^{ld_s} h + E_s over the
  // earlier segments s.
  float st[N / 2];
#pragma unroll
  for (int q = 0; q < N / 8; ++q) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float2 v = make_float2(0.f, 0.f);
      if (p.init != nullptr)
        v = *reinterpret_cast<const float2*>(
            p.init + (static_cast<size_t>(bh) * kHP + 16 * warp + g + 8 * half) * N + 8 * q + 2 * t);
      st[4 * q + 2 * half] = v.x;
      st[4 * q + 2 * half + 1] = v.y;
    }
  }
  for (int s = 0; s < seg; ++s) {
    const size_t idx = static_cast<size_t>(bh) * (p.n_seg - 1) + s;
    const float dec = expf(p.seg_decay[idx]);
    const float4* e = reinterpret_cast<const float4*>(p.states) + idx * (N / 8) * kThreads + tid;
#pragma unroll
    for (int q = 0; q < N / 8; ++q) {
      const float4 v = e[q * kThreads];
      st[4 * q] = fmaf(dec, st[4 * q], v.x);
      st[4 * q + 1] = fmaf(dec, st[4 * q + 1], v.y);
      st[4 * q + 2] = fmaf(dec, st[4 * q + 2], v.z);
      st[4 * q + 3] = fmaf(dec, st[4 * q + 3], v.w);
    }
  }
  // h as hi = bf16(h) and lo = bf16(h - hi) into sH, the B operands of
  // C h^T: K-major [hp rows][N], at N 16 MN-major [N rows][hp]
  auto store_h = [&]() {
#pragma unroll
    for (int q = 0; q < N / 8; ++q)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = 16 * warp + g + 8 * half, col = 8 * q + 2 * t;
        uint32_t hi, lo;
        split_bf16x2(st[4 * q + 2 * half], st[4 * q + 2 * half + 1], hi, lo);
        st_pair<N>(gbase + L::kH, row, col, hi);
        st_pair<N>(gbase + L::kH + L::kTile, row, col, lo);
      }
    fence_async_smem();   // visible to the next wgmma after the next barrier
  };
  store_h();

  float d0 = 0.f, d1 = 0.f;
  if (warp == 0) load_dt(dtg, p.dt_ss, c0 * kQ, p.S, lane, d0, d1);
  float cbf[32];   // C.B^T of the chunk in the accumulator layout: rows i, columns j
  auto load_cb = [&](int c) {
    const float4* src = cbg + static_cast<size_t>(b * p.nc + c) * 8 * kThreads;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float4 v = __ldg(src + q * kThreads);
      cbf[4 * q] = v.x;
      cbf[4 * q + 1] = v.y;
      cbf[4 * q + 2] = v.z;
      cbf[4 * q + 3] = v.w;
    }
  };

  __nv_bfloat16* yg = static_cast<__nv_bfloat16*>(p.y) + b * p.y_sb + h * p.y_sh;
  const int i0 = 16 * warp + g, i1 = i0 + 8;   // the thread's rows of y and of the scores
  for (int c = c0; c < c1; ++c) {
    const int s = (c - c0) & 1;
    const uint32_t slot = base + s * L::kStage;
    const int r0 = c * kQ;
    load_cb(c);   // in flight during the scan of dt and the barrier
    if (warp == 0) {
      scan_chunk(d0, d1, A, lane, sDt, sAcs, sW, sEa);
      if (c + 1 < c1) load_dt(dtg, p.dt_ss, (c + 1) * kQ, p.S, lane, d0, d1);
    }
    __syncthreads();   // the chunk's vectors; sH of the state entering it; N 16: B, C
    if constexpr (N != 16) {
      mbar_wait_or_trap(full_c, (c - c0) & 1);
      __syncwarp();
    }

    // y = C h^T over N, while the scores are formed
    float y[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) y[i] = 0.f;
    if constexpr (N == 16) {   // C^T [n][i] and h^T [n][p], both MN-major, K = 16
      const uint64_t dc = sw128_desc(sC, kBox, 1024);
      fence_regs(y);
      wgmma_fence();
      wgmma_ss_mn_n64(y, dc, sw128_desc(sH, kBox, 1024), 0);
      wgmma_ss_mn_n64(y, dc, sw128_desc(sHlo, kBox, 1024), 1);
      wgmma_commit();
    } else {
      const uint64_t dc = sw128_desc(sC, 16, 1024);
      const uint64_t dh = sw128_desc(sH, 16, 1024), dl = sw128_desc(sHlo, 16, 1024);
      fence_regs(y);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        const uint32_t step = ((kk / 4) * kBox + (kk % 4) * 32) >> 4;
        wgmma_ss_n64(y, dc + step, dh + step, kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        const uint32_t step = ((kk / 4) * kBox + (kk % 4) * 32) >> 4;
        wgmma_ss_n64(y, dc + step, dl + step, 1);
      }
      wgmma_commit();
    }

    // P_ij = C_i.B_j exp(acs_i - acs_j) dt_j for j <= i, as bf16 pairs of A
    // fragments (pa[kk][0]: row i0, j = 16kk + 2t..+1; [1] row i1; [2], [3] j + 8)
    uint32_t pa[4][4], pl[4][4];
    {
      const float acs_i[2] = {sAcs[i0], sAcs[i1]};
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
        const float2 acs_j = *reinterpret_cast<const float2*>(sAcs + 8 * jb + 2 * t);
        const float2 dt_j = *reinterpret_cast<const float2*>(sDt + 8 * jb + 2 * t);
        float v[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = r < 2 ? i0 : i1;
          const int j = 8 * jb + 2 * t + (r & 1);
          const float aj = (r & 1) ? acs_j.y : acs_j.x;
          const float dj = (r & 1) ? dt_j.y : dt_j.x;
          // mask before exp: exp2(-inf) = 0
          const float e = j <= i ? (acs_i[r / 2] - aj) * kLog2e : -INFINITY;
          v[r] = cbf[4 * jb + r] * fast_exp2(e) * dj;
        }
        split_bf16x2(v[0], v[1], pa[jb / 2][2 * (jb % 2)], pl[jb / 2][2 * (jb % 2)]);
        split_bf16x2(v[2], v[3], pa[jb / 2][2 * (jb % 2) + 1], pl[jb / 2][2 * (jb % 2) + 1]);
      }
    }
    // N 16: chunk c+1's B and C, in flight until the chunk's last barrier
    // (loaded here, past the scores, where registers are free)
    uint4 b_next = make_uint4(0u, 0u, 0u, 0u), c_next = b_next;
    if (N == 16 && c + 1 < c1) {
      b_next = load_tile16(bm, p.b_ss, c + 1, p.S, tid);
      c_next = load_tile16(cm, p.c_ss, c + 1, p.S, tid);
    }
    const float ea0 = sEa[i0], ea1 = sEa[i1];
    wgmma_wait();
    fence_regs(y);
    if constexpr (N != 16) {   // (N 16 refills the C slot after the chunk's last barrier)
      __syncthreads();   // every warp is done with the C tile: chunk c+1's may come in
      if (tid == 0 && c + 1 < c1) issue_c(c + 1);
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      y[4 * q] *= ea0;
      y[4 * q + 1] *= ea0;
      y[4 * q + 2] *= ea1;
      y[4 * q + 3] *= ea1;
    }

    // y += P x, x MN-major
    mbar_wait_or_trap(full + 8 * s, ((c - c0) >> 1) & 1);
    __syncwarp();
    fence_regs(y);
    wgmma_fence();
    {
      const uint64_t dx = sw128_desc(slot + L::kX, kBox, 1024);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs_n64(y, pa[kk], dx + ((kk * 16 * 128) >> 4), 1);
        wgmma_rs_n64(y, pl[kk], dx + ((kk * 16 * 128) >> 4), 1);
      }
      wgmma_commit();
    }
    // meanwhile: the A operand of the state update, and the decay of the state
    uint32_t xa[4][4], xl[4][4];
    if constexpr (kXwPair<N>) {
      scaled_t_fragments(xa, xl, slot + L::kX, sW, warp, lane);
    } else {
      xw_fragments(xa, slot + L::kX, sW, warp, lane);
    }
    const float decay = sEa[kQ - 1];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) st[i] *= decay;
    wgmma_wait();
    fence_regs(y);
    fence_regs(pa);
    fence_regs(pl);

    // h <- decay h + (x o w)^T B, while y is stored (rows at or past S are not)
    fence_regs(st);
    wgmma_fence();
    state_update<N>(st, xa, L::b_tile(base, s));
    if constexpr (kXwPair<N>) state_update<N>(st, xl, L::b_tile(base, s));
    wgmma_commit();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + (half ? i1 : i0);
      if (row >= p.S) continue;
      __nv_bfloat16* yr = yg + row * p.y_ss + 2 * t;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        *reinterpret_cast<__nv_bfloat162*>(yr + 8 * q) =
            __floats2bfloat162_rn(y[4 * q + 2 * half], y[4 * q + 2 * half + 1]);
    }
    wgmma_wait();
    fence_regs(st);
    fence_regs(xa);
    if constexpr (kXwPair<N>) fence_regs(xl);
    __syncthreads();   // every thread is done with the slot, sH and the vectors
    if (tid == 0 && c + 2 < c1) issue_chunk<N>(base, full, c + 2, s, &tx, &tb, h, b);
    if (c + 1 < c1) {
      store_h();
      if constexpr (N == 16) {   // and the B and C slots
        store_tile16(gbase + L::kB16, b_next, tid);
        store_tile16(gbase + L::kC, c_next, tid);
      }
    }
  }

  if (p.final_state != nullptr && seg == p.n_seg - 1) {
#pragma unroll
    for (int q = 0; q < N / 8; ++q)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(p.final_state +
                                   (static_cast<size_t>(bh) * kHP + 16 * warp + g + 8 * half) * N +
                                   8 * q + 2 * t) =
            make_float2(st[4 * q + 2 * half], st[4 * q + 2 * half + 1]);
  }
}

template <int N> int set_smem_limits() {
  cudaError_t e = cudaSuccess;
  if constexpr (N != 16)
    e = cudaFuncSetAttribute(ssd_cb_kernel<N, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             cb_smem_bytes<N>());
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_segment_states_kernel<N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<N, false>::kBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_chunk_scan_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Smem<N, true>::kBytes);
  return static_cast<int>(e);
}

template <int N>
int launch(const CUtensorMap& tx, const CUtensorMap& tb, const CUtensorMap& tc, const Params& p,
           cudaStream_t stream) {
  int err = set_smem_limits<N>();
  if (err != 0) return err;
  if constexpr (N == 16) {
    ssd_cb16_kernel<false><<<dim3(p.nc, p.B), kThreads, kCb16Smem, stream>>>(
        p.Bm, p.b_sb, p.b_ss, p.Cm, p.c_sb, p.c_ss, p.cb, p.S, p.nc);
  } else {
    ssd_cb_kernel<N, false><<<dim3(p.nc, p.B), kThreads, cb_smem_bytes<N>(), stream>>>(tb, tc,
                                                                                      p.cb, p.nc);
  }
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  if (p.n_seg > 1) {
    ssd_segment_states_kernel<N><<<dim3(p.n_seg - 1, p.nh, p.B), kThreads,
                                   Smem<N, false>::kBytes, stream>>>(tx, tb, p);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  ssd_chunk_scan_kernel<N><<<dim3(p.n_seg, p.nh, p.B), kThreads, Smem<N, true>::kBytes, stream>>>(
      tx, tb, tc, p);
  return static_cast<int>(cudaGetLastError());
}

template <int N> int info(int* out) {
  int e = set_smem_limits<N>();
  if (!e) {
    if constexpr (N == 16) e = kernel_info(ssd_cb16_kernel<false>, kThreads, kCb16Smem, out);
    else e = kernel_info(ssd_cb_kernel<N, false>, kThreads, cb_smem_bytes<N>(), out);
  }
  if (!e) e = kernel_info(ssd_segment_states_kernel<N>, kThreads, Smem<N, false>::kBytes, out + 4);
  if (!e) e = kernel_info(ssd_chunk_scan_kernel<N>, kThreads, Smem<N, true>::kBytes, out + 8);
  return e;
}

}  // namespace
}  // namespace repro_torch

// bf16 only, hp 64, N 16, 64 or 128. x, y: [B, nh, S, 64]; dt: [B, nh, S]
// fp32; A: [nh] fp32 contiguous; Bm, Cm: [B, S, N]. `strides` holds 13
// element strides: x (batch, head, seq), dt (batch, head, seq), Bm (batch,
// seq), Cm (batch, seq), y (batch, head, seq); x, Bm, Cm and y have a unit
// last stride, and x, Bm, Cm strides that are multiples of 8 and 16-byte
// aligned bases. Scratch from the caller: cb [B, nc*64*64] fp32, states
// [B, nh, n_seg-1, 64*N] fp32 and seg_decay [B, nh, n_seg-1] fp32, with
// nc = ceil(S / 64) and n_seg = ceil(nc / seg_chunks). init and
// final_state ([B, nh, 64, N] fp32, contiguous) may be null. Returns the
// cudaError_t of the launches (0 on success), or 100000 plus the CUresult of
// a tensor map the driver refused.
extern "C" int ssd_scan_wgmma_launch(const void* x, const float* dt, const float* A, const void* Bm,
                                     const void* Cm, void* y, float* cb, float* states,
                                     float* seg_decay, const float* init, float* final_state,
                                     const long long* strides, int B, int nh, int S, int N,
                                     int seg_chunks, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || nh <= 0 || S <= 0 || seg_chunks <= 0 || (N != 16 && N != 64 && N != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t xdims[4] = {static_cast<cuuint64_t>(kHP), static_cast<cuuint64_t>(S),
                               static_cast<cuuint64_t>(nh), static_cast<cuuint64_t>(B)};
  const cuuint64_t xbytes[3] = {static_cast<cuuint64_t>(strides[2]) * 2,
                                static_cast<cuuint64_t>(strides[1]) * 2,
                                static_cast<cuuint64_t>(strides[0]) * 2};
  const cuuint32_t xbox[4] = {64, kQ, 1, 1};
  const cuuint64_t bcdims[3] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(S),
                                static_cast<cuuint64_t>(B)};
  const cuuint64_t bbytes[2] = {static_cast<cuuint64_t>(strides[7]) * 2,
                                static_cast<cuuint64_t>(strides[6]) * 2};
  const cuuint64_t cbytes[2] = {static_cast<cuuint64_t>(strides[9]) * 2,
                                static_cast<cuuint64_t>(strides[8]) * 2};
  const cuuint32_t bcbox[3] = {64, kQ, 1};
  CUtensorMap tx, tb{}, tc{};   // tb, tc: N >= 64 only
  int err = make_bf16_map(&tx, x, 4, xdims, xbytes, xbox);
  if (err == 0 && N != 16) err = make_bf16_map(&tb, Bm, 3, bcdims, bbytes, bcbox);
  if (err == 0 && N != 16) err = make_bf16_map(&tc, Cm, 3, bcdims, cbytes, bcbox);
  if (err != 0) return err;
  Params p;
  p.Bm = static_cast<const __nv_bfloat16*>(Bm);
  p.Cm = static_cast<const __nv_bfloat16*>(Cm);
  p.dt = dt;
  p.A = A;
  p.y = y;
  p.cb = cb;
  p.states = states;
  p.seg_decay = seg_decay;
  p.init = init;
  p.final_state = final_state;
  p.dt_sb = strides[3]; p.dt_sh = strides[4]; p.dt_ss = strides[5];
  p.b_sb = strides[6]; p.b_ss = strides[7]; p.c_sb = strides[8]; p.c_ss = strides[9];
  p.y_sb = strides[10]; p.y_sh = strides[11]; p.y_ss = strides[12];
  p.B = B;
  p.nh = nh;
  p.S = S;
  p.nc = (S + kQ - 1) / kQ;
  p.seg_chunks = seg_chunks;
  p.n_seg = (p.nc + seg_chunks - 1) / seg_chunks;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N == 16) return launch<16>(tx, tb, tc, p, s);
  return N == 128 ? launch<128>(tx, tb, tc, p, s) : launch<64>(tx, tb, tc, p, s);
}

// For N (16, 64 or 128), per kernel (C.B^T, segment states, scan) in turn,
// four ints: registers a thread, local-memory bytes a thread (spills),
// dynamic shared memory bytes, CTAs that fit on one SM. Returns a
// cudaError_t.
extern "C" int ssd_scan_wgmma_info(int N, int* out) {
  using namespace repro_torch;
  if (N == 128) return info<128>(out);
  if (N == 64) return info<64>(out);
  if (N == 16) return info<16>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}
