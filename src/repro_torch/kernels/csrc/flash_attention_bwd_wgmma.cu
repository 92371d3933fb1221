// GQA flash attention, causal, windowed or neither, backward, for Hopper
// (sm_90a): the bf16 kernels at head_dim 64, 80, 128 and 192, built on
// wgmma and TMA. fp32 and bf16
// at head_dim 32 go to the mma.sync / FMA kernels of flash_attention_bwd.cu;
// kernels/flash_attention.py picks by (dtype, head_dim).
//
// The TPU kernel (src/repro/kernels/flash_attention.py, flash_attention /
// _flash_kernel) is forward only; this is the gradient of the port's
// forward, the math of kernels/ref.py flash_attention_bwd_ref (FA2's):
//   P  = exp2(q k^T * scale * log2(e) - LSE)     recomputed, never stored
//   dV = P^T dO          dS = P * (dO V^T - D)
//   dQ = dS K * scale    dK = dS^T Q * scale
// with dK and dV summed over the nh / nkv query heads of each kv head. LSE
// (log2 units) comes from the forward kernels, D = rowsum(dO * O) from the
// launch in flash_attention_bwd.cu; both fp32 [B, nh, ld].
//
// Bound on the H100: operations, five products of 2*B*nh*hd*S(S+1)/2 flops
// each over the causal pairs (2*B*nh*hd*S^2 without the causal mask) (S = q k^T and dP = dO V^T are each computed
// twice, once per kernel below: seven products in all), bf16 on the tensor
// cores at 989 TFLOP/s.
//
// Design (after FlashAttention-3's backward, without its atomics: each
// gradient element is written by one CTA, so two runs give the same bits):
//  * dK/dV: a persistent grid, one CTA of three warpgroups per SM, walks
//    work items (kv tile of 128 rows, kv head, batch, slice of the GQA
//    group), kv tile 0 (the most causal q tiles) first, in a snake order
//    across the CTAs. A slice is `group / slices` of the kv head's query
//    heads; with more than one slice each writes fp32 partial dK and dV,
//    summed in slice order by flash_bwd_sum_kernel. Slices give the card
//    enough items (yi-6b at S 2048: 64 kv items, 256 with 4 slices).
//    The kv tile's K and V are loaded once per item. The producer
//    warpgroup's one thread streams q tiles of 64 rows (Q, dO, their LSE
//    and D rows) through a ring of kStages slots with full and empty
//    mbarriers that runs on across items. Each consumer warpgroup owns 64
//    kv rows and, per q tile, issues S^T = K Q^T and dP^T = V dO^T (both
//    operands in shared memory, K-major), forms P^T and dS^T in registers
//    (masked before exp2: masked entries give exact zeros) and issues
//    dV += P^T dO and dK += dS^T Q with P^T and dS^T as register A
//    fragments and dO, Q MN-major: the forward's p v pattern.
//  * dQ: the same shape over (q tile of 128 rows, head, batch), heaviest
//    causal q tile first. Q and dO are loaded once per item; K and V tiles
//    of 64 rows go through the ring. Per tile S = Q K^T, dP = dO V^T, then
//    dQ += dS K with K MN-major.
//  * Tensor maps are 4-D (hd, S, head, batch) over the caller's strides,
//    so the model's [B,S,nh,hd] views need no copy; TMA zero-fills rows at
//    or past S. Tiles are hd/64 boxes of [rows][64 columns], 128-byte
//    swizzle. LSE and D rows come by bulk copies (their rows are padded to
//    `ld`, a multiple of 128).
//  * hd 80 (hubert-xlarge), as the forward: two boxes, columns 80-127
//    zero-filled by TMA in shared memory (the maps declare hd 80 over the
//    caller's strides). The products over hd (S^T, dP^T, S, dP) run over
//    its five k16 slabs; those with hd as N (dV, dK, dQ) at the padded
//    width 128, whose columns past 80 sum zeros and are never stored.
//    Non-causal items walk every q (dK/dV) or kv (dQ) tile.
//  * hd 192 (nemotron-4-340b): a consumer holding dK and dV at N 192
//    (96 + 96 fp32) beside S^T and dP^T (32 + 32) needs 256 registers
//    before addresses, past the 232 below. So each kv tile is two dK/dV
//    items (`kinds`): one recomputes S^T and accumulates dV = P^T dO, the
//    other computes S^T and dP^T and accumulates dK = dS^T Q, each in one
//    accumulator of 96 (176 registers in all). That is five products a
//    (kv tile, q tile) where the fused item does four, where splitting
//    hd's columns instead would take six. The tiles do not change; three
//    boxes a row, the rings two slots deep in both kernels (dK/dV: K, V
//    96 KB + 2 x 48.5 KB; dQ: Q, dO 96 KB + 2 x 48 KB), and the products
//    with hd as N are one wgmma.m64n192k16 per 16 rows.
//  * setmaxnreg gives the producer's registers to the consumers: 32 and
//    232 a thread from the 168 of the launch (the producer's item loops
//    spill at 24; what it frees at 32, 136 x 128, covers 64 more for
//    each of 256 consumer threads, not the 72 that 240 would take).
//  * Every mbarrier wait traps after ~2^26 spins, so a copy that never
//    lands shows as a launch error, not a hang.
// The mbarrier, TMA, descriptor and wgmma helpers live in hopper.cuh.
#include <math.h>

#include "hopper.cuh"

namespace repro_torch {
namespace {

constexpr int kBoxCols = 64;              // bf16 columns in one 128-byte swizzle span
constexpr int kConsumers = 256;           // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;      // and one producer warpgroup
constexpr float kLog2e = 1.4426950408889634f;

// ring slots of both kernels: 3, or 2 at hd 192 (three boxes a row)
__host__ __device__ constexpr int ring_stages(int hd) { return hd > 128 ? 2 : 3; }
// dK/dV items a kv tile: 1 (dK and dV together), or 2 at hd 192 (dV, dK)
__host__ __device__ constexpr int dkdv_kinds(int hd) { return hd > 128 ? 2 : 1; }

// dK/dV: kv rows of an item (64 per consumer warpgroup), q rows of a ring tile
constexpr int kKvRows = 128;
constexpr int kQRows = 64;
// dQ: q rows of an item, kv rows of a ring tile
constexpr int kDqRows = 128;
constexpr int kDqKvRows = 64;

// Shared memory of the dK/dV kernel, from a 1024-byte aligned base: K, V
// (one tile each), the ring's Q and dO tiles, its LSE and D rows, barriers.
template <int HD> struct DkdvSmem {
  static_assert(HD % 16 == 0 && HD <= 192, "head dims of whole k16 slabs, at most three boxes");
  static constexpr int kStages = ring_stages(HD);
  static constexpr int kBoxes = (HD + kBoxCols - 1) / kBoxCols;   // hd 80: two, zero-filled past 80
  static constexpr int kCols = kBoxes * kBoxCols;   // the padded width of the N = hd products
  static constexpr int kKvBox = kKvRows * 128;   // [128 rows][64 columns] bf16
  static constexpr int kQBox = kQRows * 128;     // [64 rows][64 columns]
  static constexpr int kKvTile = kBoxes * kKvBox;
  static constexpr int kQTile = kBoxes * kQBox;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKvTile;
  static constexpr int kQ = kV + kKvTile;
  static constexpr int kDO = kQ + kStages * kQTile;
  static constexpr int kL = kDO + kStages * kQTile;
  static constexpr int kD = kL + kStages * kQRows * 4;
  static constexpr int kBar = kD + kStages * kQRows * 4;   // kv_full, kv_empty, full[], empty[]
  static constexpr int kBytes = kBar + 8 * (2 + 2 * kStages) + 1024;   // + alignment slack
  static_assert(kBytes <= 232448, "more shared memory than a block may have");
};

// Shared memory of the dQ kernel: Q, dO (one tile each), the ring's K and V
// tiles, barriers.
template <int HD> struct DqSmem {
  static_assert(HD % 16 == 0 && HD <= 192, "head dims of whole k16 slabs, at most three boxes");
  static constexpr int kStages = ring_stages(HD);
  static constexpr int kBoxes = (HD + kBoxCols - 1) / kBoxCols;
  static constexpr int kCols = kBoxes * kBoxCols;
  static constexpr int kQBox = kDqRows * 128;
  static constexpr int kKvBox = kDqKvRows * 128;
  static constexpr int kQTile = kBoxes * kQBox;
  static constexpr int kKvTile = kBoxes * kKvBox;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kQTile;
  static constexpr int kK = kDO + kQTile;
  static constexpr int kV = kK + kStages * kKvTile;
  static constexpr int kBar = kV + kStages * kKvTile;      // q_full, q_empty, full[], empty[]
  static constexpr int kBytes = kBar + 8 * (2 + 2 * kStages) + 1024;
  static_assert(kBytes <= 232448, "more shared memory than a block may have");
};

struct Params {
  const float* lse;     // [B, nh, ld], log2 units
  const float* delta;   // [B, nh, ld], rowsum(dO * O)
  void *dq, *dk, *dv;
  float* parts;         // [2][slices][B][nkv][S][HD] fp32 partial dK, dV (slices > 1)
  long long dq_s[3], dk_s[3], dv_s[3];   // (batch, head, seq) element strides
  int B, nh, nkv, S, causal, window, ld, slices, kinds;
  int n_kv_items, n_q_tiles, n_dq_items, n_dq_tiles;
  float scale, scale_log2;
};

// The snake order of the forward: item `r` of this CTA's share is
// r * G + c, or r * G + G - 1 - c on odd rounds.
__device__ __forceinline__ int snake(int r) {
  const int G = gridDim.x, c = blockIdx.x;
  return r * G + ((r & 1) ? G - 1 - c : c);
}

__device__ __forceinline__ bool live(const Params& p, int q_row, int k_row) {
  bool ok = q_row < p.S && k_row < p.S;
  if (p.causal) ok = ok && k_row <= q_row;
  if (p.window > 0) ok = ok && k_row > q_row - p.window;
  return ok;
}

// a [64 x 64] fp32 accumulator as the four bf16 A fragments (k = its 64
// columns, 16 at a time) of the next product
__device__ __forceinline__ void to_a_frags(const float (&d)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(d[8 * kk], d[8 * kk + 1]);       // row g, k 2t..2t+1
    a[kk][1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);   // row g+8
    a[kk][2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);   // row g, k 8+2t..
    a[kk][3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);   // row g+8, k 8+2t..
  }
}

// ---- dK / dV ---------------------------------------------------------------

// A dK/dV work item: kv rows [k0, k0 + 128) of kv head hk, query heads
// [h0, h1) (one slice of the group), and the q tiles they attend from;
// with two kinds a tile (hd 192), `kind` 0 accumulates dV, 1 dK.
struct KvItem {
  int k0, hk, b, slice, kind, h0, h1, qt_begin, qt_end;
};

__device__ __forceinline__ bool kv_item_of(const Params& p, int r, KvItem& it) {
  const int idx = snake(r);
  if (idx >= p.n_kv_items) return false;
  const int per_tile = p.nkv * p.B * p.slices * p.kinds;
  int rest = idx % per_tile;
  it.k0 = (idx / per_tile) * kKvRows;   // kv tile 0 first: the most causal q tiles
  it.kind = rest % p.kinds;             // a tile's two kinds on neighbouring CTAs
  rest /= p.kinds;
  it.slice = rest % p.slices;
  rest /= p.slices;
  it.hk = rest % p.nkv;
  it.b = rest / p.nkv;
  const int group = p.nh / p.nkv, per_slice = group / p.slices;
  it.h0 = it.hk * group + it.slice * per_slice;
  it.h1 = it.h0 + per_slice;
  it.qt_begin = p.causal ? it.k0 / kQRows : 0;
  it.qt_end = p.window > 0
                  ? min(p.n_q_tiles, (it.k0 + kKvRows - 1 + p.window - 1) / kQRows + 1)
                  : p.n_q_tiles;
  return true;
}

// Accumulator layout of wgmma.m64nNk16 (fp32): thread (warp w of the
// warpgroup, lane g*4 + t) holds, for each 8-column block j, d[4j+0..1] at
// row 16w + g, columns 8j + 2t + {0,1}, and d[4j+2..3] at row 16w + g + 8.
// Here rows are kv rows and columns q rows (the products are transposed).
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                      const Params p) {
  using L = DkdvSmem<HD>;
  constexpr int HDP = L::kCols, kStages = L::kStages;
  // accumulators a consumer thread holds: dV and dK, or the item's one
  constexpr bool kSplit = dkdv_kinds(HD) > 1;
  constexpr int kAcc = kSplit ? 1 : 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t sK = base + L::kK, sV = base + L::kV, sQ = base + L::kQ, sDO = base + L::kDO;
  const float* const sL = reinterpret_cast<const float*>(gbase + L::kL);
  const float* const sD = reinterpret_cast<const float*>(gbase + L::kD);
  const uint32_t kv_full = base + L::kBar, kv_empty = kv_full + 8;
  const uint32_t full = kv_empty + 8, empty = full + 8 * kStages;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, kConsumers);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 32;\n" ::: "memory");
    if (threadIdx.x == kConsumers) {
      int stage = 0;
      uint32_t phase = 0;
      KvItem it{};
      for (int r = 0; kv_item_of(p, r, it); ++r) {
        // K and V go in once every consumer is done with the last item's
        if (r > 0) mbar_wait_or_trap(kv_empty, (r - 1) & 1);
        mbar_expect_tx(kv_full, 2 * L::kKvTile);
        for (int c = 0; c < L::kBoxes; ++c) {
          tma_load(sK + c * L::kKvBox, &tk, kv_full, c * kBoxCols, it.k0, it.hk, it.b);
          tma_load(sV + c * L::kKvBox, &tv, kv_full, c * kBoxCols, it.k0, it.hk, it.b);
        }
        for (int h = it.h0; h < it.h1; ++h) {
          const long long row0 = (static_cast<long long>(it.b) * p.nh + h) * p.ld;
          for (int qt = it.qt_begin; qt < it.qt_end; ++qt) {
            const uint32_t bar = full + 8 * stage;
            mbar_wait_or_trap(empty + 8 * stage, phase ^ 1);
            mbar_expect_tx(bar, 2 * L::kQTile + 2 * kQRows * 4);
            for (int c = 0; c < L::kBoxes; ++c) {
              tma_load(sQ + stage * L::kQTile + c * L::kQBox, &tq, bar, c * kBoxCols, qt * kQRows,
                       h, it.b);
              tma_load(sDO + stage * L::kQTile + c * L::kQBox, &tdo, bar, c * kBoxCols,
                       qt * kQRows, h, it.b);
            }
            bulk_load(base + L::kL + stage * kQRows * 4, p.lse + row0 + qt * kQRows, kQRows * 4,
                      bar);
            bulk_load(base + L::kD + stage * kQRows * 4, p.delta + row0 + qt * kQRows,
                      kQRows * 4, bar);
            if (++stage == kStages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 kv rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int row_in = wg * 64 + warp * 16 + lane / 4;   // the thread's kv rows: k0 + row_in (+ 8)
    const int col0 = 2 * (lane % 4);                      // q column of st[0] in a tile
    const float sc = p.scale_log2;

    // acc[0] dV and acc[1] dK, or (kSplit) acc[0] the item's kind's;
    // columns past HD sum zeros, never stored
    float acc[kAcc][HDP / 2];
    float st[32], dpt[32];   // S^T and dP^T of one q tile, then P^T and dS^T
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    uint32_t fr[kAcc][4][4];   // P^T and dS^T (or the kind's one) as A fragments

    const uint64_t dK = sw128_desc(sK + wg * 64 * 128, 16, 1024);
    const uint64_t dV = sw128_desc(sV + wg * 64 * 128, 16, 1024);
    auto wait_full = [&](uint32_t bar, uint32_t parity) {
      mbar_wait_or_trap(bar, parity);
      __syncwarp();   // the spin may leave lanes apart; wgmma wants the warp converged
    };

    int stage = 0;
    uint32_t phase = 0;
    KvItem it{};
    for (int r = 0; kv_item_of(p, r, it); ++r) {
#pragma unroll
      for (int a = 0; a < kAcc; ++a)
#pragma unroll
        for (int i = 0; i < HDP / 2; ++i) acc[a][i] = 0.f;
      // whether accumulator a is dK (else dV), and whether dP^T is needed
      auto is_dk = [&](int a) { return kSplit ? it.kind == 1 : a == 1; };
      const bool need_dp = !kSplit || it.kind == 1;
      wait_full(kv_full, r & 1);
      const int n_tiles = (it.h1 - it.h0) * (it.qt_end - it.qt_begin);
      for (int i = 0; i < n_tiles; ++i) {
        const int q0 = (it.qt_begin + i % (it.qt_end - it.qt_begin)) * kQRows;
        const uint32_t q_s = sQ + stage * L::kQTile, do_s = sDO + stage * L::kQTile;
        wait_full(full + 8 * stage, phase);
        // S^T = K Q^T and dP^T = V dO^T over hd, 16 columns per wgmma
        const uint64_t dq_k = sw128_desc(q_s, 16, 1024), ddo_k = sw128_desc(do_s, 16, 1024);
        fence_regs(st);
        fence_regs(dpt);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t a = ((kk / 4) * L::kKvBox + (kk % 4) * 32) >> 4;
          const uint32_t b = ((kk / 4) * L::kQBox + (kk % 4) * 32) >> 4;
          wgmma_ss_n64(st, dK + a, dq_k + b, kk > 0);
        }
        if (need_dp) {
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {
            const uint32_t a = ((kk / 4) * L::kKvBox + (kk % 4) * 32) >> 4;
            const uint32_t b = ((kk / 4) * L::kQBox + (kk % 4) * 32) >> 4;
            wgmma_ss_n64(dpt, dV + a, ddo_k + b, kk > 0);
          }
        }
        wgmma_commit();
        wgmma_wait();
        fence_regs(st);
        fence_regs(dpt);

        // P^T = exp2(S^T * scale_log2 - LSE[q]), dS^T = P^T (dP^T - D[q]);
        // masked entries (only on tiles that straddle the diagonal, the
        // window's edge or S) are exact zeros
        const float* lse = sL + stage * kQRows;
        const float* dd = sD + stage * kQRows;
        const bool edge = q0 + kQRows > p.S || it.k0 + kKvRows > p.S ||
                          (p.causal && it.k0 + kKvRows - 1 > q0) ||
                          (p.window > 0 && q0 + kQRows - 1 - it.k0 >= p.window);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = j * 8 + col0 + (e & 1);
            float pv = fast_exp2(fmaf(st[4 * j + e], sc, -lse[c]));
            if (edge && !live(p, q0 + c, it.k0 + row_in + (e / 2) * 8)) pv = 0.f;
            st[4 * j + e] = pv;
            if (need_dp) dpt[4 * j + e] = pv * (dpt[4 * j + e] - dd[c]);
          }
        }
        if (kSplit && it.kind == 1) {
          to_a_frags(dpt, fr[0]);
        } else {
          to_a_frags(st, fr[0]);
        }
        if constexpr (!kSplit) to_a_frags(dpt, fr[1]);

        // dV += P^T dO and dK += dS^T Q, 16 q rows per wgmma, dO and Q MN-major
        const uint64_t ddo_m = sw128_desc(do_s, L::kQBox, 1024);
        const uint64_t dq_m = sw128_desc(q_s, L::kQBox, 1024);
#pragma unroll
        for (int a = 0; a < kAcc; ++a) fence_regs(acc[a]);
        wgmma_fence();
#pragma unroll
        for (int a = 0; a < kAcc; ++a) {
          const uint64_t db = is_dk(a) ? dq_m : ddo_m;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) wgmma_rs<HDP>(acc[a], fr[a][kk], db + ((kk * 16 * 128) >> 4));
        }
        wgmma_commit();
        wgmma_wait();
#pragma unroll
        for (int a = 0; a < kAcc; ++a) {
          fence_regs(acc[a]);
          fence_regs(fr[a]);
        }
        mbar_arrive(empty + 8 * stage);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      mbar_arrive(kv_empty);   // the producer may load the next item's K and V

      // one slice: dK * scale and dV in bf16, into their strided layouts;
      // more: fp32 partials (plane 0 dK, plane 1 dV); rows past S unwritten
#pragma unroll
      for (int a = 0; a < kAcc; ++a) {
        const bool dk_acc = is_dk(a);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = it.k0 + row_in + 8 * i;
          if (row >= p.S) continue;
          if (p.slices == 1) {
            const long long* ds = dk_acc ? p.dk_s : p.dv_s;
            __nv_bfloat16* out = static_cast<__nv_bfloat16*>(dk_acc ? p.dk : p.dv) +
                                 it.b * ds[0] + it.hk * ds[1] + row * ds[2] + col0;
            const float mul = dk_acc ? p.scale : 1.f;
#pragma unroll
            for (int j = 0; j < HD / 8; ++j)
              *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(
                  acc[a][4 * j + 2 * i] * mul, acc[a][4 * j + 2 * i + 1] * mul);
          } else {
            const long long plane = static_cast<long long>(p.slices) * p.B * p.nkv * p.S * HD;
            float* out = p.parts + (dk_acc ? 0 : plane) +
                         (((static_cast<long long>(it.slice) * p.B + it.b) * p.nkv + it.hk) *
                              p.S + row) * HD + col0;
#pragma unroll
            for (int j = 0; j < HD / 8; ++j)
              *reinterpret_cast<float2*>(out + 8 * j) =
                  make_float2(acc[a][4 * j + 2 * i], acc[a][4 * j + 2 * i + 1]);
          }
        }
      }
    }
  }
}

// dK = scale * sum of the slices' partials, dV = their sum, in slice order,
// rounded once to bf16 into the strided dk, dv; a thread per 4 columns
template <int HD>
__global__ void __launch_bounds__(256) flash_bwd_sum_kernel(const Params p) {
  const long long n = static_cast<long long>(p.B) * p.nkv * p.S * (HD / 4);
  const long long plane = static_cast<long long>(p.B) * p.nkv * p.S * HD;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float4 k = make_float4(0.f, 0.f, 0.f, 0.f), v = k;
    for (int s = 0; s < p.slices; ++s) {
      const float4 a = reinterpret_cast<const float4*>(p.parts + s * plane)[i];
      const float4 b = reinterpret_cast<const float4*>(p.parts + (p.slices + s) * plane)[i];
      k.x += a.x; k.y += a.y; k.z += a.z; k.w += a.w;
      v.x += b.x; v.y += b.y; v.z += b.z; v.w += b.w;
    }
    const int c = static_cast<int>(i % (HD / 4)) * 4;
    long long rest = i / (HD / 4);
    const int row = static_cast<int>(rest % p.S);
    rest /= p.S;
    const int hk = static_cast<int>(rest % p.nkv), b = static_cast<int>(rest / p.nkv);
    __nv_bfloat16* kd = static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_s[0] + hk * p.dk_s[1] +
                        row * p.dk_s[2] + c;
    __nv_bfloat16* vd = static_cast<__nv_bfloat16*>(p.dv) + b * p.dv_s[0] + hk * p.dv_s[1] +
                        row * p.dv_s[2] + c;
    __nv_bfloat162 ko[2] = {__floats2bfloat162_rn(k.x * p.scale, k.y * p.scale),
                            __floats2bfloat162_rn(k.z * p.scale, k.w * p.scale)};
    __nv_bfloat162 vo[2] = {__floats2bfloat162_rn(v.x, v.y), __floats2bfloat162_rn(v.z, v.w)};
    *reinterpret_cast<uint2*>(kd) = *reinterpret_cast<uint2*>(ko);
    *reinterpret_cast<uint2*>(vd) = *reinterpret_cast<uint2*>(vo);
  }
}

// ---- dQ --------------------------------------------------------------------

struct QItem {
  int q0, h, b, kt_begin, kt_end;
};

// heaviest causal q tile first, as the forward
__device__ __forceinline__ bool q_item_of(const Params& p, int r, QItem& it) {
  const int idx = snake(r);
  if (idx >= p.n_dq_items) return false;
  const int per_tile = p.nh * p.B;
  it.q0 = (p.n_dq_tiles - 1 - idx / per_tile) * kDqRows;
  it.h = idx % p.nh;
  it.b = (idx / p.nh) % p.B;
  const int k_end = p.causal ? min(p.S, it.q0 + kDqRows) : p.S;
  it.kt_end = (k_end + kDqKvRows - 1) / kDqKvRows;
  it.kt_begin = p.window > 0 ? max(0, it.q0 - p.window + 1) / kDqKvRows : 0;
  return true;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                    const Params p) {
  using L = DqSmem<HD>;
  constexpr int HDP = L::kCols, kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ, sDO = base + L::kDO, sK = base + L::kK, sV = base + L::kV;
  const uint32_t q_full = base + L::kBar, q_empty = q_full + 8;
  const uint32_t full = q_empty + 8, empty = full + 8 * kStages;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumers);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 32;\n" ::: "memory");
    if (threadIdx.x == kConsumers) {
      int stage = 0;
      uint32_t phase = 0;
      QItem it{};
      for (int r = 0; q_item_of(p, r, it); ++r) {
        const int hk = it.h / (p.nh / p.nkv);
        for (int kt = it.kt_begin; kt < it.kt_end; ++kt) {
          const uint32_t bar = full + 8 * stage;
          mbar_wait_or_trap(empty + 8 * stage, phase ^ 1);
          mbar_expect_tx(bar, 2 * L::kKvTile);
          for (int c = 0; c < L::kBoxes; ++c) {
            tma_load(sK + stage * L::kKvTile + c * L::kKvBox, &tk, bar, c * kBoxCols,
                     kt * kDqKvRows, hk, it.b);
            tma_load(sV + stage * L::kKvTile + c * L::kKvBox, &tv, bar, c * kBoxCols,
                     kt * kDqKvRows, hk, it.b);
          }
          if (kt == it.kt_begin) {
            // Q and dO go in once every consumer is done with the last item's
            if (r > 0) mbar_wait_or_trap(q_empty, (r - 1) & 1);
            mbar_expect_tx(q_full, 2 * L::kQTile);
            for (int c = 0; c < L::kBoxes; ++c) {
              tma_load(sQ + c * L::kQBox, &tq, q_full, c * kBoxCols, it.q0, it.h, it.b);
              tma_load(sDO + c * L::kQBox, &tdo, q_full, c * kBoxCols, it.q0, it.h, it.b);
            }
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int row_in = wg * 64 + warp * 16 + lane / 4;   // the thread's q rows: q0 + row_in (+ 8)
    const int col0 = 2 * (lane % 4);                      // kv column of s[0] in a tile
    const float sc = p.scale_log2;

    float dq[HDP / 2];   // columns past HD sum zeros, never stored
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    uint32_t da[4][4];

    const uint64_t dq_a = sw128_desc(sQ + wg * 64 * 128, 16, 1024);
    const uint64_t ddo_a = sw128_desc(sDO + wg * 64 * 128, 16, 1024);
    auto wait_full = [&](uint32_t bar, uint32_t parity) {
      mbar_wait_or_trap(bar, parity);
      __syncwarp();
    };

    int stage = 0;
    uint32_t phase = 0;
    QItem it{};
    for (int r = 0; q_item_of(p, r, it); ++r) {
#pragma unroll
      for (int i = 0; i < HDP / 2; ++i) dq[i] = 0.f;
      float lse[2], dd[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = it.q0 + row_in + 8 * i;
        const long long at = (static_cast<long long>(it.b) * p.nh + it.h) * p.ld + row;
        lse[i] = row < p.S ? p.lse[at] : 0.f;
        dd[i] = row < p.S ? p.delta[at] : 0.f;
      }
      wait_full(q_full, r & 1);
      const int n_tiles = it.kt_end - it.kt_begin;
      for (int i = 0; i < n_tiles; ++i) {
        const int k0 = (it.kt_begin + i) * kDqKvRows;
        const uint32_t k_s = sK + stage * L::kKvTile, v_s = sV + stage * L::kKvTile;
        wait_full(full + 8 * stage, phase);
        // S = Q K^T and dP = dO V^T over hd
        const uint64_t dk_k = sw128_desc(k_s, 16, 1024), dv_k = sw128_desc(v_s, 16, 1024);
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t a = ((kk / 4) * L::kQBox + (kk % 4) * 32) >> 4;
          const uint32_t b = ((kk / 4) * L::kKvBox + (kk % 4) * 32) >> 4;
          wgmma_ss_n64(s, dq_a + a, dk_k + b, kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t a = ((kk / 4) * L::kQBox + (kk % 4) * 32) >> 4;
          const uint32_t b = ((kk / 4) * L::kKvBox + (kk % 4) * 32) >> 4;
          wgmma_ss_n64(dp, ddo_a + a, dv_k + b, kk > 0);
        }
        wgmma_commit();
        wgmma_wait();
        fence_regs(s);
        fence_regs(dp);
        if (i + 1 == n_tiles) mbar_arrive(q_empty);   // the producer may load the next Q, dO

        // dS = P (dP - D), P = exp2(S * scale_log2 - LSE[row]), masked before exp2
        const bool edge = k0 + kDqKvRows > p.S || it.q0 + kDqRows > p.S ||
                          (p.causal && k0 + kDqKvRows - 1 > it.q0) ||
                          (p.window > 0 && k0 <= it.q0 + kDqRows - 1 - p.window);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float pv = fast_exp2(fmaf(s[4 * j + e], sc, -lse[e / 2]));
            if (edge && !live(p, it.q0 + row_in + (e / 2) * 8, k0 + j * 8 + col0 + (e & 1)))
              pv = 0.f;
            dp[4 * j + e] = pv * (dp[4 * j + e] - dd[e / 2]);
          }
        }
        to_a_frags(dp, da);

        // dQ += dS K, 16 kv rows per wgmma, K MN-major
        const uint64_t dk_m = sw128_desc(k_s, L::kKvBox, 1024);
        fence_regs(dq);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<HDP>(dq, da[kk], dk_m + ((kk * 16 * 128) >> 4));
        wgmma_commit();
        wgmma_wait();
        fence_regs(dq);
        fence_regs(da);
        mbar_arrive(empty + 8 * stage);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }

      // dQ * scale, rounded once, into dq's strided layout; rows past S unwritten
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = it.q0 + row_in + 8 * i;
        if (row >= p.S) continue;
        __nv_bfloat16* qrow = static_cast<__nv_bfloat16*>(p.dq) + it.b * p.dq_s[0] +
                              it.h * p.dq_s[1] + row * p.dq_s[2] + col0;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(qrow + 8 * j) = __floats2bfloat162_rn(
              dq[4 * j + 2 * i] * p.scale, dq[4 * j + 2 * i + 1] * p.scale);
      }
    }
  }
}

template <int HD> int set_smem_limits() {
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       DkdvSmem<HD>::kBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DqSmem<HD>::kBytes);
  return static_cast<int>(e);
}

int sm_count(int* sms) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  *sms = cached;
  return 0;
}

// maps: K, V with 128-row boxes and Q, dO with 64-row boxes (dK/dV); Q, dO
// with 128-row boxes and K, V with 64-row boxes (dQ)
template <int HD>
int launch(const CUtensorMap (&m)[8], const Params& p, cudaStream_t stream) {
  int sms = 0;
  int err = set_smem_limits<HD>();
  if (err == 0) err = sm_count(&sms);
  if (err != 0) return err;
  const int kv_grid = p.n_kv_items < sms ? p.n_kv_items : sms;
  const int dq_grid = p.n_dq_items < sms ? p.n_dq_items : sms;
  flash_bwd_dkdv_kernel<HD><<<kv_grid, kThreads, DkdvSmem<HD>::kBytes, stream>>>(m[0], m[1], m[2],
                                                                                m[3], p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dq_kernel<HD><<<dq_grid, kThreads, DqSmem<HD>::kBytes, stream>>>(m[4], m[5], m[6],
                                                                            m[7], p);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.slices == 1) return static_cast<int>(e);
  const long long n = static_cast<long long>(p.B) * p.nkv * p.S * (HD / 4);
  const long long needed = (n + 255) / 256;
  const int blocks = static_cast<int>(needed < 8 * sms ? needed : 8 * sms);
  flash_bwd_sum_kernel<HD><<<blocks, 256, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int HD> int info(int* out) {
  int err = set_smem_limits<HD>();
  if (err == 0) err = kernel_info(flash_bwd_dkdv_kernel<HD>, kThreads, DkdvSmem<HD>::kBytes, out);
  if (err == 0) err = kernel_info(flash_bwd_dq_kernel<HD>, kThreads, DqSmem<HD>::kBytes, out + 4);
  if (err == 0) err = kernel_info(flash_bwd_sum_kernel<HD>, 256, 0, out + 8);
  return err;
}

}  // namespace
}  // namespace repro_torch

// bf16 only, hd 64, 80, 128 or 192 (any other returns cudaErrorInvalidValue).
// q, dO, dq: [B, nh, S, hd] and k, v, dk, dv:
// [B, nkv, S, hd] as element strides (batch, head, seq) in `strides` (q, k,
// v, dO, dq, dk, dv in turn, 21 values, each a multiple of 8); hd
// contiguous; every base 16-byte aligned. lse (log2 units) and delta: fp32
// [B, nh, ld] with ld a multiple of 128. `slices` divides nh / nkv; with
// more than one, parts is fp32 scratch [2, slices, B, nkv, S, hd]. `scale`
// is the forward's softmax scale; 0 takes hd^-0.5. Returns the cudaError_t
// of the launches (0 on success), or 100000 plus the CUresult of a tensor
// map the driver refused.
extern "C" int flash_attention_bwd_wgmma_launch(const void* q, const void* k, const void* v,
                                                const void* dO, void* dq, void* dk, void* dv,
                                                const void* lse, const void* delta, void* parts,
                                                const long long* strides, int B, int nh, int nkv,
                                                int S, int hd, int causal, int window, int ld,
                                                float scale, int slices, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || S <= 0 || nkv <= 0 || nh % nkv != 0 || window < 0 ||
      ld % 128 != 0 || ld < S || slices <= 0 || (nh / nkv) % slices != 0 ||
      (slices > 1 && parts == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m[8];
  const void* const qkvdo[4] = {q, k, v, dO};
  const int heads[4] = {nh, nkv, nkv, nh};
  // dK/dV: K, V (128 rows), Q, dO (64 rows); dQ: Q, dO (128 rows), K, V (64 rows)
  const int order[8] = {1, 2, 0, 3, 0, 3, 1, 2};
  const int rows[8] = {kKvRows, kKvRows, kQRows, kQRows, kDqRows, kDqRows, kDqKvRows, kDqKvRows};
  for (int i = 0; i < 8; ++i) {
    const int t = order[i];
    const int err = make_head_map(&m[i], qkvdo[t], hd, S, heads[t], B, strides + 3 * t,
                                  rows[i]);
    if (err != 0) return err;
  }
  Params p;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.parts = static_cast<float*>(parts);
  for (int i = 0; i < 3; ++i) {
    p.dq_s[i] = strides[12 + i];
    p.dk_s[i] = strides[15 + i];
    p.dv_s[i] = strides[18 + i];
  }
  p.B = B;
  p.nh = nh;
  p.nkv = nkv;
  p.S = S;
  p.causal = causal;
  p.window = window;
  p.ld = ld;
  p.slices = slices;
  p.kinds = dkdv_kinds(hd);
  p.n_kv_items = (S + kKvRows - 1) / kKvRows * nkv * B * slices * p.kinds;
  p.n_q_tiles = (S + kQRows - 1) / kQRows;
  p.n_dq_tiles = (S + kDqRows - 1) / kDqRows;
  p.n_dq_items = p.n_dq_tiles * nh * B;
  p.scale = scale > 0.f ? scale : 1.f / sqrtf(static_cast<float>(hd));
  p.scale_log2 = kLog2e * p.scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch<64>(m, p, s);
    case 80: return launch<80>(m, p, s);
    case 128: return launch<128>(m, p, s);
    case 192: return launch<192>(m, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// For hd (64, 80, 128 or 192; any other returns cudaErrorInvalidValue), per
// kernel (dK/dV, dQ, the partials' sum) in turn,
// four ints: registers a thread, local-memory bytes a thread (spills),
// dynamic shared memory bytes, CTAs that fit on one SM. Returns a
// cudaError_t.
extern "C" int flash_attention_bwd_wgmma_info(int hd, int* out) {
  using namespace repro_torch;
  switch (hd) {
    case 64: return info<64>(out);
    case 80: return info<80>(out);
    case 128: return info<128>(out);
    case 192: return info<192>(out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
