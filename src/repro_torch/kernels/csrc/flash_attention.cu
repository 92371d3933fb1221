// GQA flash attention (forward), causal or not, with an optional sliding
// window, for Hopper (sm_90a): the bf16 kernel at head_dim 64, 80, 128 and
// 192, built on wgmma and TMA. fp32 (every head_dim) and bf16 at head_dim 32 go
// to the
// mma.sync / FMA kernel in flash_attention_mma.cu; kernels/flash_attention.py
// picks by (dtype, head_dim).
//
// Replaces: src/repro/kernels/flash_attention.py, _flash_kernel /
// flash_attention. o = softmax(mask(q k^T * hd^-0.5)) v per head, with the
// kv head h / (nh / nkv), fp32 online softmax (m, l, acc), tiles wholly in
// the causal future or outside the window skipped, and rows with nothing
// to attend to written as 0.
//
// Bound on the H100: operations. Causal attention does 4*B*nh*hd*S(S+1)/2
// flops (two products over the causal pairs), which at 989 TFLOP/s (bf16
// tensor cores) is the least time. At yi-6b prefill (B 2, nh 32, S 2000,
// hd 128) that is 65.6 GFLOP, 0.066 ms; the bytes (q, k, v read once, o
// written once: 37 MB) take 0.011 ms at 3.35 TB/s. At nemotron-4-340b's
// prefill (B 2, nh 96, nkv 8, S 2000, hd 192) 295.1 GFLOP, 0.2983 ms.
// Without the causal mask
// every (query, key) pair counts, 4*B*nh*hd*S^2: at hubert-xlarge's prefill
// (B 2, nh 16, S 2000, hd 80) 40.96 GFLOP, 0.0414 ms.
//
// Design (after FlashAttention-3's shape, without its ping-pong and
// intra-warpgroup overlap: both measured slower here, PERF.md):
//  * A persistent grid, one CTA of three warpgroups per SM, walks work
//    items (q tile of 128 rows, head, batch), heaviest causal q tiles
//    first, in a snake order across the CTAs. Two consumer warpgroups own
//    64 q rows each, so each issues wgmma.m64nNk16; the third is the
//    producer: one of its threads issues every TMA copy. setmaxnreg gives
//    the producer's registers to the consumers (24 and 240 a thread). The
//    TPU's sequential kv-block grid axis is the loop over an item's tiles.
//  * Copies: q is loaded once per item, as soon as the consumers are done
//    with the previous item's last q k^T; k and v tiles of 128 rows go
//    through a ring of kStages slots with full and empty mbarriers that
//    runs on across items, so the copy of the next tile overlaps the
//    products on this one and one item's epilogue the next item's loads.
//    The tensor maps are 4-D (hd, S, head, batch) over the caller's
//    strides, so the model's [B,S,nh,hd] views need no copy, and TMA
//    zero-fills rows at or past S: the tensors are never padded. A bf16 row
//    of hd 128 is 256 bytes, wider than the 128-byte swizzle span, so a
//    tile is loaded as hd/64 boxes of [128 rows][64 columns].
//  * hd 80 (hubert-xlarge): a row is 160 bytes, so a tile is two such
//    boxes, the second holding columns 64-79; the maps declare the head
//    dim as 80 with the caller's strides, and TMA zero-fills columns 80-127
//    of the second box, in shared memory only. q k^T runs over the 80
//    columns (five k16 slabs, the fifth at the second box's start); p v
//    runs at the padded width, N 128, whose columns past 80 sum zeros and
//    are never stored: 1.3x the products of hd 80 (q k^T 80 + p v 128
//    against 80 + 80), for one code path with hd 128's layout, registers
//    and descriptors. (A 16-column box with a 32-byte swizzle and an n80
//    p v would do no extra work; later work.)
//  * hd 192 (nemotron-4-340b): a 384-byte row is three boxes. At 128 kv
//    rows a tile, q (48 KB) and two ring slots of k and v (192 KB) pass
//    the 227 KB a block may have, and a consumer thread would hold o at
//    N 192 (96 fp32), the scores (64) and p (32) under setmaxnreg's 240.
//    So kv tiles are 64 rows here (kv_rows): the scores take 32 registers
//    and p 16 beside o's 96, and the ring has three slots (q 48 KB + 3 x
//    48 KB). q k^T is wgmma.m64n64k16, p v one wgmma.m64n192k16 per 16
//    kv rows over the three boxes (LBO = a box).
//  * Products: S = q k^T is a wgmma with both operands in shared memory,
//    K-major, 128-byte swizzled. o += p v takes p from registers (the score
//    accumulators rounded to bf16 become the A fragments without leaving
//    the thread; l sums the fp32 p) and v from shared memory through the
//    MN-major (transposed) descriptor. Accumulation is fp32; exp2 is the
//    hardware's ex2.approx.
//  * Masking: scale and mask in fp32, in the reference's order, only on
//    tiles that straddle the diagonal, the window's edge or S; tiles wholly
//    in the future or outside the window are never loaded.
//  * Epilogue: o is scaled by 1/l in registers, rounded once to bf16 and
//    stored into o's strided layout; rows at or past S are not written.
//    When the caller passes an LSE buffer (training), each row's
//    log-sum-exp in log2 units, m * scale_log2 + log2(l) (-inf for a row
//    with nothing to attend to), goes to it for the backward.
// The mbarrier, TMA, descriptor and wgmma helpers, and the host-side map
// encoding, live in hopper.cuh (shared with ssd_scan.cu).
#include <math.h>

#include "hopper.cuh"

namespace repro_torch {
namespace {

constexpr int kBQ = 128;                  // q rows per work item
constexpr int kBoxCols = 64;              // bf16 columns in one 128-byte swizzle span
constexpr int kConsumers = 256;           // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;      // and one producer warpgroup
constexpr float kLog2e = 1.4426950408889634f;

// kv rows of a tile and k/v ring slots: 128 and 2, or 64 and 3 at hd 192
// (see the header)
__host__ __device__ constexpr int kv_rows(int hd) { return hd > 128 ? 64 : 128; }
__host__ __device__ constexpr int ring_stages(int hd) { return hd > 128 ? 3 : 2; }

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle
// repeats every 8 rows of 128 bytes): q, the k ring, the v ring, barriers.
// A head dim that is not a multiple of 64 takes whole boxes (hd 80: two),
// the columns past hd zero-filled by TMA.
template <int HD> struct Smem {
  static_assert(HD % 16 == 0 && HD <= 192, "head dims of whole k16 slabs, at most three boxes");
  static constexpr int kBK = kv_rows(HD);
  static constexpr int kStages = ring_stages(HD);
  static constexpr int kBoxes = (HD + kBoxCols - 1) / kBoxCols;
  static constexpr int kCols = kBoxes * kBoxCols;    // the padded width p v runs at
  static constexpr int kQBox = kBQ * 128;            // a [128 rows][64] box
  static constexpr int kKvBox = kBK * 128;           // a [kBK rows][64] box
  static constexpr int kQTile = kBoxes * kQBox;
  static constexpr int kKvTile = kBoxes * kKvBox;    // one k or v tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQTile;
  static constexpr int kV = kK + kStages * kKvTile;
  static constexpr int kBar = kV + kStages * kKvTile;   // q_full, q_empty, then k_full[], k_empty[],
                                                        // v_full[], v_empty[]
  static constexpr int kBytes = kBar + 8 * (2 + 4 * kStages) + 1024;   // + alignment slack
  static_assert(kBytes <= 232448, "more shared memory than a block may have");
};

struct Params {
  void* o;
  float* lse;          // [B, nh, lse_ld] fp32, or null
  long long o_sb, o_sh, o_ss;
  int B, nh, nkv, S, causal, window, n_qtiles, n_items, lse_ld;
  float scale_log2;   // the softmax scale (hd^-0.5 unless given) * log2(e): scores go through exp2
};

// Online softmax over one [64 x BK] score tile of a warpgroup, in fp32:
// the running row max m (unscaled) and this thread's share l of the row
// sums, for the thread's two rows (see the accumulator layout below).
template <int BK> struct Softmax {
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  // p = exp2(s * scale_log2 - m * scale_log2), written as bf16 A fragments
  // of p v (l sums the fp32 p). Returns the factors (row g, row g + 8) by
  // which o, accumulated under the previous max, must be rescaled.
  __device__ __forceinline__ float2 step(const float (&s)[BK / 2], uint32_t (&pa)[BK / 16][4],
                                         float sc) {
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    float ms[2], corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      ms[i] = (mx[i] == -INFINITY ? 0.f : mx[i]) * sc;   // row with nothing live yet
      corr[i] = fast_exp2(fmaf(m[i], sc, -ms[i]));
      m[i] = mx[i];
      l[i] *= corr[i];
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      float pf[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        pf[e] = fast_exp2(fmaf(s[8 * kk + e], sc, -ms[(e / 2) % 2]));
        l[(e / 2) % 2] += pf[e];
      }
      pa[kk][0] = pack_bf16(pf[0], pf[1]);   // row g, k 2t..2t+1
      pa[kk][1] = pack_bf16(pf[2], pf[3]);   // row g+8
      pa[kk][2] = pack_bf16(pf[4], pf[5]);   // row g, k 8+2t..
      pa[kk][3] = pack_bf16(pf[6], pf[7]);   // row g+8, k 8+2t..
    }
    return make_float2(corr[0], corr[1]);
  }
};

// One work item: a 128-row q tile of one head, and the kv tiles it attends
// to (the causal future and what the window has left are skipped).
struct Item {
  int q0, h, b, kt_begin, kt_end;
};

// Item `r` of this CTA's share, or false past the last, over kv tiles of BK
// rows. Items are numbered heaviest causal q tile first; CTA c takes one of
// every gridDim.x, in a snake order (c, then 2G - 1 - c, ...) that evens
// out the CTAs' loads.
template <int BK>
__device__ __forceinline__ bool item_of(const Params& p, int r, Item& it) {
  const int G = gridDim.x, c = blockIdx.x;
  const int idx = r * G + ((r & 1) ? G - 1 - c : c);
  if (idx >= p.n_items) return false;
  const int per_tile = p.nh * p.B;
  it.q0 = (p.n_qtiles - 1 - idx / per_tile) * kBQ;
  it.h = idx % p.nh;
  it.b = (idx / p.nh) % p.B;
  const int k_end = p.causal ? min(p.S, it.q0 + kBQ) : p.S;
  it.kt_end = (k_end + BK - 1) / BK;
  it.kt_begin = p.window > 0 ? max(0, it.q0 - p.window + 1) / BK : 0;
  return true;
}

// Accumulator layout of wgmma.m64nNk16 (fp32): thread (warp w of the
// warpgroup, lane g*4 + t) holds, for each 8-column block j, d[4j+0..1] at
// row 16w + g, columns 8j + 2t + {0,1}, and d[4j+2..3] at row 16w + g + 8.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = Smem<HD>;
  constexpr int HDP = L::kCols, kBK = L::kBK, kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ, sK = base + L::kK, sV = base + L::kV;
  const uint32_t q_full = base + L::kBar, q_empty = q_full + 8;
  const uint32_t k_full = q_empty + 8, k_empty = k_full + 8 * kStages;
  const uint32_t v_full = k_empty + 8 * kStages, v_empty = v_full + 8 * kStages;
  const int S = p.S;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumers);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, kConsumers);
      mbar_init(v_empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers) {
      int stage = 0;
      uint32_t phase = 0;
      Item it{};
      for (int r = 0; item_of<kBK>(p, r, it); ++r) {
        const int hk = it.h / (p.nh / p.nkv);
        for (int kt = it.kt_begin; kt < it.kt_end; ++kt) {
          const uint32_t off = stage * L::kKvTile;
          mbar_wait(k_empty + 8 * stage, phase ^ 1);
          mbar_expect_tx(k_full + 8 * stage, L::kKvTile);
          for (int c = 0; c < L::kBoxes; ++c)
            tma_load(sK + off + c * L::kKvBox, &tk, k_full + 8 * stage, c * kBoxCols, kt * kBK,
                     hk, it.b);
          if (kt == it.kt_begin) {
            // q goes in once every consumer is done with the last item's
            if (r > 0) mbar_wait(q_empty, (r - 1) & 1);
            mbar_expect_tx(q_full, L::kQTile);
            for (int c = 0; c < L::kBoxes; ++c)
              tma_load(sQ + c * L::kQBox, &tq, q_full, c * kBoxCols, it.q0, it.h, it.b);
          }
          mbar_wait(v_empty + 8 * stage, phase ^ 1);
          mbar_expect_tx(v_full + 8 * stage, L::kKvTile);
          for (int c = 0; c < L::kBoxes; ++c)
            tma_load(sV + off + c * L::kKvBox, &tv, v_full + 8 * stage, c * kBoxCols, kt * kBK,
                     hk, it.b);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int row_in = wg * 64 + warp * 16 + lane / 4;   // the thread's rows: q0 + row_in (+ 8)
    const int col0 = 2 * (lane % 4);                      // column of s[0] in a tile

    float o[HDP / 2];   // columns past HD (hd 80) sum zeros and are never stored
    float s[kBK / 2];
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;
    uint32_t pa[kBK / 16][4];   // p, as p v's A fragments

    const uint64_t dq = sw128_desc(sQ + wg * 64 * 128, 16, 1024);
    // S = q k^T over hd, 16 columns of hd per wgmma (hd 80: the fifth slab
    // is the second box's first 32 bytes)
    auto issue_qk = [&](int stage) {
      const uint64_t dk = sw128_desc(sK + stage * L::kKvTile, 16, 1024);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t a = ((kk / 4) * L::kQBox + (kk % 4) * 32) >> 4;
        const uint32_t b = ((kk / 4) * L::kKvBox + (kk % 4) * 32) >> 4;
        wgmma_ss<kBK>(s, dq + a, dk + b, kk > 0);
      }
      wgmma_commit();
    };
    // o += p v, 16 kv rows per wgmma, at the padded width
    auto issue_pv = [&](int stage) {
      const uint64_t dv = sw128_desc(sV + stage * L::kKvTile, L::kKvBox, 1024);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) wgmma_rs<HDP>(o, pa[kk], dv + ((kk * 16 * 128) >> 4));
      wgmma_commit();
    };
    auto wait_full = [&](uint32_t bar, uint32_t parity) {
      mbar_wait(bar, parity);
      __syncwarp();   // the spin may leave lanes apart; wgmma wants the warp converged
    };
    // scale, then mask (the reference's order), only where a tile
    // straddles the diagonal, the window's edge or S
    auto mask = [&](int q0, int k0) {
      const bool edge = (p.causal && k0 + kBK - 1 > q0) || k0 + kBK > S ||
                        (p.window > 0 && k0 <= q0 + kBQ - 1 - p.window);
      if (!edge) return;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = q0 + row_in + (e / 2) * 8;
          const int c = k0 + j * 8 + col0 + (e & 1);
          bool ok = c < S;
          if (p.causal) ok = ok && c <= r;
          if (p.window > 0) ok = ok && c > r - p.window;
          if (!ok) s[4 * j + e] = -INFINITY;
        }
      }
    };

    // Per item: for each kv tile q k^T, the softmax, p v; then the epilogue.
    int stage = 0;
    uint32_t phase = 0;
    Item it{};
    for (int r = 0; item_of<kBK>(p, r, it); ++r) {
#pragma unroll
      for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
      Softmax<kBK> sm;
      wait_full(q_full, r & 1);
      const int n_tiles = it.kt_end - it.kt_begin;
      for (int i = 0; i < n_tiles; ++i) {
        const bool last = i + 1 == n_tiles;
        wait_full(k_full + 8 * stage, phase);
        fence_regs(s);
        wgmma_fence();
        issue_qk(stage);
        wgmma_wait();
        fence_regs(s);
        mbar_arrive(k_empty + 8 * stage);
        if (last) mbar_arrive(q_empty);   // the producer may load the next q
        mask(it.q0, (it.kt_begin + i) * kBK);
        const float2 corr = sm.step(s, pa, p.scale_log2);
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          o[4 * j] *= corr.x;
          o[4 * j + 1] *= corr.x;
          o[4 * j + 2] *= corr.y;
          o[4 * j + 3] *= corr.y;
        }
        wait_full(v_full + 8 * stage, phase);
        fence_regs(o);
        wgmma_fence();
        issue_pv(stage);
        wgmma_wait();
        fence_regs(o);
        mbar_arrive(v_empty + 8 * stage);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }

      // o / l, rounded once, into o's strided layout; rows past S unwritten
      float l[2] = {sm.l[0], sm.l[1]};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        const int row = it.q0 + row_in + 8 * i;
        if (p.lse != nullptr && lane % 4 == 0 && row < S)
          p.lse[(static_cast<long long>(it.b) * p.nh + it.h) * p.lse_ld + row] =
              l[i] > 0.f ? fmaf(sm.m[i], p.scale_log2, log2f(l[i])) : -INFINITY;
        l[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;   // rows with nothing to attend to -> 0
      }
      __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + it.b * p.o_sb + it.h * p.o_sh;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = it.q0 + row_in + 8 * i;
        if (row >= S) continue;
        __nv_bfloat16* orow = og + row * p.o_ss + col0;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
              __floats2bfloat162_rn(o[4 * j + 2 * i] * l[i], o[4 * j + 2 * i + 1] * l[i]);
      }
    }
  }
}

template <int HD> cudaError_t set_smem_limit() {
  return cudaFuncSetAttribute(flash_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Smem<HD>::kBytes);
}

template <int HD> int info(int* out) {
  const cudaError_t e = set_smem_limit<HD>();
  if (e != cudaSuccess) return static_cast<int>(e);
  return kernel_info(flash_wgmma_kernel<HD>, kThreads, Smem<HD>::kBytes, out);
}

template <int HD>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, const Params& p,
           cudaStream_t stream) {
  constexpr int bytes = Smem<HD>::kBytes;
  cudaError_t e = set_smem_limit<HD>();
  // persistent: one CTA per SM (shared memory and registers allow no more)
  static int sms = 0;
  int dev = 0;
  if (e == cudaSuccess && sms == 0) e = cudaGetDevice(&dev);
  if (e == cudaSuccess && sms == 0)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = p.n_items < sms ? p.n_items : sms;
  flash_wgmma_kernel<HD><<<grid, kThreads, bytes, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// bf16 only, hd 64, 80, 128 or 192 (any other returns cudaErrorInvalidValue).
// q, o: [B, nh, S, hd] and k, v: [B, nkv, S, hd]
// as element strides (batch, head, seq) in `strides` (q, k, v, o in turn,
// 12 values, each a multiple of 8); hd contiguous; q, k, v 16-byte aligned.
// lse: fp32 [B, nh, lse_ld] (lse_ld >= S) for each row's log-sum-exp, or
// null. `scale` is the softmax scale; 0 takes hd^-0.5. Returns the
// cudaError_t of the launch (0 on success), or 100000 plus the CUresult of
// a tensor map the driver refused.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k, const void* v, void* o,
                                            void* lse, const long long* strides, int B, int nh,
                                            int nkv, int S, int hd, int causal, int window,
                                            int lse_ld, float scale, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || S <= 0 || nkv <= 0 || nh % nkv != 0 || (lse != nullptr && lse_ld < S))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  int err = make_head_map(&tq, q, hd, S, nh, B, strides, kBQ);
  if (err == 0) err = make_head_map(&tk, k, hd, S, nkv, B, strides + 3, kv_rows(hd));
  if (err == 0) err = make_head_map(&tv, v, hd, S, nkv, B, strides + 6, kv_rows(hd));
  if (err != 0) return err;
  Params p;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.lse_ld = lse_ld;
  p.o_sb = strides[9];
  p.o_sh = strides[10];
  p.o_ss = strides[11];
  p.nh = nh;
  p.nkv = nkv;
  p.S = S;
  p.causal = causal;
  p.window = window;
  p.B = B;
  p.n_qtiles = (S + kBQ - 1) / kBQ;
  p.n_items = p.n_qtiles * nh * B;
  p.scale_log2 = scale > 0.f ? kLog2e * scale : kLog2e / sqrtf(static_cast<float>(hd));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch<64>(tq, tk, tv, p, s);
    case 80: return launch<80>(tq, tk, tv, p, s);
    case 128: return launch<128>(tq, tk, tv, p, s);
    case 192: return launch<192>(tq, tk, tv, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// For hd (64, 80, 128 or 192; any other returns cudaErrorInvalidValue), four
// ints: registers a thread, local-memory bytes a thread (spills), dynamic
// shared memory bytes, CTAs that fit on one SM. Returns a cudaError_t.
extern "C" int flash_attention_wgmma_info(int hd, int* out) {
  using namespace repro_torch;
  switch (hd) {
    case 64: return info<64>(out);
    case 80: return info<80>(out);
    case 128: return info<128>(out);
    case 192: return info<192>(out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
