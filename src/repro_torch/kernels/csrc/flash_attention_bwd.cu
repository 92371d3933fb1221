// GQA flash attention, causal, windowed or neither, backward, for Hopper
// (sm_90a): the mma.sync / FMA kernels, for fp32 at head_dim 32, 64, 80, 128
// and 192 and bf16 at head_dim 32 (bf16 at head_dim 64, 80, 128 and 192
// goes to the wgmma + TMA kernels of flash_attention_bwd_wgmma.cu), and the
// D = rowsum(dO * O) launch that both paths run first;
// kernels/flash_attention.py picks by (dtype, head_dim).
//
// The TPU kernel (src/repro/kernels/flash_attention.py, flash_attention /
// _flash_kernel) is forward only; this is the gradient of the port's
// forward (csrc/flash_attention.cu, csrc/flash_attention_mma.cu), the math
// of kernels/ref.py flash_attention_bwd_ref (FA2's backward):
//   P  = exp2(mask(q k^T * scale * log2(e)) - LSE)   recomputed, never stored
//   D  = rowsum(dO * O)
//   dV = P^T dO          dS = P * (dO V^T - D)
//   dQ = dS K * scale    dK = dS^T Q * scale
// with dK and dV summed over the nh / nkv query heads of each kv head.
//
// Bound on the H100: operations, five products of 2*B*nh*hd*S(S+1)/2 flops
// each over the causal pairs; bf16 on the tensor cores, fp32 on the FMA
// units.
//
// Design (the port's first backward, kept for the paths above):
//  * LSE (log2 units) is the forward kernels' (flash_attention.cu,
//    flash_attention_mma.cu write it when a gradient is wanted); `delta`
//    writes D, a group of lanes per (b, h, row) with one 16-byte vector of
//    o and dO each (a power of two of lanes: at hd 80 the lanes past the
//    row's 10 or 20 vectors add 0); both fp32 [B, nh, ld], rows past S of D
//    zero. Then two
//    launches.
//    `dkdv`: per (kv tile, kv head, b), a loop over the group's query
//    heads and their live q tiles, with dK and dV in registers, so the GQA
//    sum needs no atomics. `dq`: per (q tile, head, b), a loop over the
//    live kv tiles.
//  * The products are the forward mma kernel's: 4 warps, each 16 rows of
//    a 64-row tile; tiles staged in shared memory with 16-byte loads, rows
//    padded by 16 bytes, the tail past S zero-filled. bf16 runs
//    mma.sync.m16n8k16 with fp32 sums; P and dS are rounded to bf16 only as
//    the A operand of the next product (as the forward rounds p). fp32
//    runs the same fragment layout on FMAs, so it keeps full precision.
//    dkdv works on transposed tiles (kv rows, query columns: S^T = K Q^T,
//    dP^T = V dO^T), so P^T and dS^T come out of the accumulators in the
//    layout of the A operand of dV += P^T dO and dK += dS^T Q.
//  * Masks are applied before exp2 (inf * 0 is NaN on CUDA): a masked or
//    padded entry gives P = 0 and dS = 0 exactly.
//  * Strides are arguments: q, k, v, o, dO and the gradients may be
//    [B,nh,S,hd] tensors or views of [B,S,nh,hd] ones, hd contiguous.
//  * hd 192 (fp32 only: the gates): dkdv stages four tiles of 64 rows of
//    196 floats, the LSE and D rows and the P scratch, 218,624 bytes of
//    shared memory; its dK and dV (96 fp32 each a thread) beside P^T and
//    dS^T pass 255 registers, so it spills to local memory
//    (flash_attention_bwd_info reports it).
#include <math.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kTile = 64;     // rows of every q and kv tile
constexpr int kWarps = 4;     // 16 rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kLdP = kTile + 4;  // fp32 P scratch row stride (fp32 path only)
constexpr float kLog2e = 1.4426950408889634f;

struct BwdParams {
  const void *q, *k, *v, *dO;
  void *dq, *dk, *dv;
  const float *lse, *delta;  // [B, nh, ld]: LSE in log2 units, rowsum(dO * O)
  long long s[21];           // (batch, head, seq) strides of q, k, v, dO, dq, dk, dv
  int nh, nkv, S, causal, window, ld;
  float scale, scale_log2;
};

enum { Q = 0, K = 1, V = 2, DO = 3, DQ = 4, DK = 5, DV = 6 };

template <typename T, int HD> __host__ __device__ constexpr int tile_ld() {
  return HD + 16 / sizeof(T);
}

// rows [r0, r0 + kTile) of a [S, HD] strided slab into shared memory,
// zero-filling rows at or past S
template <typename T, int HD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long row_stride, int r0,
                                          int S) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = HD / kVec;
  constexpr int LD = tile_ld<T, HD>();
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S) val = *reinterpret_cast<const uint4*>(src + (r0 + r) * row_stride + c * kVec);
    *reinterpret_cast<uint4*>(dst + r * LD + c * kVec) = val;
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pair_bf16(const __nv_bfloat16* lo, const __nv_bfloat16* hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const unsigned short*>(lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const unsigned short*>(hi)) << 16);
}

// The two products, in the mma.m16n8k16 accumulator layout: lane (g =
// lane / 4, t = lane % 4) holds, for each 8-column block j, c[j][0..1] at
// row g, columns 8j + 2t + {0,1}, and c[j][2..3] at row g + 8. Rows are
// relative to the warp's 16.
//  * ab_t: s[j] += A[warp's rows] . B[rows 8j .. 8j+7]^T over HD, with A
//    and B row-major tiles in shared memory (s = A B^T, 16 x 64).
//  * ab: acc += P . B, with P (16 x 64) in the accumulator layout and B a
//    row-major 64 x HD tile (its rows indexed by P's columns).
template <typename T, int HD> struct Mma;

template <int HD> struct Mma<__nv_bfloat16, HD> {
  using T = __nv_bfloat16;
  static constexpr int LD = tile_ld<T, HD>();

  static __device__ __forceinline__ void ab_t(float (&s)[kTile / 8][4], const T* sA,
                                              const T* sB, float*, int warp, int g, int t) {
    const T* r0 = sA + (warp * 16 + g) * LD + 2 * t;
    const T* r1 = r0 + 8 * LD;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t a0 = ld_u32(r0 + kk * 16), a1 = ld_u32(r1 + kk * 16);
      const uint32_t a2 = ld_u32(r0 + kk * 16 + 8), a3 = ld_u32(r1 + kk * 16 + 8);
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        const T* br = sB + (j * 8 + g) * LD + 2 * t + kk * 16;
        mma_bf16(s[j], a0, a1, a2, a3, ld_u32(br), ld_u32(br + 8));
      }
    }
  }

  static __device__ __forceinline__ void ab(float (&acc)[HD / 8][4], const float (&p)[kTile / 8][4],
                                            const T* sB, float*, int, int g, int t) {
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint32_t a0 = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
      const uint32_t a1 = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
      const uint32_t a2 = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
      const T* b0 = sB + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const T* bn = b0 + n * 8;
        mma_bf16(acc[n], a0, a1, a2, a3, pair_bf16(bn, bn + LD),
                 pair_bf16(bn + 8 * LD, bn + 9 * LD));
      }
    }
  }
};

template <int HD> struct Mma<float, HD> {
  using T = float;
  static constexpr int LD = tile_ld<T, HD>();

  static __device__ __forceinline__ void ab_t(float (&s)[kTile / 8][4], const T* sA,
                                              const T* sB, float*, int warp, int g, int t) {
    const T* a0 = sA + (warp * 16 + g) * LD;
    const T* a1 = a0 + 8 * LD;
    const T* br = sB + 2 * t * LD;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float x0 = a0[d], x1 = a1[d];
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        const float y0 = br[j * 8 * LD + d], y1 = br[(j * 8 + 1) * LD + d];
        s[j][0] = fmaf(x0, y0, s[j][0]);
        s[j][1] = fmaf(x0, y1, s[j][1]);
        s[j][2] = fmaf(x1, y0, s[j][2]);
        s[j][3] = fmaf(x1, y1, s[j][3]);
      }
    }
  }

  // P goes through the warp's slice of shared memory: each row of the
  // product needs all 64 of its values.
  static __device__ __forceinline__ void ab(float (&acc)[HD / 8][4], const float (&p)[kTile / 8][4],
                                            const T* sB, float* sP, int warp, int g, int t) {
    float* pw = sP + warp * 16 * kLdP;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      pw[g * kLdP + j * 8 + 2 * t] = p[j][0];
      pw[g * kLdP + j * 8 + 2 * t + 1] = p[j][1];
      pw[(g + 8) * kLdP + j * 8 + 2 * t] = p[j][2];
      pw[(g + 8) * kLdP + j * 8 + 2 * t + 1] = p[j][3];
    }
    __syncwarp();
#pragma unroll 2
    for (int c = 0; c < kTile; ++c) {
      const float pa = pw[g * kLdP + c], pb = pw[(g + 8) * kLdP + c];
      const T* br = sB + c * LD + 2 * t;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const float y0 = br[n * 8], y1 = br[n * 8 + 1];
        acc[n][0] = fmaf(pa, y0, acc[n][0]);
        acc[n][1] = fmaf(pa, y1, acc[n][1]);
        acc[n][2] = fmaf(pb, y0, acc[n][2]);
        acc[n][3] = fmaf(pb, y1, acc[n][3]);
      }
    }
    __syncwarp();
  }
};

// shared memory: `tiles` staged tiles, then `floats` fp32 values a row of a
// tile (LSE, D), then the fp32 path's P scratch
template <typename T, int HD> constexpr int smem_bytes(int tiles, int floats, bool scratch) {
  return tiles * kTile * tile_ld<T, HD>() * static_cast<int>(sizeof(T)) + floats * kTile * 4 +
         (scratch && sizeof(T) == 4 ? kWarps * 16 * kLdP * 4 : 0);
}

__device__ __forceinline__ bool live(const BwdParams& p, int q_row, int k_row) {
  bool ok = q_row < p.S && k_row < p.S;
  if (p.causal) ok = ok && k_row <= q_row;
  if (p.window > 0) ok = ok && k_row > q_row - p.window;
  return ok;
}

template <int N> __device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) a[n][0] = a[n][1] = a[n][2] = a[n][3] = 0.f;
}

__device__ __forceinline__ void store_pair(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// write a warp's 16 x HD accumulator tile times `mul` to rows
// r0 + warp * 16 + {g, g + 8} of a strided slab, skipping rows at or past S
template <typename T, int HD>
__device__ __forceinline__ void store_rows(T* dst, long long row_stride, int r0, int S,
                                           const float (&acc)[HD / 8][4], float mul, int warp,
                                           int g, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + warp * 16 + g + 8 * i;
    if (r >= S) continue;
    T* row = dst + r * row_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      store_pair(row + n * 8, acc[n][2 * i] * mul, acc[n][2 * i + 1] * mul);
  }
}

// live kv tiles of the q tile at q0, and live q tiles of the kv tile at k0
__device__ __forceinline__ void kv_tiles(const BwdParams& p, int q0, int& begin, int& end) {
  const int k_end = p.causal ? min(p.S, q0 + kTile) : p.S;
  end = (k_end + kTile - 1) / kTile;
  begin = p.window > 0 ? max(0, q0 - p.window + 1) / kTile : 0;
}
__device__ __forceinline__ void q_tiles(const BwdParams& p, int k0, int& begin, int& end) {
  const int n = (p.S + kTile - 1) / kTile;
  begin = p.causal ? k0 / kTile : 0;
  end = p.window > 0 ? min(n, (k0 + kTile - 1 + p.window - 1) / kTile + 1) : n;
}

// ---- D = rowsum(dO * O): a group of `width` lanes per row (a power of
// two, at most 32), lane l summing 16-byte vectors l, l + width, ... of the
// row's `chunks` of o and of dO (one each where chunks <= 32; fp32 at hd 192
// has 48); rows in [S, ld) get 0 -------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(const T* o, const T* dO, float* delta,
                                                              long long o_sb, long long o_sh,
                                                              long long o_ss, long long d_sb,
                                                              long long d_sh, long long d_ss,
                                                              int nh, int S, int ld, int width,
                                                              int chunks, long long rows) {
  constexpr int kVec = 16 / sizeof(T);
  const long long t = blockIdx.x * 256ll + threadIdx.x;
  const long long r = t / width;
  float d = 0.f;
  if (r < rows) {
    const int row = static_cast<int>(r % ld);
    const long long bh = r / ld;
    const int h = static_cast<int>(bh % nh), b = static_cast<int>(bh / nh);
    const int lane = static_cast<int>(t % width);
    for (int v = lane; row < S && v < chunks; v += width) {
      const int c = v * kVec;
      const uint4 ou = *reinterpret_cast<const uint4*>(o + b * o_sb + h * o_sh + row * o_ss + c);
      const uint4 du = *reinterpret_cast<const uint4*>(dO + b * d_sb + h * d_sh + row * d_ss + c);
      const T* oe = reinterpret_cast<const T*>(&ou);
      const T* de = reinterpret_cast<const T*>(&du);
#pragma unroll
      for (int j = 0; j < kVec; ++j) d = fmaf(to_f32(oe[j]), to_f32(de[j]), d);
    }
  }
  for (int off = width / 2; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
  if (r < rows && t % width == 0) delta[r] = d;
}

// ---- dK, dV per (kv tile, kv head, b) ----------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(const BwdParams p) {
  constexpr int LD = tile_ld<T, HD>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kTile * LD;
  T* sQ = sV + kTile * LD;
  T* sdO = sQ + kTile * LD;
  float* sL = reinterpret_cast<float*>(sdO + kTile * LD);
  float* sD = sL + kTile;
  float* sP = sD + kTile;

  const int kt = gridDim.x - 1 - blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = p.nh / p.nkv;
  const int k0 = kt * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int krow[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  load_tile<T, HD>(sK, static_cast<const T*>(p.k) + b * p.s[3 * K] + hk * p.s[3 * K + 1],
                   p.s[3 * K + 2], k0, p.S);
  load_tile<T, HD>(sV, static_cast<const T*>(p.v) + b * p.s[3 * V] + hk * p.s[3 * V + 1],
                   p.s[3 * V + 2], k0, p.S);
  float dk[HD / 8][4], dv[HD / 8][4];
  zero(dk);
  zero(dv);
  int qt_begin, qt_end;
  q_tiles(p, k0, qt_begin, qt_end);
  for (int h = hk * group; h < (hk + 1) * group; ++h) {
    const T* qg = static_cast<const T*>(p.q) + b * p.s[3 * Q] + h * p.s[3 * Q + 1];
    const T* dog = static_cast<const T*>(p.dO) + b * p.s[3 * DO] + h * p.s[3 * DO + 1];
    const float* lse = p.lse + (static_cast<long long>(b) * p.nh + h) * p.ld;
    const float* delta = p.delta + (static_cast<long long>(b) * p.nh + h) * p.ld;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // every warp is done with the previous q, dO tiles
      load_tile<T, HD>(sQ, qg, p.s[3 * Q + 2], q0, p.S);
      load_tile<T, HD>(sdO, dog, p.s[3 * DO + 2], q0, p.S);
      for (int i = threadIdx.x; i < kTile; i += kThreads) {
        const bool in = q0 + i < p.S;
        sL[i] = in ? lse[q0 + i] : 0.f;
        sD[i] = in ? delta[q0 + i] : 0.f;
      }
      __syncthreads();
      // P^T: kv rows, query columns
      float pt[kTile / 8][4];
      zero(pt);
      Mma<T, HD>::ab_t(pt, sK, sQ, sP, warp, g, t);
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t + (e & 1);
          pt[j][e] = live(p, q0 + c, krow[e / 2]) ? exp2f(pt[j][e] * p.scale_log2 - sL[c]) : 0.f;
        }
      Mma<T, HD>::ab(dv, pt, sdO, sP, warp, g, t);
      // dS^T = P^T * (V dO^T - D)
      float ds[kTile / 8][4];
      zero(ds);
      Mma<T, HD>::ab_t(ds, sV, sdO, sP, warp, g, t);
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[j][e] = pt[j][e] * (ds[j][e] - sD[j * 8 + 2 * t + (e & 1)]);
      Mma<T, HD>::ab(dk, ds, sQ, sP, warp, g, t);
    }
  }
  store_rows<T, HD>(static_cast<T*>(p.dk) + b * p.s[3 * DK] + hk * p.s[3 * DK + 1],
                    p.s[3 * DK + 2], k0, p.S, dk, p.scale, warp, g, t);
  store_rows<T, HD>(static_cast<T*>(p.dv) + b * p.s[3 * DV] + hk * p.s[3 * DV + 1],
                    p.s[3 * DV + 2], k0, p.S, dv, 1.f, warp, g, t);
}

// ---- dQ per (q tile, head, b) ------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int LD = tile_ld<T, HD>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sdO = sQ + kTile * LD;
  T* sK = sdO + kTile * LD;
  T* sV = sK + kTile * LD;
  float* sP = reinterpret_cast<float*>(sV + kTile * LD);

  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.nh / p.nkv);
  const int q0 = qt * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const T* kg = static_cast<const T*>(p.k) + b * p.s[3 * K] + hk * p.s[3 * K + 1];
  const T* vg = static_cast<const T*>(p.v) + b * p.s[3 * V] + hk * p.s[3 * V + 1];
  const long long bh = (static_cast<long long>(b) * p.nh + h) * p.ld;
  float L[2], D[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    L[i] = row[i] < p.S ? p.lse[bh + row[i]] : 0.f;
    D[i] = row[i] < p.S ? p.delta[bh + row[i]] : 0.f;
  }

  load_tile<T, HD>(sQ, static_cast<const T*>(p.q) + b * p.s[3 * Q] + h * p.s[3 * Q + 1],
                   p.s[3 * Q + 2], q0, p.S);
  load_tile<T, HD>(sdO, static_cast<const T*>(p.dO) + b * p.s[3 * DO] + h * p.s[3 * DO + 1],
                   p.s[3 * DO + 2], q0, p.S);
  float dq[HD / 8][4];
  zero(dq);
  int kt_begin, kt_end;
  kv_tiles(p, q0, kt_begin, kt_end);
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, HD>(sK, kg, p.s[3 * K + 2], k0, p.S);
    load_tile<T, HD>(sV, vg, p.s[3 * V + 2], k0, p.S);
    __syncthreads();
    float pr[kTile / 8][4], ds[kTile / 8][4];
    zero(pr);
    zero(ds);
    Mma<T, HD>::ab_t(pr, sQ, sK, sP, warp, g, t);
    Mma<T, HD>::ab_t(ds, sdO, sV, sP, warp, g, t);
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2;
        const float pe = live(p, row[i], k0 + j * 8 + 2 * t + (e & 1))
                             ? exp2f(pr[j][e] * p.scale_log2 - L[i]) : 0.f;
        ds[j][e] = pe * (ds[j][e] - D[i]);
      }
    Mma<T, HD>::ab(dq, ds, sK, sP, warp, g, t);
  }
  store_rows<T, HD>(static_cast<T*>(p.dq) + b * p.s[3 * DQ] + h * p.s[3 * DQ + 1],
                    p.s[3 * DQ + 2], q0, p.S, dq, p.scale, warp, g, t);
}

template <typename Kernel>
cudaError_t run(Kernel kernel, dim3 grid, int bytes, const BwdParams& p, cudaStream_t stream) {
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int HD>
int launch(const BwdParams& p, int B, cudaStream_t stream) {
  const int tiles = (p.S + kTile - 1) / kTile;
  cudaError_t e = run(flash_bwd_dkdv_kernel<T, HD>, dim3(tiles, p.nkv, B),
                      smem_bytes<T, HD>(4, 2, true), p, stream);
  if (e == cudaSuccess)
    e = run(flash_bwd_dq_kernel<T, HD>, dim3(tiles, p.nh, B), smem_bytes<T, HD>(4, 0, true), p,
            stream);
  return static_cast<int>(e);
}

int launch_f32(const BwdParams& p, int B, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<float, 32>(p, B, stream);
    case 64: return launch<float, 64>(p, B, stream);
    case 80: return launch<float, 80>(p, B, stream);
    case 128: return launch<float, 128>(p, B, stream);
    case 192: return launch<float, 192>(p, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int HD> int info(int* out) {
  const int kv_bytes = smem_bytes<T, HD>(4, 2, true), q_bytes = smem_bytes<T, HD>(4, 0, true);
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kv_bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, q_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int err = kernel_info(flash_bwd_dkdv_kernel<T, HD>, kThreads, kv_bytes, out);
  return err != 0 ? err : kernel_info(flash_bwd_dq_kernel<T, HD>, kThreads, q_bytes, out + 4);
}

}  // namespace
}  // namespace repro_torch

// q, dO, dq: [B, nh, S, hd]; k, v, dk, dv: [B, nkv, S, hd], as element
// strides (batch, head, seq) in `strides` (q, k, v, dO, dq, dk, dv in turn,
// 21 values); hd contiguous. lse (log2 units, the forward's) and delta:
// fp32 [B, nh, ld]. Returns the cudaError_t of the launches (0 on success).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* dO, void* dq, void* dk, void* dv,
                                          const void* lse, const void* delta,
                                          const long long* strides, int B, int nh, int nkv, int S,
                                          int hd, int causal, int window, int ld, int dtype,
                                          void* stream) {
  using namespace repro_torch;
  if (B <= 0 || S <= 0 || nkv <= 0 || nh % nkv != 0 || window < 0 || ld < S)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dO = dO;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  for (int i = 0; i < 21; ++i) p.s[i] = strides[i];
  p.nh = nh;
  p.nkv = nkv;
  p.S = S;
  p.causal = causal;
  p.window = window;
  p.ld = ld;
  p.scale = 1.f / sqrtf(static_cast<float>(hd));
  p.scale_log2 = kLog2e * p.scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_f32(p, B, hd, s);
  if (dtype == kBFloat16 && hd == 32) return launch<__nv_bfloat16, 32>(p, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// D = rowsum(dO * O) for both backward paths: o, dO [B, nh, S, hd] as
// element strides (batch, head, seq) in `strides` (o, dO: 6 values), hd
// contiguous, rows 16-byte aligned, hd a whole number of 16-byte vectors;
// delta: fp32 [B, nh, ld], written in full (0 past S).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_bwd_delta_launch(const void* o, const void* dO, void* delta,
                                                const long long* strides, int B, int nh, int S,
                                                int hd, int ld, int dtype, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || S <= 0 || ld < S) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != kFloat32 && dtype != kBFloat16) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = hd * (dtype == kFloat32 ? 4 : 2);
  const int chunks = bytes / 16;   // 16-byte vectors a row
  if (hd <= 0 || bytes % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  int width = 1;                   // lanes a row: the power of two that covers the vectors,
  while (width < chunks && width < 32) width *= 2;   // at most a warp
  const long long rows = static_cast<long long>(B) * nh * ld;
  const unsigned blocks = static_cast<unsigned>((rows * width + 255) / 256);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* d = static_cast<float*>(delta);
  const long long* st = strides;
  if (dtype == kFloat32)
    flash_bwd_delta_kernel<float><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(o), static_cast<const float*>(dO), d, st[0], st[1], st[2],
        st[3], st[4], st[5], nh, S, ld, width, chunks, rows);
  else
    flash_bwd_delta_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dO), d, st[0],
        st[1], st[2], st[3], st[4], st[5], nh, S, ld, width, chunks, rows);
  return static_cast<int>(cudaGetLastError());
}

// For (hd, dtype) as flash_attention_bwd_launch takes them (fp32 at hd 32,
// 64, 80, 128 or 192, bf16 at hd 32; any other returns
// cudaErrorInvalidValue), per kernel (dK/dV, dQ) in turn, four ints:
// registers a thread, local-memory bytes a thread (spills), dynamic shared
// memory bytes, CTAs that fit on one SM. Returns a cudaError_t.
extern "C" int flash_attention_bwd_info(int hd, int dtype, int* out) {
  using namespace repro_torch;
  if (dtype == kBFloat16) {
    return hd == 32 ? info<__nv_bfloat16, 32>(out) : static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype != kFloat32) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 32: return info<float, 32>(out);
    case 64: return info<float, 64>(out);
    case 80: return info<float, 80>(out);
    case 128: return info<float, 128>(out);
    case 192: return info<float, 192>(out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
