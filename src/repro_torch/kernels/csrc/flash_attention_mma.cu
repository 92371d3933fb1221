// GQA flash attention (forward), causal or not, with an optional sliding
// window: the mma.sync / FMA kernel, for fp32 at head_dim 32, 64, 80, 128
// and 192 and for bf16 at head_dim 32. bf16 at head_dim 64, 80, 128 and 192
// goes to the wgmma + TMA kernel in flash_attention.cu;
// kernels/flash_attention.py picks by (dtype, head_dim). At hd 192 fp32 a
// CTA stages (64 + 2 x 64) rows of 196 floats and the p scratch: 167,936
// bytes of shared memory.
//
// Replaces: src/repro/kernels/flash_attention.py, _flash_kernel /
// flash_attention. o = softmax(mask(q k^T * hd^-0.5)) v per head, with the
// kv head h / (nh / nkv), fp32 online softmax (m, l, acc), tiles wholly in
// the causal future or outside the window skipped, and rows with nothing
// to attend to written as 0.
//
// Bound on the H100: operations, 4*B*nh*S^2*hd/2 flops of causal pairs;
// fp32 runs on the FMA units (67 TFLOP/s), bf16 on the tensor cores.
//
// Design (the port's first flash kernel, kept for the paths above):
//  * One 128-thread CTA per (q tile of 64 rows, head, batch). The TPU's
//    sequential kv-block grid axis is a loop inside the CTA, because
//    Hopper runs blocks in no order. Tiles run heaviest first (the last
//    q tile has the most causal kv tiles).
//  * Each of the four warps owns 16 query rows. q, then each 64-row k and
//    v tile, are staged in shared memory with 16-byte loads (rows padded
//    by 16 bytes so the fragment reads hit distinct banks). The tail past
//    S is zero-filled and masked here: the tensors are never padded.
//  * bf16: q k^T and p v run on the tensor cores through
//    mma.sync.m16n8k16 with fp32 accumulation; q's fragments stay in
//    registers for the whole kv loop, and p goes from the score
//    accumulators straight into the A fragments of p v (rounded to bf16;
//    l is summed from the fp32 p). fp32: the same register layout, filled
//    by plain FMAs, so fp32 keeps full precision (no TF32).
//  * m, l and acc stay in fp32 registers; the four threads that share a
//    row reduce with two shuffles. GQA reads the kv head directly: no
//    repeated k/v in device memory.
//  * Strides are arguments: q, k, v and o may be [B,nh,S,hd] tensors or
//    views of [B,S,nh,hd] ones, with hd contiguous.
//  * Given an LSE buffer (training), each row's log-sum-exp in log2 units,
//    m + log2(l) (-inf for a row with nothing to attend to), goes to it for
//    the backward.
#include <math.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kBQ = 64;       // query rows per CTA
constexpr int kBK = 64;       // kv rows per tile
constexpr int kWarps = 4;     // 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;   // [B, nh, lse_ld] fp32, or null
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  int nh, nkv, S, causal, window, lse_ld;
  float scale_log2;  // the softmax scale (hd^-0.5 unless given) * log2(e): scores go through exp2
};

// row stride of a staged tile, padded by 16 bytes
template <typename T, int HD> __host__ __device__ constexpr int tile_ld() { return HD + 16 / sizeof(T); }
constexpr int kLdP = kBK + 4;  // fp32 p scratch row stride (fp32 path only)

template <typename T, int HD> constexpr int smem_bytes() {
  return (kBQ + 2 * kBK) * tile_ld<T, HD>() * static_cast<int>(sizeof(T)) +
         (sizeof(T) == 4 ? kWarps * 16 * kLdP * 4 : 0);
}

// Copy rows [r0, r0 + ROWS) of a [S, HD] strided slab into shared memory,
// zero-filling rows at or past S.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long row_stride, int r0,
                                          int S) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = HD / kVec;
  constexpr int LD = tile_ld<T, HD>();
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
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

// Fragment layout (mma.m16n8k16 accumulator), used by both types: lane
// (g = lane / 4, t = lane % 4) holds, for each 8-column block j,
// c[j][0..1] at row g, columns 8j + 2t + {0,1}, and c[j][2..3] at row
// g + 8, the same columns. Rows are relative to the warp's 16.
template <typename T, int HD> struct Mma;

template <int HD> struct Mma<__nv_bfloat16, HD> {
  using T = __nv_bfloat16;
  static constexpr int LD = tile_ld<T, HD>();
  uint32_t qf[HD / 16][4];  // q's A fragments, loaded once

  __device__ __forceinline__ void load_q(const T* sQ, int warp, int g, int t) {
    const T* r0 = sQ + (warp * 16 + g) * LD + 2 * t;
    const T* r1 = r0 + 8 * LD;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      qf[kk][0] = ld_u32(r0 + kk * 16);
      qf[kk][1] = ld_u32(r1 + kk * 16);
      qf[kk][2] = ld_u32(r0 + kk * 16 + 8);
      qf[kk][3] = ld_u32(r1 + kk * 16 + 8);
    }
  }

  // s[j] = q k^T for kv columns 8j .. 8j+7 of the tile
  __device__ __forceinline__ void qk(float (&s)[kBK / 8][4], const T* sQ, const T* sK, int warp,
                                     int g, int t) const {
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      const T* kr = sK + (j * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        mma_bf16(s[j], qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3], ld_u32(kr + kk * 16),
                 ld_u32(kr + kk * 16 + 8));
    }
  }

  // acc += p v; p comes in the accumulator layout of qk and becomes the
  // A fragment of this product without leaving registers.
  __device__ __forceinline__ void pv(float (&acc)[HD / 8][4], const float (&p)[kBK / 8][4],
                                     const T* sV, float*, int, int g, int t) const {
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a0 = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
      const uint32_t a1 = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
      const uint32_t a2 = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
      const T* v0 = sV + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const T* vn = v0 + n * 8;
        mma_bf16(acc[n], a0, a1, a2, a3, pair_bf16(vn, vn + LD),
                 pair_bf16(vn + 8 * LD, vn + 9 * LD));
      }
    }
  }
};

template <int HD> struct Mma<float, HD> {
  using T = float;
  static constexpr int LD = tile_ld<T, HD>();

  __device__ __forceinline__ void load_q(const T*, int, int, int) {}

  __device__ __forceinline__ void qk(float (&s)[kBK / 8][4], const T* sQ, const T* sK, int warp,
                                     int g, int t) const {
    const T* q0 = sQ + (warp * 16 + g) * LD;
    const T* q1 = q0 + 8 * LD;
    const T* kr = sK + 2 * t * LD;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float qa = q0[d], qb = q1[d];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const float k0 = kr[j * 8 * LD + d], k1 = kr[(j * 8 + 1) * LD + d];
        s[j][0] = fmaf(qa, k0, s[j][0]);
        s[j][1] = fmaf(qa, k1, s[j][1]);
        s[j][2] = fmaf(qb, k0, s[j][2]);
        s[j][3] = fmaf(qb, k1, s[j][3]);
      }
    }
  }

  // p goes through the warp's slice of shared memory, since each row of
  // the product needs all 64 of its p values.
  __device__ __forceinline__ void pv(float (&acc)[HD / 8][4], const float (&p)[kBK / 8][4],
                                     const T* sV, float* sP, int warp, int g, int t) const {
    float* pw = sP + warp * 16 * kLdP;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      pw[g * kLdP + j * 8 + 2 * t] = p[j][0];
      pw[g * kLdP + j * 8 + 2 * t + 1] = p[j][1];
      pw[(g + 8) * kLdP + j * 8 + 2 * t] = p[j][2];
      pw[(g + 8) * kLdP + j * 8 + 2 * t + 1] = p[j][3];
    }
    __syncwarp();
#pragma unroll 2
    for (int c = 0; c < kBK; ++c) {
      const float pa = pw[g * kLdP + c], pb = pw[(g + 8) * kLdP + c];
      const T* vr = sV + c * LD + 2 * t;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const float v0 = vr[n * 8], v1 = vr[n * 8 + 1];
        acc[n][0] = fmaf(pa, v0, acc[n][0]);
        acc[n][1] = fmaf(pa, v1, acc[n][1]);
        acc[n][2] = fmaf(pb, v0, acc[n][2]);
        acc[n][3] = fmaf(pb, v1, acc[n][3]);
      }
    }
    __syncwarp();
  }
};

__device__ __forceinline__ void store_pair(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const FlashParams p) {
  constexpr int LD = tile_ld<T, HD>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + kBQ * LD;
  T* sV = sK + kBK * LD;
  float* sP = reinterpret_cast<float*>(sV + kBK * LD);

  const int S = p.S;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.nh / p.nkv);
  const int q0 = qt * kBQ;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  load_tile<T, HD, kBQ>(sQ, qg, p.q_ss, q0, S);
  __syncthreads();
  Mma<T, HD> mma;
  mma.load_q(sQ, warp, g, t);

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // live kv tiles: skip the causal future and tiles the window has left
  const int k_end = p.causal ? min(S, q0 + kBQ) : S;
  const int kt_end = (k_end + kBK - 1) / kBK;
  const int kt_begin = p.window > 0 ? max(0, q0 - p.window + 1) / kBK : 0;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // every warp is done with the previous k, v tiles
    load_tile<T, HD, kBK>(sK, kg, p.k_ss, k0, S);
    load_tile<T, HD, kBK>(sV, vg, p.v_ss, k0, S);
    __syncthreads();

    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mma.qk(s, sQ, sK, warp, g, t);

    // scale, then mask (the reference's order), in log2 units
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row[e / 2];
        const int c = k0 + j * 8 + 2 * t + (e & 1);
        bool ok = c < S;
        if (p.causal) ok = ok && c <= r;
        if (p.window > 0) ok = ok && c > r - p.window;
        s[j][e] = ok ? s[j][e] * p.scale_log2 : -INFINITY;
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    }
    float corr[2], m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      m_use[i] = m_new == -INFINITY ? 0.f : m_new;  // row with nothing live yet
      corr[i] = exp2f(m[i] - m_use[i]);
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m_use[e / 2]);
        l[e / 2] += s[j][e];
      }
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    mma.pv(acc, s, sV, sP, warp, g, t);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (p.lse != nullptr && t == 0 && row[i] < S)
      p.lse[(static_cast<long long>(b) * p.nh + h) * p.lse_ld + row[i]] =
          l[i] > 0.f ? m[i] + log2f(l[i]) : -INFINITY;
    l[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;  // rows with nothing to attend to -> 0
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= S) continue;
    T* orow = og + row[i] * p.o_ss + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      store_pair(orow + n * 8, acc[n][2 * i] * l[i], acc[n][2 * i + 1] * l[i]);
  }
}

template <typename T, int HD>
int launch(const FlashParams& p, int B, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<T, HD>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.S + kBQ - 1) / kBQ, p.nh, B);
  flash_fwd_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const FlashParams& p, int B, int hd, cudaStream_t stream) {
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
  constexpr int bytes = smem_bytes<T, HD>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  return kernel_info(flash_fwd_kernel<T, HD>, kThreads, bytes, out);
}

}  // namespace
}  // namespace repro_torch

// q, o: [B, nh, S, hd] and k, v: [B, nkv, S, hd] as element strides
// (batch, head, seq) in `strides` (q, k, v, o in turn, 12 values); hd is
// contiguous. lse: fp32 [B, nh, lse_ld] (lse_ld >= S) for each row's
// log-sum-exp, or null. `scale` is the softmax scale; 0 takes hd^-0.5.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_mma_launch(const void* q, const void* k, const void* v, void* o,
                                          void* lse, const long long* strides, int B, int nh,
                                          int nkv, int S, int hd, int causal, int window,
                                          int lse_ld, float scale, int dtype, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || S <= 0 || nkv <= 0 || nh % nkv != 0 || (lse != nullptr && lse_ld < S))
    return static_cast<int>(cudaErrorInvalidValue);
  FlashParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.lse_ld = lse_ld;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_ss = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_ss = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_ss = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_ss = strides[11];
  p.nh = nh;
  p.nkv = nkv;
  p.S = S;
  p.causal = causal;
  p.window = window;
  p.scale_log2 = scale > 0.f ? kLog2e * scale : kLog2e / sqrtf(static_cast<float>(hd));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_f32(p, B, hd, s);
  if (dtype == kBFloat16 && hd == 32) return launch<__nv_bfloat16, 32>(p, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// For (hd, dtype) as flash_attention_mma_launch takes them (fp32 at hd 32,
// 64, 80, 128 or 192, bf16 at hd 32; any other returns
// cudaErrorInvalidValue), four ints: registers a thread, local-memory bytes
// a thread (spills), dynamic shared memory bytes, CTAs that fit on one SM.
// Returns a cudaError_t.
extern "C" int flash_attention_mma_info(int hd, int dtype, int* out) {
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
