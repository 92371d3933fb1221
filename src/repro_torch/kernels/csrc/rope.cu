// Rotary position embedding of a layer's q and k in one launch, for Hopper
// (sm_90a), and its backward.
//
// Replaces no TPU kernel: the reference rotates q and k in plain JAX
// (src/repro/models/layers.py, rope), which XLA fuses into the producers.
// In eager PyTorch the same lines (kernels/ref.py rope_ref) took 16
// launches a call, two calls a layer, and moved fp32 temporaries of
// [B,S,n,hd/2] four times over.
//
// Bound on the H100: memory. q and k are read once and written once:
// 2 * B*S*(nh+nkv)*hd * bytes / 3.35 TB/s. The fp32 table cos, sin
// [B,S,hd/2] is a head's row of x in size or less, and is read from L2 by
// the (nh+nkv) heads of its token. A few flops an element.
//
// Arithmetic: the eager version's, bit for bit. Forward, with x1, x2 the two
// halves of a head and c, s the table:
//   out1 = T(fl(x1 c) - fl(x2 s)),  out2 = T(fl(x2 c) + fl(x1 s)),
// every fp32 product and sum rounded once (__fmul_rn, __fsub_rn, __fadd_rn:
// never contracted into an FMA) and one round to nearest even into T at the
// end. Backward (backward = 1, x the gradients g1, g2), autograd's order:
//   dx1 = T(T(fl(g1 c)) + T(fl(g2 s))),  dx2 = T(T(fl(g2 c)) - T(fl(g1 s))),
// each product cast to T as autograd casts a mul's gradient to its input's
// type, then one more fp32 add of 0, as autograd's sum of the two halves'
// zero-padded slice gradients makes (a -0 becomes +0). In fp32 the casts
// are no-ops.
//
// Design: a thread takes one vector of V elements of the first half of a
// head, the matching vector of the second half, and the table's V cos and
// V sin values for its token, and walks up to kHeads heads of that token
// with the table in registers; all of its loads are issued before the
// first store. Threads are ordered (token, head slot, vector) with the
// vector fastest, so a warp reads and writes whole 128-byte rows of heads.
// V is 16 bytes of T (8 bf16, 4 fp32) where hd/2 is a multiple of it and
// every base is 16-byte aligned, 1 otherwise (kernels/rope.py picks).
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kHeads = 4;          // heads a thread walks

template <typename T, int V> struct alignas(sizeof(T) * V) Pack { T e[V]; };

template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// V fp32 values from p, in 16-byte loads where V allows
template <int V> __device__ __forceinline__ void load_table(float (&out)[V], const float* p) {
  constexpr int W = V < 4 ? V : 4;
#pragma unroll
  for (int i = 0; i < V / W; ++i) {
    const Pack<float, W> u = reinterpret_cast<const Pack<float, W>*>(p)[i];
#pragma unroll
    for (int e = 0; e < W; ++e) out[i * W + e] = u.e[e];
  }
}

template <typename T, int V, bool kBwd>
__global__ void __launch_bounds__(kThreads)
rotary_qk_kernel(const T* __restrict__ q, const T* __restrict__ k, const float* __restrict__ cos_t,
                 const float* __restrict__ sin_t, T* __restrict__ q_out, T* __restrict__ k_out,
                 int items, int nh, int nkv, int hd, int slots) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= items) return;
  const int half = hd / 2, nvec = half / V;
  const int j = i % nvec;
  const int slot = (i / nvec) % slots;
  const size_t tok = i / (nvec * slots);

  float c[V], s[V];
  load_table<V>(c, cos_t + tok * half + j * V);
  load_table<V>(s, sin_t + tok * half + j * V);

  Pack<T, V> x1[kHeads], x2[kHeads];
  size_t off[kHeads];
#pragma unroll
  for (int u = 0; u < kHeads; ++u) {
    const int h = slot * kHeads + u;
    if (h >= nh + nkv) break;
    const T* x;
    if (h < nh) {
      off[u] = (tok * nh + h) * hd + j * V;
      x = q + off[u];
    } else {
      off[u] = (tok * nkv + (h - nh)) * hd + j * V;
      x = k + off[u];
    }
    x1[u] = *reinterpret_cast<const Pack<T, V>*>(x);
    x2[u] = *reinterpret_cast<const Pack<T, V>*>(x + half);
  }
#pragma unroll
  for (int u = 0; u < kHeads; ++u) {
    const int h = slot * kHeads + u;
    if (h >= nh + nkv) break;
    Pack<T, V> o1, o2;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float a = to_f32(x1[u].e[e]), b = to_f32(x2[u].e[e]);
      float r1, r2;
      if constexpr (!kBwd) {
        r1 = __fsub_rn(__fmul_rn(a, c[e]), __fmul_rn(b, s[e]));
        r2 = __fadd_rn(__fmul_rn(b, c[e]), __fmul_rn(a, s[e]));
      } else {
        r1 = __fadd_rn(round_to<T>(__fmul_rn(a, c[e])), round_to<T>(__fmul_rn(b, s[e])));
        r2 = __fsub_rn(round_to<T>(__fmul_rn(b, c[e])), round_to<T>(__fmul_rn(a, s[e])));
        r1 = __fadd_rn(round_to<T>(r1), 0.f);
        r2 = __fadd_rn(round_to<T>(r2), 0.f);
      }
      o1.e[e] = from_f32<T>(r1);
      o2.e[e] = from_f32<T>(r2);
    }
    T* y = (h < nh ? q_out : k_out) + off[u];
    *reinterpret_cast<Pack<T, V>*>(y) = o1;
    *reinterpret_cast<Pack<T, V>*>(y + half) = o2;
  }
}

template <typename T, int V>
int launch(const void* q, const void* k, const void* cos_t, const void* sin_t, void* q_out,
           void* k_out, int tokens, int nh, int nkv, int hd, bool backward, cudaStream_t stream) {
  const int slots = (nh + nkv + kHeads - 1) / kHeads;
  const long long items = static_cast<long long>(tokens) * slots * (hd / 2 / V);
  if (items >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((items + kThreads - 1) / kThreads);
  auto kernel = backward ? rotary_qk_kernel<T, V, true> : rotary_qk_kernel<T, V, false>;
  kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<T*>(q_out), static_cast<T*>(k_out),
      static_cast<int>(items), nh, nkv, hd, slots);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// q, q_out: [tokens, nh, hd]; k, k_out: [tokens, nkv, hd]; cos, sin:
// [tokens, hd/2] fp32; all contiguous. vec = 1 moves 16-byte vectors (hd/2
// a multiple of 16 bytes of the type, every base 16-byte aligned), vec = 0
// single elements. backward = 1 runs the gradient (q, k are then the
// outputs' gradients). Returns the cudaError_t of the launch (0 on success).
extern "C" int rope_launch(const void* q, const void* k, const void* cos_t, const void* sin_t,
                           void* q_out, void* k_out, int tokens, int nh, int nkv, int hd,
                           int dtype, int vec, int backward, void* stream) {
  using namespace repro_torch;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tokens <= 0 || nh <= 0 || nkv <= 0 || hd <= 0 || hd % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int half = hd / 2;
  const bool bwd = backward != 0;
  if (dtype == kBFloat16) {
    if (!vec) return launch<__nv_bfloat16, 1>(q, k, cos_t, sin_t, q_out, k_out, tokens, nh, nkv,
                                              hd, bwd, s);
    if (half % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
    return launch<__nv_bfloat16, 8>(q, k, cos_t, sin_t, q_out, k_out, tokens, nh, nkv, hd, bwd, s);
  }
  if (dtype == kFloat32) {
    if (!vec) return launch<float, 1>(q, k, cos_t, sin_t, q_out, k_out, tokens, nh, nkv, hd, bwd,
                                      s);
    if (half % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
    return launch<float, 4>(q, k, cos_t, sin_t, q_out, k_out, tokens, nh, nkv, hd, bwd, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
