// Batched chain replay of the PALM simulator's co-design tier
// (repro_torch.core.fastbatch): one launch evaluates one compiled chain
// program for every configuration of a signature group, one thread a
// configuration.
//
// Replaces: the numpy evaluator ``_BatchEval`` of the reference's batched
// tier (src/repro/core/fastbatch.py:283), whose segment fold is
// ``np.add.accumulate`` over the leaf matrix. A Pallas kernel did not
// exist for it; it is the only array work of the simulator.
//
// Arithmetic: only fp64 adds (__dadd_rn), compares and selects. There is
// no multiply anywhere, so nothing can be contracted into an FMA, and each
// time is the strict left fold P[i+1] = P[i] + x_i that the scalar tier
// and the event kernel compute. A parallel scan (torch.cumsum) would
// reassociate and change the bits, which is why the fold is written out
// here. A par join is numpy's NaN-propagating maximum:
// (a >= b || a != a) ? a : b, with the running best as a.
//
// Program format (int32, built by fastbatch._Compiler, walked the same way
// by kernels/ref.py:chain_replay_ref), depth first:
//   SEG k h n0 n1 n2 | adv[k] | hold_pos[h] | rows0[n0] rows1[n1] rows2[n2]
//       advance t by V[adv[i]] in order; hold j writes [P[pos], P[pos+1]]
//       into the next hold slot; accumulator a adds V[rows_a] in order
//   PAR        push t;           BRANCH_END  fold t into the best, t = pushed t
//   PAR_END    t = best (t if the par had no branch), pop
//   SPAWN      push t;           SPAWN_END   write t to the next spawn slot,
//                                            t = pushed t, pop
//   END
// V is (rows, G) row-major, so a row is read coalesced across threads.
// Outputs: t_out (G), hold_start/hold_end (holds, G) in emission order,
// spawn_end (spawns, G), accs (3, G) updated in place.
//
// Bound: bytes. A launch reads each referenced leaf row once and writes
// 8 bytes a hold, spawn and time per configuration; the adds are a
// handful per byte. At the groups' sizes (G 256) a launch moves tens of
// KB, so it sits at launch latency; fusing a group's replay into one
// launch is later work.
#include "common.cuh"

namespace repro_torch {
namespace {

// opcodes: kernels/ref.py CHAIN_OPS
constexpr int kSeg = 0;
constexpr int kPar = 1;
constexpr int kBranchEnd = 2;
constexpr int kParEnd = 3;
constexpr int kSpawn = 4;
constexpr int kSpawnEnd = 5;
constexpr int kEnd = 6;
constexpr int kThreads = 128;

__device__ __forceinline__ double np_maximum(double a, double b) {
  return (a >= b || a != a) ? a : b;
}

template <int DEPTH>
__global__ void __launch_bounds__(kThreads)
chain_replay_kernel(const int* __restrict__ code, const double* __restrict__ V, int G,
                    const double* __restrict__ t_in, double* __restrict__ t_out,
                    double* __restrict__ hold_start, double* __restrict__ hold_end,
                    double* __restrict__ spawn_end, double* __restrict__ accs) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= G) return;
  const size_t ld = static_cast<size_t>(G);
  double t = t_in[g];
  double acc[3] = {accs[g], accs[ld + g], accs[2 * ld + g]};
  double base[DEPTH];   // the time a par or spawn started at
  double best[DEPTH];   // a par's join so far
  bool first[DEPTH];    // no branch of the par has ended yet
  int sp = 0;
  size_t hold = 0, spawn = 0;
  int pc = 0;
  for (;;) {
    const int op = code[pc];
    if (op == kSeg) {
      const int k = code[pc + 1], h = code[pc + 2];
      const int n[3] = {code[pc + 3], code[pc + 4], code[pc + 5]};
      const int* adv = code + pc + 6;
      const int* pos = adv + k;
      int j = 0;
      for (int i = 0; i < k; ++i) {
        const double prev = t;
        t = __dadd_rn(t, V[static_cast<size_t>(adv[i]) * ld + g]);
        for (; j < h && pos[j] == i; ++j, ++hold) {
          hold_start[hold * ld + g] = prev;
          hold_end[hold * ld + g] = t;
        }
      }
      const int* rows = pos + h;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        for (int i = 0; i < n[a]; ++i)
          acc[a] = __dadd_rn(acc[a], V[static_cast<size_t>(rows[i]) * ld + g]);
        rows += n[a];
      }
      pc += 6 + k + h + n[0] + n[1] + n[2];
    } else if (op == kPar || op == kSpawn) {
      base[sp] = t;
      first[sp] = true;
      ++sp;
      ++pc;
    } else if (op == kBranchEnd) {
      const int f = sp - 1;
      best[f] = first[f] ? t : np_maximum(best[f], t);
      first[f] = false;
      t = base[f];
      ++pc;
    } else if (op == kParEnd) {
      --sp;
      if (!first[sp]) t = best[sp];
      ++pc;
    } else if (op == kSpawnEnd) {
      --sp;
      spawn_end[spawn * ld + g] = t;
      ++spawn;
      t = base[sp];
      ++pc;
    } else {  // kEnd (the compiler emits no other opcode)
      break;
    }
  }
  t_out[g] = t;
  accs[g] = acc[0];
  accs[ld + g] = acc[1];
  accs[2 * ld + g] = acc[2];
}

template <int DEPTH>
int launch(const int* code, const double* V, int G, const double* t_in, double* t_out,
           double* hold_start, double* hold_end, double* spawn_end, double* accs,
           cudaStream_t stream) {
  const int blocks = (G + kThreads - 1) / kThreads;
  chain_replay_kernel<DEPTH><<<blocks, kThreads, 0, stream>>>(
      code, V, G, t_in, t_out, hold_start, hold_end, spawn_end, accs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// code: the group's int32 program buffer, `entry` the program's first
// word; V: (rows, G) fp64; t_in, t_out: (G); hold_start, hold_end:
// (holds, G); spawn_end: (spawns, G); accs: (3, G), read and written.
// `depth` is the program's deepest par/spawn nesting: the thread's stack
// is the smallest instantiation that holds it (kernels/chain_replay.py
// MAX_DEPTH is the largest). Returns the cudaError_t of the launch.
extern "C" int chain_replay_launch(const void* code, int entry, const void* V, int G,
                                   const void* t_in, void* t_out, void* hold_start,
                                   void* hold_end, void* spawn_end, void* accs, int depth,
                                   void* stream) {
  using namespace repro_torch;
  if (G <= 0 || entry < 0 || depth < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int* c = static_cast<const int*>(code) + entry;
  const double* v = static_cast<const double*>(V);
  const double* ti = static_cast<const double*>(t_in);
  double* to = static_cast<double*>(t_out);
  double* hs = static_cast<double*>(hold_start);
  double* he = static_cast<double*>(hold_end);
  double* se = static_cast<double*>(spawn_end);
  double* ac = static_cast<double*>(accs);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (depth <= 4) return launch<4>(c, v, G, ti, to, hs, he, se, ac, s);
  if (depth <= 8) return launch<8>(c, v, G, ti, to, hs, he, se, ac, s);
  if (depth <= 16) return launch<16>(c, v, G, ti, to, hs, he, se, ac, s);
  if (depth <= 32) return launch<32>(c, v, G, ti, to, hs, he, se, ac, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers, local bytes, shared bytes and CTAs an SM of the instantiation
// for `depth`, into out[0..3]. Returns a cudaError_t.
extern "C" int chain_replay_info(int depth, int* out) {
  using namespace repro_torch;
  if (depth <= 4) return kernel_info(chain_replay_kernel<4>, kThreads, 0, out);
  if (depth <= 8) return kernel_info(chain_replay_kernel<8>, kThreads, 0, out);
  if (depth <= 16) return kernel_info(chain_replay_kernel<16>, kThreads, 0, out);
  if (depth <= 32) return kernel_info(chain_replay_kernel<32>, kThreads, 0, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
