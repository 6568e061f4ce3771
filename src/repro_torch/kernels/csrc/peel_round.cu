// One whole peel round of the nucleus decomposition, one launch per round.
//
// Replaces the TPU kernel repro/kernels/peel_round.py::fused_peel_round.
// For each r-clique r, over its CSR edges e in [offsets[r], offsets[r+1]):
//   dead(e) = no member of e's s-clique peeled before this round
//           & some member peeled before or at this round (deg <= level)
// and then, with delta[r] = #dead edges of r and a = !peeled & deg <= level:
//   deg'   = (peeled | a) ? deg : deg - delta
//   peeled'= peeled | a,   core' = a ? level : core,   order' = a ? rnd : order
//
// Bound on Hopper: memory.  A round reads every edge's member row (E * C
// int32), gathers deg and peeled of each member (2 * C int32 per edge, at
// random addresses) and streams 8 * n_r int32 of state in and out; it does
// almost no arithmetic.  Design: a block owns a contiguous range of
// r-cliques and one warp owns each r-clique.  The warp's lanes stride the
// r-clique's edge range, so neighbouring lanes read neighbouring member rows
// (coalesced), and __reduce_add_sync sums the dead edges.  There are no
// atomics, so the result is deterministic.  Outputs go to separate buffers:
// every dead test must read the PRE-round deg/peeled of other r-cliques.
// The one-hot MXU contraction and the scalar-prefetch chunk windows of the
// TPU kernel have no counterpart: the CSR offsets give each warp its range.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void peel_round_kernel(const int* __restrict__ offsets,
                                  const int* __restrict__ members, int C,
                                  const int* __restrict__ deg,
                                  const int* __restrict__ peeled,
                                  const int* __restrict__ core,
                                  const int* __restrict__ order,
                                  int* __restrict__ deg_out,
                                  int* __restrict__ peeled_out,
                                  int* __restrict__ core_out,
                                  int* __restrict__ order_out,
                                  int n_r, int level, int rnd) {
  const int lane = threadIdx.x & 31;
  const long long r =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= n_r) return;  // uniform per warp: the shuffle below stays legal
  const int e0 = offsets[r];
  const int e1 = offsets[r + 1];
  unsigned dead = 0;
  for (int e = e0 + lane; e < e1; e += 32) {
    const int* row = members + (long long)e * C;
    bool was = false;
    bool gone = false;
    for (int c = 0; c < C; ++c) {
      const int m = row[c];
      if (m < 0) {  // pad member: reads as already peeled
        was = true;
        gone = true;
        continue;
      }
      const bool p = peeled[m] != 0;
      was |= p;
      gone |= p || (deg[m] <= level);
    }
    dead += (!was && gone) ? 1u : 0u;
  }
  const unsigned delta = __reduce_add_sync(0xffffffffu, dead);
  if (lane == 0) {
    const int d = deg[r];
    const bool p = peeled[r] != 0;
    const bool a = !p && d <= level;
    const bool newp = p || a;
    deg_out[r] = newp ? d : d - (int)delta;
    peeled_out[r] = newp ? 1 : 0;
    core_out[r] = a ? level : core[r];
    order_out[r] = a ? rnd : order[r];
  }
}

}  // namespace

extern "C" int repro_peel_round(const int* offsets, const int* members, int C,
                                const int* deg, const int* peeled,
                                const int* core, const int* order,
                                int* deg_out, int* peeled_out, int* core_out,
                                int* order_out, int n_r, int level, int rnd,
                                cudaStream_t stream) {
  if (n_r <= 0) return (int)cudaSuccess;
  const int threads = 32 * kWarpsPerBlock;
  const long long blocks = ((long long)n_r + kWarpsPerBlock - 1) /
                           kWarpsPerBlock;
  peel_round_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      offsets, members, C, deg, peeled, core, order, deg_out, peeled_out,
      core_out, order_out, n_r, level, rnd);
  return (int)cudaGetLastError();
}
