// One whole peel round of the nucleus decomposition, one launch per round.
//
// Replaces the TPU kernel repro/kernels/peel_round.py::fused_peel_round
// (:142; body _round_kernel :93).  The round state is (deg, key, core,
// order) with key = peeled ? kPeeled : deg (kPeeled = INT32_MAX; a live
// deg is always below it).  For each r-clique r, over its CSR edges e in
// [offsets[r], offsets[r+1]):
//   dead(e) = no member of e's s-clique peeled before this round
//           & some member peeled before or at this round (deg <= level)
// and then, with delta[r] = #dead edges of r and a = !peeled & deg <= level:
//   deg'   = (peeled | a) ? deg : deg - delta
//   key'   = (peeled | a) ? kPeeled : deg',
//   core'  = a ? level : core,   order' = a ? rnd : order
//
// Bound on Hopper: memory, and only what the round needs.  deg' ignores
// delta for an r-clique peeled before the round or in it, so only the edges
// of the r-cliques that are live and survive the round ("needed") are read:
// their member rows (C int32 each) and each member's key (one int32 at a
// scattered address, a re-read of the key stream), beside the state stream
// (the offsets and 4 + 4 int32 per r-clique in and out).  On the smoke
// graph an r-clique has about 3 edges (hundreds on hubs); ~11 % of the
// r-cliques are needed in an average round, and they hold ~45 % of the
// edges.  Design:
//
//   * a block of 128 threads owns 128 consecutive r-cliques, one a thread:
//     each reads its own state (coalesced) and decides whether it is
//     needed.  A skipped r-clique costs its state stream only: its outputs
//     come from its own state, and its edges are never read;
//   * a block-wide exclusive scan of the needed r-cliques' edge counts lays
//     their edge ranges end to end, and the block's 128 lanes walk that
//     list 128 consecutive entries at a time.  So every lane works on a
//     needed edge whatever the run lengths (1 to 100,000 and more), and
//     neighbouring lanes read neighbouring member rows.  A lane finds its
//     edge's r-clique by a binary search of the scan in shared memory;
//   * a member's one gather is its key: key == kPeeled says "peeled before
//     the round", key <= level "peeled at it" (a live key is its deg);
//   * per warp step, a ballot of the dead flags and one of the lanes that
//     start an r-clique's run within the step give each run's dead count by
//     one popcount, added to the r-clique's counter in shared memory.  The
//     counts are integers, so the order of the adds cannot change them: the
//     result is deterministic, and deg' is written once, by its owner;
//   * the outputs are separate buffers: every dead test reads the PRE-round
//     key of other r-cliques.
//
// A block whose needed runs are very long walks them alone (one run of
// 100,000 edges is ~800 steps of one block); the other blocks are not held
// up.  The one-hot MXU contraction and the scalar-prefetch chunk windows of
// the TPU kernel have no counterpart: the CSR offsets give each r-clique
// its edges, and the scan gives each lane its edge.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // r-cliques of a block, and its lanes
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPeeled = 0x7fffffff;  // the key of a peeled r-clique

// edge's s-clique (member row `row`) dies this round: no member peeled
// before the round, some member peeled before or at it; a pad member -1
// reads as already peeled
__device__ __forceinline__ bool edge_dead(const int* __restrict__ row, int C,
                                          const int* __restrict__ key,
                                          int level) {
  bool was = false, gone = false;
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    const int m = __ldg(row + c);
    const int k = __ldg(key + (m < 0 ? 0 : m));  // pads gather at 0
    was |= m < 0 || k == kPeeled;
    gone |= k <= level;
  }
  return !was && gone;
}

__global__ void __launch_bounds__(kThreads)
peel_round_kernel(const int* __restrict__ offsets,
                  const int* __restrict__ members, int C,
                  const int* __restrict__ deg,
                  const int* __restrict__ key,
                  const int* __restrict__ core,
                  const int* __restrict__ order,
                  int* __restrict__ deg_out, int* __restrict__ key_out,
                  int* __restrict__ core_out, int* __restrict__ order_out,
                  int n_r, int level, int rnd) {
  __shared__ int s_first[kThreads];  // first plan edge of each r-clique
  __shared__ int s_excl[kThreads];   // exclusive scan of the needed counts
  __shared__ int s_dead[kThreads];   // dead edges counted per r-clique
  __shared__ int s_warp[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long r = (long long)blockIdx.x * kThreads + tid;
  const bool mine = r < n_r;

  // own state
  int d = 0, e0 = 0, cnt = 0;
  bool p = true;
  if (mine) {
    d = deg[r];
    p = key[r] == kPeeled;
  }
  const bool a = mine && !p && d <= level;
  const bool newp = p || a;
  if (mine && !newp) {  // needed: deg' takes its dead count
    e0 = offsets[r];
    cnt = offsets[r + 1] - e0;
  }

  // block-wide exclusive scan of the needed counts
  int incl = cnt;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  s_first[tid] = e0;
  s_dead[tid] = 0;
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int v = s_warp[w];
    before += w < warp ? v : 0;
    total += v;
  }
  s_excl[tid] = before + incl - cnt;
  __syncthreads();

  // walk the needed edges, kThreads consecutive list entries a step
  for (int k0 = 0; k0 < total; k0 += kThreads) {
    const int k = k0 + tid;
    int own = -1;
    bool dead = false;
    if (k < total) {
      // entry k's r-clique is the last t with s_excl[t] <= k: an r-clique
      // with no needed edges shares its successor's scan value
      int t = 0;
#pragma unroll
      for (int step = kThreads / 2; step > 0; step >>= 1)
        if (s_excl[t + step] <= k) t += step;
      own = t;
      const long long e = (long long)s_first[t] + (k - s_excl[t]);
      dead = edge_dead(members + e * C, C, key, level);
    }
    // each run's part of this warp's 32 entries starts at a `head` lane
    // and ends before the next one
    const unsigned dmask = __ballot_sync(kFull, dead);
    const int prev = __shfl_up_sync(kFull, own, 1);
    const bool head = own >= 0 && (lane == 0 || prev != own);
    const unsigned heads = __ballot_sync(kFull, head);
    if (head) {
      const unsigned later = heads & (0xfffffffeu << lane);
      const unsigned below_next =
          later ? (1u << (__ffs(later) - 1)) - 1u : kFull;
      const int n_dead = __popc(dmask & below_next & (kFull << lane));
      if (n_dead) atomicAdd(&s_dead[own], n_dead);
    }
  }
  __syncthreads();

  if (mine) {
    const int d_new = newp ? d : d - s_dead[tid];
    deg_out[r] = d_new;
    key_out[r] = newp ? kPeeled : d_new;
    core_out[r] = a ? level : core[r];
    order_out[r] = a ? rnd : order[r];
  }
}

}  // namespace

extern "C" int repro_peel_round(const int* offsets, const int* members, int C,
                                const int* deg, const int* key,
                                const int* core, const int* order,
                                int* deg_out, int* key_out, int* core_out,
                                int* order_out, int n_r, int level, int rnd,
                                cudaStream_t stream) {
  if (n_r <= 0) return (int)cudaSuccess;
  const long long blocks = ((long long)n_r + kThreads - 1) / kThreads;
  peel_round_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      offsets, members, C, deg, key, core, order, deg_out, key_out, core_out,
      order_out, n_r, level, rnd);
  return (int)cudaGetLastError();
}
