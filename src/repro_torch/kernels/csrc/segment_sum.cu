// Sorted-segment sum: out[n, :] = sum of data[k, :] over k with ids[k] == n.
//
// Replaces the TPU kernel repro/kernels/segment_sum.py::segment_sum_sorted.
// ids is ascending; rows whose id falls outside [0, n_segments) (the pad id
// n_segments, say) are skipped, and empty segments are 0.  int32 data
// accumulates in int32, float32 in float32.
//
// Bound on Hopper: memory.  The sum reads data (E * d) and ids (E) once and
// writes n_segments * d outputs; one add per element.  On the engine's plan
// (d = 1 int32, about three rows per segment) the bytes are 4 (2E + n_seg),
// so every lane has to stay busy on consecutive rows whatever the segment
// lengths, and nothing may cost a dependent load per segment.  Design:
//
//   * flat tiles: a block of 256 threads takes 4,096 consecutive rows,
//     loaded coalesced into shared memory (16-byte vector loads of ids and
//     data when d = 1 and both pointers are aligned; scalar loads at the
//     tail and for views), and each thread walks 16 consecutive of them
//     there (one pad word per 16 rows keeps the walk free of bank
//     conflicts);
//   * each thread sums the runs of equal ids inside its 16 rows; a run that
//     starts and ends there is written at once.  Runs that cross threads
//     are joined by a segmented scan over (has a run start, sum of the open
//     run): warp shuffles, then the 8 warp totals through shared memory; the
//     thread holding the next run's start writes the joined run;
//   * ownership: a segment is written by the block holding its first row.
//     When the block's last run goes on past its tile (long segments: a hub
//     edge lies in hundreds of triangles), one warp of that block reads on,
//     32 rows a step, to the run's end; a block whose tile holds no run
//     start writes nothing;
//   * gaps: the row that starts a run writes zeros to the segments between
//     the previous id and its own.  The grid has one tile more than E needs,
//     so the virtual row E (id INT_MAX) starts a run in the last block and
//     fills the segments after the last id; rows before 0 carry INT_MIN.
//
// No atomics and no search over all of E: every output is written once, in
// a summation order fixed by E and the ids, so float32 results are
// deterministic.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;                 // consecutive rows per thread
constexpr int kTile = kThreads * kItems;   // rows per block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Vec4;
template <>
struct Vec4<int> {
  using type = int4;
};
template <>
struct Vec4<float> {
  using type = float4;
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// zeros for the empty segments strictly between ids lo and hi (column j)
template <typename T>
__device__ __forceinline__ void fill_gap(T* out, int lo, int hi, int n_seg,
                                         int d, int j) {
  const long long a = lo + 1LL > 0 ? lo + 1LL : 0;
  const long long b = hi < n_seg ? hi : n_seg;
  for (long long s = a; s < b; ++s) out[s * d + j] = T(0);
}

template <typename T>
__device__ __forceinline__ void put(T* out, int id, int n_seg, int d, int j,
                                    T v) {
  if (id >= 0 && id < n_seg) out[(long long)id * d + j] = v;
}

// tile row k lives at k + k / 16 in shared memory: a thread's 16 rows are
// contiguous and the threads of a warp start 17 words apart (no bank
// conflicts)
__device__ __forceinline__ int pad(int k) { return k + (k >> 4); }

// column j of a tile of rows (src[k * d + j] for tile rows k; rows past E
// read as `fill`) into shared memory, coalesced: 16-byte vectors when kVec
// (d = 1, aligned) and the tile is whole
template <typename U, bool kVec>
__device__ __forceinline__ void load_tile(U* dst, const U* src,
                                          long long tile0, long long E,
                                          int d, int j, U fill, int tid) {
  if (kVec && tile0 + kTile <= E) {
    using V = typename Vec4<U>::type;
    const V* p = reinterpret_cast<const V*>(src + tile0);
#pragma unroll
    for (int m = 0; m < kItems / 4; ++m) {
      const int c = tid + kThreads * m;
      const V x = __ldg(p + c);
      const int k = pad(4 * c);
      dst[k] = x.x;
      dst[k + 1] = x.y;
      dst[k + 2] = x.z;
      dst[k + 3] = x.w;
    }
  } else {
#pragma unroll 4
    for (int m = 0; m < kItems; ++m) {
      const int k = tid + kThreads * m;
      dst[pad(k)] = tile0 + k < E ? __ldg(src + (tile0 + k) * d + j) : fill;
    }
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    segment_sum_kernel(const T* __restrict__ data,
                       const int* __restrict__ ids, long long E, int d,
                       int n_seg, T* __restrict__ out) {
  constexpr int kPadded = kTile + kTile / 16;
  __shared__ int s_id[kPadded];
  __shared__ T s_v[kPadded];
  __shared__ int warp_f[kWarps];
  __shared__ T warp_s[kWarps];
  __shared__ int end_f, end_id;
  __shared__ T end_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long tile0 = (long long)blockIdx.x * kTile;

  // the tile's ids; rows past E carry INT_MAX
  load_tile<int, kVec>(s_id, ids, tile0, E, 1, 0, INT_MAX, tid);
  const int* my_id = s_id + pad(tid * kItems);
  const T* my_v = s_v + pad(tid * kItems);
  for (int j = 0; j < d; ++j) {
    load_tile<T, kVec>(s_v, data, tile0, E, d, j, T(0), tid);
    __syncthreads();
    // the id of the row before this thread's first (the row before 0
    // carries INT_MIN)
    const int prev = tid > 0 ? my_id[-2]
                     : tile0 == 0 ? INT_MIN
                     : tile0 - 1 < E ? __ldg(ids + tile0 - 1) : INT_MAX;

    // runs inside the thread: `lead` sums the rows before the first run
    // start, `run` the open run; a run closed here is written here
    int head = 0;
    T lead = T(0), run = T(0);
    int pid = prev;
#pragma unroll 4
    for (int i = 0; i < kItems; ++i) {
      const int cur = my_id[i];
      if (cur != pid) {
        if (head) put(out, pid, n_seg, d, j, run);
        else lead = run;
        fill_gap(out, pid, cur, n_seg, d, j);
        head = 1;
        run = T(0);
      }
      run += my_v[i];
      pid = cur;
    }

    // segmented inclusive scan of (head, run) over the warp: a later start
    // restarts the sum
    int f = head;
    T s = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int fu = __shfl_up_sync(kFull, f, off);
      const T su = __shfl_up_sync(kFull, s, off);
      if (lane >= off) {
        if (!f) s = su + s;
        f |= fu;
      }
    }
    int fe = __shfl_up_sync(kFull, f, 1);
    T se = __shfl_up_sync(kFull, s, 1);
    if (lane == 0) {
      fe = 0;
      se = T(0);
    }
    if (lane == 31) {
      warp_f[warp] = f;
      warp_s[warp] = s;
    }
    __syncthreads();
    // the earlier warps' totals, in order
    int fp = 0;
    T sp = T(0);
    for (int w = 0; w < warp; ++w) {
      sp = warp_f[w] ? warp_s[w] : sp + warp_s[w];
      fp |= warp_f[w];
    }
    // (fx, sx): the run open where this thread starts, from its start in
    // this tile (fx = 0: it started in an earlier tile, whose block owns it)
    const int fx = fp | fe;
    const T sx = fe ? se : sp + se;
    if (head && fx) put(out, prev, n_seg, d, j, sx + lead);
    if (tid == kThreads - 1) {
      end_f = fx | head;
      end_s = head ? run : sx + run;
      end_id = pid;
    }
    __syncthreads();
    const int last_id = end_id;

    // the tile's last run, when it started here: read on to its end
    if (warp == 0 && end_f && last_id >= 0 && last_id < n_seg) {
      T ext = T(0);
      for (long long k = tile0 + kTile;; k += 32) {
        const long long row = k + lane;
        const bool same = row < E && __ldg(ids + row) == last_id;
        ext += warp_sum(same ? __ldg(data + row * d + j) : T(0));
        if (__ballot_sync(kFull, same) != kFull) break;
      }
      if (lane == 0) out[(long long)last_id * d + j] = end_s + ext;
    }
    __syncthreads();  // the shared words are reused by the next column
  }
}

template <typename T>
int launch(const T* data, const int* ids, long long E, int d, int n_seg,
           T* out, cudaStream_t stream) {
  if (n_seg <= 0 || d <= 0) return (int)cudaSuccess;
  if (E < 0) return (int)cudaErrorInvalidValue;
  const long long blocks = E / kTile + 1;  // the last tile holds row E
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const bool vec = d == 1 && reinterpret_cast<uintptr_t>(data) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ids) % 16 == 0;
  if (vec)
    segment_sum_kernel<T, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        data, ids, E, d, n_seg, out);
  else
    segment_sum_kernel<T, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        data, ids, E, d, n_seg, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_segment_sum_i32(const int* data, const int* ids,
                                     long long E, int d, int n_seg, int* out,
                                     cudaStream_t stream) {
  return launch<int>(data, ids, E, d, n_seg, out, stream);
}

extern "C" int repro_segment_sum_f32(const float* data, const int* ids,
                                     long long E, int d, int n_seg,
                                     float* out, cudaStream_t stream) {
  return launch<float>(data, ids, E, d, n_seg, out, stream);
}
