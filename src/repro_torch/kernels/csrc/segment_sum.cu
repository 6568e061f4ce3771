// Sorted-segment sum: out[n, :] = sum of data[k, :] over k with ids[k] == n.
//
// Replaces the TPU kernel repro/kernels/segment_sum.py::segment_sum_sorted.
// ids is ascending; rows whose id falls outside [0, n_segments) (the pad id
// n_segments, say) are skipped.  int32 data accumulates in int32, float32
// in float32.
//
// Bound on Hopper: memory.  The sum reads data (E * d) and ids (E) once and
// writes n_segments * d outputs; one add per element.  Design: a block
// owns kSegsPerBlock consecutive segments.  Two threads find the block's
// edge range [k0, k1) by binary search over ids (this replaces the TPU's
// scalar-prefetched chunk0/nchunks windows); the block then marks each
// segment's run boundaries in shared memory in one coalesced pass over
// ids[k0:k1), and each warp reduces whole segments: lanes stride the run,
// a warp shuffle sums the lanes.  The summation order is fixed by the
// code and there are no atomics, so results are deterministic.
#include <cuda_runtime.h>

namespace {

constexpr int kSegsPerBlock = 256;
constexpr int kThreads = 256;

__device__ __forceinline__ int warp_sum(int v) {
  return __reduce_add_sync(0xffffffffu, v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ long long lower_bound(const int* ids, long long n, int target) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (ids[mid] < target) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename T>
__global__ void segment_sum_kernel(const T* __restrict__ data,
                                   const int* __restrict__ ids, long long E,
                                   int d, int n_seg, T* __restrict__ out) {
  __shared__ long long range[2];
  __shared__ int seg_lo[kSegsPerBlock];
  __shared__ int seg_hi[kSegsPerBlock];
  const int seg0 = blockIdx.x * kSegsPerBlock;
  const int n_here = min(kSegsPerBlock, n_seg - seg0);
  if (threadIdx.x < 2)
    range[threadIdx.x] =
        lower_bound(ids, E, threadIdx.x == 0 ? seg0 : seg0 + n_here);
  for (int i = threadIdx.x; i < kSegsPerBlock; i += blockDim.x) {
    seg_lo[i] = 0;
    seg_hi[i] = 0;
  }
  __syncthreads();
  const long long k0 = range[0];
  const long long k1 = range[1];
  for (long long k = k0 + threadIdx.x; k < k1; k += blockDim.x) {
    const int id = ids[k];
    const int s = id - seg0;
    if (k == k0 || ids[k - 1] != id) seg_lo[s] = (int)(k - k0);
    if (k == k1 - 1 || ids[k + 1] != id) seg_hi[s] = (int)(k - k0 + 1);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int s = warp; s < n_here; s += n_warps) {
    const long long a = k0 + seg_lo[s];
    const long long b = k0 + seg_hi[s];
    for (int j = 0; j < d; ++j) {
      T acc = 0;
      for (long long k = a + lane; k < b; k += 32) acc += data[k * d + j];
      acc = warp_sum(acc);
      if (lane == 0) out[(long long)(seg0 + s) * d + j] = acc;
    }
  }
}

template <typename T>
int launch(const T* data, const int* ids, long long E, int d, int n_seg,
           T* out, cudaStream_t stream) {
  if (n_seg <= 0) return (int)cudaSuccess;
  const int blocks = (n_seg + kSegsPerBlock - 1) / kSegsPerBlock;
  segment_sum_kernel<T><<<blocks, kThreads, 0, stream>>>(data, ids, E, d,
                                                         n_seg, out);
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
