// Masked 0/1 matrix product for triangle counting:
//
//   out[i, j] = adj[i, j] * sum_k adj[i, k] * op(adj)[k, j],   i, j < n,
//
// with op(adj) = adj^T for the per-DAG-edge extension counts (D @ D^T) ⊙ D
// (tricount_oriented, the count pass of the chunked (2,3) build) and
// op(adj) = adj for the per-edge counts (A @ A) ⊙ A (tricount_per_edge).
//
// Replaces the TPU kernel repro/kernels/tricount.py::_masked_matmul (:67;
// body _tricount_kernel :42), which runs (X @ Y) ⊙ M over 128x128 f32 tiles
// on the MXU with an f32 VMEM accumulator carried across the sequential k
// grid axis.
//
// Bound on Hopper: bytes.  The function reads adj once (4n^2 bytes) and
// writes out once (4n^2 bytes): at n = 32768, 8.6 GB / 3.35 TB/s = 2.6 ms.
// The mask keeps only nnz(adj) outputs (3e-4 of them on the chunked build's
// 32k graph), each a count over row i's set columns, so a dense product
// (2n^3 operations) is far more work than the function needs.  This design
// computes only the outputs the mask keeps, with 0/1 rows held as bitsets:
//
//   1. pack: one pass reads adj once, coalesced (16 B a thread when n is a
//      multiple of 4, else 4 B), and writes the row bitsets R (n, W) uint32,
//      W = ceil(n / 32), bit k of R[i][k / 32] = adj[i, k]: a block takes 32
//      rows by 1,024 columns, and a warp turns a row's 32 consecutive
//      columns into a word by ballot (or by shuffles over the 16-byte
//      loads).  It raises `bad` on any value other than 0 or 1 (NaN
//      included).  For op = identity it also writes the column bitsets
//      Cb (n, W), bit k of Cb[j][k / 32] = adj[k, j], by transposing the
//      block's 32x32 words through shared memory.
//   2. count: one block per output row i.  It writes the whole row with
//      zeros (coalesced vector stores), compacts row i's set columns L_i
//      into shared memory, and then, for each j in L_i, a warp computes
//      count(i, j) = sum over k in L_i of bit k of X[j] (X = R for
//      op = adj^T, Cb for op = adj): lanes over L_i, one probe each into
//      one row of bitsets, a warp sum, and one store of the count over the
//      zero.  Where |L_i| exceeds W, the warp counts by & and __popc over
//      the W words of R[i] and X[j] instead (coalesced, W / 32 steps).
//
// A dense input (density 0.3 at n = 8,192) counts every row by popcounts;
// chip_smoke.py times it there beside the int8 tensor-core product, which
// it stays within 2x of, so no dense-product route is kept for dense rows.
// The bitsets are n^2 / 8 bytes (R, and Cb for op = identity): 134 MB at
// n = 32768.  Counts are integers below n, exact in f32 below 2^24, so the
// output equals (adj @ op(adj)) * adj bit for bit.  All flat indices are
// 64-bit: n^2 passes 2^31 at n = 46,341.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // both passes
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 32;        // pack: rows of a block (one word of Cb)
constexpr int kTileWords = 32;       // pack: words of a block (1,024 columns)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// 1 if x is 1, 0 if x is 0; anything else (NaN included) sets `bad`
__device__ __forceinline__ unsigned bit_of(float x, int& bad) {
  bad |= (x != 0.0f) & (x != 1.0f);
  return x == 1.0f ? 1u : 0u;
}

// row r's words w0 .. w0 + 31 of R: lane l returns word w0 + l (columns
// past n read as 0)
template <bool kVec>
__device__ __forceinline__ unsigned pack_row_words(
    const float* __restrict__ row, long long n, long long c0, int lane,
    int& bad) {
  unsigned word = 0;
  if (kVec) {
    // 8 steps of 128 columns: lane l loads columns 4l .. 4l + 3, and the 8
    // lanes of a group OR their nibbles into one word
#pragma unroll
    for (int s = 0; s < kTileWords / 4; ++s) {
      const long long c = c0 + 128LL * s + 4 * lane;
      unsigned nib = 0;
      if (c < n) {  // n % 4 == 0: the whole float4 is inside the row
        const float4 x = __ldg(reinterpret_cast<const float4*>(row + c));
        nib = bit_of(x.x, bad) | bit_of(x.y, bad) << 1 |
              bit_of(x.z, bad) << 2 | bit_of(x.w, bad) << 3;
      }
      unsigned v = nib << (4 * (lane & 7));
      v |= __shfl_xor_sync(kFull, v, 1);
      v |= __shfl_xor_sync(kFull, v, 2);
      v |= __shfl_xor_sync(kFull, v, 4);
      // group q holds word 4s + q; lane 4s + q takes it
      const unsigned got = __shfl_sync(kFull, v, (lane & 3) << 3);
      if ((lane >> 2) == s) word = got;
    }
  } else {
#pragma unroll 4
    for (int s = 0; s < kTileWords; ++s) {
      const long long c = c0 + 32LL * s + lane;
      const unsigned b = c < n ? bit_of(__ldg(row + c), bad) : 0u;
      const unsigned got = __ballot_sync(kFull, b);
      if (lane == s) word = got;
    }
  }
  return word;
}

// pass 1: a block packs rows r0 .. r0 + 31, words w0 .. w0 + 31
template <bool kVec, bool kCols>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const float* __restrict__ adj, long long n, int W,
            unsigned* __restrict__ rows, unsigned* __restrict__ cols,
            int* __restrict__ bad_flag) {
  __shared__ unsigned tile[kTileRows][kTileWords + 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long r0 = (long long)blockIdx.x * kTileRows;
  const int w0 = blockIdx.y * kTileWords;
  const long long c0 = 32LL * w0;
  int bad = 0;
  for (int k = warp; k < kTileRows; k += kWarps) {
    const long long r = r0 + k;
    unsigned word = 0;
    if (r < n) {  // uniform per warp
      word = pack_row_words<kVec>(adj + r * n, n, c0, lane, bad);
      if (w0 + lane < W) rows[r * W + w0 + lane] = word;
    }
    if (kCols) tile[k][lane] = word;
  }
  if (kCols) {
    // column j = c0 + 32t + b of this tile: bit k of its word r0 / 32 is
    // bit b of row r0 + k's word t
    __syncthreads();
    const long long wr = r0 / 32;
    for (int jl = tid; jl < 32 * kTileWords; jl += kThreads) {
      const long long j = c0 + jl;
      if (j >= n) break;
      const int t = jl >> 5, b = jl & 31;
      unsigned word = 0;
#pragma unroll 8
      for (int k = 0; k < kTileRows; ++k)
        word |= ((tile[k][t] >> b) & 1u) << k;
      cols[j * W + wr] = word;
    }
  }
  if (__any_sync(kFull, bad) && lane == 0) atomicOr(bad_flag, 1);
}

// pass 2: block i writes output row i
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
count_kernel(const unsigned* __restrict__ rows,
             const unsigned* __restrict__ X, long long n, int W,
             float* __restrict__ out) {
  extern __shared__ unsigned smem[];
  unsigned* s_row = smem;                          // R[i], W words
  int* s_list = reinterpret_cast<int*>(smem + W);  // L_i when |L_i| <= W
  __shared__ int s_len, s_fill;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long i = blockIdx.x;
  if (tid == 0) {
    s_len = 0;
    s_fill = 0;
  }
  __syncthreads();
  int len = 0;
  for (int w = tid; w < W; w += kThreads) {
    const unsigned v = __ldg(rows + i * W + w);
    s_row[w] = v;
    len += __popc(v);
  }
  len = warp_sum(len);
  if (lane == 0 && len) atomicAdd(&s_len, len);

  // zeros over the whole row; the counts are stored over them after the
  // barrier below, which orders the block's stores to the same address
  float* o = out + i * n;
  if (kVec) {
    float4* o4 = reinterpret_cast<float4*>(o);
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (long long q = tid; q < n / 4; q += kThreads) o4[q] = z;
  } else {
    for (long long c = tid; c < n; c += kThreads) o[c] = 0.f;
  }
  __syncthreads();
  len = s_len;
  if (len == 0) return;

  if (len <= W) {
    // probes: compact L_i (in any order: a count is an order-free sum),
    // then a warp per j, lanes over L_i
    for (int w = tid; w < W; w += kThreads) {
      unsigned v = s_row[w];
      if (v) {
        int at = atomicAdd(&s_fill, __popc(v));
        for (; v; v &= v - 1) s_list[at++] = 32 * w + __ffs(v) - 1;
      }
    }
    __syncthreads();
    for (int x = warp; x < len; x += kWarps) {
      const int j = s_list[x];
      const unsigned* xj = X + (long long)j * W;
      int c = 0;
#pragma unroll 4
      for (int y = lane; y < len; y += 32) {
        const int k = s_list[y];
        c += (__ldg(xj + (k >> 5)) >> (k & 31)) & 1u;
      }
      c = warp_sum(c);
      if (lane == 0) o[j] = (float)c;
    }
  } else {
    // dense row: a warp per j, & and popcount over the W words
    for (int w = warp; w < W; w += kWarps) {
      for (unsigned v = s_row[w]; v; v &= v - 1) {
        const int j = 32 * w + __ffs(v) - 1;
        const unsigned* xj = X + (long long)j * W;
        int c = 0;
#pragma unroll 4
        for (int y = lane; y < W; y += 32)
          c += __popc(s_row[y] & __ldg(xj + y));
        c = warp_sum(c);
        if (lane == 0) o[j] = (float)c;
      }
    }
  }
}

template <bool kVec>
int launch(const float* adj, long long n, int W, bool op_transposed,
           unsigned* rows, unsigned* cols, float* out, int* bad,
           cudaStream_t stream) {
  const dim3 pgrid((unsigned)((n + kTileRows - 1) / kTileRows),
                   (unsigned)((W + kTileWords - 1) / kTileWords));
  if (op_transposed)
    pack_kernel<kVec, false><<<pgrid, kThreads, 0, stream>>>(adj, n, W, rows,
                                                             cols, bad);
  else
    pack_kernel<kVec, true><<<pgrid, kThreads, 0, stream>>>(adj, n, W, rows,
                                                            cols, bad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = 8 * (size_t)W;  // R[i] and L_i
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(count_kernel<kVec>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  count_kernel<kVec><<<(unsigned)n, kThreads, smem, stream>>>(
      rows, op_transposed ? rows : cols, n, W, out);
  return (int)cudaGetLastError();
}

}  // namespace

// adj, out: (n, n) f32 on the device.  rows (and, when op_transposed is 0,
// cols): (n, ceil(n / 32)) uint32 scratch for the bitsets.  bad: one int32,
// zeroed by the caller, set to 1 if adj holds a value other than 0 and 1
// (the result is then meaningless).  Returns the CUDA launch status.
extern "C" int repro_tricount(const float* adj, long long n, int op_transposed,
                              unsigned* rows, unsigned* cols, float* out,
                              int* bad, cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int W = (int)((n + 31) / 32);
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(adj) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return vec ? launch<true>(adj, n, W, op_transposed != 0, rows, cols, out,
                            bad, stream)
             : launch<false>(adj, n, W, op_transposed != 0, rows, cols, out,
                             bad, stream);
}
