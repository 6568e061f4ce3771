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
// The mask keeps only nnz(adj) outputs, each one length-n dot product, so
// the operations it needs are 2n*nnz(adj): 2.1e10 for the chunked build's
// 32k graph (nnz 319,721), 0.01 ms at the int8 rate.  This design does not
// use the mask's sparsity: it computes all n^2 dot products (2n^3 ops,
// 35.6 ms at 1,979e12 int8 ops/s at n = 32768) on the tensor cores and
// applies the mask in the epilogue.  0/1 operands are exact in int8:
//
//   1. stage: one pass reads the f32 matrix once and writes an int8 copy,
//      zero-padded to a multiple of 128 on both axes, and raises a flag if
//      any value is neither 0 nor 1.  The product's B operand is read
//      k-contiguous (column j of op(adj) as a row).  For op = adj^T that is
//      row j of adj itself, so B is read from the same staged buffer by
//      indexing; for op = adj a second staged buffer holds adj^T, written
//      through a shared-memory transpose.
//   2. product: one 128x128 output tile per block (grouped tile order, so
//      blocks that run together share operand panels in L2), 8 warps of
//      64x32 each, mma.sync m16n8k32 on s8 fragments loaded with ldmatrix,
//      int32 accumulators; 64-deep k slabs are double-buffered through
//      shared memory with cp.async.  The k loop inside the block replaces
//      the TPU's sequential k grid axis.  The epilogue multiplies the int32
//      sum by the f32 mask and writes only i, j < n (ragged n needs no
//      padded output).  int32 sums of 0/1 products are exact for any n, and
//      their f32 value is exact below 2^24.
//
// The way toward the bound is a masked formulation (a dot product only
// where the mask is 1, e.g. over bitset rows, or CSR intersections), not a
// faster dense product.  All flat indices are 64-bit: n^2 passes 2^31 at
// n = 46,341.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;          // output tile edge and staging pad
constexpr int kBK = 64;             // k depth of one shared-memory slab
constexpr int kLds = kBK + 16;      // slab row stride in bytes (no conflicts)
constexpr int kThreads = 256;       // 8 warps: 2 (rows) x 4 (cols)
constexpr int kGroupM = 8;          // row tiles per group of the tile order
constexpr int kStage = 32;          // staging tile edge

template <bool kTranspose>
__global__ void stage_kernel(const float* __restrict__ src, long long n,
                             long long np, signed char* __restrict__ dst,
                             int* __restrict__ bad) {
  __shared__ signed char tile[kStage][kStage + 1];
  const long long c0 = (long long)blockIdx.x * kStage;
  const long long r0 = (long long)blockIdx.y * kStage;
  const int tx = threadIdx.x, ty = threadIdx.y;
  int flag = 0;
  for (int k = 0; k < kStage; k += blockDim.y) {
    const long long r = r0 + ty + k, c = c0 + tx;
    signed char v = 0;
    if (r < n && c < n) {
      const float x = src[r * n + c];
      if (x == 1.0f) v = 1;
      else if (x != 0.0f) flag = 1;  // NaN lands here too
    }
    if (kTranspose) tile[ty + k][tx] = v;
    else dst[r * np + c] = v;
  }
  if (kTranspose) {
    __syncthreads();
    for (int k = 0; k < kStage; k += blockDim.y)
      dst[(c0 + ty + k) * np + r0 + tx] = tile[tx][ty + k];
  }
  if (__any_sync(0xffffffffu, flag) && (tx == 0)) atomicOr(bad, 1);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(smem)), "l"(gmem));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8(int c[4], const unsigned a[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A: staged adj, row-major (np, np).  Bt: op(adj) with k contiguous, i.e.
// Bt[j][k] = op(adj)[k][j].  mask/out: (n, n) f32.
__global__ void __launch_bounds__(kThreads)
masked_product_kernel(const signed char* __restrict__ A,
                      const signed char* __restrict__ Bt,
                      const float* __restrict__ mask, long long n,
                      long long np, float* __restrict__ out) {
  __shared__ __align__(16) signed char As[2][kTile][kLds];
  __shared__ __align__(16) signed char Bs[2][kTile][kLds];

  // grouped tile order: kGroupM row tiles sweep the column tiles together
  const int tiles = (int)(np / kTile);
  const int pid = blockIdx.x;
  const int per_group = kGroupM * tiles;
  const int first_m = (pid / per_group) * kGroupM;
  const int gsize = min(tiles - first_m, kGroupM);
  const int tm = first_m + (pid % per_group) % gsize;
  const int tn = (pid % per_group) / gsize;
  const long long m0 = (long long)tm * kTile, n0 = (long long)tn * kTile;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;

  auto load_slab = [&](int buf, long long k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // 128 rows x 4 chunks of 16 B, each
      const int c = tid + i * kThreads;
      const int row = c >> 2, col = (c & 3) * 16;
      cp_async16(&As[buf][row][col], A + (m0 + row) * np + k0 + col);
      cp_async16(&Bs[buf][row][col], Bt + (n0 + row) * np + k0 + col);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  // ldmatrix row addresses: lane l feeds row (l & 7) of matrix l >> 3
  const int q = lane >> 3, lr = lane & 7;
  const int a_row = lr + (q & 1) * 8, a_col = (q >> 1) * 16;
  const int b_row = lr + (q >> 1) * 8, b_col = (q & 1) * 16;

  const long long nk = np / kBK;
  load_slab(0, 0);
  for (long long kt = 0; kt < nk; ++kt) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (kt + 1 < nk) load_slab((int)((kt + 1) & 1), (kt + 1) * kBK);
    const int buf = (int)(kt & 1);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      unsigned af[4][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], &As[buf][wm + mi * 16 + a_row][kk + a_col]);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)  // two 8-column fragments per load
        ldmatrix_x4(bf[nj], &Bs[buf][wn + nj * 16 + b_row][kk + b_col]);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_s8(acc[mi][ni], af[mi], bf[ni >> 1][(ni & 1) * 2],
                 bf[ni >> 1][(ni & 1) * 2 + 1]);
    }
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long r = m0 + wm + mi * 16 + g + h * 8;
        if (r >= n) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const long long c = n0 + wn + ni * 8 + t * 2 + e;
          if (c < n) {
            const long long idx = r * n + c;
            out[idx] = (float)acc[mi][ni][h * 2 + e] * mask[idx];
          }
        }
      }
}

}  // namespace

// adj, out: (n, n) f32 on the device.  stage_a (and, when op_transposed is
// 0, stage_b): (np, np) int8 scratch, np = n rounded up to 128.  bad: one
// int32, zeroed by the caller, set to 1 if adj holds a value other than 0
// and 1 (the result is then meaningless).  Returns the CUDA launch status.
extern "C" int repro_tricount(const float* adj, long long n, int op_transposed,
                              signed char* stage_a, signed char* stage_b,
                              float* out, int* bad, cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  const long long np = (n + kTile - 1) / kTile * kTile;
  const dim3 sgrid((unsigned)(np / kStage), (unsigned)(np / kStage));
  const dim3 sblock(kStage, 8);
  stage_kernel<false><<<sgrid, sblock, 0, stream>>>(adj, n, np, stage_a, bad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const signed char* bt = stage_a;
  if (!op_transposed) {
    stage_kernel<true><<<sgrid, sblock, 0, stream>>>(adj, n, np, stage_b,
                                                     bad);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    bt = stage_b;
  }
  const long long tiles = np / kTile;
  masked_product_kernel<<<(unsigned)(tiles * tiles), kThreads, 0, stream>>>(
      stage_a, bt, adj, n, np, out);
  return (int)cudaGetLastError();
}
