// Flash attention forward (online softmax), causal by index or not:
//
//   o[b, h, i, :] = sum_j softmax_j(q[b, h, i, :] . k[b, h / G, j, :] * scale)
//                   * v[b, h / G, j, :],       scale = 1 / sqrt(D),
//
// over keys j < Sk (and j <= i when causal), G = H / Hkv query heads per KV
// head (GQA; G = 1 is MHA).  q, k, v and o are addressed through their
// (batch, head, position) strides with the head dim contiguous, so the
// model's (B, S, H, D) layout is read and written in place, without a
// transpose copy, and a KV head is shared by its G query heads without a
// repeat.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (:72; body _flash_kernel :27), whose grid (batch*heads, q_blocks,
// kv_blocks) runs the kv axis in order on one core, carrying (m, l, acc) in
// VMEM scratch and skipping fully masked kv blocks with @pl.when.
//
// Bound on Hopper: operations.  The function needs 4*D flops per visible
// (query, key) pair (Q K^T and P V), 4*D*H*S(S+1)/2 for causal prefill:
// 4.95e12 at minicpm-2b's prefill (H 36, D 64, S 32768), 5.0 ms at the
// 989e12 bf16 tensor-core rate, against 0.18 ms for reading q, k, v and
// writing o once.  So the scores must never touch device memory and the
// tensor cores must do the products:
//
//   * one block (4 warps) owns 64 query rows of one (b, h) and loops over
//     the KV tiles of 64 keys inside, the loop that takes the place of the
//     TPU's sequential kv grid axis.  Each warp keeps its 16 rows' running
//     max m, sum l and f32 output accumulator in registers; the scores and
//     probabilities live only in registers.
//   * causal: the loop stops at the last tile the block's last query can
//     see (the TPU kernel's @pl.when skip), which halves prefill work, and
//     only tiles that straddle the diagonal or the ragged end of the keys
//     evaluate the mask.  Blocks are issued heaviest first (last q block
//     first), so the short causal blocks fill the tail of the grid.
//   * bf16: Q K^T and P V run on mma.sync m16n8k16 with f32 sums; Q's
//     fragments stay in registers for the whole loop, K and V fragments
//     come from shared memory through ldmatrix (V through its transposing
//     form), and the next K/V tile is fetched with cp.async while the
//     current one is computed (two buffers).  Shared-memory rows are padded
//     by 16 bytes so that ldmatrix and the 32-bit fragment loads meet no
//     bank conflicts.
//   * f32 (the smoke configs and the card-vs-CPU checks): plain f32 FMAs,
//     four threads per query row, probabilities staged in shared memory.
//
// Numerics follow the TPU kernel: mask value -1e30, f32 statistics, p cast
// to V's dtype before the P V product, output acc / max(l, 1e-30) cast to
// q's dtype.  Keys at or past Sk are masked in the kernel, so any Sq and Sk
// need no padded copy.  wgmma, TMA and warp specialisation are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;        // query rows per block
constexpr int kBN = 64;        // keys per KV tile
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
  int H, Hkv, Sq, Sk, causal;
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros (rows past the end)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [row0, row0 + 64) of a (rows, kD) matrix with row stride `stride`
// (elements) into shared memory with row stride kLd; rows >= n_rows read 0
template <typename T, int kD, int kLd, int kThreads>
__device__ __forceinline__ void load_tile(T* sm, const T* g, long long stride,
                                          int row0, int n_rows, int tid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = kD / kVec;
#pragma unroll 4
  for (int c = tid; c < 64 * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * kVec;
    const bool valid = row0 + r < n_rows;
    const T* src = valid ? g + (long long)(row0 + r) * stride + col : g;
    cp_async16(sm + r * kLd + col, src, valid);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// number of KV tiles the q block starting at q0 visits
__device__ __forceinline__ int kv_tiles(const Params& p, int q0) {
  int n = (p.Sk + kBN - 1) / kBN;
  if (p.causal) n = min(n, (q0 + kBM - 1) / kBN + 1);
  return n;
}

// ---------------------------------------------------------------------------
// bf16: 4 warps, 16 query rows each, mma.sync m16n8k16
// ---------------------------------------------------------------------------

template <int kD>
__global__ void __launch_bounds__(128)
    flash_bf16_kernel(const Params p) {
  constexpr int kLd = kD + 8;  // padded row: 16 bytes over kD
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kBM][kLd]
  bf16* Ks = Qs + kBM * kLd;                     // [2][kBN][kLd]
  bf16* Vs = Ks + 2 * kBN * kLd;                 // [2][kBN][kLd]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest causal blocks first
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = qb * kBM;
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.qsb + h * p.qsh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.ksb + hk * p.ksh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.vsb + hk * p.vsh;
  bf16* og = static_cast<bf16*>(p.o) + b * p.osb + h * p.osh;
  const int n_kv = kv_tiles(p, q0);

  load_tile<bf16, kD, kLd, 128>(Qs, qg, p.qss, q0, p.Sq, tid);
  if (n_kv > 0) {
    load_tile<bf16, kD, kLd, 128>(Ks, kg, p.kss, 0, p.Sk, tid);
    load_tile<bf16, kD, kLd, 128>(Vs, vg, p.vss, 0, p.Sk, tid);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // this warp's 16 query rows as mma A fragments, kept for the whole loop
  const int r0 = warp * 16 + g;
  uint32_t qf[kD / 16][4];
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) {
    const int c = ks * 16 + tig * 2;
    qf[ks][0] = *reinterpret_cast<const uint32_t*>(&Qs[r0 * kLd + c]);
    qf[ks][1] = *reinterpret_cast<const uint32_t*>(&Qs[(r0 + 8) * kLd + c]);
    qf[ks][2] = *reinterpret_cast<const uint32_t*>(&Qs[r0 * kLd + c + 8]);
    qf[ks][3] =
        *reinterpret_cast<const uint32_t*>(&Qs[(r0 + 8) * kLd + c + 8]);
  }

  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int row_a = q0 + r0, row_b = row_a + 8;
  const int mi = lane >> 3, rr = lane & 7;  // ldmatrix: matrix, row

  for (int j = 0; j < n_kv; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_kv) {
      const int nb = (buf ^ 1) * kBN * kLd;
      load_tile<bf16, kD, kLd, 128>(Ks + nb, kg, p.kss, (j + 1) * kBN, p.Sk,
                                    tid);
      load_tile<bf16, kD, kLd, 128>(Vs + nb, vg, p.vss, (j + 1) * kBN, p.Sk,
                                    tid);
    }
    cp_async_commit();
    const bf16* Kt = Ks + buf * kBN * kLd;
    const bf16* Vt = Vs + buf * kBN * kLd;

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    float s[kBN / 8][4];
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks) {
#pragma unroll
      for (int np = 0; np < kBN / 16; ++np) {
        // matrices: keys np*16 + {0, 8} x dims ks*16 + {0, 8}
        uint32_t kb[4];
        ldsm_x4(kb, &Kt[(np * 16 + (mi >> 1) * 8 + rr) * kLd + ks * 16 +
                        (mi & 1) * 8]);
        mma_bf16(s[2 * np], qf[ks], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf[ks], kb[2], kb[3]);
      }
    }

    const bool need_mask = (j + 1) * kBN > p.Sk ||
                           (p.causal && (j + 1) * kBN - 1 > q0);
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * p.scale;
        if (need_mask) {
          const int col = j * kBN + n * 8 + tig * 2 + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          if (col >= p.Sk || (p.causal && col > row)) x = kNegInf;
        }
        s[n][e] = x;
      }
    }

    // online softmax over the tile (rows row_a: e = 0, 1; row_b: e = 2, 3)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
    const float corr0 = __expf(m[0] - mx[0]), corr1 = __expf(m[1] - mx[1]);
    m[0] = mx[0];
    m[1] = mx[1];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
      s[n][0] = __expf(s[n][0] - mx[0]);
      s[n][1] = __expf(s[n][1] - mx[0]);
      s[n][2] = __expf(s[n][2] - mx[1]);
      s[n][3] = __expf(s[n][3] - mx[1]);
      rs0 += s[n][0] + s[n][1];
      rs1 += s[n][2] + s[n][3];
    }
    l[0] = l[0] * corr0 + quad_sum(rs0);
    l[1] = l[1] * corr1 + quad_sum(rs1);
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      acc[n][0] *= corr0;
      acc[n][1] *= corr0;
      acc[n][2] *= corr1;
      acc[n][3] *= corr1;
    }

    // O += P V: P (bf16, as V's dtype) re-enters as A fragments from the
    // score registers; V's B fragments through the transposing ldmatrix
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kD / 16; ++dp) {
        // matrices: keys kk*16 + {0, 8} x dims dp*16 + {0, 8}
        uint32_t vb[4];
        ldsm_x4_trans(vb, &Vt[(kk * 16 + (mi & 1) * 8 + rr) * kLd + dp * 16 +
                              (mi >> 1) * 8]);
        mma_bf16(acc[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }

  const float la = fmaxf(l[0], 1e-30f), lb = fmaxf(l[1], 1e-30f);
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    const int c = n * 8 + tig * 2;
    if (row_a < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(og + row_a * p.oss + c) =
          __floats2bfloat162_rn(acc[n][0] / la, acc[n][1] / la);
    if (row_b < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(og + row_b * p.oss + c) =
          __floats2bfloat162_rn(acc[n][2] / lb, acc[n][3] / lb);
  }
}

// ---------------------------------------------------------------------------
// f32: 256 threads, 4 per query row, plain FMAs
// ---------------------------------------------------------------------------

template <int kD>
__global__ void __launch_bounds__(256) flash_f32_kernel(const Params p) {
  constexpr int kLd = kD + 4;
  constexpr int kPLd = kBN + 1;
  constexpr int kPer = kD / 4;  // output dims per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [kBM][kLd]
  float* Ks = Qs + kBM * kLd;                      // [kBN][kLd]
  float* Vs = Ks + kBN * kLd;                      // [kBN][kLd]
  float* Ps = Vs + kBN * kLd;                      // [kBM][kPLd]

  const int tid = threadIdx.x, row = tid >> 2, t = tid & 3;
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = qb * kBM;
  const float* qg = static_cast<const float*>(p.q) + b * p.qsb + h * p.qsh;
  const float* kg = static_cast<const float*>(p.k) + b * p.ksb + hk * p.ksh;
  const float* vg = static_cast<const float*>(p.v) + b * p.vsb + hk * p.vsh;
  float* og = static_cast<float*>(p.o) + b * p.osb + h * p.osh;
  const int n_kv = kv_tiles(p, q0);
  const int qrow = q0 + row;

  load_tile<float, kD, kLd, 256>(Qs, qg, p.qss, q0, p.Sq, tid);
  cp_async_commit();

  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;

  for (int j = 0; j < n_kv; ++j) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<float, kD, kLd, 256>(Ks, kg, p.kss, j * kBN, p.Sk, tid);
    load_tile<float, kD, kLd, 256>(Vs, vg, p.vss, j * kBN, p.Sk, tid);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    float s[kBN / 4];
    float mx = m;
#pragma unroll
    for (int i = 0; i < kBN / 4; ++i) {
      const int key = t + 4 * i;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < kD; ++d)
        dot = fmaf(Qs[row * kLd + d], Ks[key * kLd + d], dot);
      float x = dot * p.scale;
      const int col = j * kBN + key;
      if (col >= p.Sk || (p.causal && col > qrow)) x = kNegInf;
      s[i] = x;
      mx = fmaxf(mx, x);
    }
    mx = quad_max(mx);
    const float corr = expf(m - mx);
    m = mx;
    float rs = 0.f;
#pragma unroll
    for (int i = 0; i < kBN / 4; ++i) {
      const float pv = expf(s[i] - mx);
      rs += pv;
      Ps[row * kPLd + t + 4 * i] = pv;
    }
    l = l * corr + quad_sum(rs);
    __syncwarp();  // the row's four lanes wrote Ps[row]; they read it next
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] *= corr;
    for (int key = 0; key < kBN; ++key) {
      const float pk = Ps[row * kPLd + key];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        acc[i] = fmaf(pk, Vs[key * kLd + t + 4 * i], acc[i]);
    }
  }
  cp_async_wait_all();  // the Q load when no KV tile was visited

  if (qrow < p.Sq) {
    const float ld = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < kPer; ++i) og[qrow * p.oss + t + 4 * i] = acc[i] / ld;
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, size_t smem, dim3 grid,
                   const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int kD>
cudaError_t launch_d(bool is_f32, dim3 grid, const Params& p,
                     cudaStream_t stream) {
  if (is_f32) {
    const size_t smem =
        sizeof(float) * ((size_t)(kBM + 2 * kBN) * (kD + 4) + kBM * (kBN + 1));
    return launch(flash_f32_kernel<kD>, 256, smem, grid, p, stream);
  }
  const size_t smem = sizeof(__nv_bfloat16) * (size_t)(kBM + 4 * kBN) *
                      (kD + 8);
  return launch(flash_bf16_kernel<kD>, 128, smem, grid, p, stream);
}

}  // namespace

// q (B, H, Sq, D), k and v (B, Hkv, Sk, D), o (B, H, Sq, D) on the device,
// all bf16 (is_f32 0) or all f32 (is_f32 1), addressed through the given
// element strides (batch, head, position) with the head dim contiguous.
// Every pointer and every stride times the element size is a multiple of 16
// bytes; H % Hkv == 0; D is 64, 128 or 160; B * H <= 65535.  Returns the
// CUDA launch status (cudaErrorInvalidValue for an unsupported D).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int is_f32, int B,
    int H, int Hkv, int Sq, int Sk, int D, int causal, long long qsb,
    long long qsh, long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb, long long osh,
    long long oss, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return (int)cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || Sk < 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.qsb = qsb; p.qsh = qsh; p.qss = qss;
  p.ksb = ksb; p.ksh = ksh; p.kss = kss;
  p.vsb = vsb; p.vsh = vsh; p.vss = vss;
  p.osb = osb; p.osh = osh; p.oss = oss;
  p.H = H;
  p.Hkv = Hkv;
  p.Sq = Sq;
  p.Sk = Sk;
  p.causal = causal ? 1 : 0;
  p.scale = (float)(1.0 / sqrt((double)D));
  const dim3 grid((unsigned)((Sq + kBM - 1) / kBM), (unsigned)(B * H));
  switch (D) {
    case 64: return (int)launch_d<64>(is_f32 != 0, grid, p, stream);
    case 128: return (int)launch_d<128>(is_f32 != 0, grid, p, stream);
    case 160: return (int)launch_d<160>(is_f32 != 0, grid, p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
