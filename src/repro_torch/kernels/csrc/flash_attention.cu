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
// writing o once.  So the scores never touch device memory, the tensor
// cores do the products at the rate only wgmma reaches, and the softmax
// (one exp2 and about four FP32 instructions per score: at D = 64 about as
// many cycles as the products take) must hide behind the products.  A loop inside the block over
// KV tiles takes the place of the TPU's sequential kv grid axis, with the
// running max m, sum l and f32 output accumulator in registers.
//
// bf16 at D = 64 and 128 (minicpm-2b, minitron-4b), the Hopper design:
//   * a block owns 64 * W query rows of one (b, h): W consumer warpgroups
//     (W = 3 at D = 64, 2 at D = 128) and one producer warpgroup, which
//     gives its registers to the consumers (setmaxnreg) while one of its
//     threads loads Q once and streams the K and V tiles of 128 keys
//     through a ring of shared-memory stages (4 at D = 64, 3 at D = 128)
//     with TMA, each stage guarded by a full and an empty mbarrier.  Rows
//     and keys past the end read as zeros (TMA's bounds), so no padded copy
//     is made; the output stores are masked.
//   * each consumer warpgroup owns 64 rows (the M of wgmma).  S = Q K^T is
//     one SS wgmma chain (m64n128k16, Q and K K-major in shared memory
//     under the 128-byte swizzle the TMA boxes were written with; a
//     128-wide head is two 64-wide boxes).  The softmax runs on the f32
//     accumulator in registers, where a thread holds rows lane/4 and
//     lane/4 + 8 of its warp's 16: exp2 with scale*log2(e) folded into one
//     FMA per score, each thread's share of the row sum reduced across its
//     quad once at the end.  O += P V is an RS wgmma chain: P converted to
//     bf16 A fragments in registers, V read N-major through the
//     descriptor's transpose.
//   * overlap: a warpgroup issues tile j's Q K^T and tile j-1's P V back to
//     back and runs tile j's softmax while P V is still on the tensor
//     cores; the warpgroups issue their products in turns (named barriers,
//     "ping-pong"), so one's softmax runs while another's products hold the
//     tensor cores.  At D = 64 the softmax's FP32 work and exp2 take about
//     as long as the products, so three warpgroups hide it better than two.
//   * causal: the key loop stops at the tile of the block's last row, only
//     the diagonal tiles and the ragged end evaluate the mask, and the grid
//     issues every head's heaviest query blocks (the last ones) first.
// bf16 at D = 160 (stablelm-12b) keeps the first design, chosen by shape in
//   the C entry: 4 warps own 64 rows on mma.sync m16n8k16, K/V fragments
//   through ldmatrix from cp.async double buffers (a 160-wide head is three
//   TMA boxes, 64 + 64 + 32, a later step).
// f32 (the smoke configs and the card-vs-CPU checks): plain f32 FMAs, four
//   threads per query row, probabilities staged in shared memory.
//
// Numerics follow the TPU kernel: mask value -1e30, f32 statistics, p cast
// to V's dtype before the P V product, output acc / max(l, 1e-30) cast to
// q's dtype.  Keys at or past Sk are masked in the kernel, so any Sq and Sk
// need no padded copy.
#include <cuda.h>  // CUtensorMap and its enums (types only; no libcuda link)
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
// bf16 at D = 160: 4 warps, 16 query rows each, mma.sync m16n8k16
// ---------------------------------------------------------------------------

template <int kD>
__global__ void __launch_bounds__(128)
    flash_bf16_mma_kernel(const Params p) {
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


// ---------------------------------------------------------------------------
// bf16 at D = 64 and 128: TMA, an mbarrier ring, wgmma, warp specialisation
// ---------------------------------------------------------------------------

namespace hopper {

constexpr int kBN = 128;           // keys per K/V tile
constexpr int kRowBytes = 128;     // one 128-byte swizzle row: 64 bf16
constexpr float kLog2e = 1.4426950408889634f;

// kWG consumer warpgroups of 64 query rows each, one producer warpgroup;
// setmaxnreg moves the producer's registers to the consumers
template <int kD, int kWG>
struct Cfg {
  static constexpr int kBM = 64 * kWG;              // query rows per block
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr int kConsumers = 128 * kWG;
  static constexpr int kLoadRegs = kWG == 2 ? 24 : 32;
  static constexpr int kMmaRegs = kWG == 2 ? 240 : 160;
  static constexpr int kStages = kD == 64 ? 4 : 3;  // K/V ring depth
  static constexpr int kQBytes = kBM * kD * 2;
  static constexpr int kTileBytes = kBN * kD * 2;   // one K or one V tile
  // + 1024: the dynamic buffer is realigned to the swizzle's 1024 bytes
  static constexpr int kSmem = kQBytes + 2 * kStages * kTileBytes + 1024;
  static_assert(kSmem <= 227 * 1024, "over the 227 KB a block may use");
};

struct Params {
  CUtensorMap qmap, kmap, vmap;  // (D, S, heads, B) views, 64-dim boxes
  void* o;
  long long osb, osh, oss;
  int H, Hkv, Sq, Sk, causal;
  float scale_log2;              // 1/sqrt(D) * log2(e)
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// spin until the barrier has completed the phase of the given parity; a
// wait of ~2^34 cycles (seconds) means a broken pipeline and traps, so a
// fault surfaces as a launch error instead of a hung card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 34)) {
      __trap();
    }
  }
}

// the map's box at coordinates (c0, c1, c2, c3) of a 4-D map
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 (B128)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accesses of wgmma registers across the
// asynchronous instructions that read or write them
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// D (64 x 128, f32) (+)= A (64 x 16, shared) * B (128 x 16, shared)^T
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, shared, N-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, registers) * B (16 x 128, shared, N-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int kD>
__device__ __forceinline__ void wgmma_pv(float (&o)[kD / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(o, a, db);
}

template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(o, a, db);
}

// The consumers' named barriers for ping-pong: warpgroup c waits on 1 + c
// and arrives on the next one's, so they issue their products in turns and
// one's softmax runs while another's products hold the tensor cores
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// S = Q K^T (64 x 128, f32) for one warpgroup: both operands K-major under
// the 128-byte swizzle, 16 head dims a step, 64 dims per column block
template <int kD, int kBM>
__device__ __forceinline__ void issue_qk(float (&s)[kBN / 2], uint32_t q_addr,
                                         uint32_t k_addr) {
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) {
    const uint32_t qo = (ks / 4) * kBM * kRowBytes + (ks % 4) * 32;
    const uint32_t ko = (ks / 4) * kBN * kRowBytes + (ks % 4) * 32;
    wgmma_ss_n128(s, desc_sw128(q_addr + qo, 16, 1024),
                  desc_sw128(k_addr + ko, 16, 1024), ks > 0);
  }
}

// O += P V: P's bf16 A fragments from registers, V N-major (the
// descriptor's transpose): 8 keys per 1024-byte swizzle atom, the next 64
// head dims one column block (kBN rows) further
template <int kD>
__device__ __forceinline__ void issue_pv(float (&o)[kD / 2],
                                         const uint32_t (&pf)[kBN / 16][4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
    wgmma_pv<kD>(o, pf[kk],
                 desc_sw128(v_addr + kk * 16 * kRowBytes, kBN * kRowBytes,
                            1024));
}

// The online-softmax step of one tile on the S accumulator: mask (diagonal
// and ragged tiles only), new row max (raw score units), p = exp2(s*sl -
// m*sl) in place, this thread's share of the row sum.  Returns the factors
// (corr_a, corr_b) that rescale the rows' earlier O.
struct Rows {
  int row_a, row_b, tig;
  float m_a, m_b, l_a, l_b;
};

__device__ __forceinline__ void softmax_tile(float (&s)[kBN / 2], Rows& r,
                                             const Params& p, int key0,
                                             bool need_mask, float& corr_a,
                                             float& corr_b) {
  const float sl = p.scale_log2;
  if (need_mask) {
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = key0 + n * 8 + r.tig * 2 + (e & 1);
        const int row = e < 2 ? r.row_a : r.row_b;
        if (col >= p.Sk || (p.causal && col > row)) s[4 * n + e] = kNegInf;
      }
    }
  }
  float mx_a = r.m_a, mx_b = r.m_b;
#pragma unroll
  for (int n = 0; n < kBN / 8; ++n) {
    mx_a = fmaxf(mx_a, fmaxf(s[4 * n], s[4 * n + 1]));
    mx_b = fmaxf(mx_b, fmaxf(s[4 * n + 2], s[4 * n + 3]));
  }
  mx_a = quad_max(mx_a);
  mx_b = quad_max(mx_b);
  corr_a = fast_exp2((r.m_a - mx_a) * sl);
  corr_b = fast_exp2((r.m_b - mx_b) * sl);
  r.m_a = mx_a;
  r.m_b = mx_b;
  const float off_a = -mx_a * sl, off_b = -mx_b * sl;
  float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
  for (int n = 0; n < kBN / 8; ++n) {
    s[4 * n] = fast_exp2(fmaf(s[4 * n], sl, off_a));
    s[4 * n + 1] = fast_exp2(fmaf(s[4 * n + 1], sl, off_a));
    s[4 * n + 2] = fast_exp2(fmaf(s[4 * n + 2], sl, off_b));
    s[4 * n + 3] = fast_exp2(fmaf(s[4 * n + 3], sl, off_b));
    rs_a += s[4 * n] + s[4 * n + 1];
    rs_b += s[4 * n + 2] + s[4 * n + 3];
  }
  r.l_a = r.l_a * corr_a + rs_a;
  r.l_b = r.l_b * corr_b + rs_b;
}

// P (bf16, as V's dtype) as wgmma A fragments: the accumulator of keys
// 16kk..16kk+15 is the A fragment of k-step kk, register for register
__device__ __forceinline__ void pack_p(const float (&s)[kBN / 2],
                                       uint32_t (&pf)[kBN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    pf[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    pf[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pf[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pf[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int kD>
__device__ __forceinline__ void rescale(float (&o)[kD / 2], float corr_a,
                                        float corr_b) {
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    o[4 * n] *= corr_a;
    o[4 * n + 1] *= corr_a;
    o[4 * n + 2] *= corr_b;
    o[4 * n + 3] *= corr_b;
  }
}

// One block: 64 * kWG query rows of one (b, h).  Warpgroup 0 is the producer
// (one thread issues every TMA load); warpgroups 1..kWG each own 64 rows and
// run the wgmma products and the online softmax.  Within a warpgroup, tile
// j's scores are computed while tile j-1's P V is still on the tensor cores
// (both issued back to back, then waited for one at a time).
template <int kD, int kWG>
__global__ void __launch_bounds__(Cfg<kD, kWG>::kThreads, 1)
    flash_bf16_wgmma_kernel(const __grid_constant__ Params p) {
  using C = Cfg<kD, kWG>;
  constexpr int kBM = C::kBM;
  using bf16 = __nv_bfloat16;
  constexpr int kCB = kD / 64;  // 64-wide column blocks of the head dim
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t kv_full[C::kStages];
  __shared__ __align__(8) uint64_t kv_empty[C::kStages];
  // 128-byte swizzled tiles start on 1024-byte boundaries
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* Qs = reinterpret_cast<bf16*>(base);  // [kCB][kBM][64]
  bf16* Ks = Qs + kBM * kD;                  // [kStages][kCB][kBN][64]
  bf16* Vs = Ks + C::kStages * kBN * kD;     // [kStages][kCB][kBN][64]

  const int qb = gridDim.y - 1 - blockIdx.y;  // heaviest causal blocks first
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = qb * kBM;
  int n_kv = (p.Sk + kBN - 1) / kBN;
  // causal: up to the tile of the block's last row
  if (p.causal) n_kv = min(n_kv, (q0 + kBM - 1) / kBN + 1);

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], C::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: registers to the consumers, one thread issues TMA ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::kLoadRegs)
                 : "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(&q_full, C::kQBytes);
#pragma unroll
      for (int c = 0; c < kCB; ++c)
        tma_load(Qs + c * kBM * 64, &p.qmap, &q_full, c * 64, q0, h, b);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % C::kStages;
        mbar_wait(&kv_empty[s], ((j / C::kStages) & 1) ^ 1);
        mbar_expect_tx(&kv_full[s], 2 * C::kTileBytes);
        bf16* kt = Ks + s * kBN * kD;
        bf16* vt = Vs + s * kBN * kD;
#pragma unroll
        for (int c = 0; c < kCB; ++c) {
          tma_load(kt + c * kBN * 64, &p.kmap, &kv_full[s], c * 64, j * kBN,
                   hk, b);
          tma_load(vt + c * kBN * 64, &p.vmap, &kv_full[s], c * 64, j * kBN,
                   hk, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kMmaRegs)
                 : "memory");
    const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup 0..kWG-1
    const int t = threadIdx.x % 128;
    const int warp = t >> 5, lane = t & 31;
    Rows r;
    r.tig = lane & 3;
    r.row_a = q0 + 64 * cw + 16 * warp + (lane >> 2);
    r.row_b = r.row_a + 8;
    // running max (raw score units) and this thread's share of the sum
    r.m_a = r.m_b = kNegInf;
    r.l_a = r.l_b = 0.f;
    // this warpgroup's 64 rows of Q within each column block
    const uint32_t q_addr = smem_u32(Qs) + cw * 64 * kRowBytes;
    const int first_row = q0 + 64 * cw;
    auto k_addr = [&](int j) {
      return smem_u32(Ks + (j % C::kStages) * kBN * kD);
    };
    auto v_addr = [&](int j) {
      return smem_u32(Vs + (j % C::kStages) * kBN * kD);
    };
    auto need_mask = [&](int j) {
      return (j + 1) * kBN > p.Sk ||
             (p.causal && (j + 1) * kBN - 1 > first_row);
    };
    // ping-pong: warpgroup 0 goes first, each passes to the next; every
    // arrive meets a wait
    const int next = 1 + (cw + 1) % kWG;
    if (cw == kWG - 1 && n_kv > 0) named_arrive(1);

    float o[kD / 2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
    float s[kBN / 2];
    uint32_t pf[kBN / 16][4];
    float corr_a, corr_b;

    mbar_wait(&q_full, 0);
    if (n_kv > 0) {
      // tile 0: scores, softmax, P
      mbar_wait(&kv_full[0], 0);
      named_sync(1 + cw);
      reg_fence(s);
      wg_fence();
      issue_qk<kD, kBM>(s, q_addr, k_addr(0));
      wg_commit();
      named_arrive(next);
      wg_wait<0>();
      reg_fence(s);
      softmax_tile(s, r, p, 0, need_mask(0), corr_a, corr_b);
      pack_p(s, pf);
    }
    for (int j = 1; j < n_kv; ++j) {
      mbar_wait(&kv_full[j % C::kStages], (j / C::kStages) & 1);
      named_sync(1 + cw);
      reg_fence(s);
      reg_fence(o);
      reg_fence(pf);
      wg_fence();
      issue_qk<kD, kBM>(s, q_addr, k_addr(j));  // tile j's scores
      wg_commit();
      issue_pv<kD>(o, pf, v_addr(j - 1));  // tile j-1's P V
      wg_commit();
      named_arrive(next);
      wg_wait<1>();  // the scores are in; P V runs on
      reg_fence(s);
      softmax_tile(s, r, p, j * kBN, need_mask(j), corr_a, corr_b);
      wg_wait<0>();
      reg_fence(o);
      reg_fence(pf);
      mbar_arrive(&kv_empty[(j - 1) % C::kStages]);  // tile j-1 is done
      rescale<kD>(o, corr_a, corr_b);
      pack_p(s, pf);
    }
    if (n_kv > 0) {
      // the last tile's P V
      named_sync(1 + cw);
      reg_fence(o);
      reg_fence(pf);
      wg_fence();
      issue_pv<kD>(o, pf, v_addr(n_kv - 1));
      wg_commit();
      if (cw < kWG - 1) named_arrive(next);
      wg_wait<0>();
      reg_fence(o);
      mbar_arrive(&kv_empty[(n_kv - 1) % C::kStages]);
    }

    const float la = quad_sum(r.l_a), lb = quad_sum(r.l_b);
    const float ia = 1.f / fmaxf(la, 1e-30f), ib = 1.f / fmaxf(lb, 1e-30f);
    bf16* og = static_cast<bf16*>(p.o) + b * p.osb + h * p.osh;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const int c = n * 8 + r.tig * 2;
      if (r.row_a < p.Sq)
        *reinterpret_cast<__nv_bfloat162*>(og + r.row_a * p.oss + c) =
            __floats2bfloat162_rn(o[4 * n] * ia, o[4 * n + 1] * ia);
      if (r.row_b < p.Sq)
        *reinterpret_cast<__nv_bfloat162*>(og + r.row_b * p.oss + c) =
            __floats2bfloat162_rn(o[4 * n + 2] * ib, o[4 * n + 3] * ib);
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query
// (no link against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a (D, S, heads, B) bf16 view with element strides (sb, sh, ss) and the
// head dim contiguous, read in boxes of 64 dims x box_rows rows under the
// 128-byte swizzle; rows past S read as zeros
bool encode(CUtensorMap* map, const void* ptr, int D, int S, int heads,
            int B, long long sb, long long sh, long long ss, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kD, int kWG>
cudaError_t launch(const ::Params& a, int B, cudaStream_t stream) {
  using C = Cfg<kD, kWG>;
  Params p;
  const int sk = a.Sk > 0 ? a.Sk : 1;  // Sk = 0 visits no tile
  if (!encode(&p.qmap, a.q, kD, a.Sq, a.H, B, a.qsb, a.qsh, a.qss,
              C::kBM) ||
      !encode(&p.kmap, a.k, kD, sk, a.Hkv, B, a.ksb, a.ksh, a.kss, kBN) ||
      !encode(&p.vmap, a.v, kD, sk, a.Hkv, B, a.vsb, a.vsh, a.vss, kBN))
    return cudaErrorInvalidValue;
  p.o = a.o;
  p.osb = a.osb;
  p.osh = a.osh;
  p.oss = a.oss;
  p.H = a.H;
  p.Hkv = a.Hkv;
  p.Sq = a.Sq;
  p.Sk = a.Sk;
  p.causal = a.causal;
  p.scale_log2 = a.scale * kLog2e;
  const long long n_qb = ((long long)a.Sq + C::kBM - 1) / C::kBM;
  if (n_qb > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)(B * a.H), (unsigned)n_qb);
  auto kernel = flash_bf16_wgmma_kernel<kD, kWG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace hopper

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, size_t smem, dim3 grid,
                   const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// the first design: f32 at every D, bf16 at D = 160
template <int kD>
cudaError_t launch_d(bool is_f32, int B, const Params& p,
                     cudaStream_t stream) {
  const dim3 grid((unsigned)((p.Sq + kBM - 1) / kBM), (unsigned)(B * p.H));
  if (is_f32) {
    const size_t smem =
        sizeof(float) * ((size_t)(kBM + 2 * kBN) * (kD + 4) + kBM * (kBN + 1));
    return launch(flash_f32_kernel<kD>, 256, smem, grid, p, stream);
  }
  const size_t smem = sizeof(__nv_bfloat16) * (size_t)(kBM + 4 * kBN) *
                      (kD + 8);
  return launch(flash_bf16_mma_kernel<kD>, 128, smem, grid, p, stream);
}

}  // namespace

// q (B, H, Sq, D), k and v (B, Hkv, Sk, D), o (B, H, Sq, D) on the device,
// all bf16 (is_f32 0) or all f32 (is_f32 1), addressed through the given
// element strides (batch, head, position) with the head dim contiguous.
// Every pointer and every stride times the element size is a multiple of 16
// bytes; H % Hkv == 0; D is 64, 128 or 160; B * H <= 65535.  bf16 at D = 64
// and 128 runs the wgmma/TMA kernel, the rest the first design.  Returns the
// CUDA status of the tensor maps' encoding and the launch
// (cudaErrorInvalidValue for an unsupported D or more than 65535 query
// blocks).
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
  const bool f32 = is_f32 != 0;
  switch (D) {
    case 64:
      return (int)(f32 ? launch_d<64>(true, B, p, stream)
                       : hopper::launch<64, 3>(p, B, stream));
    case 128:
      return (int)(f32 ? launch_d<128>(true, B, p, stream)
                       : hopper::launch<128, 2>(p, B, stream));
    case 160: return (int)launch_d<160>(f32, B, p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
