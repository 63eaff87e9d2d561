// G1: the folded stride-1 3x3 conv + bias + ReLU as three GEMMs.
//
// Replaces the Pallas TPU kernel annonet_tpu/ops/pallas_conv.py:137
// conv3x3_gemm_aligned (pallas_call at :164), the s1p layers of the folded
// net (models/folded_runtime.py, ``use_pallas_conv``).
//
// What it computes. x is [N, H, WB, K1] with K1 = fold*cin (fold pixels of
// one width block side by side in the channel dim); Wc, Wl, Wr are
// [3*K1, NC] with NC = fold*cout, in x's dtype; bias is [cout] f32, column
// j*cout + co taking bias[co]. With P_dy[n,h,b] = x[n, h+dy-1, b, :] (zero
// outside 0..H-1):
//   out[n,h,b,:] = relu(bias + sum_dy P_dy[b] . Wc_dy + P_dy[b-1] . Wl_dy
//                                  + P_dy[b+1] . Wr_dy)
// with the b-1 term zero at b = 0 and the b+1 term zero at b = WB-1. That
// is one GEMM of M = N*H*WB rows by NC columns over K = 9*K1, whose A row
// (segment s, dy; channel c) is x at the row shifted by dy-1 and the block
// shifted by 0, -1, +1 for Wc, Wl, Wr. It holds for any weights.
//
// What bounds it on an H100. The folded weights are block-banded
// (build_gemm_kernels_aligned): output pixel j of a block reads input
// pixels j-1..j+1 only, and Wl and Wr hold one nonzero pixel block each, so
// only about 1/fold of the dense GEMM's 2*M*NC*9*K1 operations multiply
// nonzero weights. What remains is 100-300 operations a byte, at or under
// the ~295 where bf16 tensor cores stop waiting on memory: by its bytes,
// most layers are bound by memory. The first version multiplied every
// zero (fold times the work, 8x at the stem and dec1) in a two-stage
// mainloop without ldmatrix, at half of cuBLAS's rate on the same dense
// GEMMs and 2.3x slower than cuDNN's unfolded conv. This one takes about
// 5x its bound over the flagship's layers, 0.8x cuDNN's unfolded conv:
// with the copies or the products switched off, the two parts add up
// rather than overlap, and neither fewer bytes (one A chunk for all three
// matrices, B of the listed slabs only), more stages, more blocks an SM nor
// fewer block barriers changed the total (PERF.md).
//
// Design (bf16). (a) Skip what is zero, exactly: the wrapper passes a
// table, built on the host once per weight set (ops/gemm_conv.py
// g1_block_table), that lists for each group of 128 output columns the K
// chunks (segment, dy, 32 rows of K1) whose weights hold any nonzero in
// that group, each with a mask of the group's four 32-column slabs that
// do. A block (128 rows x 128 columns, 8 warps) walks its group's list:
// it copies each listed chunk of A once and every warp whose slab the
// mask names multiplies it; a slab whose block of the chunk is all zero
// contributes exactly zero, so the skip changes no sum and the result
// holds for any weights (dense weights list every chunk with a full mask).
// Warps split the block as 4 slabs x 2 row halves, so one A chunk in
// shared memory feeds every slab that needs it. (b) The mainloop: a ring
// of 4 cp.async stages (A rows of the shifted input, out-of-range rows and
// blocks as zero-fill copies; B the chunk's 32 weight rows), fragments by ldmatrix (A) and ldmatrix.trans (B) from
// rows padded by 8 elements (conflict-free), bf16 mma.sync m16n8k16 with
// f32 accumulation, each B fragment used by 4 m16 tiles. The epilogue adds
// the f32 bias, applies ReLU, rounds once, stages the tile in shared
// memory and stores 16 bytes a thread. K1 need not be a multiple of 32 (the
// RGB stem's 24: the chunk's missing rows are zero-filled); where K1 or NC
// is no multiple of 8 the copies are element by element.
// f32 runs on the CUDA cores (a 64 x 64 tile, 4 x 4 outputs a thread,
// dense): only the f32 configs, used to check the arithmetic, take it.
//
// Numerics: f32 accumulation, + f32 bias, ReLU, one rounding to x's dtype,
// as the Pallas kernel does.

#include "common.cuh"

namespace annonet {
namespace {

constexpr int kThreads = 256;

// the source pixel of GEMM row m for (dy, db), or -1 outside the image
struct ARow {
  int64_t m;  // -1 past the last row
  int h, b;
};

__device__ __forceinline__ ARow a_row(int64_t m, int64_t rows, int h, int wb) {
  ARow r;
  if (m >= rows) {
    r.m = -1;
    r.h = r.b = 0;
    return r;
  }
  r.m = m;
  r.b = (int)(m % wb);
  r.h = (int)((m / wb) % h);
  return r;
}

__device__ __forceinline__ int64_t a_src(const ARow& r, int dy, int db, int h,
                                         int wb) {
  const int hh = r.h + dy - 1, bb = r.b + db;
  if (r.m < 0 || hh < 0 || hh >= h || bb < 0 || bb >= wb) return -1;
  return r.m + (int64_t)(dy - 1) * wb + db;
}

// segment s in {0: Wc, 1: Wl, 2: Wr}: the block shift of its A rows
__device__ __forceinline__ int seg_db(int s) { return s == 0 ? 0 : (s == 1 ? -1 : 1); }

// ----------------------------------------------------------------- bf16

// block: kBM rows x kGN columns (one group); slabs of kSlab columns, K
// chunks of kKC rows; ops/gemm_conv.py builds the table with the same sizes
constexpr int kBM = 128, kGN = 128, kSlab = 32, kKC = 32, kStages = 4;
constexpr int kALd = kKC + 8;  // padded shared rows, in bf16 elements
constexpr int kBLd = kGN + 8;
constexpr int kABytes = kBM * kALd * 2;
constexpr int kStageBytes = kABytes + kKC * kBLd * 2;
constexpr int kSmemBytes = kStages * kStageBytes;
static_assert(kBM * kBLd * 2 <= kSmemBytes, "the staged output tile fits");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from src, or 16 zero bytes when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the first min(n, 8) elements at p, zero-filled to 8, packed low first
__device__ __forceinline__ uint4 pack8(const __nv_bfloat16* p, int n) {
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (j < n) w[j >> 1] |= (uint32_t)__bfloat16_as_ushort(p[j]) << (16 * (j & 1));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// table: [groups + 1] offsets into the entries that follow them; an entry
// is chunk * 16 + mask, chunk = (s * 3 + dy) * ceil(K1 / kKC) + c (rows
// c*kKC .. of segment s = Wc, Wl, Wr at row tap dy), mask bit j = the
// group's slab j holds a nonzero weight in that chunk
__global__ void __launch_bounds__(kThreads, 2)
gemm_conv_bf16(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ wc,
               const __nv_bfloat16* __restrict__ wl,
               const __nv_bfloat16* __restrict__ wr,
               const float* __restrict__ bias, const int* __restrict__ table,
               __nv_bfloat16* __restrict__ out, int64_t rows, int h, int wb,
               int k1, int nc, int cout, int groups, int vec_a, int vec_b,
               int vec_o) {
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t m0 = (int64_t)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kGN;
  const int first = table[blockIdx.y];
  const int count = table[blockIdx.y + 1] - first;
  const int* entries = table + groups + 1 + first;
  const int cps = (k1 + kKC - 1) / kKC;  // chunks a (segment, dy)

  // A copies: rows tid/4 and tid/4 + 64, 16-byte piece tid%4 of the chunk
  const int a_piece = tid & 3;
  ARow arow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) arow[i] = a_row(m0 + (tid >> 2) + 64 * i, rows, h, wb);
  // B copies: chunk rows tid/16 and tid/16 + 16, columns (tid%16)*8 .. +7
  const int b_row = tid >> 4, b_col = (tid & 15) * 8;

  auto fill = [&](int i, int buf) {
    const int chunk = entries[i] >> 4;
    const int seg = chunk / cps, c0 = (chunk - seg * cps) * kKC;
    const int s = seg / 3, dy = seg % 3;
    __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem + buf * kStageBytes);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t src = a_src(arow[r], dy, seg_db(s), h, wb);
      const int c = c0 + a_piece * 8;
      __nv_bfloat16* dst = as + ((tid >> 2) + 64 * r) * kALd + a_piece * 8;
      const bool ok = src >= 0 && c < k1;
      if (vec_a)
        cp_async16(dst, ok ? x + src * k1 + c : x, ok);
      else
        *reinterpret_cast<uint4*>(dst) =
            ok ? pack8(x + src * k1 + c, k1 - c) : make_uint4(0, 0, 0, 0);
    }
    const __nv_bfloat16* w = s == 0 ? wc : (s == 1 ? wl : wr);
    __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(smem + buf * kStageBytes + kABytes);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int k = b_row + 16 * r, col = n0 + b_col;
      const bool ok = c0 + k < k1 && col < nc;
      const __nv_bfloat16* src = w + ((int64_t)dy * k1 + c0 + k) * nc + col;
      __nv_bfloat16* dst = bs + k * kBLd + b_col;
      if (vec_b)
        cp_async16(dst, ok ? src : w, ok);
      else
        *reinterpret_cast<uint4*>(dst) = ok ? pack8(src, nc - col) : make_uint4(0, 0, 0, 0);
    }
  };

  // warp tile: rows mh*64 .. +64 (4 m16 tiles), columns slab*32 .. +32
  // (4 n8 tiles)
  const int slab = warp & 3, mh = warp >> 2;
  const int r16 = lane & 15, hi = lane >> 4;
  // this lane's ldmatrix row of A (row r16 of an m16 tile, columns +8*hi)
  // and of B (k = r16, columns + 8*hi), in bytes from their stage's start
  const uint32_t a_off = ((mh * 64 + r16) * kALd + hi * 8) * 2;
  const uint32_t b_off = kABytes + (r16 * kBLd + slab * kSlab + hi * 8) * 2;

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < count) fill(i, i);
    cp_async_commit();
  }
  for (int i = 0; i < count; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // entry i has landed; entry i-1's buffer is free
    const int next = i + kStages - 1;
    if (next < count) fill(next, next % kStages);
    cp_async_commit();
    if ((entries[i] >> slab) & 1) {
      const uint32_t base = smem_addr(smem + (i % kStages) * kStageBytes);
#pragma unroll
      for (int ks = 0; ks < kKC; ks += 16) {
        uint32_t b[4][2];
        ldmatrix_x4_trans(&b[0][0], base + b_off + ks * kBLd * 2);
        ldmatrix_x4_trans(&b[2][0], base + b_off + (ks * kBLd + 16) * 2);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          uint32_t a[4];
          ldmatrix_x4(a, base + a_off + (mt * 16 * kALd + ks) * 2);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a, b[nt]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: f32 bias, ReLU, one rounding; staged as [kBM][kBLd] bf16
  __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(smem);
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = slab * kSlab + nt * 8 + tg * 2;
    const float b0 = n0 + col < nc ? bias[(n0 + col) % cout] : 0.f;
    const float b1 = n0 + col + 1 < nc ? bias[(n0 + col + 1) % cout] : 0.f;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int row = mh * 64 + mt * 16 + g;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* c = &acc[mt][nt][2 * half];
        *reinterpret_cast<__nv_bfloat162*>(os + (row + 8 * half) * kBLd + col) =
            __floats2bfloat162_rn(fmaxf(c[0] + b0, 0.f), fmaxf(c[1] + b1, 0.f));
      }
    }
  }
  __syncthreads();
  const int ncols = min(kGN, nc - n0);
  for (int e = tid; e < kBM * (kGN / 8); e += kThreads) {
    const int p = e / (kGN / 8), col = (e % (kGN / 8)) * 8;
    const int64_t m = m0 + p;
    if (m >= rows || col >= ncols) continue;
    __nv_bfloat16* dst = out + m * nc + n0 + col;
    const __nv_bfloat16* src = os + p * kBLd + col;
    if (vec_o) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int j = 0; j < 8 && col + j < ncols; ++j) dst[j] = src[j];
    }
  }
}

// ------------------------------------------------------------------ f32

constexpr int kFM = 64, kFN = 64, kFK = 16;

__global__ void __launch_bounds__(kThreads)
gemm_conv_f32(const float* __restrict__ x, const float* __restrict__ wc,
              const float* __restrict__ wl, const float* __restrict__ wr,
              const float* __restrict__ bias, float* __restrict__ out,
              int64_t rows, int h, int wb, int k1, int nc, int cout) {
  __shared__ __align__(16) float As[kFK][kFM];  // [k][m]
  __shared__ __align__(16) float Bs[kFK][kFN];  // [k][n]

  const int tid = threadIdx.x;
  const int64_t m0 = (int64_t)blockIdx.x * kFM;
  const int n0 = blockIdx.y * kFN;
  const int chunks_per_seg = (k1 + kFK - 1) / kFK;
  // loads: A row tid/4, columns (tid%4)*4 .. +3; B row tid/16, columns
  // (tid%16)*4 .. +3
  const int a_r = tid >> 2, a_k = (tid & 3) * 4;
  const ARow arow = a_row(m0 + a_r, rows, h, wb);
  const int b_k = tid >> 4, b_c = (tid & 15) * 4;
  // compute: rows ty*4 .. +3, columns tx*4 .. +3
  const int ty = tid >> 4, tx = tid & 15;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < 9 * chunks_per_seg; ++t) {
    const int seg = t / chunks_per_seg;
    const int c0 = (t - seg * chunks_per_seg) * kFK;
    const int s = seg / 3, dy = seg % 3;
    const int64_t src = a_src(arow, dy, seg_db(s), h, wb);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + a_k + j;
      As[a_k + j][a_r] = (src >= 0 && c < k1) ? x[src * k1 + c] : 0.f;
    }
    const float* w = s == 0 ? wc : (s == 1 ? wl : wr);
    const int k = c0 + b_k;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + b_c + j;
      Bs[b_k][b_c + j] =
          (k < k1 && col < nc) ? w[((int64_t)dy * k1 + k) * nc + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + ty * 4 + i;
    if (m >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < nc) out[m * nc + col] = fmaxf(acc[i][j] + bias[col % cout], 0.f);
    }
  }
}

}  // namespace
}  // namespace annonet

extern "C" int annonet_conv3x3_gemm(const void* x, const void* wc,
                                    const void* wl, const void* wr,
                                    const void* bias, const void* table,
                                    void* out, int64_t n, int64_t h,
                                    int64_t wb, int k1, int nc, int cout,
                                    int bf16, void* stream) {
  using namespace annonet;
  cudaGetLastError();  // report this launch's error only
  if (k1 <= 0 || nc <= 0 || cout <= 0 || nc % cout || h > INT32_MAX ||
      wb > INT32_MAX || (bf16 && table == nullptr))
    return (int)cudaErrorInvalidValue;
  const int64_t rows = n * h * wb;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (bf16) {
    const auto* xt = static_cast<const __nv_bfloat16*>(x);
    const auto* wct = static_cast<const __nv_bfloat16*>(wc);
    const auto* wlt = static_cast<const __nv_bfloat16*>(wl);
    const auto* wrt = static_cast<const __nv_bfloat16*>(wr);
    auto* ot = static_cast<__nv_bfloat16*>(out);
    const int vec_a = k1 % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const int vec_b = nc % 8 == 0 && reinterpret_cast<uintptr_t>(wc) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(wl) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(wr) % 16 == 0;
    const int vec_o = nc % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    const int groups = (nc + kGN - 1) / kGN;
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_conv_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((unsigned)((rows + kBM - 1) / kBM), (unsigned)groups);
    gemm_conv_bf16<<<grid, kThreads, kSmemBytes, s>>>(
        xt, wct, wlt, wrt, b, static_cast<const int*>(table), ot, rows, (int)h,
        (int)wb, k1, nc, cout, groups, vec_a, vec_b, vec_o);
  } else {
    dim3 grid((unsigned)((rows + kFM - 1) / kFM), (unsigned)((nc + kFN - 1) / kFN));
    gemm_conv_f32<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(wc),
        static_cast<const float*>(wl), static_cast<const float*>(wr), b,
        static_cast<float*>(out), rows, (int)h, (int)wb, k1, nc, cout);
  }
  return (int)cudaGetLastError();
}
