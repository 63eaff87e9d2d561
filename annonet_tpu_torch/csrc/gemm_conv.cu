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
// shifted by 0, -1, +1 for Wc, Wl, Wr. The kernel holds for any weights: it
// does not use the zero rows that build_gemm_kernels_aligned leaves in Wl
// and Wr.
//
// Design. The TPU kernel materialises a padded copy and three shifted
// planes and rolls them in VMEM; here the shifts are address offsets into
// the one input in device memory, and out-of-range rows and blocks are
// predicated zero loads. Each block computes a 128 x 128 output tile with
// eight warps of bf16 mma.sync m16n8k16 (f32 accumulate), streaming K in
// chunks of 32 through double-buffered shared memory: the next chunk's
// global loads are in registers while the current one is multiplied. Each
// (segment, dy) part of K is zero-padded to whole chunks in shared memory,
// so K1 need not divide 32 (the RGB stem's K1 = 24). The weights are
// stored transposed in shared memory (column-major B), so every fragment
// is one 32-bit shared load, on padded rows that make them conflict-free.
// f32 runs on the CUDA cores (a 64 x 64 tile, 4 x 4 outputs a thread): only
// the f32 configs, used to check the arithmetic, take it.
//
// What bounds it on an H100: the folded GEMM does fold times the conv's
// FLOPs (the zeros in the folded weights ride along), 2*M*NC*9*K1, e.g.
// 1.48 TFLOP for the flagship's dec1/conv0 on a 25-tile 896^2 batch
// against 0.19 GB of bytes: far above the ~295 FLOP/byte where bf16
// tensor cores stop waiting on memory, so it is bound by tensor-core
// throughput. mma.sync reaches only part of the card's wgmma peak; moving
// to wgmma with TMA loads, or dropping the zero blocks, is later work.
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

constexpr int kBM = 128, kBN = 128, kKC = 32;
constexpr int kLd = kKC + 8;  // padded shared row, in bf16 elements

struct Bf16Stage {
  uint4 a[2];  // two 8-element pieces of A rows
  uint4 b[2];  // two 8-column pieces of one weight row
};

// the first min(n, 8) elements at p, zero-filled to 8, packed low first
__device__ __forceinline__ uint4 pack8(const __nv_bfloat16* p, int n) {
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (j < n) w[j >> 1] |= (uint32_t)__bfloat16_as_ushort(p[j]) << (16 * (j & 1));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
gemm_conv_bf16(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ wc,
               const __nv_bfloat16* __restrict__ wl,
               const __nv_bfloat16* __restrict__ wr,
               const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
               int64_t rows, int h, int wb, int k1, int nc, int cout,
               int vec_a, int vec_b) {
  __shared__ __align__(16) __nv_bfloat16 As[2][kBM][kLd];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][kBN][kLd];  // [n][k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t m0 = (int64_t)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int chunks_per_seg = (k1 + kKC - 1) / kKC;
  const int chunks = 9 * chunks_per_seg;

  // A: rows tid/4 and tid/4 + 64, columns (tid%4)*8 .. +7 of the chunk
  const int a_kk = (tid & 3) * 8;
  ARow arow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) arow[i] = a_row(m0 + (tid >> 2) + 64 * i, rows, h, wb);
  // B: weight row k = tid%32 of the chunk, columns ng*8 and (ng+8)*8
  const int b_k = tid & 31, b_ng = tid >> 5;

  auto load = [&](int t, Bf16Stage& st) {
    const int seg = t / chunks_per_seg;
    const int c0 = (t - seg * chunks_per_seg) * kKC;
    const int s = seg / 3, dy = seg % 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int64_t src = a_src(arow[i], dy, seg_db(s), h, wb);
      const int c = c0 + a_kk;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (src >= 0 && c < k1) {
        const __nv_bfloat16* p = x + src * k1 + c;
        v = vec_a ? *reinterpret_cast<const uint4*>(p) : pack8(p, k1 - c);
      }
      st.a[i] = v;
    }
    const __nv_bfloat16* w = s == 0 ? wc : (s == 1 ? wl : wr);
    const int k = c0 + b_k;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int col = n0 + (b_ng + 8 * i) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (k < k1 && col < nc) {
        const __nv_bfloat16* p = w + ((int64_t)dy * k1 + k) * nc + col;
        v = vec_b && col + 8 <= nc ? *reinterpret_cast<const uint4*>(p)
                                   : pack8(p, nc - col);
      }
      st.b[i] = v;
    }
  };

  auto store = [&](int buf, const Bf16Stage& st) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint4*>(&As[buf][(tid >> 2) + 64 * i][a_kk]) = st.a[i];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t words[4] = {st.b[i].x, st.b[i].y, st.b[i].z, st.b[i].w};
      const int col = (b_ng + 8 * i) * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        Bs[buf][col + j][b_k] = __ushort_as_bfloat16(
            (unsigned short)(words[j >> 1] >> (16 * (j & 1))));
    }
  };

  // warp tile: rows wm*32 .. +32, columns wn*64 .. +64
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, tg = lane & 3;
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  Bf16Stage stage;
  load(0, stage);
  store(0, stage);
  __syncthreads();
  for (int t = 0; t < chunks; ++t) {
    const int buf = t & 1;
    if (t + 1 < chunks) load(t + 1, stage);
#pragma unroll
    for (int ks = 0; ks < kKC; ks += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm * 32 + mt * 16 + g;
        const int kc = ks + tg * 2;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(&As[buf][r][kc]);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(&As[buf][r + 8][kc]);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(&As[buf][r][kc + 8]);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(&As[buf][r + 8][kc + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = wn * 64 + nt * 8 + g;
        const int kc = ks + tg * 2;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&Bs[buf][col][kc]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&Bs[buf][col][kc + 8]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
      }
    }
    if (t + 1 < chunks) store(buf ^ 1, stage);
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t m = m0 + wm * 32 + mt * 16 + g + 8 * half;
      if (m >= rows) continue;
      __nv_bfloat16* o = out + m * nc;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = n0 + wn * 64 + nt * 8 + tg * 2;
        if (col >= nc) continue;
        const float v0 = fmaxf(acc[mt][nt][2 * half] + bias[col % cout], 0.f);
        if (col + 1 < nc) {
          const float v1 =
              fmaxf(acc[mt][nt][2 * half + 1] + bias[(col + 1) % cout], 0.f);
          if ((nc & 1) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(o + col) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            o[col] = __float2bfloat16_rn(v0);
            o[col + 1] = __float2bfloat16_rn(v1);
          }
        } else {
          o[col] = __float2bfloat16_rn(v0);
        }
      }
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
                                    const void* bias, void* out, int64_t n,
                                    int64_t h, int64_t wb, int k1, int nc,
                                    int cout, int bf16, void* stream) {
  using namespace annonet;
  cudaGetLastError();  // report this launch's error only
  if (k1 <= 0 || nc <= 0 || cout <= 0 || nc % cout || h > INT32_MAX ||
      wb > INT32_MAX)
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
    const int vec_a = k1 % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const int vec_b = nc % 8 == 0 && reinterpret_cast<uintptr_t>(wc) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(wl) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(wr) % 16 == 0;
    dim3 grid((unsigned)((rows + kBM - 1) / kBM), (unsigned)((nc + kBN - 1) / kBN));
    gemm_conv_bf16<<<grid, kThreads, 0, s>>>(
        xt, wct, wlt, wrt, b, static_cast<__nv_bfloat16*>(out), rows, (int)h,
        (int)wb, k1, nc, cout, vec_a, vec_b);
  } else {
    dim3 grid((unsigned)((rows + kFM - 1) / kFM), (unsigned)((nc + kFN - 1) / kFN));
    gemm_conv_f32<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(wc),
        static_cast<const float*>(wl), static_cast<const float*>(wr), b,
        static_cast<float*>(out), rows, (int)h, (int)wb, k1, nc, cout);
  }
  return (int)cudaGetLastError();
}
