// K1 and K2 in bf16: the 3x3 conv + bias + ReLU as an implicit GEMM on the
// tensor cores.
//
// Replaces the Pallas TPU kernels of annonet_tpu/ops/int8_conv_mosaic.py
//   K1 fconv3x3_s1_bias_relu (:359)  stride 1, zero padding (1, 1), with the
//                                    decoder's concat as a second input x2
//   K2 fconv3x3_s2_bias_relu (:426)  stride 2, XLA SAME padding (0, 1):
//                                    output o taps inputs 2o + d
// in bf16; the f32 configs run conv.cu's implicit GEMM on the CUDA cores
// (TF32 tensor cores keep 10 mantissa bits and would break the 1e-4
// contract the f32 configs exist to check). annonet_conv3x3_bias_relu
// (conv.cu) dispatches on the dtype.
//
// What it computes: out[n, o, co] = bf16(relu(bias[co] + sum over the 9
// taps and all input channels of x * w, in f32)) -- one rounding, after the
// bias, as the TPU kernels' _bias_relu (int8_conv_mosaic.py:355, :422).
//
// What bounds it on an H100. On the flagship's 25-tile 896^2 batch
// (bytes = input + output + weights once; bound = max(bytes / 3.35 TB/s,
// FLOPs / 989 TFLOP/s)):
//
//   layer       stride  x -> cout              FLOP/B  bound ms  binds
//   stem/conv0  1       [25,896,896,3]  -> 16      23     0.228  bytes
//   stem/conv1  1       [25,896,896,16] -> 16      72     0.383  bytes
//   enc1/conv0  2       [25,896,896,16] -> 32      48     0.288  bytes
//   enc1/conv1  1       [25,448,448,32] -> 32     144     0.192  bytes
//   enc2/conv0  2       [25,448,448,32] -> 64      96     0.144  bytes
//   enc2/conv1  1       [25,224,224,64] -> 64     288     0.096  bytes
//   enc3/conv0  2       [25,224,224,64] -> 128    192     0.072  bytes
//   enc3/conv1  1       [25,112,112,128] -> 128   575     0.094  MMA
//   dec3/conv0  1       [25,224,224,64+64] -> 64  384     0.187  MMA
//   dec2/conv0  1       [25,448,448,32+32] -> 32  192     0.288  bytes
//   dec1/conv0  1       [25,896,896,16+16] -> 16   96     0.575  bytes
//
// Most layers sit under the card's ~295 FLOP/byte bf16 line: bound by
// bytes, and at 16-32 channels by the latency of the loads that bring
// them. The design reads each input element once per block (plus the
// block's halo), never writes an im2col matrix, overlaps a chunk's copies
// with the previous chunk's products and stores 16 bytes a thread. The
// deep layers above the line are bound by the tensor cores: there each
// A fragment feeds up to three MMAs (below) and B fragments are reused
// over a warp's rows. The f32 path's implicit GEMM on the CUDA cores
// (conv.cu) runs at 30-39 TFLOP/s on the layers with 16 or more input
// channels, so its time follows FLOPs instead.
//
// Design. GEMM M = the block's output pixels (kTH rows x kTW columns: 8 x
// 64 at stride 1 and cout <= 32, fewer rows or columns for wider slabs),
// N = cout (a slab of BN = 16, 32, 64 or 128 channels per block, grid.y
// over slabs), K = 9 * (c1 + c2), walked channel chunk by channel chunk
// (16 channels, the k of bf16 mma) and, inside a chunk, tap by tap. For
// each chunk the block copies its tile's halo patch (8-channel 16-byte
// pieces, with cp.async) and the chunk's weights [9][16][BN] into shared
// memory, double-buffered so that the next chunk's copies run under the
// current chunk's MMAs. Padding and the ragged edge are zero pieces.
// Channel c comes from x when c < c1 and from x2 otherwise; where c1 or c2
// is not a multiple of 8 (the RGB stem's 3, a grayscale 1, odd concats)
// the pieces are gathered element by element instead of by cp.async. The
// weights stream with the chunks, so enc3/conv1's 288 KiB never need to
// fit in shared memory.
//
// The patch layout: one 16-byte piece per (pixel, channel half), stored in
// two planes by channel half and, at stride 2, by column parity
// ([half][row][parity][column / stride]). An ldmatrix phase reads the same
// half of 8 output pixels of one row, whose input columns are x*s + dx:
// within a parity plane those are 8 consecutive pieces, so both strides
// read without bank conflicts. (Interleaving the two halves at a 32-byte
// pixel pitch conflicts 2-way at stride 1 and 4-way at stride 2.)
//
// Fragments. A warp owns kMT output rows (4 at stride 1, 2 at stride 2)
// of one 16-column strip: one m16 tile per row. A fragments come by
// ldmatrix.x4 with per-lane row addresses (the lane's pixel plus the
// tap's constant offset). The warp walks the column taps dx; for each it
// loads the B fragments of its three row taps (ldmatrix.x4.trans from the
// HWIO weights, a row-major [K, N] whose rows are padded by 8 elements,
// conflict-free), then each patch row it reads once, and feeds that A
// fragment to every (output row, row tap) pair that reads it: at stride
// 1, 6 A loads serve 12 m16 products per dx instead of 12 loads. At
// cout <= 32 the block is 8 warps along M, each holding the whole slab's
// B fragments of a column tap in registers, so the thin-N layers are not
// paced by shared-memory loads of B. The epilogue adds the f32 bias, applies ReLU, rounds once to bf16,
// stages the tile in shared memory and stores 16 bytes per thread where
// cout is a multiple of 8, element by element at the ragged edge.
//
// MMA: bf16 mma.sync.m16n8k16 with f32 accumulation, as G1
// (gemm_conv.cu). wgmma would need A either in registers in its warpgroup
// layout or in shared memory in one of its canonical layouts; the halo
// patch's rows (pixel + tap offset) fit neither without a copy per tap,
// and most layers here are bound by bytes, not by the MMA rate. Offsets
// are 64-bit; any N (grid.z chunks of kMaxGridYZ images), H and W (even
// at stride 2), c1 >= 1, c2 >= 0 and cout >= 1.

#include "common.cuh"

namespace annonet {
namespace {

constexpr int kThreads = 256;  // 8 warps

template <int STRIDE, int BN>
struct Shape {
  static constexpr int kNT = BN == 16 ? 2 : 4;         // n8 tiles a warp
  static constexpr int kWN = BN / (8 * kNT);           // warps along N
  static constexpr int kWM = 8 / kWN;                  // warps along M
  static constexpr int kMT = STRIDE == 1 ? 4 : 2;      // m16 tiles a warp
  // a warp's m16 tiles are kMT consecutive output rows of one 16-column
  // strip; the block's kWM warps along M cover kStrips strips side by side
  static constexpr int kStrips = kWM < 4 ? kWM : 4;
  static constexpr int kTW = 16 * kStrips;             // output columns
  static constexpr int kTH = kMT * (kWM / kStrips);    // output rows
  static constexpr int kM = kTH * kTW;                 // output pixels
  static constexpr int kPH = (kTH - 1) * STRIDE + 3;   // patch rows
  static constexpr int kPW = (kTW - 1) * STRIDE + 3;   // patch columns
  static constexpr int kPWS = (kPW + STRIDE - 1) / STRIDE;  // a parity plane
  static constexpr int kABytes = 2 * kPH * STRIDE * kPWS * 16;
  static constexpr int kBNP = BN + 8;                  // padded B row
  static constexpr int kBBytes = 9 * 16 * kBNP * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kOutBytes = kM * kBNP * 2;      // the staged tile
  static_assert(kWN * kWM == 8 && kM == kWM * kMT * 16, "block shape");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
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

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// the 16-byte piece of channel half ``half`` of patch pixel (row, col)
template <int STRIDE, int BN>
__device__ __forceinline__ int piece(int half, int row, int col) {
  using S = Shape<STRIDE, BN>;
  return ((half * S::kPH + row) * STRIDE + col % STRIDE) * S::kPWS + col / STRIDE;
}

template <int STRIDE, int BN>
__global__ void __launch_bounds__(kThreads)
igemm_kernel(const __nv_bfloat16* __restrict__ x,
             const __nv_bfloat16* __restrict__ x2,
             const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
             __nv_bfloat16* __restrict__ out, int64_t h, int64_t wd, int c1,
             int c2, int cout, int64_t tiles_x, int vec_x, int vec_w,
             int vec_o) {
  using S = Shape<STRIDE, BN>;
  constexpr int kPad = STRIDE == 1 ? 1 : 0;  // top/left zero padding
  extern __shared__ __align__(16) unsigned char smem[];

  const int cin = c1 + c2;
  const int chunks = (cin + 15) / 16;
  const int64_t ho = h / STRIDE, wo = wd / STRIDE;
  const int64_t img = blockIdx.z;
  const int64_t oy0 = (int64_t)(blockIdx.x / tiles_x) * S::kTH;
  const int64_t ox0 = (int64_t)(blockIdx.x % tiles_x) * S::kTW;
  const int cob = blockIdx.y * BN;
  const int64_t iy0 = oy0 * STRIDE - kPad, ix0 = ox0 * STRIDE - kPad;
  const __nv_bfloat16* xi = x + img * h * wd * c1;
  const __nv_bfloat16* x2i = c2 ? x2 + img * h * wd * c2 : x2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  // copies (or gathers) channel chunk t into stage buffer buf
  auto fill = [&](int t, int buf) {
    unsigned char* base = smem + buf * S::kStageBytes;
    uint4* a = reinterpret_cast<uint4*>(base);
    const int c0 = t * 16;
    for (int e = tid; e < S::kPH * S::kPW * 2; e += kThreads) {
      const int half = e & 1, pix = e >> 1;
      const int pr = pix / S::kPW, pc = pix - pr * S::kPW;
      const int64_t iy = iy0 + pr, ix = ix0 + pc;
      const int c = c0 + half * 8;
      uint4* dst = a + piece<STRIDE, BN>(half, pr, pc);
      if (iy < 0 || iy >= h || ix < 0 || ix >= wd || c >= cin) {
        *dst = zero;
        continue;
      }
      const int64_t p = iy * wd + ix;
      if (vec_x) {
        cp_async16(dst, c < c1 ? xi + p * c1 + c : x2i + p * c2 + (c - c1));
      } else {
        __nv_bfloat16 v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int cj = c + j;
          v[j] = cj >= cin ? __float2bfloat16_rn(0.f)
                           : (cj < c1 ? xi[p * c1 + cj] : x2i[p * c2 + (cj - c1)]);
        }
        *dst = make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                          pack2(v[4], v[5]), pack2(v[6], v[7]));
      }
    }
    // weights [tap][k][BN] of HWIO [3][3][cin][cout]
    __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(base + S::kABytes);
    for (int e = tid; e < 9 * 16 * (BN / 8); e += kThreads) {
      const int col8 = e % (BN / 8), r = e / (BN / 8);
      const int k = r % 16, tap = r / 16;
      const int c = c0 + k, co = cob + col8 * 8;
      uint4* dst = reinterpret_cast<uint4*>(bs + r * S::kBNP + col8 * 8);
      if (c >= cin || co >= cout) {
        *dst = zero;
        continue;
      }
      const __nv_bfloat16* src = w + ((int64_t)tap * cin + c) * cout + co;
      if (vec_w) {
        cp_async16(dst, src);
      } else {
        __nv_bfloat16 v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = co + j < cout ? src[j] : __float2bfloat16_rn(0.f);
        *dst = make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                          pack2(v[4], v[5]), pack2(v[6], v[7]));
      }
    }
  };

  // warp tile: output rows ty0 .. ty0 + kMT - 1 of the 16-column strip at
  // tx0 (one m16 tile a row), n8 tiles wn*kNT .. +kNT
  const int wm = warp / S::kWN, wn = warp % S::kWN;
  const int ty0 = wm / S::kStrips * S::kMT, tx0 = wm % S::kStrips * 16;
  const int r16 = lane & 15, hi = lane >> 4;
  // this lane's ldmatrix row (pixel tx0 + r16 of the strip) in patch row 0
  // at dx = 0, as a piece index
  const int a_lane = piece<STRIDE, BN>(hi, ty0 * STRIDE, (tx0 + r16) * STRIDE);
  // this lane's ldmatrix.trans row of B: k = r16, columns + 8 * hi
  const int b_off = (r16 * S::kBNP + wn * S::kNT * 8 + hi * 8) * 2;

  float acc[S::kMT][S::kNT][4];
#pragma unroll
  for (int mt = 0; mt < S::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < S::kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  fill(0, 0);
  cp_async_commit();
  for (int t = 0; t < chunks; ++t) {
    if (t + 1 < chunks) {
      fill(t + 1, (t + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* base = smem + (t & 1) * S::kStageBytes;
    const uint32_t a_base = smem_addr(base);
    const uint32_t b_base = smem_addr(base + S::kABytes) + b_off;
    // column tap dx by column tap: the B fragments of its three row taps,
    // then each patch row R the warp's rows read, loaded once and used by
    // every (output row mt, row tap dy) with mt * STRIDE + dy == R
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      uint32_t b[3][S::kNT][2];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int np = 0; np < S::kNT / 2; ++np)
          ldmatrix_x4_trans(&b[dy][2 * np][0],
                            b_base + ((dy * 3 + dx) * 16 * S::kBNP + np * 16) * 2);
#pragma unroll
      for (int r = 0; r < (S::kMT - 1) * STRIDE + 3; ++r) {
        // piece(0, r, dx) - piece(0, 0, 0) in the patch
        const int a_off = (r * STRIDE + dx % STRIDE) * S::kPWS + dx / STRIDE;
        uint32_t a[4];
        ldmatrix_x4(a, a_base + (a_lane + a_off) * 16);
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int mt = (r - dy) / STRIDE;
          if (r < dy || (r - dy) % STRIDE || mt >= S::kMT) continue;
#pragma unroll
          for (int nt = 0; nt < S::kNT; ++nt) mma_bf16(acc[mt][nt], a, b[dy][nt]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: f32 bias, ReLU, one rounding; staged as [kM][kBNP] bf16
  __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(smem);
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int nt = 0; nt < S::kNT; ++nt) {
    const int col = (wn * S::kNT + nt) * 8 + tg * 2;
    const float b0 = cob + col < cout ? bias[cob + col] : 0.f;
    const float b1 = cob + col + 1 < cout ? bias[cob + col + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < S::kMT; ++mt) {
      // staged pixel index of m16 row g: output row ty0 + mt, column tx0 + g
      const int row = (ty0 + mt) * S::kTW + tx0 + g;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* c = &acc[mt][nt][2 * half];
        *reinterpret_cast<__nv_bfloat162*>(os + (row + 8 * half) * S::kBNP + col) =
            __floats2bfloat162_rn(fmaxf(c[0] + b0, 0.f), fmaxf(c[1] + b1, 0.f));
      }
    }
  }
  __syncthreads();
  const int ncols = min(BN, cout - cob);
  for (int e = tid; e < S::kM * (BN / 8); e += kThreads) {
    const int p = e / (BN / 8), col = (e % (BN / 8)) * 8;
    const int64_t oy = oy0 + p / S::kTW, ox = ox0 + p % S::kTW;
    if (oy >= ho || ox >= wo || col >= ncols) continue;
    __nv_bfloat16* dst = out + ((img * ho + oy) * wo + ox) * cout + cob + col;
    const __nv_bfloat16* src = os + p * S::kBNP + col;
    if (vec_o) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int j = 0; j < 8 && col + j < ncols; ++j) dst[j] = src[j];
    }
  }
}

template <int STRIDE, int BN>
cudaError_t launch(const __nv_bfloat16* x, const __nv_bfloat16* x2,
                   const __nv_bfloat16* w, const float* bias,
                   __nv_bfloat16* out, int64_t n, int64_t h, int64_t wd,
                   int c1, int c2, int cout, cudaStream_t stream) {
  using S = Shape<STRIDE, BN>;
  const int chunks = (c1 + c2 + 15) / 16;
  const int stage = (chunks > 1 ? 2 : 1) * S::kStageBytes;
  const int smem = stage > S::kOutBytes ? stage : S::kOutBytes;
  // above 48 KB of dynamic shared memory a kernel needs the opt-in
  const cudaError_t e = cudaFuncSetAttribute(
      igemm_kernel<STRIDE, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int64_t ho = h / STRIDE, wo = wd / STRIDE;
  const int64_t tiles_x = (wo + S::kTW - 1) / S::kTW;
  const int64_t tiles = tiles_x * ((ho + S::kTH - 1) / S::kTH);
  const int64_t slabs = (cout + BN - 1) / BN;
  if (tiles > INT32_MAX || slabs > kMaxGridYZ) return cudaErrorInvalidValue;
  const int vec_x = c1 % 8 == 0 && c2 % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(x2) % 16 == 0;
  const int vec_w = cout % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int vec_o = cout % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  for (int64_t n0 = 0; n0 < n; n0 += kMaxGridYZ) {
    const int64_t nb = n - n0 < kMaxGridYZ ? n - n0 : kMaxGridYZ;
    dim3 grid((unsigned)tiles, (unsigned)slabs, (unsigned)nb);
    igemm_kernel<STRIDE, BN><<<grid, kThreads, smem, stream>>>(
        x + n0 * h * wd * c1, c2 ? x2 + n0 * h * wd * c2 : x2, w, bias,
        out + n0 * ho * wo * cout, h, wd, c1, c2, cout, tiles_x, vec_x, vec_w,
        vec_o);
  }
  return cudaGetLastError();
}

template <int STRIDE>
cudaError_t dispatch(const __nv_bfloat16* x, const __nv_bfloat16* x2,
                     const __nv_bfloat16* w, const float* b,
                     __nv_bfloat16* out, int64_t n, int64_t h, int64_t wd,
                     int c1, int c2, int cout, cudaStream_t s) {
  if (cout <= 16) return launch<STRIDE, 16>(x, x2, w, b, out, n, h, wd, c1, c2, cout, s);
  if (cout <= 32) return launch<STRIDE, 32>(x, x2, w, b, out, n, h, wd, c1, c2, cout, s);
  if (cout <= 64) return launch<STRIDE, 64>(x, x2, w, b, out, n, h, wd, c1, c2, cout, s);
  return launch<STRIDE, 128>(x, x2, w, b, out, n, h, wd, c1, c2, cout, s);
}

}  // namespace

cudaError_t conv3x3_igemm_bf16(const void* x, const void* x2, const void* w,
                               const float* bias, void* out, int64_t n,
                               int64_t h, int64_t wd, int c1, int c2,
                               int cout, int stride, cudaStream_t s) {
  const auto* xt = static_cast<const __nv_bfloat16*>(x);
  const auto* x2t = static_cast<const __nv_bfloat16*>(x2);
  const auto* wt = static_cast<const __nv_bfloat16*>(w);
  auto* ot = static_cast<__nv_bfloat16*>(out);
  return stride == 1
             ? dispatch<1>(xt, x2t, wt, bias, ot, n, h, wd, c1, c2, cout, s)
             : dispatch<2>(xt, x2t, wt, bias, ot, n, h, wd, c1, c2, cout, s);
}

}  // namespace annonet
