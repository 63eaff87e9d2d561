// The fused conv + bias + ReLU kernels of the runtime segmentation net
// (K1-K3) in f32. In bf16 they run on the tensor cores (K1 and K2 in
// conv_igemm.cu, K3 and its requant mode in up_igemm.cu); the C entry
// points at the end of this file dispatch on the dtype.
//
// Replaces the Pallas TPU kernels of annonet_tpu/ops/int8_conv_mosaic.py
//   K1 fconv3x3_s1_bias_relu (:359)  3x3 stride 1, zero padding (1, 1), with
//                                    the decoder's concat as a second input x2
//   K2 fconv3x3_s2_bias_relu (:426)  3x3 stride 2, XLA SAME padding (0, 1):
//                                    output o taps inputs 2o + d
//   K3 fup_bias_relu         (:485)  2x2 stride-2 transpose conv, and its
//                                    requant mode (the int8 net's up)
// in f32, and the XLA convs the default JAX path runs in their place
// (models/segnet.py _conv / _conv_transpose). The TPU kernels work on a
// width-folded layout that packs 8 pixels into the 128 MXU lanes; these
// kernels run the plain NHWC geometry.
//
// K1 and K2 compute out[n, o, co] = relu(bias[co] + the sum over the 9
// taps and the c1 + c2 input channels of x * w), summed in f32 by FMAs,
// one f32 result per output. No TF32: the f32 configs exist to check the
// arithmetic to 1e-4 of scale, and TF32 keeps 10 mantissa bits.
//
// What bounds K1 and K2 on an H100. The flagship's layers on the inferer's
// 25-tile 872^2 batch of a 4096^2 image (bytes = input + output + weights
// once; bound = max(bytes / 3.35 TB/s, FLOPs / 67 TFLOP/s, the f32 rate
// outside the tensor cores)):
//
//   layer       stride  x -> cout                GFLOP  FLOP/B  bound ms  binds
//   stem/conv0  1       [25,872,872,3] -> 16       16.4      11     0.431  bytes
//   stem/conv1  1       [25,872,872,16] -> 16      87.6      36     1.307  FMAs
//   enc1/conv0  2       [25,872,872,16] -> 32      43.8      24     0.654  FMAs
//   enc1/conv1  1       [25,436,436,32] -> 32      87.6      72     1.307  FMAs
//   enc2/conv0  2       [25,436,436,32] -> 64      43.8      48     0.654  FMAs
//   enc2/conv1  1       [25,218,218,64] -> 64      87.6     144     1.307  FMAs
//   enc3/conv0  2       [25,218,218,64] -> 128     43.8      96     0.654  FMAs
//   enc3/conv1  1       [25,109,109,128] -> 128    87.6     287     1.307  FMAs
//   dec3/conv0  1       [25,218,218,64+64] -> 64  175.2     192     2.615  FMAs
//   dec2/conv0  1       [25,436,436,32+32] -> 32  175.2      96     2.615  FMAs
//   dec1/conv0  1       [25,872,872,16+16] -> 16  175.2      48     2.615  FMAs
//
// The card's f32 line is 67e12 / 3.35e12 = 20 FLOP/byte, so every layer but
// the RGB stem is bound by its FMAs: 13.5 ms for K1 and 1.96 ms for K2 over
// the batch. The design keeps the FMA pipe fed and issues little else: each
// shared-memory load feeds 17-22 FMAs, and the copies that bring the data
// run under the FMAs.
//
// Design: an implicit GEMM on the CUDA cores. GEMM M = the block's output
// pixels (8 rows x kTW columns: 8 x 64 where cout <= 32, 8 x 32 above),
// N = a slab of BN = 16, 32 or 64 output channels (one slab a block up to
// 64 channels, so those layers stage each input patch once; grid.y runs
// over the slabs above that), K = 9 * (c1 + c2), walked by channel chunk
// and, inside a chunk, tap by tap.
//
// Register tile. A warp owns one output row of the block's tile; a thread
// owns kTM = 8 consecutive output pixels of that row and kTN output
// channels (4 at BN 16, else 8): 8 x 4 or 8 x 8 f32 accumulators. For each
// 4-channel piece of the chunk and each row tap dy it loads the patch
// pixels its 8 outputs read -- 10 at stride 1; at stride 2 the 9 even
// ones, then the 8 odd ones -- one 16-byte load each (the piece's 4
// channels of one pixel), then for each column tap dx and channel its kTN
// weights as 16-byte loads, and feeds them to 8 * kTN FMAs. At stride 1,
// 34 loads feed 768 FMAs (8 x 8) and 22 feed 384 (8 x 4). Registers: 8
// warps a block and two blocks an SM (128 registers a thread), but one
// block (168) for the 8 x 8 tile at stride 1, the faster of the two on an
// H100; no spill (chip_smoke.py's resource usage). On an H100 (700 W) the
// layers with 16 or more input channels run at 30-39 TFLOP/s, 45-58% of
// the f32 peak (chip_smoke.py phase 3).
//
// Staging. Each chunk's halo patch ([piece][row][column] of 16-byte pieces)
// and weights ([tap][channel][BN] from HWIO) are copied into shared memory
// by 16-byte cp.async, double-buffered, so that the next chunk's copies
// run under this chunk's FMAs; dynamic shared memory, with the opt-in above
// 48 KB. Padding and the ragged edges are zero pieces. Channel c comes from
// x when c < c1 and from x2 otherwise; where c1 or c2 is not a multiple of
// 4 (the RGB stem's 3, a grayscale 1, odd concats) the patch pieces are
// gathered element by element, where cout is not the weights are, and the
// output is stored element by element instead of 16 bytes a thread.
//
// Bank conflicts. The threads of a warp that share a pixel group read the
// same patch piece (a broadcast). The warp's pixel groups start 8 * STRIDE
// patch columns apart, and a patch row holds one pad piece after every
// 8 * STRIDE columns, so the groups' pieces fall in distinct 16-byte bank
// groups at both strides. A thread's channels are one or two 4-channel
// quads BN / 2 apart, so the warp's weight loads read consecutive pieces.
//
// The stem (c1 + c2 <= 4) runs with one 4-channel piece a pixel: K = 9 x 4
// = 36 (27 real for RGB). Its bound is its bytes (0.431 ms against 0.327
// ms for its FMAs at K = 36), and at 1.08 ms on an H100 it is held by its
// one chunk's gather, which no FMA of the block hides, not by K: packing K
// as (tap, channel) to 28 would not cut its time.
//
// Choices (dispatch_f32), each covered by tests/test_torch_cuda.py:
//   BN      16 where cout <= 16, 32 where cout <= 32, else 64 (cout > 64
//           in slabs of 64); the 8 x 8 tile (BN 32 and 64) at stride 1
//           with one block an SM, every other shape with two
//   chunk   8 channels (2 pieces) at stride 1 where c1 + c2 > 4; 4 channels
//           (1 piece) at stride 2 and for the stems
//   paths   the patch by cp.async where c1 % 4 == c2 % 4 == 0 and x, x2 are
//           16-byte aligned, else gathered; the weights by cp.async and
//           16-byte stores where cout % 4 == 0 (and aligned), else element
//           by element
// Any N (grid.z chunks of kMaxGridYZ images), H and W (even at stride 2),
// c1 >= 1, c2 >= 0, cout >= 1; offsets are 64-bit (a 25-tile batch of
// 872^2 at 32 channels is close to 2^31 elements).
//
// f32 K3 is a direct convolution: each thread keeps 16 output channels of
// the four outputs of one input pixel. Numerics: f32 accumulation, + f32
// bias, ReLU, one rounding to the output dtype.
//
// K3 has a requant mode, the int8 net's default ``up`` layer
// (quantized_runtime.py:480-487): the int8 input times the per-channel
// scale s_in, rounded to the compute dtype, goes through the same
// transpose conv with f32 accumulation; the sum is rounded to the compute
// dtype (as XLA's bf16 conv output is) and requantized to int8 with one
// fused multiply-add, clip [0, 127] and truncation (see ops/qconv.py).

#include "common.cuh"

namespace annonet {
namespace {

constexpr int kThreads = 256;  // K3: 8 warps
constexpr int kCpt = 16;       // K3: output channels per thread

// ---------------------------------------------------------------------------
// K1 and K2 in f32: the implicit GEMM on the CUDA cores
// ---------------------------------------------------------------------------

// the f32 K1/K2 block: kFWarps warps, one output row each
constexpr int kFWarps = 8;
constexpr int kFThreads = 32 * kFWarps;

template <int STRIDE, int BN, int KP>
struct FShape {
  static constexpr int kTM = 8;                     // output pixels a thread
  static constexpr int kTN = BN == 16 ? 4 : 8;      // output channels a thread
  static constexpr int kNG = BN / kTN;              // threads along N: 4 or 8
  static constexpr int kGroups = 32 / kNG;          // pixel groups a warp
  static constexpr int kTW = kTM * kGroups;         // output columns: 64 or 32
  static constexpr int kTH = kFWarps;               // output rows: a warp each
  static constexpr int kKC = 4 * KP;                // channels a chunk
  static constexpr int kPH = (kTH - 1) * STRIDE + 3;      // patch rows
  static constexpr int kPW = (kTW - 1) * STRIDE + 3;      // patch columns
  static constexpr int kSkew = kTM * STRIDE;        // a pad piece after each kSkew
  static constexpr int kPWS = kPW + (kPW - 1) / kSkew;    // pieces a patch row
  static constexpr int kAPieces = KP * kPH * kPWS;
  static constexpr int kStageBytes = kAPieces * 16 + 9 * kKC * BN * 4;
  // blocks an SM is to hold, so at most 65536 / (kFThreads * kBlocks)
  // registers a thread: the 8 x 8 tile at stride 1 runs faster with 168
  // registers and one block than with 128 and two, the others do not
  static constexpr int kBlocks = STRIDE == 1 && kTN == 8 ? 1 : 2;
  static_assert(kNG * kTN == BN && kTW * kTH == kFThreads / kNG * kTM, "block shape");
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

// channel ``i`` (a constant after unrolling) of a 4-channel piece
__device__ __forceinline__ float channel(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc[m][n] += v[m] * w[n] for one channel of one tap
template <int TM, int TN>
__device__ __forceinline__ void outer(float (&acc)[TM][TN], const float (&v)[TM],
                                      const float (&w)[TN]) {
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[m][n] = fmaf(v[m], w[n], acc[m][n]);
}

template <int STRIDE, int BN, int KP>
__global__ void __launch_bounds__(kFThreads, (FShape<STRIDE, BN, KP>::kBlocks))
simt_conv_kernel(const float* __restrict__ x, const float* __restrict__ x2,
                 const float* __restrict__ w, const float* __restrict__ bias,
                 float* __restrict__ out, int64_t h, int64_t wd, int c1, int c2,
                 int cout, int64_t tiles_x, int vec_x, int vec_w, int vec_o) {
  using S = FShape<STRIDE, BN, KP>;
  constexpr int kTM = S::kTM, kTN = S::kTN, kKC = S::kKC;
  constexpr int kPad = STRIDE == 1 ? 1 : 0;  // top/left zero padding
  extern __shared__ __align__(16) unsigned char smem[];

  const int cin = c1 + c2;
  const int chunks = (cin + kKC - 1) / kKC;
  const int64_t ho = h / STRIDE, wo = wd / STRIDE;
  const int64_t img = blockIdx.z;
  const int64_t oy0 = (int64_t)(blockIdx.x / tiles_x) * S::kTH;
  const int64_t ox0 = (int64_t)(blockIdx.x % tiles_x) * S::kTW;
  const int cob = blockIdx.y * BN;
  const int64_t iy0 = oy0 * STRIDE - kPad, ix0 = ox0 * STRIDE - kPad;
  const float* xi = x + img * h * wd * c1;
  const float* x2i = c2 ? x2 + img * h * wd * c2 : x2;
  const int tid = threadIdx.x, lane = tid & 31, ty = tid >> 5;
  const int pg = lane / S::kNG, ng = lane % S::kNG;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  // copies (or gathers) channel chunk t into stage buffer buf
  auto fill = [&](int t, int buf) {
    unsigned char* base = smem + buf * S::kStageBytes;
    float4* a = reinterpret_cast<float4*>(base);
    const int c0 = t * kKC;
    for (int e = tid; e < S::kPH * S::kPW * KP; e += kFThreads) {
      const int kp = e % KP, pix = e / KP;
      const int pr = pix / S::kPW, pc = pix - pr * S::kPW;
      const int64_t iy = iy0 + pr, ix = ix0 + pc;
      const int c = c0 + kp * 4;
      float4* dst = a + (kp * S::kPH + pr) * S::kPWS + pc + pc / S::kSkew;
      if (iy < 0 || iy >= h || ix < 0 || ix >= wd || c >= cin) {
        *dst = zero;
        continue;
      }
      const int64_t p = iy * wd + ix;
      if (vec_x) {
        cp_async16(dst, c < c1 ? xi + p * c1 + c : x2i + p * c2 + (c - c1));
      } else {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cj = c + j;
          v[j] = cj >= cin ? 0.f : (cj < c1 ? xi[p * c1 + cj] : x2i[p * c2 + (cj - c1)]);
        }
        *dst = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    // weights [tap][k][BN] of HWIO [3][3][cin][cout]
    float* bs = reinterpret_cast<float*>(base + S::kAPieces * 16);
    for (int e = tid; e < 9 * kKC * (BN / 4); e += kFThreads) {
      const int col4 = e % (BN / 4), r = e / (BN / 4);
      const int k = r % kKC, tap = r / kKC;
      const int c = c0 + k, co = cob + col4 * 4;
      float4* dst = reinterpret_cast<float4*>(bs + r * BN + col4 * 4);
      if (c >= cin || co >= cout) {
        *dst = zero;
        continue;
      }
      const float* src = w + ((int64_t)tap * cin + c) * cout + co;
      if (vec_w) {
        cp_async16(dst, src);
      } else {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = co + j < cout ? src[j] : 0.f;
        *dst = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  };

  // this thread's first patch piece (row tap 0, column tap 0, piece 0): its
  // output row ty and its pixel group's first column pg * kSkew, skewed
  const int a_thr = ty * STRIDE * S::kPWS + pg * (S::kSkew + 1);
  // this thread's weight columns: quads ng and ng + kNG of the slab
  const int b_thr = ng * 4;

  float acc[kTM][kTN];
#pragma unroll
  for (int m = 0; m < kTM; ++m)
#pragma unroll
    for (int n = 0; n < kTN; ++n) acc[m][n] = 0.f;

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
    const float4* a = reinterpret_cast<const float4*>(base) + a_thr;
    const float* b = reinterpret_cast<const float*>(base + S::kAPieces * 16) + b_thr;
    // the kTN weights of (tap, channel k) for this thread
    auto weights = [&](int tap, int k, float (&wv)[kTN]) {
      const float* src = b + (tap * kKC + k) * BN;
#pragma unroll
      for (int q = 0; q < kTN / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(src + q * (S::kNG * 4));
        wv[4 * q] = v.x;
        wv[4 * q + 1] = v.y;
        wv[4 * q + 2] = v.z;
        wv[4 * q + 3] = v.w;
      }
    };
#pragma unroll 1
    for (int kp = 0; kp < KP; ++kp) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        // patch row ty * STRIDE + dy of piece kp; column j of the thread's
        // span lies at j + j / kSkew
        const float4* ar = a + (kp * S::kPH + dy) * S::kPWS;
        if constexpr (STRIDE == 1) {
          float4 p[kTM + 2];
#pragma unroll
          for (int j = 0; j < kTM + 2; ++j) p[j] = ar[j + j / S::kSkew];
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
#pragma unroll
            for (int ch = 0; ch < 4; ++ch) {
              float wv[kTN], v[kTM];
              weights(dy * 3 + dx, kp * 4 + ch, wv);
#pragma unroll
              for (int m = 0; m < kTM; ++m) v[m] = channel(p[m + dx], ch);
              outer(acc, v, wv);
            }
        } else {
          // output m reads column 2m + dx: the even columns serve dx 0
          // and 2, the odd ones dx 1
          float4 p[kTM + 1];
#pragma unroll
          for (int i = 0; i < kTM + 1; ++i) p[i] = ar[2 * i + 2 * i / S::kSkew];
#pragma unroll
          for (int dx = 0; dx < 3; dx += 2)
#pragma unroll
            for (int ch = 0; ch < 4; ++ch) {
              float wv[kTN], v[kTM];
              weights(dy * 3 + dx, kp * 4 + ch, wv);
#pragma unroll
              for (int m = 0; m < kTM; ++m) v[m] = channel(p[m + dx / 2], ch);
              outer(acc, v, wv);
            }
          float4 q[kTM];
#pragma unroll
          for (int i = 0; i < kTM; ++i) q[i] = ar[2 * i + 1];
#pragma unroll
          for (int ch = 0; ch < 4; ++ch) {
            float wv[kTN], v[kTM];
            weights(dy * 3 + 1, kp * 4 + ch, wv);
#pragma unroll
            for (int m = 0; m < kTM; ++m) v[m] = channel(q[m], ch);
            outer(acc, v, wv);
          }
        }
      }
    }
    __syncthreads();
  }

  // epilogue: f32 bias, ReLU; 16 bytes a thread and pixel per quad
  const int64_t oy = oy0 + ty;
  if (oy >= ho) return;
  const int64_t oxt = ox0 + pg * kTM;
  float* orow = out + (img * ho + oy) * wo * cout;
#pragma unroll
  for (int q = 0; q < kTN / 4; ++q) {
    const int col = cob + q * (S::kNG * 4) + b_thr;
    if (col >= cout) continue;
    float bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) bv[i] = col + i < cout ? bias[col + i] : 0.f;
#pragma unroll
    for (int m = 0; m < kTM; ++m) {
      if (oxt + m >= wo) break;
      float r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) r[i] = fmaxf(acc[m][4 * q + i] + bv[i], 0.f);
      float* dst = orow + (oxt + m) * cout + col;
      if (vec_o) {
        *reinterpret_cast<float4*>(dst) = make_float4(r[0], r[1], r[2], r[3]);
      } else {
        for (int i = 0; i < 4 && col + i < cout; ++i) dst[i] = r[i];
      }
    }
  }
}

template <int STRIDE, int BN, int KP>
cudaError_t launch_f32(const float* x, const float* x2, const float* w,
                       const float* bias, float* out, int64_t n, int64_t h,
                       int64_t wd, int c1, int c2, int cout, cudaStream_t stream) {
  using S = FShape<STRIDE, BN, KP>;
  const int chunks = (c1 + c2 + S::kKC - 1) / S::kKC;
  const int smem = (chunks > 1 ? 2 : 1) * S::kStageBytes;
  // above 48 KB of dynamic shared memory a kernel needs the opt-in
  const cudaError_t e = cudaFuncSetAttribute(
      simt_conv_kernel<STRIDE, BN, KP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  const int64_t ho = h / STRIDE, wo = wd / STRIDE;
  const int64_t tiles_x = (wo + S::kTW - 1) / S::kTW;
  const int64_t tiles = tiles_x * ((ho + S::kTH - 1) / S::kTH);
  const int64_t slabs = (cout + BN - 1) / BN;
  if (tiles > INT32_MAX || slabs > kMaxGridYZ) return cudaErrorInvalidValue;
  const int vec_x = c1 % 4 == 0 && c2 % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(x2) % 16 == 0;
  const int vec_w = cout % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int vec_o = cout % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  for (int64_t n0 = 0; n0 < n; n0 += kMaxGridYZ) {
    const int64_t nb = n - n0 < kMaxGridYZ ? n - n0 : kMaxGridYZ;
    dim3 grid((unsigned)tiles, (unsigned)slabs, (unsigned)nb);
    simt_conv_kernel<STRIDE, BN, KP><<<grid, kFThreads, smem, stream>>>(
        x + n0 * h * wd * c1, c2 ? x2 + n0 * h * wd * c2 : x2, w, bias,
        out + n0 * ho * wo * cout, h, wd, c1, c2, cout, tiles_x, vec_x, vec_w,
        vec_o);
  }
  return cudaGetLastError();
}

template <int STRIDE, int KP>
cudaError_t dispatch_f32_bn(const float* x, const float* x2, const float* w,
                            const float* b, float* out, int64_t n, int64_t h,
                            int64_t wd, int c1, int c2, int cout, cudaStream_t s) {
  if (cout <= 16)
    return launch_f32<STRIDE, 16, KP>(x, x2, w, b, out, n, h, wd, c1, c2, cout, s);
  if (cout <= 32)
    return launch_f32<STRIDE, 32, KP>(x, x2, w, b, out, n, h, wd, c1, c2, cout, s);
  return launch_f32<STRIDE, 64, KP>(x, x2, w, b, out, n, h, wd, c1, c2, cout, s);
}

// K1/K2 in f32; the choices are listed in the note at the head of the file
cudaError_t dispatch_f32(const void* x, const void* x2, const void* w,
                         const float* b, void* out, int64_t n, int64_t h,
                         int64_t wd, int c1, int c2, int cout, int stride,
                         cudaStream_t s) {
  const auto* xt = static_cast<const float*>(x);
  const auto* x2t = static_cast<const float*>(x2);
  const auto* wt = static_cast<const float*>(w);
  auto* ot = static_cast<float*>(out);
  if (stride == 2)
    return dispatch_f32_bn<2, 1>(xt, x2t, wt, b, ot, n, h, wd, c1, c2, cout, s);
  if (c1 + c2 <= 4)
    return dispatch_f32_bn<1, 1>(xt, x2t, wt, b, ot, n, h, wd, c1, c2, cout, s);
  return dispatch_f32_bn<1, 2>(xt, x2t, wt, b, ot, n, h, wd, c1, c2, cout, s);
}

// ---------------------------------------------------------------------------
// K3 in f32 and its requant mode
// ---------------------------------------------------------------------------

// K3: each thread owns one INPUT pixel and writes the four output pixels
// (2i+u, 2j+v) it feeds, for 16 output channels: out = x . w[1-u][1-v].
// REQUANT: x is int8 and is scaled by s_in (rounded to T) on the way into
// shared memory; ``bias`` is then the requant scale and ``offset`` its
// offset, and the output is int8.
template <typename T, bool REQUANT, int GROUPS>
__global__ void __launch_bounds__(kThreads)
up2x2_kernel(const void* __restrict__ xv, const float* __restrict__ s_in,
             const T* __restrict__ w, const float* __restrict__ bias,
             const float* __restrict__ offset, void* __restrict__ outv,
             int64_t npix, int64_t h, int64_t wd, int cin, int cout) {
  constexpr int kPix = kThreads / GROUPS;
  constexpr int kCob = kCpt * GROUPS;
  constexpr int kCk = 16;

  __shared__ float xs[kCk][kPix];
  __shared__ __align__(16) float ws[4][kCk][kCob];

  const int tid = threadIdx.x;
  const int pl = tid % kPix, g = tid / kPix;
  const int64_t p0 = (int64_t)blockIdx.x * kPix;
  const int cob = blockIdx.y * kCob;

  float acc[4][kCpt];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int j = 0; j < kCpt; ++j) acc[s][j] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += kCk) {
    for (int e = tid; e < kPix * kCk; e += kThreads) {
      const int ci = e % kCk, q = e / kCk;
      const int64_t pidx = p0 + q;
      const int c = c0 + ci;
      float v = 0.f;
      if (pidx < npix && c < cin) {
        if constexpr (REQUANT) {
          const int8_t xq = static_cast<const int8_t*>(xv)[pidx * cin + c];
          const float s = to_f32(from_f32<T>(s_in[c]));
          v = to_f32(from_f32<T>(__fmul_rn((float)xq, s)));
        } else {
          v = to_f32(static_cast<const T*>(xv)[pidx * cin + c]);
        }
      }
      xs[ci][q] = v;
    }
    // ws[s = 2u + v] holds the flipped tap w[1-u][1-v]
    for (int e = tid; e < 4 * kCk * kCob; e += kThreads) {
      const int col = e % kCob, r = e / kCob;
      const int ci = r % kCk, s = r / kCk;
      const int u = s >> 1, v = s & 1;
      const int c = c0 + ci, co = cob + col;
      const int tap = (1 - u) * 2 + (1 - v);
      ws[s][ci][col] =
          (c < cin && co < cout)
              ? to_f32(w[((int64_t)tap * cin + c) * cout + co])
              : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int ci = 0; ci < kCk; ++ci) {
      const float v = xs[ci][pl];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float* wr = &ws[s][ci][g * kCpt];
#pragma unroll
        for (int j = 0; j < kCpt; ++j) acc[s][j] = fmaf(v, wr[j], acc[s][j]);
      }
    }
    __syncthreads();
  }

  const int64_t pidx = p0 + pl;
  if (pidx >= npix) return;
  const int64_t jx = pidx % wd, t = pidx / wd;
  const int64_t iy = t % h, img = t / h;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int u = s >> 1, v = s & 1;
    const int64_t o =
        ((img * 2 * h + 2 * iy + u) * (2 * wd) + 2 * jx + v) * cout;
#pragma unroll
    for (int j = 0; j < kCpt; ++j) {
      const int co = cob + g * kCpt + j;
      if (co >= cout) continue;
      if constexpr (REQUANT) {
        const float r = to_f32(from_f32<T>(acc[s][j]));
        const float f = __fmaf_rn(r, bias[co], offset[co]);
        static_cast<int8_t*>(outv)[o + co] =
            (int8_t)__float2int_rz(fminf(fmaxf(f, 0.f), 127.f));
      } else {
        static_cast<T*>(outv)[o + co] =
            from_f32<T>(fmaxf(acc[s][j] + bias[co], 0.f));
      }
    }
  }
}

template <typename T, bool REQUANT>
void launch_up(const void* x, const float* s_in, const void* w,
               const float* bias, const float* offset, void* out, int64_t n,
               int64_t h, int64_t wd, int cin, int cout, cudaStream_t stream) {
  const int64_t npix = n * h * wd;
  const T* wt = static_cast<const T*>(w);
  if (cout > kCpt) {
    constexpr int kPix = kThreads / 2;
    dim3 grid((unsigned)((npix + kPix - 1) / kPix),
              (unsigned)((cout + 2 * kCpt - 1) / (2 * kCpt)), 1);
    up2x2_kernel<T, REQUANT, 2><<<grid, kThreads, 0, stream>>>(
        x, s_in, wt, bias, offset, out, npix, h, wd, cin, cout);
  } else {
    dim3 grid((unsigned)((npix + kThreads - 1) / kThreads), 1, 1);
    up2x2_kernel<T, REQUANT, 1><<<grid, kThreads, 0, stream>>>(
        x, s_in, wt, bias, offset, out, npix, h, wd, cin, cout);
  }
}


}  // namespace
}  // namespace annonet

extern "C" int annonet_conv3x3_bias_relu(const void* x, const void* x2,
                                         const void* w, const void* bias,
                                         void* out, int64_t n, int64_t h,
                                         int64_t wd, int c1, int c2, int cout,
                                         int stride, int bf16, void* stream) {
  using namespace annonet;
  cudaGetLastError();  // report this launch's error only
  if ((stride != 1 && stride != 2) || cout <= 0 || c1 <= 0 || c2 < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || h / stride == 0 || wd / stride == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  // bf16 on the tensor cores, f32 on the CUDA cores (see the notes)
  if (bf16)
    return (int)conv3x3_igemm_bf16(x, x2, w, b, out, n, h, wd, c1, c2, cout,
                                   stride, s);
  return (int)dispatch_f32(x, x2, w, b, out, n, h, wd, c1, c2, cout, stride, s);
}

extern "C" int annonet_up2x2_bias_relu(const void* x, const void* w,
                                       const void* bias, void* out, int64_t n,
                                       int64_t h, int64_t wd, int cin,
                                       int cout, int bf16, void* stream) {
  using namespace annonet;
  cudaGetLastError();
  if (cin <= 0 || cout <= 0) return (int)cudaErrorInvalidValue;
  if (n * h * wd == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  // bf16 on the tensor cores, f32 on the CUDA cores (see the notes)
  if (bf16)
    return (int)up2x2_igemm_bf16(x, nullptr, w, b, nullptr, out, n, h, wd, cin,
                                 cout, false, s);
  launch_up<float, false>(x, nullptr, w, b, nullptr, out, n, h, wd, cin, cout,
                          s);
  return (int)cudaGetLastError();
}

extern "C" int annonet_up2x2_requant(const void* x, const void* s_in,
                                     const void* w, const void* scale,
                                     const void* offset, void* out, int64_t n,
                                     int64_t h, int64_t wd, int cin, int cout,
                                     int bf16, void* stream) {
  using namespace annonet;
  cudaGetLastError();
  if (cin <= 0 || cout <= 0) return (int)cudaErrorInvalidValue;
  if (n * h * wd == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* si = static_cast<const float*>(s_in);
  const float* sc = static_cast<const float*>(scale);
  const float* of = static_cast<const float*>(offset);
  if (bf16)
    return (int)up2x2_igemm_bf16(x, si, w, sc, of, out, n, h, wd, cin, cout,
                                 true, s);
  launch_up<float, true>(x, si, w, sc, of, out, n, h, wd, cin, cout, s);
  return (int)cudaGetLastError();
}
