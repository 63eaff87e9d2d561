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
// K3 in f32 (up_gemm_f32_kernel) replaces fup_bias_relu
// (int8_conv_mosaic.py:485, pallas_call at :511), in both of its modes. It
// is a plain GEMM: A is the input as a row-major [N*H*W, cin] matrix (a run
// of NHWC pixels across all channels is one contiguous span), B the flipped
// weights as [cin, 4 taps x cout], C[p][(2u + v) * cout + co] the output
// out[img, 2i+u, 2j+v, co] of input pixel p = (img, i, j). M = input
// pixels, N = 4 cout, K = cin (32-128 in the flagship). Its bound on the
// same 25-tile batch (bytes = input + output + weights once; the same
// rates):
//
//   layer     x -> out                            GFLOP  GB     FLOP/B  bound ms  binds
//   dec3/up   [25,109,109,128] -> [25,218,218,64]  19.47  0.456   42.7     0.291  FMAs
//   dec2/up   [25,218,218,64] -> [25,436,436,32]   19.47  0.912   21.3     0.291  FMAs (bytes 0.272)
//   dec1/up   [25,436,436,32] -> [25,872,872,16]   19.47  1.825   10.7     0.545  bytes
//
// So dec3/up is bound by its FMAs, dec2/up sits on the card's 20 FLOP/B
// line, and dec1/up streams: two thirds of its bytes are the output.
//
// The design, against what held the direct convolution it replaces (one
// input pixel and 16 output channels of its four taps a thread; 10.4 ms a
// 25-tile forward on an H100 at 700 W):
//  1. Register tile. A thread owns kUTM = 8 pixels x 8 GEMM columns (64
//     f32 accumulators): one 4-channel quad of tap (0, v) and the same
//     quad of tap (1, v). For each 4-channel piece of K it loads its 8
//     pixels' pieces and the 4 channels' two weight quads, 16 16-byte
//     shared loads for 256 FMAs (the direct kernel: 17 for 64).
//  2. Staging. A tile's input is one contiguous span: copied by 16-byte
//     cp.async into [pixel][piece] rows of kc / 4 + 1 pieces (odd, so the
//     4 pixel groups of a warp, 1 row apart, fall in 4 distinct 16-byte
//     bank groups; the 8 lanes of a group read one piece as a broadcast,
//     and the 8 groups of a warp read 8 neighbouring weight quads). The
//     weights of the whole K stay in shared memory for every tile a block
//     runs (128 KB at dec3/up), copied once by cp.async; blocks are
//     persistent, and the next tile's input is copied while this tile is
//     computed (two buffers, one barrier a tile). Where the whole K does
//     not fit (above 96 to 176 input channels, by the slab and the mode),
//     K runs in chunks of 32 channels, input and weights double-buffered
//     together.
//     The requant mode stages the raw int8 bytes and scales them
//     (__fmul_rn by s_in) into the f32 chunk in one pass (one more
//     barrier).
//  3. Stores. Bias and ReLU (or the requant FMA, clip [0, 127] and
//     truncation) in registers, then 16-byte stores straight from them:
//     the 8 lanes of a pixel group write 8 neighbouring quads of one
//     output row, whole 128-byte lines, and the 4 groups of a warp 4
//     neighbouring input pixels, so at dec1/up one store of a warp is 512
//     contiguous bytes of output row 2i (or 2i + 1). The tile's layout
//     makes a pass through shared memory unnecessary.
//  4. One slab for cout <= 64 (BC = cout rounded up to 16, 32 or 64), so
//     dec3/up reads its input once; above 64 channels the slabs of 64 run
//     on grid.y (each slab reads the input again).
// On an H100 (700 W) dec3/up runs at 55-56% of the f32 peak, dec2/up at
// 48-50%, and dec1/up moves 2.5-2.6 TB/s, 76-79% of the HBM rate
// (tools/conv_f32_ab.py); 1.82-1.86 ms a 25-tile forward, 0.15x cuDNN's
// f32 conv_transpose2d.
// A tile is kBM consecutive input pixels in N*H*W order (256, 128 or 64 at
// BC 16, 32, 64): a segment of one or two input rows, whose four taps fill
// contiguous segments of output rows 2i and 2i + 1; no column is masked
// where a row ends.
//
// Choices (dispatch_up_f32), each covered by tests/test_torch_cuda.py:
//   BC      16 where cout <= 16, 32 where cout <= 32, else 64 (cout > 64 in
//           slabs of 64 over grid.y); two blocks an SM (128 registers) in
//           the float mode at BC 16 and 32, one (up to 167) at BC 64 and
//           in the requant mode, which spills at 128
//   K       whole (cin rounded up to 16), the weights resident, where the
//           weights and two input buffers fit in shared memory; else
//           chunks of 32 channels
//   paths   the input by cp.async where x is 16-byte aligned and cin % 4
//           == 0 (requant: cin % 16 == 0), else gathered element by
//           element; the weights by cp.async where cout % 4 == 0 and w is
//           aligned, else element by element; the output as 16-byte (int8:
//           4-byte) stores where cout % 4 == 0 and out is aligned, else
//           element by element
// Any N, H and W; 64-bit offsets (32-bit index division where N*H*W fits).
// Numerics: f32 sums by FMAs in any order, one f32 bias add, ReLU (none in
// annonet_up2x2_bias, the U-Net's linear up layer).
//
// K3 has a requant mode, the int8 net's default ``up`` layer
// (quantized_runtime.py:480-487): the int8 input times the per-channel
// scale s_in, rounded to the compute dtype, goes through the same
// transpose conv with f32 accumulation; the sum is rounded to the compute
// dtype (as XLA's bf16 conv output is) and requantized to int8 with one
// fused multiply-add, clip [0, 127] and truncation (see ops/qconv.py). In
// f32 both roundings are the identity, so the f32 requant mode differs
// from its plain version only by the order of the f32 sum.

#include "common.cuh"

namespace annonet {
namespace {

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
// K3 in f32 and its requant mode: a GEMM on the CUDA cores
// ---------------------------------------------------------------------------

// the f32 K3 block: kFWarps warps of 4 pixel groups x 8 column groups; a
// thread owns kUTM pixels of the tile (kPG apart) x 8 GEMM columns: one
// 4-channel quad of tap (u = 0, v) and the same quad of tap (1, v)
constexpr int kUTM = 8;
constexpr int kUChunk = 32;  // channels a chunk where the whole K does not fit

template <int BC>
struct UShape {
  static constexpr int kNS = 4 * BC;               // GEMM columns: 4 taps x BC channels
  static constexpr int kNG = kNS / 8;              // column groups, 8 columns each
  static constexpr int kWN = kNG / 8;              // warps along the columns
  static constexpr int kPG = 4 * (kFWarps / kWN);  // pixel groups
  static constexpr int kBM = kUTM * kPG;           // input pixels a tile: 256, 128, 64
  static_assert(kWN * kPG / 4 == kFWarps && kNG % 8 == 0, "block shape");
};

// the dynamic shared memory's carve-up, the same on the host (to size the
// launch) and on the device. kc channels a chunk (a multiple of 16); two
// stage buffers, each the chunk's input (f32 pieces, or in the requant
// mode its raw int8 bytes) and, where K takes several chunks, its weights
struct USmem {
  int pitch;                   // 16-byte pieces of a staged pixel: kc / 4 + 1, odd
  int a_buf, raw_buf, b_buf;   // bytes of an f32 input chunk, a raw one, a weight chunk
  int stage;                   // bytes of one stage buffer
  int off_a;                   // requant: the one f32 input chunk, converted
  int off_b;                   // one chunk: the resident weights of the whole K
  int total;
};

__host__ __device__ inline USmem up_carve(int bm, int ns, int kc, int chunks, bool requant) {
  USmem s;
  s.pitch = kc / 4 + 1;
  s.a_buf = bm * s.pitch * 16;
  s.raw_buf = requant ? bm * kc : 0;
  s.b_buf = kc * ns * 4;
  s.stage = (requant ? s.raw_buf : s.a_buf) + (chunks > 1 ? s.b_buf : 0);
  s.off_a = 2 * s.stage;
  s.off_b = s.off_a + (requant ? s.a_buf : 0);
  s.total = s.off_b + (chunks > 1 ? 0 : s.b_buf);
  return s;
}

// C[p][s * BC + j] = sum_c A[p][c] * B[c][s * BC + j], with A the input as
// [N*H*W, cin], B[c][(2u + v) * BC + j] = w[1-u][1-v][c][cob + j] and cob =
// blockIdx.y * BC; out[img, 2i+u, 2j'+v, cob + j] = relu(C + bias) for
// input pixel p = (img, i, j') (C + bias where relu is 0: the U-Net's
// linear up layer). REQUANT: x is int8 and is scaled by s_in (__fmul_rn)
// after staging; e0 is then the requant scale, e1 its offset, and the
// output int8. Else e0 is the bias.
// Blocks an SM is to hold: two (128 registers a thread) in the float mode
// at BC 16 and 32; one at BC 64, which stages the whole K of its 256
// columns (128 KB at dec3/up's 128 channels), and in the requant mode,
// whose conversion pass would spill at 128 registers.
template <bool REQUANT, int BC>
__global__ void __launch_bounds__(kFThreads, REQUANT || BC == 64 ? 1 : 2)
up_gemm_f32_kernel(const void* __restrict__ xv, const float* __restrict__ s_in,
                   const float* __restrict__ w, const float* __restrict__ e0,
                   const float* __restrict__ e1, void* __restrict__ outv, int64_t npix,
                   int64_t wd, int cin, int cout, int kc, int chunks, int vec_x,
                   int vec_w, int vec_o, int relu) {
  using S = UShape<BC>;
  constexpr int kNS = S::kNS, kBM = S::kBM, kPG = S::kPG;
  extern __shared__ __align__(16) unsigned char smem[];
  const USmem L = up_carve(kBM, kNS, kc, chunks, REQUANT);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ng = (warp % S::kWN) * 8 + (lane & 7);   // column group
  const int pg = (warp / S::kWN) * 4 + (lane >> 3);  // pixel group
  const int cob = blockIdx.y * BC;
  const int tiles = (int)((npix + kBM - 1) / kBM);
  if ((int)blockIdx.x >= tiles) return;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  auto stage_base = [&](int buf) { return smem + buf * L.stage; };
  auto b_of = [&](int buf) {
    return reinterpret_cast<float*>(
        chunks > 1 ? stage_base(buf) + (REQUANT ? L.raw_buf : L.a_buf) : smem + L.off_b);
  };
  auto tile_rows = [&](int t) {
    const int64_t left = npix - (int64_t)t * kBM;
    return left < kBM ? (int)left : kBM;
  };
  // the 4-channel pieces of chunk c0 that hold channels below cin
  auto chunk_pieces = [&](int c0) {
    const int left = cin - c0;
    return ((left < kc ? left : kc) + 3) / 4;
  };

  // copies (or gathers) chunk c0 of tile t into stage buffer buf: the input
  // of the tile's pixels, then the weights of the chunk (once, for the
  // whole K, where K is one chunk)
  auto fill = [&](int t, int c0, int buf, bool weights) {
    const int64_t p0 = (int64_t)t * kBM;
    const int rows = tile_rows(t);
    const int np = chunk_pieces(c0);
    unsigned char* base = stage_base(buf);
    if constexpr (REQUANT) {
      const int8_t* x = static_cast<const int8_t*>(xv) + p0 * cin + c0;
      int8_t* raw = reinterpret_cast<int8_t*>(base);
      if (vec_x) {  // cin % 16 == 0: whole 16-byte pieces
        const int n16 = (np + 3) / 4;
        for (int e = tid; e < rows * n16; e += kFThreads) {
          const int p = e / n16, c = e - p * n16;
          cp_async16(raw + p * kc + 16 * c, x + (int64_t)p * cin + 16 * c);
        }
      } else {
        const int nc = cin - c0 < kc ? cin - c0 : kc;
        for (int e = tid; e < rows * nc; e += kFThreads) {
          const int p = e / nc, c = e - p * nc;
          raw[p * kc + c] = x[(int64_t)p * cin + c];
        }
      }
    } else {
      const float* x = static_cast<const float*>(xv) + p0 * cin + c0;
      float4* a = reinterpret_cast<float4*>(base);
      for (int e = tid; e < rows * np; e += kFThreads) {
        const int p = e / np, c = e - p * np;
        float4* dst = a + p * L.pitch + c;
        const float* src = x + (int64_t)p * cin + 4 * c;
        if (vec_x) {
          cp_async16(dst, src);
        } else {
          float v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) v[j] = c0 + 4 * c + j < cin ? src[j] : 0.f;
          *dst = make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    }
    if (!weights) return;
    // rows k < 4 np of B; BC quads a row, co fastest
    float* b = b_of(buf);
    for (int e = tid; e < 4 * np * BC; e += kFThreads) {
      const int k = e / BC, n = 4 * (e % BC);
      const int s = n / BC, co = cob + n % BC, c = c0 + k;
      float4* dst = reinterpret_cast<float4*>(b + k * kNS + n);
      if (c >= cin || co >= cout) {
        *dst = zero;
        continue;
      }
      const float* src = w + ((int64_t)(3 - s) * cin + c) * cout + co;  // tap (1-u, 1-v)
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

  // requant: the raw int8 chunk of stage buffer buf times s_in, into the
  // f32 chunk that every warp reads
  auto convert = [&](int buf, int c0, int rows) {
    const int8_t* raw = reinterpret_cast<const int8_t*>(stage_base(buf));
    float4* a = reinterpret_cast<float4*>(smem + L.off_a);
    const int np = chunk_pieces(c0);
    for (int e = tid; e < rows * np; e += kFThreads) {
      const int p = e / np, c = e - p * np, ch = c0 + 4 * c;
      const char4 q = *reinterpret_cast<const char4*>(raw + p * kc + 4 * c);
      const float xq[4] = {(float)q.x, (float)q.y, (float)q.z, (float)q.w};
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = ch + j < cin ? __fmul_rn(xq[j], __ldg(s_in + ch + j)) : 0.f;
      a[p * L.pitch + c] = make_float4(v[0], v[1], v[2], v[3]);
    }
  };

  float acc[kUTM][8];

  // acc += this chunk's products: the thread's pixels are rows pg + m * kPG
  // of the staged input, its columns quads ng (tap u = 0) and ng + kNG
  // (u = 1) of B; each 4-channel piece is 8 16-byte loads of A and 8 of B
  // for 256 FMAs
  auto compute = [&](const float4* a, const float* b, int np) {
    const float4* ap = a + pg * L.pitch;
    const int mstride = kPG * L.pitch;
    const float* bq = b + 4 * ng;
#pragma unroll 1
    for (int kp = 0; kp < np; ++kp) {
      float4 av[kUTM];
#pragma unroll
      for (int m = 0; m < kUTM; ++m) av[m] = ap[m * mstride + kp];
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        const float* br = bq + (4 * kp + ch) * kNS;
        const float4 b0 = *reinterpret_cast<const float4*>(br);
        const float4 b1 = *reinterpret_cast<const float4*>(br + kNS / 2);
        const float wv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        float v[kUTM];
#pragma unroll
        for (int m = 0; m < kUTM; ++m) v[m] = channel(av[m], ch);
        outer(acc, v, wv);
      }
    }
  };

  // bias + ReLU (or the requant FMA, clip and truncation) in registers, and
  // 16-byte stores (4 bytes in int8): the 8 lanes of a pixel group write
  // 8 neighbouring quads of one output row, the 4 groups of a warp 4
  // neighbouring input pixels
  auto epilogue = [&](int t) {
    const int n = 4 * ng;
    const int v = n / BC, co = cob + n % BC;  // quad a's tap (0, v); quad b's (1, v)
    if (co >= cout) return;
    float k0[4], k1[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      k0[j] = co + j < cout ? __ldg(e0 + co + j) : 0.f;
      k1[j] = REQUANT && co + j < cout ? __ldg(e1 + co + j) : 0.f;
    }
    // the pixel of m = 0: flat input row r (img * h + i, whose output rows
    // are 2r and 2r + 1) and column j
    int64_t q = (int64_t)t * kBM + pg, r, jx;
    if (npix <= INT32_MAX) {
      const uint32_t rr = (uint32_t)q / (uint32_t)wd;
      r = rr, jx = (uint32_t)q - rr * (uint32_t)wd;
    } else {
      r = q / wd, jx = q - r * wd;
    }
    const int64_t urow = 2 * wd * cout;  // output row 2i + 1 is + urow
#pragma unroll
    for (int m = 0; m < kUTM; ++m) {
      if (q >= npix) break;
      const int64_t o = (2 * r * 2 * wd + 2 * jx) * cout + v * cout + co;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float* c = &acc[m][4 * u];
        if constexpr (REQUANT) {
          int8_t y[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            y[j] = (int8_t)__float2int_rz(fminf(fmaxf(__fmaf_rn(c[j], k0[j], k1[j]), 0.f), 127.f));
          int8_t* dst = static_cast<int8_t*>(outv) + o + u * urow;
          if (vec_o) {
            *reinterpret_cast<char4*>(dst) = make_char4(y[0], y[1], y[2], y[3]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (co + j < cout) dst[j] = y[j];
          }
        } else {
          float y[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) y[j] = relu ? fmaxf(c[j] + k0[j], 0.f) : c[j] + k0[j];
          float* dst = static_cast<float*>(outv) + o + u * urow;
          if (vec_o) {
            *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (co + j < cout) dst[j] = y[j];
          }
        }
      }
      q += kPG;
      jx += kPG;
      while (jx >= wd) jx -= wd, ++r;
    }
  };

  // stages run over (tile, chunk), the block's tiles gridDim.x apart, each
  // tile's chunks in turn. Two stage buffers: the next stage is copied
  // while this one is computed. One block barrier a stage (two in the
  // requant mode): after it, this stage has landed for every thread and
  // every warp is done with the last one, whose buffer the next copy takes.
  int t = blockIdx.x, c = 0, buf = 0;
  fill(t, 0, 0, true);
  cp_async_commit();
  for (;;) {
    cp_async_wait<0>();
    __syncthreads();
    const int cn = c + 1 == chunks ? 0 : c + 1;
    const int tn = cn == 0 ? t + (int)gridDim.x : t;
    const bool more = tn < tiles;
    if (more) fill(tn, cn * kc, buf ^ 1, chunks > 1);
    cp_async_commit();
    const int c0 = c * kc;
    const float4* a = reinterpret_cast<const float4*>(stage_base(buf));
    if constexpr (REQUANT) {
      convert(buf, c0, tile_rows(t));
      __syncthreads();
      a = reinterpret_cast<const float4*>(smem + L.off_a);
    }
    if (c == 0) {
#pragma unroll
      for (int m = 0; m < kUTM; ++m)
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[m][n] = 0.f;
    }
    compute(a, b_of(buf), chunk_pieces(c0));
    if (c == chunks - 1) epilogue(t);
    if (!more) break;
    t = tn;
    c = cn;
    buf ^= 1;
  }
}

template <bool REQUANT, int BC>
cudaError_t launch_up_f32(const void* x, const float* s_in, const float* w,
                          const float* e0, const float* e1, void* out, int64_t npix,
                          int64_t wd, int cin, int cout, int relu, cudaStream_t stream) {
  using S = UShape<BC>;
  int dev = 0, max_smem = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  // the whole K (and its weights, resident) where it fits, else chunks
  int kc = (cin + 15) / 16 * 16, chunks = 1;
  if (up_carve(S::kBM, S::kNS, kc, 1, REQUANT).total > max_smem) {
    kc = kUChunk;
    chunks = (cin + kc - 1) / kc;
  }
  const int smem = up_carve(S::kBM, S::kNS, kc, chunks, REQUANT).total;
  const auto kernel = up_gemm_f32_kernel<REQUANT, BC>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kFThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t slabs = (cout + BC - 1) / BC;
  // persistent blocks, all resident at once, over the tiles
  const int64_t tiles = (npix + S::kBM - 1) / S::kBM;
  if (slabs > kMaxGridYZ || tiles * chunks > INT32_MAX) return cudaErrorInvalidValue;
  int64_t blocks = (int64_t)per_sm * sms / slabs;
  if (blocks < 1) blocks = 1;
  if (blocks > tiles) blocks = tiles;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  const int vec_x = xa % 16 == 0 && cin % (REQUANT ? 16 : 4) == 0;
  const int vec_w = reinterpret_cast<uintptr_t>(w) % 16 == 0 && cout % 4 == 0;
  const int vec_o = oa % (REQUANT ? 4 : 16) == 0 && cout % 4 == 0;
  kernel<<<dim3((unsigned)blocks, (unsigned)slabs, 1), kFThreads, smem, stream>>>(
      x, s_in, w, e0, e1, out, npix, wd, cin, cout, kc, chunks, vec_x, vec_w, vec_o, relu);
  return cudaGetLastError();
}

// K3 in f32, both modes (relu: the float mode's ReLU, or none); the
// choices are listed in the note at the head of the file
cudaError_t dispatch_up_f32(const void* x, const float* s_in, const void* w,
                            const float* e0, const float* e1, void* out, int64_t n,
                            int64_t h, int64_t wd, int cin, int cout, bool requant,
                            int relu, cudaStream_t s) {
  const auto* wt = static_cast<const float*>(w);
  const int64_t npix = n * h * wd;
  const int r = relu;
  if (cout <= 16)
    return requant
               ? launch_up_f32<true, 16>(x, s_in, wt, e0, e1, out, npix, wd, cin, cout, r, s)
               : launch_up_f32<false, 16>(x, s_in, wt, e0, e1, out, npix, wd, cin, cout, r, s);
  if (cout <= 32)
    return requant
               ? launch_up_f32<true, 32>(x, s_in, wt, e0, e1, out, npix, wd, cin, cout, r, s)
               : launch_up_f32<false, 32>(x, s_in, wt, e0, e1, out, npix, wd, cin, cout, r, s);
  return requant ? launch_up_f32<true, 64>(x, s_in, wt, e0, e1, out, npix, wd, cin, cout, r, s)
                 : launch_up_f32<false, 64>(x, s_in, wt, e0, e1, out, npix, wd, cin, cout, r, s);
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

namespace {

// K3's float mode, with or without its ReLU
int up2x2_float(const void* x, const void* w, const void* bias, void* out, int64_t n,
                int64_t h, int64_t wd, int cin, int cout, int bf16, int relu,
                void* stream) {
  using namespace annonet;
  cudaGetLastError();
  if (cin <= 0 || cout <= 0) return (int)cudaErrorInvalidValue;
  if (n * h * wd == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  // bf16 on the tensor cores, f32 on the CUDA cores (see the notes)
  if (bf16)
    return (int)up2x2_igemm_bf16(x, nullptr, w, b, nullptr, out, n, h, wd, cin,
                                 cout, false, relu, s);
  return (int)dispatch_up_f32(x, nullptr, w, b, nullptr, out, n, h, wd, cin, cout,
                              false, relu, s);
}

}  // namespace

extern "C" int annonet_up2x2_bias_relu(const void* x, const void* w,
                                       const void* bias, void* out, int64_t n,
                                       int64_t h, int64_t wd, int cin,
                                       int cout, int bf16, void* stream) {
  return up2x2_float(x, w, bias, out, n, h, wd, cin, cout, bf16, 1, stream);
}

// K3 without the ReLU: the U-Net's linear up layer
extern "C" int annonet_up2x2_bias(const void* x, const void* w, const void* bias,
                                  void* out, int64_t n, int64_t h, int64_t wd,
                                  int cin, int cout, int bf16, void* stream) {
  return up2x2_float(x, w, bias, out, n, h, wd, cin, cout, bf16, 0, stream);
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
                                 true, 0, s);
  return (int)dispatch_up_f32(x, si, w, sc, of, out, n, h, wd, cin, cout, true, 0, s);
}
