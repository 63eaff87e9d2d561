// Q3: the int8 2x2 stride-2 transpose conv + requant of the quantized
// segmentation net, which runs under quantize_up only.
//
// Replaces the Pallas TPU kernel of annonet_tpu/ops/int8_conv_mosaic.py
//   Q3 qup_requant (:294)  2x2 stride-2 transpose conv
// and the XLA int8 transpose conv the default JAX path runs in its place
// (models/quantized_runtime.py apply_folded_int8). The TPU kernel works on
// the width-folded layout (8 pixels x 16 channels in 128 lanes) as tap
// GEMMs; this one runs the plain NHWC geometry. Q1 (stride 1), its
// accumulator mode and Q2 (stride 2) run on the int8 tensor cores
// (qconv_igemm.cu); Q3 is the one kernel left on __dp4a.
//
// The layer function is requant(conv_int32(x, w_q)):
//   q = int8(clip(fma(float(acc), scale[co], offset[co]), 0, 127))
// with ReLU folded into the clip and the round-half-up carried by the +0.5
// inside offset (quantized_runtime.py:381-388), so the float -> int8 step
// truncates (__float2int_rz). The multiply-add is one fused, singly
// rounded __fmaf_rn: XLA contracts the same expression into an FMA on the
// CPU, and the plain PyTorch versions emulate that FMA exactly.
//
// What bounds it on an H100: int8 activations halve the bytes of the bf16
// net, and the layer's 2*4*cin MACs per input pixel and output channel are
// far under the int8 tensor cores' ridge, so with tensor cores it would be
// bound by bytes. This is a direct computation on the CUDA cores with
// __dp4a (four int8 products and an int32 add per instruction): its bound
// is the instruction rate, dp4a and the shared-memory loads that feed it,
// and its time follows the layer's MACs. It keeps the bytes low: each
// input element is read once per block into shared memory as 4-channel
// words, the weights of a channel chunk are packed into words once per
// block, and each thread keeps 16 output channels of the four output
// pixels of one input pixel in int32 registers. Moving it to the int8
// tensor cores, as Q1 and Q2, is later work.
//
// Offsets are 64-bit: a 25-tile batch of 872^2 at 16 channels is 3.0e8
// elements, and the deeper layers' products of batch, pixels and channels
// come near 2^31.

#include "common.cuh"

namespace annonet {
namespace {

constexpr int kThreads = 256;
constexpr int kCpt = 16;  // output channels per thread

// Channel word cw of pixel ``pix`` of x (cin channels): channels
// 4cw..4cw+3 packed little-endian (byte j = channel 4cw+j), zero past the
// last channel. ``words`` says x holds whole 4-byte aligned words (cin a
// multiple of 4), so one load serves.
__device__ __forceinline__ int32_t load_word(const int8_t* __restrict__ x,
                                             int64_t pix, int cin, int cw,
                                             bool words) {
  const int c = 4 * cw;
  if (words) return *reinterpret_cast<const int32_t*>(x + pix * cin + c);
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (c + j < cin) v |= (uint32_t)(uint8_t)x[pix * cin + c + j] << (8 * j);
  return (int32_t)v;
}

// The HWIO int8 weights of input channels 4cw..4cw+3 at one tap and output
// channel, packed like load_word's activations.
__device__ __forceinline__ int32_t weight_word(const int8_t* __restrict__ w,
                                               int tap, int cw, int co,
                                               int cin, int cout) {
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = 4 * cw + j;
    if (c < cin)
      v |= (uint32_t)(uint8_t)w[((int64_t)tap * cin + c) * cout + co]
           << (8 * j);
  }
  return (int32_t)v;
}

__device__ __forceinline__ int8_t requant(int32_t acc, float scale,
                                          float offset) {
  const float f = __fmaf_rn(__int2float_rn(acc), scale, offset);
  return (int8_t)__float2int_rz(fminf(fmaxf(f, 0.f), 127.f));
}

// 16 consecutive output channels of one pixel: one 16-byte store when the
// slab is whole and aligned, bytes otherwise.
__device__ __forceinline__ void store16(int8_t* o, int co0, int cout,
                                        const int8_t (&q)[kCpt]) {
  if (co0 + kCpt <= cout && (cout % kCpt) == 0) {
    int4 v;
    int32_t* vw = reinterpret_cast<int32_t*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      vw[k] = (int32_t)((uint32_t)(uint8_t)q[4 * k] |
                        (uint32_t)(uint8_t)q[4 * k + 1] << 8 |
                        (uint32_t)(uint8_t)q[4 * k + 2] << 16 |
                        (uint32_t)(uint8_t)q[4 * k + 3] << 24);
    *reinterpret_cast<int4*>(o + co0) = v;
    return;
  }
#pragma unroll
  for (int j = 0; j < kCpt; ++j)
    if (co0 + j < cout) o[co0 + j] = q[j];
}

// Q3: each thread owns one INPUT pixel and writes the four output pixels
// (2i+u, 2j+v) it feeds, for 16 output channels:
// out = requant(x . w_q[1-u][1-v]) with scale and offset [2][cout] indexed
// by the output column's parity v (the int8 up's weight scales are per
// (v, channel): quantized.py quantize_up_layer).
template <int GROUPS>
__global__ void __launch_bounds__(kThreads)
qup2x2_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
              const float* __restrict__ scale, const float* __restrict__ offset,
              int8_t* __restrict__ out, int64_t npix, int64_t h, int64_t wd,
              int cin, int cout, bool words) {
  constexpr int kPix = kThreads / GROUPS;
  constexpr int kCob = kCpt * GROUPS;
  constexpr int kWk = 8;

  __shared__ int32_t xs[kWk][kPix];
  __shared__ __align__(16) int32_t ws[4][kWk][kCob];

  const int cinw = (cin + 3) / 4;
  const int tid = threadIdx.x;
  const int pl = tid % kPix, g = tid / kPix;
  const int64_t p0 = (int64_t)blockIdx.x * kPix;
  const int cob = blockIdx.y * kCob;

  int32_t acc[4][kCpt];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int j = 0; j < kCpt; ++j) acc[s][j] = 0;

  for (int w0 = 0; w0 < cinw; w0 += kWk) {
    for (int e = tid; e < kPix * kWk; e += kThreads) {
      const int wi = e % kWk, q = e / kWk;
      const int64_t pidx = p0 + q;
      const int cw = w0 + wi;
      xs[wi][q] = (pidx < npix && cw < cinw)
                      ? load_word(x, pidx, cin, cw, words)
                      : 0;
    }
    // ws[s = 2u + v] holds the flipped tap w_q[1-u][1-v]
    for (int e = tid; e < 4 * kWk * kCob; e += kThreads) {
      const int col = e % kCob, r = e / kCob;
      const int wi = r % kWk, s = r / kWk;
      const int u = s >> 1, v = s & 1;
      const int cw = w0 + wi, co = cob + col;
      ws[s][wi][col] = (cw < cinw && co < cout)
                           ? weight_word(w, (1 - u) * 2 + (1 - v), cw, co,
                                         cin, cout)
                           : 0;
    }
    __syncthreads();
#pragma unroll 2
    for (int wi = 0; wi < kWk; ++wi) {
      const int32_t v = xs[wi][pl];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int4* wr = reinterpret_cast<const int4*>(&ws[s][wi][g * kCpt]);
#pragma unroll
        for (int k = 0; k < kCpt / 4; ++k) {
          const int4 ww = wr[k];
          acc[s][4 * k] = __dp4a(v, ww.x, acc[s][4 * k]);
          acc[s][4 * k + 1] = __dp4a(v, ww.y, acc[s][4 * k + 1]);
          acc[s][4 * k + 2] = __dp4a(v, ww.z, acc[s][4 * k + 2]);
          acc[s][4 * k + 3] = __dp4a(v, ww.w, acc[s][4 * k + 3]);
        }
      }
    }
    __syncthreads();
  }

  const int64_t pidx = p0 + pl;
  if (pidx >= npix) return;
  const int64_t jx = pidx % wd, t = pidx / wd;
  const int64_t iy = t % h, img = t / h;
  const int co0 = cob + g * kCpt;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int u = s >> 1, v = s & 1;
    int8_t q[kCpt];
#pragma unroll
    for (int j = 0; j < kCpt; ++j) {
      const int co = co0 + j < cout ? co0 + j : cout - 1;
      q[j] = requant(acc[s][j], scale[v * cout + co], offset[v * cout + co]);
    }
    store16(out + ((img * 2 * h + 2 * iy + u) * (2 * wd) + 2 * jx + v) * cout,
            co0, cout, q);
  }
}

}  // namespace
}  // namespace annonet

extern "C" int annonet_qup2x2_requant(const void* x, const void* w,
                                      const void* scale, const void* offset,
                                      void* out, int64_t n, int64_t h,
                                      int64_t wd, int cin, int cout, int words,
                                      void* stream) {
  using namespace annonet;
  cudaGetLastError();
  if (cin <= 0 || cout <= 0) return (int)cudaErrorInvalidValue;
  const int64_t npix = n * h * wd;
  if (npix == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xt = static_cast<const int8_t*>(x);
  const int8_t* wt = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  const float* of = static_cast<const float*>(offset);
  int8_t* ot = static_cast<int8_t*>(out);
  if (cout > kCpt) {
    constexpr int kPix = kThreads / 2;
    dim3 grid((unsigned)((npix + kPix - 1) / kPix),
              (unsigned)((cout + 2 * kCpt - 1) / (2 * kCpt)), 1);
    qup2x2_kernel<2><<<grid, kThreads, 0, s>>>(xt, wt, sc, of, ot, npix, h, wd,
                                               cin, cout, words != 0);
  } else {
    dim3 grid((unsigned)((npix + kThreads - 1) / kThreads), 1, 1);
    qup2x2_kernel<1><<<grid, kThreads, 0, s>>>(xt, wt, sc, of, ot, npix, h, wd,
                                               cin, cout, words != 0);
  }
  return (int)cudaGetLastError();
}
