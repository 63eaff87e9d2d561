// Fused conv + bias + ReLU kernels of the runtime segmentation net (K1-K3).
// In bf16 they run on the tensor cores (K1 and K2 in conv_igemm.cu, K3 and
// its requant mode in up_igemm.cu); here are their f32 versions.
//
// Replaces the Pallas TPU kernels of annonet_tpu/ops/int8_conv_mosaic.py
//   K1 fconv3x3_s1_bias_relu (:359)  3x3 stride 1, zero padding (1, 1)
//   K2 fconv3x3_s2_bias_relu (:426)  3x3 stride 2, zero padding (0, 1)
//   K3 fup_bias_relu         (:485)  2x2 stride-2 transpose conv, and its
//                                    requant mode (the int8 net's up)
// and the XLA convs the default JAX path runs in their place
// (models/segnet.py _conv / _conv_transpose). The TPU kernels work on a
// width-folded layout that packs 8 pixels into the 128 MXU lanes and pays
// 8x redundant FLOPs for it; these kernels run the plain NHWC geometry.
//
// K1/K2 in f32 (the f32 configs, which check the arithmetic to 1e-4) are
// direct convolution on the CUDA cores (f32 FMA, roof 67 TFLOP/s): TF32
// tensor cores keep 10 mantissa bits and would break that contract. Their
// bound is instruction issue (FMAs and the shared-memory loads that feed
// them), so their time follows the layer's FLOPs. Each input element is
// read once per block from device memory into a shared-memory patch (halo
// included), weights for a channel chunk are staged once per block, and
// each thread keeps 16 output channels of one pixel in f32 registers. f32
// K3 is direct convolution too.
//
// Numerics: f32 accumulation, + f32 bias, ReLU, one rounding to the output
// dtype. Offsets are 64-bit (a 25-tile batch of 896^2 at 32 channels is
// close to 2^31 elements).
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

constexpr int kThreads = 256;
constexpr int kTileW = 32;  // output columns per block: one warp per row
constexpr int kCpt = 16;    // output channels per thread

// groups: output-channel groups of kCpt per block (1 when cout <= 16, so
// no thread idles on the 16-channel full-resolution layers). The block
// covers (8 / groups) x 32 output pixels x (16 * groups) channels.
template <int STRIDE, int GROUPS>
__global__ void __launch_bounds__(kThreads)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ x2,
                   const float* __restrict__ w, const float* __restrict__ bias,
                   float* __restrict__ out, int64_t h, int64_t wd, int c1,
                   int c2, int cout, int64_t tiles_x) {
  constexpr int kTileH = 8 / GROUPS;
  constexpr int kTilePix = kTileH * kTileW;
  constexpr int kCob = kCpt * GROUPS;
  constexpr int kCk = STRIDE == 1 ? 16 : 8;  // input channels per chunk
  constexpr int kPh = (kTileH - 1) * STRIDE + 3;
  constexpr int kPw = (kTileW - 1) * STRIDE + 3;
  constexpr int kPad = STRIDE == 1 ? 1 : 0;  // top/left zero padding
  static_assert(kTilePix * GROUPS == kThreads, "block shape");

  __shared__ float patch[kCk][kPh][kPw];
  __shared__ __align__(16) float wsh[9][kCk][kCob];

  const int cin = c1 + c2;
  const int64_t ho = h / STRIDE, wo = wd / STRIDE;
  const int64_t img = blockIdx.z;
  const int64_t oy0 = (blockIdx.x / tiles_x) * kTileH;
  const int64_t ox0 = (blockIdx.x % tiles_x) * kTileW;
  const int cob = blockIdx.y * kCob;
  const int tid = threadIdx.x;
  const int p = tid % kTilePix, g = tid / kTilePix;
  const int ty = p / kTileW, tx = p % kTileW;
  const int64_t iy0 = oy0 * STRIDE - kPad, ix0 = ox0 * STRIDE - kPad;

  float acc[kCpt];
#pragma unroll
  for (int j = 0; j < kCpt; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += kCk) {
    // input patch, channel fastest in the loop for coalesced NHWC reads;
    // zero outside the image (the padding) and past the last channel
    for (int e = tid; e < kPh * kPw * kCk; e += kThreads) {
      const int ci = e % kCk, pp = e / kCk;
      const int py = pp / kPw, px = pp % kPw;
      const int64_t iy = iy0 + py, ix = ix0 + px;
      const int c = c0 + ci;
      float v = 0.f;
      if (iy >= 0 && iy < h && ix >= 0 && ix < wd && c < cin) {
        const int64_t pix = (img * h + iy) * wd + ix;
        v = c < c1 ? x[pix * c1 + c] : x2[pix * c2 + (c - c1)];
      }
      patch[ci][py][px] = v;
    }
    // weights [tap][ci][cout slab] from HWIO [3][3][cin][cout]
    for (int e = tid; e < 9 * kCk * kCob; e += kThreads) {
      const int col = e % kCob, r = e / kCob;
      const int ci = r % kCk, tap = r / kCk;
      const int c = c0 + ci, co = cob + col;
      wsh[tap][ci][col] =
          (c < cin && co < cout) ? w[((int64_t)tap * cin + c) * cout + co] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int ci = 0; ci < kCk; ++ci) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float v = patch[ci][ty * STRIDE + dy][tx * STRIDE + dx];
          const float* wr = &wsh[dy * 3 + dx][ci][g * kCpt];
#pragma unroll
          for (int j = 0; j < kCpt; ++j) acc[j] = fmaf(v, wr[j], acc[j]);
        }
      }
    }
    __syncthreads();
  }

  const int64_t oy = oy0 + ty, ox = ox0 + tx;
  if (oy < ho && ox < wo) {
    float* o = out + ((img * ho + oy) * wo + ox) * cout;
#pragma unroll
    for (int j = 0; j < kCpt; ++j) {
      const int co = cob + g * kCpt + j;
      if (co < cout) o[co] = fmaxf(acc[j] + bias[co], 0.f);
    }
  }
}

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

template <int STRIDE, int GROUPS>
void launch_conv(const float* x, const float* x2, const float* w,
                 const float* bias, float* out, int64_t n, int64_t h,
                 int64_t wd, int c1, int c2, int cout, cudaStream_t stream) {
  constexpr int kTileH = 8 / GROUPS;
  const int64_t ho = h / STRIDE, wo = wd / STRIDE;
  const int64_t tiles_x = (wo + kTileW - 1) / kTileW;
  const int64_t tiles_y = (ho + kTileH - 1) / kTileH;
  const int64_t slabs = (cout + kCpt * GROUPS - 1) / (kCpt * GROUPS);
  for (int64_t n0 = 0; n0 < n; n0 += kMaxGridYZ) {
    const int64_t nb = n - n0 < kMaxGridYZ ? n - n0 : kMaxGridYZ;
    dim3 grid((unsigned)(tiles_x * tiles_y), (unsigned)slabs, (unsigned)nb);
    conv3x3_f32_kernel<STRIDE, GROUPS><<<grid, kThreads, 0, stream>>>(
        x + n0 * h * wd * c1, x2 == nullptr ? nullptr : x2 + n0 * h * wd * c2,
        w, bias, out + n0 * ho * wo * cout, h, wd, c1, c2, cout, tiles_x);
  }
}

void dispatch_conv_f32(const void* x, const void* x2, const void* w,
                       const float* bias, void* out, int64_t n, int64_t h,
                       int64_t wd, int c1, int c2, int cout, int stride,
                       cudaStream_t s) {
  const float* xt = static_cast<const float*>(x);
  const float* x2t = static_cast<const float*>(x2);
  const float* wt = static_cast<const float*>(w);
  float* ot = static_cast<float*>(out);
  const bool wide = cout > kCpt;
  if (stride == 1 && wide)
    launch_conv<1, 2>(xt, x2t, wt, bias, ot, n, h, wd, c1, c2, cout, s);
  else if (stride == 1)
    launch_conv<1, 1>(xt, x2t, wt, bias, ot, n, h, wd, c1, c2, cout, s);
  else if (wide)
    launch_conv<2, 2>(xt, x2t, wt, bias, ot, n, h, wd, c1, c2, cout, s);
  else
    launch_conv<2, 1>(xt, x2t, wt, bias, ot, n, h, wd, c1, c2, cout, s);
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
  dispatch_conv_f32(x, x2, w, b, out, n, h, wd, c1, c2, cout, stride, s);
  return (int)cudaGetLastError();
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
