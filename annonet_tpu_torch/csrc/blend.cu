// K4: the tiled-inference epilogue in one pass — ramp-weighted blend of the
// tile logits, 1/wsum normalisation, gains argmax and detection seeds.
//
// Replaces the Pallas TPU kernel annonet_tpu/ops/pallas_blend.py
// blend_accumulate (:94), which scatter-adds ramp-weighted tiles into a
// [K, Hp, Wp] canvas in device memory, and fuses the XLA epilogue that
// follows it on the default path (infer/core.py:512-552): normalise,
// argmax of blended + gains, and the seed test.
//
// Gather form, not atomics: one thread per output pixel sums the tiles
// that cover it in tile-index order, starting from 0, as
// acc = __fadd_rn(acc, __fmul_rn(logit, ramp)). The intrinsics keep nvcc
// from contracting the pair into an FMA, so the sum is the XLA add chain's
// (core.py:513-519) and the plain PyTorch version's, bit for bit, and the
// result is deterministic. The canvas never exists in device memory: the
// kernel reads the logits once (plus the overlap bands twice) and writes
// one label byte and one seed byte per pixel.
//
// What bounds it on an H100: the per-pixel loop, not bytes. Every pixel
// tests all n_tiles tiles for coverage, for each of the K classes: at
// 4096^2 with a 25-tile 896^2 plan and K = 3 that is 75 tests per pixel,
// while the ~241 MB of f32 logits it reads would take ~0.07 ms at the
// card's 3.35 TB/s and the kernel takes ~1.2 ms (PERF.md). Looping over
// only the tiles of the pixel's grid row and column is the next step
// (PERF.md, Open questions).
//
// bf16 mode (the int8 path's default, infer/core.py:403-493): the same
// gather, with every rounding point of the JAX bf16 chain written out:
// logit and ramp rounded to bf16, their product rounded, the running sum
// rounded after each add; then either the argmax fold
// argmax(acc + (gain * wy) * wx), which needs no 1/wsum pass (the blend
// weight sum factorises over grid plans, tiling.weight_sum_factors), or
// argmax(acc * inv_wsum + gain) and the seeds from those normalised
// values, each product, sum and difference rounded to bf16. The fold also
// runs in f32 (an int8 net with an f32 blend). The plain version rounds at
// the same points, so labels and seeds stay bit-identical to it.

#include "common.cuh"

namespace annonet {
namespace {

constexpr int kBlendThreads = 256;

// rounding to the blend dtype: bf16 in BF16 mode, none in f32
template <bool BF16>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (BF16)
    return __bfloat162float(__float2bfloat16_rn(v));
  else
    return v;
}

template <bool BF16>
__global__ void __launch_bounds__(kBlendThreads)
blend_argmax_kernel(const float* __restrict__ logits,
                    const int32_t* __restrict__ tile_yx,
                    const float* __restrict__ ramp,
                    const float* __restrict__ inv_wsum,
                    const float* __restrict__ gains,
                    const float* __restrict__ det,
                    const float* __restrict__ wy,
                    const float* __restrict__ wx, uint8_t* labels_u8,
                    int32_t* labels_i32, uint8_t* seeds, int64_t n_tiles,
                    int64_t m, int64_t img0, int64_t th, int64_t tw,
                    int64_t hp, int64_t wp, int k, int reference_blend) {
  const int64_t pix = (int64_t)blockIdx.x * kBlendThreads + threadIdx.x;
  if (pix >= hp * wp) return;
  const int64_t img = img0 + blockIdx.y;
  const int64_t y = pix / wp, x = pix % wp;
  const float inv = rnd<BF16>(inv_wsum[pix]);
  // argmax fold: the gain enters scaled by the weight sum wy(y) * wx(x)
  const bool fold = wy != nullptr;
  const float fy = fold ? rnd<BF16>(wy[y]) : 0.f;
  const float fx = fold ? rnd<BF16>(wx[x]) : 0.f;

  int label = 0;
  float best = 0.f, b_label = 0.f, b0 = 0.f;
  for (int c = 0; c < k; ++c) {
    float acc = 0.f;
    for (int64_t t = 0; t < n_tiles; ++t) {
      const int64_t dy = y - tile_yx[2 * t], dx = x - tile_yx[2 * t + 1];
      if (dy >= 0 && dy < th && dx >= 0 && dx < tw) {
        const float l =
            rnd<BF16>(logits[(((t * m + img) * th + dy) * tw + dx) * k + c]);
        const float r = rnd<BF16>(ramp[dy * tw + dx]);
        acc = rnd<BF16>(__fadd_rn(acc, rnd<BF16>(__fmul_rn(l, r))));
      }
    }
    const float g = rnd<BF16>(gains[c]);
    float blended, v;
    if (reference_blend) {
      blended = acc;
      v = rnd<BF16>(__fadd_rn(acc, g));
    } else if (fold) {
      blended = acc;  // the fold runs without detection: no seeds read it
      v = rnd<BF16>(
          __fadd_rn(acc, rnd<BF16>(__fmul_rn(rnd<BF16>(__fmul_rn(g, fy)), fx))));
    } else {
      blended = rnd<BF16>(__fmul_rn(acc, inv));
      v = rnd<BF16>(__fadd_rn(blended, g));
    }
    // first maximum wins; a NaN counts as the maximum (argmax semantics)
    if (c == 0) {
      best = v;
      b0 = blended;
      b_label = blended;
    } else if (!isnan(best) && (v > best || isnan(v))) {
      best = v;
      label = c;
      b_label = blended;
    }
  }
  const int64_t o = img * hp * wp + pix;
  if (labels_i32 != nullptr)
    labels_i32[o] = label;
  else
    labels_u8[o] = (uint8_t)label;
  if (seeds != nullptr)
    seeds[o] = (label > 0 &&
                rnd<BF16>(__fsub_rn(b_label, b0)) >
                    rnd<BF16>(__fsub_rn(rnd<BF16>(det[label]),
                                        rnd<BF16>(det[0]))))
                   ? 1
                   : 0;
}

}  // namespace
}  // namespace annonet

extern "C" int annonet_blend_argmax(
    const void* logits, const void* tile_yx, const void* ramp,
    const void* inv_wsum, const void* gains, const void* det, const void* wy,
    const void* wx, void* labels, void* seeds, int64_t n_tiles, int64_t m,
    int64_t th, int64_t tw, int64_t hp, int64_t wp, int k, int labels_int32,
    int with_detection, int reference_blend, int bf16, void* stream) {
  using namespace annonet;
  cudaGetLastError();  // report this launch's error only
  if (k <= 0 || n_tiles <= 0 || (wy == nullptr) != (wx == nullptr))
    return (int)cudaErrorInvalidValue;
  if (m == 0 || hp * wp == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t blocks = (hp * wp + kBlendThreads - 1) / kBlendThreads;
  auto kernel = bf16 ? blend_argmax_kernel<true> : blend_argmax_kernel<false>;
  for (int64_t m0 = 0; m0 < m; m0 += kMaxGridYZ) {
    const int64_t mb = m - m0 < kMaxGridYZ ? m - m0 : kMaxGridYZ;
    dim3 grid((unsigned)blocks, (unsigned)mb, 1);
    kernel<<<grid, kBlendThreads, 0, s>>>(
        static_cast<const float*>(logits),
        static_cast<const int32_t*>(tile_yx), static_cast<const float*>(ramp),
        static_cast<const float*>(inv_wsum), static_cast<const float*>(gains),
        static_cast<const float*>(det), static_cast<const float*>(wy),
        static_cast<const float*>(wx),
        labels_int32 ? nullptr : static_cast<uint8_t*>(labels),
        labels_int32 ? static_cast<int32_t*>(labels) : nullptr,
        with_detection ? static_cast<uint8_t*>(seeds) : nullptr, n_tiles, m,
        m0, th, tw, hp, wp, k, reference_blend);
  }
  return (int)cudaGetLastError();
}
