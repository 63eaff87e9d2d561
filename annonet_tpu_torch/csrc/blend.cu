// K4: the tiled-inference epilogue in one pass — ramp-weighted blend of the
// tile logits, 1/wsum normalisation, gains argmax and detection seeds.
//
// Replaces the Pallas TPU kernel annonet_tpu/ops/pallas_blend.py
// blend_accumulate (:94), which scatter-adds ramp-weighted tiles into a
// [K, Hp, Wp] canvas in device memory, and fuses the XLA epilogue that
// follows it on the default path (infer/core.py:512-552): normalise,
// argmax of blended + gains, and the seed test.
//
// Gather form, not atomics: each output pixel sums the tiles that cover it
// in tile-index order, starting from 0, as
// acc = __fadd_rn(acc, __fmul_rn(logit, ramp)). The intrinsics keep nvcc
// from contracting the pair into an FMA, so the sum is the XLA add chain's
// (core.py:513-519) and the plain PyTorch version's, bit for bit, and the
// result is deterministic. The canvas never exists in device memory: the
// kernel reads each tile's logits once and writes one label byte and one
// seed byte per pixel.
//
// What bounds it on an H100: its bytes. On the 4096^2 plan (25 tiles of
// 872^2 on a 4112^2 canvas, K = 3) it reads 228 MB of f32 logits and the
// 68 MB 1/wsum canvas and writes 2 x 17 MB of labels and seeds: ~0.1 ms at
// the card's 3.35 TB/s, against a few operations a byte, so each pixel
// must touch only the tiles that cover it.
//
// Design. A block owns a patch of kPatchH x kPatchW canvas pixels of one
// image. Its first warp tests the tiles against the patch's rectangle,
// kList at a time in tile-index order, and compacts the ones that
// intersect into an ordered list in shared memory (a warp ballot and its
// prefix count keep the order). Each thread then walks that short list for
// its kPixels pixels of one canvas column (at most 4 tiles of a grid plan
// meet a patch), skips the tiles that do not
// cover a pixel, and adds the logits of up to kClasses classes of a
// covering tile in one pass, with one accumulator each in registers:
// neighbouring threads read neighbouring pixels of a tile row (coalesced).
// The list is exact for any tile_yx, not only grid plans: where more than
// kList tiles exist they are compacted and walked kList candidates at a
// time, in order, and more than kClasses classes take one walk per class
// chunk, carrying the argmax across chunks. Labels and seeds are staged in
// shared memory and stored 16 bytes a thread (int32 labels, K > 255, go
// straight out).
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
constexpr int kPatchH = 8;    // canvas rows of a block's patch
constexpr int kPatchW = 128;  // canvas columns
constexpr int kPixels = kPatchH * kPatchW / kBlendThreads;  // a thread's
constexpr int kRowStep = kBlendThreads / kPatchW;  // rows between them
constexpr int kList = 64;     // candidate tiles tested and listed at a time
constexpr int kClasses = 4;   // classes summed in one walk of the list
constexpr int kPieces = kPatchH * kPatchW / 16;  // 16-byte stores a patch
static_assert(kPixels * kRowStep == kPatchH && kList % 32 == 0, "patch shape");

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
                    int64_t hp, int64_t wp, int k, int reference_blend,
                    int64_t patches_x, int vec_store) {
  __shared__ int32_t s_tile[kList], s_y[kList], s_x[kList];
  __shared__ int s_count;
  __shared__ __align__(16) uint8_t s_labels[kPatchH][kPatchW];
  __shared__ __align__(16) uint8_t s_seeds[kPatchH][kPatchW];

  const int64_t img = img0 + blockIdx.y;
  const int64_t py0 = (int64_t)(blockIdx.x / patches_x) * kPatchH;
  const int64_t px0 = (int64_t)(blockIdx.x % patches_x) * kPatchW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col = tid % kPatchW, row0 = tid / kPatchW;
  const int64_t x = px0 + col;
  // argmax fold: the gain enters scaled by the weight sum wy(y) * wx(x)
  const bool fold = wy != nullptr;
  const bool normalise = !reference_blend && !fold;
  const float fx = fold && x < wp ? rnd<BF16>(wx[x]) : 0.f;

  // this thread's pixels: canvas column x, rows py0 + row0 + j * kRowStep
  bool inside[kPixels];
  int64_t y[kPixels];
  float inv[kPixels], fy[kPixels];
  int label[kPixels];
  float best[kPixels], b_label[kPixels], b0[kPixels];
#pragma unroll
  for (int j = 0; j < kPixels; ++j) {
    y[j] = py0 + row0 + j * kRowStep;
    inside[j] = y[j] < hp && x < wp;
    inv[j] = normalise && inside[j] ? rnd<BF16>(inv_wsum[y[j] * wp + x]) : 0.f;
    fy[j] = fold && inside[j] ? rnd<BF16>(wy[y[j]]) : 0.f;
    label[j] = 0;
    best[j] = b_label[j] = b0[j] = 0.f;
  }

  // the first warp lists the tiles w0 .. w0 + kList - 1 that intersect the
  // patch, in tile-index order: a ballot per 32 tiles, each hit at its
  // prefix count
  auto list = [&](int64_t w0) {
    if (warp != 0) return;
    int count = 0;
    for (int s = 0; s < kList; s += 32) {
      const int64_t t = w0 + s + lane;
      int64_t ty = 0, tx = 0;
      bool hit = false;
      if (t < n_tiles) {
        ty = tile_yx[2 * t];
        tx = tile_yx[2 * t + 1];
        hit = ty < py0 + kPatchH && ty + th > py0 && tx < px0 + kPatchW && tx + tw > px0;
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      if (hit) {
        const int at = count + __popc(ballot & ((1u << lane) - 1u));
        s_tile[at] = (int32_t)t;
        s_y[at] = (int32_t)ty;
        s_x[at] = (int32_t)tx;
      }
      count += __popc(ballot);
    }
    if (lane == 0) s_count = count;
  };

  int64_t listed = -1;  // the w0 of the list in shared memory
  for (int c0 = 0; c0 < k; c0 += kClasses) {
    float acc[kPixels][kClasses];
#pragma unroll
    for (int j = 0; j < kPixels; ++j)
#pragma unroll
      for (int cc = 0; cc < kClasses; ++cc) acc[j][cc] = 0.f;
    for (int64_t w0 = 0; w0 < n_tiles; w0 += kList) {
      if (w0 != listed) {  // the same for the whole block
        __syncthreads();
        list(w0);
        __syncthreads();
        listed = w0;
      }
      const int count = s_count;
      for (int i = 0; i < count; ++i) {
        const int64_t dx = x - s_x[i];
        if (dx < 0 || dx >= tw) continue;
        const int64_t ty = s_y[i];
        const float* lt = logits + ((int64_t)s_tile[i] * m + img) * th * tw * k + c0;
#pragma unroll
        for (int j = 0; j < kPixels; ++j) {
          const int64_t dy = y[j] - ty;
          if (!inside[j] || dy < 0 || dy >= th) continue;
          const int64_t p = dy * tw + dx;
          const float r = rnd<BF16>(ramp[p]);
#pragma unroll
          for (int cc = 0; cc < kClasses; ++cc) {
            if (c0 + cc >= k) break;
            const float l = rnd<BF16>(lt[p * k + cc]);
            acc[j][cc] = rnd<BF16>(__fadd_rn(acc[j][cc], rnd<BF16>(__fmul_rn(l, r))));
          }
        }
      }
    }
#pragma unroll
    for (int cc = 0; cc < kClasses; ++cc) {
      const int c = c0 + cc;
      if (c >= k) break;
      const float g = rnd<BF16>(gains[c]);
#pragma unroll
      for (int j = 0; j < kPixels; ++j) {
        const float a = acc[j][cc];
        float blended, v;
        if (reference_blend) {
          blended = a;
          v = rnd<BF16>(__fadd_rn(a, g));
        } else if (fold) {
          blended = a;  // the fold runs without detection: no seeds read it
          v = rnd<BF16>(__fadd_rn(
              a, rnd<BF16>(__fmul_rn(rnd<BF16>(__fmul_rn(g, fy[j])), fx))));
        } else {
          blended = rnd<BF16>(__fmul_rn(a, inv[j]));
          v = rnd<BF16>(__fadd_rn(blended, g));
        }
        // first maximum wins; a NaN counts as the maximum (argmax semantics)
        if (c == 0) {
          best[j] = v;
          b0[j] = blended;
          b_label[j] = blended;
        } else if (!isnan(best[j]) && (v > best[j] || isnan(v))) {
          best[j] = v;
          label[j] = c;
          b_label[j] = blended;
        }
      }
    }
  }

  const float d0 = seeds != nullptr ? rnd<BF16>(det[0]) : 0.f;
#pragma unroll
  for (int j = 0; j < kPixels; ++j) {
    const uint8_t seed =
        seeds != nullptr && label[j] > 0 &&
        rnd<BF16>(__fsub_rn(b_label[j], b0[j])) >
            rnd<BF16>(__fsub_rn(rnd<BF16>(det[label[j]]), d0));
    if (labels_i32 != nullptr) {
      const int64_t o = (img * hp + y[j]) * wp + x;
      if (inside[j]) {
        labels_i32[o] = label[j];
        if (seeds != nullptr) seeds[o] = seed;
      }
    } else {
      s_labels[row0 + j * kRowStep][col] = (uint8_t)label[j];
      s_seeds[row0 + j * kRowStep][col] = seed;
    }
  }
  if (labels_i32 != nullptr) return;
  __syncthreads();
  // 16 bytes a thread: the labels' pieces, then the seeds'
  for (int e = tid; e < 2 * kPieces; e += kBlendThreads) {
    const bool is_seed = e >= kPieces;
    if (is_seed && seeds == nullptr) break;
    const int q = e % kPieces, r = q / (kPatchW / 16), c16 = q % (kPatchW / 16) * 16;
    const int64_t yy = py0 + r, xx = px0 + c16;
    if (yy >= hp || xx >= wp) continue;
    uint8_t* dst = (is_seed ? seeds : labels_u8) + (img * hp + yy) * wp + xx;
    const uint8_t* src = is_seed ? &s_seeds[r][c16] : &s_labels[r][c16];
    if (vec_store && xx + 16 <= wp) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int j = 0; j < 16 && xx + j < wp; ++j) dst[j] = src[j];
    }
  }
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
  if (k <= 0 || n_tiles <= 0 || n_tiles > INT32_MAX ||
      (wy == nullptr) != (wx == nullptr))
    return (int)cudaErrorInvalidValue;
  if (m == 0 || hp * wp == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t patches_x = (wp + kPatchW - 1) / kPatchW;
  const int64_t patches = patches_x * ((hp + kPatchH - 1) / kPatchH);
  if (patches > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int vec_store = !labels_int32 && wp % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(labels) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(seeds) % 16 == 0;
  auto kernel = bf16 ? blend_argmax_kernel<true> : blend_argmax_kernel<false>;
  for (int64_t m0 = 0; m0 < m; m0 += kMaxGridYZ) {
    const int64_t mb = m - m0 < kMaxGridYZ ? m - m0 : kMaxGridYZ;
    dim3 grid((unsigned)patches, (unsigned)mb, 1);
    kernel<<<grid, kBlendThreads, 0, s>>>(
        static_cast<const float*>(logits),
        static_cast<const int32_t*>(tile_yx), static_cast<const float*>(ramp),
        static_cast<const float*>(inv_wsum), static_cast<const float*>(gains),
        static_cast<const float*>(det), static_cast<const float*>(wy),
        static_cast<const float*>(wx),
        labels_int32 ? nullptr : static_cast<uint8_t*>(labels),
        labels_int32 ? static_cast<int32_t*>(labels) : nullptr,
        with_detection ? static_cast<uint8_t*>(seeds) : nullptr, n_tiles, m,
        m0, th, tw, hp, wp, k, reference_blend, patches_x, vec_store);
  }
  return (int)cudaGetLastError();
}
