// K3 in bf16, both modes: the 2x2 stride-2 transpose conv as a GEMM on the
// tensor cores.
//
// Replaces the Pallas TPU kernel fup_bias_relu of
// annonet_tpu/ops/int8_conv_mosaic.py (:485, pallas_call at :511) and, in
// its requant mode, the int8 net's bf16 ``up`` layer
// (annonet_tpu/models/quantized_runtime.py:480-487). The f32 configs stay
// on conv.cu's direct convolution on the CUDA cores (TF32 tensor cores keep
// 10 mantissa bits and would break their 1e-4 contract);
// annonet_up2x2_bias_relu and annonet_up2x2_requant (conv.cu) dispatch on
// the dtype.
//
// What it computes. out[img, 2i+u, 2j+v, co] = x[img, i, j, :] . w[1-u, 1-v,
// :, co] (the flipped kernel, folded_runtime.py:108-111). As the TPU kernel
// does (int8_conv_mosaic.py:474-481: one dilation-free GEMM per output-row
// parity), it is C = A . B with
//   A [M input pixels, K = cin],
//   B [cin, 4 cout], column (2u + v) * cout + co holding w[1-u, 1-v, :, co].
// In NHWC the 2 cout columns of parity u of pixel (i, j) are exactly the
// contiguous out[img, 2i+u, 2j:2j+2, :], so a run of pixels along a row
// gives one contiguous output run per u: no interleave.
//   float:   out = bf16(relu(C + bias)), one rounding after the f32 bias
//            (bf16(C + bias) without the ReLU: the U-Net's linear up)
//   requant: A = bf16(int8 x * bf16(s_in[c])) on the way into shared
//            memory, r = bf16(C), out = int8(trunc(clip(fma(r, scale,
//            offset), 0, 127))) (conv.cu's f32 kernel, qup_igemm.cu)
//
// What bounds it on an H100. On the flagship's 25-tile 896^2 batch (bytes =
// input + output once; bound = max(bytes / 3.35 TB/s, FLOPs / 989
// TFLOP/s)):
//
//   layer      x -> cout                 GFLOP  FLOP/B  bound ms  binds
//   dec3/up    [25,112,112,128] -> 64     20.5     85    0.072   bytes
//   dec2/up    [25,224,224,64]  -> 32     20.5     43    0.144   bytes
//   dec1/up    [25,448,448,32]  -> 16     20.5     21    0.287   bytes
//
// (the requant mode moves int8 in and out: half the bytes, the same
// FLOPs). All three sit far under the card's ~295 FLOP/byte bf16 line, so
// the aim is bytes: read each input element from device memory once and
// write each output element once, in coalesced 16-byte pieces; the tensor
// cores only take the arithmetic off that path. The direct convolution it
// replaces kept one pixel per thread and wrote 2-byte scalars lanes
// 4 cout bytes apart, and above 16 output channels read (and rescaled)
// every input twice: 6.6 TFLOP/s and ~0.1 TB/s.
//
// Design. Persistent blocks of 8 warps walk tiles of 128 consecutive input
// pixels (in N*H*W order; a tile may cross image rows, the epilogue
// computes each pixel's output rows). B for all four parities, padded to
// K = 16k and to whole 64-column chunks, is staged in shared memory once
// per block by cp.async (64 KiB at dec3's 128 -> 64), with the per-column
// bias (or scale and offset). A tile's input is one contiguous span of
// memory: it is copied by cp.async 16-byte pieces (bf16 with cin % 8 == 0;
// element gathers otherwise), or, in the requant mode, as raw int8 bytes
// that each warp rescales into its own 16 rows of the bf16 A tile. The
// next tile's copy runs under the current tile's products and stores
// (double-buffered), with one block barrier per tile.
// Each warp owns 16 pixels (one m16 row tile) and walks the columns 64 at
// a time: A fragments by ldmatrix.x4, B by ldmatrix.x4.trans (rows padded
// by 8 elements: conflict-free), all of a k-step's fragments loaded before
// its bf16 mma.sync.m16n8k16 products (f32 accumulation). The epilogue
// rounds into a per-warp staging tile in shared memory, and lanes then
// store 16-byte pieces, neighbouring lanes on neighbouring addresses
// (element by element where cout is not a multiple of 4, in int8 of 8).
// Where the whole of B and two A buffers do not fit in shared memory
// (configs wider than the flagship), the columns split into slabs over
// grid.y (each slab reads A again). Then, in the float mode, K runs in
// chunks of kKChunk channels (the U-Net's dec4/up reads 1024): one slab of
// kNC columns a block, whose accumulators persist over the chunks, and a
// stage buffer holds a chunk's A rows and B rows together, copied under
// the previous chunk's products; the sums are the unchunked ones, k-step by
// k-step in the same order. In the requant mode A falls to one buffer
// instead; cin up to 384 fits there.
//
// What holds it (H100, chip_smoke.py; PERF.md): dec2/up and dec1/up in
// bf16 move ~2.2 TB/s, two thirds of the HBM rate; dec3/up and the requant
// mode are bound by the instructions and latencies of each tile (the
// copy, the conversion, the products, the epilogue and the stores add up
// rather than overlap), not by bytes. A deeper ring of copies, one barrier
// instead of three and 3 blocks per SM changed nothing there, nor did
// keeping the conversions off the conversion unit; staging B by cp.async
// helped dec3/up, whose blocks each stage 64 KiB of it. The U-Net's wide
// up layers (512 and 1024 input channels, chunked) reach 9% of their
// operations' bound, slower than cuDNN's transpose conv: every 64-column
// slab reads A again, and every tile stages its slab's B again.
//
// mma.sync and not wgmma: the layers sit at 21-85 FLOP per byte, and a
// warp's 16 x 64 x K products are a few instructions per 2 KiB of output.

#include "common.cuh"

namespace annonet {
namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 16 * kWarps;  // input pixels per tile: 16 per warp
constexpr int kNC = 64;           // output columns per warp pass: 8 n8 tiles
constexpr int kStagePitch = (kNC + 8) * 2;  // bytes of a staged bf16 row
constexpr int kStagePitch8 = kNC + 16;      // bytes of a staged int8 row
constexpr int kKChunk = 64;  // channels a chunk where the whole K does not fit

// the dynamic shared memory's carve-up; the same arithmetic on the host
// (to size the launch) and on the device
// kc: the channels of K a stage holds (all of them, rounded up to 16, or a
// chunk); chunked: B is staged chunk by chunk beside A, one buffer a stage
struct Smem {
  int a_pitch, b_pitch;  // elements of an A row (kc + 8), a B row (ns + 8)
  int a_buf, raw_buf;    // bytes of one A buffer, one raw int8 stage
  int b_buf;             // bytes of B's kc rows
  int off_a, off_raw, off_b, off_stage, off_epi, off_sin, total;
};

__host__ __device__ inline Smem carve(int kc, int ns, int stages, bool requant,
                                      int cin, bool chunked) {
  Smem s;
  s.a_pitch = kc + 8;
  s.b_pitch = ns + 8;
  s.a_buf = kBM * s.a_pitch * 2;
  s.raw_buf = requant ? (kBM * cin + 15) / 16 * 16 : 0;
  s.b_buf = kc * s.b_pitch * 2;
  int o = 0;
  s.off_a = o;
  o += (requant ? 1 : stages) * s.a_buf;  // requant: raw stages, one A
  s.off_raw = o;
  o += (requant ? stages : 0) * s.raw_buf;
  s.off_b = o;
  o += (chunked ? stages : 1) * s.b_buf;
  s.off_stage = o;
  o += kWarps * 16 * kStagePitch;
  s.off_epi = o;
  o += 2 * ns * 4;
  s.off_sin = o;
  o += kc * 4;
  s.total = o;
  return s;
}

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

// two floats rounded to bf16 and packed, lo in the low half
__device__ __forceinline__ uint32_t pack2f(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// REQUANT: x is int8 and e0, e1 are the requant scale and offset, else x is
// bf16 and e0 the bias (relu: the ReLU after it, or none). Columns n0 .. n0
// + ns - 1 of B (this block's slab, blockIdx.y); ns and kc are multiples of
// kNC and 16. CHUNKED: K is walked in ``chunks`` chunks of kc channels
// (only in the float mode, with ns == kNC), else in one. The one-chunk
// kernel is its own instantiation so that its accumulators are dead between
// tiles: carried over (tile, chunk) stages, they stay live through the next
// stage's copy, and the flagship's up layers take 4% longer.
template <bool REQUANT, bool CHUNKED>
__global__ void __launch_bounds__(kThreads, 2)
upgemm_kernel(const void* __restrict__ xv, const float* __restrict__ s_in,
              const __nv_bfloat16* __restrict__ w, const float* __restrict__ e0,
              const float* __restrict__ e1, void* __restrict__ outv,
              int64_t npix, int64_t h, int64_t wd, int cin, int cout, int kc,
              int chunks, int ns, int stages, int vec_x, int vec_w, int vec_o,
              int relu) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L = carve(kc, ns, stages, REQUANT, cin, CHUNKED);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n4 = 4 * cout, n0 = blockIdx.y * ns;
  const int64_t tiles = (npix + kBM - 1) / kBM;
  float* epi = reinterpret_cast<float*>(smem + L.off_epi);  // [2][ns]
  float* s_bf = reinterpret_cast<float*>(smem + L.off_sin);  // [kc]
  const uint4 zero = make_uint4(0, 0, 0, 0);
  // B's rows of stage st (one resident copy of the whole K, unchunked)
  auto b_of = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(smem + L.off_b + (CHUNKED ? st * L.b_buf : 0));
  };

  // B[k][n] = w[1-u][1-v][k][co] for column n0 + n = (2u + v) * cout + co,
  // rows k0 .. k0 + kc - 1 into bs; zero past cin and past 4 cout. 8
  // columns at a time, co fastest: by cp.async where cout % 8 == 0 (the
  // pieces then never straddle a parity), so that these loads overlap the
  // tile's instead of each waiting out its own latency. They land with the
  // commit group of the tile (or chunk) that follows.
  const int groups = ns / 8;
  auto stage_b = [&](__nv_bfloat16* bs, int k0) {
    for (int e = tid; e < kc * groups; e += kThreads) {
      const int kr = e / groups, n = (e - kr * groups) * 8, col = n0 + n, k = k0 + kr;
      __nv_bfloat16* dst = bs + kr * L.b_pitch + n;
      if (k >= cin || col >= n4) {
        *reinterpret_cast<uint4*>(dst) = zero;
        continue;
      }
      if (vec_w) {
        const int q = col / cout, co = col - q * cout;
        cp_async16(dst, w + ((int64_t)(3 - q) * cin + k) * cout + co);  // tap (1-u)*2 + (1-v)
        continue;
      }
      __nv_bfloat16 v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int q = (col + j) / cout, co = col + j - q * cout;
        v[j] = col + j < n4 ? w[((int64_t)(3 - q) * cin + k) * cout + co]
                            : __float2bfloat16_rn(0.f);
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                                                  pack2(v[4], v[5]), pack2(v[6], v[7]));
    }
  };
  if (!CHUNKED) stage_b(b_of(0), 0);
  for (int n = tid; n < ns; n += kThreads) {
    const int col = n0 + n, co = col % cout;
    epi[n] = col < n4 ? e0[co] : 0.f;
    epi[ns + n] = REQUANT && col < n4 ? e1[co] : 0.f;
  }
  if (REQUANT)
    for (int k = tid; k < kc; k += kThreads)
      s_bf[k] = k < cin ? __bfloat162float(__float2bfloat16_rn(s_in[k])) : 0.f;

  auto tile_rows = [&](int64_t t) {
    const int64_t left = npix - t * kBM;
    return left < kBM ? (int)left : kBM;
  };

  // copies chunk ch of tile t's input into stage st: the bf16 A buffer
  // (and, chunked, the chunk's B rows), or the raw int8 bytes (one
  // contiguous span of rows * cin bytes)
  auto fill = [&](int64_t t, int ch, int st) {
    const int64_t p0 = t * kBM;
    const int rows = tile_rows(t);
    if constexpr (REQUANT) {
      const int8_t* src = static_cast<const int8_t*>(xv) + p0 * cin;
      int8_t* dst = reinterpret_cast<int8_t*>(smem + L.off_raw + st * L.raw_buf);
      const int bytes = rows * cin;
      const int whole = vec_x ? bytes / 16 : 0;
      for (int e = tid; e < whole; e += kThreads) cp_async16(dst + 16 * e, src + 16 * e);
      for (int e = 16 * whole + tid; e < bytes; e += kThreads) dst[e] = src[e];
    } else {
      const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(xv);
      __nv_bfloat16* a = reinterpret_cast<__nv_bfloat16*>(smem + L.off_a + st * L.a_buf);
      const int pieces = kc / 8, k0 = ch * kc;
      for (int e = tid; e < kBM * pieces; e += kThreads) {
        const int p = e / pieces, cl = (e - p * pieces) * 8, c = k0 + cl;
        uint4* dst = reinterpret_cast<uint4*>(a + p * L.a_pitch + cl);
        if (p >= rows || c >= cin) {
          *dst = zero;
          continue;
        }
        const __nv_bfloat16* s = x + (p0 + p) * cin + c;
        if (vec_x) {
          cp_async16(dst, s);
        } else {
          __nv_bfloat16 v[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = c + j < cin ? s[j] : __float2bfloat16_rn(0.f);
          *dst = make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                            pack2(v[4], v[5]), pack2(v[6], v[7]));
        }
      }
      if (CHUNKED) stage_b(b_of(st), k0);
    }
  };

  // the warp's rows: 16 pixels r0 .. r0 + 15 of the tile
  const int r0 = warp * 16;
  const int g = lane >> 2, tg = lane & 3;
  unsigned char* stage = smem + L.off_stage + warp * 16 * kStagePitch;
  const int64_t urow = 2 * wd * cout;  // one output row: parity u = 1 is + urow
  constexpr int kPE = REQUANT ? 16 : 8;  // elements in a 16-byte piece
  constexpr int kPPR = kNC / kPE;        // pieces in a staged row
  constexpr int kRPP = 32 / kPPR;        // staged rows a warp stores at once

  // requant: the warp's own 16 rows of the raw int8 stage st times
  // bf16(s_in), rounded to bf16, into A. Only this warp reads those rows,
  // so no block barrier follows.
  auto convert = [&](int st, int rows) {
    const int8_t* raw = reinterpret_cast<const int8_t*>(smem + L.off_raw + st * L.raw_buf);
    __nv_bfloat16* a = reinterpret_cast<__nv_bfloat16*>(smem + L.off_a);
    const int pieces = kc / 8;
    for (int e = lane; e < 16 * pieces; e += 32) {
      const int pr = e / pieces, p = r0 + pr, c = (e - pr * pieces) * 8;
      float f[8];
      if (cin % 8 == 0) {  // 8 whole channels or none: one 8-byte read
        uint2 q = make_uint2(0, 0);
        if (p < rows && c < cin) q = *reinterpret_cast<const uint2*>(raw + p * cin + c);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          f[j] = __fmul_rn((float)(int8_t)((j < 4 ? q.x : q.y) >> (8 * (j & 3))), s_bf[c + j]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int cj = c + j;
          f[j] = p < rows && cj < cin ? __fmul_rn((float)raw[p * cin + cj], s_bf[cj]) : 0.f;
        }
      }
      *reinterpret_cast<uint4*>(a + p * L.a_pitch + c) =
          make_uint4(pack2f(f[0], f[1]), pack2f(f[2], f[3]), pack2f(f[4], f[5]),
                     pack2f(f[6], f[7]));
    }
    __syncwarp();
  };

  // the accumulators of the warp's 16 x kNC pass; chunked, they carry over
  // the chunks of one tile (its only pass, ns == kNC)
  float acc[8][4];

  // chunk ch of the tile's products; at its last chunk the epilogue
  auto compute = [&](const __nv_bfloat16* a, const __nv_bfloat16* bs, int64_t p0, int rows,
                     int ch) {
    if (r0 >= rows) return;
    // lane l < 16: the output offset of pixel r0 + l at parity u = 0
    int64_t rowbase = -1;
    if (lane < 16 && r0 + lane < rows) {
      int64_t img, iy, jx;
      if (npix <= INT32_MAX) {  // 32-bit divisions where the indices fit
        const uint32_t p = (uint32_t)(p0 + r0 + lane);
        const uint32_t q = p / (uint32_t)wd, i = q / (uint32_t)h;
        img = i, iy = q - i * (uint32_t)h, jx = p - q * (uint32_t)wd;
      } else {
        const int64_t p = p0 + r0 + lane;
        const int64_t q = p / wd;
        img = q / h, iy = q - img * h, jx = p - q * wd;
      }
      rowbase = ((img * 2 * h + 2 * iy) * 2 * wd + 2 * jx) * cout;
    }
    const uint32_t a_lane = smem_addr(a + (r0 + (lane & 15)) * L.a_pitch + (lane >> 4) * 8);
    const uint32_t b_lane = smem_addr(bs + (lane & 15) * L.b_pitch + (lane >> 4) * 8);
    for (int c0 = 0; c0 < ns && n0 + c0 < n4; c0 += kNC) {
      if (!CHUNKED || ch == 0) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
      }
      // a k-step's fragments are all loaded before its 8 products (the
      // asm statements keep their order: interleaved, each product would
      // wait out its own load)
      for (int k0 = 0; k0 < kc; k0 += 16) {
        uint32_t af[4], bf[4][4];
        ldmatrix_x4(af, a_lane + k0 * 2);
#pragma unroll
        for (int np = 0; np < 4; ++np)
          ldmatrix_x4_trans(bf[np], b_lane + (k0 * L.b_pitch + c0 + np * 16) * 2);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          mma_bf16(acc[2 * np], af, &bf[np][0]);
          mma_bf16(acc[2 * np + 1], af, &bf[np][2]);
        }
      }
      if (CHUNKED && ch != chunks - 1) continue;
      // round into the warp's staging tile: rows g and g + 8, columns
      // nt * 8 + 2 tg and + 1
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = nt * 8 + 2 * tg, n = c0 + col;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = g + 8 * half;
          const float* c = &acc[nt][2 * half];
          if constexpr (REQUANT) {
            // both sums rounded to bf16 by one packed conversion
            const uint32_t r = pack2f(c[0], c[1]);
            const float rv[2] = {__uint_as_float(r << 16), __uint_as_float(r & 0xffff0000u)};
            int8_t q[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const float f = __fmaf_rn(rv[i], epi[n + i], epi[ns + n + i]);
              q[i] = (int8_t)__float2int_rz(fminf(fmaxf(f, 0.f), 127.f));
            }
            *reinterpret_cast<char2*>(stage + row * kStagePitch8 + col) = make_char2(q[0], q[1]);
          } else {
            float y0 = c[0] + epi[n], y1 = c[1] + epi[n + 1];
            if (relu) y0 = fmaxf(y0, 0.f), y1 = fmaxf(y1, 0.f);
            *reinterpret_cast<__nv_bfloat162*>(stage + row * kStagePitch + col * 2) =
                __floats2bfloat162_rn(y0, y1);
          }
        }
      }
      __syncwarp();
      // 16-byte pieces: lanes kPPR apart take consecutive rows, the lanes
      // of a row its consecutive pieces
      const int piece = lane % kPPR;
      const int n = n0 + c0 + piece * kPE;
#pragma unroll
      for (int rr0 = 0; rr0 < 16; rr0 += kRPP) {
        const int rr = rr0 + lane / kPPR;
        const int64_t base = __shfl_sync(0xffffffffu, rowbase, rr);
        if (base < 0 || n >= n4) continue;
        const unsigned char* src =
            stage + rr * (REQUANT ? kStagePitch8 : kStagePitch) + piece * 16;
        if (vec_o) {  // the piece lies in one parity's contiguous run
          const int u = n / (2 * cout), rem = n - u * 2 * cout;
          unsigned char* dst = static_cast<unsigned char*>(outv) +
                               (base + u * urow + rem) * (REQUANT ? 1 : 2);
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int j = 0; j < kPE && n + j < n4; ++j) {
            const int u = (n + j) / (2 * cout), rem = n + j - u * 2 * cout;
            const int64_t o = base + u * urow + rem;
            if constexpr (REQUANT)
              static_cast<int8_t*>(outv)[o] = reinterpret_cast<const int8_t*>(src)[j];
            else
              static_cast<__nv_bfloat16*>(outv)[o] =
                  reinterpret_cast<const __nv_bfloat16*>(src)[j];
          }
        }
      }
      __syncwarp();
    }
  };

  // stages run over (tile, chunk), the block's tiles gridDim.x apart, each
  // tile's chunks in turn. Two stages: the next (tile, chunk) is copied
  // while this one is computed. One block barrier per stage: after it, this
  // stage has landed for every thread, and every warp is done with the
  // last one, whose buffer the next copy takes. (One stage buffer: copy,
  // then compute, then a barrier.)
  int64_t t = blockIdx.x;
  int ch = 0;
  const int64_t step = gridDim.x;
  if (stages == 2) {
    fill(t, 0, 0);
    cp_async_commit();
  }
  for (int it = 0; t < tiles; ++it) {
    const int st = stages == 2 ? (it & 1) : 0;
    if (stages == 1) {
      fill(t, ch, 0);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();
    const int chn = !CHUNKED || ch + 1 == chunks ? 0 : ch + 1;
    const int64_t tn = chn == 0 ? t + step : t;
    if (stages == 2) {
      if (tn < tiles) fill(tn, chn, st ^ 1);
      cp_async_commit();
    }
    const int rows = tile_rows(t);
    if constexpr (REQUANT) {
      convert(st, rows);
    }
    compute(reinterpret_cast<const __nv_bfloat16*>(
                smem + L.off_a + (REQUANT ? 0 : st * L.a_buf)),
            b_of(st), t * kBM, rows, ch);
    if (stages == 1) __syncthreads();  // before the next fill overwrites the buffer
    t = tn;
    ch = chn;
  }
}

}  // namespace

cudaError_t up2x2_igemm_bf16(const void* x, const float* s_in, const void* w,
                             const float* e0, const float* e1, void* out,
                             int64_t n, int64_t h, int64_t wd, int cin,
                             int cout, bool requant, int relu, cudaStream_t stream) {
  const int kp = (cin + 15) / 16 * 16;
  const int n4 = 4 * cout;
  int ns = (n4 + kNC - 1) / kNC * kNC;
  int stages = 2, kc = kp, chunks = 1;
  int dev = 0, max_smem = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  // wide configs: slabs of columns, then K in chunks (float; ns is kNC by
  // then) or one A buffer (requant)
  while (carve(kc, ns, stages, requant, cin, chunks > 1).total > max_smem) {
    if (ns > kNC) {
      ns = (ns / 2 + kNC - 1) / kNC * kNC;
    } else if (!requant && chunks == 1) {
      kc = kKChunk;
      chunks = (kp + kc - 1) / kc;
    } else if (stages == 2) {
      stages = 1;
    } else {
      return cudaErrorInvalidValue;
    }
  }
  const int smem = carve(kc, ns, stages, requant, cin, chunks > 1).total;
  const int slabs = (n4 + ns - 1) / ns;
  const void* kernel = requant      ? (const void*)upgemm_kernel<true, false>
                       : chunks > 1 ? (const void*)upgemm_kernel<false, true>
                                    : (const void*)upgemm_kernel<false, false>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t npix = n * h * wd;
  const int64_t tiles = (npix + kBM - 1) / kBM;
  if (tiles * chunks > INT32_MAX) return cudaErrorInvalidValue;
  const int64_t resident = (int64_t)per_sm * sms / slabs;
  const int64_t blocks = tiles < resident ? tiles : (resident > 0 ? resident : 1);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  const int vec_x = xa % 16 == 0 && (requant || cin % 8 == 0);
  const int vec_w = reinterpret_cast<uintptr_t>(w) % 16 == 0 && cout % 8 == 0;
  const int vec_o = oa % 16 == 0 && cout % (requant ? 8 : 4) == 0;
  dim3 grid((unsigned)blocks, (unsigned)slabs, 1);
  const auto* wt = static_cast<const __nv_bfloat16*>(w);
  if (requant)
    upgemm_kernel<true, false><<<grid, kThreads, smem, stream>>>(
        x, s_in, wt, e0, e1, out, npix, h, wd, cin, cout, kc, chunks, ns, stages, vec_x,
        vec_w, vec_o, 0);
  else if (chunks > 1)
    upgemm_kernel<false, true><<<grid, kThreads, smem, stream>>>(
        x, nullptr, wt, e0, nullptr, out, npix, h, wd, cin, cout, kc, chunks, ns, stages,
        vec_x, vec_w, vec_o, relu);
  else
    upgemm_kernel<false, false><<<grid, kThreads, smem, stream>>>(
        x, nullptr, wt, e0, nullptr, out, npix, h, wd, cin, cout, kc, chunks, ns, stages,
        vec_x, vec_w, vec_o, relu);
  return cudaGetLastError();
}

}  // namespace annonet
