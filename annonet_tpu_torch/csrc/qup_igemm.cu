// Q3: the int8 2x2 stride-2 transpose conv + requant of the quantized
// segmentation net (its up layers under quantize_up), as a GEMM on the
// int8 tensor cores.
//
// Replaces the Pallas TPU kernel
//   annonet_tpu/ops/int8_conv_mosaic.py:294 qup_requant (pallas_call at
//   :330, kernel body _qup_kernel at :280),
// which works on the width-folded layout (8 pixels x 16 channels in 128
// lanes) as one tap GEMM per output-row parity; this one runs the plain
// NHWC geometry.
//
// What it computes. out[img, 2i+u, 2j+v, co] = requant_v(x[img, i, j, :] .
// w_q[1-u, 1-v, :, co]) with
//   q = int8(trunc(clip(fma(float(acc), scale[v, co], offset[v, co]), 0, 127)))
// (one singly rounded FMA, as XLA contracts it; the weight scales are per
// output column parity v and channel, models/quantized.py
// quantize_up_layer). Integer sums are exact in any order, so it equals
// ops/qconv.py's qup2x2_requant_plain bit for bit.
//
// As up_igemm.cu's K3 (bf16), it is C = A . B with
//   A [M input pixels in N*H*W order, K = cin zero-padded to kp = 32k],
//   B [kp, 4 cout], column (2u + v) * cout + co holding w_q[1-u, 1-v, :, co].
// In NHWC the 2 cout columns of parity u of pixel (i, j) are exactly the
// contiguous out[img, 2i+u, 2j:2j+2, :], so the rows need no interleave.
//
// What bounds it on an H100. On the flagship's 25-tile 872^2 batch (bytes
// = int8 input + output once, bound = bytes / 3.35 TB/s):
//
//   layer      x -> cout                  bytes MB  bound ms
//   dec3/up    [25,109,109,128] -> 64      114       0.034
//   dec2/up    [25,218,218,64]  -> 32      228       0.068
//   dec1/up    [25,436,436,32]  -> 16      456       0.136
//
// A pixel's 2 * cin * 4 cout operations over its cin + 4 cout bytes are
// 43-171 operations a byte, far under the int8 tensor cores' ridge (1,979
// TOP/s over 3.35 TB/s, ~590 a byte): the layers are bound by bytes, and
// the copies, the requant of every output byte and the stores pace the
// kernel, not the products.
//
// Design: K3's persistent GEMM with Q1's int8 machinery
// (qconv_igemm.cu), and nothing of the __dp4a direct convolution it
// replaces. Persistent blocks of 8 warps walk tiles of 128 consecutive
// input pixels (a tile may cross image rows: the epilogue computes each
// pixel's output rows). B comes packed once per layer
// (ops/qconv.py pack_q3_weights: [4 cout][kp], each column's K contiguous,
// since ldmatrix.trans cannot transpose bytes) and is staged in shared
// memory once per block by cp.async, rows padded to kp + 16 bytes (an odd
// number of 16-byte units: ldmatrix conflict-free), with the per-column
// scale and offset. A tile's input is one contiguous span of raw int8
// rows, copied in 16-byte cp.async pieces into rows of the same padded
// pitch (byte gathers into zero-padded pieces where cin is no multiple of
// 16), double-buffered: the next tile's copy runs under the current tile's
// products and stores, with one block barrier per tile. No conversion on
// the way in: the int8 rows are the m16n8k32 A operand as they stand.
// Each warp owns 16 pixels (one m16 row tile) and walks the columns 64 at
// a time: A by ldmatrix.x4 (an int8 m16n8k32 A fragment has the bytes of a
// bf16 m16n8k16 one), B by plain ldmatrix.x4, int8 mma.sync m16n8k32 with
// int32 accumulation. The epilogue requantizes each sum after the
// fragment's (row, column) mapping (by __int2float_rn and __float2int_rz;
// magic-number conversions and 32-bit index divisions were no faster on
// the H100, PERF.md), stages the warp's rows in shared memory,
// and lanes store 16 bytes each, neighbouring lanes on neighbouring
// addresses (byte by byte where cout is no multiple of 8, so that a
// 16-byte piece would straddle two output rows). Where B and two A buffers
// do not fit in shared memory (configs far wider than the flagship), the
// columns split into slabs over grid.y (each slab reads A again), then A
// falls to one buffer (cin above 672); above cin 1120 even that does not
// fit, and the launcher refuses. Offsets are 64-bit.
//
// mma.sync and not wgmma: at tens of operations a byte a warp's 16 x 64 x
// kp products are a few instructions per KiB of output.

#include "common.cuh"

namespace annonet {
namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 16 * kWarps;       // input pixels a tile: 16 a warp
constexpr int kNC = 64;                // output columns a warp pass: 8 n8 tiles
constexpr int kStagePitch = kNC + 16;  // bytes of a staged output row

// the dynamic shared memory's carve-up, the same on the host (to size the
// launch) and on the device
struct Smem {
  int pitch;  // bytes of an A or B row: kp + 16
  int a_buf;  // bytes of one A buffer
  int off_a, off_b, off_stage, off_epi, total;
};

__host__ __device__ inline Smem carve(int kp, int ns, int stages) {
  Smem s;
  s.pitch = kp + 16;
  s.a_buf = kBM * s.pitch;
  int o = 0;
  s.off_a = o;
  o += stages * s.a_buf;
  s.off_b = o;
  o += ns * s.pitch;
  s.off_stage = o;
  o += kWarps * 16 * kStagePitch;
  s.off_epi = o;
  o += 2 * ns * 4;
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int32_t* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The requant of one int32 sum, as an unsigned byte: int8(trunc(clip(
// fma(float(acc), scale, offset), 0, 127))).
__device__ __forceinline__ uint32_t requant_byte(int32_t acc, float scale,
                                                 float offset) {
  const float f = fminf(fmaxf(__fmaf_rn(__int2float_rn(acc), scale, offset), 0.f), 127.f);
  return (uint32_t)__float2int_rz(f);
}

// Columns n0 .. n0 + ns - 1 of B (this block's slab, blockIdx.y); ns is a
// multiple of kNC, kp of 32.
__global__ void __launch_bounds__(kThreads, 2)
qup_igemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wp,
                 const float* __restrict__ scale, const float* __restrict__ offset,
                 int8_t* __restrict__ out, int64_t npix, int64_t h, int64_t wd,
                 int cin, int cout, int kp, int ns, int stages, int vec_x,
                 int vec_o) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L = carve(kp, ns, stages);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n4 = 4 * cout, n0 = blockIdx.y * ns;
  const int64_t tiles = (npix + kBM - 1) / kBM;
  unsigned char* bs = smem + L.off_b;
  float* epi = reinterpret_cast<float*>(smem + L.off_epi);  // [2][ns]
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const int pieces = kp / 16;  // 16-byte pieces of a row

  // B: rows n0 + n of the packed [4 cout][kp], zero past 4 cout. They land
  // with the first tile's commit group.
  for (int e = tid; e < ns * pieces; e += kThreads) {
    const int n = e / pieces, c = (e - n * pieces) * 16;
    unsigned char* dst = bs + n * L.pitch + c;
    if (n0 + n < n4)
      cp_async16(dst, wp + (int64_t)(n0 + n) * kp + c);
    else
      *reinterpret_cast<uint4*>(dst) = zero;
  }
  // column (2u + v) * cout + co requantizes with scale[v][co], offset[v][co]
  for (int n = tid; n < ns; n += kThreads) {
    const int col = n0 + n, rem = col % (2 * cout);
    epi[n] = col < n4 ? scale[rem] : 0.f;
    epi[ns + n] = col < n4 ? offset[rem] : 0.f;
  }

  auto tile_rows = [&](int64_t t) {
    const int64_t left = npix - t * kBM;
    return left < kBM ? (int)left : kBM;
  };

  // copies tile t's rows into A buffer st. Bytes past cin in a row, and
  // rows past the tile's end, are left as they are: B is zero past cin, so
  // they add nothing, and no output of a row past the end is stored.
  auto fill = [&](int64_t t, int st) {
    const int rows = tile_rows(t);
    const int8_t* src = x + t * kBM * cin;
    unsigned char* a = smem + L.off_a + st * L.a_buf;
    if (vec_x) {  // whole 16-byte pieces: the span is rows * cin bytes
      const int per_row = cin / 16;
      for (int e = tid; e < rows * per_row; e += kThreads) {
        const int p = e / per_row, c = (e - p * per_row) * 16;
        cp_async16(a + p * L.pitch + c, src + (int64_t)p * cin + c);
      }
    } else {  // byte gathers into zero-padded pieces
      for (int e = tid; e < rows * pieces; e += kThreads) {
        const int p = e / pieces, c = (e - p * pieces) * 16;
        uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (c + j < cin) v[j >> 2] |= (uint32_t)(uint8_t)src[(int64_t)p * cin + c + j] << (8 * (j & 3));
        *reinterpret_cast<uint4*>(a + p * L.pitch + c) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  };

  // the warp's rows: 16 pixels r0 .. r0 + 15 of the tile
  const int r0 = warp * 16;
  const int g = lane >> 2, tg = lane & 3;
  unsigned char* stage = smem + L.off_stage + warp * 16 * kStagePitch;
  // this lane's ldmatrix row of B: column (lane / 16) * 8 + lane % 8 of a
  // 16-column group, bytes ((lane / 8) % 2) * 16 of the k32 step: registers
  // 0-1 are the (b0, b1) of one n8 tile, 2-3 of the next
  const uint32_t b_lane =
      smem_addr(bs + ((lane >> 4) * 8 + (lane & 7)) * L.pitch + ((lane >> 3) & 1) * 16);
  const int64_t urow = 2 * wd * cout;  // one output row: parity u = 1 is + urow
  constexpr int kPPR = kNC / 16;       // 16-byte pieces of a staged row
  constexpr int kRPP = 32 / kPPR;      // staged rows a warp stores at once

  auto compute = [&](const unsigned char* a, int64_t p0, int rows) {
    if (r0 >= rows) return;
    // lane l < 16: the output offset of pixel r0 + l at parity u = 0
    int64_t rowbase = -1;
    if (lane < 16 && r0 + lane < rows) {
      const int64_t p = p0 + r0 + lane;
      const int64_t q = p / wd, img = q / h, iy = q - img * h, jx = p - q * wd;
      rowbase = ((img * 2 * h + 2 * iy) * 2 * wd + 2 * jx) * cout;
    }
    // bytes 0-15 of the fragment from rows 0-15 (lanes 0-15), 16-31 from
    // the same rows (lanes 16-31)
    const uint32_t a_lane = smem_addr(a + (r0 + (lane & 15)) * L.pitch + (lane >> 4) * 16);
    for (int c0 = 0; c0 < ns && n0 + c0 < n4; c0 += kNC) {
      int32_t acc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = 0;
      // a k-step's fragments are all loaded before its 8 products
      for (int k0 = 0; k0 < kp; k0 += 32) {
        uint32_t af[4], bf[4][4];
        ldmatrix_x4(af, a_lane + k0);
#pragma unroll
        for (int np = 0; np < 4; ++np)
          ldmatrix_x4(bf[np], b_lane + (c0 + np * 16) * L.pitch + k0);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          mma_s8(acc[2 * np], af, &bf[np][0]);
          mma_s8(acc[2 * np + 1], af, &bf[np][2]);
        }
      }
      // requantize into the warp's staging tile: rows g and g + 8,
      // columns nt * 8 + 2 tg and + 1
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = nt * 8 + 2 * tg, n = c0 + col;
        const float s0 = epi[n], s1 = epi[n + 1], f0 = epi[ns + n], f1 = epi[ns + n + 1];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int32_t* c = &acc[nt][2 * half];
          const uint32_t q = requant_byte(c[0], s0, f0) |
                             requant_byte(c[1], s1, f1) << 8;
          *reinterpret_cast<uint16_t*>(stage + (g + 8 * half) * kStagePitch + col) =
              (uint16_t)q;
        }
      }
      __syncwarp();
      // 16-byte pieces: lanes kPPR apart take consecutive rows, the lanes
      // of a row its consecutive pieces
      const int piece = lane % kPPR;
      const int n = n0 + c0 + piece * 16;
#pragma unroll
      for (int rr0 = 0; rr0 < 16; rr0 += kRPP) {
        const int rr = rr0 + lane / kPPR;
        const int64_t base = __shfl_sync(0xffffffffu, rowbase, rr);
        if (base < 0 || n >= n4) continue;
        const unsigned char* src = stage + rr * kStagePitch + piece * 16;
        if (vec_o) {  // the piece lies in one parity's contiguous run
          const int u = n / (2 * cout), rem = n - u * 2 * cout;
          *reinterpret_cast<uint4*>(out + base + u * urow + rem) =
              *reinterpret_cast<const uint4*>(src);
        } else {
          for (int j = 0; j < 16 && n + j < n4; ++j) {
            const int u = (n + j) / (2 * cout), rem = n + j - u * 2 * cout;
            out[base + u * urow + rem] = (int8_t)src[j];
          }
        }
      }
      __syncwarp();
    }
  };

  // two stages: tile t + step is copied while tile t is computed. One
  // block barrier per tile: after it, tile t has landed for every thread,
  // and every warp is done with tile t - step, whose buffer the next copy
  // takes. (One stage: copy, then compute, then a barrier.)
  int64_t t = blockIdx.x;
  const int64_t step = gridDim.x;
  if (stages == 2) {
    fill(t, 0);
    cp_async_commit();
  }
  for (int it = 0; t < tiles; t += step, ++it) {
    const int st = stages == 2 ? (it & 1) : 0;
    if (stages == 1) {
      fill(t, 0);
      cp_async_commit();
    }
    cp_async_wait_all();
    __syncthreads();
    if (stages == 2) {
      if (t + step < tiles) fill(t + step, st ^ 1);
      cp_async_commit();
    }
    compute(smem + L.off_a + st * L.a_buf, t * kBM, tile_rows(t));
    if (stages == 1) __syncthreads();  // before the next fill overwrites the buffer
  }
}

}  // namespace
}  // namespace annonet

// x int8 NHWC [n, h, w, cin]; wp the packed weights [4 cout][kp] (kp = cin
// rounded up to 32; ops/qconv.py pack_q3_weights); scale and offset f32
// [2][cout]; out int8 [n, 2h, 2w, cout]
extern "C" int annonet_qup2x2_requant(const void* x, const void* wp,
                                      const void* scale, const void* offset,
                                      void* out, int64_t n, int64_t h,
                                      int64_t wd, int cin, int cout,
                                      void* stream) {
  using namespace annonet;
  cudaGetLastError();  // report this launch's error only
  if (cin <= 0 || cout <= 0 || reinterpret_cast<uintptr_t>(wp) % 16)
    return (int)cudaErrorInvalidValue;
  const int64_t npix = n * h * wd;
  if (npix == 0) return 0;
  const int kp = (cin + 31) / 32 * 32;
  const int n4 = 4 * cout;
  int ns = (n4 + kNC - 1) / kNC * kNC;
  int stages = 2;
  int dev = 0, max_smem = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // wide configs: slabs of columns, then one A buffer
  while (carve(kp, ns, stages).total > max_smem) {
    if (ns > kNC)
      ns = (ns / 2 + kNC - 1) / kNC * kNC;
    else if (stages == 2)
      stages = 1;
    else
      return (int)cudaErrorInvalidValue;
  }
  const int smem = carve(kp, ns, stages).total;
  const int64_t slabs = (n4 + ns - 1) / ns;
  if (slabs > kMaxGridYZ) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(qup_igemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, qup_igemm_kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t tiles = (npix + kBM - 1) / kBM;
  const int64_t resident = (int64_t)per_sm * sms / slabs;
  const int64_t blocks = tiles < resident ? tiles : (resident > 0 ? resident : 1);
  const int vec_x = cin % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_o = cout % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  dim3 grid((unsigned)blocks, (unsigned)slabs, 1);
  qup_igemm_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wp),
      static_cast<const float*>(scale), static_cast<const float*>(offset),
      static_cast<int8_t*>(out), npix, h, wd, cin, cout, kp, ns, stages, vec_x, vec_o);
  return (int)cudaGetLastError();
}
