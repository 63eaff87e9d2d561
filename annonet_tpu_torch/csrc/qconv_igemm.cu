// Q1 and Q2 and their accumulator modes: the int8 3x3 convs as an implicit
// GEMM on the int8 tensor cores.
//
// Replaces the Pallas TPU kernels
//   annonet_tpu/ops/int8_conv_mosaic.py:673 qconv3x3_s1_requant (pallas_call
//     at :720), with the decoder's concat as a second input x2,
//   annonet_tpu/ops/int8_conv_mosaic.py:222 qconv3x3_s2_requant (pallas_call
//     at :263), stride 2 with XLA SAME padding (0, 1): output o taps inputs
//     2o + d, and
//   scripts/repro_mosaic_s1.py:136 bisect._acc_kernel (pallas_call at :160),
//     the raw int32 accumulator of the TPU diagnostic script (ACC below,
//     stride 1); ACC at stride 2 is the int32 conv of int8 training's
//     stride-2 layers (annonet_tpu/ops/int8_train.py:47, an XLA conv with
//     int32 accumulation; ACC at stride 1 serves its stride-1 layers).
// Q3 (the 2x2 transpose conv) is qup_igemm.cu's GEMM on the same tensor cores.
//
// What it computes: acc[n, o, co] = the exact int32 sum over the 9 taps and
// all input channels of the virtual concat [x (c1), x2 (c2)] of x * w, zero
// padding (1, 1) at stride 1 and (0, 1) at stride 2; then q =
// int8(clip(fma(float(acc), scale[co], offset[co]), 0, 127)), truncating
// (__fmaf_rn, one rounding, as XLA's contracted FMA; ops/qconv.py). ACC
// writes acc itself, int32, instead, at either stride. Integer sums are exact
// in any order, so every mode equals its plain version bit for bit.
//
// What bounds it on an H100. A layer's 2 * 9 * cin operations per output
// channel sit far under the int8 tensor cores' ridge (1,979 TOP/s over
// 3.35 TB/s, ~590 operations a byte): every layer of the flagship is bound
// by its bytes (int8 in, int8 or int32 out).
//
// Design: conv_igemm.cu's implicit GEMM (K1 and K2, bf16) carried over to
// int8. GEMM M = the block's output pixels (8 x 64 at cout <= 32, fewer
// rows or columns for wider slabs), N = cout (a slab of BN = 16, 32, 64 or
// 128 channels, at stride 2 at most 64, grid.y over slabs), K = 9 *
// (c1 + c2), walked channel chunk by channel chunk (32 channels: the k of
// int8 mma.sync m16n8k32) and, inside a chunk, tap by tap. An int8 chunk of
// 32 channels is 32 bytes a pixel, as a bf16 chunk of 16 channels is, so
// the halo patch, its planes of 16-byte pieces (by channel half and, at
// stride 2, by column parity: an ldmatrix phase over 8 output pixels reads
// 8 consecutive pieces at either stride, conflict-free), the cp.async
// double buffering, and the A fragments (ldmatrix.x4: an int8 A fragment of
// m16n8k32 is the bytes of a bf16 one of m16n8k16) are K1's and K2's. Each
// A fragment feeds every (output row, row tap) pair that reads it. A warp
// holds 4 output rows at either stride (K2 holds 2): a stride-2 patch has
// about 4x the input pixels of a stride-1 patch for the same output tile,
// and its copies, not the products, pace the stride-2 layers, so the
// taller tile's smaller halo share and fewer blocks pay (PERF.md).
//
// B. The "col" B operand wants each output channel's K contiguous, and
// ldmatrix.trans transposes 16-bit elements only, so it cannot turn the
// HWIO int8 weights around. The weights come packed once per layer
// (ops/qconv.py pack_q1_weights, the same at either stride):
// [chunk][unit][cout][32 bytes], one k32 step a unit; B fragments are plain
// ldmatrix.x4 from rows padded to 48 bytes (conflict-free).
//
// Layers of at most 16 channels (the RGB stem's 3, stem/conv1's 16 and
// enc1/conv0's 16) fill only half of a k32 step. There (PAIR) the patch
// holds one 16-byte piece a pixel and two row taps share a step: the lanes
// that bring the fragment's bytes 16-31 address the patch row below the
// lanes that bring bytes 0-15, so fragment F(r) holds rows r and r + 1,
// and output row mt, whose row taps start at patch row mt * STRIDE, sums
// F(mt * STRIDE) . [w(dy 0) | w(dy 1)] + F(mt * STRIDE + 2) . [w(dy 2) | 0]
// for each column tap: 6 steps instead of 9, and at stride 1 each fragment
// serves two output rows (at stride 2, F(2 mt + 2) is also F(2 (mt + 1))).
//
// Channels that do not fill whole 16-byte pieces of one input (the stem's
// 3, concats with c1 % 16 != 0) are gathered byte by byte into
// zero-padded pieces; cout that is no multiple of 16 (int8) or 4 (int32)
// is stored byte by byte. The epilogue requantizes after the MMA
// fragment's (row, column) mapping, stages the tile in shared memory and
// stores 16 bytes a thread. Offsets are 64-bit; any N (grid.z chunks of
// kMaxGridYZ images), H and W (even at stride 2), c1 >= 1, c2 >= 0 and
// cout >= 1.

#include "common.cuh"

namespace annonet {
namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBPitch = 48;    // bytes of a B row in shared memory: 32 + 16

template <int STRIDE, int BN, bool PAIR>
struct QShape {
  static constexpr int kNT = BN == 16 ? 2 : 4;       // n8 tiles a warp
  static constexpr int kWN = BN / (8 * kNT);         // warps along N
  static constexpr int kWM = 8 / kWN;                // warps along M
  static constexpr int kMT = 4;                      // m16 tiles (rows) a warp
  static constexpr int kStrips = kWM < 4 ? kWM : 4;  // 16-column strips
  static constexpr int kTW = 16 * kStrips;           // output columns
  static constexpr int kTH = kMT * (kWM / kStrips);  // output rows
  static constexpr int kM = kTH * kTW;               // output pixels
  static constexpr int kPlanes = PAIR ? 1 : 2;       // 16-byte pieces a pixel
  // patch rows (PAIR's upper lanes read one row further) and columns
  static constexpr int kPH = (kTH - 1) * STRIDE + 3 + (PAIR ? 1 : 0);
  static constexpr int kPW = (kTW - 1) * STRIDE + 3;
  static constexpr int kPWS = (kPW + STRIDE - 1) / STRIDE;  // a parity plane
  static constexpr int kABytes = kPlanes * kPH * STRIDE * kPWS * 16;
  static constexpr int kUnits = PAIR ? 6 : 9;        // k32 steps of a chunk
  static constexpr int kBBytes = kUnits * BN * kBPitch;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static_assert(kWN * kWM == 8 && kM == kWM * kMT * 16, "block shape");
};

template <int BN, bool ACC>
struct QOut {
  static constexpr int kElem = ACC ? 4 : 1;             // bytes an element
  static constexpr int kPitch = ACC ? BN + 4 : BN + 16;  // staged row, elements
  static constexpr int kPerPiece = 16 / kElem;          // elements a 16-byte store
};

// the 16-byte piece of channel half ``half`` of patch pixel (row, col):
// planes [half][row][column parity][column / STRIDE]
template <int STRIDE, int BN, bool PAIR>
__device__ __forceinline__ int piece(int half, int row, int col) {
  using S = QShape<STRIDE, BN, PAIR>;
  return ((half * S::kPH + row) * STRIDE + col % STRIDE) * S::kPWS + col / STRIDE;
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

__device__ __forceinline__ void mma_s8(int32_t* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ int8_t requant(int32_t acc, float scale,
                                          float offset) {
  const float f = __fmaf_rn(__int2float_rn(acc), scale, offset);
  return (int8_t)__float2int_rz(fminf(fmaxf(f, 0.f), 127.f));
}

// at least 2 blocks an SM (4 at BN = 16 with paired taps, whose registers
// allow it without spilling), so that one block's copies overlap another's
// products and stores
template <int STRIDE, int BN, bool PAIR, bool ACC>
__global__ void __launch_bounds__(kThreads, BN == 16 && PAIR ? 4 : 2)
q1_igemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ x2,
                const int8_t* __restrict__ wp, const float* __restrict__ scale,
                const float* __restrict__ offset, void* __restrict__ out,
                int64_t h, int64_t wd, int c1, int c2, int cout,
                int64_t tiles_x, int vec_x, int vec_o) {
  using S = QShape<STRIDE, BN, PAIR>;
  using O = QOut<BN, ACC>;
  constexpr int kPad = STRIDE == 1 ? 1 : 0;  // top/left zero padding
  extern __shared__ __align__(16) unsigned char smem[];

  const int cin = c1 + c2;
  const int chunks = PAIR ? 1 : (cin + 31) / 32;
  const int64_t ho = h / STRIDE, wo = wd / STRIDE;
  const int64_t img = blockIdx.z;
  const int64_t oy0 = (int64_t)(blockIdx.x / tiles_x) * S::kTH;
  const int64_t ox0 = (int64_t)(blockIdx.x % tiles_x) * S::kTW;
  const int cob = blockIdx.y * BN;
  const int64_t iy0 = oy0 * STRIDE - kPad, ix0 = ox0 * STRIDE - kPad;
  const int8_t* xi = x + img * h * wd * c1;
  const int8_t* x2i = c2 ? x2 + img * h * wd * c2 : x2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  // copies (or gathers) channel chunk t into stage buffer buf
  auto fill = [&](int t, int buf) {
    unsigned char* base = smem + buf * S::kStageBytes;
    uint4* a = reinterpret_cast<uint4*>(base);
    const int c0 = t * 32;
    for (int e = tid; e < S::kPH * S::kPW * S::kPlanes; e += kThreads) {
      const int half = PAIR ? 0 : (e & 1);
      const int pix = PAIR ? e : (e >> 1);
      const int pr = pix / S::kPW, pc = pix - pr * S::kPW;
      const int64_t iy = iy0 + pr, ix = ix0 + pc;
      const int c = c0 + half * 16;
      uint4* dst = a + piece<STRIDE, BN, PAIR>(half, pr, pc);
      if (iy < 0 || iy >= h || ix < 0 || ix >= wd || c >= cin) {
        *dst = zero;
        continue;
      }
      const int64_t p = iy * wd + ix;
      if (vec_x) {
        cp_async16(dst, c < c1 ? xi + p * c1 + c : x2i + p * c2 + (c - c1));
      } else {
        uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int cj = c + j;
          if (cj < cin) {
            const int8_t b = cj < c1 ? xi[p * c1 + cj] : x2i[p * c2 + (cj - c1)];
            v[j >> 2] |= (uint32_t)(uint8_t)b << (8 * (j & 3));
          }
        }
        *dst = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    // B: [unit][BN rows][32 bytes] of the packed [chunk][unit][cout][32]
    unsigned char* bs = base + S::kABytes;
    for (int e = tid; e < S::kUnits * BN * 2; e += kThreads) {
      const int piece = e & 1, r = e >> 1;
      const int col = r % BN, unit = r / BN;
      const int co = cob + col;
      uint4* dst = reinterpret_cast<uint4*>(bs + (unit * BN + col) * kBPitch + piece * 16);
      if (co >= cout) {
        *dst = zero;
        continue;
      }
      cp_async16(dst, wp + (((int64_t)t * S::kUnits + unit) * cout + co) * 32 + piece * 16);
    }
  };

  // warp tile: output rows ty0 .. ty0 + kMT - 1 of the 16-column strip at
  // tx0 (one m16 tile a row), n8 tiles wn*kNT .. +kNT
  const int wm = warp / S::kWN, wn = warp % S::kWN;
  const int ty0 = wm / S::kStrips * S::kMT, tx0 = wm % S::kStrips * 16;
  const int r16 = lane & 15, hi = lane >> 4;
  // this lane's ldmatrix row, output pixel tx0 + r16 in the warp's first
  // patch row at dx = 0, as a piece index: bytes 16-31 of the fragment come
  // from the second channel plane, or under PAIR from the row below
  const int a_lane = PAIR ? piece<STRIDE, BN, PAIR>(0, ty0 * STRIDE + hi, (tx0 + r16) * STRIDE)
                          : piece<STRIDE, BN, PAIR>(hi, ty0 * STRIDE, (tx0 + r16) * STRIDE);
  // this lane's ldmatrix row of B: n = (lane / 16) * 8 + lane % 8 of the
  // warp's columns, bytes ((lane / 8) % 2) * 16: registers 0-1 are the
  // (b0, b1) of one n8 tile, 2-3 of the next
  const int b_off = (wn * S::kNT * 8 + (lane >> 4) * 8 + (lane & 7)) * kBPitch +
                    ((lane >> 3) & 1) * 16;

  int32_t acc[S::kMT][S::kNT][4];
#pragma unroll
  for (int mt = 0; mt < S::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < S::kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

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
    const uint32_t a_base = smem_addr(base) + a_lane * 16;
    const uint32_t b_base = smem_addr(base + S::kABytes) + b_off;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      if constexpr (PAIR) {
        // units dx*2 (row taps 0 | 1) and dx*2 + 1 (row tap 2 | zero):
        // fragment r serves output row r / STRIDE through the first and
        // output row (r - 2) / STRIDE through the second
        uint32_t b[2][S::kNT][2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int np = 0; np < S::kNT / 2; ++np)
            ldmatrix_x4(&b[j][2 * np][0],
                        b_base + ((dx * 2 + j) * BN + np * 16) * kBPitch);
#pragma unroll
        for (int r = 0; r <= (S::kMT - 1) * STRIDE + 2; ++r) {
          const bool u0 = r % STRIDE == 0 && r / STRIDE < S::kMT;
          const bool u1 = r >= 2 && (r - 2) % STRIDE == 0;
          if (!u0 && !u1) continue;
          // piece(0, r, dx) - piece(0, 0, 0) in the patch
          const int a_off = (r * STRIDE + dx % STRIDE) * S::kPWS + dx / STRIDE;
          uint32_t a[4];
          ldmatrix_x4(a, a_base + a_off * 16);
          if (u0) {
#pragma unroll
            for (int nt = 0; nt < S::kNT; ++nt) mma_s8(acc[r / STRIDE][nt], a, b[0][nt]);
          }
          if (u1) {
#pragma unroll
            for (int nt = 0; nt < S::kNT; ++nt)
              mma_s8(acc[(r - 2) / STRIDE][nt], a, b[1][nt]);
          }
        }
      } else {
        // units dy*3 + dx: the B fragments of the column tap's three row
        // taps, then each patch row r, loaded once and used by every
        // (output row mt, row tap dy) with mt * STRIDE + dy == r
        uint32_t b[3][S::kNT][2];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int np = 0; np < S::kNT / 2; ++np)
            ldmatrix_x4(&b[dy][2 * np][0],
                        b_base + ((dy * 3 + dx) * BN + np * 16) * kBPitch);
#pragma unroll
        for (int r = 0; r <= (S::kMT - 1) * STRIDE + 2; ++r) {
          const int a_off = (r * STRIDE + dx % STRIDE) * S::kPWS + dx / STRIDE;
          uint32_t a[4];
          ldmatrix_x4(a, a_base + a_off * 16);
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const int mt = (r - dy) / STRIDE;
            if (r < dy || (r - dy) % STRIDE || mt >= S::kMT) continue;
#pragma unroll
            for (int nt = 0; nt < S::kNT; ++nt) mma_s8(acc[mt][nt], a, b[dy][nt]);
          }
        }
      }
    }
    __syncthreads();
  }

  // epilogue: requant (or the raw sums), staged as [kM][kPitch]
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int nt = 0; nt < S::kNT; ++nt) {
    const int col = (wn * S::kNT + nt) * 8 + tg * 2;
    float s0 = 0.f, s1 = 0.f, f0 = 0.f, f1 = 0.f;
    if constexpr (!ACC) {
      if (cob + col < cout) s0 = scale[cob + col], f0 = offset[cob + col];
      if (cob + col + 1 < cout) s1 = scale[cob + col + 1], f1 = offset[cob + col + 1];
    }
#pragma unroll
    for (int mt = 0; mt < S::kMT; ++mt) {
      // staged pixel of m16 row g: output row ty0 + mt, column tx0 + g
      const int row = (ty0 + mt) * S::kTW + tx0 + g;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int32_t* c = &acc[mt][nt][2 * half];
        const int at = (row + 8 * half) * O::kPitch + col;
        if constexpr (ACC) {
          *reinterpret_cast<int2*>(reinterpret_cast<int32_t*>(smem) + at) =
              make_int2(c[0], c[1]);
        } else {
          const uint32_t q0 = (uint8_t)requant(c[0], s0, f0);
          const uint32_t q1 = (uint8_t)requant(c[1], s1, f1);
          *reinterpret_cast<uint16_t*>(smem + at) = (uint16_t)(q0 | q1 << 8);
        }
      }
    }
  }
  __syncthreads();
  constexpr int kPieces = BN / O::kPerPiece;  // 16-byte pieces of a staged row
  const int ncols = min(BN, cout - cob);
  for (int e = tid; e < S::kM * kPieces; e += kThreads) {
    const int p = e / kPieces, col = (e % kPieces) * O::kPerPiece;
    const int64_t oy = oy0 + p / S::kTW, ox = ox0 + p % S::kTW;
    if (oy >= ho || ox >= wo || col >= ncols) continue;
    const int64_t o = ((img * ho + oy) * wo + ox) * cout + cob + col;  // elements
    unsigned char* dst = static_cast<unsigned char*>(out) + o * O::kElem;
    const unsigned char* src = smem + (p * O::kPitch + col) * O::kElem;
    if (vec_o) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int j = 0; j < O::kPerPiece && col + j < ncols; ++j)
        for (int k = 0; k < O::kElem; ++k) dst[j * O::kElem + k] = src[j * O::kElem + k];
    }
  }
}

template <int STRIDE, int BN, bool PAIR, bool ACC>
cudaError_t launch(const int8_t* x, const int8_t* x2, const int8_t* wp,
                   const float* scale, const float* offset, void* out,
                   int64_t n, int64_t h, int64_t wd, int c1, int c2, int cout,
                   cudaStream_t stream) {
  using S = QShape<STRIDE, BN, PAIR>;
  using O = QOut<BN, ACC>;
  auto kernel = q1_igemm_kernel<STRIDE, BN, PAIR, ACC>;
  const int chunks = PAIR ? 1 : (c1 + c2 + 31) / 32;
  const int stage = (chunks > 1 ? 2 : 1) * S::kStageBytes;
  const int staged = S::kM * O::kPitch * O::kElem;
  const int smem = stage > staged ? stage : staged;
  // above 48 KB of dynamic shared memory a kernel needs the opt-in
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int64_t ho = h / STRIDE, wo = wd / STRIDE;
  const int64_t tiles_x = (wo + S::kTW - 1) / S::kTW;
  const int64_t tiles = tiles_x * ((ho + S::kTH - 1) / S::kTH);
  const int64_t slabs = (cout + BN - 1) / BN;
  if (tiles > INT32_MAX || slabs > kMaxGridYZ) return cudaErrorInvalidValue;
  const int vec_x = c1 % 16 == 0 && c2 % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(x2) % 16 == 0;
  const int vec_o = cout % O::kPerPiece == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  for (int64_t n0 = 0; n0 < n; n0 += kMaxGridYZ) {
    const int64_t nb = n - n0 < kMaxGridYZ ? n - n0 : kMaxGridYZ;
    dim3 grid((unsigned)tiles, (unsigned)slabs, (unsigned)nb);
    kernel<<<grid, kThreads, smem, stream>>>(
        x + n0 * h * wd * c1, c2 ? x2 + n0 * h * wd * c2 : x2, wp, scale, offset,
        static_cast<unsigned char*>(out) + n0 * ho * wo * cout * O::kElem, h, wd,
        c1, c2, cout, tiles_x, vec_x, vec_o);
  }
  return cudaGetLastError();
}

template <int STRIDE, bool PAIR, bool ACC>
cudaError_t dispatch(const int8_t* x, const int8_t* x2, const int8_t* wp,
                     const float* sc, const float* of, void* out, int64_t n,
                     int64_t h, int64_t wd, int c1, int c2, int cout,
                     cudaStream_t s) {
  if (cout <= 16)
    return launch<STRIDE, 16, PAIR, ACC>(x, x2, wp, sc, of, out, n, h, wd, c1, c2, cout, s);
  if (cout <= 32)
    return launch<STRIDE, 32, PAIR, ACC>(x, x2, wp, sc, of, out, n, h, wd, c1, c2, cout, s);
  // at stride 2 a 128-channel slab's two stages would leave one block an
  // SM: wider layers run in slabs of 64
  if constexpr (STRIDE == 2)
    return launch<STRIDE, 64, PAIR, ACC>(x, x2, wp, sc, of, out, n, h, wd, c1, c2, cout, s);
  else if (cout <= 64)
    return launch<STRIDE, 64, PAIR, ACC>(x, x2, wp, sc, of, out, n, h, wd, c1, c2, cout, s);
  else
    return launch<STRIDE, 128, PAIR, ACC>(x, x2, wp, sc, of, out, n, h, wd, c1, c2, cout, s);
}

}  // namespace
}  // namespace annonet

// x, x2 (null when c2 == 0) int8 NHWC; wp the packed weights
// [chunks][units][cout][32] (units 6 when c1 + c2 <= 16, else 9); acc != 0
// writes the int32 sums (scale and offset unused), else the requantized int8
extern "C" int annonet_q1_igemm(const void* x, const void* x2, const void* wp,
                                const void* scale, const void* offset, void* out,
                                int64_t n, int64_t h, int64_t wd, int c1, int c2,
                                int cout, int acc, void* stream) {
  using namespace annonet;
  cudaGetLastError();  // report this launch's error only
  if (cout <= 0 || c1 <= 0 || c2 < 0 || reinterpret_cast<uintptr_t>(wp) % 16)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || h == 0 || wd == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xt = static_cast<const int8_t*>(x);
  const auto* x2t = static_cast<const int8_t*>(x2);
  const auto* wt = static_cast<const int8_t*>(wp);
  const auto* sc = static_cast<const float*>(scale);
  const auto* of = static_cast<const float*>(offset);
  const bool pair = c1 + c2 <= 16;
  cudaError_t e;
  if (acc)
    e = pair ? dispatch<1, true, true>(xt, x2t, wt, sc, of, out, n, h, wd, c1, c2, cout, s)
             : dispatch<1, false, true>(xt, x2t, wt, sc, of, out, n, h, wd, c1, c2, cout, s);
  else
    e = pair ? dispatch<1, true, false>(xt, x2t, wt, sc, of, out, n, h, wd, c1, c2, cout, s)
             : dispatch<1, false, false>(xt, x2t, wt, sc, of, out, n, h, wd, c1, c2, cout, s);
  return (int)e;
}

// Q2: x int8 NHWC [n, h, w, cin] with even h and w; wp the packed weights
// as for Q1 (pack_q1_weights); out [n, h / 2, w / 2, cout]: acc != 0
// writes the int32 sums (scale and offset unused), else the requantized int8
extern "C" int annonet_q2_igemm(const void* x, const void* wp, const void* scale,
                                const void* offset, void* out, int64_t n, int64_t h,
                                int64_t wd, int cin, int cout, int acc, void* stream) {
  using namespace annonet;
  cudaGetLastError();  // report this launch's error only
  if (cout <= 0 || cin <= 0 || reinterpret_cast<uintptr_t>(wp) % 16)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || h / 2 == 0 || wd / 2 == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xt = static_cast<const int8_t*>(x);
  const auto* wt = static_cast<const int8_t*>(wp);
  const auto* sc = static_cast<const float*>(scale);
  const auto* of = static_cast<const float*>(offset);
  const bool pair = cin <= 16;
  cudaError_t e;
  if (acc)
    e = pair ? dispatch<2, true, true>(xt, nullptr, wt, sc, of, out, n, h, wd, cin, 0, cout, s)
             : dispatch<2, false, true>(xt, nullptr, wt, sc, of, out, n, h, wd, cin, 0, cout, s);
  else
    e = pair ? dispatch<2, true, false>(xt, nullptr, wt, sc, of, out, n, h, wd, cin, 0, cout, s)
             : dispatch<2, false, false>(xt, nullptr, wt, sc, of, out, n, h, wd, cin, 0, cout, s);
  return (int)e;
}
