// G1: the folded stride-1 3x3 conv + bias + ReLU as three GEMMs.
//
// Replaces the Pallas TPU kernel annonet_tpu/ops/pallas_conv.py:137
// conv3x3_gemm_aligned (pallas_call at :164), the s1p layers of the folded
// net (models/folded_runtime.py, ``use_pallas_conv``).
//
// What it computes. x is [N, H, WB, K1] with K1 = fold*cin (fold pixels of
// one width block side by side in the channel dim); Wc, Wl, Wr are
// [3*K1, NC] with NC = fold*cout, in x's dtype; bias is [cout] f32, column
// j*cout + co taking bias[co]. With P_dy[n,h,b] = x[n, h+dy-1, b, :] (zero
// outside 0..H-1):
//   out[n,h,b,:] = relu(bias + sum_dy P_dy[b] . Wc_dy + P_dy[b-1] . Wl_dy
//                                  + P_dy[b+1] . Wr_dy)
// with the b-1 term zero at b = 0 and the b+1 term zero at b = WB-1. That
// is one GEMM of M = N*H*WB rows by NC columns over K = 9*K1, whose A row
// (segment s, dy; channel c) is x at the row shifted by dy-1 and the block
// shifted by 0, -1, +1 for Wc, Wl, Wr. It holds for any weights.
//
// What bounds the bf16 kernel on an H100. The folded weights are block-banded
// (build_gemm_kernels_aligned): output pixel j of a block reads input
// pixels j-1..j+1 only, and Wl and Wr hold one nonzero pixel block each, so
// only about 1/fold of the dense GEMM's 2*M*NC*9*K1 operations multiply
// nonzero weights. What remains is 100-300 operations a byte, at or under
// the ~295 where bf16 tensor cores stop waiting on memory: by its bytes,
// most layers are bound by memory. The first version multiplied every
// zero (fold times the work, 8x at the stem and dec1) in a two-stage
// mainloop without ldmatrix, at half of cuBLAS's rate on the same dense
// GEMMs and 2.3x slower than cuDNN's unfolded conv. This one takes about
// 5x its bound over the flagship's layers, 0.8x cuDNN's unfolded conv:
// with the copies or the products switched off, the two parts add up
// rather than overlap, and neither fewer bytes (one A chunk for all three
// matrices, B of the listed slabs only), more stages, more blocks an SM nor
// fewer block barriers changed the total (PERF.md).
//
// Design (bf16). (a) Skip what is zero, exactly: the wrapper passes a
// table, built on the host once per weight set (ops/gemm_conv.py
// g1_block_table), that lists for each group of 128 output columns the K
// chunks (segment, dy, 32 rows of K1) whose weights hold any nonzero in
// that group, each with a mask of the group's four 32-column slabs that
// do. A block (128 rows x 128 columns, 8 warps) walks its group's list:
// it copies each listed chunk of A once and every warp whose slab the
// mask names multiplies it; a slab whose block of the chunk is all zero
// contributes exactly zero, so the skip changes no sum and the result
// holds for any weights (dense weights list every chunk with a full mask).
// Warps split the block as 4 slabs x 2 row halves, so one A chunk in
// shared memory feeds every slab that needs it. (b) The mainloop: a ring
// of 4 cp.async stages (A rows of the shifted input, out-of-range rows and
// blocks as zero-fill copies; B the chunk's 32 weight rows), fragments by ldmatrix (A) and ldmatrix.trans (B) from
// rows padded by 8 elements (conflict-free), bf16 mma.sync m16n8k16 with
// f32 accumulation, each B fragment used by 4 m16 tiles. The epilogue adds
// the f32 bias, applies ReLU, rounds once, stages the tile in shared
// memory and stores 16 bytes a thread. K1 need not be a multiple of 32 (the
// RGB stem's 24: the chunk's missing rows are zero-filled); where K1 or NC
// is no multiple of 8 the copies are element by element.
//
// f32 (gemm_conv_f32): f32 FMAs on the CUDA cores, no TF32 (the f32 configs
// check the arithmetic to 1e-4 of scale). Its table (ops/gemm_conv.py
// _f32_table) lists 16-row K chunks by 16-column slabs: at fold 8 a block
// of a 16-channel layer is one input pixel by one output pixel, so on the
// flagship's layers but the RGB stem the table lists exactly the conv's
// products (at the stem, K1 = 24, a chunk spans 5.3 pixels: 38.3 GFLOP
// listed for the conv's 16.4). Over the 25-tile 872^2 batch of a 4096^2
// image the table lists 826.7 GFLOP (32 x 32 blocks would list 1116.9,
// the dense GEMM 3810.4) for the conv's 804.8; the bound is 12.20 ms: the
// six layers with 16 or more input channels at 67 TFLOP/s (26 to 192 FLOP
// a byte, above the card's f32 line of 20 FLOP/B), the stem by its bytes.
// What the design does about it:
// (a) Every warp busy at every step. At fold 8 a 16-row chunk holds
//     weights for 3 of the 8 slabs, so the bf16 kernel's walk (all warps
//     on one chunk) would leave 5 of 8 warps idle. Here a warp owns a slab
//     and walks its own blocks over a staged span of A: a stage copies the
//     A rows of one row tap dy and 128 K rows (the block's 128 GEMM rows and
//     one more at each end) once, and Wc, Wl and Wr read them shifted by
//     0, -1 and +1 row; in each of the stage's steps every warp multiplies
//     one block of its own slab. At each row tap each slab of the
//     flagship's layers holds the same number of blocks (3 at fold 8, 6 at
//     fold 4, 12 at fold 2; the decoder's 256 K rows split into its up and
//     skip halves, 128 rows a span), so no warp waits in a step (the host
//     pads a short slab with empty steps). The b-1 term at b = 0 and the
//     b+1 term at b = WB-1 read rows of the neighbouring image row: those
//     A values are selected to zero in registers (Wl and Wr blocks only).
// (b) Register tile: 8 rows x 8 columns a thread, 64 f32 accumulators; a
//     warp is 16 row groups x 2 column halves of 128 rows x 16 columns. For
//     each 4 K rows a thread loads its 8 rows' 4-value pieces and 2 pieces
//     of B for each K row, 16 16-byte shared loads for 256 FMAs.
// (c) Staging by 16-byte cp.async: A double-buffered by stage (the next
//     stage's copy is issued at this stage's first step and lands under
//     its FMAs), B in a ring of 3 blocks per warp, filled two steps ahead
//     by the warp itself, so a step needs only a warp barrier and a stage
//     one block barrier. A stage copies whole rows, 512 contiguous bytes a
//     warp (32 / pieces rows a warp where a span is narrower). Rows outside
//     the image (row padding), past the ends and K rows past K1 are
//     zero-fill copies. One block an SM (162 KB of shared memory, at most
//     255 registers; 167 used, no spill): two blocks an SM with one A
//     buffer ran 5% faster but spilled 40 bytes at 128 registers.
// (d) Banks: A rows are 132 floats apart (128 + 4), so the 4 row groups of a
//     quarter warp (adjacent rows) read 16-byte pieces in 4 distinct bank
//     groups, and the 2 column halves of a row group read the same piece (a
//     broadcast); B's 2 pieces a K row are read by every row group alike.
// (e) Edges: element-by-element A copies where K1 % 4 != 0 or x is not
//     16-byte aligned, B copies and output stores where NC % 4 != 0 or a
//     weight or the output is not; K1 24 (the RGB stem) and 12 fill half
//     or less of a chunk (its missing rows are zero); NC past a multiple of
//     128 runs a second group (grid.y); any N, H and WB (WB = 1: the
//     neighbour terms vanish), 64-bit offsets. A table whose header (K1,
//     NC, groups) is not the call's is not walked: the outputs are NaN.
// On an H100 (700 W) the flagship's 7 layers take about 29.4 ms over the
// 25-tile batch, 42% of the bound and 0.56x cuDNN's f32 conv of the same
// layers: about half the f32 peak at fold 2, 37-40% at fold 8, where a
// stage has 3 steps and its copy and barrier weigh most (PERF.md).
//
// Numerics: f32 accumulation, + f32 bias, ReLU, one rounding to x's dtype,
// as the Pallas kernel does.

#include "common.cuh"

namespace annonet {
namespace {

constexpr int kThreads = 256;

// the source pixel of GEMM row m for (dy, db), or -1 outside the image
struct ARow {
  int64_t m;  // -1 past the last row
  int h, b;
};

__device__ __forceinline__ ARow a_row(int64_t m, int64_t rows, int h, int wb) {
  ARow r;
  if (m >= rows) {
    r.m = -1;
    r.h = r.b = 0;
    return r;
  }
  r.m = m;
  r.b = (int)(m % wb);
  r.h = (int)((m / wb) % h);
  return r;
}

__device__ __forceinline__ int64_t a_src(const ARow& r, int dy, int db, int h,
                                         int wb) {
  const int hh = r.h + dy - 1, bb = r.b + db;
  if (r.m < 0 || hh < 0 || hh >= h || bb < 0 || bb >= wb) return -1;
  return r.m + (int64_t)(dy - 1) * wb + db;
}

// segment s in {0: Wc, 1: Wl, 2: Wr}: the block shift of its A rows
__device__ __forceinline__ int seg_db(int s) { return s == 0 ? 0 : (s == 1 ? -1 : 1); }

// ----------------------------------------------------------------- bf16

// block: kBM rows x kGN columns (one group); slabs of kSlab columns, K
// chunks of kKC rows; ops/gemm_conv.py builds the table with the same sizes
constexpr int kBM = 128, kGN = 128, kSlab = 32, kKC = 32, kStages = 4;
constexpr int kALd = kKC + 8;  // padded shared rows, in bf16 elements
constexpr int kBLd = kGN + 8;
constexpr int kABytes = kBM * kALd * 2;
constexpr int kStageBytes = kABytes + kKC * kBLd * 2;
constexpr int kSmemBytes = kStages * kStageBytes;
static_assert(kBM * kBLd * 2 <= kSmemBytes, "the staged output tile fits");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from src, or 16 zero bytes when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
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

// the first min(n, 8) elements at p, zero-filled to 8, packed low first
__device__ __forceinline__ uint4 pack8(const __nv_bfloat16* p, int n) {
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (j < n) w[j >> 1] |= (uint32_t)__bfloat16_as_ushort(p[j]) << (16 * (j & 1));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// table: [groups + 1] offsets into the entries that follow them; an entry
// is chunk * 16 + mask, chunk = (s * 3 + dy) * ceil(K1 / kKC) + c (rows
// c*kKC .. of segment s = Wc, Wl, Wr at row tap dy), mask bit j = the
// group's slab j holds a nonzero weight in that chunk
__global__ void __launch_bounds__(kThreads, 2)
gemm_conv_bf16(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ wc,
               const __nv_bfloat16* __restrict__ wl,
               const __nv_bfloat16* __restrict__ wr,
               const float* __restrict__ bias, const int* __restrict__ table,
               __nv_bfloat16* __restrict__ out, int64_t rows, int h, int wb,
               int k1, int nc, int cout, int groups, int vec_a, int vec_b,
               int vec_o) {
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t m0 = (int64_t)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kGN;
  const int first = table[blockIdx.y];
  const int count = table[blockIdx.y + 1] - first;
  const int* entries = table + groups + 1 + first;
  const int cps = (k1 + kKC - 1) / kKC;  // chunks a (segment, dy)

  // A copies: rows tid/4 and tid/4 + 64, 16-byte piece tid%4 of the chunk
  const int a_piece = tid & 3;
  ARow arow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) arow[i] = a_row(m0 + (tid >> 2) + 64 * i, rows, h, wb);
  // B copies: chunk rows tid/16 and tid/16 + 16, columns (tid%16)*8 .. +7
  const int b_row = tid >> 4, b_col = (tid & 15) * 8;

  auto fill = [&](int i, int buf) {
    const int chunk = entries[i] >> 4;
    const int seg = chunk / cps, c0 = (chunk - seg * cps) * kKC;
    const int s = seg / 3, dy = seg % 3;
    __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem + buf * kStageBytes);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t src = a_src(arow[r], dy, seg_db(s), h, wb);
      const int c = c0 + a_piece * 8;
      __nv_bfloat16* dst = as + ((tid >> 2) + 64 * r) * kALd + a_piece * 8;
      const bool ok = src >= 0 && c < k1;
      if (vec_a)
        cp_async16(dst, ok ? x + src * k1 + c : x, ok);
      else
        *reinterpret_cast<uint4*>(dst) =
            ok ? pack8(x + src * k1 + c, k1 - c) : make_uint4(0, 0, 0, 0);
    }
    const __nv_bfloat16* w = s == 0 ? wc : (s == 1 ? wl : wr);
    __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(smem + buf * kStageBytes + kABytes);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int k = b_row + 16 * r, col = n0 + b_col;
      const bool ok = c0 + k < k1 && col < nc;
      const __nv_bfloat16* src = w + ((int64_t)dy * k1 + c0 + k) * nc + col;
      __nv_bfloat16* dst = bs + k * kBLd + b_col;
      if (vec_b)
        cp_async16(dst, ok ? src : w, ok);
      else
        *reinterpret_cast<uint4*>(dst) = ok ? pack8(src, nc - col) : make_uint4(0, 0, 0, 0);
    }
  };

  // warp tile: rows mh*64 .. +64 (4 m16 tiles), columns slab*32 .. +32
  // (4 n8 tiles)
  const int slab = warp & 3, mh = warp >> 2;
  const int r16 = lane & 15, hi = lane >> 4;
  // this lane's ldmatrix row of A (row r16 of an m16 tile, columns +8*hi)
  // and of B (k = r16, columns + 8*hi), in bytes from their stage's start
  const uint32_t a_off = ((mh * 64 + r16) * kALd + hi * 8) * 2;
  const uint32_t b_off = kABytes + (r16 * kBLd + slab * kSlab + hi * 8) * 2;

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < count) fill(i, i);
    cp_async_commit();
  }
  for (int i = 0; i < count; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // entry i has landed; entry i-1's buffer is free
    const int next = i + kStages - 1;
    if (next < count) fill(next, next % kStages);
    cp_async_commit();
    if ((entries[i] >> slab) & 1) {
      const uint32_t base = smem_addr(smem + (i % kStages) * kStageBytes);
#pragma unroll
      for (int ks = 0; ks < kKC; ks += 16) {
        uint32_t b[4][2];
        ldmatrix_x4_trans(&b[0][0], base + b_off + ks * kBLd * 2);
        ldmatrix_x4_trans(&b[2][0], base + b_off + (ks * kBLd + 16) * 2);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          uint32_t a[4];
          ldmatrix_x4(a, base + a_off + (mt * 16 * kALd + ks) * 2);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a, b[nt]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: f32 bias, ReLU, one rounding; staged as [kBM][kBLd] bf16
  __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(smem);
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = slab * kSlab + nt * 8 + tg * 2;
    const float b0 = n0 + col < nc ? bias[(n0 + col) % cout] : 0.f;
    const float b1 = n0 + col + 1 < nc ? bias[(n0 + col + 1) % cout] : 0.f;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int row = mh * 64 + mt * 16 + g;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* c = &acc[mt][nt][2 * half];
        *reinterpret_cast<__nv_bfloat162*>(os + (row + 8 * half) * kBLd + col) =
            __floats2bfloat162_rn(fmaxf(c[0] + b0, 0.f), fmaxf(c[1] + b1, 0.f));
      }
    }
  }
  __syncthreads();
  const int ncols = min(kGN, nc - n0);
  for (int e = tid; e < kBM * (kGN / 8); e += kThreads) {
    const int p = e / (kGN / 8), col = (e % (kGN / 8)) * 8;
    const int64_t m = m0 + p;
    if (m >= rows || col >= ncols) continue;
    __nv_bfloat16* dst = out + m * nc + n0 + col;
    const __nv_bfloat16* src = os + p * kBLd + col;
    if (vec_o) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int j = 0; j < 8 && col + j < ncols; ++j) dst[j] = src[j];
    }
  }
}

// ------------------------------------------------------------------ f32

// block: kFBM GEMM rows x one group of kFSlabs slabs of kFSlab columns, a
// warp a slab; A staged a stage at a time (one row tap dy, kFSpan K rows:
// the tile's rows and one more at each end, for Wl's and Wr's shift); B
// blocks of kFKC rows x kFSlab columns in a ring of kFDepth per warp.
// ops/gemm_conv.py builds the table with the same sizes (G1F_*).
constexpr int kFBM = 128, kFSlab = 16, kFKC = 16, kFSlabs = 8, kFSpan = 128;
constexpr int kFDepth = 3;            // G1F_MIN_STEPS + 1
constexpr int kFRec = 16;             // ints a table row (G1F_REC)
constexpr int kFRows = kFBM + 2;      // staged A rows
constexpr int kFALd = kFSpan + 4;     // floats a staged A row (banks: below)
constexpr int kFTM = 8, kFTN = 8;     // a thread's rows and columns
constexpr int kFAFloats = kFRows * kFALd;
constexpr int kFBFloats = kFKC * kFSlab;
constexpr int kFSmemBytes =
    (2 * kFAFloats + kFSlabs * kFDepth * kFBFloats) * 4 + kFRows * 4;
static_assert(kFSlabs * 32 == kThreads && 16 * kFTM == kFBM && 2 * kFTN == kFSlab,
              "a warp a slab; 16 x 2 threads of 8 x 8 outputs a warp");

// channel ``i`` (a constant after unrolling) of a float4
__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc += one listed block: A rows a + i * 16 * kFALd (i < 8), kFKC columns
// from a; B [kFKC][kFSlab] at b, this thread's columns b[0..3] and b[8..11].
// MASK: rows whose bit is set in ``zero`` read zeros (the b-1 term at b = 0,
// the b+1 term at b = WB-1).
template <bool MASK>
__device__ __forceinline__ void f32_block(float (&acc)[kFTM][kFTN], const float* a,
                                          const float* b, unsigned zero) {
#pragma unroll
  for (int kq = 0; kq < kFKC; kq += 4) {
    float4 av[kFTM];
#pragma unroll
    for (int i = 0; i < kFTM; ++i) {
      av[i] = *reinterpret_cast<const float4*>(a + i * 16 * kFALd + kq);
      if (MASK && ((zero >> i) & 1)) av[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b0 = *reinterpret_cast<const float4*>(b + (kq + kk) * kFSlab);
      const float4 b1 = *reinterpret_cast<const float4*>(b + (kq + kk) * kFSlab + 8);
      const float bv[kFTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kFTM; ++i) {
        const float ai = lane4(av[i], kk);
#pragma unroll
        for (int j = 0; j < kFTN; ++j) acc[i][j] = fmaf(ai, bv[j], acc[i][j]);
      }
    }
  }
}

// table: ops/gemm_conv.py _f32_table, int32 rows of kFRec: a header row
// [K1, NC, groups], the groups' first records, then one record a step: [q
// = dy * spans + span, e_0 .. e_7 (chunk * 4 + segment of slab j's block,
// or -1), first step of a stage, the next stage's q, ...]. A table whose
// header is not this call's is never walked: every output is NaN (a
// launch cannot report an error without a sync).
__global__ void __launch_bounds__(kThreads, 1)
gemm_conv_f32(const float* __restrict__ x, const float* __restrict__ wc,
              const float* __restrict__ wl, const float* __restrict__ wr,
              const float* __restrict__ bias, const int* __restrict__ table,
              float* __restrict__ out, int64_t rows, int h, int wb, int k1, int nc,
              int cout, int groups, int vec_a, int vec_b, int vec_o) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* abuf = reinterpret_cast<float*>(smem);           // [2][kFRows][kFALd]
  float* bbuf = abuf + 2 * kFAFloats;                     // [warp][kFDepth][kFKC][kFSlab]
  int* hrow = reinterpret_cast<int*>(bbuf + kFSlabs * kFDepth * kFBFloats);  // [kFRows]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t m0 = (int64_t)blockIdx.x * kFBM;
  const int spans = (k1 + kFSpan - 1) / kFSpan;
  const bool valid = table[0] == k1 && table[1] == nc && table[2] == groups;
  const int* offsets = table + kFRec;
  const int* recs = table + kFRec * (1 + (groups + kFRec) / kFRec) +
                    (valid ? kFRec * offsets[blockIdx.y] : 0);
  const int steps = valid ? offsets[blockIdx.y + 1] - offsets[blockIdx.y] : 0;
  const int n_slab = blockIdx.y * (kFSlab * kFSlabs) + warp * kFSlab;

  // the image row of staged row r's GEMM row m0 - 1 + r, -1 past either end
  for (int r = tid; r < kFRows; r += kThreads) {
    const int64_t q = m0 - 1 + r;
    hrow[r] = q < 0 || q >= rows ? -1 : (int)((q / wb) % h);
  }
  __syncthreads();

  // stage q's A: staged row r holds x at GEMM row m0 - 1 + r shifted by dy - 1
  // image rows (zero where that leaves the image), K rows span * kFSpan ..
  // in whole chunks (zero past K1)
  auto fill_a = [&](int q, int buf) {
    const int dy = q / spans, k0 = (q - dy * spans) * kFSpan;
    const int w4 = (min(kFSpan, k1 - k0) + kFKC - 1) / kFKC * (kFKC / 4);  // pieces a row
    float* a = abuf + buf * kFAFloats;
    const float* xr = x + (m0 - 1 + (int64_t)(dy - 1) * wb) * k1 + k0;  // staged row 0
    if (vec_a && (w4 & (w4 - 1)) == 0) {
      // a warp copies 32 / w4 whole rows (a whole span: 512 contiguous bytes)
      const int per = 32 / w4, lr = lane / w4, c = (lane - lr * w4) * 4;
      const bool in_k = k0 + c < k1;
      for (int r = warp * per + lr; r < kFRows; r += kFSlabs * per) {
        const int hh = hrow[r] + dy - 1;
        const bool ok = in_k && hrow[r] >= 0 && hh >= 0 && hh < h;
        cp_async16(a + r * kFALd + c, ok ? xr + (int64_t)r * k1 + c : x, ok);
      }
      return;
    }
    for (int e = tid; e < kFRows * w4; e += kThreads) {
      const int r = e / w4, c = (e - r * w4) * 4, k = k0 + c;
      const int hh = hrow[r] + dy - 1;
      const bool row_ok = hrow[r] >= 0 && hh >= 0 && hh < h;
      const float* src = xr + (int64_t)r * k1 + c;
      float* dst = a + r * kFALd + c;
      if (vec_a) {
        const bool ok = row_ok && k < k1;
        cp_async16(dst, ok ? src : x, ok);
      } else {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = row_ok && k + j < k1 ? src[j] : 0.f;
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  };
  // step t's block of this warp's slab into its ring slot t % kFDepth
  float* bw = bbuf + warp * (kFDepth * kFBFloats);
  auto fill_b = [&](int t) {
    const int* rec = recs + t * kFRec;
    const int e = rec[1 + warp];
    if (e < 0) return;
    const int dy = rec[0] / spans;
    const int k0 = (rec[0] - dy * spans) * kFSpan + (e >> 2) * kFKC;
    const float* w = (e & 3) == 0 ? wc : ((e & 3) == 1 ? wl : wr);
    float* b = bw + (t % kFDepth) * kFBFloats;
#pragma unroll
    for (int r = 0; r < kFBFloats / 4 / 32; ++r) {  // 16 rows x 4 pieces, 2 a lane
      const int i = lane + 32 * r;
      const int kk = i >> 2, c = (i & 3) * 4, k = k0 + kk, col = n_slab + c;
      const float* src = w + ((int64_t)dy * k1 + k) * nc + col;
      float* dst = b + kk * kFSlab + c;
      if (vec_b) {
        const bool ok = k < k1 && col < nc;
        cp_async16(dst, ok ? src : w, ok);
      } else {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = k < k1 && col + j < nc ? src[j] : 0.f;
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  };

  // thread tile: rows rg + 16 i (i < 8) of the block, columns ch * 4 .. +3
  // and 8 + ch * 4 .. +3 of the warp's slab
  const int rg = lane >> 1, ch = lane & 1;
  unsigned zero_l = 0, zero_r = 0;  // rows at b = 0 and at b = WB - 1
  for (int i = 0, b = (int)((m0 + rg) % wb); i < kFTM; ++i) {
    zero_l |= (unsigned)(b == 0) << i;
    zero_r |= (unsigned)(b == wb - 1) << i;
    b += 16;
    while (b >= wb) b -= wb;
  }
  float acc[kFTM][kFTN];
#pragma unroll
  for (int i = 0; i < kFTM; ++i)
#pragma unroll
    for (int j = 0; j < kFTN; ++j) acc[i][j] = 0.f;

  if (steps > 0) fill_a(recs[0], 0);
#pragma unroll
  for (int t = 0; t < kFDepth - 1; ++t) {
    if (t < steps) fill_b(t);
    cp_async_commit();
  }
  int stage = -1;
  for (int t = 0; t < steps; ++t) {
    const int* rec = recs + t * kFRec;
    cp_async_wait<kFDepth - 2>();  // step t's B (and its stage's A) landed
    if (rec[9]) {
      // a new stage: its A is complete in every thread, and every warp is
      // done with the last stage, whose buffer takes the next stage's A
      __syncthreads();
      ++stage;
    } else {
      __syncwarp();  // the warp's B of step t; its slot of step t-1 is free
    }
    if (t + kFDepth - 1 < steps) fill_b(t + kFDepth - 1);
    if (rec[9] && rec[10] >= 0) fill_a(rec[10], (stage + 1) & 1);
    cp_async_commit();
    const int e = rec[1 + warp];
    if (e >= 0) {
      const int s = e & 3;
      // Wc reads row m (staged row m - m0 + 1), Wl row m - 1, Wr row m + 1
      const float* a = abuf + (stage & 1) * kFAFloats +
                       (rg + (s == 0 ? 1 : (s == 1 ? 0 : 2))) * kFALd + (e >> 2) * kFKC;
      const float* b = bw + (t % kFDepth) * kFBFloats + ch * 4;
      if (s == 0)
        f32_block<false>(acc, a, b, 0u);
      else
        f32_block<true>(acc, a, b, s == 1 ? zero_l : zero_r);
    }
  }
  cp_async_wait<0>();

  // epilogue: f32 bias, ReLU; 16-byte stores (a warp's store: 16 rows x 32
  // contiguous bytes)
  const int c0 = n_slab + ch * 4;
  float bv[kFTN];
#pragma unroll
  for (int j = 0; j < kFTN; ++j) {
    const int col = c0 + (j < 4 ? j : 4 + j);
    bv[j] = col < nc ? bias[col % cout] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kFTM; ++i) {
    const int64_t m = m0 + rg + 16 * i;
    if (m >= rows) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = c0 + 8 * half;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = valid ? fmaxf(acc[i][4 * half + j] + bv[4 * half + j], 0.f)
                     : __int_as_float(0x7fc00000);  // a quiet NaN
      float* dst = out + m * nc + col;
      if (vec_o) {
        if (col < nc) *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < nc) dst[j] = v[j];
      }
    }
  }
}

}  // namespace
}  // namespace annonet

extern "C" int annonet_conv3x3_gemm(const void* x, const void* wc,
                                    const void* wl, const void* wr,
                                    const void* bias, const void* table,
                                    void* out, int64_t n, int64_t h,
                                    int64_t wb, int k1, int nc, int cout,
                                    int bf16, void* stream) {
  using namespace annonet;
  cudaGetLastError();  // report this launch's error only
  if (k1 <= 0 || nc <= 0 || cout <= 0 || nc % cout || h > INT32_MAX ||
      wb > INT32_MAX || table == nullptr)
    return (int)cudaErrorInvalidValue;
  const int64_t rows = n * h * wb;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (bf16) {
    const auto* xt = static_cast<const __nv_bfloat16*>(x);
    const auto* wct = static_cast<const __nv_bfloat16*>(wc);
    const auto* wlt = static_cast<const __nv_bfloat16*>(wl);
    const auto* wrt = static_cast<const __nv_bfloat16*>(wr);
    auto* ot = static_cast<__nv_bfloat16*>(out);
    const int vec_a = k1 % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const int vec_b = nc % 8 == 0 && reinterpret_cast<uintptr_t>(wc) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(wl) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(wr) % 16 == 0;
    const int vec_o = nc % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    const int groups = (nc + kGN - 1) / kGN;
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_conv_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((unsigned)((rows + kBM - 1) / kBM), (unsigned)groups);
    gemm_conv_bf16<<<grid, kThreads, kSmemBytes, s>>>(
        xt, wct, wlt, wrt, b, static_cast<const int*>(table), ot, rows, (int)h,
        (int)wb, k1, nc, cout, groups, vec_a, vec_b, vec_o);
  } else {
    const auto* xt = static_cast<const float*>(x);
    const auto* wct = static_cast<const float*>(wc);
    const auto* wlt = static_cast<const float*>(wl);
    const auto* wrt = static_cast<const float*>(wr);
    auto* ot = static_cast<float*>(out);
    const int vec_a = k1 % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const int vec_b = nc % 4 == 0 && reinterpret_cast<uintptr_t>(wc) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(wl) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(wr) % 16 == 0;
    const int vec_o = nc % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    const int groups = (nc + kFSlab * kFSlabs - 1) / (kFSlab * kFSlabs);
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_conv_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, kFSmemBytes);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((unsigned)((rows + kFBM - 1) / kFBM), (unsigned)groups);
    gemm_conv_f32<<<grid, kThreads, kFSmemBytes, s>>>(
        xt, wct, wlt, wrt, b, static_cast<const int*>(table), ot, rows, (int)h, (int)wb,
        k1, nc, cout, groups, vec_a, vec_b, vec_o);
  }
  return (int)cudaGetLastError();
}
