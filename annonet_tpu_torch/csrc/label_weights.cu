// The loss weights of a training batch (ops/weighting.py
// batched_label_weights): each crop's histogram of its valid labels, the
// class weights it gives, and every pixel's weight, in two kernels.
//
// Replaces no TPU kernel: the JAX package computes the weights in plain
// jnp (annonet_tpu/ops/weighting.py), which XLA fuses. Eager PyTorch ran
// them as some 25 launches, one of them a float scatter-add that sends
// each pixel's 1.0 to its crop's K counts with an atomicAdd: at batch 16
// of 624^2 crops, 6.2 M float atomics on 48 floats, two L2 lines, which
// the L2 serialises (7.7 ms on an H100).
//
// What bounds it on an H100: its bytes. The function reads the int32
// labels and writes the f32 weights, 8 bytes a pixel: 49.8 MB at batch 16
// of 624^2, 14.9 us at 3.35 TB/s. A pixel's weight needs its whole crop's
// counts, so this design reads the labels twice: 12 bytes a pixel, 74.8
// MB, 22.3 us if every byte came from HBM; the second read may come from
// the 50 MB L2.
//
// Design. count: a grid of (blocks a crop) x N blocks of 256 threads; a
// thread reads 16 bytes of labels at a time (a scalar head and tail where
// the crop does not start on a 16-byte boundary or H*W is not a multiple
// of 4), kUnroll loads in flight. It keeps its counts in registers when K
// <= kRegisterClasses (one compare and add a class a label), else in
// per-warp shared-memory bins (integer shared atomics). The block adds its
// counts (warp shuffles, then shared memory) and adds them to the [N, K]
// int32 counts with one integer atomicAdd a class. Integer sums are exact
// in any order, so the counts depend neither on the grid nor on the order
// of the blocks: no float atomic anywhere. The last block to finish (an
// integer ticket, as in bn_relu.cu) computes the [N, K] f32 weight table
// and leaves the counts and the ticket zero for the next launch on the
// stream. apply: the same grid; a block puts its crop's K weights in
// shared memory and writes each pixel's, 16 bytes at a time (scalars where
// the labels and the weights are not equally aligned).
//
// Arithmetic, as the eager path's on the card (ops/weighting.py
// batched_label_weights_plain), rounding point by rounding point:
//   counts: exact integers; the eager f32 counts are the same up to 2^24
//     pixels a crop
//   total = sum of the counts: exact below 2^24 in any order
//   u_k = count_k > 0 ? max(count_k, 1) ** -class_weight : 0, where `**`
//     is torch's pow of an f32 tensor by a scalar (torch_pow below)
//   total_u = sum_k f32(count_k * u_k), in the order of torch's CUDA
//     reduction over the last dimension (torch_row_sum below)
//   target = total * (f32(1 / max(total, 1)) * f32(H*W)) ** image_weight
//     (`pixels / safe_total` is Tensor.__rdiv__: reciprocal, then a product)
//   scale = total_u > 0 ? target / total_u : 0; weight_k = u_k * scale
//   a pixel's weight: weight_label if label != IGNORE_LABEL and label < K
//   (and label >= 0, where the eager path fails), else 0
// Every product, sum and quotient is a single IEEE f32 operation
// (__fmul_rn, __fadd_rn, __fdiv_rn: nothing contracts to an FMA).
// torch_pow and torch_row_sum follow PyTorch 2.11's sources (Pow.cpp,
// PowKernel.cu, Reduce.cuh), and were tested bit-equal on 2.11.0+cu128.
// These are internals of torch, not its interface: after a torch upgrade,
// re-run the test_label_weights_* cases of tests/test_torch_cuda.py on the
// card before relying on bit-equality.

#include <algorithm>

#include "common.cuh"

namespace annonet {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;            // 16-byte loads in flight a thread
constexpr int kVectorsPerBlock = 2 * kUnroll * kThreads;  // a block's share of a crop
constexpr int kRegisterClasses = 8;   // up to this K a thread counts in registers
constexpr int kMaxClasses = 8192;     // 32 KB of shared bins or weights (ops/weighting.py)
constexpr int kIgnore = 0xFFFF;       // classes.py IGNORE_LABEL
// torch's reduction kernel (aten/src/ATen/native/cuda/Reduce.cuh): threads
// a block at most, accumulators a thread (vt0)
constexpr int kReduceThreads = 512;
constexpr int kReduceAccumulators = 4;

__host__ __device__ int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

__device__ __forceinline__ bool valid_label(int v, int k) {
  return v != kIgnore && (unsigned)v < (unsigned)k;
}

// A crop's labels: `head` elements before its first 16-byte boundary, then
// `vectors` 16-byte vectors, then the rest; `scalars` = head + the rest.
// Without vectors (vec false) every element is a scalar.
struct Crop {
  int64_t head, vectors, scalars;
  __device__ Crop(const int* p, int64_t hw, bool vec) {
    if (!vec) {
      head = scalars = hw;
      vectors = 0;
      return;
    }
    head = min(hw, (int64_t)((4 - ((reinterpret_cast<uintptr_t>(p) >> 2) & 3)) & 3));
    vectors = (hw - head) >> 2;
    scalars = hw - 4 * vectors;
  }
  // the crop's element index of its i-th scalar
  __device__ int64_t scalar(int64_t i) const { return i < head ? i : i + 4 * vectors; }
  // this block's vectors [v0, v1) of the crop's (gridDim.x equal shares)
  __device__ void share(int64_t& v0, int64_t& v1) const {
    const int64_t per = ceil_div(vectors, gridDim.x);
    v0 = min(vectors, (int64_t)blockIdx.x * per);
    v1 = min(vectors, v0 + per);
  }
};

__device__ __forceinline__ int4 load_vector(const int4* p, int64_t v, int64_t v1) {
  return v < v1 ? __ldg(p + v) : make_int4(-1, -1, -1, -1);  // -1: no class
}

// torch's `t ** e` of an f32 CUDA tensor t and a Python float e
// (aten/src/ATen/native/Pow.cpp pow_Tensor_Scalar_out, cuda/PowKernel.cu
// pow_tensor_scalar_kernel): e == 0 fills ones and e == 1 copies; e of 0.5,
// -0.5 and -1 run sqrt, rsqrt and the reciprocal; otherwise e is rounded to
// f32, and 2, 3 and -2 multiply out (-2 as 1.0 / (b * b) in double), any
// other is powf. The library calls are the ones torch's kernels make
// (::sqrt, ::rsqrt, ::pow of floats), compiled without fast math as
// torch's are.
__device__ float torch_pow(float b, double e) {
  if (e == 0.0) return 1.f;
  if (e == 1.0) return b;
  if (e == 0.5) return sqrtf(b);
  if (e == -0.5) return rsqrtf(b);
  if (e == -1.0) return __fdiv_rn(1.f, b);
  const float ef = (float)e;
  if (ef == 2.f) return __fmul_rn(b, b);
  if (ef == 3.f) return __fmul_rn(__fmul_rn(b, b), b);
  if (ef == -2.f) return (float)__ddiv_rn(1.0, (double)__fmul_rn(b, b));
  return powf(b, ef);
}

__device__ int last_pow2(int64_t n) {  // Reduce.cuh last_pow2
  n |= n >> 1;
  n |= n >> 2;
  n |= n >> 4;
  n |= n >> 8;
  n |= n >> 16;
  n |= n >> 32;
  return (int)max((int64_t)1, n - (n >> 1));
}

// torch's sum over the last dimension of a contiguous [rows, k] f32 CUDA
// tensor, k < 128 (Reduce.cuh as PyTorch 2.11 has it: setReduceConfig,
// thread_reduce_impl, block_x_reduce). A row gets bw threads, bw a power
// of two: the largest <= k up to 32, more when the rows are few. Thread x
// adds elements x, x + bw, x + 2bw, ... into four accumulators in turn
// and folds them in order; the bw values are then added by halving (lane
// x takes lane x + bw/2, then x + bw/4, ...): a pairwise sum of the lanes
// in bit-reversed order. From k = 128 torch loads 4 elements a thread and
// sums in another order (the ops/weighting.py docstring says by how much
// the weights may then differ). value(j) gives element j.
template <typename F>
__device__ float torch_row_sum(const F& value, int k, int64_t rows) {
  const int p0 = k < kReduceThreads ? last_pow2(k) : kReduceThreads;
  const int p1 = rows < kReduceThreads ? last_pow2(rows) : kReduceThreads;
  int bw = min(p0, 32);
  const int bh = min(p1, kReduceThreads / bw);
  bw = min(p0, kReduceThreads / bh);
  const int bits = __ffs(bw) - 1;
  float stack[10];  // bw <= 512: a pairwise sum of at most 2^9 lanes
  for (int i = 0; i < bw; ++i) {
    const int x = bits ? (int)(__brev((unsigned)i) >> (32 - bits)) : 0;
    float acc[kReduceAccumulators];
#pragma unroll
    for (int a = 0; a < kReduceAccumulators; ++a) acc[a] = 0.f;
    int idx = x;
    while (idx + (kReduceAccumulators - 1) * bw < k) {
#pragma unroll
      for (int a = 0; a < kReduceAccumulators; ++a) acc[a] = __fadd_rn(acc[a], value(idx + a * bw));
      idx += kReduceAccumulators * bw;
    }
    for (int a = 0; a < kReduceAccumulators && idx < k; ++a, idx += bw)
      acc[a] = __fadd_rn(acc[a], value(idx));
    float v = acc[0];
#pragma unroll
    for (int a = 1; a < kReduceAccumulators; ++a) v = __fadd_rn(v, acc[a]);
    int level = 0;
    for (int y = i; y & 1; y >>= 1, ++level) v = __fadd_rn(stack[level], v);
    stack[level] = v;
  }
  return stack[bits];
}

// One crop's K weights from its counts (read from L2: the other blocks'
// atomics), written to table; see the arithmetic in the note above.
__device__ void crop_table(const int* counts, int k, int64_t rows, float pixels,
                           double class_exponent, double image_weight, float* table) {
  auto unnormalized = [&](int j) {
    const float c = (float)__ldcg(counts + j);
    return c > 0.f ? torch_pow(fmaxf(c, 1.f), class_exponent) : 0.f;
  };
  int64_t count = 0;
  for (int j = 0; j < k; ++j) count += __ldcg(counts + j);
  const float total = (float)count;
  const float total_u = torch_row_sum(
      [&](int j) { return __fmul_rn((float)__ldcg(counts + j), unnormalized(j)); }, k, rows);
  const float share = __fmul_rn(__fdiv_rn(1.f, fmaxf(total, 1.f)), pixels);
  const float target = __fmul_rn(total, torch_pow(share, image_weight));
  const float scale = total_u > 0.f ? __fdiv_rn(target, total_u) : 0.f;
  for (int j = 0; j < k; ++j) table[j] = __fmul_rn(unnormalized(j), scale);
}

// The counts of every crop (grid: x its blocks, y the crops), then, in the
// last block, the weight table. REGISTERS: counts in kRegisterClasses
// registers a thread (K <= kRegisterClasses); else in `copies` shared bins
// of K ints, warp w's the (w % copies)-th.
template <bool REGISTERS>
__global__ void __launch_bounds__(kThreads) label_count_kernel(
    const int* __restrict__ labels, int64_t n, int64_t hw, int k, int copies,
    double class_exponent, double image_weight, unsigned* __restrict__ ticket,
    int* __restrict__ counts, float* __restrict__ table) {
  extern __shared__ int bins[];
  __shared__ int warp_counts[kWarps][kRegisterClasses];
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* my_bins = bins + (warp % copies) * k;
  for (int64_t c = blockIdx.y; c < n; c += gridDim.y) {
    const int* p = labels + c * hw;
    const Crop crop(p, hw, true);
    int cnt[kRegisterClasses];
#pragma unroll
    for (int j = 0; j < kRegisterClasses; ++j) cnt[j] = 0;
    if constexpr (!REGISTERS) {
      for (int i = tid; i < copies * k; i += kThreads) bins[i] = 0;
      __syncthreads();
    }
    auto count = [&](int v) {
      if constexpr (REGISTERS) {
#pragma unroll
        for (int j = 0; j < kRegisterClasses; ++j) cnt[j] += v == j;  // never IGNORE, never < 0
      } else {
        if (valid_label(v, k)) atomicAdd(my_bins + v, 1);
      }
    };
    int64_t v0, v1;
    crop.share(v0, v1);
    const int4* vp = reinterpret_cast<const int4*>(p + crop.head);
    for (int64_t v = v0 + tid; v < v1; v += kUnroll * kThreads) {
      int4 r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) r[u] = load_vector(vp, v + u * kThreads, v1);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        count(r[u].x);
        count(r[u].y);
        count(r[u].z);
        count(r[u].w);
      }
    }
    for (int64_t i = (int64_t)blockIdx.x * kThreads + tid; i < crop.scalars;
         i += (int64_t)gridDim.x * kThreads)
      count(__ldg(p + crop.scalar(i)));

    if constexpr (REGISTERS) {
#pragma unroll
      for (int j = 0; j < kRegisterClasses; ++j) {
        int s = cnt[j];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
        if (lane == 0) warp_counts[warp][j] = s;
      }
      __syncthreads();
      if (tid < k) {
        int s = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += warp_counts[w][tid];
        if (s) atomicAdd(counts + c * k + tid, s);
      }
    } else {
      __syncthreads();
      for (int j = tid; j < k; j += kThreads) {
        int s = 0;
        for (int b = 0; b < copies; ++b) s += bins[b * k + j];
        if (s) atomicAdd(counts + c * k + j, s);
      }
    }
    __syncthreads();  // the shared counts are free for the next crop
  }

  __threadfence();  // this block's counts are added before its ticket is taken
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float pixels = (float)(double)hw;  // the eager path's float(h * w), rounded to f32
  for (int64_t c = tid; c < n; c += kThreads) {
    crop_table(counts + c * k, k, n, pixels, class_exponent, image_weight, table + c * k);
    for (int j = 0; j < k; ++j) counts[c * k + j] = 0;  // ready for the next launch
  }
  if (tid == 0) *ticket = 0u;
}

// Every pixel's weight from its crop's row of the table.
__global__ void __launch_bounds__(kThreads) label_apply_kernel(
    const int* __restrict__ labels, float* __restrict__ out, int64_t n, int64_t hw, int k,
    const float* __restrict__ table, int vec) {
  extern __shared__ float weight[];
  const int tid = threadIdx.x;
  for (int64_t c = blockIdx.y; c < n; c += gridDim.y) {
    __syncthreads();  // the previous crop's weights are no longer read
    for (int j = tid; j < k; j += kThreads) weight[j] = __ldg(table + c * k + j);
    __syncthreads();
    auto w = [&](int v) { return valid_label(v, k) ? weight[v] : 0.f; };
    const int* p = labels + c * hw;
    float* o = out + c * hw;
    const Crop crop(p, hw, vec != 0);
    int64_t v0, v1;
    crop.share(v0, v1);
    const int4* vp = reinterpret_cast<const int4*>(p + crop.head);
    float4* op = reinterpret_cast<float4*>(o + crop.head);
    for (int64_t v = v0 + tid; v < v1; v += kUnroll * kThreads) {
      int4 r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) r[u] = load_vector(vp, v + u * kThreads, v1);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (v + u * kThreads < v1)
          op[v + u * kThreads] = make_float4(w(r[u].x), w(r[u].y), w(r[u].z), w(r[u].w));
    }
    for (int64_t i = (int64_t)blockIdx.x * kThreads + tid; i < crop.scalars;
         i += (int64_t)gridDim.x * kThreads) {
      const int64_t e = crop.scalar(i);
      o[e] = w(__ldg(p + e));
    }
  }
}

}  // namespace
}  // namespace annonet

// The loss weights of n crops of hw int32 labels (contiguous) into out
// (n * hw f32): class_exponent is -class_weight. The stream's workspace:
// ticket (one unsigned) and counts (n * k ints), zeroed and left zero;
// table (n * k f32) apart from them, so that no call's table lands where a
// later call counts. vec: labels and out are equally aligned modulo 16
// bytes. device: the tensors' and the stream's device. Two launches.
extern "C" int annonet_label_weights(const int* labels, float* out, unsigned* ticket,
                                     int* counts, float* table, int64_t n, int64_t hw, int k,
                                     double class_exponent, double image_weight, int vec,
                                     int device, void* stream) {
  using namespace annonet;
  if (n <= 0 || hw <= 0 || k <= 0 || k > kMaxClasses) return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  cudaGetLastError();  // report this call's errors only
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)std::max<int64_t>(1, ceil_div(ceil_div(hw, 4), kVectorsPerBlock)),
                  (unsigned)std::min<int64_t>(n, kMaxGridYZ));
  if (k <= kRegisterClasses) {
    label_count_kernel<true><<<grid, kThreads, 0, s>>>(labels, n, hw, k, 1, class_exponent,
                                                       image_weight, ticket, counts, table);
  } else {
    const int copies = std::max(1, std::min(kWarps, kMaxClasses / k));
    label_count_kernel<false><<<grid, kThreads, (size_t)copies * k * sizeof(int), s>>>(
        labels, n, hw, k, copies, class_exponent, image_weight, ticket, counts, table);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  label_apply_kernel<<<grid, kThreads, (size_t)k * sizeof(float), s>>>(labels, out, n, hw, k,
                                                                      table, vec);
  return (int)cudaGetLastError();
}
