// The training step's batch norm and ReLU (ops/bn_relu.py bn_plain, then
// the ReLU) as one operation: two kernels forward, two backward.
//
// Replaces no TPU kernel: in the JAX package the unit's batch norm and ReLU
// are plain jnp operations (annonet_tpu/models/segnet.py _bn_train) that
// XLA fuses into the convolutions' neighbours. Eager PyTorch ran them as
// some fifty passes a unit, forward and backward, over f32 copies of each
// activation; this file runs them in four.
//
// What bounds it on an H100: its bytes, at well under one operation a byte.
// The flagship's 14 units see 4,276,224 values a 192^2 crop; at batch 128
// that is 547.4 M values, 1.095 GB a bf16 pass. The function itself moves
// two passes forward (h in, y out): 2.19 GB, 0.65 ms at 3.35 TB/s; and
// three backward (h and dy in, dh out): 3.28 GB, 0.98 ms.
//
// Design: the statistics have to be whole before the first output, so
// this design reads its inputs twice: three passes forward (h for the
// sums; h again, y out), five backward (h and dy for the sums; both again,
// dh out), 0.98 and 1.63 ms if every pass came from HBM. The units whose
// activations fit in the 50 MB L2 may serve the second read from it. No
// pass more than those, and every pass at the memory's rate.
// Activations are channels_last, so a row of C channels is contiguous: a
// thread reads 16 bytes of one row at a time (C % (16 / sizeof(T)) == 0,
// else one element) and keeps the same channels for its whole life, so
// its scale, shift and coefficients sit in registers and its sums need no
// index arithmetic. Each thread has kUnroll loads in flight; the grids
// walk the rows, at most max_blocks blocks (ops/bn_relu.py: a fixed number
// an SM), so a shape always gets the same grid and the same sums.
//
// The two reductions (sum and sum of squares of h; sum of dz and of dz * h)
// end in the same kernel, with no launch spent on C-sized work, and finish
// across a thread-block cluster of K blocks (ops/bn_relu.py
// reduce_geometry: 16, 8, 4 or 2, the largest of which the card holds the
// grid's clusters at once; 1 where none fits). Each block leaves its
// per-channel f32 partials in its shared memory; block rank r of a cluster
// adds channel slice r over the cluster's blocks (distributed shared
// memory, rank order, double) into the cluster's row of f64 partials and
// takes ticket r; the last to take ticket r adds that slice's rows in
// cluster order, several loads in flight a thread, and computes its
// channels' C-sized results. So K SMs finish, each reading a K^2-th of
// what one last block read when every block wrote its own row (grid x 2C
// floats, 3.1 MB at C = 1024, at about 0.47 ns a float: up to 372 us a
// launch over the streaming floor on an H100, PERF.md). It costs two
// cluster barriers and 2C shared-memory reads a block, and at most K - 1
// blocks that walk no rows, rounding the grid up to whole clusters. The
// logical grid fixes each block's rows, so every block's partials are
// those of K = 1; only the grouping of the double sums follows K, and a
// shape always gets the same K on one card. Nothing is stored in f32
// beside the activations: the backward recomputes the ReLU's mask from h,
// scale and shift with the forward's roundings.
//
// Arithmetic, as the eager path's on the card, rounding point by rounding
// point (ops/bn_relu.py has the plain versions):
//   mean = f32(sum h) * (C / (N*H*W*C)), mean_sq likewise (torch's mean)
//   diff = mean_sq - mean*mean; var = max(diff, 0); inv = rsqrtf(var + eps)
//   scale = T(inv * g); shift = T(b - (mean * inv) * g)
//   y = relu(T(T(h * scale) + shift))         (no FMA: __fmul_rn, __fadd_rn)
// and backward, with dz = dy where y > 0, s1 = sum dz, s2 = sum dz * h,
// autograd's chain through the clamp's mask, rsqrt and the two means:
//   dgamma = s2*inv - s1*(mean*inv); dbeta = s1
//   dinv = s2*g + (-s1*g)*mean; dd = diff >= 0 ? -0.5*dinv*inv^3 : 0
//   a = ((-s1*g)*inv - dd*(2*mean)) / M; b = 2*dd / M     (M = N*H*W)
//   dh = T(dz*scale + a + b*h)

#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"

namespace annonet {
namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;  // the most a block has (ops/bn_relu.py rows_a_pass sets it)
constexpr int kUnroll = 4;     // loads in flight a thread
constexpr float kEps = 1e-5f;  // ops/bn_relu.py BN_EPS
constexpr int kMaxCluster = 16;  // blocks a reduction's cluster has at most
constexpr int kFinishLoads = 8;  // rows a finishing thread has in flight

// Rows of the per-channel buffer [kRows, C] f32 (ops/bn_relu.py reads the
// mean and the variance from the first two).
enum Row { kMean, kVar, kInv, kScale, kShift, kDiff, kA, kB, kRows };

template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f32<T>(from_f32<T>(v));
}

// T(T(h * scale) + shift): the eager normalisation's two roundings
template <typename T>
__device__ __forceinline__ float pre_relu(float h, float scale, float shift) {
  return rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(h, scale)), shift));
}

// One thread's chunk of a row: VEC values, 16 bytes, or one element.
template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_f32<T>(*p);
  } else {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = __uint_as_float(w[k]);
    } else {  // bf16: element 2k in the low half of word k
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[2 * k] = __uint_as_float(w[k] << 16);
        v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
      }
    }
  }
}

// Stores values that are already on T's grid (rnd<T>), so cutting an f32
// to its bf16 bits is exact.
template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    *p = from_f32<T>(v[0]);
  } else {
    uint32_t w[4];
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int k = 0; k < 4; ++k) w[k] = __float_as_uint(v[k]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = (__float_as_uint(v[2 * k]) >> 16) |
               (__float_as_uint(v[2 * k + 1]) & 0xffff0000u);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// A thread's place: lane = its VEC channels, r0 = its first row. A block
// of lanes * per_pass threads covers per_pass rows a pass.
struct Place {
  int lanes, per_pass, lane, r0;
  __device__ Place(int c, int vec)
      : lanes(c / vec),
        per_pass(blockDim.x / (c / vec)),
        lane(threadIdx.x % (c / vec)),
        r0(threadIdx.x / (c / vec)) {}
};

template <int VEC>
__device__ __forceinline__ void channel_values(const float* row, int lane,
                                               float (&v)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) v[j] = row[lane * VEC + j];
}

// Adds the block's per-thread values v (thread g * lanes + l holds the
// channels l*VEC .. l*VEC+VEC-1 of its rows) per channel in a fixed order
// and writes the C sums to out. smem: blockDim.x * (VEC + 1) floats.
template <int VEC>
__device__ void block_channel_sums(const float (&v)[VEC], int c,
                                   int per_pass, float* smem, float* out) {
  const int n = blockDim.x;
  __syncthreads();  // smem is free
#pragma unroll
  for (int j = 0; j < VEC; ++j) smem[threadIdx.x * VEC + j] = v[j];
  __syncthreads();  // row group g's channel ch is smem[g * c + ch]
  const int slices = c < n ? min(n / c, per_pass) : 1;
  if (slices == 1) {
    for (int ch = threadIdx.x; ch < c; ch += n) {
      float acc = 0.f;
      for (int g = 0; g < per_pass; ++g) acc += smem[g * c + ch];
      out[ch] = acc;
    }
    return;
  }
  float* mid = smem + n * VEC;
  if (threadIdx.x < slices * c) {
    const int ch = threadIdx.x % c, sl = threadIdx.x / c;
    float acc = 0.f;
    for (int g = sl; g < per_pass; g += slices) acc += smem[g * c + ch];
    mid[threadIdx.x] = acc;
  }
  __syncthreads();
  if (threadIdx.x < c) {
    float acc = 0.f;
    for (int sl = 0; sl < slices; ++sl) acc += mid[sl * c + threadIdx.x];
    out[threadIdx.x] = acc;
  }
}

// The forward's C-sized results from the channel's two f32 totals.
template <typename T>
__device__ void finish_forward(int ch, int c, int64_t rows, float sum,
                               float sum_sq, const float* gamma,
                               const float* beta, float* buf) {
  // torch's mean on the card: the f32 sum times C / numel in f32
  const float factor = __fdiv_rn((float)c, (float)(rows * c));
  const float mean = __fmul_rn(sum, factor);
  const float mean_sq = __fmul_rn(sum_sq, factor);
  const float diff = __fsub_rn(mean_sq, __fmul_rn(mean, mean));
  const float var = diff < 0.f ? 0.f : diff;
  const float inv = rsqrtf(__fadd_rn(var, kEps));
  const float g = gamma[ch];
  buf[kMean * c + ch] = mean;
  buf[kVar * c + ch] = var;
  buf[kInv * c + ch] = inv;
  buf[kDiff * c + ch] = diff;
  buf[kScale * c + ch] = rnd<T>(__fmul_rn(inv, g));
  buf[kShift * c + ch] =
      rnd<T>(__fsub_rn(beta[ch], __fmul_rn(__fmul_rn(mean, inv), g)));
}

// The backward's: dgamma, dbeta and dh's coefficients a and b.
__device__ void finish_backward(int ch, int c, int64_t rows, float s1,
                                float s2, const float* gamma, float* buf,
                                float* dgamma, float* dbeta) {
  const float mean = buf[kMean * c + ch], inv = buf[kInv * c + ch];
  const float g = gamma[ch];
  dgamma[ch] = __fsub_rn(__fmul_rn(s2, inv), __fmul_rn(s1, __fmul_rn(mean, inv)));
  dbeta[ch] = s1;
  const float dt1 = -__fmul_rn(s1, g);  // d(mean * inv)
  const float dinv = __fadd_rn(__fmul_rn(s2, g), __fmul_rn(dt1, mean));
  const float inv3 = __fmul_rn(__fmul_rn(inv, inv), inv);
  const float dd = buf[kDiff * c + ch] >= 0.f
                       ? __fmul_rn(__fmul_rn(-0.5f, dinv), inv3)
                       : 0.f;  // d(diff): clamp's mask, rsqrt
  const float dmean =
      __fsub_rn(__fmul_rn(dt1, inv), __fmul_rn(dd, __fmul_rn(2.f, mean)));
  const float m = (float)rows;
  buf[kA * c + ch] = __fdiv_rn(dmean, m);
  buf[kB * c + ch] = __fdiv_rn(__fmul_rn(2.f, dd), m);
}

// The reductions' shared memory: block_channel_sums' scratch, then the
// block's partials [2, c] f32, which the blocks of its cluster read.
template <int VEC>
__host__ __device__ constexpr int scratch_floats() {
  return kThreads * (VEC + 1 > 4 ? VEC + 1 : 4);
}
template <int VEC>
size_t reduce_smem(int c) {
  return (scratch_floats<VEC>() + 2 * (size_t)c) * sizeof(float);
}

// Channel slice r of c among k blocks: [*lo, *hi), possibly empty.
__device__ __forceinline__ void channel_slice(int c, int k, int r, int* lo, int* hi) {
  const int width = (c + k - 1) / k;
  *lo = min(c, r * width);
  *hi = min(c, *lo + width);
}

// Forward (BACKWARD false): per-channel sums of h and h^2. Backward: of dz
// and dz * h, dz = dy where the forward's y > 0. Logical block b < blocks
// walks rows b*per_pass + r0, stepping blocks*per_pass; the launch may add
// blocks up to a whole number of clusters of `cluster`, which walk none.
// Block rank r of cluster i adds channel slice r of its cluster's block
// partials (distributed shared memory, in rank order, in double) into row
// i of `partial` [clusters, c, 2] f64 and takes ticket r; the last of the
// clusters to take it adds slice r's rows in cluster order and finishes
// those channels.
template <typename T, int VEC, bool BACKWARD>
__global__ void __launch_bounds__(kThreads) bn_reduce_kernel(
    const T* __restrict__ h, const T* __restrict__ dy, int64_t ld_dy,
    int64_t rows, int c, int blocks, int cluster,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    float* __restrict__ buf, float* __restrict__ dgamma,
    float* __restrict__ dbeta, double* __restrict__ partial,
    unsigned* __restrict__ tickets) {
  extern __shared__ float smem[];
  __shared__ bool last;
  float* mine = smem + scratch_floats<VEC>();
  const Place p(c, VEC);
  float s[VEC], q[VEC], scale[VEC], shift[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s[j] = q[j] = 0.f;
  if constexpr (BACKWARD) {
    channel_values<VEC>(buf + kScale * c, p.lane, scale);
    channel_values<VEC>(buf + kShift * c, p.lane, shift);
  }
  const int64_t step = (int64_t)blocks * p.per_pass;
  const int64_t first = (int)blockIdx.x < blocks ? (int64_t)blockIdx.x * p.per_pass + p.r0 : rows;
  for (int64_t r = first; r < rows; r += kUnroll * step) {
    float x[kUnroll][VEC], d[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t ru = r + u * step;
      if (ru < rows) {
        load<T, VEC>(h + ru * c + p.lane * VEC, x[u]);
        if constexpr (BACKWARD) load<T, VEC>(dy + ru * ld_dy + p.lane * VEC, d[u]);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) x[u][j] = d[u][j] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        if constexpr (BACKWARD) {
          const float dz =
              pre_relu<T>(x[u][j], scale[j], shift[j]) <= 0.f ? 0.f : d[u][j];
          s[j] += dz;
          q[j] = fmaf(dz, x[u][j], q[j]);
        } else {
          s[j] += x[u][j];
          q[j] = fmaf(x[u][j], x[u][j], q[j]);
        }
      }
    }
  }
  block_channel_sums<VEC>(s, c, p.per_pass, smem, mine);
  block_channel_sums<VEC>(q, c, p.per_pass, smem, mine + c);

  // the cluster's partials: rank r adds slice r of every block's, with all
  // of their loads in flight
  cg::cluster_group group = cg::this_cluster();
  if (cluster > 1) group.sync(); else __syncthreads();
  const int rank = (int)blockIdx.x % cluster;
  int lo, hi;
  channel_slice(c, cluster, rank, &lo, &hi);
  const int width = hi - lo;
  double* row = partial + (size_t)(blockIdx.x / cluster) * 2 * c + 2 * lo;
  for (int i = threadIdx.x; i < 2 * width; i += blockDim.x) {
    const int v = (i % 2) * c + lo + i / 2;  // row[2 * ch + 1] is the second sum's
    float x[kMaxCluster];
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k)
      x[k] = k >= cluster ? 0.f : cluster > 1 ? group.map_shared_rank(mine, k)[v] : mine[v];
    double acc = 0.0;
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k)
      if (k < cluster) acc += x[k];
    row[i] = acc;
  }
  __threadfence();  // the row is visible before the ticket is taken
  // no block leaves while the cluster reads its partials
  if (cluster > 1) group.sync(); else __syncthreads();
  const int clusters = (int)gridDim.x / cluster;
  if (threadIdx.x == 0) {
    last = atomicAdd(tickets + rank, 1u) == (unsigned)clusters - 1;
    if (last) tickets[rank] = 0u;  // every cluster has taken it: ready for the next launch
  }
  __syncthreads();
  if (!last || width <= 0) return;
  __threadfence();

  // slice r's finish: groups of threads walk the rows g, g + groups, ...
  // of a channel, kFinishLoads rows in flight, adding in row order; then
  // the groups' sums are added in group order
  const int n = blockDim.x;
  const int groups = width < n ? min(n / width, clusters) : 1;
  double* mid = reinterpret_cast<double*>(smem);  // [groups * width][2]
  for (int i = threadIdx.x; i < groups * width; i += n) {
    const int ch = lo + i % width;
    const double2* col = reinterpret_cast<const double2*>(partial) + ch;
    double a = 0.0, b = 0.0;
    int g = i / width;
    for (; g + (kFinishLoads - 1) * groups < clusters; g += kFinishLoads * groups) {
      double2 x[kFinishLoads];
#pragma unroll
      for (int u = 0; u < kFinishLoads; ++u) x[u] = __ldcg(col + (size_t)(g + u * groups) * c);
#pragma unroll
      for (int u = 0; u < kFinishLoads; ++u) {
        a += x[u].x;
        b += x[u].y;
      }
    }
    for (; g < clusters; g += groups) {
      const double2 x = __ldcg(col + (size_t)g * c);
      a += x.x;
      b += x.y;
    }
    if (groups == 1) {
      if constexpr (BACKWARD) {
        finish_backward(ch, c, rows, (float)a, (float)b, gamma, buf, dgamma, dbeta);
      } else {
        finish_forward<T>(ch, c, rows, (float)a, (float)b, gamma, beta, buf);
      }
    } else {
      mid[2 * i] = a;
      mid[2 * i + 1] = b;
    }
  }
  if (groups > 1) {
    __syncthreads();
    for (int j = threadIdx.x; j < width; j += n) {
      double a = 0.0, b = 0.0;
      for (int gi = 0; gi < groups; ++gi) {
        a += mid[2 * (gi * width + j)];
        b += mid[2 * (gi * width + j) + 1];
      }
      if constexpr (BACKWARD) {
        finish_backward(lo + j, c, rows, (float)a, (float)b, gamma, buf, dgamma, dbeta);
      } else {
        finish_forward<T>(lo + j, c, rows, (float)a, (float)b, gamma, beta, buf);
      }
    }
  }
}

// y = relu(T(T(h * scale) + shift))
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) bn_relu_apply_kernel(
    const T* __restrict__ h, T* __restrict__ y, int64_t rows, int c,
    const float* __restrict__ buf) {
  const Place p(c, VEC);
  float scale[VEC], shift[VEC];
  channel_values<VEC>(buf + kScale * c, p.lane, scale);
  channel_values<VEC>(buf + kShift * c, p.lane, shift);
  const int64_t step = (int64_t)gridDim.x * p.per_pass;
  for (int64_t r = (int64_t)blockIdx.x * p.per_pass + p.r0; r < rows;
       r += kUnroll * step) {
    float x[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (r + u * step < rows) load<T, VEC>(h + (r + u * step) * c + p.lane * VEC, x[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * step >= rows) break;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float z = pre_relu<T>(x[u][j], scale[j], shift[j]);
        x[u][j] = z <= 0.f ? 0.f : z;
      }
      store<T, VEC>(y + (r + u * step) * c + p.lane * VEC, x[u]);
    }
  }
}

// dh = T(dz * scale + a + b * h)
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) bn_relu_grad_kernel(
    const T* __restrict__ h, const T* __restrict__ dy, int64_t ld_dy,
    T* __restrict__ dh, int64_t rows, int c, const float* __restrict__ buf) {
  const Place p(c, VEC);
  float scale[VEC], shift[VEC], a[VEC], b[VEC];
  channel_values<VEC>(buf + kScale * c, p.lane, scale);
  channel_values<VEC>(buf + kShift * c, p.lane, shift);
  channel_values<VEC>(buf + kA * c, p.lane, a);
  channel_values<VEC>(buf + kB * c, p.lane, b);
  const int64_t step = (int64_t)gridDim.x * p.per_pass;
  for (int64_t r = (int64_t)blockIdx.x * p.per_pass + p.r0; r < rows;
       r += kUnroll * step) {
    float x[kUnroll][VEC], d[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * step < rows) {
        load<T, VEC>(h + (r + u * step) * c + p.lane * VEC, x[u]);
        load<T, VEC>(dy + (r + u * step) * ld_dy + p.lane * VEC, d[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * step >= rows) break;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float dz =
            pre_relu<T>(x[u][j], scale[j], shift[j]) <= 0.f ? 0.f : d[u][j];
        x[u][j] = rnd<T>(fmaf(b[j], x[u][j], fmaf(dz, scale[j], a[j])));
      }
      store<T, VEC>(dh + (r + u * step) * c + p.lane * VEC, x[u]);
    }
  }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// per_pass: the rows a block walks at once (ops/bn_relu.py rows_a_pass),
// so a block has per_pass * c / VEC threads, at most kThreads.
bool valid_block(int c, int vec, int per_pass) {
  return per_pass >= 1 && (int64_t)per_pass * (c / vec) <= kThreads;
}

template <int VEC>
void reduce_config(int c, int per_pass, int grid, int cluster, cudaStream_t s,
                   cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  *cfg = {};
  cfg->gridDim = dim3(grid);
  cfg->blockDim = dim3(per_pass * (c / VEC));
  cfg->dynamicSmemBytes = reduce_smem<VEC>(c);
  cfg->stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = cluster > 1 ? 1 : 0;
}

// The clusters of `cluster` blocks of the reduction that the device holds
// at once (cudaOccupancyMaxActiveClusters), or minus an error code. Allows
// the reduction clusters above the portable 8 blocks first.
template <typename T, int VEC>
int reduce_clusters(bool backward, int c, int per_pass, int cluster) {
  if (!valid_block(c, VEC, per_pass) || cluster <= 0 || cluster > kMaxCluster)
    return -(int)cudaErrorInvalidValue;
  auto reduce = backward ? bn_reduce_kernel<T, VEC, true> : bn_reduce_kernel<T, VEC, false>;
  cudaError_t err = cudaFuncSetAttribute(reduce, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  reduce_config<VEC>(c, per_pass, cluster, cluster, nullptr, &cfg, &attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, reduce, &cfg);
  return err != cudaSuccess ? -(int)err : n;
}

// The reduction on a grid of `blocks` (ops/bn_relu.py reduce_geometry's
// logical grid) rounded up to whole clusters of `cluster`, then the
// normalisation or the input gradient on at most max_blocks blocks; every
// block of per_pass * c / VEC threads.
template <typename T, int VEC>
cudaError_t launch(bool backward, const void* h, const void* dy, int64_t ld_dy,
                   void* out, int64_t rows, int c, const float* gamma,
                   const float* beta, float* buf, float* dgamma, float* dbeta,
                   double* partial, int per_pass, int max_blocks, int blocks,
                   int cluster, unsigned* tickets, cudaStream_t s) {
  if (!valid_block(c, VEC, per_pass) || blocks <= 0 || cluster <= 0 || cluster > kMaxCluster)
    return cudaErrorInvalidValue;
  const int threads = per_pass * (c / VEC);
  auto reduce = backward ? bn_reduce_kernel<T, VEC, true> : bn_reduce_kernel<T, VEC, false>;
  // every grid is a function of the shape and the geometry alone, so the
  // order of the sums is fixed per shape
  const int grid = (int)ceil_div(blocks, cluster) * cluster;
  const int apply = (int)std::min<int64_t>(max_blocks, ceil_div(rows, (int64_t)per_pass * kUnroll));
  const T* ht = static_cast<const T*>(h);
  const T* dyt = static_cast<const T*>(dy);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  reduce_config<VEC>(c, per_pass, grid, cluster, s, &cfg, &attr);
  cudaError_t err = cudaLaunchKernelEx(&cfg, reduce, ht, dyt, ld_dy, rows, c, blocks, cluster,
                                       gamma, beta, buf, dgamma, dbeta, partial, tickets);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (backward) {
    bn_relu_grad_kernel<T, VEC><<<apply, threads, 0, s>>>(ht, dyt, ld_dy, static_cast<T*>(out),
                                                          rows, c, buf);
  } else {
    bn_relu_apply_kernel<T, VEC><<<apply, threads, 0, s>>>(ht, static_cast<T*>(out), rows, c, buf);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int vec, bool backward, const void* h, const void* dy,
                     int64_t ld_dy, void* out, int64_t rows, int c,
                     const float* gamma, const float* beta, float* buf,
                     float* dgamma, float* dbeta, double* partial, int per_pass,
                     int max_blocks, int blocks, int cluster, unsigned* tickets,
                     cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec) {
    if (c % kVec) return cudaErrorInvalidValue;
    return launch<T, kVec>(backward, h, dy, ld_dy, out, rows, c, gamma, beta, buf, dgamma,
                           dbeta, partial, per_pass, max_blocks, blocks, cluster, tickets, s);
  }
  return launch<T, 1>(backward, h, dy, ld_dy, out, rows, c, gamma, beta, buf, dgamma, dbeta,
                      partial, per_pass, max_blocks, blocks, cluster, tickets, s);
}

}  // namespace
}  // namespace annonet

// Forward: y = relu(bn(h)) over rows = N*H*W rows of c channels (channels
// last, contiguous); buf [8, c] f32 receives the mean, variance, inv,
// scale, shift and diff. Every kernel's blocks walk per_pass rows at once
// (per_pass * c / VEC threads, at most 256). The reduction runs on
// `blocks` blocks in clusters of `cluster` (1 to 16; above 8 after
// annonet_bn_relu_clusters); partial [ceil(blocks / cluster), c, 2] f64
// scratch; tickets 16 zeroed unsigned per stream (left zero). The
// normalisation runs on at most max_blocks blocks. vec: 16-byte chunks (every pointer 16-byte aligned, c
// a multiple of 16 / sizeof(T)), else elements. device: the tensors' and
// the stream's device.
extern "C" int annonet_bn_relu_forward(const void* h, void* y, const float* gamma,
                                       const float* beta, float* buf, double* partial,
                                       int per_pass, int max_blocks, int blocks, int cluster,
                                       unsigned* tickets, int64_t rows, int c, int vec,
                                       int bf16, int device, void* stream) {
  using namespace annonet;
  if (rows <= 0 || c <= 0 || max_blocks <= 0) return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  cudaGetLastError();  // report this launch's error only
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(vec, false, h, nullptr, 0, y, rows, c, gamma, beta, buf,
                                     nullptr, nullptr, partial, per_pass, max_blocks, blocks,
                                     cluster, tickets, s)
           : dispatch<float>(vec, false, h, nullptr, 0, y, rows, c, gamma, beta, buf, nullptr,
                             nullptr, partial, per_pass, max_blocks, blocks, cluster, tickets,
                             s);
  return (int)err;
}

// Backward: dh, dgamma and dbeta [c] f32 from h, dy (rows of c channels at
// a pitch of ld_dy elements) and the forward's buf, whose rows a and b it
// fills. Other arguments as the forward's.
extern "C" int annonet_bn_relu_backward(const void* h, const void* dy, int64_t ld_dy,
                                        void* dh, const float* gamma, float* buf,
                                        float* dgamma, float* dbeta, double* partial,
                                        int per_pass, int max_blocks, int blocks, int cluster,
                                        unsigned* tickets, int64_t rows, int c, int vec,
                                        int bf16, int device, void* stream) {
  using namespace annonet;
  if (rows <= 0 || c <= 0 || max_blocks <= 0 || ld_dy < c) return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(vec, true, h, dy, ld_dy, dh, rows, c, gamma, nullptr, buf,
                                     dgamma, dbeta, partial, per_pass, max_blocks, blocks,
                                     cluster, tickets, s)
           : dispatch<float>(vec, true, h, dy, ld_dy, dh, rows, c, gamma, nullptr, buf, dgamma,
                             dbeta, partial, per_pass, max_blocks, blocks, cluster, tickets, s);
  return (int)err;
}

// The clusters of `cluster` blocks of the forward (backward 0) or backward
// reduction at c channels and per_pass rows a block that the device holds
// at once, or minus a CUDA error code. Called before the first launch in
// clusters above 8 blocks.
extern "C" int annonet_bn_relu_clusters(int backward, int c, int per_pass, int cluster, int vec,
                                        int bf16, int device) {
  using namespace annonet;
  if (c <= 0) return -(int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  cudaGetLastError();
  constexpr int kVecBf16 = 16 / sizeof(__nv_bfloat16), kVecF32 = 16 / sizeof(float);
  if (vec && c % (bf16 ? kVecBf16 : kVecF32)) return -(int)cudaErrorInvalidValue;
  if (bf16) {
    return vec ? reduce_clusters<__nv_bfloat16, kVecBf16>(backward, c, per_pass, cluster)
               : reduce_clusters<__nv_bfloat16, 1>(backward, c, per_pass, cluster);
  }
  return vec ? reduce_clusters<float, kVecF32>(backward, c, per_pass, cluster)
             : reduce_clusters<float, 1>(backward, c, per_pass, cluster);
}
