// Train-mode batch norm of the ResNet trunk for Hopper (sm_90a), forward and
// backward, with the ReLU or the residual sum and ReLU that follow it.
//
// Replaces no TPU kernel: the JAX package's train step leaves each batch
// norm of the RTM trunk, with what follows it, to XLA, which fuses the
// statistics, the normalisation and the gradient's reductions around the
// convolutions.  PyTorch runs them eagerly: two strided reductions, the
// affine, the ReLU and the residual sum forward (ops/norms.train_batch_norm
// on an NHWC view of the NCHW conv output, models/resnet.py), and autograd's
// 15 to 20 passes backward.  These four kernels are one site's two passes
// forward (statistics, then apply) and two backward (the gradient's sums,
// then the gradients), in the manner of csrc/bn_epilogue.cu.
//
// What they compute, on a contiguous NCHW tensor x (and other) of float32 or
// bf16, the norm's scale and bias [C] of x's type, and count, the values
// each channel reduces (N*H*W; the global batch's on a mesh):
//   stats       part[s][c] = (sum x, sum x^2) over the s-th of `splits`
//               equal runs of channel c's N*H*W values, in float64
//   apply       mean = sum x / count, var = sum x^2 / count - mean^2
//               (float64, then float32), rstd = 1 / sqrt(var + 1e-5),
//               inv = scale * rstd,
//               y = relu?((x - mean) * inv + bias [+ other | + norm2(other)]),
//               and per channel the batch mean and variance and the running
//               statistics moved as ops/norms.update_running_stats moves
//               them: keep * running + 0.1 * batch, keep = 1 - 0.1, the variance's
//               batch value times count / (count - 1)
//   grad_stats  g = relu ? (y <= 0 ? 0 : dy) : dy (threshold_backward on the
//               output); per channel (sum g, sum g (x - mean)), and
//               sum g (other - mean2) for a second norm, in float64
//   grad_apply  dx = inv g - inv sum g / count
//                    - (x - mean) inv rstd^2 sum g (x - mean) / count
//               (other's alike for a second norm, g itself for an identity),
//               dscale = rstd sum g (x - mean), dbias = sum g
// The sums a forward's apply and a backward's dx read may be the global
// batch's (the host all-reduces `part` between the two launches); dscale
// and dbias always come from this rank's sums, which the train step sums
// over the ranks with every other gradient.  Elementwise arithmetic is
// float32 with one rounding to x's type at the store.
//
// Statistics as float64 sums of each value and its square: a float32 value
// and its square are exact in float64, and float64's 53 bits leave the
// variance ~2^-30 relative even where the mean is 1e3 standard deviations
// from zero.  Partial sums are written per block and merged in a fixed
// order by the next launch (no atomics), so two calls give the same bits.
//
// What bounds them: bytes.  A site reads x three times (statistics, apply,
// gradient sums) and the gradient's dy, y and x twice, and writes y, dx (and
// the identity's or second norm's gradient): 10 to 14 passes over the
// activation, against ~25 for the eager chain.  At ResNet-50's batch-128
// float32 trunk the normed tensors hold 1.42 G values, 5.69 GB, 1.70 ms a
// pass at 3.35 TB/s.
//
// What the design does about it:
//  - The reductions run one block per (channel, run of ~16 K values): whole
//    planes of one channel are contiguous in NCHW, so a block streams its
//    run with 16-byte loads (plane sizes divisible by the vector) or
//    coalesced scalar loads (7x7 planes), kUnroll loads in flight a thread.
//  - The elementwise launches stream the flat tensor as bn_epilogue does:
//    one contiguous chunk a block, one wave of resident blocks, 16-byte
//    loads and stores, each block computing the per-channel constants of
//    the channels its chunk touches into shared memory once.  The block
//    whose chunk holds a channel's first value writes its per-channel
//    outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;     // vectors a thread of a reduction loads before it sums them
constexpr float kEps = 1e-5f;  // ops/norms.EPS
constexpr float kMomentum = 0.1f;  // ops/norms.update_running_stats' momentum

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// rstd = 1 / sqrt(var + eps), each step rounded to nearest: the forward and
// the backward derive it alike from the stored float32 variance
__device__ __forceinline__ float rstd_of(float var) {
  return __frcp_rn(__fsqrt_rn(__fadd_rn(var, kEps)));
}

// -- reductions over one channel's values ------------------------------------

// The block's K sums into thread 0, in a fixed order.  Every thread of the
// block calls it (the shuffles take the full mask).
template <int K>
__device__ __forceinline__ void block_sum(double (&acc)[K]) {
  __shared__ double warp_sums[kWarps][K];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] += __shfl_down_sync(0xffffffffu, acc[k], off);
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) warp_sums[threadIdx.x >> 5][k] = acc[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      double t = 0.0;
      for (int w = 0; w < kWarps; ++w) t += warp_sums[w][k];
      acc[k] = t;
    }
  }
}

// MODE 0: (sum x, sum x^2).  MODE 1: the gradient's (sum g, sum g (x - mean)).
// MODE 2: also sum g (other - mean2).  Block b sums channel b / splits over
// the (b % splits)-th of `splits` equal runs of its n * hwv vectors; vector
// k of the channel is image k / hwv's (k % hwv)-th of the plane.
template <typename T, int V, int MODE, bool RELU>
__global__ void __launch_bounds__(kThreads)
    bn_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dy, const T* __restrict__ y,
                     const T* __restrict__ other, const float* __restrict__ stats,
                     double* __restrict__ part, int n, int channels, int hwv, int splits) {
  constexpr int K = MODE == 2 ? 3 : 2;
  using P = Pack<T, V>;
  const int c = blockIdx.x / splits;
  const int s = blockIdx.x - c * splits;
  const long long total = (long long)n * hwv;
  const long long k1 = total * (s + 1) / splits;
  float mu = 0.0f, mu2 = 0.0f;
  if (MODE != 0) mu = stats[c];
  if (MODE == 2) mu2 = stats[2 * channels + c];

  double acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0;
  long long k = total * s / splits + threadIdx.x;
  long long img = k / hwv;  // the thread's next vector: image img, vector r of its plane
  int r = (int)(k - img * hwv);
  const int dimg = kThreads / hwv, dr = kThreads % hwv;
  for (; k < k1; k += (long long)kThreads * kUnroll) {
    P a[kUnroll], b[kUnroll], e[kUnroll], f[kUnroll];  // x, dy, y, other
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k + (long long)u * kThreads < k1) {
        const long long at = (img * channels + c) * hwv + r;
        a[u] = reinterpret_cast<const P*>(x)[at];
        if (MODE != 0) {
          b[u] = reinterpret_cast<const P*>(dy)[at];
          if (RELU) e[u] = reinterpret_cast<const P*>(y)[at];
        }
        if (MODE == 2) f[u] = reinterpret_cast<const P*>(other)[at];
      }
      r += dr;
      img += dimg;
      if (r >= hwv) {
        r -= hwv;
        ++img;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k + (long long)u * kThreads < k1) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xv = to_f(a[u].v[j]);
          if (MODE == 0) {
            const double d = xv;
            acc[0] += d;
            acc[1] = fma(d, d, acc[1]);
          } else {
            float g = to_f(b[u].v[j]);
            if (RELU && to_f(e[u].v[j]) <= 0.0f) g = 0.0f;
            acc[0] += (double)g;
            acc[1] += (double)__fmul_rn(g, __fsub_rn(xv, mu));
            if (MODE == 2) acc[2] += (double)__fmul_rn(g, __fsub_rn(to_f(f[u].v[j]), mu2));
          }
        }
      }
    }
  }
  block_sum<K>(acc);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < K; ++q) part[((long long)s * channels + c) * K + q] = acc[q];
  }
}

template <typename T, int V, int MODE, bool RELU>
int launch_reduce(const void* x, const void* dy, const void* y, const void* other,
                  const float* stats, double* part, int n, int channels, int hw, int splits,
                  cudaStream_t stream) {
  const long long grid = (long long)channels * splits;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  bn_reduce_kernel<T, V, MODE, RELU><<<(unsigned)grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const T*>(y),
      static_cast<const T*>(other), stats, part, n, channels, hw / V, splits);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// 16-byte vectors where every plane holds whole vectors and every pointer
// is aligned, else one value at a time
template <typename T, int MODE, bool RELU>
int dispatch_reduce(const void* x, const void* dy, const void* y, const void* other,
                    const float* stats, double* part, int n, int channels, int hw, int splits,
                    cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = hw % V == 0 && aligned16(x) && aligned16(dy) && aligned16(y) && aligned16(other);
  return vec ? launch_reduce<T, V, MODE, RELU>(x, dy, y, other, stats, part, n, channels, hw, splits, s)
             : launch_reduce<T, 1, MODE, RELU>(x, dy, y, other, stats, part, n, channels, hw, splits, s);
}

// -- elementwise passes over the flat tensor ---------------------------------

// This block's chunk [j0, j1) of the flat tensor's V-value vectors and the
// channels it touches: planes q0.. of the flat [N*C, HW], `touched`
// channels from c_first on (all C if the chunk spans a whole image).
struct Chunk {
  long long j0, j1;
  int touched, c_first;
};

template <int V>
__device__ __forceinline__ Chunk chunk_of(long long nvec, long long chunk, int hw, int channels) {
  Chunk ch;
  ch.j0 = blockIdx.x * chunk;
  ch.j1 = min(nvec, ch.j0 + chunk);
  ch.touched = 0;
  ch.c_first = 0;
  if (ch.j0 < ch.j1) {
    const long long q0 = ch.j0 * V / hw;
    const long long planes = (ch.j1 * V - 1) / hw - q0 + 1;
    ch.touched = planes < channels ? (int)planes : channels;
    ch.c_first = (int)(q0 % channels);
  }
  return ch;
}

// f(j, r, c) for each of the thread's vectors j of the chunk, r and c the
// plane position and channel of its first value: the channel found once by
// division, then carried along by the stride's quotient and remainder
template <int V, typename F>
__device__ __forceinline__ void for_each_vector(const Chunk& ch, int hw, int channels, F&& f) {
  long long j = ch.j0 + threadIdx.x;
  if (j >= ch.j1) return;
  const long long q = j * V / hw;
  int r = (int)(j * V - q * hw);
  int c = (int)(q % channels);
  const long long step = (long long)kThreads * V;
  const int dr = (int)(step % hw);
  const int dc = (int)((step / hw) % channels);
  for (; j < ch.j1; j += kThreads) {
    f(j, r, c);
    r += dr;
    c += dc;
    if (r >= hw) {
      r -= hw;
      ++c;
    }
    if (c >= channels) c -= channels;
  }
}

// What the forward knows of one norm.
struct Norm {
  const double* part;   // [splits][C][2]: sum x, sum x^2
  const void* scale;    // [C] of x's type
  const void* bias;
  const float* rmean;   // running statistics [C]
  const float* rvar;
  float* stats;         // out: batch mean [C], then batch variance [C]
  float* run;           // out: new running mean [C], then new running variance [C]
};

struct Update {
  double count;    // values each channel reduces
  float keep;      // 1 - kMomentum
  float bessel;    // count / (count - 1)
};

// channel c's mean, inv and bias into shared memory; the writer block also
// stores the batch statistics and the new running statistics
template <typename T>
__device__ __forceinline__ void norm_consts(const Norm& nm, const Update& up, int c, int channels,
                                            int splits, bool writer, float* mu, float* inv,
                                            float* bi) {
  double s1 = 0.0, s2 = 0.0;
#pragma unroll 4
  for (int s = 0; s < splits; ++s) {
    const double* p = nm.part + ((long long)s * channels + c) * 2;
    s1 += p[0];
    s2 += p[1];
  }
  const double mean = s1 / up.count;
  double var = s2 / up.count - mean * mean;
  if (var < 0.0) var = 0.0;  // rounding only; NaN stays
  const float m = (float)mean, v = (float)var;
  mu[c] = m;
  inv[c] = __fmul_rn(to_f(static_cast<const T*>(nm.scale)[c]), rstd_of(v));
  bi[c] = to_f(static_cast<const T*>(nm.bias)[c]);
  if (writer) {
    nm.stats[c] = m;
    nm.stats[channels + c] = v;
    nm.run[c] = __fadd_rn(__fmul_rn(up.keep, nm.rmean[c]), __fmul_rn(kMomentum, m));
    nm.run[channels + c] = __fadd_rn(__fmul_rn(up.keep, nm.rvar[c]),
                                     __fmul_rn(kMomentum, __fmul_rn(v, up.bessel)));
  }
}

template <typename T, int V, int MODE>
__global__ void __launch_bounds__(kThreads)
    bn_apply_kernel(const T* __restrict__ x, const T* __restrict__ other, Norm n1, Norm n2,
                    Update up, T* __restrict__ y, long long nvec, long long chunk, int hw,
                    int channels, int splits, bool relu) {
  extern __shared__ float smem[];  // mean, inv, bias [C] of x's norm, then of other's (mode 2)
  float* mu1 = smem;
  float* inv1 = smem + channels;
  float* bi1 = smem + 2 * channels;
  float* mu2 = smem + 3 * channels;
  float* inv2 = smem + 4 * channels;
  float* bi2 = smem + 5 * channels;
  const Chunk ch = chunk_of<V>(nvec, chunk, hw, channels);
  if (ch.j0 >= ch.j1) return;  // the whole block leaves together
  for (int k = threadIdx.x; k < ch.touched; k += kThreads) {
    int c = ch.c_first + k;
    if (c >= channels) c -= channels;
    const long long first = (long long)c * hw;  // the channel's first value (image 0)
    const bool writer = first >= ch.j0 * V && first < ch.j1 * V;
    norm_consts<T>(n1, up, c, channels, splits, writer, mu1, inv1, bi1);
    if (MODE == 2) norm_consts<T>(n2, up, c, channels, splits, writer, mu2, inv2, bi2);
  }
  __syncthreads();

  using P = Pack<T, V>;
  for_each_vector<V>(ch, hw, channels, [&](long long j, int r, int c) {
    const P a = reinterpret_cast<const P*>(x)[j];
    P b;
    if (MODE != 0) b = reinterpret_cast<const P*>(other)[j];
    P out;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float v = __fmaf_rn(__fsub_rn(to_f(a.v[k]), mu1[c]), inv1[c], bi1[c]);
      if (MODE == 1) {
        v = __fadd_rn(v, to_f(b.v[k]));
      } else if (MODE == 2) {
        v = __fadd_rn(v, __fmaf_rn(__fsub_rn(to_f(b.v[k]), mu2[c]), inv2[c], bi2[c]));
      }
      if (relu && !isnan(v)) v = fmaxf(v, 0.0f);
      out.v[k] = from_f<T>(v);
      if (++r == hw) {
        r = 0;
        if (++c == channels) c = 0;
      }
    }
    reinterpret_cast<P*>(y)[j] = out;
  });
}

// What the backward knows of one norm.
struct GradNorm {
  const float* stats;  // batch mean [C], then batch variance [C]
  const void* scale;   // [C] of x's type
  void* dvec;          // out: dscale [C], then dbias [C], of x's type
  int col;             // the column of sum g (t - mean) in the [splits][C][K] sums
};

// channel c's mean and the gradient's affine (alpha g + beta (t - mean) +
// delta) into shared memory; the writer block also stores dscale and dbias
// from this rank's sums
template <typename T>
__device__ __forceinline__ void grad_consts(const GradNorm& gn, const double* glob,
                                            const double* local, int K, double count, int c,
                                            int channels, int splits, bool writer, float* mu,
                                            float* al, float* be, float* de) {
  double ag = 0.0, bg = 0.0;
#pragma unroll 4
  for (int s = 0; s < splits; ++s) {
    const double* p = glob + ((long long)s * channels + c) * K;
    ag += p[0];
    bg += p[gn.col];
  }
  const float m = gn.stats[c];
  const float rstd = rstd_of(gn.stats[channels + c]);
  const float inv = __fmul_rn(to_f(static_cast<const T*>(gn.scale)[c]), rstd);
  mu[c] = m;
  al[c] = inv;
  be[c] = (float)(-(double)inv * rstd * rstd * bg / count);
  de[c] = (float)(-(double)inv * ag / count);
  if (writer) {
    double al_ = 0.0, bl = 0.0;
#pragma unroll 4
    for (int s = 0; s < splits; ++s) {
      const double* p = local + ((long long)s * channels + c) * K;
      al_ += p[0];
      bl += p[gn.col];
    }
    T* d = static_cast<T*>(gn.dvec);
    d[c] = from_f<T>((float)(bl * rstd));
    d[channels + c] = from_f<T>((float)al_);
  }
}

// MODE 0: dx.  MODE 1: dx and the identity's gradient g.  MODE 2: dx and
// the second norm's input's gradient.
template <typename T, int V, int MODE>
__global__ void __launch_bounds__(kThreads)
    bn_grad_apply_kernel(const T* __restrict__ dy, const T* __restrict__ y, const T* __restrict__ x,
                         const T* __restrict__ other, GradNorm g1, GradNorm g2,
                         const double* __restrict__ glob, const double* __restrict__ local,
                         T* __restrict__ dx, T* __restrict__ dother, long long nvec,
                         long long chunk, int hw, int channels, int splits, double count,
                         bool relu) {
  constexpr int K = MODE == 2 ? 3 : 2;
  extern __shared__ float smem[];  // mean, alpha, beta, delta [C] of x's norm, then other's
  float* mu1 = smem;
  float* al1 = smem + channels;
  float* be1 = smem + 2 * channels;
  float* de1 = smem + 3 * channels;
  float* mu2 = smem + 4 * channels;
  float* al2 = smem + 5 * channels;
  float* be2 = smem + 6 * channels;
  float* de2 = smem + 7 * channels;
  const Chunk ch = chunk_of<V>(nvec, chunk, hw, channels);
  if (ch.j0 >= ch.j1) return;
  for (int k = threadIdx.x; k < ch.touched; k += kThreads) {
    int c = ch.c_first + k;
    if (c >= channels) c -= channels;
    const long long first = (long long)c * hw;
    const bool writer = first >= ch.j0 * V && first < ch.j1 * V;
    grad_consts<T>(g1, glob, local, K, count, c, channels, splits, writer, mu1, al1, be1, de1);
    if (MODE == 2) {
      grad_consts<T>(g2, glob, local, K, count, c, channels, splits, writer, mu2, al2, be2, de2);
    }
  }
  __syncthreads();

  using P = Pack<T, V>;
  for_each_vector<V>(ch, hw, channels, [&](long long j, int r, int c) {
    const P gy = reinterpret_cast<const P*>(dy)[j];
    P yy, a, b;
    if (relu) yy = reinterpret_cast<const P*>(y)[j];
    a = reinterpret_cast<const P*>(x)[j];
    if (MODE == 2) b = reinterpret_cast<const P*>(other)[j];
    P out, out2;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float g = to_f(gy.v[k]);
      if (relu && to_f(yy.v[k]) <= 0.0f) g = 0.0f;
      out.v[k] = from_f<T>(
          __fmaf_rn(be1[c], __fsub_rn(to_f(a.v[k]), mu1[c]), __fmaf_rn(al1[c], g, de1[c])));
      if (MODE == 1) {
        out2.v[k] = from_f<T>(g);
      } else if (MODE == 2) {
        out2.v[k] = from_f<T>(
            __fmaf_rn(be2[c], __fsub_rn(to_f(b.v[k]), mu2[c]), __fmaf_rn(al2[c], g, de2[c])));
      }
      if (++r == hw) {
        r = 0;
        if (++c == channels) c = 0;
      }
    }
    reinterpret_cast<P*>(dx)[j] = out;
    if (MODE != 0) reinterpret_cast<P*>(dother)[j] = out2;
  });
}

// one wave of resident blocks, each a contiguous chunk of the nvec vectors
template <typename K>
int elementwise_grid(K kernel, int smem, long long nvec, int sms, long long* grid,
                     long long* chunk) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long want = (nvec + kThreads - 1) / kThreads;
  *grid = want < (long long)per_sm * sms ? want : (long long)per_sm * sms;
  *chunk = (nvec + *grid - 1) / *grid;
  return 0;
}

template <typename T, int V, int MODE>
int launch_apply(const void* x, const void* other, Norm n1, Norm n2, Update up, void* y,
                 long long n, int hw, int channels, int splits, bool relu, int sms,
                 cudaStream_t stream) {
  auto kernel = bn_apply_kernel<T, V, MODE>;
  const int smem = (MODE == 2 ? 6 : 3) * channels * (int)sizeof(float);
  const long long nvec = n / V;
  long long grid = 0, chunk = 0;
  const int err = elementwise_grid(kernel, smem, nvec, sms, &grid, &chunk);
  if (err != 0) return err;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(other), n1, n2, up, static_cast<T*>(y), nvec,
      chunk, hw, channels, splits, relu);
  return (int)cudaGetLastError();
}

template <typename T, int V, int MODE>
int launch_grad_apply(const void* dy, const void* y, const void* x, const void* other, GradNorm g1,
                      GradNorm g2, const double* glob, const double* local, void* dx, void* dother,
                      long long n, int hw, int channels, int splits, double count, bool relu,
                      int sms, cudaStream_t stream) {
  auto kernel = bn_grad_apply_kernel<T, V, MODE>;
  const int smem = (MODE == 2 ? 8 : 4) * channels * (int)sizeof(float);
  const long long nvec = n / V;
  long long grid = 0, chunk = 0;
  const int err = elementwise_grid(kernel, smem, nvec, sms, &grid, &chunk);
  if (err != 0) return err;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(y), static_cast<const T*>(x),
      static_cast<const T*>(other), g1, g2, glob, local, static_cast<T*>(dx),
      static_cast<T*>(dother), nvec, chunk, hw, channels, splits, count, relu);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int apply_mode(int mode, const void* x, const void* other, Norm n1, Norm n2, Update up, void* y,
               long long n, int hw, int channels, int splits, bool relu, int sms, cudaStream_t s) {
  switch (mode) {
    case 0: return launch_apply<T, V, 0>(x, other, n1, n2, up, y, n, hw, channels, splits, relu, sms, s);
    case 1: return launch_apply<T, V, 1>(x, other, n1, n2, up, y, n, hw, channels, splits, relu, sms, s);
    case 2: return launch_apply<T, V, 2>(x, other, n1, n2, up, y, n, hw, channels, splits, relu, sms, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_apply(int mode, const void* x, const void* other, Norm n1, Norm n2, Update up, void* y,
                   long long n, int hw, int channels, int splits, bool relu, int sms,
                   cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = n % V == 0 && aligned16(x) && aligned16(y) && (mode == 0 || aligned16(other));
  return vec ? apply_mode<T, V>(mode, x, other, n1, n2, up, y, n, hw, channels, splits, relu, sms, s)
             : apply_mode<T, 1>(mode, x, other, n1, n2, up, y, n, hw, channels, splits, relu, sms, s);
}

template <typename T, int V>
int grad_apply_mode(int mode, const void* dy, const void* y, const void* x, const void* other,
                    GradNorm g1, GradNorm g2, const double* glob, const double* local, void* dx,
                    void* dother, long long n, int hw, int channels, int splits, double count,
                    bool relu, int sms, cudaStream_t s) {
  switch (mode) {
    case 0: return launch_grad_apply<T, V, 0>(dy, y, x, other, g1, g2, glob, local, dx, dother, n, hw,
                                              channels, splits, count, relu, sms, s);
    case 1: return launch_grad_apply<T, V, 1>(dy, y, x, other, g1, g2, glob, local, dx, dother, n, hw,
                                              channels, splits, count, relu, sms, s);
    case 2: return launch_grad_apply<T, V, 2>(dy, y, x, other, g1, g2, glob, local, dx, dother, n, hw,
                                              channels, splits, count, relu, sms, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_grad_apply(int mode, const void* dy, const void* y, const void* x, const void* other,
                        GradNorm g1, GradNorm g2, const double* glob, const double* local, void* dx,
                        void* dother, long long n, int hw, int channels, int splits, double count,
                        bool relu, int sms, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = n % V == 0 && aligned16(dy) && aligned16(y) && aligned16(x) && aligned16(other) &&
                   aligned16(dx) && aligned16(dother);
  return vec ? grad_apply_mode<T, V>(mode, dy, y, x, other, g1, g2, glob, local, dx, dother, n, hw,
                                     channels, splits, count, relu, sms, s)
             : grad_apply_mode<T, 1>(mode, dy, y, x, other, g1, g2, glob, local, dx, dother, n, hw,
                                     channels, splits, count, relu, sms, s);
}

bool bad_shape(int n, int channels, int hw, int splits) {
  return n <= 0 || channels <= 0 || hw <= 0 || splits <= 0 || (long long)splits > (long long)n * hw;
}

}  // namespace

// x: contiguous NCHW [n, channels, hw] of float32 (bf16 0) or bf16 (bf16 1);
// part: out [splits][channels][2] float64 (sum x, sum x^2).  Returns a cudaError_t.
extern "C" int wadt_bn_train_stats(const void* x, void* part, int n, int channels, int hw,
                                   int splits, int bf16, void* stream) {
  if (bad_shape(n, channels, hw, splits) || x == nullptr || part == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* p = static_cast<double*>(part);
  return bf16 ? dispatch_reduce<__nv_bfloat16, 0, false>(x, nullptr, nullptr, nullptr, nullptr, p, n,
                                                         channels, hw, splits, s)
              : dispatch_reduce<float, 0, false>(x, nullptr, nullptr, nullptr, nullptr, p, n, channels,
                                                 hw, splits, s);
}

// y = relu?(norm1(x) [+ other (mode 1) | + norm2(other) (mode 2)]), x, other,
// y contiguous NCHW; part1/part2 [splits][channels][2] float64 from
// wadt_bn_train_stats (summed over the ranks on a mesh); scale, bias [C] of
// x's type; rmean, rvar [C] float32; stats out [2][C] float32 (batch mean,
// variance), run out [2][C] float32 (new running mean, variance); count the
// values each channel reduced.  Returns a cudaError_t.
extern "C" int wadt_bn_train_apply(const void* x, const void* other, const void* part1,
                                   const void* scale1, const void* bias1, const void* rmean1,
                                   const void* rvar1, void* stats1, void* run1, const void* part2,
                                   const void* scale2, const void* bias2, const void* rmean2,
                                   const void* rvar2, void* stats2, void* run2, void* y, int n,
                                   int channels, int hw, int splits, double count,
                                   int mode, int relu, int bf16, int sms, void* stream) {
  if (bad_shape(n, channels, hw, splits) || sms <= 0 || mode < 0 || mode > 2 || count < 1.0 ||
      (mode != 0 && other == nullptr) || (mode == 2 && part2 == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Norm n1{static_cast<const double*>(part1), scale1, bias1, static_cast<const float*>(rmean1),
                static_cast<const float*>(rvar1), static_cast<float*>(stats1), static_cast<float*>(run1)};
  const Norm n2{static_cast<const double*>(part2), scale2, bias2, static_cast<const float*>(rmean2),
                static_cast<const float*>(rvar2), static_cast<float*>(stats2), static_cast<float*>(run2)};
  const Update up{count, 1.0f - kMomentum,
                  (float)(count / (count > 1.0 ? count - 1.0 : 1.0))};
  const long long total = (long long)n * channels * hw;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_apply<__nv_bfloat16>(mode, x, other, n1, n2, up, y, total, hw, channels,
                                              splits, relu != 0, sms, s)
              : dispatch_apply<float>(mode, x, other, n1, n2, up, y, total, hw, channels, splits,
                                      relu != 0, sms, s);
}

// The gradient's sums: part out [splits][channels][K] float64 with K 2
// (sum g, sum g (x - mean)) or, with a second norm (other given), 3 (and
// sum g (other - mean2)); stats [4][C] float32 as the forward wrote them
// (mean, variance, then the second norm's).  Returns a cudaError_t.
extern "C" int wadt_bn_train_grad_stats(const void* dy, const void* y, const void* x,
                                        const void* other, const void* stats, void* part, int n,
                                        int channels, int hw, int splits, int relu, int bf16,
                                        void* stream) {
  if (bad_shape(n, channels, hw, splits) || dy == nullptr || x == nullptr || stats == nullptr ||
      (relu && y == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const float* st = static_cast<const float*>(stats);
  double* p = static_cast<double*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool two = other != nullptr;
  if (bf16) {
    using B = __nv_bfloat16;
    if (two) {
      return relu ? dispatch_reduce<B, 2, true>(x, dy, y, other, st, p, n, channels, hw, splits, s)
                  : dispatch_reduce<B, 2, false>(x, dy, y, other, st, p, n, channels, hw, splits, s);
    }
    return relu ? dispatch_reduce<B, 1, true>(x, dy, y, other, st, p, n, channels, hw, splits, s)
                : dispatch_reduce<B, 1, false>(x, dy, y, other, st, p, n, channels, hw, splits, s);
  }
  if (two) {
    return relu ? dispatch_reduce<float, 2, true>(x, dy, y, other, st, p, n, channels, hw, splits, s)
                : dispatch_reduce<float, 2, false>(x, dy, y, other, st, p, n, channels, hw, splits, s);
  }
  return relu ? dispatch_reduce<float, 1, true>(x, dy, y, other, st, p, n, channels, hw, splits, s)
              : dispatch_reduce<float, 1, false>(x, dy, y, other, st, p, n, channels, hw, splits, s);
}

// dx, and dother (mode 1: g; mode 2: the second norm's input's gradient),
// all contiguous NCHW of x's type; stats as for wadt_bn_train_grad_stats;
// scale1/scale2 [C] of x's type; glob and local [splits][channels][K] the
// gradient's sums summed over the ranks and this rank's (the same pointer
// on one card); dvec out [4][C] of x's type (dscale, dbias, then the
// second norm's).  Returns a cudaError_t.
extern "C" int wadt_bn_train_grad_apply(const void* dy, const void* y, const void* x,
                                        const void* other, const void* stats, const void* scale1,
                                        const void* scale2, const void* glob, const void* local,
                                        void* dx, void* dother, void* dvec, int n, int channels,
                                        int hw, int splits, double count, int mode, int relu,
                                        int bf16, int sms, void* stream) {
  if (bad_shape(n, channels, hw, splits) || sms <= 0 || mode < 0 || mode > 2 || count < 1.0 ||
      (mode != 0 && dother == nullptr) || (mode == 2 && (other == nullptr || scale2 == nullptr)) ||
      (relu && y == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const float* st = static_cast<const float*>(stats);
  const int es = bf16 ? 2 : 4;
  const GradNorm g1{st, scale1, dvec, 1};
  const GradNorm g2{st + 2 * channels, scale2,
                    static_cast<char*>(dvec) + (long long)2 * channels * es, 2};
  const long long total = (long long)n * channels * hw;
  const double* gp = static_cast<const double*>(glob);
  const double* lp = static_cast<const double*>(local);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_grad_apply<__nv_bfloat16>(mode, dy, y, x, other, g1, g2, gp, lp, dx, dother,
                                                   total, hw, channels, splits, count, relu != 0, sms, s)
              : dispatch_grad_apply<float>(mode, dy, y, x, other, g1, g2, gp, lp, dx, dother, total, hw,
                                           channels, splits, count, relu != 0, sms, s);
}
