// Instance norm and LeakyReLU of the PM trunk for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves each trunk block's
// instance norm and LeakyReLU to XLA, which fuses them into the
// convolution's output pass.  PyTorch runs them eagerly, as about nine
// passes over each convolution's output (ops/norms.instance_norm, then
// ops/nn.leaky_relu: statistics, strided differences and products, the
// compare, the slope's product and torch.where); this kernel is one.
//
// What it computes, on x [N, HW, C] (the convolution's output as it lies
// in memory: channels last, contiguous) float32 or bf16, with the norm's
// affine scale[C] and bias[C] of x's type, for each (image n, channel c):
//   mean  = the mean of x[n, :, c] over its HW rows
//   var   = the population variance over the same rows
//   rstd  = 1 / sqrt(var + 1e-5)                       (ops/norms.EPS)
//   y     = ((x - mean) * rstd) * scale[c] + bias[c]   each step rounded
//   y     = y >= 0 ? y : y * slope                      (torch.where, NaN kept)
// in float32, with one rounding to x's type at the store.  The last four
// steps are separate float32 operations rounded to nearest (__fsub_rn,
// __fmul_rn, __fadd_rn: no FMA contraction), in the plain version's order
// (ops/cuda_kernels.instance_norm_leaky_plain), so in float32 the two
// differ only by their statistics' rounding.
//
// Statistics, never as E[x^2] - mean^2: a thread holds up to kRows of its
// rows in registers and takes their mean, then the sum of squared
// deviations from it (two passes over the registers, float32); those
// (count, mean, M2) triples are merged pairwise in float64 (Chan, Golub
// and LeVeque's update), first a thread's successive row chunks, then the
// block's threads in a tree over the lanes, and the mean and variance
// rounded once to float32.  A float32 merge of 32 to 400 triples drifts by
// a few units in the last place, which a mean far from zero carries into
// every output; the float64 merges cost a few operations a chunk.  No
// atomics: two calls give the same bits.
//
// What bounds it: bytes.  x is read and y written: 8 bytes an element in
// float32.  At the PM headline trunk (batch 256, 224 px) the five sites
// hold 429.65 M elements, 3.44 GB read once and written once, 1.03 ms at
// 3.35 TB/s.
//
// What the design does about it:
//  - Layout: the trunk's convolutions return channels-last memory (cuDNN
//    follows its NHWC input), so a row of C channels is contiguous and a
//    plane (one channel's HW values) is strided.  One block per (image,
//    slab of channels): 32 float32 or 64 bf16 channels, 128 contiguous
//    bytes of each row, so each load of a warp is whole 128-byte lines.  A
//    thread owns one 16-byte vector of channels (4 float32, 8 bf16) and the
//    rows lane, lane + lanes, ...; a tensor whose channels or pointers do
//    not allow 16-byte vectors takes the scalar variant.
//  - Where a thread's rows fit its registers (HW <= kRows * lanes: the 14x14
//    and 13x13 sites), the block reads its tile once, keeps it in registers
//    through the statistics and writes y from them: one read, one write.
//    Larger planes (112x112, 56x56, 28x28) do not fit on chip in this
//    layout (a 112x112 plane of 32 channels is 1.6 MB), so the block
//    streams its rows twice: once for the statistics and once to normalise
//    (two reads, one write; 1.46 ms at 3.35 TB/s over the five sites).
//  - Loads go out kRows at a time before any arithmetic on them, so each
//    thread keeps kRows 16-byte loads in flight.
//  - y may be x (in place): each element is read and written by the same
//    thread, and in the cached variant only after the block's statistics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;     // rows a thread holds in registers at once
constexpr int kSlabBytes = 128;
constexpr float kEps = 1e-5f;  // ops/norms.EPS

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

// (mean, m2) of n values += (mean_b, m2_b) of nb more: Chan, Golub and
// LeVeque's pairwise update of a mean and a sum of squared deviations.  The
// weight is a float32 quotient (a float64 one is a slow software sequence):
// its rounding moves the mean by 1e-7 of the two means' difference.
__device__ __forceinline__ void merge(double& mean, double& m2, float n, float nb, double mean_b,
                                      double m2_b) {
  if (nb == 0.0f) return;
  const double wb = nb / (n + nb);
  const double d = mean_b - mean;
  mean += d * wb;
  m2 += m2_b + d * d * n * wb;
}

template <typename T, int V, bool CACHED>
__global__ void __launch_bounds__(kThreads)
    instance_norm_leaky_kernel(const T* x, const T* __restrict__ scale,
                               const T* __restrict__ bias, T* y, float* __restrict__ mean_out,
                               float* __restrict__ rstd_out, int hw, int channels, int slabs,
                               int cvs, float slope) {
  using P = Pack<T, V>;
  __shared__ float s_n[kThreads];
  __shared__ double s_mean[kThreads * V];
  __shared__ double s_m2[kThreads * V];
  __shared__ float s_mu[kThreads];  // the slab's channels: at most 64
  __shared__ float s_rs[kThreads];

  const int n = blockIdx.x / slabs;
  const int slab = blockIdx.x - n * slabs;
  const int lanes = kThreads / cvs;
  const int cv = threadIdx.x % cvs;
  const int lane = threadIdx.x / cvs;
  const int c0 = (slab * cvs + cv) * V;  // this thread's first channel
  const bool active = c0 < channels;     // the host keeps channels % V == 0
  const long long rows0 = (long long)n * hw;

  auto load = [&](int r) {
    return *reinterpret_cast<const P*>(x + (rows0 + r) * channels + c0);
  };

  // -- statistics: each row chunk two-pass in registers, chunks merged ----
  float cnt = 0.0f;
  double mean[V], m2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) mean[j] = m2[j] = 0.0;
  P buf[kRows];
  const int step = kRows * lanes;
  for (int r0 = lane; r0 < hw; r0 += step) {
    const int nb = active ? min(kRows, (hw - r0 + lanes - 1) / lanes) : 0;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (k < nb) buf[k] = load(r0 + k * lanes);
    }
    if (nb == 0) continue;
    float mb[V], m2b[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (k < nb) s += to_f(buf[k].v[j]);
      }
      mb[j] = s / (float)nb;
      float q = 0.0f;
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (k < nb) {
          const float d = to_f(buf[k].v[j]) - mb[j];
          q += d * d;
        }
      }
      m2b[j] = q;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) merge(mean[j], m2[j], cnt, (float)nb, mb[j], m2b[j]);
    cnt += (float)nb;
  }

  // -- the block's threads merged per channel: a tree over the lanes -------
  // (lanes is a power of two; at each level lanes [stride, 2 stride) hand
  // their triples to lanes [0, stride), through slots no other level reads)
  for (int stride = lanes / 2; stride > 0; stride /= 2) {
    if (lane >= stride && lane < 2 * stride) {
      s_n[threadIdx.x] = cnt;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s_mean[threadIdx.x * V + j] = mean[j];
        s_m2[threadIdx.x * V + j] = m2[j];
      }
    }
    __syncthreads();
    if (lane < stride) {
      const int t = threadIdx.x + stride * cvs;
      const float nb = s_n[t];
#pragma unroll
      for (int j = 0; j < V; ++j) merge(mean[j], m2[j], cnt, nb, s_mean[t * V + j], s_m2[t * V + j]);
      cnt += nb;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float mu = (float)mean[j];
      const float rs = __frcp_rn(__fsqrt_rn(__fadd_rn((float)(m2[j] / hw), kEps)));
      s_mu[cv * V + j] = mu;
      s_rs[cv * V + j] = rs;
      if (mean_out != nullptr && active) {
        mean_out[(long long)n * channels + c0 + j] = mu;
        rstd_out[(long long)n * channels + c0 + j] = rs;
      }
    }
  }
  __syncthreads();
  if (!active) return;

  // -- normalise, the affine, LeakyReLU -------------------------------------
  float mu[V], rs[V], sc[V], bi[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mu[j] = s_mu[cv * V + j];
    rs[j] = s_rs[cv * V + j];
    sc[j] = to_f(scale[c0 + j]);
    bi[j] = to_f(bias[c0 + j]);
  }
  auto finish = [&](const P& a) {
    P out;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float v = __fmul_rn(__fsub_rn(to_f(a.v[j]), mu[j]), rs[j]);
      v = __fadd_rn(__fmul_rn(v, sc[j]), bi[j]);
      out.v[j] = from_f<T>(v >= 0.0f ? v : __fmul_rn(v, slope));
    }
    return out;
  };
  auto store = [&](int r, const P& a) {
    *reinterpret_cast<P*>(y + (rows0 + r) * channels + c0) = finish(a);
  };
  if (CACHED) {  // the host guarantees hw <= step: buf holds every row
    const int nb = min(kRows, (hw - lane + lanes - 1) / lanes);
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (k < nb) store(lane + k * lanes, buf[k]);
    }
  } else {
    for (int r0 = lane; r0 < hw; r0 += step) {
      const int nb = min(kRows, (hw - r0 + lanes - 1) / lanes);
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (k < nb) buf[k] = load(r0 + k * lanes);
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (k < nb) store(r0 + k * lanes, buf[k]);
      }
    }
  }
}

template <typename T, int V>
int launch(const void* x, const void* scale, const void* bias, void* y, float* mean_out,
           float* rstd_out, int n, int hw, int channels, float slope, cudaStream_t stream) {
  // channel vectors a slab: a power of two (it divides kThreads), at most
  // kSlabBytes of each row
  const int vecs = (channels + V - 1) / V;
  int cvs = 1;
  while (cvs < vecs && cvs * V * (int)sizeof(T) < kSlabBytes) cvs *= 2;
  const int slabs = (vecs + cvs - 1) / cvs;
  const int lanes = kThreads / cvs;
  const long long grid = (long long)n * slabs;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const bool cached = hw <= kRows * lanes;
  auto kernel = cached ? instance_norm_leaky_kernel<T, V, true>
                       : instance_norm_leaky_kernel<T, V, false>;
  kernel<<<(unsigned)grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale), static_cast<const T*>(bias),
      static_cast<T*>(y), mean_out, rstd_out, hw, channels, slabs, cvs, slope);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* scale, const void* bias, void* y, float* mean_out,
             float* rstd_out, int n, int hw, int channels, float slope, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = channels % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  return vec ? launch<T, V>(x, scale, bias, y, mean_out, rstd_out, n, hw, channels, slope, s)
             : launch<T, 1>(x, scale, bias, y, mean_out, rstd_out, n, hw, channels, slope, s);
}

}  // namespace

// x, y: [n, hw, channels] contiguous (y may be x); scale, bias: [channels]
// of x's type; mean_out, rstd_out: [n, channels] float32, or both null;
// bf16: 0 float32, 1 bf16.  Returns a cudaError_t.
extern "C" int wadt_instance_norm_leaky(const void* x, const void* scale, const void* bias,
                                        void* y, void* mean_out, void* rstd_out, int n, int hw,
                                        int channels, float slope, int bf16, void* stream) {
  if (n <= 0 || hw <= 0 || channels <= 0 || (mean_out == nullptr) != (rstd_out == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mo = static_cast<float*>(mean_out);
  float* ro = static_cast<float*>(rstd_out);
  return bf16 ? dispatch<__nv_bfloat16>(x, scale, bias, y, mo, ro, n, hw, channels, slope, s)
              : dispatch<float>(x, scale, bias, y, mo, ro, n, hw, channels, slope, s);
}
