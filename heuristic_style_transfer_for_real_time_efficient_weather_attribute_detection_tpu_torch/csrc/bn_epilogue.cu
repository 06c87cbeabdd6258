// Inference batch-norm epilogue of the ResNet trunk for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the norm, the residual sum
// and the ReLU after each convolution of the RTM trunk to XLA, which fuses
// them into the convolution's output pass.  PyTorch runs them eagerly, as
// four to six passes over the activation (models/resnet.py); this kernel is
// those passes as one.
//
// What it computes, on a contiguous NCHW tensor x of float32 or bf16 and
// the norm's four per-channel vectors (scale, bias, mean, var) of x's type:
//   inv   = r(scale * r(1 / r(sqrt(r(var + 1e-5)))))
//   shift = r(bias - r(mean * inv))
//   y     = r(r(x * inv[c]) + shift[c])                     mode 0
//   y     = r(y + other)                                   mode 1 (identity)
//   y     = r(y + r(r(other * inv2[c]) + shift2[c]))        mode 2 (downsample)
//   y     = relu(y)                                        if relu
// with r() rounding to x's type (the identity in float32) and c = (i / HW)
// % C for the flat index i.  Each step is one float32 operation rounded to
// nearest (__fmul_rn, __fadd_rn, __fsqrt_rn, __frcp_rn: no FMA contraction)
// and then rounded to the type, as PyTorch's eager operations compute and
// round each one: ops/norms.batch_norm_affine, then x * scale + shift, the
// residual sum and torch.relu (clamp_min: NaN kept, fmaxf otherwise).  So
// the output equals the plain version (ops/cuda_kernels.bn_epilogue_plain)
// bit for bit.
//
// What bounds it: bytes.  x (and other) are read once and y written once:
// 4 or 6 bytes an element in bf16, 8 or 12 in float32; the per-channel
// affine is nothing beside that.  At ResNet-50's batch-128 bf16 trunk the 49
// sites move ~6.3 GB, ~1.9 ms at 3.35 TB/s.
//
// What the design does about it:
//  - 16-byte loads and stores (8 bf16 or 4 float32 a thread) over the flat
//    tensor, so 7x7 maps (HW 49) stream as fast as 56x56 ones; a tensor
//    whose pointers or length do not allow it takes the scalar variant.
//  - Each block owns one contiguous chunk of the flat tensor: a grid of as
//    many blocks as stay resident (occupancy), so there is one wave and no
//    tail of late blocks.  A block computes the affine of the channels its
//    chunk touches (all C only if it spans a whole image) into shared
//    memory, once, before it streams.
//  - A thread's channel is found once by division and then carried along:
//    within a vector one element at a time, between a thread's vectors by
//    the stride's precomputed quotient and remainder.
//  - A thread loads its next vector before it computes the current one, and
//    its first before the block's affine, so two loads of each input are in
//    flight and the affine's arithmetic hides behind the first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
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

// v rounded to T, as float
template <typename T>
__device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

template <typename T>
__device__ __forceinline__ void affine(const T* scale, const T* bias, const T* mean, const T* var,
                                       int c, float* inv, float* shift) {
  const float s = rnd<T>(__fsqrt_rn(rnd<T>(__fadd_rn(to_f(var[c]), kEps))));
  const float i = rnd<T>(__fmul_rn(to_f(scale[c]), rnd<T>(__frcp_rn(s))));
  inv[c] = i;
  shift[c] = rnd<T>(__fsub_rn(to_f(bias[c]), rnd<T>(__fmul_rn(to_f(mean[c]), i))));
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

struct Norm {
  const void* scale;
  const void* bias;
  const void* mean;
  const void* var;
};

template <typename T, int V, int MODE>
__global__ void __launch_bounds__(kThreads)
    bn_epilogue_kernel(const T* __restrict__ x, const T* __restrict__ other, Norm n1, Norm n2,
                       T* __restrict__ y, long long nvec, long long chunk, int hw, int channels,
                       bool relu) {
  extern __shared__ float smem[];  // inv1[C], shift1[C], then inv2[C], shift2[C] in mode 2
  float* inv1 = smem;
  float* shift1 = smem + channels;
  float* inv2 = smem + 2 * channels;
  float* shift2 = smem + 3 * channels;
  const long long j0 = blockIdx.x * chunk;
  const long long j1 = min(nvec, j0 + chunk);
  if (j0 >= j1) return;  // the whole block leaves together

  // this thread's first vector, loaded before the affine below so that
  // its read overlaps the per-channel arithmetic
  using P = Pack<T, V>;
  long long j = j0 + threadIdx.x;
  bool have = j < j1;
  P a, b;
  if (have) {
    a = reinterpret_cast<const P*>(x)[j];
    if (MODE != 0) b = reinterpret_cast<const P*>(other)[j];
  }

  // the channels this chunk touches: planes q0..q1 of the flat [N*C, HW]
  const long long q0 = j0 * V / hw;
  const long long planes = (j1 * V - 1) / hw - q0 + 1;
  const int touched = planes < channels ? (int)planes : channels;
  const int c_first = (int)(q0 % channels);
  for (int k = threadIdx.x; k < touched; k += kThreads) {
    int c = c_first + k;
    if (c >= channels) c -= channels;
    affine<T>(static_cast<const T*>(n1.scale), static_cast<const T*>(n1.bias),
              static_cast<const T*>(n1.mean), static_cast<const T*>(n1.var), c, inv1, shift1);
    if (MODE == 2) {
      affine<T>(static_cast<const T*>(n2.scale), static_cast<const T*>(n2.bias),
                static_cast<const T*>(n2.mean), static_cast<const T*>(n2.var), c, inv2, shift2);
    }
  }
  __syncthreads();
  if (!have) return;

  // the first vector's position (r in the plane, channel c), and the step
  // to the thread's next vector, kThreads * V elements on
  long long q = j * V / hw;
  int r = (int)(j * V - q * hw);
  int c = (int)(q % channels);
  const long long step = (long long)kThreads * V;
  const int dr = (int)(step % hw);
  const int dc = (int)((step / hw) % channels);

  while (have) {
    // the next vector's loads go out before this one's arithmetic
    const long long jn = j + kThreads;
    const bool more = jn < j1;
    P an, bn;
    if (more) {
      an = reinterpret_cast<const P*>(x)[jn];
      if (MODE != 0) bn = reinterpret_cast<const P*>(other)[jn];
    }
    P out;
    int rr = r, cc = c;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float v = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(to_f(a.v[k]), inv1[cc])), shift1[cc]));
      if (MODE == 1) {
        v = rnd<T>(__fadd_rn(v, to_f(b.v[k])));
      } else if (MODE == 2) {
        const float d = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(to_f(b.v[k]), inv2[cc])), shift2[cc]));
        v = rnd<T>(__fadd_rn(v, d));
      }
      if (relu && !isnan(v)) v = fmaxf(v, 0.0f);
      out.v[k] = from_f<T>(v);
      if (++rr == hw) {
        rr = 0;
        if (++cc == channels) cc = 0;
      }
    }
    reinterpret_cast<P*>(y)[j] = out;
    a = an;
    if (MODE != 0) b = bn;
    j = jn;
    have = more;
    r += dr;
    c += dc;
    if (r >= hw) {
      r -= hw;
      ++c;
    }
    if (c >= channels) c -= channels;
  }
}

template <typename T, int V, int MODE>
int launch(const void* x, const void* other, Norm n1, Norm n2, void* y, long long n, int hw,
           int channels, bool relu, int sms, cudaStream_t stream) {
  auto kernel = bn_epilogue_kernel<T, V, MODE>;
  const int smem = (MODE == 2 ? 4 : 2) * channels * (int)sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  int per_sm = 0;  // resident blocks an SM
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long nvec = n / V;
  const long long want = (nvec + kThreads - 1) / kThreads;
  const long long grid = want < (long long)per_sm * sms ? want : (long long)per_sm * sms;
  const long long chunk = (nvec + grid - 1) / grid;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(other), n1, n2, static_cast<T*>(y), nvec,
      chunk, hw, channels, relu);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int dispatch_mode(int mode, bool relu, const void* x, const void* other, Norm n1, Norm n2, void* y,
                  long long n, int hw, int channels, int sms, cudaStream_t s) {
  switch (mode) {
    case 0: return launch<T, V, 0>(x, other, n1, n2, y, n, hw, channels, relu, sms, s);
    case 1: return launch<T, V, 1>(x, other, n1, n2, y, n, hw, channels, relu, sms, s);
    case 2: return launch<T, V, 2>(x, other, n1, n2, y, n, hw, channels, relu, sms, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch(int mode, bool relu, const void* x, const void* other, Norm n1, Norm n2, void* y,
             long long n, int hw, int channels, int sms, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = n % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                   (mode == 0 || reinterpret_cast<uintptr_t>(other) % 16 == 0);
  return vec ? dispatch_mode<T, V>(mode, relu, x, other, n1, n2, y, n, hw, channels, sms, s)
             : dispatch_mode<T, 1>(mode, relu, x, other, n1, n2, y, n, hw, channels, sms, s);
}

}  // namespace

// x, other, y: contiguous NCHW of n elements (other unused in mode 0);
// s1..v1 the norm of x, s2..v2 the norm of other (mode 2 only), each [C]
// of x's type; bf16: 0 float32, 1 bf16.  Returns a cudaError_t.
extern "C" int wadt_bn_epilogue(const void* x, const void* other, const void* s1, const void* b1,
                                const void* m1, const void* v1, const void* s2, const void* b2,
                                const void* m2, const void* v2, void* y, long long n, int channels,
                                int hw, int mode, int relu, int bf16, int sms, void* stream) {
  if (n <= 0 || channels <= 0 || hw <= 0 || sms <= 0 || mode < 0 || mode > 2 ||
      n % ((long long)channels * hw) != 0 || (mode != 0 && other == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Norm n1{s1, b1, m1, v1}, n2{s2, b2, m2, v2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(mode, relu != 0, x, other, n1, n2, y, n, hw, channels, sms, s)
              : dispatch<float>(mode, relu != 0, x, other, n1, n2, y, n, hw, channels, sms, s);
}
