// PMG stem for Hopper (sm_90a): uint8 image -> first trunk block.
//
// Replaces the Pallas TPU kernel `fused_stem`
// (heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu/ops/pallas_kernels.py:118,
// body `_stem_kernel` :92), the same math as the packed GEMM stem of
// `pmg.packed_trunk_features` (models/pmg.py:346-358).
//
// What it computes, for raw uint8 NHWC x[B, H, W, cin] and a kernel == stride
// == k, pad 0 convolution whose ImageNet normalize is folded into the weight
// w[k*k*cin, cout] (row order dy, dx, ci) and into shift:
//   y[b, hp, wp, co] = act(scale[co] * sum_{dy,dx,ci} float(x[b, hp*k+dy,
//                      wp*k+dx, ci]) * w[(dy*k+dx)*cin+ci, co] + shift[co])
// with act = LeakyReLU(0.2) when `leaky` is set, else identity.  scale/shift
// carry the folded inference batch norm (identity scale for other norms).
//
// What bounds it: at the main path's shape (B = 256, 224x224x3 -> 56x56x32)
// it reads 38.5 MB and writes 102.8 MB, about 42 us at 3.35 TB/s, and does
// 2.47 GFLOP, about 37 us of float32 FMA at 67 TFLOP/s.  The two bounds are
// close, so the design keeps both the FMA loop and the stores lean.
//
// What the design does about it:
//  - The input is read as raw bytes, converted to float in registers; no
//    space-to-depth copy and no float image exist in device memory.  The
//    lanes of a warp hold consecutive output pixels, so each load of a warp
//    falls on one contiguous span of an input row.  For the main path's
//    k = 4, cin = 3 (a pixel's row span is 12 bytes, three 32-bit words) the
//    kernel is compiled for those sizes: each input row's words are loaded
//    as 32-bit words and the loop is fully unrolled.  Other sizes take the
//    same kernel with runtime loops and byte loads.
//  - Each thread computes four output pixels x 16 channels per pass (64
//    float32 accumulators).  The weights sit in shared memory, padded to a
//    multiple of 16 channels, and are read as warp-uniform float4
//    broadcasts: 4 shared loads per 64 FMAs.
//  - The affine and LeakyReLU run in registers; the result goes through
//    shared memory (float4 slots, XOR-swizzled so neither side conflicts on
//    banks) so that each warp stores whole pixels' channel runs, 16 bytes a
//    lane.
// Not done yet: tensor cores.  uint8 values are exact in bf16 and TF32, but
// the folded weights are not, so a tensor-core stem needs split weights.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPpt = 4;                 // output pixels per thread
constexpr int kPix = kPpt * kThreads;   // output pixels per block
constexpr int kCh = 16;                 // output channels per pass
constexpr int kQ = kCh / 4;             // float4 slots per pixel and pass
constexpr int kMinBlocks = 4;           // 16 warps per SM: caps registers at 128 a thread

// Staging slot of pixel slot ps, channel slot q (one float4): XOR-swizzled
// so that any 8 consecutive lanes, writing one slot each by pixel or
// reading one pixel's slots, hit 8 distinct 16-byte bank groups.
__device__ __forceinline__ int out_slot(int ps, int q) {
  return ps * kQ + (q ^ ((ps / (8 / kQ)) % kQ));
}

// acc[p] += v[p] * w_row[0:kCh] for each of the thread's pixels.
__device__ __forceinline__ void fma_row(const float* s_w_row, const float (&v)[kPpt],
                                        float (&acc)[kPpt][kCh]) {
  const float4* wr = reinterpret_cast<const float4*>(s_w_row);
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const float4 wv = wr[q];
#pragma unroll
    for (int p = 0; p < kPpt; ++p) {
      acc[p][4 * q + 0] = fmaf(v[p], wv.x, acc[p][4 * q + 0]);
      acc[p][4 * q + 1] = fmaf(v[p], wv.y, acc[p][4 * q + 1]);
      acc[p][4 * q + 2] = fmaf(v[p], wv.z, acc[p][4 * q + 2]);
      acc[p][4 * q + 3] = fmaf(v[p], wv.w, acc[p][4 * q + 3]);
    }
  }
}

// KC, CINC: kernel size and input channels fixed at compile time (word
// loads, unrolled loop), or 0 for runtime loops with byte loads.
template <int KC, int CINC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
stem_kernel(const uint8_t* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ scale, const float* __restrict__ shift,
            float* __restrict__ y, int H, int W, int cin_rt, int k_rt, int Hp,
            int Wp, int cout, int cpad, long long npix, int leaky, bool vec4) {
  const int k = KC ? KC : k_rt;
  const int cin = CINC ? CINC : cin_rt;
  extern __shared__ float4 smem4[];
  const int K = k * k * cin;
  float* s_w = reinterpret_cast<float*>(smem4);       // [K][cpad]
  float4* s_out = smem4 + (size_t)K * cpad / 4;       // [kPix][kQ], swizzled

  if (cout == cpad && vec4) {
    for (int e = threadIdx.x; e < K * cpad / 4; e += kThreads)
      smem4[e] = __ldg(reinterpret_cast<const float4*>(w) + e);
  } else {
    for (int e = threadIdx.x; e < K * cpad; e += kThreads) {
      const int kk = e / cpad;
      const int c = e % cpad;
      s_w[e] = c < cout ? w[(size_t)kk * cout + c] : 0.f;
    }
  }

  // The thread's pixels are pix0 + threadIdx.x + p * kThreads: the lanes of
  // a warp hold consecutive pixels.  32-bit index math: npix < 2^31.
  const long long pix0 = (long long)blockIdx.x * kPix;
  long long base[kPpt];
#pragma unroll
  for (int p = 0; p < kPpt; ++p) {
    // a tail lane loads a valid pixel; its store is masked
    const int pix = (int)min(pix0 + threadIdx.x + p * kThreads, npix - 1);
    const int hw = Hp * Wp;
    const int b = pix / hw;
    const int r = pix - b * hw;
    const int hp = r / Wp;
    const int wp = r - hp * Wp;
    base[p] = (((long long)b * H + hp * k) * W + wp * k) * cin;
  }
  __syncthreads();

  for (int c0 = 0; c0 < cpad; c0 += kCh) {
    float acc[kPpt][kCh];
#pragma unroll
    for (int p = 0; p < kPpt; ++p)
#pragma unroll
      for (int j = 0; j < kCh; ++j) acc[p][j] = 0.f;

    if constexpr (KC && CINC) {
      static_assert(KC * CINC % 4 == 0, "word loads need k*cin % 4 == 0");
      constexpr int kWords = KC * CINC / 4;  // a pixel's span of one input row
#pragma unroll
      for (int dy = 0; dy < KC; ++dy) {
        uint32_t words[kPpt][kWords];
#pragma unroll
        for (int p = 0; p < kPpt; ++p)
#pragma unroll
          for (int i = 0; i < kWords; ++i)
            words[p][i] = __ldg(reinterpret_cast<const uint32_t*>(
                                    x + base[p] + (long long)dy * W * CINC) + i);
#pragma unroll
        for (int bi = 0; bi < KC * CINC; ++bi) {  // byte bi = dx*cin + ci of the row
          float v[kPpt];
#pragma unroll
          for (int p = 0; p < kPpt; ++p)
            v[p] = (float)((words[p][bi / 4] >> (8 * (bi % 4))) & 0xffu);
          fma_row(s_w + (size_t)(dy * KC * CINC + bi) * cpad + c0, v, acc);
        }
      }
    } else {
      int kk = 0;
      for (int dy = 0; dy < k; ++dy) {
        for (int dx = 0; dx < k; ++dx) {
          const long long off = ((long long)dy * W + dx) * cin;
          for (int ci = 0; ci < cin; ++ci, ++kk) {
            float v[kPpt];
#pragma unroll
            for (int p = 0; p < kPpt; ++p) v[p] = (float)__ldg(x + base[p] + off + ci);
            fma_row(s_w + (size_t)kk * cpad + c0, v, acc);
          }
        }
      }
    }

    // the epilogue, in place
#pragma unroll
    for (int j = 0; j < kCh; ++j) {
      const int c = c0 + j;
      const float sc = c < cout ? __ldg(scale + c) : 0.f;
      const float sh = c < cout ? __ldg(shift + c) : 0.f;
#pragma unroll
      for (int p = 0; p < kPpt; ++p) {
        acc[p][j] = fmaf(acc[p][j], sc, sh);
        if (leaky) acc[p][j] = acc[p][j] >= 0.f ? acc[p][j] : acc[p][j] * 0.2f;
      }
    }
#pragma unroll
    for (int p = 0; p < kPpt; ++p) {
      const int ps = threadIdx.x + p * kThreads;
#pragma unroll
      for (int q = 0; q < kQ; ++q)
        s_out[out_slot(ps, q)] = make_float4(
            acc[p][4 * q], acc[p][4 * q + 1], acc[p][4 * q + 2], acc[p][4 * q + 3]);
    }
    __syncthreads();
    const int nc = min(kCh, cout - c0);
    if (vec4 && nc == kCh) {
      float4* y4 = reinterpret_cast<float4*>(y);
      for (int e = threadIdx.x; e < kPix * kQ; e += kThreads) {
        const int ps = e / kQ;
        const int q = e % kQ;
        const long long pix = pix0 + ps;
        if (pix < npix) y4[(pix * cout + c0) / 4 + q] = s_out[out_slot(ps, q)];
      }
    } else {
      const float* s_f = reinterpret_cast<const float*>(s_out);
      for (int e = threadIdx.x; e < kPix * nc; e += kThreads) {
        const int ps = e / nc;
        const int j = e % nc;
        const long long pix = pix0 + ps;
        if (pix < npix)
          y[pix * cout + c0 + j] = s_f[out_slot(ps, j / 4) * 4 + j % 4];
      }
    }
    __syncthreads();  // s_out is rewritten by the next pass
  }
}

template <int KC, int CINC>
int launch(const void* x, const void* w, const void* scale, const void* shift,
           void* y, int B, int H, int W, int cin, int k, int cout, int leaky,
           cudaStream_t stream) {
  const int Hp = H / k;
  const int Wp = W / k;
  const int cpad = (cout + kCh - 1) / kCh * kCh;
  const long long npix = (long long)B * Hp * Wp;
  const size_t smem = ((size_t)k * k * cin * cpad + (size_t)kPix * kCh) * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stem_kernel<KC, CINC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // float4 weight copies and output stores need cout % 4 == 0 and 16-byte alignment
  const bool vec4 = cout % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const long long blocks = (npix + kPix - 1) / kPix;
  stem_kernel<KC, CINC><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<const float*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<float*>(y), H, W, cin, k, Hp, Wp, cout, cpad, npix, leaky, vec4);
  return (int)cudaGetLastError();
}

}  // namespace

// x: uint8 [B, H, W, cin]; w: float32 [k*k*cin, cout]; scale, shift: float32
// [cout]; y: float32 [B, H/k, W/k, cout]; all contiguous.  Rows and columns
// beyond a multiple of k are ignored, as by a pad-0 stride-k convolution.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int wadt_stem_u8_f32(const void* x, const void* w, const void* scale,
                                const void* shift, void* y, int B, int H, int W,
                                int cin, int k, int cout, int leaky,
                                void* stream) {
  if (B <= 0 || cin <= 0 || k <= 0 || cout <= 0 || H < k || W < k ||
      (long long)B * (H / k) * (W / k) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  // word loads need every pixel's row span 4-byte aligned
  const bool words = k == 4 && cin == 3 && (W * cin) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return words ? launch<4, 3>(x, w, scale, shift, y, B, H, W, cin, k, cout, leaky, s)
               : launch<0, 0>(x, w, scale, shift, y, B, H, W, cin, k, cout, leaky, s);
}
