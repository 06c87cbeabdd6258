// Per-patch Gram tokens for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `patch_gram_tokens_pallas`
// (heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu/ops/pallas_kernels.py:68,
// body `_gram_kernel` :32).
//
// What it computes, for an NHWC map x[B, H, W, C] and a div x div grid:
// replicate-pad bottom and right to a multiple of div, split into div*div
// disjoint patches in row-major order, and for each patch P [ph*pw, C] write
// G = P^T P / (ph*pw), flattened row-major, to out[B, div*div, C*C].  Two
// entry points: float32 in and out, and bf16 in and out (the bf16 batch
// path), which sums in float32 and rounds G once to bf16 (nearest even),
// as the JAX package's `.astype(x.dtype)` after its float32 einsum does.
//
// What bounds it: memory.  At the main path's shape (B = 256, 14x14x96,
// div 3: nine 5x5 patches) it reads 19.3 MB and writes 84.9 MB, about 31 us
// at 3.35 TB/s, against 1.06 GFLOP, about 16 us of float32 FMA at 67 TFLOP/s.
//
// What the design does about it: each input byte is read from device memory
// once and each output byte written once, in full 128-byte lines.
//  - One block per (image, patch).  The block stages its patch in shared
//    memory (25 x 96 floats = 9.6 KB at the main shape), clamping rows and
//    columns to H-1 and W-1: that clamp is the replicate pad, so no padded
//    copy of the map is ever written.
//  - 256 threads as a 16 x 16 grid each own a 6 x 6 tile of a 96 x 96 output
//    tile and accumulate it in registers in float32, in pixel order.  They
//    read their operands as float2: a warp's column reads fall on 32
//    distinct banks, its row reads are broadcasts.
//  - The finished tile goes back through shared memory, so the store to
//    device memory is one contiguous run per output row.
//  - A wider C loops over 96 x 96 output tiles; a patch larger than the
//    shared buffer is staged in chunks of pixels.
// Not done yet: G is symmetric, so half the FMAs could go; the bytes, which
// bound the kernel, would stay the same.  In bf16 both are halved (9.6 MB in,
// 42.5 MB out at the main shape).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;            // 16 x 16
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 6;                 // per-thread output tile edge
constexpr int kBlockTile = 16 * kTile;   // 96: output tile edge of a block
constexpr int kSmemFloats = 12288;       // 48 KB of shared memory

using bf16 = __nv_bfloat16;

// One pixel's C channels into the float32 staging buffer; vec: 16-byte
// loads (C % 4 == 0 for float, C % 8 == 0 for bf16, src 16-byte aligned).
__device__ __forceinline__ void stage_pixel(float* dst, const float* src, int C, int lane,
                                            bool vec) {
  if (vec) {
    for (int q = lane; q < C / 4; q += 32)
      reinterpret_cast<float4*>(dst)[q] = __ldg(reinterpret_cast<const float4*>(src) + q);
  } else {
    for (int ch = lane; ch < C; ch += 32) dst[ch] = __ldg(src + ch);
  }
}

__device__ __forceinline__ void stage_pixel(float* dst, const bf16* src, int C, int lane,
                                            bool vec) {
  if (vec) {
    for (int q = lane; q < C / 8; q += 32) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(src) + q);
      const bf16* h = reinterpret_cast<const bf16*>(&u);
      float4* d = reinterpret_cast<float4*>(dst) + 2 * q;
      d[0] = make_float4(__bfloat162float(h[0]), __bfloat162float(h[1]),
                         __bfloat162float(h[2]), __bfloat162float(h[3]));
      d[1] = make_float4(__bfloat162float(h[4]), __bfloat162float(h[5]),
                         __bfloat162float(h[6]), __bfloat162float(h[7]));
    }
  } else {
    for (int ch = lane; ch < C; ch += 32) dst[ch] = __bfloat162float(src[ch]);
  }
}

// One output row of the finished tile; vec: 16-byte (float) or 8-byte
// (bf16) stores, cols % 4 == 0 and dst aligned to them.
__device__ __forceinline__ void store_row(float* dst, const float* src, int cols, int lane,
                                          bool vec) {
  if (vec) {
    for (int q = lane; q < cols / 4; q += 32)
      reinterpret_cast<float4*>(dst)[q] = reinterpret_cast<const float4*>(src)[q];
  } else {
    for (int j = lane; j < cols; j += 32) dst[j] = src[j];
  }
}

__device__ __forceinline__ void store_row(bf16* dst, const float* src, int cols, int lane,
                                          bool vec) {
  if (vec) {
    for (int q = lane; q < cols / 4; q += 32) {
      const float4 v = reinterpret_cast<const float4*>(src)[q];
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      uint2 u;
      u.x = *reinterpret_cast<const unsigned*>(&lo);
      u.y = *reinterpret_cast<const unsigned*>(&hi);
      reinterpret_cast<uint2*>(dst)[q] = u;
    }
  } else {
    for (int j = lane; j < cols; j += 32) dst[j] = __float2bfloat16_rn(src[j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
patch_gram_kernel(const T* __restrict__ x, T* __restrict__ out,
                  int H, int W, int C, int div, int ph, int pw, int chunk,
                  float inv_area, bool vec_in, bool vec_out) {
  extern __shared__ float s[];  // a chunk of the patch [chunk][C], then the output tile
  const int np = div * div;
  const int b = blockIdx.x / np;
  const int p = blockIdx.x % np;
  const int r0 = (p / div) * ph;
  const int c0 = (p % div) * pw;
  const int area = ph * pw;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* xb = x + (size_t)b * H * W * C;
  T* ob = out + ((size_t)b * np + p) * (size_t)C * C;

  for (int i0 = 0; i0 < C; i0 += kBlockTile) {
    for (int j0 = 0; j0 < C; j0 += kBlockTile) {
      const int ii = i0 + ty * kTile;
      const int jj = j0 + tx * kTile;
      float acc[kTile][kTile];
#pragma unroll
      for (int u = 0; u < kTile; ++u)
#pragma unroll
        for (int v = 0; v < kTile; ++v) acc[u][v] = 0.f;

      for (int n0 = 0; n0 < area; n0 += chunk) {
        const int nn = min(chunk, area - n0);
        __syncthreads();  // the buffer's previous contents are consumed
        // one warp per pixel: a pixel's C channels are contiguous in x
        for (int n = warp; n < nn; n += kWarps) {
          const int pn = n0 + n;
          const int row = min(r0 + pn / pw, H - 1);
          const int col = min(c0 + pn % pw, W - 1);
          stage_pixel(s + n * C, xb + ((size_t)row * W + col) * C, C, lane, vec_in);
        }
        __syncthreads();
        const bool full = ii + kTile <= C && jj + kTile <= C;
        for (int n = 0; n < nn; ++n) {
          const float* sr = s + n * C;
          float a[kTile], bv[kTile];
          if (vec_in && full) {
            // float2 reads: a warp's 16 column tiles then fall on 32 distinct
            // banks (stride 6 words, 2 words each), one wavefront per read
#pragma unroll
            for (int t = 0; t < kTile; t += 2) {
              const float2 av = *reinterpret_cast<const float2*>(sr + ii + t);
              const float2 bw = *reinterpret_cast<const float2*>(sr + jj + t);
              a[t] = av.x;
              a[t + 1] = av.y;
              bv[t] = bw.x;
              bv[t + 1] = bw.y;
            }
          } else {
#pragma unroll
            for (int t = 0; t < kTile; ++t) {
              a[t] = (ii + t < C) ? sr[ii + t] : 0.f;
              bv[t] = (jj + t < C) ? sr[jj + t] : 0.f;
            }
          }
#pragma unroll
          for (int u = 0; u < kTile; ++u)
#pragma unroll
            for (int v = 0; v < kTile; ++v) acc[u][v] = fmaf(a[u], bv[v], acc[u][v]);
        }
      }

      __syncthreads();  // done with the patch: the buffer takes the output tile
#pragma unroll
      for (int u = 0; u < kTile; ++u)
#pragma unroll
        for (int v = 0; v < kTile; ++v)
          s[(ty * kTile + u) * kBlockTile + tx * kTile + v] = acc[u][v] * inv_area;
      __syncthreads();
      // one warp per output row: each row of the tile is contiguous in out
      const int rows = min(kBlockTile, C - i0);
      const int cols = min(kBlockTile, C - j0);
      for (int i = warp; i < rows; i += kWarps)
        store_row(ob + (size_t)(i0 + i) * C + j0, s + i * kBlockTile, cols, lane, vec_out);
    }
  }
}

template <typename T>
int launch(const void* x, void* out, int B, int H, int W, int C, int div, bool vec_in,
           bool vec_out, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || div <= 0 || C > kSmemFloats)
    return (int)cudaErrorInvalidValue;
  const int ph = (H + div - 1) / div;
  const int pw = (W + div - 1) / div;
  const int area = ph * pw;
  const int chunk = std::min(kSmemFloats / C, area);
  const size_t smem =
      (size_t)std::max(chunk * C, kBlockTile * kBlockTile) * sizeof(float);
  patch_gram_kernel<T><<<B * div * div, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), H, W, C, div, ph, pw, chunk,
      1.0f / (float)area, vec_in, vec_out);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

}  // namespace

// x: float32 [B, H, W, C] contiguous; out: float32 [B, div*div, C*C].
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int wadt_patch_gram_f32(const void* x, void* out, int B, int H, int W,
                                   int C, int div, void* stream) {
  // float4 loads and stores need C % 4 == 0 and 16-byte aligned tensors
  return launch<float>(x, out, B, H, W, C, div, C % 4 == 0 && aligned(x, 16),
                       C % 4 == 0 && aligned(out, 16), stream);
}

// x: bf16 [B, H, W, C] contiguous; out: bf16 [B, div*div, C*C].
extern "C" int wadt_patch_gram_bf16(const void* x, void* out, int B, int H, int W,
                                    int C, int div, void* stream) {
  // 16-byte loads of 8 channels; 8-byte stores of 4 values
  return launch<bf16>(x, out, B, H, W, C, div, C % 8 == 0 && aligned(x, 16),
                      C % 4 == 0 && aligned(out, 8), stream);
}
