// Per-patch Gram tokens for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `patch_gram_tokens_pallas`
// (heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu/ops/pallas_kernels.py:68,
// body `_gram_kernel` :32).
//
// What it computes, for an NHWC float32 map x[B, H, W, C] and a div x div grid:
// replicate-pad bottom and right to a multiple of div, split into div*div
// disjoint patches in row-major order, and for each patch P [ph*pw, C] write
// G = P^T P / (ph*pw), flattened row-major, to out[B, div*div, C*C].
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
// bound the kernel, would stay the same.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;            // 16 x 16
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 6;                 // per-thread output tile edge
constexpr int kBlockTile = 16 * kTile;   // 96: output tile edge of a block
constexpr int kSmemFloats = 12288;       // 48 KB of shared memory

__global__ void __launch_bounds__(kThreads)
patch_gram_kernel(const float* __restrict__ x, float* __restrict__ out,
                  int H, int W, int C, int div, int ph, int pw, int chunk,
                  float inv_area, bool vec4) {
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
  const float* xb = x + (size_t)b * H * W * C;
  float* ob = out + ((size_t)b * np + p) * (size_t)C * C;

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
          const float* src = xb + ((size_t)row * W + col) * C;
          float* dst = s + n * C;
          if (vec4) {
            for (int q = lane; q < C / 4; q += 32)
              reinterpret_cast<float4*>(dst)[q] = __ldg(reinterpret_cast<const float4*>(src) + q);
          } else {
            for (int ch = lane; ch < C; ch += 32) dst[ch] = __ldg(src + ch);
          }
        }
        __syncthreads();
        const bool full = ii + kTile <= C && jj + kTile <= C;
        for (int n = 0; n < nn; ++n) {
          const float* sr = s + n * C;
          float a[kTile], bv[kTile];
          if (vec4 && full) {
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
      for (int i = warp; i < rows; i += kWarps) {
        float* dst = ob + (size_t)(i0 + i) * C + j0;
        const float* src = s + i * kBlockTile;
        if (vec4) {
          for (int q = lane; q < cols / 4; q += 32)
            reinterpret_cast<float4*>(dst)[q] = reinterpret_cast<const float4*>(src)[q];
        } else {
          for (int j = lane; j < cols; j += 32) dst[j] = src[j];
        }
      }
    }
  }
}

}  // namespace

// x: float32 [B, H, W, C] contiguous; out: float32 [B, div*div, C*C].
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int wadt_patch_gram_f32(const void* x, void* out, int B, int H, int W,
                                   int C, int div, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || div <= 0 || C > kSmemFloats)
    return (int)cudaErrorInvalidValue;
  const int ph = (H + div - 1) / div;
  const int pw = (W + div - 1) / div;
  const int area = ph * pw;
  const int chunk = std::min(kSmemFloats / C, area);
  const size_t smem =
      (size_t)std::max(chunk * C, kBlockTile * kBlockTile) * sizeof(float);
  // float4 loads and stores need C % 4 == 0 and 16-byte aligned tensors
  const bool vec4 = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  patch_gram_kernel<<<B * div * div, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<float*>(out), H, W, C, div, ph,
      pw, chunk, 1.0f / (float)area, vec4);
  return (int)cudaGetLastError();
}
