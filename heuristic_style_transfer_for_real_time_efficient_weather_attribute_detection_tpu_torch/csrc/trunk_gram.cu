// Fused PMG trunk + per-patch Gram for Hopper (sm_90a): the camera path's
// first kernel, raw uint8 frame -> Gram tokens.
//
// Replaces the Pallas TPU kernel `fused_trunk_gram`
// (heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu/ops/pallas_kernels.py:309,
// body `_trunk_gram_kernel` :273, weight fold `fold_trunk_gram_weights` :206).
//
// What it computes, for raw uint8 NHWC x[B, H, W, cin] and a trunk plan
// [k1 = s1 p0, k2 = s2 p0, 1x1] with K = k1*k2 (16 shipped), on the final
// grid Hf = H/K, Wf = W/K (14 x 14 at 224 px): for each final pixel, with its
// K x K x cin input block,
//   a = bf16(lrelu(x_sub @ W0 + b0))  for each of the k2*k2 sub-cells  (conv1)
//   b = bf16(lrelu(a @ W2 + b2))                                         (conv2)
//   c = bf16(lrelu(b @ W3 + b3))                                         (1x1)
//   z = c @ Wcp + bcp                                     (chan_proj, float32)
// then replicate-pad the z map bottom/right to a multiple of div and write
// each patch's Gram z_p^T z_p / area to out[B, div*div, gc*gc] in float32.
// Weights are bf16, biases float32, every sum float32; bf16(.) rounds to
// nearest even, where the TPU kernel casts.  W0 is read from the
// block-diagonal W0bd[K*K*cin, k2*k2*c0] of the fold: only its (0, 0) block
// [k1*k1*cin, c0], which the fold repeats on the diagonal, so the 15/16
// zeros of conv1 are never multiplied.
//
// What bounds it: at the camera path's shape (B = 1, 224 px, shipped
// widths) it moves 0.15 MB of frame, 0.11 MB of weights and 0.33 MB of
// output, 0.18 us at 3.35 TB/s, and does 2 * 2.4 M FMAs (trunk 1.96 M at 25
// pixels per patch, Gram 0.21 M), 0.07 us at 67 TFLOP/s.  Neither bound
// is reachable at B = 1: the work is nine patches, so at most nine SMs of
// 132 take part, and each patch's chain of four dependent GEMMs runs on one.
// The kernel is bound by the latency of that chain on one SM.
//
// What the design does about it:
//  - One block per (image, patch): 9 blocks at B = 1.  The block computes
//    its patch's final pixels through all four GEMMs, keeping every
//    intermediate in shared memory; only the Gram leaves the block.  The
//    replicate pad is a clamp of the final pixel's index: a duplicated pixel
//    is recomputed and gives the same value.
//  - The frame is read raw by index arithmetic: no K = 16 space-to-depth
//    pack and no padded copy exist.  uint8 is exact in bf16, so the bytes
//    are converted to float once, while staged.
//  - Each layer's bf16 weight is copied to shared memory before its GEMM
//    (16-byte copies); a thread accumulates a TM x 2 output tile in float32
//    registers, reading its input rows as float4 and its weight column pair
//    as one 32-bit word.
// Not done yet: tensor cores (every GEMM operand is bf16 already, so
// `mma.sync` m16n8k16 would give the same products), and splitting a patch
// over more than one SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }
__device__ __forceinline__ float bf16_at(const uint16_t* w, int i) {
  return __uint_as_float((uint32_t)w[i] << 16);
}

// float32 -> bfloat16 -> float32, round to nearest even (finite inputs).
__device__ __forceinline__ float round_bf16(float v) {
  uint32_t u = __float_as_uint(v);
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : 0.2f * v; }

// out[M, N] = epi(in[M, Kd] @ w[Kd, N] + bias[N]); in, out float32 in shared
// memory (row strides Kd and N), w bf16 in shared memory.  epi = LeakyReLU
// then bf16 rounding when `act`, else identity.  No synchronization inside.
template <int TM>
__device__ void gemm_smem(const float* in, int M, int Kd, const uint16_t* w,
                          const float* __restrict__ bias, int N, float* out, bool act) {
  const int ncp = (N + 1) / 2;
  const int nrg = (M + TM - 1) / TM;
  const bool pairs = N % 2 == 0;
  const bool vec = Kd % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0;
  for (int item = threadIdx.x; item < nrg * ncp; item += kThreads) {
    const int rg = item / ncp;
    const int n = (item - rg * ncp) * 2;
    const float* rows[TM];
#pragma unroll
    for (int t = 0; t < TM; ++t) rows[t] = in + (size_t)min(rg * TM + t, M - 1) * Kd;
    float acc[TM][2];
#pragma unroll
    for (int t = 0; t < TM; ++t) acc[t][0] = acc[t][1] = 0.f;
    int k = 0;
    if (vec && pairs) {
      for (; k < Kd; k += 4) {
        float w0[4], w1[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t u = *reinterpret_cast<const uint32_t*>(w + (size_t)(k + j) * N + n);
          w0[j] = bf16_lo(u);
          w1[j] = bf16_hi(u);
        }
#pragma unroll
        for (int t = 0; t < TM; ++t) {
          const float4 v = *reinterpret_cast<const float4*>(rows[t] + k);
          acc[t][0] = fmaf(v.x, w0[0], acc[t][0]);
          acc[t][1] = fmaf(v.x, w1[0], acc[t][1]);
          acc[t][0] = fmaf(v.y, w0[1], acc[t][0]);
          acc[t][1] = fmaf(v.y, w1[1], acc[t][1]);
          acc[t][0] = fmaf(v.z, w0[2], acc[t][0]);
          acc[t][1] = fmaf(v.z, w1[2], acc[t][1]);
          acc[t][0] = fmaf(v.w, w0[3], acc[t][0]);
          acc[t][1] = fmaf(v.w, w1[3], acc[t][1]);
        }
      }
    }
    for (; k < Kd; ++k) {
      const float w0 = bf16_at(w, k * N + n);
      const float w1 = n + 1 < N ? bf16_at(w, k * N + n + 1) : 0.f;
#pragma unroll
      for (int t = 0; t < TM; ++t) {
        acc[t][0] = fmaf(rows[t][k], w0, acc[t][0]);
        acc[t][1] = fmaf(rows[t][k], w1, acc[t][1]);
      }
    }
#pragma unroll
    for (int t = 0; t < TM; ++t) {
      const int r = rg * TM + t;
      if (r >= M) break;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (n + j >= N) break;
        float v = acc[t][j] + bias[n + j];
        if (act) v = round_bf16(lrelu(v));
        out[(size_t)r * N + n + j] = v;
      }
    }
  }
}

// Copy n bf16 values from device to shared memory, 16 bytes at a time where
// both sides allow it.
__device__ void stage_bf16(uint16_t* dst, const uint16_t* __restrict__ src, int n) {
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0 && n % 8 == 0) {
    for (int e = threadIdx.x; e < n / 8; e += kThreads)
      reinterpret_cast<uint4*>(dst)[e] = __ldg(reinterpret_cast<const uint4*>(src) + e);
  } else {
    for (int e = threadIdx.x; e < n; e += kThreads) dst[e] = src[e];
  }
}

struct Shape {
  int H, W, cin, k1, k2, c0, c1, c2, gc, div;
  int K, Hf, Wf, ph, pw, area;
  size_t off_a, off_w;  // byte offsets of the a and weight regions
};

__global__ void __launch_bounds__(kThreads, 1)
trunk_gram_kernel(const uint8_t* __restrict__ x, const uint16_t* __restrict__ w0bd,
                  const float* __restrict__ b0, const uint16_t* __restrict__ w2,
                  const float* __restrict__ b2, const uint16_t* __restrict__ w3,
                  const float* __restrict__ b3, const uint16_t* __restrict__ wcp,
                  const float* __restrict__ bcp, float* __restrict__ out, Shape s) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const int np = s.div * s.div;
  const int b = blockIdx.x / np;
  const int p = blockIdx.x % np;
  const int area = s.area;
  const int cells = s.k2 * s.k2;
  const int kd0 = s.k1 * s.k1 * s.cin;          // conv1 depth (48 shipped)
  float* xin = reinterpret_cast<float*>(smem);  // [area*cells][kd0]
  float* bb = xin;                              // [area][c1], after conv1
  float* cc = bb + (size_t)area * s.c1;         // [area][c2]
  float* zz = cc + (size_t)area * s.c2;         // [area][gc]
  float* aa = reinterpret_cast<float*>(smem + s.off_a);  // [area][cells*c0]
  uint16_t* ws = reinterpret_cast<uint16_t*>(smem + s.off_w);

  // conv1's dense block of W0bd: row (dy*k1+dx)*cin+ci of the block is row
  // (dy*K+dx)*cin+ci of W0bd, columns 0..c0-1
  const int ld0 = cells * s.c0;
  for (int e = threadIdx.x; e < kd0 * s.c0; e += kThreads) {
    const int r = e / s.c0;
    const int co = e - r * s.c0;
    const int dy = r / (s.k1 * s.cin);
    const int rem = r - dy * s.k1 * s.cin;
    ws[e] = w0bd[(size_t)(dy * s.K * s.cin + rem) * ld0 + co];
  }
  // the patch's input blocks, row pix*cells + u*k2 + v, column (dy*k1+dx)*cin+ci
  {
    const int pr = p / s.div, pc = p % s.div;
    const int rowb = s.K * s.cin;  // bytes of one input row of a final pixel
    const int pixb = s.K * rowb;
    const uint8_t* xb = x + (size_t)b * s.H * s.W * s.cin;
    for (int e = threadIdx.x; e < area * pixb; e += kThreads) {
      const int pix = e / pixb;
      const int rem = e - pix * pixb;
      const int Y = rem / rowb;
      const int r2 = rem - Y * rowb;
      const int X = r2 / s.cin;
      const int ci = r2 - X * s.cin;
      const int py = pix / s.pw;
      const int fy = min(pr * s.ph + py, s.Hf - 1);
      const int fx = min(pc * s.pw + (pix - py * s.pw), s.Wf - 1);
      const uint8_t v = xb[((size_t)(fy * s.K + Y) * s.W + fx * s.K + X) * s.cin + ci];
      const int row = pix * cells + (Y / s.k1) * s.k2 + X / s.k1;
      const int col = ((Y % s.k1) * s.k1 + X % s.k1) * s.cin + ci;
      xin[(size_t)row * kd0 + col] = (float)v;
    }
  }
  __syncthreads();
  // conv1: every sub-cell of every pixel is one row; the output rows land in
  // a's [pix][(u*k2+v)*c0 + co] layout as they are.  b0 is the fold's bias
  // tiled k2*k2 times: its first c0 entries.
  gemm_smem<4>(xin, area * cells, kd0, ws, b0, s.c0, aa, true);
  __syncthreads();
  stage_bf16(ws, w2, cells * s.c0 * s.c1);
  __syncthreads();
  gemm_smem<2>(aa, area, cells * s.c0, ws, b2, s.c1, bb, true);
  __syncthreads();
  stage_bf16(ws, w3, s.c1 * s.c2);
  __syncthreads();
  gemm_smem<2>(bb, area, s.c1, ws, b3, s.c2, cc, true);
  __syncthreads();
  stage_bf16(ws, wcp, s.c2 * s.gc);
  __syncthreads();
  gemm_smem<2>(cc, area, s.c2, ws, bcp, s.gc, zz, false);
  __syncthreads();

  // Gram of the patch: each thread a 4 x 4 tile, float32, pixels in order
  const int gc = s.gc;
  const int nt = (gc + 3) / 4;
  const float inv_area = 1.0f / (float)area;
  float* ob = out + ((size_t)b * np + p) * (size_t)gc * gc;
  for (int item = threadIdx.x; item < nt * nt; item += kThreads) {
    const int i0 = (item / nt) * 4;
    const int j0 = (item % nt) * 4;
    float acc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
    for (int n = 0; n < area; ++n) {
      const float* zr = zz + (size_t)n * gc;
      float a[4], c[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        a[t] = i0 + t < gc ? zr[i0 + t] : 0.f;
        c[t] = j0 + t < gc ? zr[j0 + t] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(a[u], c[v], acc[u][v]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (i0 + u >= gc) break;
#pragma unroll
      for (int v = 0; v < 4; ++v)
        if (j0 + v < gc) ob[(size_t)(i0 + u) * gc + j0 + v] = acc[u][v] * inv_area;
    }
  }
}

size_t align16(size_t n) { return (n + 15) / 16 * 16; }

}  // namespace

// x: uint8 [B, H, W, cin]; w0bd: bf16 [K*K*cin, k2*k2*c0] (K = k1*k2);
// b0: float32 [k2*k2*c0]; w2: bf16 [k2*k2*c0, c1]; b2: [c1]; w3: bf16
// [c1, c2]; b3: [c2]; wcp: bf16 [c2, gc]; bcp: [gc]; out: float32
// [B, div*div, gc*gc]; all contiguous, bf16 passed as its 16-bit pattern.
// Rows and columns beyond a multiple of K are ignored.  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for sizes it does not take.
extern "C" int wadt_trunk_gram_u8(const void* x, const void* w0bd, const void* b0,
                                  const void* w2, const void* b2, const void* w3,
                                  const void* b3, const void* wcp, const void* bcp,
                                  void* out, int B, int H, int W, int cin, int k1,
                                  int k2, int c0, int c1, int c2, int gc, int div,
                                  void* stream) {
  Shape s;
  s.H = H; s.W = W; s.cin = cin; s.k1 = k1; s.k2 = k2;
  s.c0 = c0; s.c1 = c1; s.c2 = c2; s.gc = gc; s.div = div;
  s.K = k1 * k2;
  if (B <= 0 || cin <= 0 || k1 <= 0 || k2 <= 0 || c0 <= 0 || c1 <= 0 || c2 <= 0 ||
      gc <= 0 || div <= 0 || H < s.K || W < s.K || (long long)B * div * div >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  s.Hf = H / s.K;
  s.Wf = W / s.K;
  s.ph = (s.Hf + div - 1) / div;
  s.pw = (s.Wf + div - 1) / div;
  s.area = s.ph * s.pw;
  const size_t cells = (size_t)k2 * k2;
  const size_t xin = (size_t)s.area * cells * k1 * k1 * cin * sizeof(float);
  const size_t bcz = (size_t)s.area * (c1 + c2 + gc) * sizeof(float);
  const size_t a = (size_t)s.area * cells * c0 * sizeof(float);
  size_t wmax = (size_t)k1 * k1 * cin * c0;
  wmax = wmax > cells * c0 * c1 ? wmax : cells * c0 * c1;
  wmax = wmax > (size_t)c1 * c2 ? wmax : (size_t)c1 * c2;
  wmax = wmax > (size_t)c2 * gc ? wmax : (size_t)c2 * gc;
  s.off_a = align16(xin > bcz ? xin : bcz);
  s.off_w = s.off_a + align16(a);
  const size_t smem = s.off_w + align16(wmax * sizeof(uint16_t));
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        trunk_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  trunk_gram_kernel<<<B * div * div, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint16_t*>(w0bd),
      static_cast<const float*>(b0), static_cast<const uint16_t*>(w2),
      static_cast<const float*>(b2), static_cast<const uint16_t*>(w3),
      static_cast<const float*>(b3), static_cast<const uint16_t*>(wcp),
      static_cast<const float*>(bcp), static_cast<float*>(out), s);
  return (int)cudaGetLastError();
}
