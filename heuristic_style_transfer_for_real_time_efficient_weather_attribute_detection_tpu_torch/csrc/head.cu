// Fused PMG head for Hopper (sm_90a): Gram tokens -> stacked task logits,
// the camera path's second kernel.
//
// Replaces the Pallas TPU kernel `fused_head`
// (heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu/ops/pallas_kernels.py:477,
// body `_head_kernel` :398, weight flattening `_flatten_head_weights` :359).
//
// What it computes, for tokens[B, Np, Din] (Din = gc*gc) and a
// `fold_head_weights` tree (models/pmg.py):
//   x = bf16(tokens) @ Wp + bp, Wp = token_proj's bf16 weight, or for the
//       weight-only int8 fold Wp = bf16(bf16(w8) * bf16(scale)) per column;
//   then n pre-norm layers: x += MHA(LN1(x)), x += FFN(LN2(x)), LayerNorm
//       eps 1e-5, q scaled by 1/sqrt(head_dim), ReLU FFN, weights bf16;
//   then task-query pooling (softmax over tokens of queries . x, no 1/sqrt(d))
//   and the stacked heads: logits[B, T, Kmax].
// Every sum is float32; bf16(.) rounds to nearest even, where the TPU
// kernel casts.
//
// What bounds it: reading weights.  At the camera path's shape (B = 1, the
// shipped head: Din 9216, d 192, 2 layers, FFN 384, 12 tasks, Kmax 8) the
// bf16 token_proj is 3.54 MB (int8: 1.77 MB), the transformer 1.18 MB, and
// the rest KBs: about 1.4 us at 3.35 TB/s, against 2 * 6.8 M FMAs, 0.2 us at
// 67 TFLOP/s.  One block per image, the TPU's grid, would stream all of it
// through one SM.
//
// What the design does about it: two launches.
//  - Launch 1 splits token_proj over its Din rows, 256 rows x 64 columns a
//    block (108 blocks at the shipped shape), so the weight streams through
//    most SMs at once.  Each warp takes 32 rows; a lane owns one column pair
//    for up to 16 token rows and loads all 32 of its weight words (bf16
//    pairs, or int8 pairs dequantized in registers) before using any, so
//    their latency is paid once.  The eight warps' sums are added in a
//    fixed order, and each block writes a float32 partial sum [B*Np, 64] to
//    scratch that the wrapper allocates: no atomics, the result does not
//    depend on the run.
//  - Launch 2 is one block per image.  It adds the partial sums in chunk
//    order, then runs the layers, the pooling and the heads with every
//    activation in shared memory.  Its 2.6 M multiply-adds a layer would
//    take one SM's CUDA cores at least ~12 us, so the six GEMMs of a layer
//    run on the tensor cores (`mma.sync` m16n8k16 bf16, float32 sums): the
//    weights are bf16 already, and each float32 activation is split into
//    two bf16 terms, hi + lo, which keeps the product to about 2^-16 of
//    float32.  Each weight is copied whole (or in row chunks, for wider
//    models) into shared memory with `cp.async` before its GEMM, all of a
//    thread's copies in flight at once; biases are loaded before the k
//    loop.  The queries and head weights are copied to shared memory before
//    pooling, and each pooling score and head logit takes a warp.
// Not done yet: launch 2 runs on one SM, and a layer there is some 25
// phases between barriers (nine token rows padded to the MMA's sixteen;
// attention scores, softmax and layer norms on CUDA cores), which at batch 1
// sets K4's time far above the weight read.  Spreading a layer over a
// cluster of SMs is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunkRows = 256;   // token_proj rows per launch-1 block
constexpr int kColTile = 64;      // token_proj columns per launch-1 block
constexpr int kRowTile = 16;      // token rows per pass of launch 1
constexpr int kProjThreads = 256;
constexpr int kProjWarps = kProjThreads / 32;
constexpr int kWarpRows = kChunkRows / kProjWarps;  // token_proj rows per warp
constexpr int kRestThreads = 512;
constexpr int kMaxLayers = 8;
constexpr int kWbufMax = 96 * 1024;  // bf16 elements of launch 2's weight buffer, at most

__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// float32 -> bfloat16 -> float32, round to nearest even (finite inputs).
__device__ __forceinline__ float round_bf16(float v) {
  uint32_t u = __float_as_uint(v);
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

// ---------------------------------------------------------------------------
// Launch 1: partial[c][m][n] = sum over rows k of chunk c of bf16(tok[m][k]) * Wp[k][n]
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kProjThreads)
head_proj_kernel(const float* __restrict__ tok, const uint16_t* __restrict__ wbf,
                 const int8_t* __restrict__ w8, const float* __restrict__ scale,
                 float* __restrict__ partial, int M, int Din, int d) {
  extern __shared__ float smem[];
  float* xs = smem;                                  // [kRowTile][kChunkRows]
  float* red = smem + kRowTile * kChunkRows;         // [kProjWarps][kRowTile][kColTile]
  const int c = blockIdx.x;
  const int col0 = blockIdx.y * kColTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n = col0 + 2 * lane;
  const bool has_col = n < d;  // d is even, so n + 1 < d too
  const int k0 = c * kChunkRows;
  const int kw = k0 + warp * kWarpRows;
  float sc0 = 0.f, sc1 = 0.f;
  if (w8 != nullptr && has_col) {
    sc0 = round_bf16(scale[n]);
    sc1 = round_bf16(scale[n + 1]);
  }

  // The warp's weight rows, all loaded before any use, so their latency is
  // paid once: 32-bit words of two bf16, or 16 bits of two int8.
  uint32_t wr[kWarpRows];
#pragma unroll
  for (int kk = 0; kk < kWarpRows; ++kk) {
    const int k = kw + kk;
    wr[kk] = 0u;
    if (has_col && k < Din)
      wr[kk] = w8 != nullptr
          ? (uint32_t)__ldg(reinterpret_cast<const uint16_t*>(w8 + (size_t)k * d + n))
          : __ldg(reinterpret_cast<const uint32_t*>(wbf + (size_t)k * d + n));
  }

  for (int m0 = 0; m0 < M; m0 += kRowTile) {
    const int mt = min(kRowTile, M - m0);
    for (int e = threadIdx.x; e < kRowTile * kChunkRows; e += kProjThreads) {
      const int i = e / kChunkRows;
      const int k = k0 + e % kChunkRows;
      xs[e] = (i < mt && k < Din) ? round_bf16(tok[(size_t)(m0 + i) * Din + k]) : 0.f;
    }
    __syncthreads();
    float acc[kRowTile][2];
#pragma unroll
    for (int i = 0; i < kRowTile; ++i) acc[i][0] = acc[i][1] = 0.f;
    const float* xw = xs + (kw - k0);
#pragma unroll  // wr stays in registers only when fully unrolled
    for (int kk = 0; kk < kWarpRows; ++kk) {
      float wa, wb;
      if (w8 != nullptr) {
        wa = round_bf16((float)(int8_t)(wr[kk] & 0xffu) * sc0);
        wb = round_bf16((float)(int8_t)((wr[kk] >> 8) & 0xffu) * sc1);
      } else {
        wa = bf16_lo(wr[kk]);
        wb = bf16_hi(wr[kk]);
      }
#pragma unroll
      for (int i = 0; i < kRowTile; ++i) {
        const float xv = xw[i * kChunkRows + kk];
        acc[i][0] = fmaf(xv, wa, acc[i][0]);
        acc[i][1] = fmaf(xv, wb, acc[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRowTile; ++i) {
      red[(warp * kRowTile + i) * kColTile + 2 * lane] = acc[i][0];
      red[(warp * kRowTile + i) * kColTile + 2 * lane + 1] = acc[i][1];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kRowTile * kColTile; e += kProjThreads) {
      const int i = e / kColTile;
      const int col = e % kColTile;
      if (i >= mt || col0 + col >= d) continue;
      float s = 0.f;
      for (int w = 0; w < kProjWarps; ++w) s += red[(w * kRowTile + i) * kColTile + col];
      partial[((size_t)c * M + m0 + i) * d + col0 + col] = s;
    }
    __syncthreads();  // xs and red are rewritten by the next pass
  }
}

// ---------------------------------------------------------------------------
// Launch 2: the rest of the head, one block per image
// ---------------------------------------------------------------------------

struct Layer {
  const float *n1s, *n1b;
  const uint16_t* wq; const float* bq;
  const uint16_t* wk; const float* bk;
  const uint16_t* wv; const float* bv;
  const uint16_t* wo; const float* bo;
  const float *n2s, *n2b;
  const uint16_t* f1w; const float* f1b;
  const uint16_t* f2w; const float* f2b;
};

struct RestArgs {
  Layer layers[kMaxLayers];
  int n_layers;
  const float* partial;  // [chunks][B*Np][d]
  const float* tp_b;     // [d]
  const float* queries;  // [T][d]
  const float* heads_w;  // [T][d][kmax]
  const float* heads_b;  // [T][kmax]
  float* out;            // [B][T][kmax]
  int chunks, B, Np, d, ff, heads, T, kmax;
  int wbuf_elems;        // weight buffer size, a multiple of 8
  int split_elems;       // size of each activation split buffer, a multiple of 8
  int att_elems;         // size of the score buffer, a multiple of 4
};

enum Epilogue { kBias = 0, kRelu = 1, kResidual = 2 };

constexpr int kRestWarps = kRestThreads / 32;
constexpr int kTilesPerWarp = 4;  // 16 x 8 output tiles a warp holds per pass

// d += a * b for one m16n8k16 tile: a row-major bf16 (4 registers), b
// column-major bf16 (2 registers), d float32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint16_t bf16_bits(float rounded) {
  return (uint16_t)(__float_as_uint(rounded) >> 16);
}

// Asynchronous 16-byte copy from device to shared memory (no register
// round trip, so a thread keeps all its copies in flight at once).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// Copy `bytes` (a multiple of 16, both ends 16-byte aligned) to shared
// memory with the whole block; the caller waits and synchronizes.
__device__ void stage_async(void* smem, const void* gmem, int bytes) {
  for (int e = threadIdx.x; e < bytes / 16; e += kRestThreads)
    cp_async16(static_cast<uint4*>(smem) + e, static_cast<const uint4*>(gmem) + e);
}

// out[M, N] (=, or += for kResidual) epi(in[M, Kd] @ w[Kd, N] + bias) * scale
// on the tensor cores.  in: float32 [M, Kd] in shared memory; w: bf16
// [Kd, N] in device memory, 16-byte aligned; Kd % 16 == 0, N % 8 == 0.
// Each float32 input a is split into hi = bf16(a) and lo = bf16(a - hi), so
// a * w = hi * w + lo * w to about 2^-16 relative (w is bf16 already): two
// bf16 MMAs per tile and step, float32 sums.  hi and lo go to `ahi` / `alo`
// ([rows][Kd + 8], rows zero-padded to a multiple of 16); the weight goes
// through `wbuf` in chunks of whole rows (row stride N + 8), copied 16 bytes
// a thread by the whole block.  The +8 pads put the lanes of a fragment
// load on distinct banks.  Every thread of the block calls this: it
// synchronizes inside.
__device__ void gemm_tc(const float* in, int M, int Kd, const uint16_t* __restrict__ w,
                        const float* __restrict__ bias, int N, float* out, int epi,
                        uint16_t* wbuf, int wbuf_elems, uint16_t* ahi, uint16_t* alo,
                        float scale = 1.f) {
  const int rows = (M + 15) / 16 * 16;
  const int lda = Kd + 8;
  const int ldb = N + 8;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  __syncthreads();  // `in` is complete; ahi and alo are free
  for (int e = threadIdx.x; e < rows * Kd / 4; e += kRestThreads) {
    const int r = e / (Kd / 4);
    const int c = (e - r * (Kd / 4)) * 4;
    const float4 v = r < M ? *reinterpret_cast<const float4*>(in + (size_t)r * Kd + c)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float hi = round_bf16(vs[j]);
      ahi[r * lda + c + j] = bf16_bits(hi);
      alo[r * lda + c + j] = bf16_bits(round_bf16(vs[j] - hi));
    }
  }
  const int ntn = N / 8;
  const int tiles = rows / 16 * ntn;
  const int kc = wbuf_elems / ldb / 16 * 16;  // weight rows a chunk
  const int vecs = N / 8;                     // 16-byte vectors a weight row
  for (int base = 0; base < tiles; base += kTilesPerWarp * kRestWarps) {
    float acc[kTilesPerWarp][4];
    float bv[kTilesPerWarp][2];  // the tiles' biases, loaded ahead of their use
#pragma unroll
    for (int i = 0; i < kTilesPerWarp; ++i) {
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
      const int tile = base + i * kRestWarps + warp;
      const int col = tile % ntn * 8 + 2 * t;
      bv[i][0] = tile < tiles ? bias[col] : 0.f;
      bv[i][1] = tile < tiles ? bias[col + 1] : 0.f;
    }
    for (int k0 = 0; k0 < Kd; k0 += kc) {
      const int kn = min(kc, Kd - k0);
      const uint4* src = reinterpret_cast<const uint4*>(w + (size_t)k0 * N);
      __syncthreads();  // the buffer's previous contents are consumed
      for (int e = threadIdx.x; e < kn * vecs; e += kRestThreads) {
        const int r = e / vecs;
        cp_async16(reinterpret_cast<uint4*>(wbuf + (size_t)r * ldb) + (e - r * vecs), src + e);
      }
      cp_async_wait_all();
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kTilesPerWarp; ++i) {
        const int tile = base + i * kRestWarps + warp;
        if (tile >= tiles) break;  // warp-uniform
        const int m0 = tile / ntn * 16;
        const int n0 = tile % ntn * 8;
        const uint16_t* ah = ahi + (m0 + g) * lda + k0 + 2 * t;
        const uint16_t* al = alo + (m0 + g) * lda + k0 + 2 * t;
        const uint16_t* bp = wbuf + (2 * t) * ldb + n0 + g;
        for (int kk = 0; kk < kn; kk += 16) {
          uint32_t a[4], l[4];
          a[0] = *reinterpret_cast<const uint32_t*>(ah + kk);
          a[1] = *reinterpret_cast<const uint32_t*>(ah + 8 * lda + kk);
          a[2] = *reinterpret_cast<const uint32_t*>(ah + kk + 8);
          a[3] = *reinterpret_cast<const uint32_t*>(ah + 8 * lda + kk + 8);
          l[0] = *reinterpret_cast<const uint32_t*>(al + kk);
          l[1] = *reinterpret_cast<const uint32_t*>(al + 8 * lda + kk);
          l[2] = *reinterpret_cast<const uint32_t*>(al + kk + 8);
          l[3] = *reinterpret_cast<const uint32_t*>(al + 8 * lda + kk + 8);
          const uint16_t* b = bp + (size_t)kk * ldb;
          const uint32_t b0 = (uint32_t)b[0] | ((uint32_t)b[ldb] << 16);
          const uint32_t b1 = (uint32_t)b[8 * ldb] | ((uint32_t)b[9 * ldb] << 16);
          mma_bf16(acc[i], a, b0, b1);
          mma_bf16(acc[i], l, b0, b1);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kTilesPerWarp; ++i) {
      const int tile = base + i * kRestWarps + warp;
      if (tile >= tiles) break;
      const int m0 = tile / ntn * 16;
      const int n0 = tile % ntn * 8;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + g + 8 * half;
        if (r >= M) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = n0 + 2 * t + j;
          float v = acc[i][2 * half + j] + bv[i][j];
          float* o = out + (size_t)r * N + col;
          if (epi == kRelu) v = fmaxf(v, 0.f);
          if (epi == kResidual) *o = *o + v;
          else *o = v * scale;
        }
      }
    }
  }
}

// Sum of a lane's values over the warp, in a fixed order.
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dst[r] = LayerNorm(src[r]) * s + b over rows of width d, one warp a row.
__device__ void layer_norm_rows(const float* src, float* dst, int M, int d,
                                const float* __restrict__ s, const float* __restrict__ b) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < M; r += kRestThreads / 32) {
    const float* x = src + (size_t)r * d;
    float sum = 0.f;
    for (int j = lane; j < d; j += 32) sum += x[j];
    const float mu = warp_sum(sum) / (float)d;
    float sq = 0.f;
    for (int j = lane; j < d; j += 32) sq += (x[j] - mu) * (x[j] - mu);
    const float inv = 1.0f / sqrtf(warp_sum(sq) / (float)d + 1e-5f);
    for (int j = lane; j < d; j += 32) dst[(size_t)r * d + j] = (x[j] - mu) * inv * s[j] + b[j];
  }
}

// Softmax of each of `rows` rows of width n, in place, one thread a row.
__device__ void softmax_rows(float* a, int rows, int n) {
  for (int r = threadIdx.x; r < rows; r += kRestThreads) {
    float* p = a + (size_t)r * n;
    float m = p[0];
    for (int j = 1; j < n; ++j) m = fmaxf(m, p[j]);
    float sum = 0.f;
    for (int j = 0; j < n; ++j) {
      p[j] = expf(p[j] - m);
      sum += p[j];
    }
    for (int j = 0; j < n; ++j) p[j] = p[j] / sum;
  }
}

__global__ void __launch_bounds__(kRestThreads, 1) head_rest_kernel(RestArgs a) {
  extern __shared__ float4 smem4[];
  uint16_t* wbuf = reinterpret_cast<uint16_t*>(smem4);  // [wbuf_elems]
  uint16_t* ahi = wbuf + a.wbuf_elems;                   // [split_elems]
  uint16_t* alo = ahi + a.split_elems;                   // [split_elems]
  float* x = reinterpret_cast<float*>(alo + a.split_elems);
  const int Np = a.Np, d = a.d;
  const int wb = a.wbuf_elems;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t nd = (size_t)Np * d;
  float* h = x + nd;
  float* q = h + nd;
  float* kk = q + nd;
  float* v = kk + nd;
  float* att = v + nd;             // [heads][Np][Np], then [T][Np]
  float* hid = att + a.att_elems;  // [Np][ff], then [T][d]
  const int b = blockIdx.x;
  const int M = a.B * Np;

  for (int e = threadIdx.x; e < Np * d; e += kRestThreads) {
    float s = 0.f;
#pragma unroll 12
    for (int c = 0; c < a.chunks; ++c) s += a.partial[((size_t)c * M + (size_t)b * Np) * d + e];
    x[e] = s + a.tp_b[e % d];
  }
  __syncthreads();

  const int hd = d / a.heads;
  const float qscale = 1.0f / sqrtf((float)hd);
  for (int li = 0; li < a.n_layers; ++li) {
    const Layer& L = a.layers[li];
    layer_norm_rows(x, h, Np, d, L.n1s, L.n1b);
    __syncthreads();
    gemm_tc(h, Np, d, L.wq, L.bq, d, q, kBias, wbuf, wb, ahi, alo, qscale);
    gemm_tc(h, Np, d, L.wk, L.bk, d, kk, kBias, wbuf, wb, ahi, alo);
    gemm_tc(h, Np, d, L.wv, L.bv, d, v, kBias, wbuf, wb, ahi, alo);
    __syncthreads();
    for (int e = threadIdx.x; e < a.heads * Np * Np; e += kRestThreads) {
      const int hh = e / (Np * Np);
      const int i = (e / Np) % Np;
      const int j = e % Np;
      const float* qi = q + (size_t)i * d + hh * hd;
      const float* kj = kk + (size_t)j * d + hh * hd;
      float s = 0.f;
      for (int t = 0; t < hd; ++t) s = fmaf(qi[t], kj[t], s);
      att[e] = s;
    }
    __syncthreads();
    softmax_rows(att, a.heads * Np, Np);
    __syncthreads();
    for (int e = threadIdx.x; e < Np * d; e += kRestThreads) {
      const int i = e / d;
      const int col = e % d;
      const float* p = att + ((size_t)(col / hd) * Np + i) * Np;
      float s = 0.f;
      for (int j = 0; j < Np; ++j) s = fmaf(p[j], v[(size_t)j * d + col], s);
      h[e] = s;
    }
    __syncthreads();
    gemm_tc(h, Np, d, L.wo, L.bo, d, x, kResidual, wbuf, wb, ahi, alo);
    __syncthreads();
    layer_norm_rows(x, h, Np, d, L.n2s, L.n2b);
    __syncthreads();
    gemm_tc(h, Np, d, L.f1w, L.f1b, a.ff, hid, kRelu, wbuf, wb, ahi, alo);
    __syncthreads();
    gemm_tc(hid, Np, a.ff, L.f2w, L.f2b, d, x, kResidual, wbuf, wb, ahi, alo);
    __syncthreads();
  }

  // task-query pooling, then the stacked heads; a warp for each score and
  // each logit, its lanes striding the model width.  The queries and head
  // weights go to shared memory first, where they fit (16-byte aligned).
  float* ps = att;      // [T][Np]
  float* pooled = hid;  // [T][d]
  const float* queries = a.queries;
  const float* heads_w = a.heads_w;
  const int qbytes = a.T * d * 4;
  const int hbytes = a.T * d * a.kmax * 4;
  if (qbytes % 16 == 0 && hbytes % 16 == 0 && qbytes + hbytes <= a.wbuf_elems * 2 &&
      reinterpret_cast<uintptr_t>(queries) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(heads_w) % 16 == 0) {
    float* sq = reinterpret_cast<float*>(wbuf);
    float* sh = sq + a.T * d;
    __syncthreads();  // the layers are done with the buffer
    stage_async(sq, queries, qbytes);
    stage_async(sh, heads_w, hbytes);
    cp_async_wait_all();
    __syncthreads();
    queries = sq;
    heads_w = sh;
  }
  for (int e = warp; e < a.T * Np; e += kRestThreads / 32) {
    const int t = e / Np;
    const int n = e % Np;
    float s = 0.f;
    for (int j = lane; j < d; j += 32) s = fmaf(queries[(size_t)t * d + j], x[(size_t)n * d + j], s);
    s = warp_sum(s);
    if (lane == 0) ps[e] = s;
  }
  __syncthreads();
  softmax_rows(ps, a.T, Np);
  __syncthreads();
  for (int e = threadIdx.x; e < a.T * d; e += kRestThreads) {
    const int t = e / d;
    const int j = e % d;
    float s = 0.f;
    for (int n = 0; n < Np; ++n) s = fmaf(ps[t * Np + n], x[(size_t)n * d + j], s);
    pooled[e] = s;
  }
  __syncthreads();
  for (int e = warp; e < a.T * a.kmax; e += kRestThreads / 32) {
    const int t = e / a.kmax;
    const int k = e % a.kmax;
    const float* hw = heads_w + (size_t)t * d * a.kmax + k;
    float s = 0.f;
    for (int j = lane; j < d; j += 32) s = fmaf(pooled[(size_t)t * d + j], hw[(size_t)j * a.kmax], s);
    s = warp_sum(s);
    if (lane == 0) a.out[((size_t)b * a.T + t) * a.kmax + k] = s + a.heads_b[e];
  }
}

}  // namespace

// tokens: float32 [B, Np, Din]; token_proj: bf16 tp_w [Din, d] (tp_q8 = 0)
// or int8 tp_w [Din, d] with float32 tp_scale [d] (tp_q8 = 1); tp_b [d];
// layer_ptrs: host array of n_layers x 16 device pointers per layer, in the
// order n1s n1b wq bq wk bk wv bv wo bo n2s n2b f1w f1b f2w f2b (matrices bf16
// [in, out], the rest float32); queries float32 [T, d]; heads_w [T, d, kmax];
// heads_b [T, kmax]; partial: float32 scratch [partial_chunks, B*Np, d] with
// partial_chunks = ceil(Din / 256); out float32 [B, T, kmax].  All
// contiguous.  Two launches on `stream`; returns the first error of either
// (0 on success), or cudaErrorInvalidValue for sizes it does not take.
extern "C" int wadt_fused_head(const void* tokens, const void* tp_w, int tp_q8,
                               const void* tp_scale, const void* tp_b,
                               const void* const* layer_ptrs, int n_layers,
                               const void* queries, const void* heads_w,
                               const void* heads_b, void* partial, int partial_chunks,
                               void* out, int B, int Np, int Din, int d, int ff,
                               int heads, int T, int kmax, void* stream) {
  if (B <= 0 || Np <= 0 || Din <= 0 || d <= 0 || d % 2 != 0 || T <= 0 || kmax <= 0 ||
      n_layers < 0 || n_layers > kMaxLayers ||
      partial_chunks != (Din + kChunkRows - 1) / kChunkRows ||
      (n_layers > 0 && (heads <= 0 || d % heads != 0 || d % 16 != 0 || ff <= 0 || ff % 16 != 0)) ||
      (long long)B * Np * Din >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * Np;

  const dim3 grid1(partial_chunks, (d + kColTile - 1) / kColTile);
  const size_t smem1 =
      (size_t)(kRowTile * kChunkRows + kProjWarps * kRowTile * kColTile) * sizeof(float);
  head_proj_kernel<<<grid1, kProjThreads, smem1, s>>>(
      static_cast<const float*>(tokens), tp_q8 ? nullptr : static_cast<const uint16_t*>(tp_w),
      tp_q8 ? static_cast<const int8_t*>(tp_w) : nullptr, static_cast<const float*>(tp_scale),
      static_cast<float*>(partial), M, Din, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  RestArgs a = {};
  for (int li = 0; li < n_layers; ++li) {
    const void* const* p = layer_ptrs + 16 * li;
    Layer& L = a.layers[li];
    L.n1s = static_cast<const float*>(p[0]);
    L.n1b = static_cast<const float*>(p[1]);
    L.wq = static_cast<const uint16_t*>(p[2]);
    L.bq = static_cast<const float*>(p[3]);
    L.wk = static_cast<const uint16_t*>(p[4]);
    L.bk = static_cast<const float*>(p[5]);
    L.wv = static_cast<const uint16_t*>(p[6]);
    L.bv = static_cast<const float*>(p[7]);
    L.wo = static_cast<const uint16_t*>(p[8]);
    L.bo = static_cast<const float*>(p[9]);
    L.n2s = static_cast<const float*>(p[10]);
    L.n2b = static_cast<const float*>(p[11]);
    L.f1w = static_cast<const uint16_t*>(p[12]);
    L.f1b = static_cast<const float*>(p[13]);
    L.f2w = static_cast<const uint16_t*>(p[14]);
    L.f2b = static_cast<const float*>(p[15]);
  }
  a.n_layers = n_layers;
  a.partial = static_cast<const float*>(partial);
  a.tp_b = static_cast<const float*>(tp_b);
  a.queries = static_cast<const float*>(queries);
  a.heads_w = static_cast<const float*>(heads_w);
  a.heads_b = static_cast<const float*>(heads_b);
  a.out = static_cast<float*>(out);
  a.chunks = partial_chunks;
  a.B = B; a.Np = Np; a.d = d; a.ff = n_layers > 0 ? ff : 0;
  a.heads = n_layers > 0 ? heads : 1;
  a.T = T; a.kmax = kmax;
  const size_t hid = (size_t)Np * a.ff > (size_t)T * d ? (size_t)Np * a.ff : (size_t)T * d;
  const size_t att = ((size_t)(a.heads > T ? a.heads : T) * Np * Np + 3) / 4 * 4;
  a.att_elems = (int)att;
  // activations and their bf16 splits, then as much weight buffer as the
  // rest of the 227 KB holds (at least 16 rows of the widest weight)
  const int widest = a.ff > d ? a.ff : d;
  a.split_elems = n_layers > 0 ? (Np + 15) / 16 * 16 * (widest + 8) : 0;
  const size_t act = (5 * (size_t)Np * d + att + hid) * sizeof(float) +
                     2 * (size_t)a.split_elems * sizeof(uint16_t);
  const size_t room = act < 227 * 1024 ? (227 * 1024 - act) / sizeof(uint16_t) / 8 * 8 : 0;
  a.wbuf_elems = (int)(room < (size_t)kWbufMax ? room : kWbufMax);
  if (n_layers > 0 && a.wbuf_elems < 16 * (widest + 8)) return (int)cudaErrorInvalidValue;
  const int matrices[] = {2, 4, 6, 8, 12, 14};  // copied to shared memory 16 bytes at a time
  for (int li = 0; li < n_layers; ++li)
    for (int i : matrices)
      if (reinterpret_cast<uintptr_t>(layer_ptrs[16 * li + i]) % 16 != 0)
        return (int)cudaErrorInvalidValue;
  const size_t smem2 = (size_t)a.wbuf_elems * sizeof(uint16_t) + act;
  if (smem2 > 48 * 1024) {
    err = cudaFuncSetAttribute(head_rest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem2);
    if (err != cudaSuccess) return (int)err;
  }
  head_rest_kernel<<<B, kRestThreads, smem2, s>>>(a);
  return (int)cudaGetLastError();
}
