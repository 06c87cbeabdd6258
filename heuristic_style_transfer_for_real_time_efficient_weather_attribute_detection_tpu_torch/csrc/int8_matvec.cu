// Per-task weight-only int8 matvec for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `int8_pallas`
// (tools/exp_rtm_int8_stream.py:77, body `_dequant_matvec_kernel` :63),
// which computes what the JAX package's RTM camera route does in XLA on its
// `folded_q8` fold (models/rtm.py:320-330) and in `_classify` for `mlp_q8`
// layers (models/rtm.py:119-126).
//
// What it computes, in two modes:
//  - float32: x float32 [B, T, C], w8 int8 [T, C, D], scale float32 [T, D]
//    -> y float32 [B, T, D],
//      y[b, t, d] = (sum_c x[b, t, c] * w8[t, c, d]) * scale[t, d],
//    summed in float32.  Scaling after the sum equals dequantizing first:
//    the scale is per output column.
//  - bf16: x bf16 [B, T, C], w8 int8 [T, C, D], scale bf16 [T, D] -> y
//    float32 [B, T, D],
//      y[b, t, d] = sum_c x[b, t, c] * bf16(w8[t, c, d] * scale[t, d]),
//    summed in float32: the JAX package's bf16 camera path, which
//    dequantizes each weight to bf16 before the product
//    (models/rtm.py:324).  Each weight is rounded to bf16 once, so the
//    scale cannot move after the sum; the product w8 * scale is exact in
//    float32 (7 by 8 significant bits), and one round to nearest even
//    gives the bf16 weight.
//
// What bounds it: bytes.  At the RTM camera path's shape (B = 1, T = 12,
// C = D = 2048) it reads 50.3 MB of int8 weights once, about 15 us at
// 3.35 TB/s; its 0.1 GFLOP are nothing at any rate.
//
// What the design does about it: every weight byte is read from device
// memory once, in 16-byte loads, with enough loads in flight to cover the
// memory latency on every SM.
//  - One block per (task, tile of 64 output columns, group of up to 4 batch
//    rows): 12 x 32 = 384 blocks at the camera shape, three per SM.
//  - The block's rows of x are staged in shared memory.  Its 256 threads
//    are 64 row lanes x 4 column groups: a thread owns 16 neighbouring
//    columns and reads them as one int4, so the four threads of a row read
//    one contiguous 64-byte run.  Each thread issues four loads (four rows)
//    before it uses any.
//  - Each thread sums its rows in float32 registers; the 8 row lanes of a
//    warp are added by shuffles, the 8 warps in shared memory in a fixed
//    order, then the scale is applied.  No atomics: the result is the same
//    on every run.
//  - Ragged shapes: D % 16 != 0 or a misaligned pointer takes a byte-wise
//    load path; rows and columns beyond C and D are masked.
//  - The bf16 mode stages x as float32 and holds the thread's 16 column
//    scales in registers; each weight costs one more multiply and a round
//    to bf16 before its FMA, and the bytes read stay those of w8.
// Not done yet: tensor cores (only worth it at a batch of many rows) and
// TMA bulk copies of the weight tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 16;                           // columns per thread
constexpr int kColGroups = 4;                       // threads per row
constexpr int kTileCols = kCols * kColGroups;       // 64 columns per block
constexpr int kRowLanes = kThreads / kColGroups;    // 64 rows per pass
constexpr int kUnroll = 4;                          // loads in flight per thread
constexpr int kMaxSmem = 227 * 1024;

// The weight as the product uses it: the int8 value (float32 mode), or the
// int8 value times its column scale rounded once to bf16 (bf16 mode).
template <bool BF16>
__device__ __forceinline__ float weight(int q, float sc) {
  const float w = static_cast<float>(q);
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(w * sc));
  } else {
    return w;
  }
}

template <int BT, bool BF16>
__device__ __forceinline__ void fma_word(float (&acc)[BT][kCols], const float (&sc)[kCols],
                                         const float* xs, int C, int c, int word, int base) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float w = weight<BF16>(static_cast<signed char>(word >> (8 * e)), sc[base + e]);
#pragma unroll
    for (int j = 0; j < BT; ++j) acc[j][base + e] = fmaf(xs[j * C + c], w, acc[j][base + e]);
  }
}

template <typename T>
__device__ __forceinline__ float to_float(T v) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return __bfloat162float(v);
  } else {
    return v;
  }
}

// T is x's and scale's element type: float (float32 mode) or bf16 (bf16 mode).
template <int BT, typename T>
__global__ void __launch_bounds__(kThreads)
dequant_matvec_kernel(const T* __restrict__ x, const int8_t* __restrict__ w8,
                      const T* __restrict__ scale, float* __restrict__ y,
                      int B, int T_, int C, int D, bool vec16) {
  constexpr bool BF16 = std::is_same_v<T, __nv_bfloat16>;
  extern __shared__ float smem[];
  float* xs = smem;             // [BT][C]: this block's rows of x for task t
  float* red = smem + BT * C;   // [kWarps][kTileCols]: per-warp column sums
  const int t = blockIdx.y;
  const int d0 = blockIdx.x * kTileCols;
  const int b0 = blockIdx.z * BT;
  const int nb = min(BT, B - b0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int cg = lane % kColGroups;
  const int r = warp * (32 / kColGroups) + lane / kColGroups;  // row lane, 0..63
  const int col = d0 + cg * kCols;

  for (int j = 0; j < BT; ++j) {
    const T* src = x + ((size_t)(b0 + j) * T_ + t) * C;
    for (int c = threadIdx.x; c < C; c += kThreads) xs[j * C + c] = j < nb ? to_float(src[c]) : 0.f;
  }
  // bf16 mode: the thread's column scales (1 beyond D, where no weight is read)
  float sc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i)
    sc[i] = BF16 && col + i < D ? to_float(scale[(size_t)t * D + col + i]) : 1.f;
  __syncthreads();

  float acc[BT][kCols];
#pragma unroll
  for (int j = 0; j < BT; ++j)
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[j][i] = 0.f;

  const int8_t* wt = w8 + (size_t)t * C * D;
  if (vec16 && col < D) {
    // D % 16 == 0 here, so all 16 columns of the thread are in range
    const int8_t* wc = wt + col;
    for (int c0 = r; c0 < C; c0 += kRowLanes * kUnroll) {
      int4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + u * kRowLanes;
        v[u] = c < C ? __ldg(reinterpret_cast<const int4*>(wc + (size_t)c * D))
                     : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + u * kRowLanes;
        if (c < C) {
          fma_word<BT, BF16>(acc, sc, xs, C, c, v[u].x, 0);
          fma_word<BT, BF16>(acc, sc, xs, C, c, v[u].y, 4);
          fma_word<BT, BF16>(acc, sc, xs, C, c, v[u].z, 8);
          fma_word<BT, BF16>(acc, sc, xs, C, c, v[u].w, 12);
        }
      }
    }
  } else if (col < D) {
    for (int c = r; c < C; c += kRowLanes) {
      const int8_t* wr = wt + (size_t)c * D;
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const float w = col + i < D ? weight<BF16>(wr[col + i], sc[i]) : 0.f;
#pragma unroll
        for (int j = 0; j < BT; ++j) acc[j][i] = fmaf(xs[j * C + c], w, acc[j][i]);
      }
    }
  }

  // j runs over compile-time indices so that acc stays in registers; the
  // test j < nb is the same for the whole block, so the barriers are safe
#pragma unroll
  for (int j = 0; j < BT; ++j) {
    if (j >= nb) continue;
    // the warp's 8 row lanes differ in lane bits 2..4
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      float s = acc[j][i];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (lane < kColGroups) red[warp * kTileCols + cg * kCols + i] = s;
    }
    __syncthreads();
    if (threadIdx.x < kTileCols && d0 + threadIdx.x < D) {
      const int d = d0 + threadIdx.x;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w * kTileCols + threadIdx.x];
      y[((size_t)(b0 + j) * T_ + t) * D + d] = BF16 ? s : s * to_float(scale[(size_t)t * D + d]);
    }
    __syncthreads();
  }
}

template <int BT, typename T>
int launch(const T* x, const int8_t* w8, const T* scale, float* y, int B, int T_,
           int C, int D, bool vec16, cudaStream_t stream) {
  const size_t smem = (size_t)(BT * C + kWarps * kTileCols) * sizeof(float);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dequant_matvec_kernel<BT, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((D + kTileCols - 1) / kTileCols, T_, (B + BT - 1) / BT);
  dequant_matvec_kernel<BT, T><<<grid, kThreads, smem, stream>>>(x, w8, scale, y, B, T_, C, D, vec16);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* w8, const void* scale, void* y, int B, int T_, int C,
             int D, void* stream) {
  if (B <= 0 || T_ <= 0 || C <= 0 || D <= 0 || T_ > 65535) return (int)cudaErrorInvalidValue;
  const bool vec16 = D % 16 == 0 && reinterpret_cast<uintptr_t>(w8) % 16 == 0;
  const auto* xt = static_cast<const T*>(x);
  const auto* wq = static_cast<const int8_t*>(w8);
  const auto* st = static_cast<const T*>(scale);
  auto* yf = static_cast<float*>(y);
  const auto s = static_cast<cudaStream_t>(stream);
  if (B == 1) return launch<1, T>(xt, wq, st, yf, B, T_, C, D, vec16, s);
  if ((B + 3) / 4 > 65535) return (int)cudaErrorInvalidValue;
  return launch<4, T>(xt, wq, st, yf, B, T_, C, D, vec16, s);
}

}  // namespace

// x: float32 [B, T, C]; w8: int8 [T, C, D]; scale: float32 [T, D];
// y: float32 [B, T, D]; all contiguous.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int wadt_dequant_matvec(const void* x, const void* w8, const void* scale, void* y,
                                   int B, int T, int C, int D, void* stream) {
  return dispatch<float>(x, w8, scale, y, B, T, C, D, stream);
}

// The bf16 mode: x bf16 [B, T, C]; w8 int8 [T, C, D]; scale bf16 [T, D];
// y float32 [B, T, D]; all contiguous.
extern "C" int wadt_dequant_matvec_bf16(const void* x, const void* w8, const void* scale,
                                        void* y, int B, int T, int C, int D, void* stream) {
  return dispatch<__nv_bfloat16>(x, w8, scale, y, B, T, C, D, stream);
}
