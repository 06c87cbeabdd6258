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
//    (models/rtm.py:324).
//
// What bounds it: bytes.  At the RTM camera path's shape (B = 1, T = 12,
// C = D = 2048) it reads 50.3 MB of int8 weights once, 15.0 us at 3.35
// TB/s; its 0.1 GFLOP are nothing at any rate.  What held the previous
// design back was the conversion unit: one I2F a weight (and an F2F for the
// bf16 rounding), 16 a clock on an SM against 128 FFMAs, is 50.3 M / (132
// SMs x 16 x 1.98 GHz) = 12.0 us (24.1 us for two), and a thread's next
// loads left only after its conversions were done.
//
// What the design does about it:
//  - Dequantization on full-rate pipes, exact.  A 32-bit word of four int8
//    weights is biased once (u = w ^ 0x80808080: each byte q + 128, one
//    LOP3); byte e of u under the exponent of 2^23 (one PRMT) is the float
//    2^23 + 128 + q, and one FADD of -8388736 leaves q exactly.
//    bf16 mode: q is exact in bf16, so one PRMT packs the top halves of two
//    such floats into an exact bf16 pair, and one fma.rn.bf16x2 with the
//    pair of column scales and a -0 addend rounds the exact product q * s
//    once to nearest even, subnormals kept: the value of
//    __float2bfloat16_rn(float(q) * s) (chip_smoke.py's exhaustive phase
//    holds it bit for bit to the plain version over every int8 value and
//    every finite bf16 scale).  A shift and a mask unpack the pair for the
//    float32 FFMAs; x * w is exact in float32.  Issue slots a weight at
//    B = 1: float32 ~3.25 (~4.9 us at the camera shape), bf16 ~5.25 (~7.9
//    us), both under the 15 us of bytes.
//  - Bytes in flight while the math runs.  Covering 3.35 TB/s x ~1 us of
//    latency takes ~25 KB in flight on each of the 132 SMs.  Each block keeps
//    a ring of kStages = 4 shared-memory stages of 64 rows x 64 bytes (4 KB),
//    filled by 16-byte cp.async.cg copies, one a thread a stage: 3 stages
//    (12 KB) stay in flight while the block does a stage's math, 36 KB an SM
//    at three blocks an SM.  A thread consumes the copy it issued itself,
//    so cp.async.wait_group (2 groups left pending) orders it and the loop
//    needs no block barrier.  Each copy asks L2 for its whole 128-byte line:
//    the other half is the neighbouring tile's, wanted at about that time.
//  - The block's rows of x go to shared memory by cp.async with the first
//    stage (plain loads where C's rows are not whole 16-byte runs), so the
//    ring is filling while x arrives and one barrier covers both.
//  - One block per (task, tile of 64 output columns, group of up to 4 batch
//    rows): 12 x 32 = 384 blocks at the camera shape, three an SM, one wave.
//    Every weight byte is read from device memory once.  256 threads are 64
//    row lanes x 4 column groups of 16 columns (one 16-byte copy a row).
//  - Sums in float32 registers; the 8 row lanes of a warp are added by
//    shuffles, the 8 warps in shared memory in a fixed order, then float32
//    mode applies the scale.  No atomics: the result is the same every run.
//  - The launch plan (tile, grid, group, stages, shared-memory bytes) is
//    `dequant_matvec_plan` in ops/cuda_kernels.py; the launcher checks the
//    plan's numbers against its own and refuses a mismatch.
//  - Ragged shapes: D % 16 != 0 or a misaligned w8 takes a byte-wise path
//    in the same kernel (no ring: each thread gathers its 16 bytes of a row
//    into words, zero beyond D, and runs the same dequantization).
// Not done: tensor cores (the FFMAs are not the limit at B <= 4); TMA (a
// tile's 64-byte row runs are not contiguous, and cp.async needs no tensor
// map); splitting C over a cluster for longer row runs (a cluster launch
// costs more than the longer runs save at this size).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 16;                         // columns per thread: one 16-byte copy a row
constexpr int kColGroups = 4;                     // threads per row
constexpr int kTileCols = kCols * kColGroups;     // 64 columns per block
constexpr int kRowLanes = kThreads / kColGroups;  // 64 rows per stage
constexpr int kStageBytes = kThreads * 16;        // 4 KB
constexpr int kStages = 4;                        // the ring's depth
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory past L1, the whole 128-byte line
// fetched into L2; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// q of byte E of the biased word u (q + 128 a byte): 2^23 + 128 + q exact
// as a float, less 2^23 + 128
template <int E>
__device__ __forceinline__ float dequant_q(uint32_t u) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + E)) - 8388736.f;
}

__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// bf16(q0 * s0), bf16(q1 * s1) as float32: q0, q1 packed exactly (top
// halves), one multiply by the scale pair s01 rounded once (+ -0 keeps the
// sign of a zero product)
__device__ __forceinline__ void bf16_pair(float q0, float q1, uint32_t s01, float& w0, float& w1) {
  const uint32_t p =
      fma_bf16x2(__byte_perm(__float_as_uint(q0), __float_as_uint(q1), 0x7632), s01, 0x80008000u);
  w0 = __uint_as_float(p << 16);
  w1 = __uint_as_float(p & 0xFFFF0000u);
}

// One word of w8 (columns BASE..BASE+3 of one row) into the sums:
// acc[j][BASE + e] += xv[j] * w_e, w_e = q_e (float32 mode) or bf16(q_e * s_e)
template <int BASE, int BT, bool BF16>
__device__ __forceinline__ void fma_word(float (&acc)[BT][kCols], const float (&xv)[BT],
                                         const uint32_t (&sc2)[kCols / 2], uint32_t word) {
  const uint32_t u = word ^ 0x80808080u;
  float w[4] = {dequant_q<0>(u), dequant_q<1>(u), dequant_q<2>(u), dequant_q<3>(u)};
  if constexpr (BF16) {
    bf16_pair(w[0], w[1], sc2[BASE / 2], w[0], w[1]);
    bf16_pair(w[2], w[3], sc2[BASE / 2 + 1], w[2], w[3]);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int j = 0; j < BT; ++j) acc[j][BASE + e] = fmaf(xv[j], w[e], acc[j][BASE + e]);
}

template <int BT, bool BF16>
__device__ __forceinline__ void fma_row(float (&acc)[BT][kCols], const float (&xv)[BT],
                                        const uint32_t (&sc2)[kCols / 2], uint4 v) {
  fma_word<0, BT, BF16>(acc, xv, sc2, v.x);
  fma_word<4, BT, BF16>(acc, xv, sc2, v.y);
  fma_word<8, BT, BF16>(acc, xv, sc2, v.z);
  fma_word<12, BT, BF16>(acc, xv, sc2, v.w);
}

template <typename T>
__device__ __forceinline__ float to_float(T v) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return __bfloat162float(v);
  } else {
    return v;
  }
}

// Shared memory: the ring ([stages][kThreads] 16-byte slots), x's rows
// ([bt][ksteps * kRowLanes], float32-sized slots, zero past C) and the
// per-warp column sums.
__host__ __device__ constexpr size_t smem_bytes(int bt, int stages, int ksteps) {
  return (size_t)stages * kStageBytes + ((size_t)bt * ksteps * kRowLanes + kWarps * kTileCols) * 4;
}

// T is x's and scale's element type: float (float32 mode) or bf16 (bf16
// mode).  stages: kStages on the 16-byte path, 0 on the byte-wise path;
// xcopy (16-byte path only): x's rows by cp.async, else by plain loads.
template <int BT, typename T>
__global__ void __launch_bounds__(kThreads)
dequant_matvec_kernel(const T* __restrict__ x, const int8_t* __restrict__ w8,
                      const T* __restrict__ scale, float* __restrict__ y, int B, int T_, int C,
                      int D, int ksteps, int stages, bool xcopy) {
  constexpr bool BF16 = std::is_same_v<T, __nv_bfloat16>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* ring = reinterpret_cast<uint4*>(smem);
  T* xs = reinterpret_cast<T*>(smem + (size_t)stages * kStageBytes);
  const int cpad = ksteps * kRowLanes;
  float* red = reinterpret_cast<float*>(smem + (size_t)stages * kStageBytes) + BT * cpad;
  const int t = blockIdx.y;
  const int d0 = blockIdx.x * kTileCols;
  const int b0 = blockIdx.z * BT;
  const int nb = min(BT, B - b0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int cg = lane % kColGroups;
  const int r = warp * (32 / kColGroups) + lane / kColGroups;  // row lane, 0..63
  const int col = d0 + cg * kCols;
  const int8_t* wt = w8 + (size_t)t * C * D;
  const bool vec = stages > 0;

  // row r + k * kRowLanes of the thread's 16 columns into its slot of stage k
  // (zeros past C or D)
  auto issue = [&](int k) {
    const int c = r + k * kRowLanes;
    const bool in = c < C && col < D;
    cp_async16(&ring[(k % kStages) * kThreads + threadIdx.x], in ? wt + (size_t)c * D + col : w8,
               in ? 16 : 0);
  };
  if (xcopy) {  // x's rows join the first stage's group (zeros past C)
    constexpr int kPer = 16 / sizeof(T);
    const int runs = cpad / kPer;
    for (int i = threadIdx.x; i < BT * runs; i += kThreads) {
      const int j = i / runs, c = i % runs * kPer;
      const bool in = j < nb && c < C;
      cp_async16(xs + j * cpad + c, in ? x + ((size_t)(b0 + j) * T_ + t) * C + c : x, in ? 16 : 0);
    }
  } else {
    for (int j = 0; j < BT; ++j) {
      const T* src = x + ((size_t)(b0 + j) * T_ + t) * C;
      for (int c = threadIdx.x; c < cpad; c += kThreads) xs[j * cpad + c] = j < nb && c < C ? src[c] : T{};
    }
  }
  if (vec) {
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < ksteps) issue(s);
      cp_async_commit();
    }
  }
  // bf16 mode: the thread's column scales as bf16 pairs (1 beyond D)
  uint32_t sc2[kCols / 2];
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) {
    uint32_t lo = 0x3F80u, hi = 0x3F80u;
    if (BF16) {
      const unsigned short* sb = reinterpret_cast<const unsigned short*>(scale) + (size_t)t * D;
      if (col + 2 * i < D) lo = sb[col + 2 * i];
      if (col + 2 * i + 1 < D) hi = sb[col + 2 * i + 1];
    }
    sc2[i] = lo | hi << 16;
  }
  cp_async_wait<kStages - 2>();  // this thread's copies of x's rows (and stage 0) have landed
  __syncthreads();

  float acc[BT][kCols];
#pragma unroll
  for (int j = 0; j < BT; ++j)
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[j][i] = 0.f;

  if (vec) {
    for (int k = 0; k < ksteps; ++k) {
      cp_async_wait<kStages - 2>();  // this thread's copy of stage k has landed
      const uint4 v = ring[(k % kStages) * kThreads + threadIdx.x];
      if (k + kStages - 1 < ksteps) issue(k + kStages - 1);  // into the slot read at k - 1
      cp_async_commit();
      float xv[BT];
#pragma unroll
      for (int j = 0; j < BT; ++j) xv[j] = to_float(xs[j * cpad + r + k * kRowLanes]);
      fma_row<BT, BF16>(acc, xv, sc2, v);
    }
  } else if (col < D) {
    for (int c = r; c < C; c += kRowLanes) {
      const int8_t* wr = wt + (size_t)c * D + col;
      uint32_t word[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        word[i] = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + 4 * i + e < D) word[i] |= (uint32_t)(uint8_t)wr[4 * i + e] << (8 * e);
      }
      float xv[BT];
#pragma unroll
      for (int j = 0; j < BT; ++j) xv[j] = to_float(xs[j * cpad + c]);
      fma_row<BT, BF16>(acc, xv, sc2, make_uint4(word[0], word[1], word[2], word[3]));
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
int launch(const T* x, const int8_t* w8, const T* scale, float* y, int B, int T_, int C, int D,
           int ksteps, int stages, bool xcopy, size_t smem, cudaStream_t stream) {
  auto* kernel = dequant_matvec_kernel<BT, T>;
  if (smem > 48 * 1024) {
    static const cudaError_t set =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (set != cudaSuccess) return (int)set;
  }
  const dim3 grid((D + kTileCols - 1) / kTileCols, T_, (B + BT - 1) / BT);
  kernel<<<grid, kThreads, smem, stream>>>(x, w8, scale, y, B, T_, C, D, ksteps, stages, xcopy);
  return (int)cudaGetLastError();
}

// The plan's numbers (group of batch rows, ring stages, shared-memory
// bytes) are checked against the kernel's own: a mismatch is refused.
template <typename T>
int dispatch(const void* x, const void* w8, const void* scale, void* y, int B, int T_, int C,
             int D, int group, int stages, int smem, void* stream) {
  const auto bad = (int)cudaErrorInvalidValue;
  if (B <= 0 || T_ <= 0 || C <= 0 || D <= 0 || T_ > 65535) return bad;
  if ((group != 1 && group != 4) || (B + group - 1) / group > 65535) return bad;
  const bool vec16 = D % 16 == 0 && reinterpret_cast<uintptr_t>(w8) % 16 == 0;
  if (stages != (vec16 ? kStages : 0)) return bad;
  const int ksteps = (C + kRowLanes - 1) / kRowLanes;
  const size_t bytes = smem_bytes(group, stages, ksteps);
  if (bytes > (size_t)kMaxSmem || (size_t)smem != bytes) return bad;
  // x's rows by cp.async on the 16-byte path, where each is whole 16-byte runs
  const bool xcopy = stages > 0 && C * sizeof(T) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const auto* xt = static_cast<const T*>(x);
  const auto* wq = static_cast<const int8_t*>(w8);
  const auto* st = static_cast<const T*>(scale);
  auto* yf = static_cast<float*>(y);
  const auto s = static_cast<cudaStream_t>(stream);
  return group == 1 ? launch<1, T>(xt, wq, st, yf, B, T_, C, D, ksteps, stages, xcopy, bytes, s)
                    : launch<4, T>(xt, wq, st, yf, B, T_, C, D, ksteps, stages, xcopy, bytes, s);
}

}  // namespace

// x: float32 [B, T, C]; w8: int8 [T, C, D]; scale: float32 [T, D];
// y: float32 [B, T, D]; all contiguous.  group, stages, smem: the launch
// plan (ops/cuda_kernels.py, dequant_matvec_plan).  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int wadt_dequant_matvec(const void* x, const void* w8, const void* scale, void* y,
                                   int B, int T, int C, int D, int group, int stages, int smem,
                                   void* stream) {
  return dispatch<float>(x, w8, scale, y, B, T, C, D, group, stages, smem, stream);
}

// The bf16 mode: x bf16 [B, T, C]; w8 int8 [T, C, D]; scale bf16 [T, D];
// y float32 [B, T, D]; all contiguous.
extern "C" int wadt_dequant_matvec_bf16(const void* x, const void* w8, const void* scale,
                                        void* y, int B, int T, int C, int D, int group, int stages,
                                        int smem, void* stream) {
  return dispatch<__nv_bfloat16>(x, w8, scale, y, B, T, C, D, group, stages, smem, stream);
}
