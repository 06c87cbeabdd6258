// bf16 token projection from the row-major Gram, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `make_proj_kernel.proj`
// (tools/exp_pmg_projkernel.py:65, `pl.pallas_call` :67, body `kern` :50),
// the token projection of the PMG bf16 path read straight from the
// per-patch Gram.
//
// What it computes: out[m, n] = sum_k G[m, k] * W[k, n] + b[n], with G the
// flattened row-major Gram [M = B*Np, K = C*C] in bf16, W `token_proj` in
// its own [C*C, N] order in bf16, b float32, sums and out float32.  (The TPU
// kernel took W transposed to d-major and sliced G's sublanes; G is
// symmetric, so the flat row-major Gram is already the A operand of a GEMM
// and no transposed copy of W is needed.)
//
// What bounds it: memory.  At batch 256 of the shipped spec (M 2304,
// K 9216, N 192) it reads 42.5 MB of G and 3.5 MB of W and writes 1.8 MB,
// about 14.3 us at 3.35 TB/s, against 8.15 GFLOP, about 8.2 us of bf16
// tensor-core work at 989 TFLOP/s.
//
// What the design does about it (a simple version):
//  - one block per 64 x 64 output tile and slice of K, four warps of
//    32 x 32, each a 2 x 2 grid of 16 x 16 x 16 bf16 tensor-core products
//    (`nvcuda::wmma`) with float32 accumulators;
//  - split K: the main shape has only 108 output tiles for 132 SMs, one
//    block of four warps each, too few to hide the copies' latency (136 us).
//    The wrapper picks a split count for about eight blocks per SM (ten at
//    the main shape: 73 us); each slice writes float32 partial sums to a
//    scratch buffer, and a second launch adds the slices in a fixed order
//    and the bias (35 MB more traffic at the main shape);
//  - the K loop stages 64-deep tiles of G and W in shared memory, two
//    stages deep, filled with 16-byte `cp.async` copies while the previous
//    tile is multiplied; the row pitch is padded by 16 bytes so the
//    fragment loads spread over the banks;
//  - the N tiles of one row band are neighbours in the launch order, so the
//    band's G is read from device memory about once and then from L2;
//  - the epilogue goes through shared memory and writes whole output rows
//    (with the bias when K is not split); no atomics, so every run gives
//    the same result.
// Ragged shapes: rows and columns beyond M and N, and the K tail beyond
// the last whole tile, are masked (zero-filled copies); K and N must be
// multiples of 8 and G and W 16-byte aligned, so that every 16-byte copy
// lies wholly inside or outside a matrix (the entry point refuses other
// shapes; every spec's C*C and d_model are).  Not done yet: `wgmma` and TMA, and a
// tile wider in N so that G is read from L2 fewer times.  (A ring of four
// 32-deep stages was slower than these two 64-deep ones at every split.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kBM = 64;                 // output rows of a block
constexpr int kBN = 64;                 // output columns of a block
constexpr int kBK = 64;                 // depth of a staged tile
constexpr int kThreads = 128;           // 4 warps as 2 x 2, 32 x 32 each
constexpr int kPitchA = kBK + 8;        // bf16 elements per staged G row (144 B)
constexpr int kPitchB = kBN + 8;        // bf16 elements per staged W row (144 B)
constexpr int kPitchC = kBN + 4;        // floats per output-tile row
constexpr int kStageA = kBM * kPitchA;  // elements of one staged G tile
constexpr int kStageB = kBK * kPitchB;  // elements of one staged W tile
constexpr int kSmemAB = 2 * (kStageA + kStageB) * 2;
constexpr int kSmemC = kBM * kPitchC * 4;
constexpr int kSmemBytes = kSmemAB > kSmemC ? kSmemAB : kSmemC;  // 36,864 B

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0: no bytes read, the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage G[m0:m0+64, k0:k0+64] and W[k0:k0+64, n0:n0+64] with 16-byte
// copies; K % 8 == 0 and N % 8 == 0, so a copy is wholly inside or outside.
__device__ __forceinline__ void stage_async(bf16* as, bf16* bs, const bf16* __restrict__ g,
                                            const bf16* __restrict__ w, int M, int N, int K,
                                            int m0, int n0, int k0) {
  for (int c = threadIdx.x; c < kBM * kBK / 8; c += kThreads) {
    const int r = c / (kBK / 8), q = c % (kBK / 8);
    const int m = m0 + r, k = k0 + q * 8;
    const bool ok = m < M && k < K;
    cp_async16(as + r * kPitchA + q * 8, ok ? g + (size_t)m * K + k : g, ok);
  }
  for (int c = threadIdx.x; c < kBK * kBN / 8; c += kThreads) {
    const int r = c / (kBN / 8), q = c % (kBN / 8);
    const int k = k0 + r, n = n0 + q * 8;
    const bool ok = k < K && n < N;
    cp_async16(bs + r * kPitchB + q * 8, ok ? w + (size_t)k * N + n : w, ok);
  }
}

// blockIdx.z: the slice of K, [z * k_split, min(K, (z + 1) * k_split)),
// k_split a multiple of kBK.  part == nullptr: one slice, out = sum + bias;
// otherwise the slice's sums go to part[z] and gram_proj_reduce finishes.
__global__ void __launch_bounds__(kThreads)
gram_proj_kernel(const bf16* __restrict__ g, const bf16* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ out,
                 float* __restrict__ part, int M, int N, int K, int k_split) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  bf16* as = reinterpret_cast<bf16*>(smem);  // [2][kBM][kPitchA]
  bf16* bs = as + 2 * kStageA;               // [2][kBK][kPitchB]
  float* cs = reinterpret_cast<float*>(smem);  // [kBM][kPitchC], after the K loop

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int warp = threadIdx.x / 32;
  const int wm = warp / 2, wn = warp % 2;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int kb = blockIdx.z * k_split;
  const int nk = (min(K - kb, k_split) + kBK - 1) / kBK;
  stage_async(as, bs, g, w, M, N, K, m0, n0, kb);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) {
      // the other stage was last read in step kt-1, which ended in a barrier
      const int nx = (kt + 1) & 1;
      stage_async(as + nx * kStageA, bs + nx * kStageB, g, w, M, N, K, m0, n0,
                  kb + (kt + 1) * kBK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* a_t = as + st * kStageA;
    const bf16* b_t = bs + st * kStageB;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], a_t + (wm * 32 + i * 16) * kPitchA + kk * 16, kPitchA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], b_t + (kk * 16) * kPitchB + wn * 32 + j * 16, kPitchB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // this stage is consumed; the last one frees the tiles for cs
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm * 32 + i * 16) * kPitchC + wn * 32 + j * 16, acc[i][j],
                              kPitchC, wmma::mem_row_major);
  __syncthreads();
  // 64 consecutive threads write one output row's 64 columns
  float* dst = part ? part + (size_t)blockIdx.z * M * N : out;
  for (int e = threadIdx.x; e < kBM * kBN; e += kThreads) {
    const int r = e / kBN, c = e % kBN;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < N) dst[(size_t)m * N + n] = cs[r * kPitchC + c] + (part ? 0.f : bias[n]);
  }
}

// out[i] = sum over the slices s = 0, 1, ... of part[s][i], then + bias.
__global__ void __launch_bounds__(256)
gram_proj_reduce(const float* __restrict__ part, const float* __restrict__ bias,
                 float* __restrict__ out, int MN, int N, int splits) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < MN; i += gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += part[(size_t)s * MN + i];
    out[i] = acc + bias[i % N];
  }
}

}  // namespace

// g: bf16 [M, K] (the Gram [B, Np, C*C] flattened); w: bf16 [K, N];
// bias: float32 [N]; out: float32 [M, N]; all contiguous, K and N
// multiples of 8, g and w 16-byte aligned.  splits > 1 cuts
// K into that many slices of whole 64-deep tiles (fewer if K is short);
// part: float32 scratch [splits, M, N] for them (unused when splits == 1).
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int wadt_gram_proj_bf16(const void* g, const void* w, const void* bias, void* out,
                                   void* part, int M, int N, int K, int splits, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 != 0 || N % 8 != 0 || splits <= 0 ||
      (splits > 1 && part == nullptr) || reinterpret_cast<uintptr_t>(g) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int k_split = ((K + splits - 1) / splits + kBK - 1) / kBK * kBK;
  splits = (K + k_split - 1) / k_split;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const auto* gp = static_cast<const bf16*>(g);
  const auto* wp = static_cast<const bf16*>(w);
  const auto* bp = static_cast<const float*>(bias);
  auto* op = static_cast<float*>(out);
  auto* pp = splits > 1 ? static_cast<float*>(part) : nullptr;
  const auto s = (cudaStream_t)stream;
  gram_proj_kernel<<<grid, kThreads, 0, s>>>(gp, wp, bp, op, pp, M, N, K, k_split);
  if (splits > 1) {
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    const int mn = M * N;
    const int blocks = (mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096;
    gram_proj_reduce<<<blocks, 256, 0, s>>>(pp, bp, op, mn, N, splits);
  }
  return (int)cudaGetLastError();
}
