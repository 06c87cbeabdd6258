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
// 67 TFLOP/s.  At batch 1 the layers are a chain of small dependent steps,
// so latency, not either bound, sets the time.
//
// What the design does about it: two launches.
//  - Launch 1 splits token_proj over its Din rows, 256 rows x 64 columns a
//    block (108 blocks at the shipped shape), so the weight streams through
//    most SMs at once.  Each warp takes 32 rows; a lane owns one column pair
//    for up to 16 token rows and loads all 32 of its weight words (bf16
//    pairs, or int8 pairs dequantized in registers) before using any, so
//    their latency is paid once.  The eight warps' sums are added in a
//    fixed order, and each block writes a float32 partial sum [B*Np, 64] to
//    scratch that the wrapper allocates.
//  - Launch 2 is one thread block cluster per image, 8 blocks, or 16 where
//    a block's share of the weights needs it (the shipped head).  Block r
//    owns a share of the columns of every layer matrix (multiples of 8;
//    uneven shares and idle blocks allowed): the wrapper packs each block's
//    shares of all layers contiguously, and each layer's float32 vectors,
//    once per fold.  At kernel start each block issues one bulk copy
//    (`cp.async.bulk` on an `mbarrier`) per layer of its shares and the
//    layer's vectors into its own shared memory, and one per task it
//    classifies; so the whole transformer's weights are in flight on 8-16
//    SMs at once, and with programmatic dependent launch they stream in
//    while launch 1 still runs (`griddepcontrol.wait` comes before the
//    first read of the partial sums).  Every block keeps a full copy of the
//    activations.  Each GEMM stage computes the block's column share for
//    all Np rows on the tensor cores (`mma.sync` m16n8k16 bf16, float32
//    sums; the float32 activations are kept as two bf16 terms, hi + lo,
//    which keeps the product to about 2^-16 of float32), writes it into
//    every block's copy through distributed shared memory, and ends in one
//    cluster barrier: four a layer (QKV, the output projection, FFN1,
//    FFN2).  Layer norms (a half warp a row, the row in registers) and
//    attention (scores, softmax, P.V) are small and run redundantly in
//    every block on its own copy.  Launch 1's partial sums are added the
//    same way: each block sums its column share in chunk order and
//    all-gathers it.  Task t is pooled and classified by block t mod the
//    cluster size.
// No atomics: every sum is taken in a fixed order, so two runs give the
// same bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kChunkRows = 256;   // token_proj rows per launch-1 block
constexpr int kColTile = 64;      // token_proj columns per launch-1 block
constexpr int kRowTile = 16;      // token rows per pass of launch 1
constexpr int kProjThreads = 256;
constexpr int kProjWarps = kProjThreads / 32;
constexpr int kWarpRows = kChunkRows / kProjWarps;  // token_proj rows per warp
constexpr int kRestThreads = 512;
constexpr int kRestWarps = kRestThreads / 32;
constexpr int kMaxLayers = 8;
constexpr int kMaxCluster = 16;
constexpr int kSmemMax = 227 * 1024;

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
  // let launch 2 start its weight prefetch now; it waits for this grid's
  // completion before it reads `partial`
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
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
// Launch 2: the rest of the head, one cluster per image
// ---------------------------------------------------------------------------

// A layer's float32 vectors, packed: the d-wide n1s n1b bq bk bv bo n2s
// n2b f2b, then the FFN-wide f1b.
enum Vec { kN1s = 0, kN1b, kBq, kBk, kBv, kBo, kN2s, kN2b, kF2b, kF1b };

struct HeadArgs {
  const float* vecs;           // [n_layers][9 d + ff]
  const uint16_t* packed;      // every block's shares of every layer matrix, bf16
  int bd[kMaxCluster + 1];     // block r owns d-wide columns [bd[r], bd[r+1])
  int bf[kMaxCluster + 1];     // and FFN-wide columns [bf[r], bf[r+1])
  int off[kMaxCluster + 1];    // its packed shares start at packed + off[r]
  int n_layers;
  const float* partial;  // [chunks][B*Np][d]
  const float* tp_b;     // [d]
  const float* queries;  // [T][d]
  const float* heads_w;  // [T][d][kmax]
  const float* heads_b;  // [T][kmax]
  float* out;            // [B][T][kmax]
  int chunks, B, Np, d, ff, heads, T, kmax;
  int w_cap;  // bf16 elements of a block's weight buffer
  int t_cap;  // tasks a block classifies, at most
};

// Shared-memory layout of launch 2, in bytes from the (16-byte aligned)
// base; the wrapper's plan (`ops/cuda_kernels.head_share_plan`) mirrors it.
// The GEMM inputs are kept as bf16 hi/lo splits, rows padded to 16 (the
// padding rows only feed output rows that are never stored).  q, k and v
// rows are d + 4 floats apart, so that the score loop's 16-byte loads of
// eight rows fall on distinct banks.  FFN1's output (hhi, hlo) shares the
// bytes of q, k and v: each is dead while the other is written.
struct HeadSmem {
  int w, vec, tq, th, x, q, k, v, ahi, alo, hhi, hlo, att, ps, pooled, bars, total;
};

__host__ __device__ inline int up16(int bytes) { return (bytes + 15) / 16 * 16; }

__host__ __device__ inline HeadSmem head_smem(int w_cap, int t_cap, int n_layers, int Np, int d,
                                              int ff, int heads, int kmax) {
  const int rows = (Np + 15) / 16 * 16;
  HeadSmem s;
  int o = 0;
  s.w = o; o += up16(w_cap * 2);
  s.vec = o; o += n_layers * (9 * d + ff) * 4;
  s.tq = o; o += up16(t_cap * d * 4);
  s.th = o; o += up16(t_cap * d * kmax * 4);
  s.x = o; o += up16(Np * d * 4);
  const int qkv = up16(Np * (d + 4) * 4), hid = up16(rows * (ff + 8) * 2);
  s.q = s.hhi = o;
  s.k = o + qkv;
  s.v = o + 2 * qkv;
  s.hlo = o + hid;
  o += 3 * qkv > 2 * hid ? 3 * qkv : 2 * hid;
  s.ahi = o; o += up16(rows * (d + 8) * 2);
  s.alo = o; o += up16(rows * (d + 8) * 2);
  s.att = o; o += up16(heads * Np * Np * 4);
  s.ps = o; o += up16(t_cap * Np * 4);
  s.pooled = o; o += up16(t_cap * d * 4);
  s.bars = o; o += (kMaxLayers + 1) * 8;
  s.total = o;
  return s;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// device memory into this block's shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Sum of a lane's values over the warp, in a fixed order.
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over each half of the warp, in a fixed order.
__device__ __forceinline__ float half_sum(float v) {
  for (int o = 8; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  return (__float_as_uint(lo_col) >> 16) | (__float_as_uint(hi_col) & 0xffff0000u);
}

// The bf16 hi/lo split of a float32 pair: hi = bf16(a), lo = bf16(a - hi),
// so that a * w = hi * w + lo * w to about 2^-16 of a (w bf16 already).
__device__ __forceinline__ void split2(float a0, float a1, uint32_t& hi, uint32_t& lo) {
  const float h0 = round_bf16(a0), h1 = round_bf16(a1);
  hi = pack_bf16(h0, h1);
  lo = pack_bf16(round_bf16(a0 - h0), round_bf16(a1 - h1));
}

constexpr int kMaxPerLane = 16;  // d / 16 values a half warp holds in layer norm (d <= 256)

// LayerNorm(x[r]) * s + b of the Np rows of width d, written as bf16 hi/lo
// splits (row pitch d + 8); a half warp a row, the row in registers.  A
// warp takes rows in pairs, so that the whole warp takes part in every
// shuffle, also where its second row lies beyond Np.
__device__ void layer_norm_split(const float* x, int Np, int d, const float* s, const float* b,
                                 uint16_t* hi, uint16_t* lo) {
  const int lane = threadIdx.x % 16;
  for (int r0 = 2 * (threadIdx.x / 32); r0 < Np; r0 += 2 * kRestWarps) {
    const int r = r0 + (threadIdx.x % 32) / 16;
    const bool row = r < Np;
    const float* xr = x + (size_t)r * d;
    float v[kMaxPerLane];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; i += 2) {  // 8-byte loads: a half warp reads 128 bytes
      const int j = 2 * lane + 16 * i;
      const float2 p = row && j < d ? *reinterpret_cast<const float2*>(xr + j) : make_float2(0.f, 0.f);
      v[i] = p.x;
      v[i + 1] = p.y;
      sum += v[i];
      sum += v[i + 1];
    }
    const float mu = half_sum(sum) / (float)d;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int j = 2 * lane + 32 * (i / 2) + (i % 2);
      if (j < d) sq += (v[i] - mu) * (v[i] - mu);
    }
    const float inv = 1.0f / sqrtf(half_sum(sq) / (float)d + 1e-5f);
#pragma unroll
    for (int i = 0; i < kMaxPerLane; i += 2) {
      const int j = 2 * lane + 16 * i;
      if (row && j < d) {
        uint32_t h, l;
        split2((v[i] - mu) * inv * s[j] + b[j], (v[i + 1] - mu) * inv * s[j + 1] + b[j + 1], h, l);
        *reinterpret_cast<uint32_t*>(hi + (size_t)r * (d + 8) + j) = h;
        *reinterpret_cast<uint32_t*>(lo + (size_t)r * (d + 8) + j) = l;
      }
    }
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

// The block's column share of A[Np, Kd] @ W_m for nmat matrices m on the
// tensor cores: A as bf16 hi/lo splits (row pitch Kd + 8, rows padded to 16),
// W_m's share bf16 [Kd, cw] row-major at w + m Kd cw.  A warp takes one
// 16 x 8 output tile at a time over the whole of Kd, the hi and lo products
// in two float32 chains added at the end (a fixed order), and hands each
// row's column pair to store(m, row, col, v0, v1), col in [0, cw).
template <typename Store>
__device__ __forceinline__ void gemm_share(const uint16_t* ahi, const uint16_t* alo, int Np,
                                           int Kd, const uint16_t* w, int cw, int nmat,
                                           Store store) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int lda = Kd + 8;
  const int ntn = cw / 8, mt = (Np + 15) / 16;
  for (int tile = warp; tile < nmat * mt * ntn; tile += kRestWarps) {
    const int m = tile / (mt * ntn);
    const int r0 = (tile / ntn) % mt * 16;
    const int n0 = tile % ntn * 8;
    const uint16_t* ah = ahi + (size_t)(r0 + g) * lda + 2 * t;
    const uint16_t* al = alo + (size_t)(r0 + g) * lda + 2 * t;
    const uint16_t* bp = w + (size_t)m * Kd * cw + (size_t)(2 * t) * cw + n0 + g;
    float ch[4] = {0.f, 0.f, 0.f, 0.f}, cl[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
    for (int k = 0; k < Kd; k += 16) {
      uint32_t a[4], l[4];
      a[0] = *reinterpret_cast<const uint32_t*>(ah + k);
      a[1] = *reinterpret_cast<const uint32_t*>(ah + 8 * lda + k);
      a[2] = *reinterpret_cast<const uint32_t*>(ah + k + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(ah + 8 * lda + k + 8);
      l[0] = *reinterpret_cast<const uint32_t*>(al + k);
      l[1] = *reinterpret_cast<const uint32_t*>(al + 8 * lda + k);
      l[2] = *reinterpret_cast<const uint32_t*>(al + k + 8);
      l[3] = *reinterpret_cast<const uint32_t*>(al + 8 * lda + k + 8);
      const uint16_t* b = bp + (size_t)k * cw;
      const uint32_t b0 = (uint32_t)b[0] | ((uint32_t)b[cw] << 16);
      const uint32_t b1 = (uint32_t)b[8 * cw] | ((uint32_t)b[9 * cw] << 16);
      mma_bf16(ch, a, b0, b1);
      mma_bf16(cl, l, b0, b1);
    }
    if (r0 + g < Np) store(m, r0 + g, n0 + 2 * t, ch[0] + cl[0], ch[1] + cl[1]);
    if (r0 + g + 8 < Np) store(m, r0 + g + 8, n0 + 2 * t, ch[2] + cl[2], ch[3] + cl[3]);
  }
}

// Write a value into every block's copy of an activation (same offset),
// with shared::cluster stores to the `mapa`-mapped addresses.
__device__ __forceinline__ uint32_t map_rank(uint32_t local, int q) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(q));
  return remote;
}

__device__ __forceinline__ void all_gather(cg::cluster_group& cl, float2* local, float2 v) {
  const uint32_t a = smem_u32(local);
  const int n = (int)cl.num_blocks();
#pragma unroll 4
  for (int q = 0; q < n; ++q)
    asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(map_rank(a, q)), "f"(v.x),
                 "f"(v.y)
                 : "memory");
}

__device__ __forceinline__ void all_gather(cg::cluster_group& cl, uint32_t* local, uint32_t v) {
  const uint32_t a = smem_u32(local);
  const int n = (int)cl.num_blocks();
#pragma unroll 4
  for (int q = 0; q < n; ++q)
    asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(map_rank(a, q)), "r"(v) : "memory");
}

__global__ void __launch_bounds__(kRestThreads, 1) head_cluster_kernel(const HeadArgs a) {
  extern __shared__ float4 smem4[];
  uint8_t* base = reinterpret_cast<uint8_t*>(smem4);
  cg::cluster_group cl = cg::this_cluster();
  const int r = (int)cl.block_rank();
  const int cs = (int)cl.num_blocks();
  const int b = blockIdx.x / cs;  // the image
  const int Np = a.Np, d = a.d, ff = a.ff;
  const HeadSmem L = head_smem(a.w_cap, a.t_cap, a.n_layers, Np, d, ff, a.heads, a.kmax);
  uint16_t* wsm = reinterpret_cast<uint16_t*>(base + L.w);
  float* vsm = reinterpret_cast<float*>(base + L.vec);
  float* tq = reinterpret_cast<float*>(base + L.tq);
  float* th = reinterpret_cast<float*>(base + L.th);
  float* x = reinterpret_cast<float*>(base + L.x);
  float* q = reinterpret_cast<float*>(base + L.q);
  float* kk = reinterpret_cast<float*>(base + L.k);
  float* v = reinterpret_cast<float*>(base + L.v);
  uint16_t* ahi = reinterpret_cast<uint16_t*>(base + L.ahi);
  uint16_t* alo = reinterpret_cast<uint16_t*>(base + L.alo);
  uint16_t* hhi = reinterpret_cast<uint16_t*>(base + L.hhi);
  uint16_t* hlo = reinterpret_cast<uint16_t*>(base + L.hlo);
  float* att = reinterpret_cast<float*>(base + L.att);
  float* ps = reinterpret_cast<float*>(base + L.ps);
  float* pooled = reinterpret_cast<float*>(base + L.pooled);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L.bars);
  const int c0 = a.bd[r], cw = a.bd[r + 1] - c0;  // this block's d-wide columns
  const int f0 = a.bf[r], fw = a.bf[r + 1] - f0;  // and FFN-wide columns
  const int region = 4 * d * cw + d * fw + ff * cw;  // bf16 elements a layer
  const int nvec = 9 * d + ff;                        // float32 vector elements a layer
  const int ntask = a.T > r ? (a.T - 1 - r) / cs + 1 : 0;  // tasks r, r + cs, ...
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // prefetch: every layer's shares and vectors and this block's task
  // weights, all in flight at once; none of it depends on launch 1
  if (threadIdx.x == 0) {
    for (int i = 0; i <= kMaxLayers; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int l = 0; l < a.n_layers; ++l) {
      mbar_expect_tx(&bars[l], region * 2 + nvec * 4);
      if (region > 0)
        bulk_copy(wsm + (size_t)l * region, a.packed + a.off[r] + (size_t)l * region, region * 2,
                  &bars[l]);
      bulk_copy(vsm + (size_t)l * nvec, a.vecs + (size_t)l * nvec, nvec * 4, &bars[l]);
    }
    if (ntask > 0) {
      mbar_expect_tx(&bars[kMaxLayers], ntask * d * (1 + a.kmax) * 4);
      for (int j = 0; j < ntask; ++j) {
        const int t = r + j * cs;
        bulk_copy(tq + j * d, a.queries + (size_t)t * d, d * 4, &bars[kMaxLayers]);
        bulk_copy(th + (size_t)j * d * a.kmax, a.heads_w + (size_t)t * d * a.kmax,
                  d * a.kmax * 4, &bars[kMaxLayers]);
      }
    }
  }
  cl.sync();  // every block runs, and its barriers are set, before any remote write
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // launch 1 is complete

  // x[:, share] = sum of launch 1's partials in chunk order + bias, gathered
  const int M = a.B * Np;
  for (int e = threadIdx.x; e < Np * (cw / 2); e += kRestThreads) {
    const int i = e / (cw / 2);
    const int c = c0 + 2 * (e - i * (cw / 2));
    float2 s = make_float2(0.f, 0.f);
#pragma unroll 12  // independent loads, in flight together
    for (int ch = 0; ch < a.chunks; ++ch) {
      const float2 p =
          *reinterpret_cast<const float2*>(a.partial + ((size_t)ch * M + (size_t)b * Np + i) * d + c);
      s.x += p.x;
      s.y += p.y;
    }
    s.x += a.tp_b[c];
    s.y += a.tp_b[c + 1];
    all_gather(cl, reinterpret_cast<float2*>(x + (size_t)i * d + c), s);
  }
  cl.sync();

  const int hd = d / a.heads;
  const int ldq = d + 4;  // row pitch of q, k and v
  const float qscale = 1.0f / sqrtf((float)hd);
  for (int l = 0; l < a.n_layers; ++l) {
    const float* P = vsm + (size_t)l * nvec;
    const uint16_t* wl = wsm + (size_t)l * region;
    mbar_wait(&bars[l], 0);
    layer_norm_split(x, Np, d, P + kN1s * d, P + kN1b * d, ahi, alo);
    __syncthreads();
    // q (scaled), k, v: this block's columns, gathered
    float* const qkv[3] = {q, kk, v};
    gemm_share(ahi, alo, Np, d, wl, cw, 3, [&](int m, int i, int c, float v0, float v1) {
      const float* bias = P + (kBq + m) * d + c0 + c;
      const float sc = m == 0 ? qscale : 1.f;
      float* dst = m == 0 ? qkv[0] : (m == 1 ? qkv[1] : qkv[2]);
      all_gather(cl, reinterpret_cast<float2*>(dst + (size_t)i * ldq + c0 + c),
                 make_float2((v0 + bias[0]) * sc, (v1 + bias[1]) * sc));
    });
    cl.sync();
    // attention on this block's full copy: scores, softmax, P . V -> hi/lo
    for (int e = threadIdx.x; e < a.heads * Np * Np; e += kRestThreads) {
      const int hh = e / (Np * Np);
      const int i = (e / Np) % Np;
      const int j = e % Np;
      const float4* qi = reinterpret_cast<const float4*>(q + (size_t)i * ldq + hh * hd);
      const float4* kj = reinterpret_cast<const float4*>(kk + (size_t)j * ldq + hh * hd);
      float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int t = 0; t < hd / 4; ++t) {
        const float4 qa = qi[t], kb = kj[t];
        s4[0] = fmaf(qa.x, kb.x, s4[0]);
        s4[1] = fmaf(qa.y, kb.y, s4[1]);
        s4[2] = fmaf(qa.z, kb.z, s4[2]);
        s4[3] = fmaf(qa.w, kb.w, s4[3]);
      }
      att[e] = (s4[0] + s4[1]) + (s4[2] + s4[3]);
    }
    __syncthreads();
    softmax_rows(att, a.heads * Np, Np);
    __syncthreads();
    for (int e = threadIdx.x; e < Np * (d / 4); e += kRestThreads) {
      const int i = e / (d / 4);
      const int c = (e % (d / 4)) * 4;
      const float* p = att + ((size_t)(c / hd) * Np + i) * Np;
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int j = 0; j < Np; ++j) {
        const float4 vj = *reinterpret_cast<const float4*>(v + (size_t)j * ldq + c);
        o.x = fmaf(p[j], vj.x, o.x);
        o.y = fmaf(p[j], vj.y, o.y);
        o.z = fmaf(p[j], vj.z, o.z);
        o.w = fmaf(p[j], vj.w, o.w);
      }
      uint32_t h0, l0, h1, l1;
      split2(o.x, o.y, h0, l0);
      split2(o.z, o.w, h1, l1);
      *reinterpret_cast<uint2*>(ahi + (size_t)i * (d + 8) + c) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(alo + (size_t)i * (d + 8) + c) = make_uint2(l0, l1);
    }
    __syncthreads();
    // x += attention @ Wo + bo: this block's columns, gathered
    gemm_share(ahi, alo, Np, d, wl + 3 * d * cw, cw, 1, [&](int, int i, int c, float v0, float v1) {
      float* xo = x + (size_t)i * d + c0 + c;
      const float* bias = P + kBo * d + c0 + c;
      all_gather(cl, reinterpret_cast<float2*>(xo),
                 make_float2(xo[0] + (v0 + bias[0]), xo[1] + (v1 + bias[1])));
    });
    cl.sync();
    layer_norm_split(x, Np, d, P + kN2s * d, P + kN2b * d, ahi, alo);
    __syncthreads();
    // ReLU(LN2(x) @ FFN1 + b): this block's FFN columns, gathered as hi/lo
    gemm_share(ahi, alo, Np, d, wl + 4 * d * cw, fw, 1, [&](int, int i, int c, float v0, float v1) {
      const float* bias = P + 9 * d + f0 + c;
      uint32_t h, lw;
      split2(fmaxf(v0 + bias[0], 0.f), fmaxf(v1 + bias[1], 0.f), h, lw);
      all_gather(cl, reinterpret_cast<uint32_t*>(hhi + (size_t)i * (ff + 8) + f0 + c), h);
      all_gather(cl, reinterpret_cast<uint32_t*>(hlo + (size_t)i * (ff + 8) + f0 + c), lw);
    });
    cl.sync();
    // x += hidden @ FFN2 + b: this block's columns, gathered
    gemm_share(hhi, hlo, Np, ff, wl + 4 * d * cw + d * fw, cw, 1,
               [&](int, int i, int c, float v0, float v1) {
                 float* xo = x + (size_t)i * d + c0 + c;
                 const float* bias = P + kF2b * d + c0 + c;
                 all_gather(cl, reinterpret_cast<float2*>(xo),
                            make_float2(xo[0] + (v0 + bias[0]), xo[1] + (v1 + bias[1])));
               });
    cl.sync();
  }
  // no remote access from here on: each block pools and classifies its tasks
  if (ntask == 0) return;
  mbar_wait(&bars[kMaxLayers], 0);
  for (int e = warp; e < ntask * Np; e += kRestWarps) {
    const int j = e / Np;
    const int n = e % Np;
    float s = 0.f;
    for (int c = lane; c < d; c += 32) s = fmaf(tq[(size_t)j * d + c], x[(size_t)n * d + c], s);
    s = warp_sum(s);
    if (lane == 0) ps[e] = s;
  }
  __syncthreads();
  softmax_rows(ps, ntask, Np);
  __syncthreads();
  for (int e = threadIdx.x; e < ntask * d; e += kRestThreads) {
    const int j = e / d;
    const int c = e % d;
    float s = 0.f;
    for (int n = 0; n < Np; ++n) s = fmaf(ps[j * Np + n], x[(size_t)n * d + c], s);
    pooled[e] = s;
  }
  __syncthreads();
  for (int e = warp; e < ntask * a.kmax; e += kRestWarps) {
    const int j = e / a.kmax;
    const int k = e % a.kmax;
    const int t = r + j * cs;
    const float* hw = th + (size_t)j * d * a.kmax + k;
    float s = 0.f;
    for (int c = lane; c < d; c += 32) s = fmaf(pooled[(size_t)j * d + c], hw[(size_t)c * a.kmax], s);
    s = warp_sum(s);
    if (lane == 0) a.out[((size_t)b * a.T + t) * a.kmax + k] = s + a.heads_b[t * a.kmax + k];
  }
}

}  // namespace

// tokens: float32 [B, Np, Din]; token_proj: bf16 tp_w [Din, d] (tp_q8 = 0)
// or int8 tp_w [Din, d] with float32 tp_scale [d] (tp_q8 = 1); tp_b [d];
// packed: bf16, block r's shares of every layer at packed + off[r], per
// layer Wq, Wk, Wv, Wo, FFN2 columns [bd[r], bd[r+1]) and FFN1 columns
// [bf[r], bf[r+1]) in the order q k v o f1 f2, each [in, share] row-major;
// vecs: float32 [n_layers, 9 d + ff], each layer's n1s n1b bq bk bv bo n2s
// n2b f2b (d wide) then f1b (ff wide); bd, bf, off: host
// arrays of cluster + 1 ints; queries float32 [T, d]; heads_w [T, d, kmax];
// heads_b [T, kmax]; partial: float32 scratch [partial_chunks, B*Np, d] with
// partial_chunks = ceil(Din / 256); out float32 [B, T, kmax].  All
// contiguous.  w_cap, t_cap: the weight buffer (bf16 elements) and tasks of
// a block.  stages: 1 launch 1 only, 2 launch 2 only (on launch 1's last
// partial sums), 3 both.  Returns the first error (0 on success), or
// cudaErrorInvalidValue for sizes it does not take.
extern "C" int wadt_fused_head(const void* tokens, const void* tp_w, int tp_q8,
                               const void* tp_scale, const void* tp_b, const void* packed,
                               const void* vecs, int n_layers, const int* bd,
                               const int* bf, const int* off, int cluster, int w_cap, int t_cap,
                               const void* queries, const void* heads_w, const void* heads_b,
                               void* partial, int partial_chunks, void* out, int B, int Np,
                               int Din, int d, int ff, int heads, int T, int kmax, int stages,
                               void* stream) {
  if (B <= 0 || Np <= 0 || Din <= 0 || d <= 0 || d % 8 != 0 || T <= 0 || kmax <= 0 ||
      n_layers < 0 || n_layers > kMaxLayers || cluster < 1 || cluster > kMaxCluster ||
      t_cap != (T + cluster - 1) / cluster || w_cap < 0 || w_cap % 8 != 0 || stages < 1 || stages > 3 ||
      partial_chunks != (Din + kChunkRows - 1) / kChunkRows ||
      (n_layers > 0 && (heads <= 0 || d % 16 != 0 || d > 16 * kMaxPerLane || d % heads != 0 ||
                        (d / heads) % 4 != 0 || ff <= 0 || ff % 16 != 0)) ||
      (long long)B * Np * Din >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (n_layers == 0) ff = 0, heads = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * Np;
  cudaError_t err;
  if (stages & 1) {
    const dim3 grid1(partial_chunks, (d + kColTile - 1) / kColTile);
    const size_t smem1 =
        (size_t)(kRowTile * kChunkRows + kProjWarps * kRowTile * kColTile) * sizeof(float);
    head_proj_kernel<<<grid1, kProjThreads, smem1, s>>>(
        static_cast<const float*>(tokens), tp_q8 ? nullptr : static_cast<const uint16_t*>(tp_w),
        tp_q8 ? static_cast<const int8_t*>(tp_w) : nullptr, static_cast<const float*>(tp_scale),
        static_cast<float*>(partial), M, Din, d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (!(stages & 2)) return 0;

  HeadArgs a = {};
  a.vecs = static_cast<const float*>(vecs);
  for (int i = 0; i <= cluster; ++i) {
    a.bd[i] = bd[i];
    a.bf[i] = n_layers > 0 ? bf[i] : 0;
    a.off[i] = off[i];
  }
  for (int i = 0; i < cluster; ++i) {
    const int cw = a.bd[i + 1] - a.bd[i], fw = a.bf[i + 1] - a.bf[i];
    if (cw < 0 || fw < 0 || cw % 8 != 0 || fw % 8 != 0 || a.off[i] % 8 != 0 ||
        (long long)n_layers * (4 * d * cw + d * fw + ff * cw) > w_cap)
      return (int)cudaErrorInvalidValue;
  }
  if (a.bd[0] != 0 || a.bd[cluster] != d || a.bf[0] != 0 || a.bf[cluster] != ff ||
      reinterpret_cast<uintptr_t>(packed) % 16 != 0 || reinterpret_cast<uintptr_t>(vecs) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(queries) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(heads_w) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  a.packed = static_cast<const uint16_t*>(packed);
  a.n_layers = n_layers;
  a.partial = static_cast<const float*>(partial);
  a.tp_b = static_cast<const float*>(tp_b);
  a.queries = static_cast<const float*>(queries);
  a.heads_w = static_cast<const float*>(heads_w);
  a.heads_b = static_cast<const float*>(heads_b);
  a.out = static_cast<float*>(out);
  a.chunks = partial_chunks;
  a.B = B; a.Np = Np; a.d = d; a.ff = ff; a.heads = heads;
  a.T = T; a.kmax = kmax;
  a.w_cap = w_cap; a.t_cap = t_cap;
  const int smem2 = head_smem(w_cap, t_cap, n_layers, Np, d, ff, heads, kmax).total;
  if (smem2 > kSmemMax) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(head_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
  if (err != cudaSuccess) return (int)err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(head_cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * cluster);
  cfg.blockDim = dim3(kRestThreads);
  cfg.dynamicSmemBytes = smem2;
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, head_cluster_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
