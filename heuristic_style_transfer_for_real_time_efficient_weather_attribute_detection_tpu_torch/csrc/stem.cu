// PMG stem for Hopper (sm_90a): uint8 image -> first trunk block, on the
// tensor cores, fed by bulk asynchronous copies.
//
// Replaces the Pallas TPU kernel `fused_stem`
// (heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu/ops/pallas_kernels.py:118,
// body `_stem_kernel` :92, out_dtype included), the same math as the packed
// GEMM stem of `pmg.packed_trunk_features` (models/pmg.py:346-358).
//
// What it computes, for raw uint8 NHWC x[B, H, W, cin] and a kernel == stride
// == k, pad 0 convolution whose ImageNet normalize is folded into the weight
// w[k*k*cin, cout] (row order dy, dx, ci), with acc = s2d(x) . w in float32:
//  - float32 mode: y = act(fmaf(acc, scale, shift)), float32 out, with act =
//    LeakyReLU(0.2) when `leaky` is set (the folded batch norm in scale and
//    shift; identity scale for other norms);
//  - bf16 mode (the bf16 batch path): y0 = bf16(acc + bias); with the batch
//    norm's bf16 scale s and shift t, y1 = bf16(y0 * s), y2 = bf16(y1 + t);
//    then y = y2 >= 0 ? y2 : bf16(y2 * 0.2f) when `leaky` is set; bf16 out.
//    Each step rounds once to nearest even, as one float32 operation
//    rounded to bf16 would: the same bits as the chain of PyTorch bf16
//    operations (`.to(bf16)`, `x * s + t`, `where(x >= 0, x, x * 0.2)`).
//    The sum and the LeakyReLU's product are __fadd_rn / __fmul_rn (no
//    contraction into an FMA); y0 * s and y1 + t are fma.rn.bf16x2, which
//    rounds the exact result once (see finish_bf16).
//
// What bounds it: memory.  At the main path's shape (B = 256, 224x224x3 ->
// 56x56x32, 802,816 output pixels) it reads 38.5 MB and writes 102.8 MB in
// float32 (42.2 us at 3.35 TB/s) or 51.4 MB in bf16 (26.8 us).  On the CUDA
// cores the 2.47 GFLOP alone took 37 us at the float32 peak (the previous,
// CUDA-core version of this kernel took 117.6 us); on the tensor cores the
// products are a few us.
//
// What the design does about it:
//  - Tensor cores with exact products: uint8 values are exact in bf16.  The
//    float32 weight is split in the kernel into three bf16 parts, hi =
//    bf16(w), mid = bf16(w - hi), lo = w - hi - mid (exact: 8 + 8 + 8
//    significant bits), and every product goes through mma.sync m16n8k16
//    with float32 sums (three per k-step and channel tile; the bf16 mode's
//    weight is bf16 already, one).
//  - The K order fits the fragments.  A pixel's input is k rows of k*cin
//    bytes, each cut into 4-byte words (12 at the main shape, no padding;
//    at most 12: three k-steps); k-step s takes words 4s..4s+3, and the
//    lane with t = lane % 4 takes word 4s + t: its bytes 0,1 are the A
//    fragment's columns 2t, 2t+1
//    and bytes 2,3 its columns 2t+8, 2t+9.  So each A register pair comes
//    from one 32-bit shared load per pixel, converted by a byte permute and
//    a float subtract per byte (no integer-to-float instruction).  The
//    weight rows are permuted the same way when each warp builds its B
//    fragments, once per block, from the float32 weight; a byte past k*cin
//    in a row's last word meets a zero weight row.
//  - Bulk asynchronous input.  A tile is `rows` whole output rows; the k
//    input rows under each are one contiguous run (2,688 bytes at the main
//    shape), fetched by one cp.async.bulk each into a ring of `stages`
//    slots on mbarriers (full: bytes landed; empty: the four consumer warps
//    are done with the slot).  One producer warp keeps the ring full; where
//    a run breaks the bulk copy's 16-byte rules it copies the bytes itself
//    (the plain path, which ops/cuda_kernels.stem_plan names).
//  - A persistent grid: ops/cuda_kernels.stem_plan sizes it to the SMs
//    (three blocks an SM, never more than the tiles); block k takes tiles
//    k, k + grid, ...  Each warp holds its B fragments in registers for the
//    whole run.  A 16-pixel m-tile goes to the warps in turn, the turn
//    rotating from tile to tile so that no warp falls behind.
//  - Bulk asynchronous output.  A warp writes a whole m-tile (16 pixels x
//    32 channels, 2 KB in float32) into one of its four buffers in the
//    swizzled layout of a 2-D tensor map (128-byte swizzle, 64-byte in
//    bf16: no bank conflicts) and sends it with one tensor store, reusing
//    a buffer only once its store has read it: the stores overlap the next
//    m-tiles' loads and products.  The map is encoded in the C launcher.
//    A tile's last partial m-tile, and a cout other than 32, 64 or 128,
//    are stored straight from the fragments.  Loads and stores carry an
//    L2 evict-first policy.
//  - The bf16 epilogue works on channel pairs: one cvt.rn.bf16x2 for y0,
//    fma.rn.bf16x2 for y0 * s and y1 + t, one more cvt for the negative
//    branch of the LeakyReLU.
// No atomics: every sum has a fixed order, so two runs give the same bits.
// Not done yet: the loads and stores alone take longer than a copy of the
// same bytes (chip_smoke.py --profile cuts the kernel stage by stage); the
// A fragments of chunks beyond the first are converted again by each
// chunk's warps; more than 12 words of input a pixel or more than 128
// channels is refused (the PMG stems are 12 words, <= 64 channels).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kConsumers = 4;                    // consumer warps a block
constexpr int kThreads = 32 * (kConsumers + 1);  // and one producer warp
constexpr int kNT = 4;          // 8-channel n-tiles a warp holds: a 32-channel chunk
constexpr int kKS = 3;          // k-steps of 16: up to 12 words of 4 bytes a pixel
constexpr int kOutBufs = 4;     // output buffers of one m-tile a consumer warp
constexpr int kMaxStages = 8;
constexpr int kSmemMax = 227 * 1024;

__host__ __device__ __forceinline__ int up(int n, int m) { return (n + m - 1) / m * m; }

// The shared-memory layout that the host and the kernel both derive, from a
// base aligned to 1024 bytes (the launch adds 1024 bytes to align it):
// the input ring, each consumer warp's output buffers (16 pixels of one
// 32-channel chunk each, in the tensor map's swizzled layout), the
// per-channel constants, the per-pixel offset table of a tile, the barriers.
struct Layout {
  int row_bytes;    // input bytes under one output row: k * W * cin
  int stage_bytes;  // one slot: rows runs, 16 bytes of slack (a last word's
                    // bytes past the run), rounded to 128
  int out;          // byte offset of the output buffers
  int out_bytes;    // one buffer: 16 x 32 float32 or bf16
  int consts;       // byte offset of the constants: 3 x (chunks * 32) of 4 bytes
  int table;        // byte offset of the pixel table
  int bars;         // byte offset of the barriers
  int smem;         // bytes to launch with
};

__host__ __device__ inline Layout layout(int W, int cin, int k, int Wp, int rows, int stages,
                                         int chunks, int esize) {
  Layout L;
  L.row_bytes = k * W * cin;
  L.stage_bytes = up(rows * L.row_bytes + 16, 128);
  L.out = up(stages * L.stage_bytes, 1024);
  L.out_bytes = 16 * 32 * esize;
  L.consts = L.out + kConsumers * kOutBufs * L.out_bytes;
  L.table = L.consts + 3 * chunks * 32 * 4;
  L.bars = up(L.table + 4 * rows * Wp, 16);
  L.smem = L.bars + 2 * 8 * stages + 1024;
  return L;
}

struct Args {
  const uint8_t* x;
  const float* w;
  const void* scale;   // float32 (float32 mode) or bf16 (bf16 mode with norm)
  const void* shift;
  const float* bias;   // bf16 mode
  void* y;
  int H, W, cin, k, cout, Hp, Wp;
  int nrows;           // B * Hp output rows
  int rows, stages, ntiles;
  int wpr, words;      // 4-byte words a pixel's input row, and a pixel
  int chunks;          // 32-channel chunks
  int norm, leaky, bulk, wordload, tma;
  Layout L;
};

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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Spin until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// An L2 policy that evicts first: the frames are read once and the output
// is written once, so neither should push the other out of L2.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

// Bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// device memory into this block's shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar,
                                          uint64_t pol) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(pol)
      : "memory");
}

// Tensor store of one box from shared memory at coordinates (c0 inner,
// c1 outer), in this thread's bulk group; rows past the tensor are dropped.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, uint64_t pol) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::cache_hint [%0, {%2, %3}], [%1], "
      "%4;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "l"(pol)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// This thread's bulk stores, all but the newest N, have finished reading shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Generic-proxy writes to shared memory become visible to the bulk copy.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d += a * b for one m16n8k16 tile: a row-major bf16, b column-major, d float32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a * b + c on bf16 pairs, each rounded once to nearest even.
__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// Byte `sel` of w as an exact float: 2^23 + byte, less 2^23.
template <int kSel>
__device__ __forceinline__ float byte_f32(uint32_t w) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | kSel)) - 8388608.f;
}

// Bytes 2h, 2h+1 of w as a bf16 pair (low half the first): an integer up to
// 255 has 8 significant bits, so its bf16 is the high half of its float.
template <int kH>
__device__ __forceinline__ uint32_t bytes_bf16x2(uint32_t w) {
  return __byte_perm(__float_as_uint(byte_f32<2 * kH>(w)),
                     __float_as_uint(byte_f32<2 * kH + 1>(w)), 0x7632);
}

// Two floats rounded to nearest even into a bf16 pair (lo the low half).
__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t load_word(const uint8_t* p, int wordload) {
  if (wordload) return *reinterpret_cast<const uint32_t*>(p);
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
}

__device__ __forceinline__ const uint8_t* src_row(const Args& a, int rr) {
  const int b = rr / a.Hp, hp = rr - b * a.Hp;
  return a.x + ((size_t)b * a.H + (size_t)hp * a.k) * a.W * a.cin;
}

// The producer warp: tile it of this block goes into slot it % stages once
// the consumers have released that slot's previous tile.
__device__ __forceinline__ void produce(const Args& a, uint8_t* ring, uint64_t* full,
                                        uint64_t* empty, int lane) {
  const int rb = a.L.row_bytes;
  const uint64_t pol = evict_first_policy();
  int it = 0;
  for (int tile = blockIdx.x; tile < a.ntiles; tile += gridDim.x, ++it) {
    const int s = it % a.stages;
    if (it >= a.stages) mbar_wait(&empty[s], (uint32_t)((it / a.stages - 1) & 1));
    uint8_t* dst = ring + (size_t)s * a.L.stage_bytes;
    const int r0 = tile * a.rows;
    const int nr = min(a.rows, a.nrows - r0);
    if (a.bulk) {
      if (lane == 0) {
        mbar_expect_tx(&full[s], (uint32_t)(nr * rb));
        for (int r = 0; r < nr; ++r)
          bulk_copy(dst + (size_t)r * rb, src_row(a, r0 + r), rb, &full[s], pol);
      }
    } else {
      for (int r = 0; r < nr; ++r) {
        const uint8_t* src = src_row(a, r0 + r);
        for (int i = lane; i < rb; i += 32) dst[(size_t)r * rb + i] = __ldg(src + i);
      }
      mbar_arrive(&full[s]);  // all 32 lanes: the barrier counts 32 on this path
    }
  }
}

// Word `wi` of a pixel: its byte offset under the pixel's first byte in the
// staged rows, and the weight rows of its four bytes (-1: a zero row).
__device__ __forceinline__ int word_rows(const Args& a, int wi, int (&rows)[4]) {
  if (wi >= a.words) {
    for (int i = 0; i < 4; ++i) rows[i] = -1;
    return 0;
  }
  const int dy = wi / a.wpr, jw = wi - dy * a.wpr;
  const int span = a.k * a.cin;
  for (int i = 0; i < 4; ++i) rows[i] = 4 * jw + i < span ? dy * span + 4 * jw + i : -1;
  return dy * a.W * a.cin + 4 * jw;
}

// The float32 epilogue of two sums of adjacent channels: act(fmaf(sum,
// scale, shift)).
__device__ __forceinline__ float2 finish_f32(const Args& a, float s0, float s1, float2 sc,
                                             float2 sh) {
  float2 y = make_float2(fmaf(s0, sc.x, sh.x), fmaf(s1, sc.y, sh.y));
  if (a.leaky) {
    y.x = y.x >= 0.f ? y.x : y.x * 0.2f;
    y.y = y.y >= 0.f ? y.y : y.y * 0.2f;
  }
  return y;
}

// The bf16 epilogue of two sums of adjacent channels, as a bf16 pair: y0 =
// bf16(sum + bias) (a float32 add, then one rounding); with the norm y1 =
// bf16(y0 * s) and y2 = bf16(y1 + t) on the pair, each a single rounding
// of the exact result (the product of two bf16 values is exact in float32,
// and a float32 sum of two that is not exact lies too far below the larger
// to move its bf16 rounding), so the same bits as a float32 operation
// rounded to bf16; then where y2 < 0, bf16(float(y2) * 0.2f) (-0 stays).
__device__ __forceinline__ uint32_t finish_bf16(const Args& a, float s0, float s1, float2 bias,
                                                uint32_t sc, uint32_t sh) {
  uint32_t y = bf16x2_bits(__fadd_rn(s0, bias.x), __fadd_rn(s1, bias.y));
  if (a.norm) {
    y = fma_bf16x2(y, sc, 0x80008000u);  // y0 * s (+ -0: the sign of a zero product kept)
    y = fma_bf16x2(y, 0x3F803F80u, sh);  // y1 * 1 + t
  }
  if (a.leaky) {
    const uint32_t neg = bf16x2_bits(__fmul_rn(__uint_as_float(y << 16), 0.2f),
                                     __fmul_rn(__uint_as_float(y & 0xFFFF0000u), 0.2f));
    const uint32_t m = ((y >> 15) & 0x10001u) * 0xFFFFu;  // the halves whose sign is set
    y = (y & ~m) | (neg & m);
  }
  return y;
}

template <bool kBf16>
__device__ __forceinline__ void consume(const Args& a, const CUtensorMap* ymap, const uint8_t* ring,
                                        uint8_t* obuf, const uint8_t* consts, const int* pixoff,
                                        uint64_t* full, uint64_t* empty, int warp, int lane) {
  constexpr int kSplits = kBf16 ? 1 : 3;
  const int g = lane >> 2, t = lane & 3;
  const int chunk = warp % a.chunks;
  const int wpc = kConsumers / a.chunks;  // warps that share the chunk
  const int wc = warp / a.chunks;
  const int n0 = chunk * 8 * kNT;
  const int cpad = a.chunks * 8 * kNT;

  // B fragments: for k-step s and n-tile j, b0 holds the weights of this
  // lane's word 4s + t, bytes 0 and 1, for channel n0 + 8j + g; b1 bytes 2, 3
  int woff[kKS];
  uint32_t bf[kKS][kNT][kSplits][2];
#pragma unroll
  for (int s = 0; s < kKS; ++s) {
    int rows[4];
    woff[s] = word_rows(a, 4 * s + t, rows);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int n = n0 + 8 * j + g;
      float part[kSplits][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float v = (rows[i] >= 0 && n < a.cout) ? __ldg(a.w + (size_t)rows[i] * a.cout + n) : 0.f;
#pragma unroll
        for (int sp = 0; sp < kSplits; ++sp) {  // hi, mid, lo: exact differences
          part[sp][i] = bf16r(v);
          v -= part[sp][i];
        }
      }
#pragma unroll
      for (int sp = 0; sp < kSplits; ++sp) {
        bf[s][j][sp][0] = bf16x2_bits(part[sp][0], part[sp][1]);
        bf[s][j][sp][1] = bf16x2_bits(part[sp][2], part[sp][3]);
      }
    }
  }
  const float* c0 = reinterpret_cast<const float*>(consts);  // scale or bias
  const float* c1 = c0 + cpad;                               // shift, or s and t as bf16
  uint8_t* mybuf = obuf + (size_t)warp * kOutBufs * a.L.out_bytes;
  const uint64_t pol = evict_first_policy();
  int q = 0;  // tensor stores this warp has issued

  const int mt_full = (a.rows * a.Wp + 15) / 16;
  int it = 0;
  for (int tile = blockIdx.x; tile < a.ntiles; tile += gridDim.x, ++it) {
    const int s = it % a.stages;
    mbar_wait(&full[s], (uint32_t)((it / a.stages) & 1));
    const uint8_t* st = ring + (size_t)s * a.L.stage_bytes;
    const int r0 = tile * a.rows;
    const int npx = min(a.rows, a.nrows - r0) * a.Wp;
    const int mt = (npx + 15) / 16;
    const long long pix0 = (long long)r0 * a.Wp;  // the tile's first output pixel
    // the chunk's warps take m-tiles in turn, the turn rotating by tile
    const int first = (wc + wpc - (int)(((long long)it * mt_full) % wpc)) % wpc;
    for (int m = first; m < mt; m += wpc) {
      const int p0 = m * 16 + g, p1 = p0 + 8;
      const uint8_t* x0 = st + pixoff[min(p0, npx - 1)];
      const uint8_t* x1 = st + pixoff[min(p1, npx - 1)];
      float acc[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        const uint32_t w0 = load_word(x0 + woff[ks], a.wordload);
        const uint32_t w1 = load_word(x1 + woff[ks], a.wordload);
        const uint32_t af[4] = {bytes_bf16x2<0>(w0), bytes_bf16x2<0>(w1), bytes_bf16x2<1>(w0),
                                bytes_bf16x2<1>(w1)};
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int sp = kSplits - 1; sp >= 0; --sp)  // the small parts first
            mma_bf16(acc[j], af, bf[ks][j][sp][0], bf[ks][j][sp][1]);
      }
      // acc[j][0..1]: pixel p0, channels n0 + 8j + 2t, +1; acc[j][2..3]: pixel p1
      uint32_t out[2][kNT][kBf16 ? 1 : 2];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = n0 + 8 * j + 2 * t;
        if (kBf16) {
          const float2 bias = *reinterpret_cast<const float2*>(c0 + n);
          const uint32_t sc = reinterpret_cast<const uint32_t*>(c1)[n / 2];
          const uint32_t sh = reinterpret_cast<const uint32_t*>(c1)[cpad / 2 + n / 2];
#pragma unroll
          for (int h = 0; h < 2; ++h)
            out[h][j][0] = finish_bf16(a, acc[j][2 * h], acc[j][2 * h + 1], bias, sc, sh);
        } else {
          const float2 sc = *reinterpret_cast<const float2*>(c0 + n);
          const float2 sh = *reinterpret_cast<const float2*>(c1 + n);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 y = finish_f32(a, acc[j][2 * h], acc[j][2 * h + 1], sc, sh);
            out[h][j][0] = __float_as_uint(y.x);
            out[h][j][kBf16 ? 0 : 1] = __float_as_uint(y.y);
          }
        }
      }
      if (a.tma && m * 16 + 16 <= npx) {
        // a whole m-tile: into this warp's next buffer in the map's swizzled
        // layout (no bank conflicts), then one tensor store
        uint8_t* buf = mybuf + (size_t)(q % kOutBufs) * a.L.out_bytes;
        if (lane == 0) bulk_wait_read<kOutBufs - 1>();  // the buffer's last store has read it
        __syncwarp();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = g + 8 * h;
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            if (kBf16) {  // 64-byte rows, 64-byte swizzle: 16-byte chunk j ^ ((r >> 1) & 3)
              *reinterpret_cast<uint32_t*>(buf + r * 64 + ((j ^ ((r >> 1) & 3)) << 4) + 4 * t) =
                  out[h][j][0];
            } else {  // 128-byte rows, 128-byte swizzle: 16-byte chunk (2j + t/2) ^ (r & 7)
              *reinterpret_cast<uint2*>(buf + r * 128 + (((2 * j + (t >> 1)) ^ (r & 7)) << 4) +
                                        8 * (t & 1)) = make_uint2(out[h][j][0], out[h][j][kBf16 ? 0 : 1]);
            }
          }
        }
        fence_async_shared();
        __syncwarp();
        if (lane == 0) tma_store_2d(ymap, buf, n0, (int)(pix0 + m * 16), pol);
        ++q;
      } else {
        // a partial m-tile (or no tensor map): straight from the fragments
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = h ? p1 : p0;
          if (p >= npx) continue;
          const long long o = (pix0 + p) * a.cout;
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            const int n = n0 + 8 * j + 2 * t;
            if (n >= a.cout) continue;
            if (kBf16) {
              __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(a.y) + o + n;
              if (!(a.cout & 1)) {
                *reinterpret_cast<uint32_t*>(yb) = out[h][j][0];
              } else {
                *reinterpret_cast<uint16_t*>(yb) = (uint16_t)(out[h][j][0] & 0xFFFFu);
                if (n + 1 < a.cout) *reinterpret_cast<uint16_t*>(yb + 1) = (uint16_t)(out[h][j][0] >> 16);
              }
            } else {
              float* yf = static_cast<float*>(a.y) + o + n;
              if (!(a.cout & 1)) {
                *reinterpret_cast<uint2*>(yf) = make_uint2(out[h][j][0], out[h][j][kBf16 ? 0 : 1]);
              } else {
                yf[0] = __uint_as_float(out[h][j][0]);
                if (n + 1 < a.cout) yf[1] = __uint_as_float(out[h][j][kBf16 ? 0 : 1]);
              }
            }
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  if (lane == 0) bulk_wait_read<0>();  // shared memory outlives every store's read
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 3)
    stem_kernel(__grid_constant__ const CUtensorMap ymap, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem;
  uint8_t* consts = smem + a.L.consts;
  int* pixoff = reinterpret_cast<int*>(smem + a.L.table);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + a.L.bars);
  uint64_t* empty = full + a.stages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // a tile pixel's first byte in its slot: output row r, column wp
  for (int p = threadIdx.x; p < a.rows * a.Wp; p += kThreads) {
    const int r = p / a.Wp, wp = p - r * a.Wp;
    pixoff[p] = r * a.L.row_bytes + wp * a.k * a.cin;
  }
  // per-channel constants, zero past cout: float32 scale and shift; bf16
  // the float32 bias, then s and t as bf16 (1 and 0 without the norm)
  const int cpad = a.chunks * 8 * kNT;
  for (int n = threadIdx.x; n < cpad; n += kThreads) {
    const bool in = n < a.cout;
    float* c = reinterpret_cast<float*>(consts);
    if (kBf16) {
      c[n] = in ? a.bias[n] : 0.f;
      __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(c + cpad);
      st[n] = in && a.norm ? static_cast<const __nv_bfloat16*>(a.scale)[n] : __float2bfloat16_rn(1.f);
      st[cpad + n] = in && a.norm ? static_cast<const __nv_bfloat16*>(a.shift)[n] : __float2bfloat16_rn(0.f);
    } else {
      c[n] = in ? static_cast<const float*>(a.scale)[n] : 0.f;
      c[cpad + n] = in ? static_cast<const float*>(a.shift)[n] : 0.f;
    }
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], a.bulk ? 1 : 32);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == kConsumers)
    produce(a, ring, full, empty, lane);
  else
    consume<kBf16>(a, &ymap, ring, smem + a.L.out, consts, pixoff, full, empty, warp, lane);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// y [npix, cout] as a 2-D map of boxes of 16 pixels x 32 channels: float32
// rows of 128 bytes with the 128-byte swizzle, bf16 rows of 64 bytes with
// the 64-byte swizzle.
bool encode_y(CUtensorMap* map, void* y, long long npix, int cout, bool bf16) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const int es = bf16 ? 2 : 4;
  const cuuint64_t dims[2] = {(cuuint64_t)cout, (cuuint64_t)npix};
  const cuuint64_t strides[1] = {(cuuint64_t)cout * es};
  const cuuint32_t box[2] = {32, 16};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, y,
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            bf16 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kBf16>
int launch(const CUtensorMap& ymap, const Args& a, int grid, cudaStream_t stream) {
  static int smem_set = 48 * 1024;  // the most dynamic shared memory allowed so far
  if (a.L.smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        stem_kernel<kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize, a.L.smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = a.L.smem;
  }
  stem_kernel<kBf16><<<grid, kThreads, a.L.smem, stream>>>(ymap, a);
  return (int)cudaGetLastError();
}

}  // namespace

// x: uint8 [B, H, W, cin]; w: float32 [k*k*cin, cout] (bf16-valued in the
// bf16 modes); y: float32 (mode 0) or bf16 (modes 1, 2) [B, H/k, W/k, cout];
// all contiguous.  mode 0: scale, shift float32 [cout]; mode 1: bias float32
// [cout], no norm; mode 2: bias float32, scale, shift bf16 [cout] (the batch
// norm).  rows, stages, grid, bulk, tma: the launch plan of
// ops/cuda_kernels.stem_plan (bulk needs x 16-byte aligned and k*W*cin and
// H*W*cin multiples of 16; tma, the tensor stores, needs y 16-byte aligned
// and cout 32, 64 or 128).  Rows and columns beyond a
// multiple of k are ignored, as by a pad-0 stride-k convolution.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int wadt_stem_u8(const void* x, const void* w, const void* scale, const void* shift,
                            const void* bias, void* y, int B, int H, int W, int cin, int k,
                            int cout, int mode, int leaky, int rows, int stages, int grid,
                            int bulk, int tma, void* stream) {
  if (B <= 0 || cin <= 0 || k <= 0 || cout <= 0 || cout > kNT * 8 * kConsumers || H < k ||
      W < k || rows <= 0 || stages < 2 || stages > kMaxStages || grid <= 0 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const uint8_t*>(x);
  a.w = static_cast<const float*>(w);
  a.scale = scale;
  a.shift = shift;
  a.bias = static_cast<const float*>(bias);
  a.y = y;
  a.H = H; a.W = W; a.cin = cin; a.k = k; a.cout = cout;
  a.Hp = H / k; a.Wp = W / k;
  if ((long long)B * a.Hp >= (1LL << 31) || (long long)B * a.Hp * a.Wp >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  a.nrows = B * a.Hp;
  a.rows = rows;
  a.stages = stages;
  a.ntiles = (a.nrows + rows - 1) / rows;
  a.wpr = (k * cin + 3) / 4;
  a.words = k * a.wpr;
  const int chunks = (cout + kNT * 8 - 1) / (kNT * 8);
  a.chunks = chunks <= 1 ? 1 : chunks <= 2 ? 2 : 4;  // a divisor of the consumer warps
  a.norm = mode == 2;
  a.leaky = leaky;
  const bool bf = mode > 0;
  a.L = layout(W, cin, k, a.Wp, rows, stages, a.chunks, bf ? 2 : 4);
  a.bulk = bulk && reinterpret_cast<uintptr_t>(x) % 16 == 0 && a.L.row_bytes % 16 == 0 &&
           ((long long)H * W * cin) % 16 == 0;
  a.tma = tma && reinterpret_cast<uintptr_t>(y) % 16 == 0 && cout == a.chunks * 8 * kNT;
  if (bulk != a.bulk || tma != a.tma) return (int)cudaErrorInvalidValue;  // plan and kernel disagree
  a.wordload = (k * cin) % 4 == 0 && (W * cin) % 4 == 0;
  if (a.words > 4 * kKS || a.L.smem > kSmemMax) return (int)cudaErrorInvalidValue;
  if ((mode > 0) != (bias != nullptr) || (mode != 1 && (scale == nullptr || shift == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(y) % 8) return (int)cudaErrorInvalidValue;
  CUtensorMap ymap = {};
  if (a.tma && !encode_y(&ymap, y, (long long)a.nrows * a.Wp, cout, bf))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf ? launch<true>(ymap, a, grid, s) : launch<false>(ymap, a, grid, s);
}
