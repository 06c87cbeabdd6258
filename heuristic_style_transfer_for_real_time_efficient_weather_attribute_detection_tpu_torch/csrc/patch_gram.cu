// Per-patch Gram tokens for Hopper (sm_90a): a persistent, store-overlapped
// schedule, with the bf16 products on the tensor cores.
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
// path), which sums in float32 and rounds G once to bf16 (nearest even).
//
// What bounds it: memory.  At the main path's shape (B = 256, 14x14x96,
// div 3: 2,304 items of nine 5x5 patches, each a 96x96 tile that is one
// contiguous run of `out`) float32 reads 19.3 MB and writes 84.9 MB, 31.1 us
// at 3.35 TB/s; bf16 moves half, 15.6 us.  The 0.53 G multiply-adds take
// 16 us on the CUDA cores at 67 TFLOP/s, as long as the bf16 bound itself,
// so the bf16 path cannot come near its bound without the tensor cores.
//
// What the design does about it:
//  - A persistent grid of two (float32) or three (bf16) blocks per SM,
//    sized by ops/cuda_kernels.patch_gram_plan and never larger than the
//    number of units; block k walks units k, k + grid, ...  A unit is one
//    (image, patch) and a band of whole output rows (the whole C x C tile
//    unless C is wide), so its output is one contiguous run.
//  - Double-buffered loads: a stage is up to kc pixels of a unit's patch.
//    The next stage's pixels go into the other slot with 16-byte cp.async
//    while this stage computes.  Row and column indices are clamped to H-1
//    and W-1: that clamp is the replicate pad (a TMA box fills zeros).
//  - One bulk store per unit: the finished band is scaled by 1/area in
//    registers, written into one of two output buffers in shared memory and
//    sent out with one cp.async.bulk.  A buffer is reused only after its
//    store has finished reading it (cp.async.bulk.wait_group.read), so unit
//    i's store overlaps unit i+1's loads and products.
//  - Only the tiles on and above the diagonal are computed; each is written
//    as it is and transposed (with one band).  float32: CUDA cores, float32
//    FMAs in pixel order, a thread a 6x6 tile, the tiles handed out diagonal
//    after diagonal so that a warp's writes and its transposed writes fall
//    on distinct banks.  (TF32 would miss the 1e-5 limit.)
//  - bf16: mma.sync m16n8k16 with float32 sums, pixels zero-padded to a
//    multiple of 16, a warp up to four 16x16 tiles side by side in each
//    k-step.  A = P^T and B = P come from the same staged patch through
//    ldmatrix.trans; tiles go out with stmatrix and stmatrix.trans.
//  - bf16 rounding: the tensor cores add a k-step's products with their own
//    alignment and rounding, not as the sequential float32 FMAs that the
//    plain version (and the TPU kernel's float32 einsum) rounds to bf16, so
//    a sum near a bf16 rounding boundary could round the other way.  Each
//    bf16 output is certified instead: with S = sqrt(G_ii G_jj) >= sum |p|
//    (Cauchy-Schwarz), both sums lie within (36 k-steps + area + 8) 2^-24 S
//    of the exact one (36 a k-step: 17 addends truncated to the largest one's
//    24 bits and a final rounding, with no extra bits assumed); where that
//    interval holds a bf16 rounding boundary, the output is recomputed with
//    sequential FMAs in pixel order, the warp's flagged outputs spread over
//    its lanes (about 5 % of them at the main shape with random data).
// No atomics: every sum has a fixed order, so two runs give the same bits.
// Not done yet: in bf16 the certificate and its recomputations cost more
// than the products (chip_smoke.py --profile cuts them apart); a tighter
// bound for Hopper's mma.sync would flag fewer outputs.  A wide C is cut
// into bands of rows rather than into column tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 6;               // float32: a thread's output tile edge
constexpr int kWarpTiles = 4;       // bf16: 16 x 16 output tiles a warp holds
constexpr int kSlots = 2;           // input slots: the next stage loads while this one computes
constexpr int kSmemMax = 227 * 1024;

using bf16 = __nv_bfloat16;

__host__ __device__ __forceinline__ int up(int n, int m) { return (n + m - 1) / m * m; }

// The launch layout that the host and the kernel both derive from (C, kc, band).
struct Layout {
  int ld;         // elements between two staged pixels
  int in_bytes;   // one input slot: kc pixels
  int out_bytes;  // one output buffer: band rows of C
  int n_tiles;    // float32: 6x6 thread tiles of a unit; bf16: 16x16 warp tiles of a band
  int smem;
};

template <bool kBf16>
__host__ __device__ Layout layout(int C, int kc, int band) {
  Layout L;
  const int esize = kBf16 ? 2 : 4;
  L.ld = kBf16 ? up(C, 16) + 8 : up(C, 12);
  L.in_bytes = kc * L.ld * esize;
  L.out_bytes = up(band * C * esize, 16);
  if (kBf16) {
    const int g = up(C, 16) / 16;
    L.n_tiles = band >= C ? g * (g + 1) / 2 : (up(band, 16) / 16) * g;
  } else {
    const int n = (C + kT - 1) / kT;
    L.n_tiles = band >= C ? n * (n + 1) / 2 : (band / kT) * n;
  }
  // the input slots, two output buffers; bf16 adds the per-channel certificate scales
  L.smem = kSlots * L.in_bytes + 2 * L.out_bytes + (kBf16 ? 2 * up(4 * C, 16) : 0);
  return L;
}

struct Args {
  const void* x;
  void* out;
  int H, W, C, div, ph, pw, area;
  int kc, chunks, band, bands, units;
  int vec_in, bulk;
  float inv_area;
  float cert;  // bf16: (36 k-steps + area + 8) 2^-24 (1 + 2^-12) / area, the certificate's scale
  Layout L;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}


// Bulk store of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// shared to device memory, in this thread's bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
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

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a * b for one m16n8k16 tile: a row-major bf16, b column-major, d float32.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}


// Issue the copies of stage (unit u, chunk ch) into `slot`: pixels n0 .. n0 +
// nn of the unit's patch, each pixel's C channels one row of the slot.  bf16
// zeroes the rows up to the next multiple of 16, which the k-steps read.
template <typename T>
__device__ void load_stage(const Args& a, int u, int ch, T* slot) {
  const int np = a.div * a.div;
  const int item = u / a.bands;
  const int b = item / np, p = item % np;
  const int r0 = (p / a.div) * a.ph, c0 = (p % a.div) * a.pw;
  const int n0 = ch * a.kc;
  const int nn = min(a.kc, a.area - n0);
  const int C = a.C, ld = a.L.ld;
  const T* xb = static_cast<const T*>(a.x) + (size_t)b * a.H * a.W * C;
  if (a.vec_in) {
    const int q16 = C * (int)sizeof(T) / 16;  // 16-byte pieces of a pixel
    for (int e = threadIdx.x; e < nn * q16; e += kThreads) {
      const int n = e / q16, q = e - n * q16;
      const int pn = n0 + n;
      const int row = min(r0 + pn / a.pw, a.H - 1);
      const int col = min(c0 + pn % a.pw, a.W - 1);
      cp_async16(reinterpret_cast<char*>(slot + (size_t)n * ld) + 16 * q,
                 reinterpret_cast<const char*>(xb + ((size_t)row * a.W + col) * C) + 16 * q);
    }
  } else {
    for (int e = threadIdx.x; e < nn * C; e += kThreads) {
      const int n = e / C, c = e - n * C;
      const int pn = n0 + n;
      const int row = min(r0 + pn / a.pw, a.H - 1);
      const int col = min(c0 + pn % a.pw, a.W - 1);
      slot[(size_t)n * ld + c] = xb[((size_t)row * a.W + col) * C + c];
    }
  }
  if (sizeof(T) == 2) {
    const int rows = up(nn, 16) - nn;
    for (int e = threadIdx.x; e < rows * ld; e += kThreads)
      slot[(size_t)nn * ld + e] = T(0.f);
  }
  cp_async_commit();
}

// Sequential float32 FMAs in pixel order over the whole patch, as the plain
// version sums: from the staged slot when the patch is one stage, else
// from device memory.
__device__ float gram_seq(const Args& a, int u, const bf16* slot, int i, int j) {
  float s = 0.f;
  if (a.chunks == 1) {
    const int ld = a.L.ld;
    int n = 0;
    for (; n + 8 <= a.area; n += 8) {  // eight pixels' operands loaded ahead of their FMAs
      float x[8], y[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        x[q] = __bfloat162float(slot[(size_t)(n + q) * ld + i]);
        y[q] = __bfloat162float(slot[(size_t)(n + q) * ld + j]);
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) s = fmaf(x[q], y[q], s);
    }
    for (; n < a.area; ++n)
      s = fmaf(__bfloat162float(slot[(size_t)n * ld + i]), __bfloat162float(slot[(size_t)n * ld + j]), s);
    return s;
  }
  const int np = a.div * a.div;
  const int item = u / a.bands;
  const int b = item / np, p = item % np;
  const int r0 = (p / a.div) * a.ph, c0 = (p % a.div) * a.pw;
  const bf16* xb = static_cast<const bf16*>(a.x) + (size_t)b * a.H * a.W * a.C;
  for (int n = 0; n < a.area; ++n) {
    const int row = min(r0 + n / a.pw, a.H - 1);
    const int col = min(c0 + n % a.pw, a.W - 1);
    const bf16* px = xb + ((size_t)row * a.W + col) * a.C;
    s = fmaf(__bfloat162float(px[i]), __bfloat162float(px[j]), s);
  }
  return s;
}

// Row-major tile q of the upper triangle of an n x n grid of tiles, as (i, j), j >= i.
__device__ __forceinline__ void upper_tile(int q, int n, int& i, int& j) {
  int r = 0;
  while (q >= n - r) q -= n - r++;
  i = r;
  j = r + q;
}

// The four 8x8 bf16 matrices of a 16x16 tile in shared memory (row pitch
// `pitch` elements, rows 16-byte aligned): lane l gives the address of row
// l & 7 of matrix l >> 3; with .trans each matrix is stored transposed.
__device__ __forceinline__ void stmatrix_x4(void* p, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   smem_u32(p)),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}
__device__ __forceinline__ void stmatrix_x4_trans(void* p, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   smem_u32(p)),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 3 : 2) patch_gram_kernel(const Args a) {
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  char* obase = base + kSlots * a.L.in_bytes;  // the two output buffers
  float* dsum = reinterpret_cast<float*>(obase + 2 * a.L.out_bytes);
  float* kk = dsum + up(a.C, 4);  // bf16: sqrt(dsum * cert) per channel
  const int C = a.C, ld = a.L.ld;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool mirror = a.bands == 1;  // tiles on and above the diagonal, written twice
  const int first = blockIdx.x;
  if (first >= a.units) return;
  const int my_units = (a.units - 1 - first) / gridDim.x + 1;
  const int stages = my_units * a.chunks;

  // the padding columns [C, ld) of every slot stay zero
  for (int e = threadIdx.x; e < kSlots * a.kc * (ld - C); e += kThreads) {
    const int n = e / (ld - C), c = C + e % (ld - C);
    reinterpret_cast<T*>(base)[(size_t)n * ld + c] = T(0.f);  // the slots are adjacent
  }

  // float32: this thread's 6x6 tile, found once.  With one band, tile q is
  // on diagonal d = tj - ti, diagonal after diagonal: a warp's lanes then
  // hold distinct ti and tj, so their direct and mirrored writes and their
  // operand reads fall on distinct banks.
  int ti = -1, tj = -1;
  if constexpr (!kBf16) {
    const int n = (C + kT - 1) / kT;
    int q = threadIdx.x;
    if (q < a.L.n_tiles) {
      if (mirror) {
        int d = 0;
        while (q >= n - d) q -= n - d++;
        ti = q;
        tj = q + d;
      } else {
        ti = q / n;
        tj = q % n;
      }
    }
  }

  // bf16: this warp's 16x16 tiles (row group tm, column group tn; tm < 0
  // past the last), found once
  const int cg = up(C, 16) / 16;
  int tm[kWarpTiles], tn[kWarpTiles];
#pragma unroll
  for (int k = 0; k < kWarpTiles; ++k) {
    const int t = warp + k * kWarps;
    tm[k] = -1;
    tn[k] = 0;
    if (kBf16 && t < a.L.n_tiles) {
      if (mirror) {
        upper_tile(t, cg, tm[k], tn[k]);
      } else {
        tm[k] = t / cg;
        tn[k] = t % cg;
      }
    }
  }

  float acc[kBf16 ? kWarpTiles * 8 : kT * kT];
#pragma unroll
  for (int e = 0; e < (kBf16 ? kWarpTiles * 8 : kT * kT); ++e) acc[e] = 0.f;

  // stage q goes to slot q % kSlots, issued kSlots - 1 stages ahead (a
  // group a stage, empty past the last, so that the count of groups in
  // flight stays the same)
  for (int q = 0; q + 1 < kSlots; ++q) {
    if (q < stages)
      load_stage<T>(a, first + (q / a.chunks) * gridDim.x, q % a.chunks,
                    reinterpret_cast<T*>(base + q * a.L.in_bytes));
    else
      cp_async_commit();
  }
  for (int s = 0; s < stages; ++s) {
    const int ui = s / a.chunks, ch = s - ui * a.chunks;
    const int u = first + ui * gridDim.x;
    const int band0 = (u % a.bands) * a.band;
    const int rows = min(a.band, C - band0);
    const int sn = s + kSlots - 1;
    if (sn < stages)
      load_stage<T>(a, first + (sn / a.chunks) * gridDim.x, sn % a.chunks,
                    reinterpret_cast<T*>(base + (sn % kSlots) * a.L.in_bytes));
    else
      cp_async_commit();
    cp_async_wait<kSlots - 1>();
    __syncthreads();  // stage s is in its slot
    const T* slot = reinterpret_cast<const T*>(base + (s % kSlots) * a.L.in_bytes);
    const int nn = min(a.kc, a.area - ch * a.kc);
    const bool last = ch + 1 == a.chunks;

    if constexpr (kBf16) {
      if (!mirror) {
        // per-channel sums of squares, sequential, for the certificate (with
        // one band the diagonal tiles give them)
        for (int c = threadIdx.x; c < C; c += kThreads) {
          float d = ch == 0 ? 0.f : dsum[c];
          for (int n = 0; n < nn; ++n) {
            const float v = __bfloat162float(slot[(size_t)n * ld + c]);
            d = fmaf(v, v, d);
          }
          dsum[c] = d;
          if (last) kk[c] = sqrtf(d * a.cert);
        }
      }
      const int ksteps = up(nn, 16) / 16;
      const int lrow = (lane & 7) + ((lane >> 4) << 3);
      const int lcol = ((lane >> 3) & 1) * 8;
      for (int ks = 0; ks < ksteps; ++ks) {  // the warp's tiles side by side in each k-step
        const T* rowp = slot + (size_t)(ks * 16 + lrow) * ld + lcol;
#pragma unroll
        for (int k = 0; k < kWarpTiles; ++k) {
          const int m0 = band0 + tm[k] * 16;
          if (tm[k] >= 0 && m0 < C) {
            uint32_t fa[4], fb[4];
            ldmatrix_x4_trans(fa, rowp + m0);
            ldmatrix_x4_trans(fb, rowp + tn[k] * 16);
            mma_bf16(&acc[k * 8], fa, fb[0], fb[2]);
            mma_bf16(&acc[k * 8 + 4], fa, fb[1], fb[3]);
          }
        }
      }
      if (mirror && last) {
        // the diagonal's sums of squares (the tensor cores' own, within
        // 2^-12 of the exact ones, which cert covers) for the certificate
        const int g = lane >> 2, tq = lane & 3;
#pragma unroll
        for (int k = 0; k < kWarpTiles; ++k)
          if (tm[k] >= 0 && tm[k] == tn[k]) {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int i = tm[k] * 16 + g + 8 * ((e >> 1) & 1);
              if (i == tn[k] * 16 + 8 * (e >> 2) + 2 * tq + (e & 1) && i < C)
                kk[i] = sqrtf(fmaxf(acc[k * 8 + e], 0.f) * a.cert);
            }
          }
      }
    } else if (ti >= 0) {
      const int ii = (mirror ? 0 : band0) + ti * kT, jj = tj * kT;
      for (int n = 0; n < nn; ++n) {
        const T* sr = slot + (size_t)n * ld;
        float av[kT], bv[kT];
#pragma unroll
        for (int t = 0; t < kT; t += 2) {
          const float2 p = *reinterpret_cast<const float2*>(sr + ii + t);
          const float2 q = *reinterpret_cast<const float2*>(sr + jj + t);
          av[t] = p.x;
          av[t + 1] = p.y;
          bv[t] = q.x;
          bv[t + 1] = q.y;
        }
#pragma unroll
        for (int x = 0; x < kT; ++x)
#pragma unroll
          for (int y = 0; y < kT; ++y) acc[x * kT + y] = fmaf(av[x], bv[y], acc[x * kT + y]);
      }
    }

    if (ch + 1 == a.chunks) {
      // epilogue: the unit's band goes to output buffer ui & 1 and out
      char* ob = obase + (ui & 1) * a.L.out_bytes;
      if (threadIdx.x == 0) bulk_wait_read<1>();  // the store two units back has read it
      __syncthreads();
      if constexpr (kBf16) {
        bf16* o = reinterpret_cast<bf16*>(ob);
        const int g = lane >> 2, tq = lane & 3;
        uint32_t redo = 0;  // outputs whose certificate failed, bit k * 8 + e
#pragma unroll
        for (int k = 0; k < kWarpTiles; ++k) {
          const int mi = tm[k], nj = tn[k];
          const int m0 = band0 + mi * 16, n0 = nj * 16;
          if (mi >= 0 && m0 < C) {
            float v[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = acc[k * 8 + e] * a.inv_area;
            // two neighbouring outputs at a time: both ends of each interval,
            // rounded to bf16; an end that rounds otherwise flags its output
#pragma unroll
            for (int e = 0; e < 8; e += 2) {
              const int i = m0 + g + 8 * ((e >> 1) & 1);
              const int j = n0 + 8 * (e >> 2) + 2 * tq;
              if (i < C && j < C) {
                const float ki = kk[i];
                const float2 kj = *reinterpret_cast<const float2*>(kk + j);
                const float r0 = ki * kj.x, r1 = ki * kj.y;
                const uint32_t d = pack_bf16x2(v[e] - r0, v[e + 1] - r1) ^
                                   pack_bf16x2(v[e] + r0, v[e + 1] + r1);
                if (d & 0xffffu) redo |= 1u << (k * 8 + e);
                if ((d >> 16) && j + 1 < C) redo |= 1u << (k * 8 + e + 1);
              }
            }
            if (C % 8 == 0 && m0 + 16 <= C && n0 + 16 <= C) {
              // whole tile: stmatrix, and its transpose for the mirror tile
              const uint32_t f[4] = {pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                                     pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7])};
              const int q = lane >> 3, r = lane & 7;
              stmatrix_x4(o + (size_t)(m0 - band0 + (q & 1) * 8 + r) * C + n0 + (q >> 1) * 8, f);
              if (mirror && mi != nj)
                stmatrix_x4_trans(o + (size_t)(n0 + (q >> 1) * 8 + r) * C + m0 + (q & 1) * 8, f);
            } else {
#pragma unroll
              for (int e = 0; e < 8; ++e) {
                const int i = m0 + g + 8 * ((e >> 1) & 1);
                const int j = n0 + 8 * (e >> 2) + 2 * tq + (e & 1);
                if (i < C && j < C) {
                  o[(size_t)(i - band0) * C + j] = __float2bfloat16_rn(v[e]);
                  if (mirror && mi != nj) o[(size_t)j * C + i] = __float2bfloat16_rn(v[e]);
                }
              }
            }
          }
        }
        // rare: the sequential sum in place of the tensor cores' one, the
        // warp's flagged outputs spread evenly over its lanes
        int cnt = __popc(redo), pre = cnt;
#pragma unroll
        for (int o2 = 1; o2 < 32; o2 <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, pre, o2);
          if (lane >= o2) pre += v;
        }
        const int total = __shfl_sync(0xffffffffu, pre, 31);
        const int excl = pre - cnt;
        __syncwarp();  // the stmatrix stores come first
        for (int b0 = 0; b0 < total; b0 += 32) {
          const int idx = min(b0 + lane, total - 1);
          int owner = 0;
#pragma unroll
          for (int step = 16; step > 0; step >>= 1)
            if (__shfl_sync(0xffffffffu, excl, owner + step) <= idx) owner += step;
          uint32_t m = __shfl_sync(0xffffffffu, redo, owner);
          const int nth = idx - __shfl_sync(0xffffffffu, excl, owner);
          if (b0 + lane < total) {
            for (int q = 0; q < nth; ++q) m &= m - 1;
            const int bit = __ffs(m) - 1;
            const int k = bit >> 3, e = bit & 7;
            int mi = 0, nj = 0;
#pragma unroll
            for (int q = 0; q < kWarpTiles; ++q)  // the warp's tile k, in registers
              if (q == k) {
                mi = tm[q];
                nj = tn[q];
              }
            const int i = band0 + mi * 16 + (owner >> 2) + 8 * ((e >> 1) & 1);
            const int j = nj * 16 + 8 * (e >> 2) + 2 * (owner & 3) + (e & 1);
            const bf16 v = __float2bfloat16_rn(gram_seq(a, u, slot, i, j) * a.inv_area);
            o[(size_t)(i - band0) * C + j] = v;
            if (mirror && mi != nj) o[(size_t)j * C + i] = v;
          }
        }
#pragma unroll
        for (int e = 0; e < kWarpTiles * 8; ++e) acc[e] = 0.f;
      } else if (ti >= 0) {
        float* o = reinterpret_cast<float*>(ob);
        const int ii = (mirror ? 0 : band0) + ti * kT, jj = tj * kT;
#pragma unroll
        for (int x = 0; x < kT; ++x)
#pragma unroll
          for (int y = 0; y < kT; ++y) {
            const int i = ii + x, j = jj + y;
            const float v = acc[x * kT + y] * a.inv_area;
            acc[x * kT + y] = 0.f;
            if (i < C && j < C) {
              o[(size_t)(i - band0) * C + j] = v;
              if (mirror && ti != tj) o[(size_t)j * C + i] = v;  // the mirror tile
            }
          }
      }
      T* dst = static_cast<T*>(a.out) + ((size_t)(u / a.bands) * C + band0) * C;
      const int n_out = rows * C;
      if (a.bulk) {
        fence_async_shared();
        __syncthreads();
        if (threadIdx.x == 0) bulk_store(dst, ob, n_out * (int)sizeof(T));
      } else {
        __syncthreads();
        const T* src = reinterpret_cast<const T*>(ob);
        for (int e = threadIdx.x; e < n_out; e += kThreads) dst[e] = src[e];
      }
    }
    __syncthreads();  // slot s % kSlots is free for stage s + kSlots
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <typename T>
int launch(const void* x, void* out, int B, int H, int W, int C, int div, int kc, int band,
           int grid, void* stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || div <= 0 || kc <= 0 || kc % 16 != 0 ||
      band <= 0 || grid <= 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.out = out;
  a.H = H; a.W = W; a.C = C; a.div = div;
  a.ph = (H + div - 1) / div;
  a.pw = (W + div - 1) / div;
  a.area = a.ph * a.pw;
  a.kc = kc;
  a.chunks = (a.area + kc - 1) / kc;
  a.band = band >= C ? C : band;
  a.bands = (C + a.band - 1) / a.band;
  if (a.bands > 1 && (kBf16 ? a.band % 16 : a.band % kT) != 0) return (int)cudaErrorInvalidValue;
  const long long units = (long long)B * div * div * a.bands;
  if (units >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  a.units = (int)units;
  a.L = layout<kBf16>(C, kc, a.band);
  if (a.L.smem > kSmemMax || a.L.n_tiles > (kBf16 ? kWarps * kWarpTiles : kThreads))
    return (int)cudaErrorInvalidValue;
  const int esize = (int)sizeof(T);
  a.vec_in = (C * esize) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.bulk = (a.band * C * esize) % 16 == 0 && (C * C * esize) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(out) % 16 == 0;
  a.inv_area = 1.0f / (float)a.area;
  const int ksteps = (a.area + 15) / 16;
  a.cert = (float)(36 * ksteps + a.area + 8) * 0x1p-24f * (1.0f + 0x1p-12f) * a.inv_area;
  cudaError_t err = cudaFuncSetAttribute(patch_gram_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, a.L.smem);
  if (err != cudaSuccess) return (int)err;
  patch_gram_kernel<T><<<grid, kThreads, a.L.smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// x: float32 [B, H, W, C] contiguous; out: float32 [B, div*div, C*C].  kc
// (pixels a stage, a multiple of 16), band (output rows a unit) and grid
// come from ops/cuda_kernels.patch_gram_plan.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a plan the kernel does not take.
extern "C" int wadt_patch_gram_f32(const void* x, void* out, int B, int H, int W, int C, int div,
                                   int kc, int band, int grid, void* stream) {
  return launch<float>(x, out, B, H, W, C, div, kc, band, grid, stream);
}

// x: bf16 [B, H, W, C] contiguous; out: bf16 [B, div*div, C*C].
extern "C" int wadt_patch_gram_bf16(const void* x, void* out, int B, int H, int W, int C, int div,
                                    int kc, int band, int grid, void* stream) {
  return launch<bf16>(x, out, B, H, W, C, div, kc, band, grid, stream);
}
