// Fused PMG trunk + per-patch Gram for Hopper (sm_90a): the camera path's
// first kernel, raw uint8 frame -> Gram tokens, one thread block cluster per
// patch.
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
// nearest even, where the TPU kernel casts.  conv1 uses only the (0, 0)
// block [k1*k1*cin, c0] of the fold's block-diagonal W0bd, which the fold
// repeats on the diagonal, so its 15/16 zeros are never multiplied.
//
// What bounds it: at the camera path's shape (B = 1, 224 px, shipped widths
// cin 3, c0 32, c1 64, c2 128, gc 96) it moves 0.15 MB of frame, 0.11 MB of
// weights and 0.33 MB of output, 0.18 us at 3.35 TB/s, and does 19.6 M
// multiply-adds a frame, not a patch: the trunk 17.5 M over the 225 final
// pixels that nine 5 x 5 patches cover (0.04 us on the tensor cores), the
// Gram 2.1 M (0.06 us on the CUDA cores at 67 TFLOP/s).
// Neither bound is reachable at B = 1: the latency of a chain of four
// dependent GEMMs, the weight loads before them and the Gram after them
// sets the time.
//
// What the design does about it:
//  - One cluster of up to 8 blocks per (image, patch)
//    (ops/cuda_kernels.trunk_gram_plan): the fewest blocks that give each
//    the fewest pixels, 7 blocks of 3-4 pixels at the shipped shape, 63 SMs
//    at B = 1 instead of 9.  A block owns a contiguous share of the patch's
//    pixels in row-major order; a replicate-padded pixel is recomputed by
//    its owner.
//  - One packed weight buffer a fold (built once and cached by the
//    wrapper): conv1's dense block, W2, W3 and Wcp, each in this kernel's
//    shared-memory layout (widths padded to 16 with zeros, rows 8 elements
//    wider so that ldmatrix hits distinct banks), each followed by its
//    float32 bias.  At entry one thread issues one bulk copy per GEMM on its
//    own mbarrier, so W2's 74 KB arrive while the frame is read and conv1
//    runs.
//  - The frame is read with 16-byte loads (a final pixel's input row is
//    K*cin = 48 contiguous bytes) and converted to bf16 once, which is exact
//    for uint8.
//  - The four GEMMs on mma.sync m16n8k16 bf16 -> float32, A through ldmatrix
//    and B through ldmatrix.trans; the epilogues (bias, LeakyReLU, one bf16
//    rounding) run in registers and write the next GEMM's A as bf16 in
//    shared memory.
//  - z stays float32: each block pushes its z rows into every block of its
//    cluster (mapa + st.shared::cluster), then one cluster barrier.  Each
//    block computes its share of the Gram's rows over all the patch's pixels
//    in pixel order on the CUDA cores, scales by 1/area and writes them.
// No atomics: every sum has a fixed order, so two runs give the same bits.
// Not done yet: the weight buffer is read by every block of a cluster
// instead of multicast across it, conv2's 32 k-steps run as one chain a
// tile, and each frame is one launch (a CUDA graph of the camera step would
// hide the launch).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
constexpr int kSmemMax = 227 * 1024;

__host__ __device__ __forceinline__ int up(int n, int m) { return (n + m - 1) / m * m; }

// Everything the kernel derives from the widths, the frame and the cluster
// size; ops/cuda_kernels.trunk_gram_plan computes the same numbers.
struct Shape {
  int H, W, cin, k1, k2, K, Hf, Wf, div, ph, pw, area, cells;
  int kd0, kd0p, c0p, c1p, c2p, gc, gcp;  // GEMM widths, padded to 16
  int cluster, mpix;                      // blocks a patch, most pixels a block
  int m1, m2;                             // rows of conv1's and of the later GEMMs' A
  int seg[5];  // packed buffer: GEMM s's weight then bias at bytes [seg[s], seg[s+1])
  int o_xa, o_aa, o_bb, o_cc, o_zz, o_bar, o_map, smem;  // shared-memory byte offsets
  int vec_x;   // 16-byte frame loads
  float inv_area;
};

__host__ __device__ inline Shape make_shape(int H, int W, int cin, int k1, int k2, int c0, int c1,
                                            int c2, int gc, int div, int cluster) {
  Shape s;
  s.H = H; s.W = W; s.cin = cin; s.k1 = k1; s.k2 = k2; s.K = k1 * k2; s.div = div;
  s.Hf = H / s.K; s.Wf = W / s.K;
  s.ph = (s.Hf + div - 1) / div; s.pw = (s.Wf + div - 1) / div;
  s.area = s.ph * s.pw;
  s.cells = k2 * k2;
  s.kd0 = k1 * k1 * cin; s.kd0p = up(s.kd0, 16);
  s.c0p = up(c0, 16); s.c1p = up(c1, 16); s.c2p = up(c2, 16);
  s.gc = gc; s.gcp = up(gc, 16);
  s.cluster = cluster;
  s.mpix = (s.area + cluster - 1) / cluster;
  s.m1 = up(s.mpix * s.cells, 16);
  s.m2 = up(s.mpix, 16);
  const int rows[4] = {s.kd0p, s.cells * s.c0p, s.c1p, s.c2p};
  const int cols[4] = {s.c0p, s.c1p, s.c2p, s.gcp};
  s.seg[0] = 0;
  for (int g = 0; g < 4; ++g) s.seg[g + 1] = s.seg[g] + rows[g] * (cols[g] + 8) * 2 + cols[g] * 4;
  s.o_xa = s.seg[4];
  s.o_aa = s.o_xa + s.m1 * (s.kd0p + 8) * 2;
  s.o_bb = s.o_aa + s.m2 * (s.cells * s.c0p + 8) * 2;
  s.o_cc = s.o_bb + s.m2 * (s.c1p + 8) * 2;
  s.o_zz = s.o_cc + s.m2 * (s.c2p + 8) * 2;
  s.o_bar = s.o_zz + s.area * s.gcp * 4;
  s.o_map = s.o_bar + 4 * 8;
  s.smem = s.o_map + up(s.K * cin * 4, 16);
  s.inv_area = 1.0f / (float)s.area;
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
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

__device__ __forceinline__ uint32_t map_rank(uint32_t local, int q) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(q));
  return remote;
}

// float32 -> bfloat16 bits, round to nearest even (finite inputs).
__device__ __forceinline__ uint32_t bf16_bits(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : 0.2f * v; }

// A[mtiles*16, ksteps*16] @ W[ksteps*16, ntiles16*16] on the tensor cores:
// A bf16 row-major (pitch lda elements), W bf16 row-major (pitch ldw).  A
// warp takes one 16 x 16 output tile at a time over the whole depth, and
// hands each row's column pair to epi(row, col, v0, v1).
template <typename Epi>
__device__ __forceinline__ void gemm(const uint16_t* A, int lda, int mtiles, const uint16_t* Wt,
                                     int ldw, int ksteps, int ntiles16, Epi epi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  for (int tile = warp; tile < mtiles * ntiles16; tile += kWarps) {
    const int m0 = (tile / ntiles16) * 16, n0 = (tile % ntiles16) * 16;
    const uint16_t* ap = A + (size_t)(m0 + (lane & 15)) * lda + (lane >> 4) * 8;
    const uint16_t* bp = Wt + (size_t)((lane & 7) + ((lane >> 3) & 1) * 8) * ldw + n0 + (lane >> 4) * 8;
    float c[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t a[4], b[4];
      ldmatrix_x4(a, ap + ks * 16);
      ldmatrix_x4_trans(b, bp + (size_t)ks * 16 * ldw);
      mma_bf16(c, a, b[0], b[1]);
      mma_bf16(c + 4, a, b[2], b[3]);
    }
    epi(m0 + g, n0 + 2 * t, c[0], c[1]);
    epi(m0 + g + 8, n0 + 2 * t, c[2], c[3]);
    epi(m0 + g, n0 + 8 + 2 * t, c[4], c[5]);
    epi(m0 + g + 8, n0 + 8 + 2 * t, c[6], c[7]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
trunk_gram_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ wbuf,
                  float* __restrict__ out, const Shape s) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const uint16_t* w0 = reinterpret_cast<const uint16_t*>(smem + s.seg[0]);
  const uint16_t* w2 = reinterpret_cast<const uint16_t*>(smem + s.seg[1]);
  const uint16_t* w3 = reinterpret_cast<const uint16_t*>(smem + s.seg[2]);
  const uint16_t* wcp = reinterpret_cast<const uint16_t*>(smem + s.seg[3]);
  const float* b0 = reinterpret_cast<const float*>(w0 + s.kd0p * (s.c0p + 8));
  const float* b2 = reinterpret_cast<const float*>(w2 + s.cells * s.c0p * (s.c1p + 8));
  const float* b3 = reinterpret_cast<const float*>(w3 + s.c1p * (s.c2p + 8));
  const float* bcp = reinterpret_cast<const float*>(wcp + s.c2p * (s.gcp + 8));
  uint16_t* xa = reinterpret_cast<uint16_t*>(smem + s.o_xa);  // conv1's A [m1][kd0p + 8]
  uint16_t* aa = reinterpret_cast<uint16_t*>(smem + s.o_aa);  // conv2's A [m2][cells*c0p + 8]
  uint16_t* bb = reinterpret_cast<uint16_t*>(smem + s.o_bb);  // [m2][c1p + 8]
  uint16_t* cc = reinterpret_cast<uint16_t*>(smem + s.o_cc);  // [m2][c2p + 8]
  float* zz = reinterpret_cast<float*>(smem + s.o_zz);        // the patch's z [area][gcp]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + s.o_bar);
  int* colmap = reinterpret_cast<int*>(smem + s.o_map);

  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  const int np = s.div * s.div;
  const int item = blockIdx.x / s.cluster;
  const int b = item / np, p = item % np;
  const int pr = p / s.div, pc = p % s.div;
  const int p0 = (int)rank * s.area / s.cluster;       // this block's pixels [p0, p1)
  const int p1 = ((int)rank + 1) * s.area / s.cluster;
  const int npx = p1 - p0;
  const int lda0 = s.kd0p + 8, lda2 = s.cells * s.c0p + 8;

  // every block of the cluster has started before any remote write (the
  // matching wait comes just before z is pushed)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  if (threadIdx.x == 0) {
    for (int g = 0; g < 4; ++g) mbar_init(&bars[g], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int g = 0; g < 4; ++g) {
      const uint32_t bytes = (uint32_t)(s.seg[g + 1] - s.seg[g]);
      mbar_expect_tx(&bars[g], bytes);
      bulk_copy(smem + s.seg[g], wbuf + s.seg[g], bytes, &bars[g]);
    }
  }

  // the frame: a final pixel's input row Y is K*cin contiguous bytes; byte
  // col of it is sub-cell column v = colmap >> 16, conv1 column (dx, ci) =
  // colmap & 0xffff (dy added per row)
  const int rowb = s.K * s.cin;
  for (int col = threadIdx.x; col < rowb; col += kThreads) {
    const int X = col / s.cin, ci = col - X * s.cin;
    colmap[col] = ((X / s.k1) << 16) | ((X % s.k1) * s.cin + ci);
  }
  // conv1's padding columns [kd0, kd0p) are zero
  for (int e = threadIdx.x; e < npx * s.cells * (s.kd0p - s.kd0); e += kThreads) {
    const int r = e / (s.kd0p - s.kd0);
    xa[(size_t)r * lda0 + s.kd0 + (e - r * (s.kd0p - s.kd0))] = 0;
  }
  __syncthreads();
  const uint8_t* xb = x + (size_t)b * s.H * s.W * s.cin;
  if (s.vec_x) {
    const int q16 = rowb / 16;
    for (int e = threadIdx.x; e < npx * s.K * q16; e += kThreads) {
      const int q = e / (s.K * q16);
      const int rem = e - q * s.K * q16;
      const int Y = rem / q16, j = rem - Y * q16;
      const int P = p0 + q, py = P / s.pw;
      const int fy = min(pr * s.ph + py, s.Hf - 1), fx = min(pc * s.pw + (P - py * s.pw), s.Wf - 1);
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(
                                xb + ((size_t)(fy * s.K + Y) * s.W + fx * s.K) * s.cin) + j);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      uint16_t* dst = xa + (size_t)(q * s.cells + (Y / s.k1) * s.k2) * lda0 + (Y % s.k1) * s.k1 * s.cin;
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const int m = colmap[16 * j + t];
        const uint32_t byte = (w[t >> 2] >> (8 * (t & 3))) & 0xffu;
        dst[(size_t)(m >> 16) * lda0 + (m & 0xffff)] = (uint16_t)bf16_bits((float)byte);
      }
    }
  } else {
    for (int e = threadIdx.x; e < npx * s.K * rowb; e += kThreads) {
      const int q = e / (s.K * rowb);
      const int rem = e - q * s.K * rowb;
      const int Y = rem / rowb, col = rem - Y * rowb;
      const int P = p0 + q, py = P / s.pw;
      const int fy = min(pr * s.ph + py, s.Hf - 1), fx = min(pc * s.pw + (P - py * s.pw), s.Wf - 1);
      const uint8_t byte = xb[((size_t)(fy * s.K + Y) * s.W + fx * s.K) * s.cin + col];
      const int m = colmap[col];
      xa[(size_t)(q * s.cells + (Y / s.k1) * s.k2 + (m >> 16)) * lda0 + (Y % s.k1) * s.k1 * s.cin +
         (m & 0xffff)] = (uint16_t)bf16_bits((float)byte);
    }
  }
  __syncthreads();

  // conv1: row q*cells + cell of xa -> a[q][cell*c0p + co]
  mbar_wait(&bars[0], 0);
  gemm(xa, lda0, s.m1 / 16, w0, s.c0p + 8, s.kd0p / 16, s.c0p / 16,
       [&](int m, int n, float v0, float v1) {
         if (m < npx * s.cells) {
           const int q = m / s.cells, cell = m - q * s.cells;
           const uint32_t h = bf16_bits(lrelu(v0 + b0[n])) | (bf16_bits(lrelu(v1 + b0[n + 1])) << 16);
           *reinterpret_cast<uint32_t*>(aa + (size_t)q * lda2 + cell * s.c0p + n) = h;
         }
       });
  __syncthreads();
  // conv2
  mbar_wait(&bars[1], 0);
  gemm(aa, lda2, s.m2 / 16, w2, s.c1p + 8, s.cells * s.c0p / 16, s.c1p / 16,
       [&](int m, int n, float v0, float v1) {
         if (m < npx) {
           const uint32_t h = bf16_bits(lrelu(v0 + b2[n])) | (bf16_bits(lrelu(v1 + b2[n + 1])) << 16);
           *reinterpret_cast<uint32_t*>(bb + (size_t)m * (s.c1p + 8) + n) = h;
         }
       });
  __syncthreads();
  // the 1x1 conv
  mbar_wait(&bars[2], 0);
  gemm(bb, s.c1p + 8, s.m2 / 16, w3, s.c2p + 8, s.c1p / 16, s.c2p / 16,
       [&](int m, int n, float v0, float v1) {
         if (m < npx) {
           const uint32_t h = bf16_bits(lrelu(v0 + b3[n])) | (bf16_bits(lrelu(v1 + b3[n + 1])) << 16);
           *reinterpret_cast<uint32_t*>(cc + (size_t)m * (s.c2p + 8) + n) = h;
         }
       });
  __syncthreads();
  // chan_proj: z rows pushed into every block's copy of the patch's z
  mbar_wait(&bars[3], 0);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  gemm(cc, s.c2p + 8, s.m2 / 16, wcp, s.gcp + 8, s.c2p / 16, s.gcp / 16,
       [&](int m, int n, float v0, float v1) {
         if (m < npx) {
           const uint32_t a = smem_u32(zz + (size_t)(p0 + m) * s.gcp + n);
           const float z0 = v0 + bcp[n], z1 = v1 + bcp[n + 1];
           for (int q = 0; q < s.cluster; ++q)
             asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(map_rank(a, q)),
                          "f"(z0), "f"(z1)
                          : "memory");
         }
       });
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");

  // this block's rows [g0, g1) of the patch's Gram, pixels in order
  const int g0 = (int)rank * s.gc / s.cluster, g1 = ((int)rank + 1) * s.gc / s.cluster;
  const int nj = (s.gc + 3) / 4;
  float* ob = out + (size_t)item * s.gc * s.gc;
  const bool vec_out = s.gc % 4 == 0;
  for (int e = threadIdx.x; e < (g1 - g0) * nj; e += kThreads) {
    const int i = g0 + e / nj, j = (e % nj) * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int n = 0; n < s.area; ++n) {
      const float zi = zz[(size_t)n * s.gcp + i];
      const float4 zj = *reinterpret_cast<const float4*>(zz + (size_t)n * s.gcp + j);
      acc.x = fmaf(zi, zj.x, acc.x);
      acc.y = fmaf(zi, zj.y, acc.y);
      acc.z = fmaf(zi, zj.z, acc.z);
      acc.w = fmaf(zi, zj.w, acc.w);
    }
    const float4 v = make_float4(acc.x * s.inv_area, acc.y * s.inv_area, acc.z * s.inv_area,
                                 acc.w * s.inv_area);
    float* o = ob + (size_t)i * s.gc + j;
    if (vec_out) {
      *reinterpret_cast<float4*>(o) = v;
    } else {
      const float vv[4] = {v.x, v.y, v.z, v.w};
      for (int t = 0; t < 4 && j + t < s.gc; ++t) o[t] = vv[t];
    }
  }
}

}  // namespace

// x: uint8 [B, H, W, cin]; wbuf: the packed weight buffer of
// ops/cuda_kernels.pack_trunk_gram_weights (16-byte aligned); out: float32
// [B, div*div, gc*gc]; cluster: blocks a patch (trunk_gram_plan, at most 8).
// Rows and columns beyond a multiple of K are ignored.  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for sizes it does not take.
extern "C" int wadt_trunk_gram_u8(const void* x, const void* wbuf, void* out, int B, int H, int W,
                                  int cin, int k1, int k2, int c0, int c1, int c2, int gc, int div,
                                  int cluster, void* stream) {
  if (B <= 0 || cin <= 0 || k1 <= 0 || k2 <= 0 || c0 <= 0 || c1 <= 0 || c2 <= 0 || gc <= 0 ||
      div <= 0 || cluster <= 0 || cluster > kMaxCluster || H < k1 * k2 || W < k1 * k2 ||
      (long long)B * div * div * cluster >= (1LL << 31) ||
      reinterpret_cast<uintptr_t>(wbuf) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Shape s = make_shape(H, W, cin, k1, k2, c0, c1, c2, gc, div, cluster);
  if (cluster > s.area || s.smem > kSmemMax) return (int)cudaErrorInvalidValue;
  s.vec_x = (s.K * cin) % 16 == 0 && (W * cin) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(trunk_gram_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, s.smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * div * div * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = s.smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, trunk_gram_kernel, static_cast<const uint8_t*>(x),
                           static_cast<const uint8_t*>(wbuf), static_cast<float*>(out), s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
