// All-pairs t-SNE repulsion for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package lays out its embeddings with
// scikit-learn's TSNE on the host (workloads/embed.py, perform_tsne), whose
// default Barnes-Hut method approximates this sum with a quadtree.  The
// port computes the same objective with the repulsion summed exactly, on
// the card, once a descent iteration (utils/tsne.py, _kl_and_grad); this
// kernel is that sum.
//
// What it computes: y float32 [N, 2] -> rep float32 [N, 2], z float32 [N],
//   q_ij   = 1 / (1 + |y_i - y_j|^2),
//   rep_i  = sum_{j != i} q_ij^2 (y_i - y_j),
//   z_i    = sum_{j != i} q_ij,
// with j = i left out by index, so coincident points (duplicates) repel
// with q = 1 as the formula says.  The caller sums z in float64 for Z.
//
// What bounds it: operations.  N^2 pairs (4.29e9 at N = 65,536), each two
// subtractions, two FMAs for 1 + dx^2 + dy^2, one reciprocal, one add, one
// multiply and two FMAs: 12 float32 FLOPs (an FMA counted as two), 0.77 ms
// at 67 TFLOP/s, and one MUFU reciprocal, 16 a clock on an SM (CUDA C
// programming guide, throughput table, compute capability 9.0), 1.03 ms at
// 132 SMs x 1.98 GHz.  The larger, ~1.03 ms a launch at N = 65,536, is the
// bound.  Bytes are nothing: 1.3 MB in and out.
//
// What the design does about it (simple first):
//  - One thread a row i, its sums in registers; 128 threads a block, so
//    N = 65,536 is 512 blocks, ~4 an SM in one wave.
//  - The block stages the points j a tile of 128 at a time in shared
//    memory (the classic N-body kernel); every thread of a warp reads the
//    same point, a broadcast, two points a 16-byte load.
//  - Each pair is 8 float32 instructions and one `rcp.approx.ftz.f32`
//    (one MUFU op, relative error ~1 ulp; its input is >= 1, never
//    subnormal).
//  - j = i is left out by index only in the block's own tile (one tile in
//    N / 128); the tail tile of a ragged N runs a counted loop.
//  - Accuracy: a tile's 128 terms are summed in float32, and the tile sums
//    are added to the row's totals with Kahan compensation, so a row of
//    65,535 terms near 1 (the PCA init, where every q is ~1) keeps ~1e-6
//    relative of a float64 sum instead of drifting by ~1e-4.
//  - No atomics: each row has one owner, so the result is the same every
//    run.
// Not done: splitting the j range over several threads a row (more warps
// an SM at small N), or a reciprocal off the MUFU pipe.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;  // rows a block = points a tile

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void add_pair(float xi, float yi, float xj, float yj, float& z,
                                         float& rx, float& ry) {
  const float dx = xi - xj;
  const float dy = yi - yj;
  const float q = rcp_approx(fmaf(dx, dx, fmaf(dy, dy, 1.0f)));
  z += q;
  const float q2 = q * q;
  rx = fmaf(q2, dx, rx);
  ry = fmaf(q2, dy, ry);
}

// s += v with Kahan compensation c.
__device__ __forceinline__ void kahan_add(float& s, float& c, float v) {
  const float yv = v - c;
  const float t = s + yv;
  c = (t - s) - yv;
  s = t;
}

__global__ void __launch_bounds__(kThreads)
tsne_repulsion_kernel(const float2* __restrict__ y, float2* __restrict__ rep,
                      float* __restrict__ z_rows, int n) {
  __shared__ __align__(16) float2 tile[kThreads];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const float2 yi = i < n ? y[i] : make_float2(0.0f, 0.0f);
  float z = 0.0f, rx = 0.0f, ry = 0.0f;     // row totals
  float cz = 0.0f, cx = 0.0f, cy = 0.0f;    // their Kahan compensations
  const int tiles = (n + kThreads - 1) / kThreads;
  for (int t = 0; t < tiles; ++t) {
    const int j0 = t * kThreads;
    const int cnt = min(kThreads, n - j0);
    __syncthreads();  // the previous tile is read
    if (threadIdx.x < cnt) tile[threadIdx.x] = y[j0 + threadIdx.x];
    __syncthreads();
    float tz = 0.0f, tx = 0.0f, ty = 0.0f;
    if (t == (int)blockIdx.x || cnt < kThreads) {
      const int self = i - j0;  // this row's place in the tile, if it is there
      for (int j = 0; j < cnt; ++j) {
        if (j != self) add_pair(yi.x, yi.y, tile[j].x, tile[j].y, tz, tx, ty);
      }
    } else {
      const float4* t4 = reinterpret_cast<const float4*>(tile);
#pragma unroll 16
      for (int j = 0; j < kThreads / 2; ++j) {
        const float4 p = t4[j];
        add_pair(yi.x, yi.y, p.x, p.y, tz, tx, ty);
        add_pair(yi.x, yi.y, p.z, p.w, tz, tx, ty);
      }
    }
    kahan_add(z, cz, tz);
    kahan_add(rx, cx, tx);
    kahan_add(ry, cy, ty);
  }
  if (i < n) {
    rep[i] = make_float2(rx, ry);
    z_rows[i] = z;
  }
}

}  // namespace

// y: float32 [n, 2], 8-byte aligned; rep: float32 [n, 2]; z_rows: float32
// [n]; all contiguous.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int wadt_tsne_repulsion(const void* y, void* rep, void* z_rows, int n, void* stream) {
  if (n <= 0 || reinterpret_cast<uintptr_t>(y) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(rep) % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (n + kThreads - 1) / kThreads;
  tsne_repulsion_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(y), static_cast<float2*>(rep), static_cast<float*>(z_rows), n);
  return (int)cudaGetLastError();
}
