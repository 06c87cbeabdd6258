// HDBSCAN's quadratic work for Hopper (sm_90a): each point's core distance
// and Prim's minimum spanning tree of the mutual reachability graph, in
// float64 and in O(N D) memory.
//
// Replaces no TPU kernel: the JAX package clusters its embeddings with
// scikit-learn's HDBSCAN on the host (workloads/embed.py,
// hdbscan_clustering), whose euclidean path (_hdbscan_prims) computes
//   1. core distances: NearestNeighbors(kd_tree).kneighbors(X, min_samples),
//      the point itself counted, so each point's min_samples-th smallest
//      distance to the N points;
//   2. mst_from_data_matrix: Prim's algorithm over the mutual reachability
//      max(core_i, core_j, d_ij), grown from point 0, one row of distances
//      recomputed a step.
// The port runs both here; the steps after the tree (single linkage, the
// condensed tree, excess of mass, labels) stay O(N) numpy on the host
// (utils/hdbscan.py).
//
// Bit for bit scikit-learn's.  Every distance is sqrt(sum_d (a_d - b_d)^2),
// summed in float64 in dimension order, each subtraction, product and sum
// rounded on its own (__dsub_rn, __dmul_rn, __dadd_rn, which nvcc never
// fuses into an FMA), and one correctly rounded __dsqrt_rn at the end, as
// scikit-learn's EuclideanDistance64 computes it.  float32 points are
// widened to float64 first, which is exact, as scikit-learn widens them.
// Both kernels read the points transposed, xt [D, N] (float32 or float64),
// so that the threads of a warp, which own neighbouring points, read
// neighbouring addresses.
//
// hdbscan_core: xt, k -> core [N] float64, the k-th smallest of the N
// distances of each point (itself at 0 included).
//   What bounds it: operations.  N^2 pairs of D float64 subtractions,
//   products and sums, 3 N^2 D operations (6.2e11 at N 65,536, D 48): 18 ms
//   at the card's 34 TFLOP/s float64 peak, which counts an FMA as two; with
//   no FMA allowed every operation is an instruction, so the FP64 pipe's
//   rate makes twice that the reachable floor.  Bytes are nothing (N D).
//   The design: one thread a row, 128 rows a block; the block stages tiles
//   of 32 points x 32 dimensions in shared memory (widened to float64), and
//   each thread sums its row's 32 squared distances of the tile in
//   registers, reading each staged value as a broadcast.
//   - k <= 32 (the insertion path): each thread keeps its row's K smallest
//     squared distances (K 8 for k <= 8, else 32) sorted, one unrolled
//     compare-and-shift pass for a value below the K-th; the answer is the
//     k-th of them.  ptxas places best[K] in local memory (a K x 8-byte
//     stack frame), not in registers; the values stay in L1.  On an H100
//     80GB HBM3 (700 W) at N 65,536, D 48, keeping 8 values is 17 % faster
//     than keeping 32, while keeping 4 or 16 came within 6 % and 3 % of
//     those two (chip_smoke.py phase 25 times each k).
//   - k > 32, up to N (the select path): a radix select on the squared
//     distances' bits (non-negative doubles order as their unsigned bit
//     patterns), 4 bits a pass from the top: each of 16 passes recomputes
//     the row's N distances and counts, in a per-thread histogram in shared
//     memory, the next digit of those that match the digits chosen so far.
//     16 times the insertion path's work, no scratch in device memory.
//   The square root is taken once, of the k-th squared distance (it is
//   monotone and correctly rounded, so this is the k-th distance).
//
// hdbscan_mst: xt, core -> edges [N - 1, 3] float64, rows (node in the
// tree, node added, weight) in the order mst_from_data_matrix adds them.
//   Step s adds one node: with cur the node added last, every node j not in
//   the tree takes mrd = max(core[cur], core[j], d(cur, j)); where mrd is
//   strictly below min_reach[j] it becomes min_reach[j] and cur its source;
//   the next node is the not-in-tree node of least min_reach, the lowest
//   index among equal values (scikit-learn's first strict minimum).
//   What bounds it: the N - 1 dependent steps.  The arithmetic is
//   1.5 N^2 D float64 operations (the remaining nodes' distances a step,
//   9 ms at N 65,536, D 48, at 34 TFLOP/s), but each step ends in a global
//   arg-min that the next step needs.
//   The design: one persistent cooperative launch for the whole tree.
//   - Grid: blocks of 256 threads, as many as fit on the card at once
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor) up to the wrapper's
//     max_blocks (2 an SM), launched with cudaLaunchCooperativeKernel, which
//     refuses a grid too large to be resident at once instead of letting the
//     grid barrier wait forever.
//   - Each thread owns the nodes j = its global index + m x (grid threads)
//     for the whole run; min_reach, source and in_tree of a node are only
//     ever read and written by its owner, in device memory.
//   - Each step the block stages x_cur (widened) in shared memory, its
//     threads update their nodes and keep their least (value, index,
//     source), the block reduces them and writes one partial.
//   - One grid barrier a step, generation-counted, its two words zeroed
//     before every launch.  After it every block reduces all the partials
//     itself in the same total order (value, then index), so all blocks
//     pick the same next node without a second barrier; block 0 writes the
//     edge.  The partials are double-buffered by step parity, so a block
//     that runs ahead into step s + 1 never overwrites what a slower block
//     still reads of step s.
// Not done: keeping a block's nodes in shared memory across steps, or
// dropping nodes that joined the tree from the scan.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

constexpr int kCoreRows = 128;  // rows (threads) of a block
constexpr int kCoreCols = 32;   // points of a staged tile
constexpr int kCoreDims = 32;   // dimensions of a staged tile
constexpr int kSmallK = 8;      // the insertion path keeps 8 values for k <= 8, else kFastCap
constexpr int kFastCap = 32;    // largest k of the insertion path
constexpr int kMstThreads = 256;
constexpr int kMstWarps = kMstThreads / 32;
constexpr int kMstMaxDims = 16384;  // x_cur in shared memory: 128 KB

// s + (a - b)^2, each operation rounded on its own
__device__ __forceinline__ double add_sq(double s, double a, double b) {
  const double t = __dsub_rn(a, b);
  return __dadd_rn(s, __dmul_rn(t, t));
}

// acc[c] = |x_i - x_{j0 + c}|^2 for the kCoreCols points of the tile at j0
// (points past N give values that are not used).  All threads of the block
// call it together: it stages the tile through `cols`.
template <typename T>
__device__ __forceinline__ void tile_distances(const T* __restrict__ xt, int n, int d, int i, int j0,
                                               double (&acc)[kCoreCols],
                                               double (*cols)[kCoreCols]) {
#pragma unroll
  for (int c = 0; c < kCoreCols; ++c) acc[c] = 0.0;
  const int row = min(i, n - 1);  // a row past N computes row N - 1's, unused
  for (int d0 = 0; d0 < d; d0 += kCoreDims) {
    const int dc = min(kCoreDims, d - d0);
    __syncthreads();  // the previous tile is read
    for (int e = threadIdx.x; e < dc * kCoreCols; e += kCoreRows) {
      const int dd = e / kCoreCols, c = e % kCoreCols, j = j0 + c;
      cols[dd][c] = j < n ? static_cast<double>(xt[static_cast<size_t>(d0 + dd) * n + j]) : 0.0;
    }
    __syncthreads();
#pragma unroll 2
    for (int dd = 0; dd < dc; ++dd) {
      const double xi = static_cast<double>(xt[static_cast<size_t>(d0 + dd) * n + row]);
      const double2* tile = reinterpret_cast<const double2*>(cols[dd]);
#pragma unroll
      for (int c = 0; c < kCoreCols / 2; ++c) {
        const double2 p = tile[c];
        acc[2 * c] = add_sq(acc[2 * c], xi, p.x);
        acc[2 * c + 1] = add_sq(acc[2 * c + 1], xi, p.y);
      }
    }
  }
}

// best: the K smallest values so far, ascending; v enters in its place
template <int K>
__device__ __forceinline__ void insert(double (&best)[K], double v) {
  if (!(v < best[K - 1])) return;
#pragma unroll
  for (int m = K - 1; m > 0; --m) {
    const double prev = best[m - 1];
    best[m] = v < prev ? prev : (v < best[m] ? v : best[m]);
  }
  best[0] = v < best[0] ? v : best[0];
}

template <typename T, int K>
__global__ void __launch_bounds__(kCoreRows)
core_insert_kernel(const T* __restrict__ xt, int n, int d, int k, double* __restrict__ out) {
  __shared__ __align__(16) double cols[kCoreDims][kCoreCols];
  const int i = blockIdx.x * kCoreRows + threadIdx.x;
  double best[K];
#pragma unroll
  for (int m = 0; m < K; ++m) best[m] = __longlong_as_double(0x7ff0000000000000LL);  // +inf
  double acc[kCoreCols];
  for (int j0 = 0; j0 < n; j0 += kCoreCols) {
    tile_distances(xt, n, d, i, j0, acc, cols);
    const int cnt = min(kCoreCols, n - j0);
#pragma unroll
    for (int c = 0; c < kCoreCols; ++c) {
      if (c < cnt) insert<K>(best, acc[c]);
    }
  }
  if (i < n) {
    double v = 0.0;
#pragma unroll
    for (int m = 0; m < K; ++m) {
      if (m == k - 1) v = best[m];
    }
    out[i] = __dsqrt_rn(v);
  }
}

template <typename T>
__global__ void __launch_bounds__(kCoreRows)
core_select_kernel(const T* __restrict__ xt, int n, int d, int k, double* __restrict__ out) {
  __shared__ __align__(16) double cols[kCoreDims][kCoreCols];
  __shared__ unsigned hist[16][kCoreRows];  // a column per thread
  const int i = blockIdx.x * kCoreRows + threadIdx.x;
  unsigned long long prefix = 0;  // the digits chosen so far
  unsigned rank = static_cast<unsigned>(k);  // among the values that match them, from 1
  double acc[kCoreCols];
  for (int shift = 60; shift >= 0; shift -= 4) {
#pragma unroll
    for (int b = 0; b < 16; ++b) hist[b][threadIdx.x] = 0;
    const unsigned long long high = shift == 60 ? 0ull : ~0ull << (shift + 4);
    for (int j0 = 0; j0 < n; j0 += kCoreCols) {
      tile_distances(xt, n, d, i, j0, acc, cols);
      const int cnt = min(kCoreCols, n - j0);
#pragma unroll
      for (int c = 0; c < kCoreCols; ++c) {
        const unsigned long long key = static_cast<unsigned long long>(__double_as_longlong(acc[c]));
        if (c < cnt && ((key ^ prefix) & high) == 0) ++hist[(key >> shift) & 15][threadIdx.x];
      }
    }
    unsigned digit = 15;
    for (int b = 0; b < 16; ++b) {
      const unsigned h = hist[b][threadIdx.x];
      if (rank <= h) {
        digit = b;
        break;
      }
      rank -= h;
    }
    prefix |= static_cast<unsigned long long>(digit) << shift;
  }
  if (i < n) out[i] = __dsqrt_rn(__longlong_as_double(static_cast<long long>(prefix)));
}

template <typename T>
int launch_core(const void* xt, int n, int d, int k, double* out, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xt);
  const int blocks = (n + kCoreRows - 1) / kCoreRows;
  if (k <= kSmallK) {
    core_insert_kernel<T, kSmallK><<<blocks, kCoreRows, 0, stream>>>(x, n, d, k, out);
  } else if (k <= kFastCap) {
    core_insert_kernel<T, kFastCap><<<blocks, kCoreRows, 0, stream>>>(x, n, d, k, out);
  } else {
    core_select_kernel<T><<<blocks, kCoreRows, 0, stream>>>(x, n, d, k, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// -- Prim's MST ---------------------------------------------------------------

struct Cand {
  double v;
  int idx;
  int src;
};

__device__ __forceinline__ bool before(double v, int i, double w, int j) {
  return v < w || (v == w && i < j);
}

__device__ __forceinline__ void warp_min(double& v, int& i, int& s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const double ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    const int os = __shfl_xor_sync(0xffffffffu, s, off);
    if (before(ov, oi, v, i)) {
      v = ov;
      i = oi;
      s = os;
    }
  }
}

// The block's least (v, i, s) by (v, i), in thread 0.  Every thread calls it.
__device__ __forceinline__ void block_min(double& v, int& i, int& s, Cand* scratch) {
  warp_min(v, i, s);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = Cand{v, i, s};
  __syncthreads();
  if (warp == 0) {
    const Cand c = lane < kMstWarps ? scratch[lane]
                                    : Cand{__longlong_as_double(0x7ff0000000000000LL), INT_MAX, 0};
    v = c.v;
    i = c.idx;
    s = c.src;
    warp_min(v, i, s);
  }
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every block of the (co-resident) grid waits here until all have arrived.
// count and gen start at 0 in each launch; the barrier ending step s sets
// gen to s + 1.
__device__ __forceinline__ void grid_barrier(unsigned* count, unsigned* gen, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(count, 1u) == gridDim.x - 1) {
      atomicExch(count, 0u);
      __threadfence();
      atomicExch(gen, target);
    } else {
      while (ld_acquire(gen) < target) {
      }
    }
    __threadfence();
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kMstThreads)
prim_mst_kernel(const T* __restrict__ xt, const double* __restrict__ core, int n, int d,
                double* __restrict__ min_reach, int* __restrict__ source,
                unsigned char* __restrict__ in_tree, Cand* partials, unsigned* bar,
                double* __restrict__ edges) {
  extern __shared__ double xc[];  // x_cur, widened
  __shared__ Cand scratch[kMstWarps];
  __shared__ int chosen;
  const double inf = __longlong_as_double(0x7ff0000000000000LL);
  const int stride = gridDim.x * kMstThreads;
  const int first = blockIdx.x * kMstThreads + threadIdx.x;
  for (int j = first; j < n; j += stride) {
    min_reach[j] = inf;
    source[j] = 1;
    in_tree[j] = 0;
  }
  int cur = 0;
  for (int step = 0; step < n - 1; ++step) {
    for (int dd = threadIdx.x; dd < d; dd += kMstThreads) {
      xc[dd] = static_cast<double>(xt[static_cast<size_t>(dd) * n + cur]);
    }
    const double core_cur = core[cur];
    __syncthreads();
    double bv = inf;
    int bi = INT_MAX, bs = 0;
    for (int j = first; j < n; j += stride) {  // j ascending: a strict < keeps the lowest index
      if (j == cur) {
        in_tree[j] = 1;
        continue;
      }
      if (in_tree[j]) continue;
      double s = 0.0;
      for (int dd = 0; dd < d; ++dd) {
        s = add_sq(s, xc[dd], static_cast<double>(xt[static_cast<size_t>(dd) * n + j]));
      }
      const double mrd = fmax(fmax(core_cur, core[j]), __dsqrt_rn(s));
      double r = min_reach[j];
      int src = source[j];
      if (mrd < r) {
        r = mrd;
        src = cur;
        min_reach[j] = r;
        source[j] = src;
      }
      if (r < bv) {
        bv = r;
        bi = j;
        bs = src;
      }
    }
    block_min(bv, bi, bs, scratch);
    Cand* part = partials + (step & 1) * gridDim.x;
    if (threadIdx.x == 0) part[blockIdx.x] = Cand{bv, bi, bs};
    grid_barrier(bar, bar + 1, static_cast<unsigned>(step) + 1u);
    bv = inf;
    bi = INT_MAX;
    bs = 0;
    for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += kMstThreads) {
      const double v = __ldcg(&part[b].v);  // written by other SMs: read past L1
      const int idx = __ldcg(&part[b].idx);
      if (before(v, idx, bv, bi)) {
        bv = v;
        bi = idx;
        bs = __ldcg(&part[b].src);
      }
    }
    block_min(bv, bi, bs, scratch);
    if (threadIdx.x == 0) {
      chosen = bi;
      if (blockIdx.x == 0) {
        edges[3 * static_cast<size_t>(step)] = static_cast<double>(bs);
        edges[3 * static_cast<size_t>(step) + 1] = static_cast<double>(bi);
        edges[3 * static_cast<size_t>(step) + 2] = bv;
      }
    }
    __syncthreads();
    cur = chosen;
  }
}

template <typename T>
int launch_mst(const void* xt, const void* core, int n, int d, void* min_reach, void* source,
               void* in_tree, void* partials, int max_blocks, void* bar, void* edges,
               cudaStream_t stream) {
  void (*kernel)(const T*, const double*, int, int, double*, int*, unsigned char*, Cand*,
                 unsigned*, double*) = prim_mst_kernel<T>;
  const int smem = d * static_cast<int>(sizeof(double));
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kMstThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int blocks = std::min({per_sm * sms, max_blocks, (n + kMstThreads - 1) / kMstThreads});
  if ((err = cudaMemsetAsync(bar, 0, 2 * sizeof(unsigned), stream)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const T* x = static_cast<const T*>(xt);
  const double* c = static_cast<const double*>(core);
  double* mr = static_cast<double*>(min_reach);
  int* src = static_cast<int*>(source);
  unsigned char* it = static_cast<unsigned char*>(in_tree);
  Cand* part = static_cast<Cand*>(partials);
  unsigned* b = static_cast<unsigned*>(bar);
  double* e = static_cast<double*>(edges);
  void* args[] = {&x, &c, &n, &d, &mr, &src, &it, &part, &b, &e};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(blocks), dim3(kMstThreads),
                                    args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xt: float32 (is_f64 0) or float64 (is_f64 1) [d, n], contiguous; out:
// float64 [n]; 1 <= k <= n.  Returns cudaGetLastError() after the launch (0
// on success).
extern "C" int wadt_hdbscan_core(const void* xt, int is_f64, int n, int d, int k, void* out,
                                 void* stream) {
  if (n <= 0 || d <= 0 || k < 1 || k > n) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* o = static_cast<double*>(out);
  return is_f64 ? launch_core<double>(xt, n, d, k, o, s) : launch_core<float>(xt, n, d, k, o, s);
}

// xt: float32 or float64 [d, n]; core: float64 [n]; scratch: min_reach
// float64 [n], source int32 [n], in_tree uint8 [n], partials 16-byte
// entries [2, max_blocks], bar uint32 [2] (zeroed here on the stream);
// edges: float64 [n - 1, 3].  n >= 2, d <= 16384.  Returns the launch's
// error (0 on success); a grid that cannot be co-resident is refused.
extern "C" int wadt_hdbscan_mst(const void* xt, int is_f64, const void* core, int n, int d,
                                void* min_reach, void* source, void* in_tree, void* partials,
                                int max_blocks, void* bar, void* edges, void* stream) {
  if (n < 2 || d <= 0 || d > kMstMaxDims || max_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch_mst<double>(xt, core, n, d, min_reach, source, in_tree, partials,
                                     max_blocks, bar, edges, s)
                : launch_mst<float>(xt, core, n, d, min_reach, source, in_tree, partials,
                                    max_blocks, bar, edges, s);
}
