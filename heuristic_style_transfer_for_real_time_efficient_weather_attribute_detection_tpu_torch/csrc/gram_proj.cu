// bf16 token projection from the row-major Gram, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `make_proj_kernel.proj`
// (tools/exp_pmg_projkernel.py:65, `pl.pallas_call` :67, body `kern` :50),
// the token projection of the PMG bf16 path read straight from the
// per-patch Gram.
//
// What it computes: out[m, n] = sum_k G[m, k] * W[k, n] + b[n], with G the
// flattened row-major Gram [M = B*Np, K = C*C] in bf16, W `token_proj` in
// its own [C*C, N] order in bf16, b float32, float32 sums; out float32, or
// bf16 rounded once (to nearest even) from the float32 sum plus bias.  (The
// TPU kernel took W transposed to d-major and sliced G's sublanes; G is
// symmetric, so the flat row-major Gram is already the A operand of a GEMM
// and no transposed copy of W is needed.)
//
// What bounds it: memory.  At batch 256 of the shipped spec (M 2304,
// K 9216, N 192) it reads 42.5 MB of G and 3.5 MB of W and writes 1.8 MB,
// about 14.3 us at 3.35 TB/s, against 8.15 GFLOP, about 8.2 us of bf16
// tensor-core work at 989 TFLOP/s.
//
// What the design does about it:
//  - one block per band of 128 rows of G (two consumer warpgroups) and
//    one output tile as wide as N (64, 128, 192 or 256
//    columns, chosen at compile time; wider N takes several tiles), so G is
//    read once, from device memory and from L2 alike;
//  - a producer warpgroup, one thread of it, issues TMA copies
//    (`cp.async.bulk.tensor.2d`, 128-byte swizzle) of 64-deep G and W tiles
//    into a ring of 4-6 stages (up to 200 KB), signalled on `mbarrier`s;
//    TMA's zero fill masks the M and N edges and the K tail;
//  - each consumer warpgroup runs `wgmma` m64nNk16 on its 64 rows of the
//    staged tiles, A K-major and B (W as stored, N contiguous) MN-major,
//    float32 accumulators in registers, one tile's products in flight while
//    the previous stage goes back to the producer; `setmaxnreg` moves the
//    producer's registers to the consumers;
//  - K is split over a thread block cluster of up to 8 blocks along K (the
//    main shape has 18 tiles for 132 SMs; the wrapper's plan keeps every
//    cluster resident at once, 5 blocks each there): each block multiplies one
//    slice of whole 64-deep tiles and parks its float32 partial tile in its
//    shared memory; after a cluster barrier each block loads every block's
//    partials for its share of the rows through distributed shared memory
//    and adds them in cluster-rank order, adds the bias and writes the
//    output.  No partial sum goes through device memory, no second launch,
//    no atomics: two runs give the same bits.
// The tensor maps are encoded on the host per call (G's address changes
// every batch) with `cuTensorMapEncodeTiled` of the CUDA library, reached with
// `cudaGetDriverEntryPoint` so that no library beyond the runtime is linked,
// and passed as `__grid_constant__` parameters.  TMA needs K and N multiples
// of 8 and G and W 16-byte aligned (the entry point refuses other shapes;
// every spec's C*C and d_model are).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kBK = 64;                // depth of a staged tile: 128 bytes of bf16
constexpr int kChunkB = kBK * 64 * 2;  // bytes of one staged 64-column W chunk (8 KB)
constexpr int kRingMax = 200 * 1024;   // shared memory for the ring, at most

constexpr int kGroups = 2;                 // consumer warpgroups, 64 rows each
constexpr int kBM = 64 * kGroups;          // output rows of a block

// BN output columns, two consumer warpgroups and one producer warpgroup.
template <int BN>
struct Cfg {
  static constexpr int kThreads = 128 * (kGroups + 1);
  static constexpr int kTileA = kBM * kBK * 2;                 // bytes of one staged G tile
  static constexpr int kStage = kTileA + (BN / 64) * kChunkB;  // bytes of one stage
  static constexpr int kStages = kRingMax / kStage < 6 ? kRingMax / kStage : 6;
  static constexpr int kPitch = BN + 8;                        // floats per parked row
  static constexpr int kRing = kStages * kStage;
  static_assert(kStages >= 3, "too few stages");
  static_assert(kBM * kPitch * 4 <= kRing, "the parked partial tile reuses the ring");
  // ring, then full and empty barriers; +1024 to align the ring by hand
  static constexpr int kSmem = kRing + 2 * kStages * 8 + 1024;
  // registers: the launch gives each thread 65536 / kThreads (a multiple of
  // 8); the producer gives back all but 40, the consumers take them
  static constexpr int kRegs = 65536 / kThreads / 8 * 8;
  static constexpr int kConsumerRegs = (kRegs + (kRegs - 40) / kGroups) / 8 * 8;
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

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets in 16-byte units.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// d[64 x N] = A[64 x 16] B[16 x N] (+ d when acc != 0): A K-major from
// `da`, B MN-major (transposed) from `db`; d in the m64nNk16 accumulator
// layout.

__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_n192(float (&d)[96], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(acc));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (BN == 64) wgmma_n64(d, da, db, acc);
  else if constexpr (BN == 128) wgmma_n128(d, da, db, acc);
  else if constexpr (BN == 192) wgmma_n192(d, da, db, acc);
  else wgmma_n256(d, da, db, acc);
}

// Keep the compiler from moving accumulator accesses across the
// asynchronous products (no instruction may touch d while they run).
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Grid (S, M tiles, N tiles), cluster (S, 1, 1): block x of a cluster takes
// K slice x of S (whole 64-deep tiles, as even as they come) of the output
// tile (y, z); the cluster adds the slices.
template <int BN>
__global__ void __launch_bounds__(Cfg<BN>::kThreads, 1)
gram_proj_kernel(__grid_constant__ const CUtensorMap g_map, __grid_constant__ const CUtensorMap w_map,
                 const float* __restrict__ bias, void* __restrict__ out, int out_bf16, int M,
                 int N, int K) {
  using C = Cfg<BN>;
  constexpr int kTileA = C::kTileA;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::kRing);
  uint64_t* empty = full + C::kStages;
  float* part = reinterpret_cast<float*>(ring);  // [kBM][kPitch], after the K loop

  const int S = gridDim.x;
  const int slice = blockIdx.x;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.z * BN;
  const int kt = (K + kBK - 1) / kBK;
  const int nt = kt / S + (slice < kt % S ? 1 : 0);  // this slice's tiles
  const int t0 = slice * (kt / S) + min(slice, kt % S);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kGroups);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cg::cluster_group cluster = cg::this_cluster();

  if (wg == kGroups) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 128 * kGroups) {
      for (int i = 0; i < nt; ++i) {
        const int st = i % C::kStages;
        const uint32_t round = i / C::kStages;
        mbar_wait(&empty[st], (round & 1) ^ 1);
        uint8_t* a = ring + st * C::kStage;
        mbar_expect_tx(&full[st], C::kStage);
        const int k0 = (t0 + i) * kBK;
        tma_load_2d(a, &g_map, &full[st], k0, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_2d(a + kTileA + j * kChunkB, &w_map, &full[st], n0 + 64 * j, k0);
      }
    }
    cluster.sync();  // the partial tiles are parked
    cluster.sync();  // every block has read them
  } else {
    setmaxnreg_inc<C::kConsumerRegs>();
    float d[BN / 2];  // the first product overwrites it: every slice has a tile
    for (int i = 0; i < nt; ++i) {
      const int st = i % C::kStages;
      mbar_wait(&full[st], (i / C::kStages) & 1);
      const uint32_t a = smem_u32(ring + st * C::kStage) + wg * 64 * 128;  // this group's 64 rows
      const uint32_t b = smem_u32(ring + st * C::kStage + kTileA);
      fence_acc(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // A: 128-byte rows, 8-row groups 1024 bytes apart, k step 32 bytes;
        // B: 64-column chunks 8 KB apart, 8-row groups 1024 bytes apart,
        // k step 16 rows of 128 bytes
        wgmma_tile<BN>(d, desc_sw128(a + kk * 32, 16, 1024),
                       desc_sw128(b + kk * 2048, kChunkB, 1024), i > 0 || kk > 0);
      }
      wgmma_commit();
      // keep this tile's products in flight; the previous tile's are done,
      // so its stage goes back to the producer
      wgmma_wait<1>();
      fence_acc(d);
      if (i > 0 && threadIdx.x % 32 == 0) mbar_arrive(&empty[(i - 1) % C::kStages]);
    }
    wgmma_wait<0>();
    fence_acc(d);
    // both warpgroups are done with the ring (and every copy into it has
    // landed) before either parks its partial tile there
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kGroups) : "memory");
    // park the partial tile: accumulator j*4 + {0,1} at row r, {2,3} at r + 8
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int r = wg * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
      *reinterpret_cast<float2*>(part + r * C::kPitch + c) = make_float2(d[4 * j], d[4 * j + 1]);
      *reinterpret_cast<float2*>(part + (r + 8) * C::kPitch + c) =
          make_float2(d[4 * j + 2], d[4 * j + 3]);
    }
    cluster.sync();
    // this block's share of the rows, summed over the cluster in rank order
    const int share = (kBM + S - 1) / S;
    const int r0 = slice * share;
    const int rows = min(kBM, r0 + share) - r0;
    const int vecs = BN / 4;
    for (int e = threadIdx.x; e < rows * vecs; e += 128 * kGroups) {
      const int row = r0 + e / vecs;
      const int c = (e % vecs) * 4;
      const int m = m0 + row, n = n0 + c;
      // every block's partials loaded first (all in flight at once), then
      // added in rank order
      float4 p[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (q < S) p[q] = *cluster.map_shared_rank(reinterpret_cast<float4*>(part + row * C::kPitch + c), q);
      float4 acc = p[0];
#pragma unroll
      for (int q = 1; q < 8; ++q)
        if (q < S) {
          acc.x += p[q].x; acc.y += p[q].y; acc.z += p[q].z; acc.w += p[q].w;
        }
      if (m >= M || n >= N) continue;  // N % 8 == 0: a vector is wholly in or out
      const float4 bv = *reinterpret_cast<const float4*>(bias + n);
      acc.x += bv.x; acc.y += bv.y; acc.z += bv.z; acc.w += bv.w;
      if (out_bf16) {
        __nv_bfloat162 lo = __floats2bfloat162_rn(acc.x, acc.y);
        __nv_bfloat162 hi = __floats2bfloat162_rn(acc.z, acc.w);
        uint2 u;
        u.x = *reinterpret_cast<uint32_t*>(&lo);
        u.y = *reinterpret_cast<uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(static_cast<bf16*>(out) + (size_t)m * N + n) = u;
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(out) + (size_t)m * N + n) = acc;
      }
    }
    cluster.sync();  // no block leaves while another reads its partials
  }
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

// A row-major bf16 [rows, cols] matrix as a 2-D map of boxes [box_rows, 64
// columns], 128-byte swizzle, zero fill beyond its edges.
bool encode(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
int launch(const CUtensorMap& gm, const CUtensorMap& wm, const float* bias, void* out, int out_bf16,
           int M, int N, int K, int splits, cudaStream_t stream) {
  using C = Cfg<BN>;
  auto* kernel = gram_proj_kernel<BN>;
  static const cudaError_t set =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (set != cudaSuccess) return (int)set;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (M + kBM - 1) / kBM, (N + BN - 1) / BN);
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, gm, wm, bias, out, out_bf16, M, N, K);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// g: bf16 [M, K] (the Gram [B, Np, C*C] flattened); w: bf16 [K, N];
// bias: float32 [N]; out: float32 [M, N], or bf16 when out_bf16; all
// contiguous, K and N multiples of 8, g and w 16-byte aligned.  tile_n: the
// output tile width, 64, 128, 192 or 256 (tiles are 128 rows high);
// splits: the cluster size along K, 1 to 8, at most ceil(K / 64).  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for what it does not take.
extern "C" int wadt_gram_proj_bf16(const void* g, const void* w, const void* bias, void* out,
                                   int out_bf16, int M, int N, int K, int tile_n, int splits,
                                   void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 != 0 || N % 8 != 0 || splits < 1 || splits > 8 ||
      splits > (K + kBK - 1) / kBK || (M + kBM - 1) / kBM > 65535 ||
      reinterpret_cast<uintptr_t>(g) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap gm, wm;
  if (!encode(&gm, g, M, K, kBM) || !encode(&wm, w, K, N, kBK)) return (int)cudaErrorInvalidValue;
  const auto* bp = static_cast<const float*>(bias);
  const auto s = (cudaStream_t)stream;
  switch (tile_n) {
    case 64: return launch<64>(gm, wm, bp, out, out_bf16, M, N, K, splits, s);
    case 128: return launch<128>(gm, wm, bp, out, out_bf16, M, N, K, splits, s);
    case 192: return launch<192>(gm, wm, bp, out, out_bf16, M, N, K, splits, s);
    case 256: return launch<256>(gm, wm, bp, out, out_bf16, M, N, K, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
