// K1: 3x3x3 SAME stride-1 convolution + bias over the channel concat of
// 1-3 channels-last bf16 operands, with the InstanceNorm sufficient
// statistics (per-(batch, channel) sum of y and y^2 of the f32 value before
// the bf16 cast) reduced in the epilogue.
//
// Replaces: mica_tpu/ops/wino_pallas.py `_wino_T` (kernel `_make_kernel`),
// as reached by `wino_conv3d_in_relu_pallas` (stats on) and
// `wino_conv3d_pallas_padded` (stats and bias off, the heads' conv1).
//
// Bound on the card: operations.  The work is 2 * B*D*H*W * 27*Ci * Co
// flops over ~2*(Ci+Co) bytes of device memory per voxel, far above the
// H100's ~295 flop/byte ridge, so the tensor cores are the limit.  What
// stands between them and the data is the L2 traffic of the 27 shifted
// reads of each input voxel and of the weight, the epilogue, and registers.
//
// Design, for Hopper (sm_90a):
//   * Implicit GEMM: M = B*D*H*W output voxels, N = Co, K = 27*sum(Ci).
//     Each K step (BK = 64, or 32 where a part has a Ci that is not a
//     multiple of 64) lies inside one tap and one part, so the concat is
//     never built.
//   * The M tile is a brick of BM = 128*MT voxels inside one sample
//     (bw x bh x bd, e.g. 64 x 2 x 1 at W = 64).  TMA loads it from a 5-D
//     tiled tensor map over (C, W, H, D, B) per part, at the brick's origin
//     shifted by the tap (dz, dy, dx); the out-of-bounds zero fill,
//     negative coordinates included, is the SAME padding.  Tiled mode, not
//     im2col: a brick is a plain box of the volume, so a shifted box is the
//     whole im2col row block of one tap, with no per-row offsets to encode.
//     The packed weight (Co, 27*sum Ci), K-major, comes in 2-D boxes.  Both
//     land 128-byte swizzled (64-byte for BK = 32), as wgmma reads them.
//   * Warp-specialised: one thread of a producer warpgroup issues the TMA
//     loads into a ring of 3-8 stages guarded by full/empty mbarriers; two
//     consumer warpgroups each run wgmma.mma_async m64nBNk16 (bf16 in, f32
//     accumulate) on MT m64 slices of the brick.  setmaxnreg takes the
//     producer down to 40 registers and gives the consumers 232 (the launch
//     allows 168; a lone producer warp would not raise that: registers go
//     by warpgroups).  BN is Co up to 256 (two N tiles at Co 384 and 512),
//     so each tap's input box is fetched once per N tile of up to 256; MT is
//     2 up to BN 128 and 1 above (of BM 128, 256 and 512, the fastest).
//   * Clusters of two CTAs on adjacent bricks share the weight: each loads
//     half of the B box and multicasts it to both, and a stage is refilled
//     only when the consumers of both CTAs have released it: with one CTA
//     per tile the weight was two thirds of the L2 traffic, and the L2,
//     not the tensor cores, set the pace at Co 256.
//   * Persistent: one cluster per two SMs walks the cluster tiles (brick
//     pairs in order, the N tiles of a pair adjacent, so they meet in L2),
//     and the producer runs ahead into the next tile while the consumers
//     run the epilogue.  An odd last brick's partner loads (zeros) but
//     stores nothing.
//   * Epilogue: bias in f32; the statistics of the f32 values, summed over
//     a thread's rows, then a reduce-scatter over the 8 lanes that share a
//     column (in chunks of two n8 blocks: wider chunks spilled), so each
//     lane holds distinct (column, stat) sums; each consumer warp writes
//     them to its own shared-memory slot, and after a named barrier the
//     consumer threads add the 8 slots in warp order and write the tile's
//     partial row pair to a (B, bricks, 2, Co) f32 buffer, one slot per
//     (brick, N tile), each written by exactly one CTA; bf16 cast and
//     16-byte stores after a 4x4 transpose within each quad.  Rows of a
//     brick outside the volume are neither stored nor counted.
//   * A second kernel (`stats_sum_kernel`) sums each sample's bricks in a
//     fixed order into (B, 2, Co): 32 groups, group g taking bricks g,
//     g + 32, ... in turn, then the groups in order.  No atomics: two calls
//     give the same bits, and the order depends only on the sample's
//     geometry, so a sample's statistics do not depend on the batch it is
//     in or on its place there.
// The tile plan (BK, BN, MT, brick, stages, CTAs) is computed in Python
// (`mica_tpu_torch/ops/conv3d_in.py`, `k1_plan`) and checked here.  Tensor
// maps are encoded on the host with cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPointByVersion, so the library links nothing new.
// Every part, the weight and the output must be 16-byte aligned.  A barrier
// wait of over 4 s traps (a launch error) instead of hanging.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CONSUMERS = 2;                  // consumer warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);  // and a producer warpgroup
constexpr int SMEM_MAX = 232448;              // 227 KB a block can use

struct Params {
  int kc[3];          // BK-steps per part (0 for an absent part)
  int ci_tot;         // sum of the parts' channels
  int bk;             // 64 or 32
  int B, D, H, W, Co;
  int lw, lh, bd;     // log2 of the brick's width and height; its depth
  int nbx, nby, nbz;  // bricks per axis
  int n_tiles;        // N tiles per brick
  int bricks;         // B * nbz * nby * nbx
  int pairs;          // tiles of a cluster: ceil(bricks / 2) * n_tiles
  int ksteps;         // K steps per tile
  int stages;
  int stage_bytes, a_bytes;
  const float* bias;  // (Co,) or null
  __nv_bfloat16* out; // (B, D, H, W, Co)
  float* part;        // (B, bricks a sample, 2, Co): a brick's partial row pair, or null
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Waits for the phase of `parity` to complete.  A wait of over 4 s means a
// lost arrival or load: the kernel traps (a launch error) instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = globaltimer_ns();
  while (!mbar_try_wait(bar, parity))
    if (globaltimer_ns() - t0 > 4000000000ull) __trap();
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4), "r"(bar)
      : "memory");
}

// a 2-D box, written to this offset in every CTA of the cluster in `mask`,
// completing its bytes on the barrier at this offset in each
__device__ __forceinline__ void tma_load_2d_multicast(uint32_t dst, const CUtensorMap* map,
                                                      uint32_t bar, int c0, int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar), "h"(mask)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// arrive on the barrier at this offset in CTA `cta` of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(bar), "r"(cta));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote) : "memory");
}

// every thread of both CTAs of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a K-major swizzled tile: start address,
// leading offset (unused when a k16 slice lies inside one swizzle row),
// stride between 8-row groups, swizzle mode (1: 128 B, 2: 64 B).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t sbo, uint32_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)mode << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator registers across the
// asynchronous wgmma that writes them
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, f32, registers) += A (64 x 16, smem) * B (N x 16, smem)^T;
// scale_d = 0 starts D from zero.  Operand lists written out for each N.
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<96>(float (&d)[48], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<192>(float (&d)[96], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<256>(float (&d)[128], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pick(uint32_t v0, uint32_t v1, uint32_t v2, uint32_t v3, int i) {
  return i == 0 ? v0 : i == 1 ? v1 : i == 2 ? v2 : v3;
}

struct Tile {
  int b, x0, y0, z0, n0;
  int brick;  // index over the batch's bricks: its slot in the partials
  bool valid;  // false for the partner of an odd last brick: it loads, but stores nothing
};

// A cluster's tile `pair` is two adjacent bricks with one N tile, brick-
// major with the N tiles of a brick pair adjacent; CTA `rank` takes one.
__device__ __forceinline__ Tile decode(const Params& p, int pair, int rank, int bn) {
  Tile r;
  const int nt = pair % p.n_tiles;
  int brick = (pair / p.n_tiles) * 2 + rank;
  r.valid = brick < p.bricks;
  r.brick = brick;
  const int bx = brick % p.nbx;
  brick /= p.nbx;
  const int by = brick % p.nby;
  brick /= p.nby;
  const int bz = brick % p.nbz;
  r.b = brick / p.nbz;
  r.x0 = bx << p.lw;
  r.y0 = by << p.lh;
  r.z0 = bz * p.bd;
  r.n0 = nt * bn;
  return r;
}

template <int BN, int MT>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(THREADS, 1)
    conv3d_stats_kernel(const __grid_constant__ CUtensorMap map0,
                        const __grid_constant__ CUtensorMap map1,
                        const __grid_constant__ CUtensorMap map2,
                        const __grid_constant__ CUtensorMap wmap, const Params p) {
  constexpr int R = BN / 2;  // accumulator registers per m64 slice
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + p.stages * p.stage_bytes;  // full[s], then empty[s]
  // the consumer warps' statistics slots, (8 warps, BN columns, 2) f32
  float* s_slots =
      reinterpret_cast<float*>(smem_raw + (base - raw) + p.stages * p.stage_bytes + 16 * p.stages);
  const int tid = threadIdx.x;
  const uint32_t rank = cluster_rank();
  const int cluster = blockIdx.x / 2, n_clusters = gridDim.x / 2;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(bars + 8 * s, 1);
      // one arrival per consumer warp of either CTA: a stage is refilled in
      // both CTAs at once
      mbar_init(bars + 8 * (p.stages + s), 2 * CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  const int wg = tid / 128;
  if (wg == CONSUMERS) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == CONSUMERS * 128) {
      // each CTA loads its A box and half of the B box, which goes to both
      const uint32_t tx = p.a_bytes + BN * p.bk * 2;
      const uint32_t b_half = (BN / 2) * p.bk * 2;
      int s = 0;
      uint32_t ph = 0;
      for (int pair = cluster; pair < p.pairs; pair += n_clusters) {
        const Tile tl = decode(p, pair, rank, BN);
        int kw = 0;  // K index into the packed weight: tap * ci_tot + channel
        for (int tap = 0; tap < 27; ++tap) {
          const int dz = tap / 9 - 1, dy = (tap / 3) % 3 - 1, dx = tap % 3 - 1;
          for (int part = 0; part < 3; ++part) {
            const CUtensorMap* m = part == 0 ? &map0 : part == 1 ? &map1 : &map2;
            for (int k = 0; k < p.kc[part]; ++k, kw += p.bk) {
              mbar_wait(bars + 8 * (p.stages + s), ph ^ 1);
              const uint32_t full = bars + 8 * s;
              mbar_expect_tx(full, tx);
              const uint32_t a = base + s * p.stage_bytes;
              tma_load_5d(a, m, full, k * p.bk, tl.x0 + dx, tl.y0 + dy, tl.z0 + dz, tl.b);
              tma_load_2d_multicast(a + p.a_bytes + rank * b_half, &wmap, full, kw,
                                    tl.n0 + rank * (BN / 2), 0x3);
              if (++s == p.stages) {
                s = 0;
                ph ^= 1;
              }
            }
          }
        }
      }
    }
    cluster_sync();  // no CTA leaves while its partner may still write to it
  } else {
    // ---- consumers: wgmma over the ring, then the epilogue ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (tid / 32) % 4, lane = tid % 32, q = lane & 3;
    const uint32_t mode = p.bk == 64 ? 1u : 2u;      // 128-byte or 64-byte swizzle
    const uint32_t sbo = p.bk * 16;                  // 8 rows of bk bf16
    const uint32_t row_bytes = p.bk * 2;
    const int kk_n = p.bk / 16;
    const int bw = 1 << p.lw, bh = 1 << p.lh;
    float acc[MT][R];
    int s = 0;
    uint32_t ph = 0;
    float* slot = s_slots + (wg * 4 + warp) * 2 * BN;  // this warp's, [column][stat]

    for (int pair = cluster; pair < p.pairs; pair += n_clusters) {
      const Tile tl = decode(p, pair, rank, BN);
      int prev = -1;
      for (int k = 0; k < p.ksteps; ++k) {
        mbar_wait(bars + 8 * s, ph);
        const uint32_t a = base + s * p.stage_bytes + wg * MT * 64 * row_bytes;
        const uint32_t bsm = base + s * p.stage_bytes + p.a_bytes;
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) fence_regs(acc[mi]);
        wgmma_fence();
        for (int kk = 0; kk < kk_n; ++kk) {
          const uint64_t db = make_desc(bsm + kk * 32, sbo, mode);
#pragma unroll
          for (int mi = 0; mi < MT; ++mi)
            wgmma<BN>(acc[mi], make_desc(a + mi * 64 * row_bytes + kk * 32, sbo, mode), db,
                      (k | kk) != 0);
        }
        wgmma_commit();
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) fence_regs(acc[mi]);
        if (prev >= 0) {
          wgmma_wait<1>();
          if (lane == 0) {
            mbar_arrive_cluster(bars + 8 * (p.stages + prev), 0);
            mbar_arrive_cluster(bars + 8 * (p.stages + prev), 1);
          }
        }
        prev = s;
        if (++s == p.stages) {
          s = 0;
          ph ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) fence_regs(acc[mi]);
      if (lane == 0) {
        mbar_arrive_cluster(bars + 8 * (p.stages + prev), 0);
        mbar_arrive_cluster(bars + 8 * (p.stages + prev), 1);
      }
      if (!tl.valid) continue;

      // ---- epilogue ----
      // this thread's rows: r = r0 + 64 * mi + 8 * h of the brick
      const int r0 = wg * MT * 64 + warp * 16 + (lane >> 2);
      auto voxel = [&](int r, int& x, int& y, int& z) {
        x = tl.x0 + (r & (bw - 1));
        y = tl.y0 + ((r >> p.lw) & (bh - 1));
        z = tl.z0 + (r >> (p.lw + p.lh));
        return x < p.W && y < p.H && z < p.D;
      };
      uint32_t okmask = 0;
#pragma unroll
      for (int i = 0; i < 2 * MT; ++i) {
        int x, y, z;
        if (voxel(r0 + 64 * (i >> 1) + 8 * (i & 1), x, y, z)) okmask |= 1u << i;
      }
      if (p.bias) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const float b0 = __ldg(p.bias + tl.n0 + 8 * j + 2 * q);
          const float b1 = __ldg(p.bias + tl.n0 + 8 * j + 2 * q + 1);
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            acc[mi][4 * j] += b0;
            acc[mi][4 * j + 1] += b1;
            acc[mi][4 * j + 2] += b0;
            acc[mi][4 * j + 3] += b1;
          }
        }
      }
      if (p.part) {
        // the slots are free once every consumer thread has read the last
        // tile's
        asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
        // per chunk of CJ n8 column blocks: this thread's sums over its rows
        // inside the volume, v[4 jj + e] (e: y of column 2q, y of 2q + 1,
        // y^2 of each), then a reduce-scatter over the 8 lanes that share q
        // (3 levels of halving), so each lane writes CJ / 2 distinct totals
        // to its warp's slot
        constexpr int CJ = 2;  // wider chunks hold more registers and spill (measured)
        constexpr int V = 4 * CJ;
#pragma unroll
        for (int j0 = 0; j0 < BN / 8; j0 += CJ) {
          float v[V];
#pragma unroll
          for (int jj = 0; jj < CJ; ++jj) {
            float s1a = 0.f, s1b = 0.f, s2a = 0.f, s2b = 0.f;
#pragma unroll
            for (int mi = 0; mi < MT; ++mi)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                if (!(okmask >> (2 * mi + h) & 1)) continue;
                const float y0 = acc[mi][4 * (j0 + jj) + 2 * h];
                const float y1 = acc[mi][4 * (j0 + jj) + 2 * h + 1];
                s1a += y0;
                s1b += y1;
                s2a += y0 * y0;
                s2b += y1 * y1;
              }
            v[4 * jj] = s1a;
            v[4 * jj + 1] = s1b;
            v[4 * jj + 2] = s2a;
            v[4 * jj + 3] = s2b;
          }
          // lane bit 2, 3, 4 in turn: keep one half, add the partner's
#pragma unroll
          for (int lvl = 0; lvl < 3; ++lvl) {
            const int half = V >> (lvl + 1);
            const bool up = lane & (4 << lvl);
#pragma unroll
            for (int i = 0; i < half; ++i) {
              const float send = up ? v[i] : v[i + half];
              const float keep = up ? v[i + half] : v[i];
              v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 4 << lvl);
            }
          }
          const int first = ((lane >> 2) & 1) * (V / 2) + ((lane >> 3) & 1) * (V / 4) +
                            ((lane >> 4) & 1) * (V / 8);
#pragma unroll
          for (int i = 0; i < V / 8; ++i) {
            const int idx = first + i, e = idx & 3;
            const int col = 8 * (j0 + (idx >> 2)) + 2 * q + (e & 1);
            // [column][stat]: a warp's 32 writes fall in 32 banks
            slot[2 * col + (e >> 1)] = v[i];
          }
        }
      }
      // bf16 stores: a quad holds 8 contiguous columns of a row in each of
      // four n8 chunks; a 4x4 transpose gives each lane one chunk's 16 bytes
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int x, y, z;
          const bool ok = voxel(r0 + 64 * mi + 8 * h, x, y, z);
          __nv_bfloat16* row =
              p.out + ((((long long)tl.b * p.D + z) * p.H + y) * p.W + x) * p.Co + tl.n0;
#pragma unroll
          for (int g = 0; g < BN / 32; ++g) {
            uint32_t v[4];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const int j = 4 * g + jj;
              v[jj] = pack_bf16(acc[mi][4 * j + 2 * h], acc[mi][4 * j + 2 * h + 1]);
            }
            uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
            for (int sh = 0; sh < 4; ++sh) {
              const uint32_t got = __shfl_sync(0xffffffffu, pick(v[0], v[1], v[2], v[3], (q - sh) & 3),
                                               (lane & ~3) | ((q + sh) & 3));
              // lane q now holds lane (q + sh)'s columns of chunk 4g + q
#pragma unroll
              for (int i = 0; i < 4; ++i)
                if (i == ((q + sh) & 3)) w[i] = got;
            }
            if (ok)
              *reinterpret_cast<uint4*>(row + (4 * g + q) * 8) = make_uint4(w[0], w[1], w[2], w[3]);
          }
        }
      if (p.part) {
        // the tile's partial row pair: the 8 warps' slots added in warp order
        asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
        float* g = p.part + (long long)tl.brick * 2 * p.Co + tl.n0;
        for (int i = tid; i < 2 * BN; i += CONSUMERS * 128) {
          float t = s_slots[i];
#pragma unroll
          for (int wi = 1; wi < CONSUMERS * 4; ++wi) t += s_slots[wi * 2 * BN + i];
          g[(i & 1) * p.Co + (i >> 1)] = t;
        }
      }
    }
    cluster_sync();
  }
}

constexpr int SUM_GROUPS = 32;  // `K1_SUM_GROUPS` in conv3d_in.py

// stats[b][i] = the sum over sample b's `nb` bricks of part[b][brick][i]
// (i over the 2 * Co values of a row pair), in a fixed order: thread row g
// adds bricks g, g + 32, ... in turn, then row 0 adds the 32 rows in order.
// One block per (32 values, sample).
__global__ void __launch_bounds__(32 * SUM_GROUPS)
    stats_sum_kernel(const float* __restrict__ part, float* __restrict__ stats, int nb, int co2) {
  __shared__ float rows[SUM_GROUPS][33];
  const int i = blockIdx.x * 32 + threadIdx.x, g = threadIdx.y;
  const float* src = part + (long long)blockIdx.y * nb * co2 + i;
  float t = 0.f;
  for (int k = g; k < nb; k += SUM_GROUPS) t += src[(long long)k * co2];
  rows[g][threadIdx.x] = t;
  __syncthreads();
  if (g == 0) {
    t = rows[0][threadIdx.x];
    for (int j = 1; j < SUM_GROUPS; ++j) t += rows[j][threadIdx.x];
    stats[(long long)blockIdx.y * co2 + i] = t;
  }
}

int launch_sum(const float* part, float* stats, int B, int nb, int Co, cudaStream_t stream) {
  stats_sum_kernel<<<dim3(2 * Co / 32, B), dim3(32, SUM_GROUPS), 0, stream>>>(part, stats, nb,
                                                                             2 * Co);
  return (int)cudaGetLastError();
}

// (BN, MT) pairs that are compiled; `k1_plan` in conv3d_in.py keeps the same list
#define K1_CONFIGS(X) X(256, 1) X(192, 1) X(128, 2) X(96, 2) X(64, 2) X(32, 2)

template <int BN, int MT>
int launch(const CUtensorMap* maps, const Params& p, int ctas, int smem, cudaStream_t stream) {
  static bool configured = false;
  static int max_clusters = 0;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(conv3d_stats_kernel<BN, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    // clusters that fit at once with the largest ring; smaller rings fit as many
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(2 * 66);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = SMEM_MAX;
    e = cudaOccupancyMaxActiveClusters(&max_clusters, conv3d_stats_kernel<BN, MT>, &cfg);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  if (max_clusters > 0 && ctas > 2 * max_clusters) ctas = 2 * max_clusters;
  conv3d_stats_kernel<BN, MT><<<ctas, THREADS, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return (int)cudaGetLastError();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

bool is_pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }
int log2i(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

}  // namespace

// Channels-last bf16 parts x0..x2 (B,D,H,W,c_k), c_k = 0 for an absent
// part; w (Co, 27*sum c_k) bf16; bias (Co,) f32 or null; out (B,D,H,W,Co)
// bf16; stats (B,2,Co) f32 or null, and with it part, an f32 buffer of
// (B, bricks a sample, 2, Co) for the bricks' partial sums (neither needs
// zeroing); every pointer 16-byte aligned.  The tile plan: K step bk, N
// tile bn (Co = n_tiles*bn), mt m64 slices per consumer warpgroup, brick
// bw x bh x bd = 128*mt voxels, ring stages, ctas persistent blocks (even:
// clusters of two; fewer if fewer clusters fit on the card at once).
// Launches the conv kernel, then, with stats, the kernel that sums the
// partials.  Returns 0 on success, a CUDA error code, -1 if
// cuTensorMapEncodeTiled cannot be had, or -2 if a tensor map is refused.
extern "C" int conv3d_stats_bf16(const void* x0, const void* x1, const void* x2, int c0, int c1,
                                 int c2, const void* w, const void* bias, void* out, void* stats,
                                 void* part, int B, int D, int H, int W, int Co, int bk, int bn, int mt,
                                 int bw, int bh, int bd, int stages, int ctas, void* stream) {
  const void* xs[3] = {x0, x1, x2};
  const int cs[3] = {c0, c1, c2};
  const int ci_tot = c0 + c1 + c2;
  if ((bk != 32 && bk != 64) || c0 <= 0 || c0 % bk || c1 % bk || c2 % bk || bn <= 0 ||
      Co % bn || B <= 0 || D <= 0 || H <= 0 || W <= 0 || ctas <= 0 || ctas % 2 ||
      (stats != nullptr) != (part != nullptr))
    return (int)cudaErrorInvalidValue;
  if (!is_pow2(bw) || !is_pow2(bh) || !is_pow2(bd) || bw > 256 || bh > 256 || bd > 256 ||
      bw * bh * bd != 128 * mt)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 3; ++i)
    if (cs[i] && (reinterpret_cast<uintptr_t>(xs[i]) & 15)) return (int)cudaErrorMisalignedAddress;
  if ((reinterpret_cast<uintptr_t>(w) & 15) || (reinterpret_cast<uintptr_t>(out) & 15))
    return (int)cudaErrorMisalignedAddress;

  Params p;
  p.ci_tot = ci_tot;
  p.bk = bk;
  for (int i = 0; i < 3; ++i) p.kc[i] = cs[i] / bk;
  p.B = B;
  p.D = D;
  p.H = H;
  p.W = W;
  p.Co = Co;
  p.lw = log2i(bw);
  p.lh = log2i(bh);
  p.bd = bd;
  p.nbx = (W + bw - 1) / bw;
  p.nby = (H + bh - 1) / bh;
  p.nbz = (D + bd - 1) / bd;
  p.n_tiles = Co / bn;
  const long long bricks = (long long)B * p.nbz * p.nby * p.nbx;
  const long long pairs = (bricks + 1) / 2 * p.n_tiles;
  if (pairs > 0x7fffffffLL || (long long)B * D * H * W * Co >= (1LL << 40))
    return (int)cudaErrorInvalidValue;
  p.bricks = (int)bricks;
  p.pairs = (int)pairs;
  p.ksteps = 27 * ci_tot / bk;
  p.stages = stages;
  p.a_bytes = 128 * mt * bk * 2;
  p.stage_bytes = (p.a_bytes + bn * bk * 2 + 1023) / 1024 * 1024;
  const int smem = 1024 + stages * p.stage_bytes + 16 * stages + 64 * bn;
  if (stages < 2 || smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.part = static_cast<float*>(part);

  EncodeTiled encode = encoder();
  if (!encode) return -1;
  const CUtensorMapSwizzle swz = bk == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap maps[4];
  for (int i = 0; i < 3; ++i) {
    const int c = cs[i] ? cs[i] : c0;
    const void* ptr = cs[i] ? xs[i] : x0;
    const cuuint64_t dims[5] = {(cuuint64_t)c, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)D,
                                (cuuint64_t)B};
    const cuuint64_t row = (cuuint64_t)c * 2;
    const cuuint64_t strides[4] = {row, row * W, row * W * H, row * W * H * D};
    const cuuint32_t box[5] = {(cuuint32_t)bk, (cuuint32_t)bw, (cuuint32_t)bh, (cuuint32_t)bd, 1};
    const cuuint32_t es[5] = {1, 1, 1, 1, 1};
    if (encode(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(ptr), dims,
               strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
        CUDA_SUCCESS)
      return -2;
  }
  {
    const cuuint64_t dims[2] = {(cuuint64_t)27 * ci_tot, (cuuint64_t)Co};
    const cuuint64_t strides[1] = {(cuuint64_t)27 * ci_tot * 2};
    const cuuint32_t box[2] = {(cuuint32_t)bk, (cuuint32_t)bn / 2};  // each CTA's half
    const cuuint32_t es[2] = {1, 1};
    if (encode(&maps[3], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims, strides,
               box, es, CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return -2;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = (int)cudaErrorInvalidValue;
#define K1_DISPATCH(N, M) \
  if (bn == N && mt == M) err = launch<N, M>(maps, p, ctas, smem, s);
  K1_CONFIGS(K1_DISPATCH)
#undef K1_DISPATCH
  if (err || !stats) return err;
  return launch_sum(p.part, static_cast<float*>(stats), B, p.bricks / B, Co, s);
}

// The second kernel alone, on the partials of a launch of the first:
// (B, nb, 2, Co) -> stats (B, 2, Co).  Returns 0 or a CUDA error code.
extern "C" int conv3d_stats_sum(const void* part, void* stats, int B, int nb, int Co,
                                void* stream) {
  if (B <= 0 || nb <= 0 || Co <= 0 || Co % 32) return (int)cudaErrorInvalidValue;
  return launch_sum(static_cast<const float*>(part), static_cast<float*>(stats), B, nb, Co,
                    static_cast<cudaStream_t>(stream));
}
