// K7: weight and bias gradients of the depthwise 3x3x3 SAME convolution
// on channels-last bf16: dk[tap][c] = sum_p x[p + tap - 1][c] * g[p][c]
// over every voxel p of every sample (27 taps, (dz, dy, dx) order) and
// db[c] = sum_p g[p][c], accumulated in f32 into a (28, C) f32 table.
//
// Replaces: mica_tpu/ops/depthwise_pallas.py `_depthwise_conv3_grads`
// (kernel `_grad_kernel`), the backward of the DualAttention local conv.
//
// Bound on the card: bytes.  Each element of x and g is read once from
// device memory (2 + 2 bytes) against 28 multiply-adds, ~14 flop/byte, far
// below the H100's ridge; the f32 FMAs come next (at C 64 they alone take
// about two thirds of the byte time), so, as in K3, the design keeps the
// instructions around them few.
//
// Design, for Hopper (sm_90a), after K3 (depthwise3.cu):
//   * A block owns a TY x TX tile of (y, x) columns x a channel group CG
//     of one sample and walks a segment of z.  For each plane it loads by
//     TMA, from 5-D tiled tensor maps over (C, W, H, D, B), the
//     (TY+2) x (TX+2) x CG halo box of x and the TY x TX x CG box of g into
//     one slot of a ring of 4 in shared memory, three planes ahead of the
//     compute.  The out-of-bounds zero fill, negative coordinates
//     included, is the SAME padding of x; it also zeroes g past the
//     volume's edge, so a tile that overhangs the volume adds nothing.
//     A segment of g planes [z0, z1) reads x planes z0-1 .. z1.
//   * The plan (TY, TX, CG, z segment) is computed in Python
//     (`mica_tpu_torch/ops/depthwise.py`, `k7_plan`) and checked here: 8 x 8
//     columns x 64 channels, 256 threads, two blocks an SM at C 64-256; z
//     is cut into segments only where the grid is well short of two waves
//     (batch 1, a short last batch).  A wider tile than K3's 4 x 8 reads
//     fewer halo bytes per g voxel (1.56x against 1.88x) and writes half
//     the partials; it was faster at every site in development runs on the
//     H100 (probes not kept).
//   * A thread owns two channels (one bf16x2 word: a warp reads 128
//     contiguous bytes of a voxel, no bank conflicts) of XT = 8 consecutive
//     x positions and slides along z.  It keeps the g of the three planes
//     around the current x plane in registers (each g plane read from
//     shared memory and converted to f32 once); each x plane's 3 rows x
//     (XT + 2) columns are read and converted once and meet all three, 27
//     FMAs an element.  Its 2 x 28 sums stay in registers over the segment.
//     Three steps an iteration rename the three g planes' roles instead of
//     moving 32 registers a step.  Registers: 56 sums and 48 of g, 128 in
//     all; `-Xptxas -v` is printed on the build line and shows no spills.
//   * Deterministic reduction, no atomics: the block sums its strips in
//     shared memory in a fixed order and writes one (28, CG) f32 partial to
//     its row of a (rows, 28, C) workspace; a second kernel sums each
//     (tap, channel) column over the rows in a fixed order.  Two calls on
//     the same inputs give the same bits, as the TPU's sequential grid does.
//   * One __syncthreads a plane: after it, one thread refills the slot just
//     consumed.  A barrier wait of over 4 s traps (a launch error) instead
//     of hanging.
// x and g must be 16-byte aligned (TMA); the wrapper refuses others.

#include <cuda_bf16.h>

#include "tma5d.cuh"

using namespace tma5d;

namespace {

constexpr int XT = 8;               // x positions a thread computes
constexpr int MAX_THREADS = 256;
constexpr int MIN_BLOCKS = 2;       // blocks an SM (k7_plan's K7_BLOCKS_PER_SM): 128 registers
constexpr int MAX_STAGES = 8;
constexpr int TAPS = 28;            // 27 taps and the bias
constexpr int SUM_THREADS = 1024;   // the column-sum kernel: 32 columns x 32 row lanes

struct Params {
  int D, C;
  int cg, ty, tx, seg, stages;
  int lanes, strips_x;              // cg / 2, tx / XT
  int tiles_x, tiles_y, groups, n_seg;
  int xslot, stage_bytes, ring_bytes;
  int xbox_bytes, gbox_bytes;
  float* part;                      // (rows, 28, C) f32
};

__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
    depthwise3_grads_kernel(const __grid_constant__ CUtensorMap xmap,
                            const __grid_constant__ CUtensorMap gmap, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 127u) & ~127u;           // stage s at base + s * stage_bytes
  unsigned char* const sbase = smem_raw + (base - raw);
  const uint32_t bars = base + p.ring_bytes;             // full[s]

  // block -> (x tile, y tile, channel group, z segment, sample); its
  // workspace row drops the channel group
  int r = blockIdx.x;
  const int bx = r % p.tiles_x;
  r /= p.tiles_x;
  const int by = r % p.tiles_y;
  r /= p.tiles_y;
  const int c0 = (r % p.groups) * p.cg;
  r /= p.groups;
  const int bs = r % p.n_seg;
  const int b = r / p.n_seg;
  const int x0 = bx * p.tx, y0 = by * p.ty, z0 = bs * p.seg;
  const int z1 = min(z0 + p.seg, p.D);                   // g planes [z0, z1)
  const int ng = z1 - z0;
  // step t reads x plane z0 - 1 + t (none at t = 0 when z0 = 0) and, for
  // t < ng, g plane z0 + t; the last x plane is z1, or D - 1 at the top
  const int n_it = ng + (z1 < p.D ? 2 : 1);

  const int tid = threadIdx.x;
  const int lane = tid % p.lanes, strip = tid / p.lanes;
  const int sy = strip / p.strips_x, sx = (strip % p.strips_x) * XT;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < p.stages && t < n_it; ++t) {
      const bool xin = z0 - 1 + t >= 0, gin = t < ng;
      const uint32_t dst = base + t * p.stage_bytes, bar = bars + 8 * t;
      mbar_expect_tx(bar, (xin ? p.xbox_bytes : 0) + (gin ? p.gbox_bytes : 0));
      if (xin) tma_load_5d(dst, &xmap, bar, c0, x0 - 1, y0 - 1, z0 - 1 + t, b);
      if (gin) tma_load_5d(dst + p.xslot, &gmap, bar, c0, x0, y0, z0 + t, b);
    }
  }
  __syncthreads();

  // sums: a[0..26] dk by tap, a[27] db; gA/gB/gC: g of three planes, in
  // the roles gp/g0/gm (planes zi + 1, zi, zi - 1 of x plane zi; 0 outside
  // the segment) that rotate by one each step
  float2 a[TAPS], gA[XT], gB[XT], gC[XT];
#pragma unroll
  for (int k = 0; k < TAPS; ++k) a[k] = make_float2(0.f, 0.f);
#pragma unroll
  for (int i = 0; i < XT; ++i) gA[i] = gB[i] = gC[i] = make_float2(0.f, 0.f);
  const int cb = p.cg * 2;                   // bytes of a voxel's channel group
  const int xrow = (p.tx + 2) * cb;          // bytes of an x box row
  const int x_off = (sy * (p.tx + 2) + sx) * cb + lane * 4;
  const int g_off = p.xslot + (sy * p.tx + sx) * cb + lane * 4;

  // step t: g plane z0 + t into gp, x plane z0 - 1 + t against gp, g0, gm
  auto step = [&](int t, float2 (&gp)[XT], const float2 (&g0)[XT], const float2 (&gm)[XT]) {
    const int s = t % p.stages;
    mbar_wait(bars + 8 * s, (t / p.stages) & 1);
    const unsigned char* slot = sbase + s * p.stage_bytes;
    if (t < ng) {
#pragma unroll
      for (int i = 0; i < XT; ++i) {
        gp[i] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(slot + g_off + i * cb));
        a[27].x += gp[i].x;
        a[27].y += gp[i].y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < XT; ++i) gp[i] = make_float2(0.f, 0.f);
    }
    if (z0 - 1 + t >= 0) {
      // x plane zi = z0 - 1 + t meets g plane zi + 1 - dz at tap dz
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float2 v[XT + 2];
#pragma unroll
        for (int jx = 0; jx < XT + 2; ++jx)
          v[jx] = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(slot + x_off + dy * xrow + jx * cb));
#pragma unroll
        for (int i = 0; i < XT; ++i) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const int k = dy * 3 + dx;
            const float2 u = v[i + dx];
            a[k].x = fmaf(u.x, gp[i].x, a[k].x);              // dz = 0
            a[k].y = fmaf(u.y, gp[i].y, a[k].y);
            a[9 + k].x = fmaf(u.x, g0[i].x, a[9 + k].x);      // dz = 1
            a[9 + k].y = fmaf(u.y, g0[i].y, a[9 + k].y);
            a[18 + k].x = fmaf(u.x, gm[i].x, a[18 + k].x);    // dz = 2
            a[18 + k].y = fmaf(u.y, gm[i].y, a[18 + k].y);
          }
        }
      }
    }
    __syncthreads();
    if (tid == 0 && t + p.stages < n_it) {
      const int u = t + p.stages;            // z0 - 1 + u >= 0 here
      const uint32_t dst = base + s * p.stage_bytes, bar = bars + 8 * s;
      mbar_expect_tx(bar, p.xbox_bytes + (u < ng ? p.gbox_bytes : 0));
      tma_load_5d(dst, &xmap, bar, c0, x0 - 1, y0 - 1, z0 - 1 + u, b);
      if (u < ng) tma_load_5d(dst + p.xslot, &gmap, bar, c0, x0, y0, z0 + u, b);
    }
  };
  // three steps an iteration, the g roles renamed instead of moved
  for (int t = 0; t < n_it; t += 3) {
    step(t, gA, gB, gC);
    if (t + 1 == n_it) break;
    step(t + 1, gC, gA, gB);
    if (t + 2 == n_it) break;
    step(t + 2, gB, gC, gA);
  }

  // every load has landed and been read: the ring now holds the strips'
  // sums, (strips, 28, cg) f32, summed in strip order into this block's
  // partial
  float* red = reinterpret_cast<float*>(sbase);
#pragma unroll
  for (int k = 0; k < TAPS; ++k)
    *reinterpret_cast<float2*>(red + (strip * TAPS + k) * p.cg + 2 * lane) = a[k];
  __syncthreads();
  const int strips = blockDim.x / p.lanes;
  const long long row = ((long long)(b * p.n_seg + bs) * p.tiles_y + by) * p.tiles_x + bx;
  float* dst = p.part + row * TAPS * p.C + c0;
  for (int i = tid; i < TAPS * p.cg; i += blockDim.x) {
    const int k = i / p.cg, cl = i % p.cg;
    float sum = 0.f;
    for (int j = 0; j < strips; ++j) sum += red[(j * TAPS + k) * p.cg + cl];
    dst[(long long)k * p.C + cl] = sum;
  }
}

// out[col] = sum over rows of part[row][col], col in [0, cols), rows in
// order: a block takes 32 columns, its 32 warps' lanes each a column and
// every 32nd row from the warp's own, then one warp sums the warps' sums
// in order.
__global__ void __launch_bounds__(SUM_THREADS)
    depthwise3_grads_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                                int rows, int cols) {
  __shared__ float red[SUM_THREADS / 32][33];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + lane;
  float sum = 0.f;
  if (col < cols) {
#pragma unroll 8
    for (int r = warp; r < rows; r += SUM_THREADS / 32) sum += part[(long long)r * cols + col];
  }
  red[warp][lane] = sum;
  __syncthreads();
  if (warp == 0 && col < cols) {
    float total = 0.f;
    for (int w = 0; w < SUM_THREADS / 32; ++w) total += red[w][lane];
    out[col] = total;
  }
}

}  // namespace

// x, g (B,D,H,W,C) bf16 channels-last, 16-byte aligned; part, a workspace
// of (B * n_seg * tiles_y * tiles_x, 28, C) f32; out (28, C) f32 receives
// dk in rows 0..26 ((dz,dy,dx) order) and db in row 27 (every element is
// written).  The tile plan (`k7_plan` in depthwise.py): channel group cg
// (C % cg == 0, cg % 8 == 0), ty x tx columns (tx % 8 == 0), seg planes a
// block, stages ring slots.  Returns 0 on success, a CUDA error code, -1
// if cuTensorMapEncodeTiled cannot be had, or -2 if a tensor map is
// refused.
extern "C" int depthwise3_grads_bf16(const void* x, const void* g, void* part, void* out, int B,
                                     int D, int H, int W, int C, int cg, int ty, int tx, int seg,
                                     int stages, void* stream) {
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 8 || cg <= 0 || cg % 8 || C % cg ||
      ty <= 0 || tx <= 0 || tx % XT || ty + 2 > 256 || tx + 2 > 256 || cg > 256 || seg <= 0 ||
      stages < 2 || stages > MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  const int threads = cg / 2 * ty * (tx / XT);
  if (threads > MAX_THREADS) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) & 15) || (reinterpret_cast<uintptr_t>(g) & 15) ||
      (reinterpret_cast<uintptr_t>(part) & 7) || (reinterpret_cast<uintptr_t>(out) & 3))
    return (int)cudaErrorMisalignedAddress;

  Params p;
  p.D = D;
  p.C = C;
  p.cg = cg;
  p.ty = ty;
  p.tx = tx;
  p.seg = seg;
  p.stages = stages;
  p.lanes = cg / 2;
  p.strips_x = tx / XT;
  p.tiles_x = (W + tx - 1) / tx;
  p.tiles_y = (H + ty - 1) / ty;
  p.groups = C / cg;
  p.n_seg = (D + seg - 1) / seg;
  p.xbox_bytes = (ty + 2) * (tx + 2) * cg * 2;
  p.gbox_bytes = ty * tx * cg * 2;
  p.xslot = align128(p.xbox_bytes);
  p.stage_bytes = p.xslot + align128(p.gbox_bytes);
  const int red_bytes = ty * (tx / XT) * TAPS * cg * 4;
  p.ring_bytes = align128(stages * p.stage_bytes > red_bytes ? stages * p.stage_bytes
                                                                : red_bytes);
  p.part = static_cast<float*>(part);
  const int smem = 128 + p.ring_bytes + 8 * stages;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * p.n_seg * p.tiles_y * p.tiles_x;
  const long long blocks = rows * p.groups;
  const long long cols = (long long)TAPS * C;
  if (blocks > 0x7fffffffLL || rows > 0x7fffffffLL || rows * cols > 0x7fffffffffffLL)
    return (int)cudaErrorInvalidValue;

  if (!encoder()) return -1;
  CUtensorMap maps[2];
  if (!encode_volume(&maps[0], x, B, D, H, W, C, cg, tx + 2, ty + 2,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B) ||
      !encode_volume(&maps[1], g, B, D, H, W, C, cg, tx, ty, CU_TENSOR_MAP_L2_PROMOTION_L2_128B))
    return -2;

  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(depthwise3_grads_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  depthwise3_grads_kernel<<<(unsigned)blocks, threads, smem, st>>>(maps[0], maps[1], p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  depthwise3_grads_sum_kernel<<<(unsigned)((cols + 31) / 32), SUM_THREADS, 0, st>>>(
      p.part, static_cast<float*>(out), (int)rows, (int)cols);
  return (int)cudaGetLastError();
}
