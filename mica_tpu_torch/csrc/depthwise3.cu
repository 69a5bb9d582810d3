// K3: depthwise 3x3x3 SAME convolution + bias on channels-last bf16,
// f32 accumulation, bf16 output.
//
// Replaces: mica_tpu/ops/depthwise_pallas.py `depthwise_conv3_pallas`
// (kernel `_kernel`), the DualAttention local conv; the training backward
// runs it again on the gradient with the flipped taps and no bias (dx).
//
// Bound on the card: bytes.  27 multiply-adds per element against one
// 2-byte read and one 2-byte write is ~13 flop/byte, far below the H100's
// ridge, so device memory is the limit; the f32 FMAs come next (at C 256
// they alone take about two thirds of the byte time), so the design also
// keeps the instructions around them few.
//
// Design, for Hopper (sm_90a):
//   * A block owns a TY x TX tile of (y, x) columns x a channel group CG
//     of one sample and walks a segment of z.  Each input plane's
//     (TY+2) x (TX+2) x CG halo box is loaded once by TMA, from a 5-D
//     tiled tensor map over (C, W, H, D, B), into a ring of 4 plane slots
//     in shared memory, three planes ahead of the compute; the
//     out-of-bounds zero fill, negative coordinates included, is the SAME
//     padding.  So each input element comes from device memory about once
//     (the halo columns of a box are the neighbouring tiles' interior,
//     which the blocks running beside it read at the same time, from L2).
//   * The plan (TY, TX, CG, z segment) is computed in Python
//     (`mica_tpu_torch/ops/depthwise.py`, `k3_plan`) and checked here.  At
//     C 64-256 it is 4 x 8 columns x 64 channels, 128 threads, four blocks
//     an SM; z is cut into segments (which read a 2-plane halo) while the
//     grid is short of two waves: at batch 1, or a short last batch.
//   * A thread owns two channels (a warp reads 32 consecutive bf16 pairs of
//     one voxel: no bank conflicts) of XT = 8 consecutive x positions, keeps
//     its 2 x 27 taps and bias in registers, and slides along z: each plane
//     read from shared memory (3 rows x 10 columns, converted to f32 once)
//     feeds the three output planes it touches, 27 FMAs an output.  Eight x
//     positions, not four, cut the loads and conversions per FMA by a
//     fifth, and were clearly faster in development runs on the H100 (a
//     probe not kept); sixteen took 217 registers for little more.
//   * Outputs go through one of two shared-memory tiles to a TMA store of
//     the (TY, TX, CG) box: 16-byte, coalesced, clipped at the volume's
//     edge by the hardware, and asynchronous (the tile is reused two
//     planes later, once the store has read it).
//   * One __syncthreads a plane: after it, one thread refills the slot just
//     consumed and issues the store.  A barrier wait of over 4 s traps (a
//     launch error) instead of hanging.
// x and out must be 16-byte aligned (TMA); the wrapper refuses other x.

#include <cuda_bf16.h>

#include "tma5d.cuh"

using namespace tma5d;

namespace {

constexpr int XT = 8;               // x positions a thread computes
constexpr int MAX_THREADS = 128;
constexpr int MAX_STAGES = 8;

struct Params {
  int D, C;
  int cg, ty, tx, seg, stages;
  int lanes, strips_x;              // cg / 2, tx / XT
  int tiles_x, tiles_y, groups, n_seg;
  int slot_bytes, out_bytes, box_bytes;
  const float* taps;                // (27, C) f32, (dz, dy, dx) order
  const float* bias;                // (C,) f32
};

__global__ void __launch_bounds__(MAX_THREADS, 4)
    depthwise3_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap omap, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 127u) & ~127u;           // slot s at base + s * slot_bytes
  unsigned char* const sbase = smem_raw + (base - raw);
  const uint32_t obase = base + p.stages * p.slot_bytes;  // two output tiles
  const uint32_t bars = obase + 2 * p.out_bytes;          // full[s]

  // block -> (x tile, y tile, channel group, z segment, sample)
  int r = blockIdx.x;
  const int x0 = (r % p.tiles_x) * p.tx;
  r /= p.tiles_x;
  const int y0 = (r % p.tiles_y) * p.ty;
  r /= p.tiles_y;
  const int c0 = (r % p.groups) * p.cg;
  r /= p.groups;
  const int z0 = (r % p.n_seg) * p.seg;
  const int b = r / p.n_seg;
  const int z1 = min(z0 + p.seg, p.D);                    // output planes [z0, z1)
  const int zlo = max(z0 - 1, 0), zhi = min(z1, p.D - 1);  // input planes read
  const int n_planes = zhi - zlo + 1;

  const int tid = threadIdx.x;
  const int lane = tid % p.lanes, strip = tid / p.lanes;
  const int sy = strip / p.strips_x, sx = (strip % p.strips_x) * XT;
  const int c = c0 + 2 * lane;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 0; j < p.stages && j < n_planes; ++j) {
      mbar_expect_tx(bars + 8 * j, p.box_bytes);
      tma_load_5d(base + j * p.slot_bytes, &xmap, bars + 8 * j, c0, x0 - 1, y0 - 1, zlo + j, b);
    }
  }
  float2 w[27];
#pragma unroll
  for (int k = 0; k < 27; ++k) w[k] = *reinterpret_cast<const float2*>(p.taps + k * p.C + c);
  const float2 bias = *reinterpret_cast<const float2*>(p.bias + c);
  __syncthreads();

  // a0/a1/a2: output planes zi-1 / zi / zi+1 of this thread's XT columns
  float2 a0[XT], a1[XT], a2[XT];
#pragma unroll
  for (int i = 0; i < XT; ++i) a0[i] = a1[i] = a2[i] = bias;
  const int cb = p.cg * 2;                   // bytes of a voxel's channel group
  const int row = (p.tx + 2) * cb;           // bytes of a box row
  const int in_off = (sy * (p.tx + 2) + sx) * cb + lane * 4;
  const int out_off = (sy * p.tx + sx) * cb + lane * 4;
  int n_out = 0;

  for (int zi = z0 - 1; zi <= z1; ++zi) {
    const int j = zi - zlo, s = j % p.stages;
    const bool in_vol = zi >= 0 && zi < p.D;
    if (in_vol) {
      mbar_wait(bars + 8 * s, (j / p.stages) & 1);
      const unsigned char* src = sbase + s * p.slot_bytes + in_off;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float2 v[XT + 2];
#pragma unroll
        for (int jx = 0; jx < XT + 2; ++jx)
          v[jx] = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(src + dy * row + jx * cb));
#pragma unroll
        for (int i = 0; i < XT; ++i) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const int k = dy * 3 + dx;
            const float2 u = v[i + dx];
            a0[i].x = fmaf(u.x, w[18 + k].x, a0[i].x);   // dz = +1: plane zi - 1
            a0[i].y = fmaf(u.y, w[18 + k].y, a0[i].y);
            a1[i].x = fmaf(u.x, w[9 + k].x, a1[i].x);    // dz = 0
            a1[i].y = fmaf(u.y, w[9 + k].y, a1[i].y);
            a2[i].x = fmaf(u.x, w[k].x, a2[i].x);        // dz = -1: plane zi + 1
            a2[i].y = fmaf(u.y, w[k].y, a2[i].y);
          }
        }
      }
    }
    const int zo = zi - 1;                   // complete after plane zi
    const bool store = zo >= z0;
    if (store) {
      unsigned char* dst = sbase + p.stages * p.slot_bytes + (n_out & 1) * p.out_bytes + out_off;
#pragma unroll
      for (int i = 0; i < XT; ++i)
        *reinterpret_cast<__nv_bfloat162*>(dst + i * cb) = __floats2bfloat162_rn(a0[i].x, a0[i].y);
      fence_proxy_async();
    }
#pragma unroll
    for (int i = 0; i < XT; ++i) {
      a0[i] = a1[i];
      a1[i] = a2[i];
      a2[i] = bias;
    }
    // the store issued a plane ago has read its tile, which the next plane
    // writes: wait for it before the barrier that lets the threads on
    if (tid == 0) bulk_wait_read();
    __syncthreads();
    if (tid == 0) {
      if (store) tma_store_5d(&omap, obase + (n_out & 1) * p.out_bytes, c0, x0, y0, zo, b);
      if (in_vol && j + p.stages < n_planes) {
        mbar_expect_tx(bars + 8 * s, p.box_bytes);
        tma_load_5d(base + s * p.slot_bytes, &xmap, bars + 8 * s, c0, x0 - 1, y0 - 1,
                    zlo + j + p.stages, b);
      }
    }
    if (store) ++n_out;
  }
  if (tid == 0) bulk_wait();
}

}  // namespace

// x, out (B,D,H,W,C) bf16 channels-last, 16-byte aligned; taps (27, C) f32
// in (dz,dy,dx) order; bias (C,) f32; C % 8 == 0.  The tile plan (`k3_plan`
// in depthwise.py): channel group cg (C % cg == 0, cg % 8 == 0), ty x tx
// columns (tx % 4 == 0), seg output planes a block, stages ring slots.
// Returns 0 on success, a CUDA error code, -1 if cuTensorMapEncodeTiled
// cannot be had, or -2 if a tensor map is refused.
extern "C" int depthwise3_bf16(const void* x, const void* taps, const void* bias, void* out, int B,
                               int D, int H, int W, int C, int cg, int ty, int tx, int seg,
                               int stages, void* stream) {
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 8 || cg <= 0 || cg % 8 || C % cg ||
      ty <= 0 || tx <= 0 || tx % XT || ty + 2 > 256 || tx + 2 > 256 || cg > 256 || seg <= 0 ||
      stages < 2 || stages > MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  const int threads = cg / 2 * ty * (tx / XT);
  if (threads > MAX_THREADS) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) & 15) || (reinterpret_cast<uintptr_t>(out) & 15) ||
      (reinterpret_cast<uintptr_t>(taps) & 7) || (reinterpret_cast<uintptr_t>(bias) & 7))
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
  p.box_bytes = (ty + 2) * (tx + 2) * cg * 2;
  p.slot_bytes = align128(p.box_bytes);
  p.out_bytes = align128(ty * tx * cg * 2);
  p.taps = static_cast<const float*>(taps);
  p.bias = static_cast<const float*>(bias);
  const int smem = 128 + stages * p.slot_bytes + 2 * p.out_bytes + 8 * stages;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)B * p.n_seg * p.groups * p.tiles_y * p.tiles_x;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;

  if (!encoder()) return -1;
  CUtensorMap maps[2];
  if (!encode_volume(&maps[0], x, B, D, H, W, C, cg, tx + 2, ty + 2,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B) ||
      !encode_volume(&maps[1], out, B, D, H, W, C, cg, tx, ty, CU_TENSOR_MAP_L2_PROMOTION_NONE))
    return -2;

  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(depthwise3_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  depthwise3_kernel<<<(unsigned)blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], p);
  return (int)cudaGetLastError();
}
