// K7: weight and bias gradients of the depthwise 3x3x3 SAME convolution
// on channels-last bf16: dk[tap][c] = sum_p x[p + tap - 1][c] * g[p][c]
// over every voxel p of every sample (27 taps, (dz, dy, dx) order) and
// db[c] = sum_p g[p][c], accumulated in f32 into a (28, C) f32 table.
//
// Replaces: mica_tpu/ops/depthwise_pallas.py `_depthwise_conv3_grads`
// (kernel `_grad_kernel`), the backward of the DualAttention local conv.
//
// Bound on the card: bytes.  Each element of x and g is read once from
// device memory (2 + 2 bytes) against 28 multiply-adds, ~14 flop/byte,
// far below the H100's ridge.  Design: the forward kernel K3's z-sliding
// neighbourhood reads.  A thread owns two consecutive channels (one
// bf16x2 word; a warp reads 128 contiguous bytes of one voxel) and walks
// whole (b, y, x) columns along z, keeping g of three consecutive planes
// in registers: each input plane's 3 x 3 neighbourhood is read once and
// meets the g of the three output planes it touches, so x is fetched 9
// times from L1/L2 and g once.  The 2 x 28 sums stay in registers across
// every column a thread visits (a grid-stride loop over columns), are
// reduced over the block's warps in shared memory, and leave with one
// atomic per (block, tap, channel), never one per voxel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;          // column lanes of a block
constexpr int PAIRS = 32;         // channel pairs of a block: 64 channels
constexpr int TAPS = 28;          // 27 taps and the bias

__global__ void __launch_bounds__(PAIRS * WARPS)
    depthwise3_grads_kernel(const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ g, float* __restrict__ out,
                            int D, int H, int W, int C, long long n_cols) {
  __shared__ float red[TAPS][2 * PAIRS];
  const int lane = threadIdx.x;  // channel pair within the block's 64 channels
  const int warp = threadIdx.y;
  const int c0 = (blockIdx.y * PAIRS + lane) * 2;
  const bool active = c0 < C;

  for (int i = threadIdx.y * PAIRS + threadIdx.x; i < TAPS * 2 * PAIRS; i += PAIRS * WARPS)
    (&red[0][0])[i] = 0.f;

  float a0[TAPS], a1[TAPS];
#pragma unroll
  for (int k = 0; k < TAPS; ++k) a0[k] = a1[k] = 0.f;

  const long long HW = (long long)H * W;
  const int cs = C / 2;  // voxel stride in bf162 units
  if (active) {
    for (long long col = (long long)blockIdx.x * WARPS + warp; col < n_cols;
         col += (long long)gridDim.x * WARPS) {
      const int xx = (int)(col % W);
      const int y = (int)((col / W) % H);
      const long long b = col / HW;
      const __nv_bfloat162* xb =
          reinterpret_cast<const __nv_bfloat162*>(x + b * D * HW * C + c0);
      const __nv_bfloat162* gb =
          reinterpret_cast<const __nv_bfloat162*>(g + b * D * HW * C + c0);
      const long long at = ((long long)y * W + xx) * cs;  // this column at z = 0
      // g at planes zi - 1 (gm), zi (g0), zi + 1 (gp); 0 outside the volume
      float2 gm = make_float2(0.f, 0.f);
      float2 g0 = __bfloat1622float2(__ldg(gb + at));
      for (int zi = 0; zi < D; ++zi) {
        const float2 gp = zi + 1 < D ? __bfloat1622float2(__ldg(gb + at + (zi + 1) * HW * cs))
                                     : make_float2(0.f, 0.f);
        a0[27] += g0.x;
        a1[27] += g0.y;
        // x at plane zi pairs with g at z = zi + 1 (dz = 0), zi (dz = 1)
        // and zi - 1 (dz = 2): x[z + dz - 1] * g[z]
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int yy = y + dy - 1;
          if (yy < 0 || yy >= H) continue;
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const int xn = xx + dx - 1;
            if (xn < 0 || xn >= W) continue;
            const float2 v = __bfloat1622float2(
                __ldg(xb + (((long long)zi * H + yy) * W + xn) * cs));
            const int k = dy * 3 + dx;
            a0[k] = fmaf(v.x, gp.x, a0[k]);
            a1[k] = fmaf(v.y, gp.y, a1[k]);
            a0[9 + k] = fmaf(v.x, g0.x, a0[9 + k]);
            a1[9 + k] = fmaf(v.y, g0.y, a1[9 + k]);
            a0[18 + k] = fmaf(v.x, gm.x, a0[18 + k]);
            a1[18 + k] = fmaf(v.y, gm.y, a1[18 + k]);
          }
        }
        gm = g0;
        g0 = gp;
      }
    }
  }
  __syncthreads();
  // reduce over the block's warps in shared memory, then one atomic per
  // (block, tap, channel)
  if (active) {
#pragma unroll
    for (int k = 0; k < TAPS; ++k) {
      atomicAdd(&red[k][2 * lane], a0[k]);
      atomicAdd(&red[k][2 * lane + 1], a1[k]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.y * PAIRS + threadIdx.x; i < TAPS * 2 * PAIRS; i += PAIRS * WARPS) {
    const int k = i / (2 * PAIRS), c = blockIdx.y * 2 * PAIRS + i % (2 * PAIRS);
    if (c < C) atomicAdd(out + (long long)k * C + c, (&red[0][0])[i]);
  }
}

}  // namespace

// x, g (B,D,H,W,C) bf16 channels-last; out (28, C) f32, ZEROED by the
// caller, receives dk in rows 0..26 ((dz,dy,dx) order) and db in row 27;
// C % 8 == 0.  Returns a CUDA error code, 0 on success.
extern "C" int depthwise3_grads_bf16(const void* x, const void* g, void* out, int B, int D,
                                     int H, int W, int C, void* stream) {
  if (C <= 0 || C % 8 || B <= 0 || D <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const long long n_cols = (long long)B * H * W;
  const int chunks = (C + 2 * PAIRS - 1) / (2 * PAIRS);
  // ~8 blocks of 256 threads per SM over 132 SMs in all, so the partial
  // sums leave through ~1K x 28 x 64 atomics whatever the volume
  long long bx = (1056 + chunks - 1) / chunks;
  const long long need = (n_cols + WARPS - 1) / WARPS;
  if (bx > need) bx = need;
  const dim3 grid((unsigned)bx, (unsigned)chunks);
  depthwise3_grads_kernel<<<grid, dim3(PAIRS, WARPS), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g),
      static_cast<float*>(out), D, H, W, C, n_cols);
  return (int)cudaGetLastError();
}
