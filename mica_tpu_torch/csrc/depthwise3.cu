// K3: depthwise 3x3x3 SAME convolution + bias on channels-last bf16,
// f32 accumulation, bf16 output.
//
// Replaces: mica_tpu/ops/depthwise_pallas.py `depthwise_conv3_pallas`
// (kernel `_kernel`), the DualAttention local conv.
//
// Bound on the card: bytes.  27 multiply-adds per element against one
// 2-byte read and one 2-byte write is ~13 flop/byte, far below the H100's
// ridge, so device memory is the limit.  Design: each thread owns two
// consecutive channels (one bf16x2 word; a warp reads 128 contiguous
// bytes of one voxel) of one (b, y, x) column, keeps its 2 x 27 taps and
// bias in registers, and slides along z: each input plane's 3 x 3
// neighbourhood is read once and feeds the three output planes it
// touches, so every input element is fetched 9 times from L1/L2, not 27
// (the first version's one-voxel threads read 27 and ran at ~5 % of the
// bound).  Accumulation is in f32.  Shared-memory tiling of the (y, x)
// halo is left for a later PR.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    depthwise3_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ taps,
                      const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int D,
                      int H, int W, int C, long long n_threads) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_threads) return;
  const int pairs = C / 2;
  const int c0 = (int)(t % pairs) * 2;
  long long r = t / pairs;
  const int xx = (int)(r % W);
  r /= W;
  const int y = (int)(r % H);
  const long long b = r / H;

  // this thread's two channels: 27 taps each and the bias, in registers
  float w0[27], w1[27];
#pragma unroll
  for (int k = 0; k < 27; ++k) {
    w0[k] = taps[k * C + c0];
    w1[k] = taps[k * C + c0 + 1];
  }
  const float b0 = bias[c0], b1 = bias[c0 + 1];

  const long long HW = (long long)H * W;
  const __nv_bfloat162* xb = reinterpret_cast<const __nv_bfloat162*>(x + b * D * HW * C + c0);
  __nv_bfloat162* ob = reinterpret_cast<__nv_bfloat162*>(out + b * D * HW * C + c0);
  const int cs = C / 2;  // voxel stride in bf162 units

  // sliding window along z: plane zi feeds out[zi-1] (dz=+1 taps),
  // out[zi] (dz=0) and out[zi+1] (dz=-1); a*_0/1/2 hold those three
  float a00 = b0, a01 = b1, a10 = b0, a11 = b1, a20 = b0, a21 = b1;
  for (int zi = -1; zi <= D; ++zi) {
    if (zi >= 0 && zi < D) {
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
          a00 = fmaf(v.x, w0[18 + k], a00);
          a01 = fmaf(v.y, w1[18 + k], a01);
          a10 = fmaf(v.x, w0[9 + k], a10);
          a11 = fmaf(v.y, w1[9 + k], a11);
          a20 = fmaf(v.x, w0[k], a20);
          a21 = fmaf(v.y, w1[k], a21);
        }
      }
    }
    if (zi >= 1) ob[(((long long)(zi - 1) * H + y) * W + xx) * cs] = __floats2bfloat162_rn(a00, a01);
    a00 = a10;
    a01 = a11;
    a10 = a20;
    a11 = a21;
    a20 = b0;
    a21 = b1;
  }
}

}  // namespace

// x, out (B,D,H,W,C) bf16 channels-last; taps (27, C) f32 in (dz,dy,dx)
// order; bias (C,) f32; C % 8 == 0.  Returns a CUDA error code, 0 on
// success.
extern "C" int depthwise3_bf16(const void* x, const void* taps, const void* bias, void* out, int B,
                               int D, int H, int W, int C, void* stream) {
  if (C <= 0 || C % 8) return (int)cudaErrorInvalidValue;
  const long long n_threads = (long long)B * H * W * (C / 2);
  const long long blocks = (n_threads + THREADS - 1) / THREADS;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  depthwise3_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(taps),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), D, H, W, C, n_threads);
  return (int)cudaGetLastError();
}
