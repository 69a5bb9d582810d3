// K13 scale2: y = x * 2 over a contiguous bf16 tensor, whatever its shape.
//
// Replaces: scripts/probe_layout_boundary.py `copy_kernel`, launched by
// `pallas_scale_bdhwc` on (B, D, H, W, C) and by `pallas_scale_dhwbc` on
// the transposed (D, H, W, B, C).  Both of the probe's layouts are
// contiguous tensors here, so one flat pass serves both.
//
// Doubling is exact in bf16 (the exponent goes up by one; the largest
// finite values go to infinity, as the eager bf16 product does), so the
// result equals the plain version to the bit.
//
// Bound on the card: bytes (one read and one write of each element, one
// multiply).  Design: a grid-stride loop over 16-byte words (8 elements)
// when both pointers are 16-byte aligned, and one element at a time for
// the tail of fewer than 8 elements, or for everything when a pointer is
// not aligned (a contiguous view can start at any element).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ __nv_bfloat162 twice(__nv_bfloat162 v) {
  float2 f = __bfloat1622float2(v);
  return __floats2bfloat162_rn(2.0f * f.x, 2.0f * f.y);
}

// One launch: the 16-byte words first (when `vec`), then the elements left.
__global__ void __launch_bounds__(THREADS)
scale2_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ y, long long n,
              bool vec) {
  const long long stride = (long long)gridDim.x * THREADS;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long n_vec = n / 8;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    uint4* yv = reinterpret_cast<uint4*>(y);
    for (long long i = tid; i < n_vec; i += stride) {
      uint4 v = xv[i];
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int k = 0; k < 4; ++k) h[k] = twice(h[k]);
      yv[i] = v;
    }
    done = n_vec * 8;
  }
  for (long long i = done + tid; i < n; i += stride)
    y[i] = __float2bfloat16_rn(2.0f * __bfloat162float(x[i]));
}

unsigned blocks_for(long long work) {
  // enough blocks to fill 132 SMs several times over; the loop does the rest
  const long long cap = 132LL * 16;
  long long b = (work + THREADS - 1) / THREADS;
  return (unsigned)(b < 1 ? 1 : (b > cap ? cap : b));
}

}  // namespace

// x, y: n bf16 elements each, in separate buffers.  Returns a CUDA error code.
extern "C" int scale2_bf16(const void* x, void* y, long long n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const bool vec = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  scale2_kernel<<<blocks_for(vec ? n / 8 + 1 : n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), n, vec);
  return (int)cudaGetLastError();
}
