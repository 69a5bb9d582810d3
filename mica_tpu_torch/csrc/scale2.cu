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
// multiply).  Design: one 16-byte word (8 elements) a thread, a grid sized
// to the work (one block per 256 words, no stride loop), 32-bit offsets
// inside a block, default caching.  The first version (a grid-stride loop
// capped at 132 x 16 blocks, 64-bit index arithmetic) ran 6 % behind
// `torch.mul` (NVIDIA H100 80GB HBM3, 700 W; `chip_smoke.py`).  In development runs on the H100 (a probe not kept) at the
// layout probe's 1 GiB, 2 to 16 independent 16-byte loads a thread before
// any store, streaming hints (`ld.global.cs`/`st.global.cs`), an L2
// prefetch hint, and TMA bulk copies through shared memory were all a
// little slower than one word a thread, which is level with
// `torch.mul(out=)`: at this size the stream is at the card's practical
// copy rate either way.  Block 0 also takes the tail of fewer than 8
// elements.  When a pointer is not 16-byte aligned (a contiguous view can
// start at any element), a thread takes one element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t twice2(uint32_t v) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  const float2 f = __bfloat1622float2(h);
  h = __floats2bfloat162_rn(2.0f * f.x, 2.0f * f.y);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ __nv_bfloat16 twice(__nv_bfloat16 v) {
  return __float2bfloat16_rn(2.0f * __bfloat162float(v));
}

// Block i takes words [i * THREADS, (i + 1) * THREADS): 16-byte vectors
// when `vec` (block 0 also takes the tail of n % 8 elements), else elements.
__global__ void __launch_bounds__(THREADS)
    scale2_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ y, long long n,
                  bool vec) {
  const long long start = (long long)blockIdx.x * THREADS;
  const int i = threadIdx.x;
  if (vec) {
    const long long n_vec = n / 8;
    if (start + i < n_vec) {
      uint4 v = reinterpret_cast<const uint4*>(x)[start + i];
      v.x = twice2(v.x);
      v.y = twice2(v.y);
      v.z = twice2(v.z);
      v.w = twice2(v.w);
      reinterpret_cast<uint4*>(y)[start + i] = v;
    }
    if (blockIdx.x == 0 && i < n % 8) y[n_vec * 8 + i] = twice(x[n_vec * 8 + i]);
    return;
  }
  if (start + i < n) y[start + i] = twice(x[start + i]);
}

}  // namespace

// x, y: n bf16 elements each, in separate buffers.  Returns a CUDA error code.
extern "C" int scale2_bf16(const void* x, void* y, long long n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const bool vec = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const long long words = vec ? n / 8 : n;
  const long long blocks = words > 0 ? (words + THREADS - 1) / THREADS : 1;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  scale2_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), n, vec);
  return (int)cudaGetLastError();
}
