// K9 gather_windows and K10 scatter_cores: the sliding-window engine's data
// movement, each as one launch per batch.
//
// Replaces: mica_tpu/ops/window_dma.py `gather_windows_dma` (K9) and
// `scatter_cores_dma` (K10).
//
// K9 copies n w^3 windows of the padded f32 map (and of the packed AF words,
// when given) at int32 (x, y, z) starts read from device memory into stacked
// (n, w, w, w) outputs.  K10 writes the first n_valid of n core blocks, bb
// and ca (n, c, c, c) and aa (n, c, c, c, A), into the volumes (X, Y, Z) and
// (X, Y, Z, A) in place at the same kind of starts; entries at index >=
// n_valid are neither read nor written.  Cores tile the volume, so blocks
// never write the same address.
//
// Bound on the card: bytes (no arithmetic; every word is read once and
// written once).  Design: the innermost axis is contiguous (w words of a
// window row, c words of a bb/ca core row, c*A words of an aa row), so a
// block takes one x-plane of one window or core and a quarter of its rows
// and moves each row with 16-byte accesses when both row pointers and both
// row strides are 16-byte aligned, with 4-byte accesses otherwise.  The
// choice is made per block from the addresses it really has, so any start,
// extent and size is copied right.  Both element types are 32 bits wide and
// are moved as words.  A start that would leave its volume is skipped whole:
// the kernel never touches memory outside the arrays it was given.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROW_SPLIT = 4;  // blocks sharing one x-plane, rows interleaved

// Rows part, part + ROW_SPLIT, ... of `rows` rows of `row_words` words.
__device__ __forceinline__ void copy_rows(const uint32_t* __restrict__ src, long long src_stride,
                                          uint32_t* __restrict__ dst, long long dst_stride,
                                          int rows, int row_words, int part) {
  const int mine = (rows - part + ROW_SPLIT - 1) / ROW_SPLIT;
  if (mine <= 0) return;
  src += (long long)part * src_stride;
  dst += (long long)part * dst_stride;
  src_stride *= ROW_SPLIT;
  dst_stride *= ROW_SPLIT;
  const bool vec = (((long long)row_words | src_stride | dst_stride) & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  if (vec) {
    const int rv = row_words >> 2;
    for (int idx = threadIdx.x; idx < mine * rv; idx += THREADS) {
      const int r = idx / rv, v = idx - r * rv;
      reinterpret_cast<uint4*>(dst + r * dst_stride)[v] =
          reinterpret_cast<const uint4*>(src + r * src_stride)[v];
    }
  } else {
    for (int idx = threadIdx.x; idx < mine * row_words; idx += THREADS) {
      const int r = idx / row_words, v = idx - r * row_words;
      dst[r * dst_stride + v] = src[r * src_stride + v];
    }
  }
}

__device__ __forceinline__ bool inside(int x0, int y0, int z0, int size, int X, int Y, int Z) {
  return x0 >= 0 && y0 >= 0 && z0 >= 0 && x0 <= X - size && y0 <= Y - size && z0 <= Z - size;
}

__global__ void __launch_bounds__(THREADS)
gather_windows_kernel(const uint32_t* __restrict__ map, const uint32_t* __restrict__ af,
                      const int* __restrict__ starts, uint32_t* __restrict__ wins,
                      uint32_t* __restrict__ afs, int X, int Y, int Z, int w) {
  const int i = blockIdx.x / w, lx = blockIdx.x - i * w;
  const int x0 = starts[3 * i], y0 = starts[3 * i + 1], z0 = starts[3 * i + 2];
  if (!inside(x0, y0, z0, w, X, Y, Z)) return;
  const long long src = ((long long)(x0 + lx) * Y + y0) * Z + z0;
  const long long dst = ((long long)i * w + lx) * w * w;
  copy_rows(map + src, Z, wins + dst, w, w, w, blockIdx.y);
  if (af != nullptr) copy_rows(af + src, Z, afs + dst, w, w, w, blockIdx.y);
}

__global__ void __launch_bounds__(THREADS)
scatter_cores_kernel(const uint32_t* __restrict__ bb_c, const uint32_t* __restrict__ ca_c,
                     const uint32_t* __restrict__ aa_c, uint32_t* __restrict__ bb_v,
                     uint32_t* __restrict__ ca_v, uint32_t* __restrict__ aa_v,
                     const int* __restrict__ starts, int X, int Y, int Z, int c, int A) {
  const int i = blockIdx.x / c, lx = blockIdx.x - i * c;
  const int x0 = starts[3 * i], y0 = starts[3 * i + 1], z0 = starts[3 * i + 2];
  if (!inside(x0, y0, z0, c, X, Y, Z)) return;
  const long long src = ((long long)i * c + lx) * c * c;
  const long long dst = ((long long)(x0 + lx) * Y + y0) * Z + z0;
  copy_rows(bb_c + src, c, bb_v + dst, Z, c, c, blockIdx.y);
  copy_rows(ca_c + src, c, ca_v + dst, Z, c, c, blockIdx.y);
  copy_rows(aa_c + src * A, (long long)c * A, aa_v + dst * A, (long long)Z * A, c, c * A,
            blockIdx.y);
}

}  // namespace

// map, af (or null): (X, Y, Z) 32-bit words; starts: (n, 3) int32 on the
// device; wins, afs (or null): (n, w, w, w).  Returns a CUDA error code.
extern "C" int gather_windows_u32(const void* map, const void* af, const void* starts, void* wins,
                                  void* afs, int n, int X, int Y, int Z, int w, void* stream) {
  if (n <= 0 || w <= 0 || X < w || Y < w || Z < w || (af == nullptr) != (afs == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((long long)n * w > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)(n * w), ROW_SPLIT);
  gather_windows_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(map), static_cast<const uint32_t*>(af),
      static_cast<const int*>(starts), static_cast<uint32_t*>(wins), static_cast<uint32_t*>(afs),
      X, Y, Z, w);
  return (int)cudaGetLastError();
}

// Cores bb_c, ca_c (n, c, c, c) and aa_c (n, c, c, c, A); volumes bb_v, ca_v
// (X, Y, Z) and aa_v (X, Y, Z, A), all f32; starts (n, 3) int32 on the
// device.  Only the first n_valid (>= 1) cores are launched for.
extern "C" int scatter_cores_f32(const void* bb_c, const void* ca_c, const void* aa_c, void* bb_v,
                                 void* ca_v, void* aa_v, const void* starts, int n_valid, int X,
                                 int Y, int Z, int c, int A, void* stream) {
  if (n_valid <= 0 || c <= 0 || A <= 0 || X < c || Y < c || Z < c)
    return (int)cudaErrorInvalidValue;
  if ((long long)n_valid * c > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)(n_valid * c), ROW_SPLIT);
  scatter_cores_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bb_c), static_cast<const uint32_t*>(ca_c),
      static_cast<const uint32_t*>(aa_c), static_cast<uint32_t*>(bb_v),
      static_cast<uint32_t*>(ca_v), static_cast<uint32_t*>(aa_v), static_cast<const int*>(starts),
      X, Y, Z, c, A);
  return (int)cudaGetLastError();
}
