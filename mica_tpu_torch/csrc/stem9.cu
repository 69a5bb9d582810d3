// K8: the multi-scale input stem, four Cin=1 SAME convs (k = 3/5/7/9, zero-
// embedded in one 9x9x9 kernel) + bias, bf16 in and out, f32 accumulation.
//
// Replaces: mica_tpu/ops/stem_pallas.py `stem_conv_pallas`.
//
// Bound on the card: the function's own work is the four kernels' real
// taps, (27 + 125 + 343 + 729) * C/4 MACs per voxel, against 2 bytes read
// and 2 * C written (C = 128 at base 64: 304 flop/byte, at the H100's ~295
// flop/byte ridge, so operations and bytes bound it alike).  This kernel
// multiplies the zero-embedded 9^3 taps of every channel, 2.4x that work
// (2.7x with the row padding below): the price of one uniform GEMM.
// Design: an implicit GEMM with M = voxels, N = C and K = the taps, on
// mma.sync m16n8k16 bf16 with f32 accumulators.  A block owns a 4 x 4 x 16 (z, y, x) tile of 256 voxels
// and stages the tile's halo ((4+8) x (4+8) x (16+8) inputs, zeros outside
// the volume) in shared memory once; the patch matrix is never built.  An
// m16 tile is 16 consecutive x of one (z, y), so the A fragment of a
// thread is two adjacent taps along x of two voxels: one 32-bit shared load
// each.  To keep those loads 4-byte aligned for odd x, the halo tile is
// stored twice, the second copy shifted by one element, and each (dz, dy)
// row of taps is padded from 9 to 10 so a pair never straddles two rows:
// K = 81 * 10 = 810, padded to 832 = 26 steps of 32 with zero weights.  A
// table in shared memory maps a tap pair to its offset in the halo tile.
// The (C, 832) bf16 weight (213 KB at C = 128) does not fit beside the
// tile, so it streams from L2 by 32-wide k-slices through a 3-stage
// cp.async ring, read with ldmatrix as in K1 (conv3d_stats.cu); 256 voxels
// a block keep that traffic at 256 flop per weight byte.  The epilogue adds
// the f32 bias and stores bf16.  Any D, H, W: tiles at the far faces mask
// their stores.  wgmma and TMA are left for a later, faster version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TZ = 4, TY = 4, TX = 16;
constexpr int BM = TZ * TY * TX;               // 256 voxels a block
constexpr int HALF = 4;                        // 9 / 2
constexpr int HZ = TZ + 8, HY = TY + 8, HXS = TX + 8;
constexpr int TILE = HZ * HY * HXS;            // 3456 halo elements
constexpr int COPY = TILE + 32;                // second copy 16 banks away
constexpr int ROW_TAPS = 10;                   // 9 taps of a (dz, dy) row + 1 zero
constexpr int K_REAL = 81 * ROW_TAPS;          // 810
constexpr int KP = 832;                        // padded K, 26 * 32
constexpr int BK = 32;
constexpr int LDS = BK + 8;                    // weight tile row stride, bf16
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int KSTEPS = KP / BK;

struct Params {
  const uint16_t* x;       // (B, D, H, W) bf16 bits
  const __nv_bfloat16* w;  // (C, KP): [c][(dz*9 + dy)*10 + dx], zeros elsewhere
  const float* bias;       // (C,)
  __nv_bfloat16* out;      // (B, D, H, W, C)
  int D, H, W, C;
  int tiles_z, tiles_y, tiles_x;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* smem) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BN>
constexpr int smem_bytes() {
  return 2 * COPY * 2 + (KP / 2) * 4 + STAGES * BN * LDS * 2;
}

template <int BN>
__global__ void __launch_bounds__(THREADS) stem9_kernel(Params p) {
  constexpr int NT = (BN < 64 ? BN : 64) / 8;   // n8 tiles a warp
  constexpr int WARPS_N = BN / (NT * 8);
  constexpr int WARPS_M = (THREADS / 32) / WARPS_N;
  constexpr int MT = (BM / 16) / WARPS_M;       // m16 tiles a warp

  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* sT = reinterpret_cast<uint16_t*>(smem_raw);            // 2 copies of the halo tile
  int* sOff = reinterpret_cast<int*>(smem_raw + 2 * COPY * 2);     // tap pair -> tile offset
  __nv_bfloat16* sB = reinterpret_cast<__nv_bfloat16*>(smem_raw + 2 * COPY * 2 + (KP / 2) * 4);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;

  int t = blockIdx.x;
  const int x0 = (t % p.tiles_x) * TX;
  t /= p.tiles_x;
  const int y0 = (t % p.tiles_y) * TY;
  t /= p.tiles_y;
  const int z0 = (t % p.tiles_z) * TZ;
  const int b = t / p.tiles_z;
  const int n0 = blockIdx.y * BN;

  auto load_stage = [&](int stage, int s) {
    __nv_bfloat16* b_dst = sB + stage * BN * LDS;
    for (int idx = tid; idx < BN * 4; idx += THREADS) {
      const int row = idx >> 2, ch = idx & 3;
      cp_async16(b_dst + row * LDS + ch * 8, p.w + (long long)(n0 + row) * KP + s * BK + ch * 8);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    load_stage(s, s);
    cp_async_commit();
  }

  // the halo tile, twice: sT[i] = tile[i], sT[COPY + i] = tile[i + 1]
  const uint16_t* xb = p.x + (long long)b * p.D * p.H * p.W;
  for (int idx = tid; idx < TILE; idx += THREADS) {
    const int hx = idx % HXS;
    const int r = idx / HXS;
    const int hy = r % HY, hz = r / HY;
    const int z = z0 + hz - HALF, y = y0 + hy - HALF, x = x0 + hx - HALF;
    uint16_t v = 0;
    if (z >= 0 && z < p.D && y >= 0 && y < p.H && x >= 0 && x < p.W)
      v = xb[((long long)z * p.H + y) * p.W + x];
    sT[idx] = v;
    if (idx > 0) sT[COPY + idx - 1] = v;
  }
  if (tid < 32) {
    sT[TILE + tid] = 0;
    sT[COPY + TILE - 1 + tid] = 0;
  }
  for (int pr = tid; pr < KP / 2; pr += THREADS) {
    const int k = 2 * pr;
    int off = 0;
    if (k < K_REAL) {
      const int row = k / ROW_TAPS, dx = k - row * ROW_TAPS;
      off = ((row / 9) * HY + row % 9) * HXS + dx;
    }
    sOff[pr] = off;
  }

  // A rows of this thread: voxel x = g and g + 8 of each of its (z, y) rows
  const int g = lane >> 2, c4 = lane & 3;
  const uint16_t* a_copy = sT + (g & 1) * COPY;
  int a_base[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int zy = wm * MT + i;
    a_base[i] = ((zy / TY) * HY + zy % TY) * HXS + (g & ~1);
  }

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  for (int kt = 0; kt < KSTEPS; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nk = kt + STAGES - 1;
    if (nk < KSTEPS) load_stage(nk % STAGES, nk);
    cp_async_commit();

    const __nv_bfloat16* b_s = sB + (kt % STAGES) * BN * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      const int pair = (kt * BK + kk) / 2 + c4;
      const int off0 = sOff[pair], off1 = sOff[pair + 4];
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const uint16_t* a = a_copy + a_base[i];
        af[i][0] = *reinterpret_cast<const uint32_t*>(a + off0);
        af[i][1] = *reinterpret_cast<const uint32_t*>(a + off0 + 8);
        af[i][2] = *reinterpret_cast<const uint32_t*>(a + off1);
        af[i][3] = *reinterpret_cast<const uint32_t*>(a + off1 + 8);
      }
      uint32_t bf[NT / 2][4];
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        const int row = wn * NT * 8 + j * 16 + (lane >> 4) * 8 + (lane & 7);
        const int col = kk + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(bf[j], b_s + row * LDS + col);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_bf16(acc[i][j], af[i], bf[j >> 1][(j & 1) * 2], bf[j >> 1][(j & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  // epilogue: bias in f32, one cast to bf16
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int zy = wm * MT + i;
    const int z = z0 + zy / TY, y = y0 + zy % TY;
    if (z >= p.D || y >= p.H) continue;
    const long long row0 = (((long long)b * p.D + z) * p.H + y) * p.W;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = x0 + g + 8 * h;
      if (x >= p.W) continue;
      __nv_bfloat16* o = p.out + (row0 + x) * p.C + n0 + wn * NT * 8 + c4 * 2;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = n0 + wn * NT * 8 + j * 8 + c4 * 2;
        *reinterpret_cast<__nv_bfloat162*>(o + j * 8) = __floats2bfloat162_rn(
            acc[i][j][2 * h] + p.bias[col], acc[i][j][2 * h + 1] + p.bias[col + 1]);
      }
    }
  }
}

template <int BN>
int launch(const Params& p, int B, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(stem9_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes<BN>());
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const long long blocks = (long long)B * p.tiles_z * p.tiles_y * p.tiles_x;
  if (blocks > 0x7fffffffLL || p.C / BN > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)blocks, (unsigned)(p.C / BN));
  stem9_kernel<BN><<<grid, THREADS, smem_bytes<BN>(), stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, D, H, W) bf16; w (C, 832) bf16 in the packed tap order above; bias
// (C,) f32; out (B, D, H, W, C) bf16; C a multiple of 32.  Returns a CUDA
// error code, 0 on success.
extern "C" int stem9_bf16(const void* x, const void* w, const void* bias, void* out, int B, int D,
                          int H, int W, int C, void* stream) {
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 32)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const uint16_t*>(x);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.D = D;
  p.H = H;
  p.W = W;
  p.C = C;
  p.tiles_z = (D + TZ - 1) / TZ;
  p.tiles_y = (H + TY - 1) / TY;
  p.tiles_x = (W + TX - 1) / TX;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % 128 == 0) return launch<128>(p, B, s);
  if (C % 64 == 0) return launch<64>(p, B, s);
  return launch<32>(p, B, s);
}
