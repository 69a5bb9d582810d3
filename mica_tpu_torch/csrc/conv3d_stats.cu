// K1: 3x3x3 SAME stride-1 convolution + bias over the channel concat of
// 1-3 channels-last bf16 operands, with the InstanceNorm sufficient
// statistics (per-(batch, channel) sum of y and y^2 of the f32 value before
// the bf16 cast) reduced in the epilogue.
//
// Replaces: mica_tpu/ops/wino_pallas.py `_wino_T` (kernel `_make_kernel`),
// as reached by `wino_conv3d_in_relu_pallas` (stats on) and
// `wino_conv3d_pallas_padded` (stats and bias off, the heads' conv1).
//
// Bound on the card: operations.  At the main path's shapes the work is
// 2 * B*D*H*W * 27*Ci * Co flops over ~2*(Ci+Co) bytes per voxel, far
// above the H100's ~295 flop/byte ridge, so the tensor cores are the
// limit.  Design: an implicit GEMM with M = B*D*H*W output voxels,
// N = Co, K = 27*sum(Ci).  Each 32-wide K step lies inside one tap and one
// operand (every Ci is a multiple of 32), so the A-tile loader picks the
// operand pointer from the channel index and the concat is never built;
// zero padding at the volume edges comes from cp.async's zero fill.  Tiles
// of 128 x BN x 32 go through a 3-stage cp.async ring in shared memory
// (rows padded to 80 bytes so ldmatrix is free of bank conflicts) into
// mma.sync m16n8k16 bf16 with f32 accumulators.  The epilogue adds the
// bias in f32, stores bf16, and reduces the statistics with warp shuffles,
// a shared-memory sum per block and one atomicAdd per (block, channel);
// the order of those atomics varies between runs.  wgmma and TMA are left
// for a later, faster version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BK = 32;
constexpr int LDS = BK + 8;  // shared-memory row stride, bf16 elements
constexpr int STAGES = 3;
constexpr int THREADS = 256;

struct Params {
  const __nv_bfloat16* x[3];
  int ci[3];
  int ci_tot;
  const __nv_bfloat16* w;  // (Co, 27 * ci_tot): [co][tap][ci]
  const float* bias;       // (Co,) or null
  __nv_bfloat16* out;      // (M, Co)
  float* stats;            // (B, 2, Co) or null
  int D, H, W, Co;
  int M;
  int ksteps;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
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
__global__ void __launch_bounds__(THREADS) conv3d_stats_kernel(Params p) {
  constexpr int WARPS_N = BN / 32;
  constexpr int WARPS_M = (THREADS / 32) / WARPS_N;
  constexpr int WM = BM / WARPS_M;
  constexpr int MT = WM / 16;  // m16 tiles per warp
  constexpr int NT = 4;        // n8 tiles per warp (warp width 32)

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sB = sA + STAGES * BM * LDS;
  __shared__ float s_stats[2][BN];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;

  const int n_tiles = p.Co / BN;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const long long m0 = (long long)(blockIdx.x / n_tiles) * BM;

  const int HW = p.H * p.W;
  const int DHW = p.D * HW;
  const int K = 27 * p.ci_tot;
  const int kc = p.ci_tot / BK;

  if (tid < BN) {
    s_stats[0][tid] = 0.f;
    s_stats[1][tid] = 0.f;
  }

  // this thread's two A rows (voxels) and its 16-byte chunk within a row
  const int chunk = tid & 3;
  long long vox[2];
  int vz[2], vy[2], vx[2];
  bool vok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    long long m = m0 + (tid >> 2) + r * 64;
    vok[r] = m < p.M;
    long long mm = vok[r] ? m : 0;
    vox[r] = mm;
    int rem = (int)(mm % DHW);
    vz[r] = rem / HW;
    vy[r] = (rem / p.W) % p.H;
    vx[r] = rem % p.W;
  }

  auto load_stage = [&](int stage, int s) {
    const int tap = s / kc;
    int c = (s % kc) * BK;
    const int dz = tap / 9 - 1, dy = (tap / 3) % 3 - 1, dx = tap % 3 - 1;
    int part = 0;
    if (c >= p.ci[0]) {
      c -= p.ci[0];
      part = 1;
      if (c >= p.ci[1]) {
        c -= p.ci[1];
        part = 2;
      }
    }
    const __nv_bfloat16* xp = p.x[part];
    const int cip = p.ci[part];
    const long long shift = (long long)dz * HW + dy * p.W + dx;
    __nv_bfloat16* a_dst = sA + stage * BM * LDS;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int z = vz[r] + dz, y = vy[r] + dy, x = vx[r] + dx;
      const bool ok = vok[r] && z >= 0 && z < p.D && y >= 0 && y < p.H && x >= 0 && x < p.W;
      const __nv_bfloat16* src = ok ? xp + (vox[r] + shift) * cip + c + chunk * 8 : xp;
      cp_async16(a_dst + ((tid >> 2) + r * 64) * LDS + chunk * 8, src, ok);
    }
    __nv_bfloat16* b_dst = sB + stage * BN * LDS;
    for (int idx = tid; idx < BN * 4; idx += THREADS) {
      const int row = idx >> 2, ch = idx & 3;
      const __nv_bfloat16* src = p.w + (long long)(n0 + row) * K + (long long)s * BK + ch * 8;
      cp_async16(b_dst + row * LDS + ch * 8, src, true);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < p.ksteps) load_stage(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < p.ksteps; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nk = kt + STAGES - 1;
    if (nk < p.ksteps) load_stage(nk % STAGES, nk);
    cp_async_commit();

    const __nv_bfloat16* a_s = sA + (kt % STAGES) * BM * LDS;
    const __nv_bfloat16* b_s = sB + (kt % STAGES) * BN * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int row = wm * WM + i * 16 + (lane & 15);
        const int col = kk + (lane >> 4) * 8;
        ldmatrix_x4(af[i], a_s + row * LDS + col);
      }
      uint32_t bf[NT / 2][4];
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        const int row = wn * 32 + j * 16 + (lane >> 4) * 8 + (lane & 7);
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

  // epilogue: bias in f32, bf16 store, statistics of the f32 value
  const long long m_last = (m0 + BM < p.M ? m0 + BM : (long long)p.M) - 1;
  const bool uniform = (m0 / DHW) == (m_last / DHW);
  const int b_blk = (int)(m0 / DHW);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + wn * 32 + j * 8 + (lane & 3) * 2;
    const float b0 = p.bias ? p.bias[col] : 0.f;
    const float b1 = p.bias ? p.bias[col + 1] : 0.f;
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = m0 + wm * WM + i * 16 + (lane >> 2) + h * 8;
        if (row >= p.M) continue;
        const float v0 = acc[i][j][2 * h] + b0;
        const float v1 = acc[i][j][2 * h + 1] + b1;
        *reinterpret_cast<__nv_bfloat162*>(p.out + row * p.Co + col) = __floats2bfloat162_rn(v0, v1);
        if (p.stats) {
          if (uniform) {
            s1[0] += v0;
            s1[1] += v1;
            s2[0] += v0 * v0;
            s2[1] += v1 * v1;
          } else {
            float* st = p.stats + (row / DHW) * 2 * p.Co;
            atomicAdd(st + col, v0);
            atomicAdd(st + col + 1, v1);
            atomicAdd(st + p.Co + col, v0 * v0);
            atomicAdd(st + p.Co + col + 1, v1 * v1);
          }
        }
      }
    }
    if (p.stats && uniform) {
      // lanes sharing (lane & 3) hold the same two columns
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          s1[q] += __shfl_xor_sync(0xffffffffu, s1[q], off);
          s2[q] += __shfl_xor_sync(0xffffffffu, s2[q], off);
        }
      }
      if (lane < 4) {
        const int lc = col - n0;
        atomicAdd(&s_stats[0][lc], s1[0]);
        atomicAdd(&s_stats[0][lc + 1], s1[1]);
        atomicAdd(&s_stats[1][lc], s2[0]);
        atomicAdd(&s_stats[1][lc + 1], s2[1]);
      }
    }
  }
  if (p.stats && uniform) {
    __syncthreads();
    if (tid < BN) {
      float* st = p.stats + (long long)b_blk * 2 * p.Co;
      atomicAdd(st + n0 + tid, s_stats[0][tid]);
      atomicAdd(st + p.Co + n0 + tid, s_stats[1][tid]);
    }
  }
}

template <int BN>
int launch(const Params& p, cudaStream_t stream) {
  const int smem = STAGES * (BM + BN) * LDS * (int)sizeof(__nv_bfloat16);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(conv3d_stats_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const long long m_tiles = ((long long)p.M + BM - 1) / BM;
  const long long blocks = m_tiles * (p.Co / BN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  conv3d_stats_kernel<BN><<<(unsigned)blocks, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Channels-last bf16 parts x0..x2 (B,D,H,W,c_k), c_k = 0 for an absent
// part; w (Co, 27*sum c_k) bf16; bias (Co,) f32 or null; out (B,D,H,W,Co)
// bf16; stats (B,2,Co) f32, zeroed by the caller, or null.  Returns a CUDA
// error code, 0 on success.
extern "C" int conv3d_stats_bf16(const void* x0, const void* x1, const void* x2, int c0, int c1,
                                 int c2, const void* w, const void* bias, void* out, void* stats,
                                 int B, int D, int H, int W, int Co, void* stream) {
  Params p;
  p.x[0] = static_cast<const __nv_bfloat16*>(x0);
  p.x[1] = static_cast<const __nv_bfloat16*>(x1);
  p.x[2] = static_cast<const __nv_bfloat16*>(x2);
  p.ci[0] = c0;
  p.ci[1] = c1;
  p.ci[2] = c2;
  p.ci_tot = c0 + c1 + c2;
  if (c0 <= 0 || c0 % BK || c1 % BK || c2 % BK || Co % 32 || Co <= 0)
    return (int)cudaErrorInvalidValue;
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.stats = static_cast<float*>(stats);
  p.D = D;
  p.H = H;
  p.W = W;
  p.Co = Co;
  const long long M = (long long)B * D * H * W;
  if (M <= 0 || M > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.M = (int)M;
  p.ksteps = 27 * p.ci_tot / BK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Co % 128 == 0) return launch<128>(p, s);
  if (Co % 64 == 0) return launch<64>(p, s);
  return launch<32>(p, s);
}
