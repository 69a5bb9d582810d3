// K8: the multi-scale input stem, four Cin=1 SAME convs (k = 3/5/7/9, C/4
// output channels each) + bias, bf16 in and out, f32 accumulation.
//
// Replaces: mica_tpu/ops/stem_pallas.py `stem_conv_pallas` (which runs the
// four kernels zero-embedded in one 9x9x9).
//
// Bound on the card: the function's own work is the four kernels' real
// taps, (27 + 125 + 343 + 729) * C/4 MACs per voxel, against 2 bytes read
// and 2 * C written (C = 128 at base 64: 304 flop/byte, at the H100's ~295
// flop/byte ridge, so operations and bytes bound it alike).
//
// Design, for Hopper (sm_90a):
//   * Four GEMMs with the real taps only, one per kernel size k: M =
//     voxels, N = the group's C/4 channels (NG a pass: 32, 16 or 8; wider
//     groups take several CTAs' passes), K = k^2 rows (dz, dy) of k + 1 taps
//     (the last one zero, so a tap pair never straddles two rows), padded
//     to a multiple of 16: 48 + 160 + 400 + 816 = 1424 taps, 1.16x the real
//     1224 (the zero-embedded 9^3 form took 3328).
//   * wgmma.mma_async m64nNGk16, A from registers, B from shared memory.
//     The packed weight of a pass (NG x 1424 bf16, 91 KB at NG 32) is laid
//     out in global memory exactly as wgmma reads it (no swizzle: 8 x 16-byte
//     core matrices, K-adjacent 128 B apart, N-adjacent 256 B apart) and is
//     loaded once per persistent CTA by bulk copies that complete on an
//     mbarrier.  A warpgroup's 64 rows are one (z, y) row of 16 x per warp,
//     4 (z, y) rows a warpgroup, 4 warpgroups a 4 x 4 x 16 tile of 256
//     voxels.  A warp's A fragment has mma.sync m16n8k16's layout, so a
//     register is a tap pair along x of one voxel: one 32-bit shared load
//     from the tile's halo.  The halo is kept twice, the second copy shifted
//     one element (and 8 banks away: the fewest conflicts where a
//     lane quad's pairs cross a tap row), so every pair is a 4-byte-aligned
//     load whatever the parity of x + tap.  A table in shared memory gives
//     each lane the halo offsets of its pairs, four k16 steps in one 16-byte
//     load.  A fragments rotate: the next step's pairs load while the
//     current wgmma runs.
//   * The halo ((4+8) x (4+8) x 32 inputs, x from x0 - 8, zeros outside the
//     volume = SAME padding) comes by 16-byte cp.async with zero fill into a
//     2-slot ring, the next tile's while this one computes (plain 2-byte
//     loads where W % 8 or x's address rules 16-byte copies out).  A TMA
//     map cannot take x: W * 2 bytes need not be a multiple of 16.
//   * Epilogue per group: bias in f32, one cast to bf16, into a shared
//     staging tile (z, y, x, NG) swizzled as the TMA store reads it (64 B
//     rows at NG 32: a quad's 16 bytes land in distinct banks); then TMA
//     stores of the four groups' boxes, which clip the far faces.  The
//     stores drain while the next tile's wgmmas run; the staging tile is
//     rewritten only after they have read it.
//   * Persistent: one CTA an SM walks the tiles (x fastest), each CTA on one
//     N pass.  The plan (tile, ring, shared bytes, grid) is computed in
//     Python (`mica_tpu_torch/ops/stem.py`, `k8_plan`) and checked here.  A
//     barrier wait of over 4 s traps (a launch error) instead of hanging.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma5d.cuh"

namespace {

using namespace tma5d;

constexpr int TZ = 4, TY = 4, TX = 16;        // a tile: 256 voxels
constexpr int WGS = 4;                        // warpgroups, one m64 slice each
constexpr int THREADS = 128 * WGS;
constexpr int HZ = TZ + 8, HY = TY + 8, HXS = 32;  // halo, x from x0 - 8
constexpr int HALO = HZ * HY * HXS;           // 4608 elements
constexpr int COPY = HALO + 16;               // 9248 B: the second copy 8 banks on
constexpr int DEPTH = 2;                      // A fragments in flight a warpgroup
constexpr int SLOT = 2 * COPY;                // elements of a ring slot
constexpr int K_TOTAL = 1424;
constexpr int TABLE_WORDS = 4 * (4 + 12 + 28 + 52);  // [group][c4][steps rounded to 4]

__host__ __device__ constexpr int kpad(int k) { return (k * k * (k + 1) + 15) / 16 * 16; }
__host__ __device__ constexpr int ksteps(int k) { return kpad(k) / 16; }
__host__ __device__ constexpr int ksteps4(int k) { return (ksteps(k) + 3) / 4 * 4; }
// group i = 0..3 has k = 3 + 2i; its first tap in the packed K and its first
// table word
__host__ __device__ constexpr int kbase(int i) {
  return i <= 0 ? 0 : i == 1 ? 48 : i == 2 ? 208 : i == 3 ? 608 : K_TOTAL;
}
__host__ __device__ constexpr int tbase(int i) {
  return i <= 0 ? 0 : i == 1 ? 16 : i == 2 ? 64 : i == 3 ? 176 : TABLE_WORDS;
}
static_assert(kbase(1) == kpad(3) && kbase(2) == kbase(1) + kpad(5) &&
                  kbase(3) == kbase(2) + kpad(7) && kbase(4) == kbase(3) + kpad(9),
              "packed K of the four groups");
static_assert(tbase(1) == 4 * ksteps4(3) && tbase(2) == tbase(1) + 4 * ksteps4(5) &&
                  tbase(3) == tbase(2) + 4 * ksteps4(7) && tbase(4) == tbase(3) + 4 * ksteps4(9),
              "offset table of the four groups");

// Shared memory, in bytes from a 1024-aligned base, for NG channels a pass.
__host__ __device__ constexpr int stage_bytes(int ng) { return TZ * TY * TX * ng * 2; }
__host__ __device__ constexpr int off_stage(int ng) { return K_TOTAL * ng * 2; }
__host__ __device__ constexpr int off_halo(int ng) { return off_stage(ng) + 4 * stage_bytes(ng); }
__host__ __device__ constexpr int off_table(int ng) { return off_halo(ng) + 2 * SLOT * 2; }
__host__ __device__ constexpr int off_bias(int ng) { return off_table(ng) + TABLE_WORDS * 4; }
__host__ __device__ constexpr int off_bar(int ng) { return off_bias(ng) + 4 * ng * 4; }
__host__ __device__ constexpr int smem_bytes(int ng) { return 1024 + off_bar(ng) + 8; }

struct Params {
  const uint16_t* x;       // (B, D, H, W) bf16 bits
  const uint8_t* w;        // packed: (passes, 1424 * NG) bf16, see `pack_weight`
  const float* bias;       // (C,)
  int B, D, H, W, C, cg;   // cg = C / 4
  int passes;              // cg / NG
  int tiles_x, tiles_y, tiles_z, n_tiles;
  int aligned;             // 16-byte cp.async of the halo allowed
};

// The halo offset (elements) of tap kk of a k^3 kernel for a voxel at the
// tile's origin, less the group's parity (k = 3, 7 offsets are odd): even.
__device__ __forceinline__ int tap_offset(int k, int kk) {
  const int h = (k - 1) / 2;
  if (kk >= k * k * (k + 1)) kk = 0;  // the zero-weight padding of K
  const int row = kk / (k + 1), dx = kk - row * (k + 1);
  const int dz = row / k, dy = row - dz * k;
  return ((4 - h + dz) * HY + (4 - h + dy)) * HXS + (8 - h + dx) - (h & 1);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma descriptor of a K-major, unswizzled B tile: core matrices of 8 rows
// x 16 bytes, the next K half 128 B on, the next 8 rows 256 B on.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
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

// D (64 x N, f32, registers) += A (64 x 16, registers: this warp's 16 rows
// in mma.sync m16n8k16's A layout) * B (N x 16, shared memory)^T; scale_d =
// 0 starts D from zero.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs<8>(float (&d)[4], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ uint32_t lds32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// One group's GEMM for this warpgroup's 64 voxels: `halo` is the slot's
// first copy advanced to this lane's row and copy, `tab` this lane's table
// words (two packed 16-bit pair offsets a step), `wb` the group's weight.
// DEPTH A fragments rotate: step s + DEPTH - 1 loads while the wgmma of
// step s runs, once that of step s - 1 has read its registers.
template <int K, int NG>
__device__ __forceinline__ void group_mma(float (&acc)[NG / 2], const uint16_t* halo,
                                          const uint4* tab, uint32_t wb) {
  constexpr int S = ksteps(K);
  constexpr int L = DEPTH - 1;
  uint32_t a[DEPTH][4];
  uint4 cur = tab[0];
  uint4 nxt = tab[S > 4 ? 1 : 0];
  // the A fragment of step n (steps are loaded in order)
  auto load = [&](uint32_t (&r)[4], int n) {
    if (n % 4 == 0 && n > 0) {
      cur = nxt;
      if (n / 4 + 1 < (S + 3) / 4) nxt = tab[n / 4 + 1];
    }
    const uint32_t w = word_of(cur, n % 4);
    const uint16_t* p0 = halo + (w & 0xFFFF);
    const uint16_t* p1 = halo + (w >> 16);
    r[0] = lds32(p0);
    r[1] = lds32(p0 + 8);
    r[2] = lds32(p1);
    r[3] = lds32(p1 + 8);
  };
#pragma unroll
  for (int n = 0; n < L; ++n) load(a[n], n);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    wgmma_fence();
    wgmma_rs<NG>(acc, a[s % DEPTH], b_desc(wb + s * NG * 32), s > 0 ? 1 : 0);
    wgmma_commit();
    if (s + L < S) {
      wgmma_wait<1>();
      load(a[(s + L) % DEPTH], s + L);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
}

// acc + bias -> bf16 rows of the group's staging tile, (z, y, x, NG) with
// the TMA store's swizzle (64 B rows: 16-byte chunk ^= (row >> 1) & 3;
// 32 B rows: ^= (row >> 2) & 1; 16 B rows: none).
template <int NG>
__device__ __forceinline__ void stage(const float (&acc)[NG / 2], unsigned char* st,
                                      const float* bias, int row0, int c4) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    const int sw = NG == 32 ? (r >> 1) & 3 : NG == 16 ? (r >> 2) & 1 : 0;
#pragma unroll
    for (int j = 0; j < NG / 8; ++j) {
      const float2 bv = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * c4);
      __nv_bfloat162 v = __floats2bfloat162_rn(acc[4 * j + 2 * h] + bv.x, acc[4 * j + 2 * h + 1] + bv.y);
      *reinterpret_cast<__nv_bfloat162*>(st + r * NG * 2 + ((j ^ sw) << 4) + 4 * c4) = v;
    }
  }
}

__device__ __forceinline__ void tile_origin(const Params& p, int t, int& b, int& z0, int& y0, int& x0) {
  x0 = (t % p.tiles_x) * TX;
  t /= p.tiles_x;
  y0 = (t % p.tiles_y) * TY;
  t /= p.tiles_y;
  z0 = (t % p.tiles_z) * TZ;
  b = t / p.tiles_z;
}

// The halo of tile t into the first copy of a slot: 16-byte cp.async with
// zero fill where allowed, else plain loads and stores.
__device__ __forceinline__ void load_halo(const Params& p, int t, uint16_t* dst) {
  int b, z0, y0, x0;
  tile_origin(p, t, b, z0, y0, x0);
  const uint16_t* xb = p.x + (long long)b * p.D * p.H * p.W;
  if (p.aligned) {
    for (int i = threadIdx.x; i < HZ * HY * (HXS / 8); i += THREADS) {
      const int ch = i & 3, row = i >> 2;
      const int z = z0 - 4 + row / HY, y = y0 - 4 + row % HY, x = x0 - 8 + 8 * ch;
      const bool in = z >= 0 && z < p.D && y >= 0 && y < p.H && x >= 0 && x < p.W;
      const uint16_t* src = in ? xb + ((long long)z * p.H + y) * p.W + x : p.x;
      cp_async16(smem_u32(dst + row * HXS + 8 * ch), src, in);
    }
  } else {
    for (int i = threadIdx.x; i < HALO; i += THREADS) {
      const int hx = i % HXS, row = i / HXS;
      const int z = z0 - 4 + row / HY, y = y0 - 4 + row % HY, x = x0 - 8 + hx;
      uint16_t v = 0;
      if (z >= 0 && z < p.D && y >= 0 && y < p.H && x >= 0 && x < p.W)
        v = xb[((long long)z * p.H + y) * p.W + x];
      dst[i] = v;
    }
  }
}

template <int NG>
__global__ void __launch_bounds__(THREADS, 1)
    stem9_kernel(const __grid_constant__ CUtensorMap omap, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const uint32_t s_w = smem_u32(sm);
  unsigned char* s_stage = sm + off_stage(NG);
  uint16_t* s_halo = reinterpret_cast<uint16_t*>(sm + off_halo(NG));
  uint32_t* s_tab = reinterpret_cast<uint32_t*>(sm + off_table(NG));
  float* s_bias = reinterpret_cast<float*>(sm + off_bias(NG));
  const uint32_t bar = smem_u32(sm + off_bar(NG));

  const int tid = threadIdx.x;
  const int pass = blockIdx.x % p.passes;
  const int stride = gridDim.x / p.passes;
  const int first = blockIdx.x / p.passes;

  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    // this pass's packed weight, once: one bulk copy per group
    const uint8_t* src = p.w + (long long)pass * K_TOTAL * NG * 2;
    mbar_expect_tx(bar, K_TOTAL * NG * 2);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      bulk_load(s_w + kbase(i) * NG * 2, src + kbase(i) * NG * 2, kpad(2 * i + 3) * NG * 2, bar);
  }
  for (int i = tid; i < TABLE_WORDS; i += THREADS) {
    const int gi = i < tbase(1) ? 0 : i < tbase(2) ? 1 : i < tbase(3) ? 2 : 3;
    const int k = 2 * gi + 3, s4 = ksteps4(k);
    const int c4 = (i - tbase(gi)) / s4, s = (i - tbase(gi)) % s4;
    const int o0 = tap_offset(k, 2 * (8 * s + c4)), o1 = tap_offset(k, 2 * (8 * s + c4 + 4));
    s_tab[i] = (uint32_t)o0 | ((uint32_t)o1 << 16);
  }
  for (int i = tid; i < 4 * NG; i += THREADS)
    s_bias[i] = p.bias[(i / NG) * p.cg + pass * NG + i % NG];
  // the zero tails of every copy in both slots (never loaded by cp.async)
  for (int i = tid; i < 4 * (COPY - HALO); i += THREADS)
    s_halo[(i / (COPY - HALO)) * COPY + HALO + i % (COPY - HALO)] = 0;
  if (first < p.n_tiles) load_halo(p, first, s_halo);
  cp_async_commit();
  mbar_wait(bar, 0);

  const int wg = tid >> 7, wl = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, c4 = lane & 3;
  const int zy = wg * 4 + wl;                        // this warp's (z, y) row of the tile
  const int row_off = ((zy / TY) * HY + zy % TY) * HXS;
  // lane's first copy (even parity of x + tap) and second copy (odd)
  const int lane_even = (g & 1) * COPY + (g & ~1) + row_off;
  const int lane_odd = ((g + 1) & 1) * COPY + ((g + 1) & ~1) + row_off;
  const int row0 = zy * TX + g;                      // staging row of this lane's first voxel

  float acc[NG / 2];
  int it = 0;
  for (int t = first; t < p.n_tiles; t += stride, ++it) {
    uint16_t* slot = s_halo + (it & 1) * SLOT;
    cp_async_wait_all();
    __syncthreads();
    // the second copy: element i of it is element i + 1 of the first
    for (int i = tid; i < HALO / 8; i += THREADS) {
      const uint4 v = *reinterpret_cast<const uint4*>(slot + 8 * i);
      const uint32_t nx = *reinterpret_cast<const uint32_t*>(slot + 8 * i + 8);
      uint4 o;
      o.x = __funnelshift_r(v.x, v.y, 16);
      o.y = __funnelshift_r(v.y, v.z, 16);
      o.z = __funnelshift_r(v.z, v.w, 16);
      o.w = __funnelshift_r(v.w, nx, 16);
      *reinterpret_cast<uint4*>(slot + COPY + 8 * i) = o;
    }
    __syncthreads();
    if (t + stride < p.n_tiles) load_halo(p, t + stride, s_halo + ((it + 1) & 1) * SLOT);
    cp_async_commit();

    const uint4* tab = reinterpret_cast<const uint4*>(s_tab);
    // k = 9 first: the previous tile's stores drain meanwhile
    group_mma<9, NG>(acc, slot + lane_even, tab + (tbase(3) + c4 * ksteps4(9)) / 4,
                     s_w + kbase(3) * NG * 2);
    if (tid == 0) bulk_wait_read();
    __syncthreads();
    stage<NG>(acc, s_stage + 3 * stage_bytes(NG), s_bias + 3 * NG, row0, c4);
    group_mma<7, NG>(acc, slot + lane_odd, tab + (tbase(2) + c4 * ksteps4(7)) / 4,
                     s_w + kbase(2) * NG * 2);
    stage<NG>(acc, s_stage + 2 * stage_bytes(NG), s_bias + 2 * NG, row0, c4);
    group_mma<5, NG>(acc, slot + lane_even, tab + (tbase(1) + c4 * ksteps4(5)) / 4,
                     s_w + kbase(1) * NG * 2);
    stage<NG>(acc, s_stage + 1 * stage_bytes(NG), s_bias + 1 * NG, row0, c4);
    group_mma<3, NG>(acc, slot + lane_odd, tab + (tbase(0) + c4 * ksteps4(3)) / 4,
                     s_w + kbase(0) * NG * 2);
    stage<NG>(acc, s_stage, s_bias, row0, c4);
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) {
      int b, z0, y0, x0;
      tile_origin(p, t, b, z0, y0, x0);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        tma_store_5d(&omap, smem_u32(s_stage + i * stage_bytes(NG)), i * p.cg + pass * NG, x0,
                     y0, z0, b);
    }
  }
  cp_async_wait_all();
  if (tid == 0) bulk_wait();
}

// A 5-D map over the (B, D, H, W, C) output with a (NG, TX, TY, TZ, 1) box,
// swizzled as `stage` writes it.
bool encode_out(CUtensorMap* map, void* out, int B, int D, int H, int W, int C, int ng) {
  const cuuint64_t dims[5] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)D,
                              (cuuint64_t)B};
  const cuuint64_t rowb = (cuuint64_t)C * 2;
  const cuuint64_t strides[4] = {rowb, rowb * W, rowb * W * H, rowb * W * H * D};
  const cuuint32_t es[5] = {1, 1, 1, 1, 1};
  const cuuint32_t box[5] = {(cuuint32_t)ng, TX, TY, TZ, 1};
  const CUtensorMapSwizzle sw = ng == 32   ? CU_TENSOR_MAP_SWIZZLE_64B
                                : ng == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
                                           : CU_TENSOR_MAP_SWIZZLE_NONE;
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, out, dims, strides, box, es,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NG>
int launch(const CUtensorMap& map, const Params& p, int ctas, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(stem9_kernel<NG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes(NG));
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  stem9_kernel<NG><<<ctas, THREADS, smem_bytes(NG), stream>>>(map, p);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, D, H, W) bf16; w the packed weight (C / (4 * ng) passes of 1424 * ng
// bf16, `pack_weight`); bias (C,) f32; out (B, D, H, W, C) bf16, 16-byte
// aligned; C a multiple of 32.  The plan (ng, ctas, smem) is `k8_plan`'s,
// checked against this file's.  Returns a CUDA error code, 0 on success.
extern "C" int stem9_bf16(const void* x, const void* w, const void* bias, void* out, int B, int D,
                          int H, int W, int C, int ng, int ctas, int smem, void* stream) {
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 32 ||
      (ng != 8 && ng != 16 && ng != 32) || (C / 4) % ng)
    return (int)cudaErrorInvalidValue;
  const int passes = C / 4 / ng;
  if (ctas < passes || ctas % passes || smem != smem_bytes(ng) || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(w) & 15) || (reinterpret_cast<uintptr_t>(out) & 15) ||
      (reinterpret_cast<uintptr_t>(bias) & 7) || (reinterpret_cast<uintptr_t>(x) & 1))
    return (int)cudaErrorMisalignedAddress;
  Params p;
  p.x = static_cast<const uint16_t*>(x);
  p.w = static_cast<const uint8_t*>(w);
  p.bias = static_cast<const float*>(bias);
  p.B = B;
  p.D = D;
  p.H = H;
  p.W = W;
  p.C = C;
  p.cg = C / 4;
  p.passes = passes;
  p.tiles_x = (W + TX - 1) / TX;
  p.tiles_y = (H + TY - 1) / TY;
  p.tiles_z = (D + TZ - 1) / TZ;
  const long long tiles = (long long)B * p.tiles_z * p.tiles_y * p.tiles_x;
  if (tiles > 0x7fffffffLL || (long long)ctas > tiles * passes) return (int)cudaErrorInvalidValue;
  p.n_tiles = (int)tiles;
  p.aligned = W % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;

  if (!encoder()) return -1;
  CUtensorMap map;
  if (!encode_out(&map, out, B, D, H, W, C, ng)) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ng == 32) return launch<32>(map, p, ctas, s);
  if (ng == 16) return launch<16>(map, p, ctas, s);
  return launch<8>(map, p, ctas, s);
}
