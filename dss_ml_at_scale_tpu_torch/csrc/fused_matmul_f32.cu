// The float32 variants of the fused BN-apply + ReLU + 1x1 conv kernels and
// their two backward kernels, for Hopper (sm_90a).
//
// Replace the three Pallas TPU kernels of
// dss_ml_at_scale_tpu/ops/fused_matmul.py in float32 (they compute in
// y.dtype with f32 accumulation, and JAX's tests run them in f32):
//   K1f _fwd_kernel    (:113)  out[M,N] = relu(y*s + t [+ res]) @ W[K,N]
//   K2f _bwd_da_kernel (:128)  gt[M,K]  = (g[M,N] @ W^T) * [y*s + t (+ res) > 0],
//                              plus sum_g[K] = sum_M gt, sum_gx[K] = sum_M gt * x_hat
//                              with x_hat = (y - mean) * inv
//   K3f _bwd_dw_kernel (:159)  dW[K,N]  = sum_M relu(y*s + t [+ res])^T @ g
// with s = gamma * rsqrt(var + eps) and t = beta - mean * s given per
// channel; every operand and result is f32. The bf16 kernels are in
// fused_matmul.cu; this source is built on its own so that theirs is not
// rebuilt for a change here.
//
// Precision. JAX's f32 tests hold these to 1e-5 of max-abs, which one pass
// of TF32 (10 mantissa bits; 3e-4 here) cannot meet, nor K1f's element by
// element rtol/atol 1e-5. All three run their products on the tensor cores
// as 3xTF32: each f32 operand x is split as hi = rna_tf32(x) and lo =
// rna_tf32(x - hi), and A*B is taken as A_hi*B_hi + A_hi*B_lo + A_lo*B_hi,
// three TF32 wgmma products into one accumulator (the dropped A_lo*B_lo is
// about 2^-22 of the product). The tensor cores truncate the sums of a wgmma
// chain (K3f chained over a run of 10,080 rows was off by 7.3e-5 of
// max-abs, over all 664,832 by 5e-3), so each ring stage (32 steps of the
// reduction, 12 wgmmas) starts a fresh chain that is then added into an f32
// accumulator with FADD, rounded to nearest (kFlush).
//
// Bound on an H100 SXM. Every ResNet-50 bottleneck site does M*K*N =
// 1.09e10 multiply-adds at batch 212. Three TF32 products (495 TFLOP/s) are
// 0.132 ms of operations, against bytes (each input read and each output
// written once in f32, at 3.35 TB/s) of 0.254 ms (K1f, K3f) and 0.305 ms
// (K2f) at stage 1 and 0.152 ms (K2f) at stage 2: stage 1 is set by bytes,
// stages 3-4 by operations.
//
// All three are wgmma kernels of two warpgroups (8 warps: 255 registers a
// thread, where a producer warp or warpgroup would cap them at 168), one
// thread of which keeps a ring of stages full by TMA (every tile in the
// 128-byte swizzle of hopper.cuh, 32 f32 a row, out-of-bounds rows and
// columns zero-filled). TF32 wgmma takes no transposed operand, so its
// shared-memory operand is K-major (the reduction index contiguous); A comes
// from registers. The activation-sized operand (K1f's a, g, and K3f's a) is
// split in registers and never reaches device memory as hi/lo copies.
//   K1f: the reduction is K, contiguous in y[M,K] and strided in W[K,N]; W
//        is split and transposed once a call into W_hi^T and W_lo^T [N, Kp]
//        scratch, the B operands; a's A fragment is built from y's TMA tile
//        in registers (BN prologue, residual, ReLU, split). Persistent: one
//        CTA per SM walks 128 x 128 tiles of out, the N bands of an M band
//        first; the epilogue stores each tile by TMA from a staging tile.
//   K2f: the reduction is N, contiguous in g[M,N] and W[K,N]. W is split once
//        a call by split_tf32_kernel into W_hi and W_lo [K,N] scratch (at
//        most 512 x 2048), the two B operands; g's A fragment is read from
//        the swizzled tile in shared memory into registers and split there.
//        Persistent: one CTA per SM walks 128-row tiles of gt, BN = 64 or
//        128 channels wide (the wrapper's da_tile_n), the channel bands of an
//        M band first. The epilogue recomputes the ReLU mask from y (and
//        res) in device memory, writes gt and adds the channel sums to the
//        CTA's own [2K] row of partials; a second pass adds the rows in a
//        fixed order. The TPU kernel carries the sums across its sequential
//        grid, which no Hopper block can.
//   K3f: the reduction is M, strided in both y[M,K] and g[M,N], so the
//        kernel computes dW^T = g^T a: wgmma's rows are g's columns n (64 a
//        warpgroup, 128 a CTA) and its columns the channels k (64 or 128:
//        the wrapper's dw_tile_k). g's A fragment is read from its TMA tile
//        into registers, at any layout, and split there. a is computed by
//        the threads anyway: they apply the BN prologue to the
//        y tile (rounding after every operation, so a is the plain
//        version's bit for bit), split it, and write a_hi and a_lo
//        transposed into a K-major B tile, double buffered, while the
//        previous stage's products run. M is split into runs (multiples of
//        the 32-row stage) over CTAs that fill the SMs once, each summing its
//        run into a [splits, K, N] f32 scratch that the same fixed-order pass
//        adds. Rows past M are zeroed in the prologue.
// No atomics anywhere: the sums, and so the gradients, are the same from run
// to run. K and N must be multiples of 4 (16-byte rows), which the wrapper's
// zero padding guarantees.

#include <algorithm>
#include <climits>

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// z = y*s + t, rounded after each operation as the plain version's separate
// torch ops round (no fused multiply-add).
__device__ __forceinline__ float bn_pre(float y, float s, float t) {
  return __fadd_rn(__fmul_rn(y, s), t);
}

__device__ __forceinline__ float4 bn_z(float4 y, float4 s, float4 t) {
  return make_float4(bn_pre(y.x, s.x, t.x), bn_pre(y.y, s.y, t.y), bn_pre(y.z, s.z, t.z),
                     bn_pre(y.w, s.w, t.w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

// ---------------------------------------------------------------------------
// 3xTF32 on wgmma: what K1f, K2f and K3f share.
// ---------------------------------------------------------------------------
using namespace hopper;

constexpr int kSmemLimit = 232448;  // what one CTA may opt in to on an H100
// Two warpgroups, and no producer warp: thread 0 also keeps the ring full.
// 8 warps are 2 on each SM sub-partition, which leaves ptxas 255 registers a
// thread; a ninth warp, or a producer warpgroup, caps them at 168 (setmaxnreg
// does not raise what ptxas compiles for), and the chain, the accumulator
// and the split fragments then spill.
constexpr int kTcThreads = 8 * 32;
constexpr int kDepth = 32;        // reduction steps of a ring stage: one 128-byte f32 row
constexpr int kBlock = 32 * 128;  // one SW128 block of 32 rows of 32 f32
// Each stage's 12 products go to a fresh wgmma chain that is then added into
// the f32 accumulator (FADD, round to nearest). The tensor cores truncate
// their sums: chained over a run of K3f's M instead, dW was off by 7.3e-5 of
// max-abs (scripts/compare_torch_kernels.py --fused-f32, flush_never).
constexpr bool kFlush = true;

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d) {
  static_assert(N == 64 || N == 128, "the TF32 products are 64 or 128 columns wide");
  if constexpr (N == 64) {
    wgmma_m64n64k8_tf32_rs(d, a, desc_b, scale_d);
  } else {
    wgmma_m64n128k8_tf32_rs(d, a, desc_b, scale_d);
  }
}

// One k8 step of 3xTF32: d (+)= hi*B_lo + lo*B_hi + hi*B_hi, the two small
// products first. b_hi and b_lo are K-major SW128 descriptors of the step.
template <int N>
__device__ __forceinline__ void mma3(float (&d)[N / 2], const uint32_t (&hi)[4],
                                     const uint32_t (&lo)[4], uint64_t b_hi, uint64_t b_lo,
                                     int scale_d) {
  wgmma_tf32<N>(d, hi, b_lo, scale_d);
  wgmma_tf32<N>(d, lo, b_hi, 1);
  wgmma_tf32<N>(d, hi, b_hi, 1);
}

__device__ __forceinline__ float lds32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v));
}

// W_hi and W_lo [K,N] from W, K*N/4 float4 each.
__global__ void __launch_bounds__(256)
split_tf32_kernel(const float4* __restrict__ w, uint4* __restrict__ hi, uint4* __restrict__ lo,
                  long long n4) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float4 v = w[i];
    uint4 h, l;
    tf32_split(v.x, h.x, l.x);
    tf32_split(v.y, h.y, l.y);
    tf32_split(v.z, h.z, l.z);
    tf32_split(v.w, h.w, l.w);
    hi[i] = h;
    lo[i] = l;
  }
}

constexpr int kDaBM = 128;
constexpr int kDaGBytes = kDaBM * 128;  // 16 KB: 128 rows x 32 columns of g

// K2f's A fragment of a stage: this lane's 16 values of the 128 x 32 g tile
// at `base` (register r of k8 step ks: row a_row + 8 (r & 1), column 8 ks +
// tq + 4 (r >> 1)), split.
__device__ __forceinline__ void da_frags(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4],
                                         uint32_t base, int a_row, int tq) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      tf32_split(lds32(base + sw128(a_row + 8 * (r & 1), 2 * ks + (r >> 1)) + tq * 4),
                 hi[ks][r], lo[ks][r]);
}

// The 12 products of a stage on the B tiles at b_hi (BN rows of 32 TF32 hi
// halves, K-major) and b_hi + BN * 128 (the lo halves), committed as one
// group; scale_d 0 starts a fresh chain.
template <int BN>
__device__ __forceinline__ void stage_mma(float (&d)[BN / 2], const uint32_t (&hi)[4][4],
                                          const uint32_t (&lo)[4][4], uint32_t b_hi,
                                          int scale_d) {
  const uint32_t b_lo = b_hi + BN * 128;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    mma3<BN>(d, hi[ks], lo[ks], sw128_desc(b_hi + ks * 32, 16, 1024),
             sw128_desc(b_lo + ks * 32, 16, 1024), ks | scale_d);
  wgmma_commit();
}

// ---------------------------------------------------------------------------
// K1f: out = relu(y*s + t [+ res]) @ W.  y, res [M,K]; W [K,N]; out [M,N].
//
// wgmma m64n128k8 with A = a's rows (k, the reduction, contiguous) from
// registers and B = W^T's rows [n][k] (K-major) from shared memory. W is
// split and transposed once a call by split_tf32_t_kernel into W_hi^T and
// W_lo^T [N, Kp] scratch (Kp: K rounded up to the 32-deep stage), the two B
// operands. A ring stage is a 128 x 32 tile of y (and of res) and the
// 128 x 32 tiles of W_hi^T and W_lo^T; a warpgroup owns 64 rows of the
// 128 x 128 output tile. Within a stage the reduction runs in a permuted
// order (fwd_col): lane quad tq's A registers are then 8 neighbouring
// columns of y, two 16-byte reads a row, and its s and t two float4 each;
// W^T's scratch holds its columns in the same order. Each lane applies the
// BN prologue to its fragment (rounding after every operation, so a is the
// plain version's bit for bit), adds res, rectifies and splits it: a never
// reaches device memory. Stage q+1's fragment is built into the second of
// two register sets while stage q's 12 products run; the chain is then
// added into the f32 accumulator and the slot freed (every warp arrives on
// its empty barrier; thread 0 waits for them and refills it). Persistent:
// CTA c walks tiles c, c + grid, ...; tile i is column band i % tiles_n of
// row tile i / tiles_n (the N bands of an M band first, so neighbouring
// CTAs read one y tile from device memory once), and the ring runs on
// across tiles, so the next tile's loads are in flight during the epilogue.
// The epilogue writes each warpgroup's 64 x 128 block into a staging tile
// in shared memory (the SW128 layout of the out map) and one thread stores
// it by TMA, which clips rows past M and columns past N; the store drains
// while the next tile's products run, and is waited for (its reads of the
// staging tile) only before the next tile's epilogue writes it.
// ---------------------------------------------------------------------------
constexpr int kFwdBM = 128, kFwdBN = 128;
constexpr int kFwdYBytes = kFwdBM * 128;           // 16 KB: 128 rows x 32 columns of y
constexpr int kFwdWBytes = kFwdBN * 128;           // 16 KB: 128 rows n x 32 k of W_hi^T
constexpr int kFwdOutBytes = kFwdBM * kFwdBN * 4;  // 64 KB: the staged out tile

// Physical column of logical column j of a stage (a permutation of 0..31):
// lane quad tq's registers of k8 step ks, logical columns 8 ks + tq and
// 8 ks + tq + 4, are physical 8 tq + 2 ks and 8 tq + 2 ks + 1.
__host__ __device__ constexpr int fwd_col(int j) {
  return 8 * (j % 4) + 2 * (j / 8) + (j / 4) % 2;
}

__host__ __device__ constexpr int fwd_stage_bytes(bool res) {
  return kFwdYBytes * (res ? 2 : 1) + 2 * kFwdWBytes;
}

// Bytes of dynamic shared memory: alignment slack, the staging tile, the
// ring, the barriers.
__host__ __device__ constexpr int fwd_smem_bytes(bool res, int stages) {
  return 1024 + kFwdOutBytes + stages * fwd_stage_bytes(res) + 2 * stages * 8;
}

// As many ring stages as fit, up to 4: 3 without a residual, 2 with one.
int fwd_stages(bool res) {
  return std::min(4, (kSmemLimit - fwd_smem_bytes(res, 0)) / (fwd_stage_bytes(res) + 16));
}

// W_hi^T and W_lo^T [N, Kp] from W [K,N]: element (n, 32 kb + j) is the
// split of W[32 kb + fwd_col(j)][n], zero where that row is past K. One
// 32 x 32 block of W per CTA, transposed through shared memory.
__global__ void __launch_bounds__(256)
split_tf32_t_kernel(const float* __restrict__ w, uint32_t* __restrict__ hi,
                    uint32_t* __restrict__ lo, int K, int N, int Kp) {
  __shared__ float blk[32][33];
  const int n0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int r = ty; r < 32; r += 8) {
    const int k = k0 + r, n = n0 + tx;
    blk[r][tx] = k < K && n < N ? w[static_cast<size_t>(k) * N + n] : 0.f;
  }
  __syncthreads();
  for (int r = ty; r < 32; r += 8) {
    const int n = n0 + r;
    if (n >= N) continue;
    const size_t off = static_cast<size_t>(n) * Kp + k0 + tx;
    tf32_split(blk[fwd_col(tx)][r], hi[off], lo[off]);
  }
}

// This lane's A fragment of a stage: a = relu(y*s + t [+ res]) of rows a_row
// and a_row + 8 of the 128 x 32 y tile at `base` (res's tile follows it),
// physical columns 8 tq .. 8 tq + 7 (s and t of them in sc, tc), split.
// Register r of k8 step ks is row a_row + 8 (r & 1), physical column
// 8 tq + 2 ks + (r >> 1).
template <bool RES>
__device__ __forceinline__ void fwd_frags(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4],
                                          uint32_t base, int a_row, int tq,
                                          const float4 (&sc)[2], const float4 (&tc)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < 2; ++c) {  // physical columns 8 tq + 4 c .. + 3
      const uint32_t at = sw128(a_row + 8 * h, 2 * tq + c);
      float4 z = bn_z(lds128(base + at), sc[c], tc[c]);
      if (RES) z = add4(z, lds128(base + kFwdYBytes + at));
      const float a[4] = {fmaxf(z.x, 0.f), fmaxf(z.y, 0.f), fmaxf(z.z, 0.f), fmaxf(z.w, 0.f)};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = 4 * c + e;  // = 2 ks + (r >> 1)
        tf32_split(a[e], hi[p / 2][h + 2 * (p % 2)], lo[p / 2][h + 2 * (p % 2)]);
      }
    }
}

__device__ __forceinline__ void sts64(uint32_t addr, float a, float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b));
}

template <bool RES>
__global__ void __launch_bounds__(kTcThreads, 1)
fwd_tf32_kernel(const __grid_constant__ CUtensorMap tm_y,
                const __grid_constant__ CUtensorMap tm_res,
                const __grid_constant__ CUtensorMap tm_whi,
                const __grid_constant__ CUtensorMap tm_wlo,
                const __grid_constant__ CUtensorMap tm_out, const float* __restrict__ s,
                const float* __restrict__ t, int M, int K, int N, int stages) {
  constexpr int kYStage = kFwdYBytes * (RES ? 2 : 1);  // y's (and res's) tiles; W's follow
  constexpr int kStage = fwd_stage_bytes(RES);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  const uint32_t s_out = smem_u32(smem);  // warpgroup wg's 64 rows at s_out + wg * 32 KB
  const uint32_t s_ring = s_out + kFwdOutBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kFwdOutBytes + stages * kStage);
  uint64_t* empty = full + stages;
  const int tiles_n = (N + kFwdBN - 1) / kFwdBN;
  const int tiles = (M + kFwdBM - 1) / kFwdBM * tiles_n;
  const int n_kb = (K + kDepth - 1) / kDepth;
  // Stage q of this CTA's walk: step q % n_kb of its tile q / n_kb.
  const int n_q = (tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x * n_kb;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  auto load = [&](int q) {  // thread 0: stage q into ring slot q % stages
    const int tile = blockIdx.x + (q / n_kb) * gridDim.x, kb = q % n_kb, st = q % stages;
    const int m0 = (tile / tiles_n) * kFwdBM, n0 = (tile % tiles_n) * kFwdBN;
    const uint32_t base = s_ring + st * kStage;
    mbar_arrive_expect_tx(&full[st], kStage);
    tma_load_2d(base, &tm_y, &full[st], kb * kDepth, m0);
    if (RES) tma_load_2d(base + kFwdYBytes, &tm_res, &full[st], kb * kDepth, m0);
    tma_load_2d(base + kYStage, &tm_whi, &full[st], kb * kDepth, n0);
    tma_load_2d(base + kYStage + kFwdWBytes, &tm_wlo, &full[st], kb * kDepth, n0);
  };
  // Thread 0 refills the slot of stage q once every warp has freed it.
  auto refill = [&](int q) {
    if (q + stages >= n_q) return;
    mbar_wait(&empty[q % stages], (q / stages) & 1);
    load(q + stages);
  };

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);
    }
    mbar_fence_init();
    for (int q = 0; q < min(stages, n_q); ++q) load(q);
  }
  __syncthreads();

  // Warpgroup wg owns rows [64 wg, 64 wg + 64) of each tile.
  const int wg = warp / 4, wl = warp % 4;
  const int g = lane >> 2, tq = lane & 3;
  const int a_row = wg * 64 + wl * 16 + g;  // this lane's rows a_row and a_row + 8 of a tile
  const bool storer = tid % 128 == 0;       // issues its warpgroup's TMA stores
  const uint32_t s_wg = s_out + wg * (kFwdOutBytes / 2);
  // Stage q's A fragment, once its slot has landed; s and t are read first.
  auto frags = [&](int q, uint32_t (&hi)[4][4], uint32_t (&lo)[4][4]) {
    const int c = (q % n_kb) * kDepth + 8 * tq;
    float4 sc[2], tc[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // K is a multiple of 4: a float4 is in or out whole
      const bool in = c + 4 * i < K;
      sc[i] = in ? __ldg(reinterpret_cast<const float4*>(s + c + 4 * i)) : make_float4(0, 0, 0, 0);
      tc[i] = in ? __ldg(reinterpret_cast<const float4*>(t + c + 4 * i)) : make_float4(0, 0, 0, 0);
    }
    mbar_wait(&full[q % stages], (q / stages) & 1);
    fwd_frags<RES>(hi, lo, s_ring + (q % stages) * kStage, a_row, tq, sc, tc);
  };

  float acc[kFwdBN / 2], chain[kFwdBN / 2];
  uint32_t hi0[4][4], lo0[4][4], hi1[4][4], lo1[4][4];
  frags(0, hi0, lo0);  // every CTA has a tile: the grid is at most the tile count
  int q = 0;           // stage q of the CTA's walk
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / tiles_n) * kFwdBM, n0 = (tile % tiles_n) * kFwdBN;
#pragma unroll
    for (int i = 0; i < kFwdBN / 2; ++i) acc[i] = 0.f;
    for (int kb = 0; kb < n_kb; ++kb, ++q) {
      const int st = q % stages;
      const uint32_t b_hi = s_ring + st * kStage + kYStage;
      const int scale_d = kFlush ? 0 : kb != 0;  // without the flush, one chain a tile
      const bool more = q + 1 < n_q;
      if (q & 1) {
        stage_mma<kFwdBN>(chain, hi1, lo1, b_hi, scale_d);
        if (more) frags(q + 1, hi0, lo0);
      } else {
        stage_mma<kFwdBN>(chain, hi0, lo0, b_hi, scale_d);
        if (more) frags(q + 1, hi1, lo1);
      }
      wgmma_wait<0>();
      fence_regs(chain);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);  // stage q's tiles are read
      if (tid == 0) refill(q);
#pragma unroll
      for (int i = 0; i < kFwdBN / 2; ++i) acc[i] = kFlush ? acc[i] + chain[i] : chain[i];
    }

    // Epilogue: this warpgroup's 64 x 128 block into its staging tile (four
    // SW128 blocks of 64 rows x 32 columns, 8 KB each) once the previous
    // tile's store has read it, then out by TMA.
    if (storer) bulk_wait_read<0>();
    named_bar_sync(1 + wg, 128);
    const int row = wl * 16 + g;
#pragma unroll
    for (int i = 0; i < kFwdBN / 8; ++i) {  // columns 8 i + 2 tq, + 1
      const uint32_t at = s_wg + (i / 4) * (64 * 128) + (tq & 1) * 8;
      sts64(at + sw128(row, 2 * (i % 4) + tq / 2), acc[4 * i], acc[4 * i + 1]);
      sts64(at + sw128(row + 8, 2 * (i % 4) + tq / 2), acc[4 * i + 2], acc[4 * i + 3]);
    }
    fence_proxy_async();  // the staging tile's stores, visible to the TMA store
    named_bar_sync(1 + wg, 128);
    if (storer) {
      if (m0 + 64 * wg < M)
        for (int b = 0; b < kFwdBN / 32 && n0 + 32 * b < N; ++b)
          tma_store_2d(&tm_out, s_wg + b * (64 * 128), n0 + 32 * b, m0 + 64 * wg);
      bulk_commit();
    }
  }
  if (storer) bulk_wait<0>();  // the last stores are done before the CTA exits
}

// ---------------------------------------------------------------------------
// K2f: gt = (g @ W^T) * [y*s + t (+ res) > 0] and the channel sums.
// g [M,N]; W_hi, W_lo [K,N]; y, res, gt [M,K]; partial [gridDim.x, 2K].
//
// wgmma m64nBNk8 with A = g's rows (n, the reduction, contiguous) from
// registers and B = W's rows [k][n] (K-major) from shared memory. A ring
// stage is a 128 x 32 g tile and the BN x 32 tiles of W_hi and W_lo; a
// warpgroup owns 64 rows of the 128-row tile. At each stage each lane reads
// its g fragment of the four k8 steps (16 values: rows g, g+8 of its warp's
// 16, columns t, t+4 of each step) from the swizzled tile and splits it;
// the stage's 12 products go as one group into a fresh chain, which is then
// added into the tile's accumulator, and the slot is freed (every warp
// arrives on its empty barrier; thread 0 waits for them and refills it).
// The two warpgroups' products take turns on the tensor cores. Persistent:
// CTA c walks tiles c, c + grid, ... of 128 x BN; tile i is channel band
// i % tiles_k of row tile i / tiles_k. The epilogue reads y (and res) from
// device memory for the mask, writes gt, and sums each column over its
// warp's 16 rows (shuffles over the 8 row groups of a lane quad); the 8
// warps' sums are added in a fixed order through shared memory and then to
// the CTA's own partial row, always by the same thread for the same channel.
// ---------------------------------------------------------------------------
__host__ __device__ constexpr int da_stage_bytes(int bn) { return kDaGBytes + 2 * bn * 128; }

// Bytes of dynamic shared memory: alignment slack, the ring, the 8 warps'
// column sums, the barriers.
__host__ __device__ constexpr int da_smem_bytes(int bn, int stages) {
  return 1024 + stages * da_stage_bytes(bn) + 8 * 2 * bn * 4 + 2 * stages * 8;
}

// As many ring stages as fit, up to 6: 6 at 64 channels, 4 at 128.
int da_stages(int bn) {
  return std::min(6, (kSmemLimit - da_smem_bytes(bn, 0)) / (da_stage_bytes(bn) + 16));
}

template <int BN, bool RES>
__global__ void __launch_bounds__(kTcThreads, 1)
bwd_da_tf32_kernel(const __grid_constant__ CUtensorMap tm_g,
                   const __grid_constant__ CUtensorMap tm_whi,
                   const __grid_constant__ CUtensorMap tm_wlo, const float* __restrict__ y,
                   const float* __restrict__ res, const float* __restrict__ s,
                   const float* __restrict__ t, const float* __restrict__ mean,
                   const float* __restrict__ inv, float* __restrict__ gt,
                   float* __restrict__ partial, int M, int K, int N, int stages) {
  constexpr int kStage = da_stage_bytes(BN);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  const uint32_t s_ring = smem_u32(smem);
  float* red = reinterpret_cast<float*>(smem + stages * kStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 8 * 2 * BN);
  uint64_t* empty = full + stages;
  const int tiles_k = (K + BN - 1) / BN;
  const int tiles = (M + kDaBM - 1) / kDaBM * tiles_k;
  const int n_kb = (N + kDepth - 1) / kDepth;
  // Stage q of this CTA's walk: step q % n_kb of its tile q / n_kb.
  const int n_q = (tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x * n_kb;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  auto load = [&](int q) {  // thread 0: stage q into ring slot q % stages
    const int tile = blockIdx.x + (q / n_kb) * gridDim.x, kb = q % n_kb, st = q % stages;
    const int m0 = (tile / tiles_k) * kDaBM, k0 = (tile % tiles_k) * BN;
    const uint32_t base = s_ring + st * kStage;
    mbar_arrive_expect_tx(&full[st], kStage);
    tma_load_2d(base, &tm_g, &full[st], kb * kDepth, m0);
    tma_load_2d(base + kDaGBytes, &tm_whi, &full[st], kb * kDepth, k0);
    tma_load_2d(base + kDaGBytes + BN * 128, &tm_wlo, &full[st], kb * kDepth, k0);
  };
  // Thread 0 refills the slot of stage q once every warp has freed it.
  auto refill = [&](int q) {
    if (q + stages >= n_q) return;
    mbar_wait(&empty[q % stages], (q / stages) & 1);
    load(q + stages);
  };

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);
    }
    mbar_fence_init();
    for (int q = 0; q < min(stages, n_q); ++q) load(q);
  }
  __syncthreads();

  // Warpgroup wg owns rows [64 wg, 64 wg + 64) of each tile.
  const int wg = warp / 4, wl = warp % 4;
  const int g = lane >> 2, tq = lane & 3;
  const int a_row = wg * 64 + wl * 16 + g;  // this lane's rows a_row and a_row + 8 of a tile
  // This CTA's row of partials: (sum_g, sum_gx) of column k at [k], [K + k].
  // Entry (which, k) is always added to by thread (which * BN + k % BN) % 256,
  // which zeroes it here: each entry is one thread's, in walk order.
  float* part_row = partial + static_cast<size_t>(blockIdx.x) * 2 * K;
  for (int band = 0; band < tiles_k; ++band)
    for (int idx = tid; idx < 2 * BN; idx += 256) {
      const int k = band * BN + idx % BN;
      if (k < K) part_row[(idx / BN) * K + k] = 0.f;
    }
  float* red_w = red + warp * 2 * BN;  // this warp's [sum_g | sum_gx] of the tile's columns
  float acc[BN / 2], chain[BN / 2];
  // The A fragments alternate between two sets of registers from stage to
  // stage (one set: compare_torch_kernels.py --fused-f32, k2f_one_fragment_set).
  uint32_t hi0[4][4], lo0[4][4], hi1[4][4], lo1[4][4];
  int q = 0;  // stage q of the CTA's walk
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / tiles_k) * kDaBM, k0 = (tile % tiles_k) * BN;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kb = 0; kb < n_kb; ++kb, ++q) {
      const int st = q % stages;
      const uint32_t base = s_ring + st * kStage;
      const int scale_d = kFlush ? 0 : kb != 0;  // without the flush, one chain a tile
      mbar_wait(&full[st], (q / stages) & 1);
      if (kb & 1) {
        da_frags(hi1, lo1, base, a_row, tq);
        stage_mma<BN>(chain, hi1, lo1, base + kDaGBytes, scale_d);
      } else {
        da_frags(hi0, lo0, base, a_row, tq);
        stage_mma<BN>(chain, hi0, lo0, base + kDaGBytes, scale_d);
      }
      wgmma_wait<0>();
      fence_regs(chain);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);  // stage q's W tiles are read
      if (tid == 0) refill(q);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = kFlush ? acc[i] + chain[i] : chain[i];
    }

    // Epilogue: the mask from y (and res), gt, and the column sums. y and
    // res are read from device memory 8 column groups at a time, every load
    // issued before the first is used (rows past M read row 0 and are not
    // stored).
#pragma unroll
    for (int i0 = 0; i0 < BN / 8; i0 += 8) {
      float2 yv[8][2], rv[8][2];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = m0 + a_row + 8 * half, c = k0 + 8 * (i0 + i) + 2 * tq;
          const size_t off = row < M && c < K ? static_cast<size_t>(row) * K + c : 0;
          yv[i][half] = __ldg(reinterpret_cast<const float2*>(y + off));
          if (RES) rv[i][half] = __ldg(reinterpret_cast<const float2*>(res + off));
        }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        // K is a multiple of 4: columns c and c + 1 are both in or both out.
        const int c = k0 + 8 * (i0 + i) + 2 * tq;
        float2 sc = make_float2(0.f, 0.f), tc = sc, mc = sc, ic = sc;
        if (c < K) {
          sc = __ldg(reinterpret_cast<const float2*>(s + c));
          tc = __ldg(reinterpret_cast<const float2*>(t + c));
          mc = __ldg(reinterpret_cast<const float2*>(mean + c));
          ic = __ldg(reinterpret_cast<const float2*>(inv + c));
        }
        float pg0 = 0.f, pg1 = 0.f, px0 = 0.f, px1 = 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = m0 + a_row + 8 * half;
          if (c >= K || row >= M) continue;
          const float2 yh = yv[i][half];
          float z0 = bn_pre(yh.x, sc.x, tc.x), z1 = bn_pre(yh.y, sc.y, tc.y);
          if (RES) {
            z0 = __fadd_rn(z0, rv[i][half].x);
            z1 = __fadd_rn(z1, rv[i][half].y);
          }
          const float g0 = z0 > 0.f ? acc[4 * (i0 + i) + 2 * half] : 0.f;
          const float g1 = z1 > 0.f ? acc[4 * (i0 + i) + 2 * half + 1] : 0.f;
          *reinterpret_cast<float2*>(gt + static_cast<size_t>(row) * K + c) = make_float2(g0, g1);
          pg0 += g0;
          pg1 += g1;
          px0 = fmaf(g0, __fmul_rn(__fsub_rn(yh.x, mc.x), ic.x), px0);
          px1 = fmaf(g1, __fmul_rn(__fsub_rn(yh.y, mc.y), ic.y), px1);
        }
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          pg0 += __shfl_xor_sync(0xffffffffu, pg0, off);
          pg1 += __shfl_xor_sync(0xffffffffu, pg1, off);
          px0 += __shfl_xor_sync(0xffffffffu, px0, off);
          px1 += __shfl_xor_sync(0xffffffffu, px1, off);
        }
        if (g == 0) {
          *reinterpret_cast<float2*>(red_w + 8 * (i0 + i) + 2 * tq) = make_float2(pg0, pg1);
          *reinterpret_cast<float2*>(red_w + BN + 8 * (i0 + i) + 2 * tq) = make_float2(px0, px1);
        }
      }
    }
    named_bar_sync(1, 256);
    for (int idx = tid; idx < 2 * BN; idx += 256) {
      const int which = idx / BN, c = idx % BN, k = k0 + c;
      if (k < K) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < 8; ++w) v += red[(w * 2 + which) * BN + c];
        part_row[which * K + k] += v;
      }
    }
    named_bar_sync(1, 256);  // the column sums are read: the next tile may write them
  }
}

// ---------------------------------------------------------------------------
// K3f: partial[z] = sum over run z of M of relu(y*s + t [+ res])^T @ g, a
// [K,N] f32 slab per run.  y, res [M,K]; g [M,N].
//
// Computed as its transpose, D[n][k] = sum_m g[m][n] a[m][k]: wgmma
// m64nTKk8 with A = g^T (64 columns of g a warpgroup, 128 a CTA) from
// registers and B = a^T [k][m] (K-major) from shared memory. One work item
// per CTA: one output tile (TK channels x 128 columns) summed over one run
// of M, the runs a multiple of the 32-row stage (no stage crosses into the
// next run). A ring stage holds the 32-row tiles of y (and res), TK
// channels, and of g, 128 columns. At stage j each lane reads its g
// fragment (columns n = rows of A: g, g+8 of its warp's 16; rows m t, t+4 of
// each k8 step) into registers, splits it and issues the stage's 12
// products on a^T buffer j % 2; a barrier frees the slot (its y was read at
// j - 1), which thread 0 refills. While the products run, the 256 threads
// read stage j+1's y tile (lane = row m, a warp's 4 channels a float4),
// apply the BN prologue, split a and store a_hi and a_lo transposed, row k
// of 32 rows m, into buffer (j+1) % 2. Then the chain is added into the
// accumulator, and a second barrier publishes the buffer.
// ---------------------------------------------------------------------------
constexpr int kDwBN = 128;                      // g's columns per CTA, dW's per tile
constexpr int kDwGBytes = kDepth * kDwBN * 4;   // 16 KB: four SW128 blocks

__host__ __device__ constexpr int dw_y_bytes(int tk, bool res) {
  return kDepth * tk * 4 * (res ? 2 : 1);
}

__host__ __device__ constexpr int dw_stage_bytes(int tk, bool res) {
  return dw_y_bytes(tk, res) + kDwGBytes;
}

// Alignment slack, the two a^T buffers (hi and lo each), the ring, s and t,
// the barriers.
__host__ __device__ constexpr int dw_smem_bytes(int tk, bool res, int stages) {
  return 1024 + 4 * tk * 128 + stages * dw_stage_bytes(tk, res) + 2 * tk * 4 + stages * 8;
}

// As many ring stages as fit, up to 6: 3 at 128 channels with res, 5
// without; 6 at 64.
int dw_stages(int tk, bool res) {
  return std::min(6, (kSmemLimit - dw_smem_bytes(tk, res, 0)) / (dw_stage_bytes(tk, res) + 16));
}

template <int TK, bool RES>
__global__ void __launch_bounds__(kTcThreads, 1)
bwd_dw_tf32_kernel(const __grid_constant__ CUtensorMap tm_y,
                   const __grid_constant__ CUtensorMap tm_res,
                   const __grid_constant__ CUtensorMap tm_g, const float* __restrict__ s,
                   const float* __restrict__ t, float* __restrict__ partial, int M, int K, int N,
                   int chunk, int stages) {
  constexpr int kYBytes = kDepth * TK * 4;  // the y blocks of a stage; the res blocks follow
  constexpr int kYStage = dw_y_bytes(TK, RES);
  constexpr int kStage = kYStage + kDwGBytes;
  constexpr int kBBytes = TK * 128;  // a_hi (or a_lo)^T: TK rows of 32 m
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  const uint32_t s_b = smem_u32(smem);  // buffer b: a_hi^T at s_b + 2 b kBBytes, a_lo^T next
  const uint32_t s_ring = s_b + 4 * kBBytes;
  float* s_s = reinterpret_cast<float*>(smem + 4 * kBBytes + stages * kStage);
  float* s_t = s_s + TK;
  uint64_t* full = reinterpret_cast<uint64_t*>(s_t + TK);
  // Work item blockIdx.x: run z of output tile `tile`; the tiles of one run
  // are neighbours, so CTAs that run together read the same rows of y and g.
  const int tiles_k = (K + TK - 1) / TK;
  const int tiles = tiles_k * ((N + kDwBN - 1) / kDwBN);
  const int z = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int k0 = (tile % tiles_k) * TK, n0 = (tile / tiles_k) * kDwBN;
  const int m_begin = z * chunk;
  const int n_st = max(0, (min(M, m_begin + chunk) - m_begin + kDepth - 1) / kDepth);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // Thread 0: stage j into ring slot j % stages. Blocks wholly past K or N
  // stay out: the rows of dW and the columns they would feed are never
  // stored, and no other depends on them.
  auto load = [&](int j) {
    const int y_boxes = min(TK / 32, (K - k0 + 31) / 32);
    const int g_boxes = min(kDwBN / 32, (N - n0 + 31) / 32);
    const int st = j % stages, m = m_begin + j * kDepth;
    const uint32_t base = s_ring + st * kStage;
    mbar_arrive_expect_tx(&full[st], (y_boxes * (RES ? 2 : 1) + g_boxes) * kBlock);
    for (int b = 0; b < y_boxes; ++b) {
      tma_load_2d(base + b * kBlock, &tm_y, &full[st], k0 + b * 32, m);
      if (RES) tma_load_2d(base + kYBytes + b * kBlock, &tm_res, &full[st], k0 + b * 32, m);
    }
    for (int b = 0; b < g_boxes; ++b)
      tma_load_2d(base + kYStage + b * kBlock, &tm_g, &full[st], n0 + b * 32, m);
  };

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) mbar_init(&full[i], 1);
    mbar_fence_init();
    for (int j = 0; j < min(stages, n_st); ++j) load(j);
  }
  for (int i = tid; i < TK; i += kTcThreads) {  // zero past K: the padded a is 0
    s_s[i] = k0 + i < K ? s[k0 + i] : 0.f;
    s_t[i] = k0 + i < K ? t[k0 + i] : 0.f;
  }
  __syncthreads();

  const int wg = warp / 4, wl = warp % 4;
  const int g = lane >> 2, tq = lane & 3;
  const int nb = wg * 64 + wl * 16 + g;  // this lane's A rows (columns of g): nb and nb + 8
  // Register r of k8 step ks reads g at column nb + 8 (r & 1) (block, chunk,
  // word of the 32-wide SW128 blocks) and row 8 ks + tq + 4 (r >> 1).
  uint32_t a_blk[2];
  int a_chunk[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = nb + 8 * h;
    a_blk[h] = (n / 32) * kBlock + (n % 4) * 4;
    a_chunk[h] = (n % 32) / 4;
  }

  // Stage j's prologue, from its ring slot into a^T buffer j % 2: lane = row
  // m of the stage, channels 4q..4q+3 of the tile (q = warp + 8 i).
  auto prologue = [&](int j) {
    const uint32_t yb = s_ring + (j % stages) * kStage;
    const uint32_t bh = s_b + 2 * (j & 1) * kBBytes;
    const bool in = m_begin + j * kDepth + lane < M;  // rows past M add nothing
#pragma unroll
    for (int i = 0; i < TK / 32; ++i) {
      const int q = warp + 8 * i;
      const uint32_t off = (q / 8) * kBlock + sw128(lane, q % 8);
      float4 zz = bn_z(lds128(yb + off), *reinterpret_cast<const float4*>(s_s + 4 * q),
                       *reinterpret_cast<const float4*>(s_t + 4 * q));
      if (RES) zz = add4(zz, lds128(yb + kYBytes + off));
      const float a[4] = {in ? fmaxf(zz.x, 0.f) : 0.f, in ? fmaxf(zz.y, 0.f) : 0.f,
                          in ? fmaxf(zz.z, 0.f) : 0.f, in ? fmaxf(zz.w, 0.f) : 0.f};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t h, l;
        tf32_split(a[e], h, l);
        const uint32_t at = sw128(4 * q + e, lane / 4) + (lane % 4) * 4;
        sts32(bh + at, h);
        sts32(bh + kBBytes + at, l);
      }
    }
  };

  float acc[TK / 2], chain[TK / 2];
  uint32_t hi[4][4], lo[4][4];
#pragma unroll
  for (int i = 0; i < TK / 2; ++i) acc[i] = 0.f;
  if (n_st > 0) {
    mbar_wait(&full[0], 0);
    prologue(0);
    fence_proxy_async();
    named_bar_sync(1, 256);
  }
  for (int j = 0; j < n_st; ++j) {
    // g's A fragment of stage j (16 values), split; then the stage's 12
    // products on a^T buffer j % 2, as one group.
    const uint32_t gb = s_ring + (j % stages) * kStage + kYStage;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        tf32_split(lds32(gb + a_blk[r & 1] + sw128(8 * ks + tq + 4 * (r >> 1), a_chunk[r & 1])),
                   hi[ks][r], lo[ks][r]);
    const uint32_t bh = s_b + 2 * (j & 1) * kBBytes, bl = bh + kBBytes;
    const int scale_d = kFlush ? 0 : j != 0;  // without the flush, one chain a run
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      mma3<TK>(chain, hi[ks], lo[ks], sw128_desc(bh + ks * 32, 16, 1024),
               sw128_desc(bl + ks * 32, 16, 1024), ks | scale_d);
    wgmma_commit();
    // Every thread has read slot j % stages (g just now, y at j - 1):
    // thread 0 refills it. a^T buffer (j + 1) % 2 was last read by stage
    // j - 1's products, done in both warpgroups at the barrier that ended
    // j - 1. Stage j + 1's prologue runs while stage j's products do.
    named_bar_sync(1, 256);
    if (tid == 0 && j + stages < n_st) load(j + stages);
    if (j + 1 < n_st) {
      mbar_wait(&full[(j + 1) % stages], ((j + 1) / stages) & 1);
      prologue(j + 1);
      fence_proxy_async();  // the prologue's stores, visible to the next products
    }
    wgmma_wait<0>();
    fence_regs(chain);
#pragma unroll
    for (int i = 0; i < TK / 2; ++i) acc[i] = kFlush ? acc[i] + chain[i] : chain[i];
    named_bar_sync(1, 256);
  }

  // dW^T's rows n = n0 + nb (+ 8), columns k = k0 + 8 i + 2 tq (+ 1),
  // stored as the slab's [K,N].
  float* slab = partial + static_cast<size_t>(z) * K * N;
  const int n_lo = n0 + nb;
#pragma unroll
  for (int i = 0; i < TK / 8; ++i) {
    const int k = k0 + 8 * i + 2 * tq;  // K is a multiple of 4: k and k + 1 both in or out
    if (k >= K) continue;
    float* r0 = slab + static_cast<size_t>(k) * N;
    if (n_lo < N) {
      r0[n_lo] = acc[4 * i];
      r0[N + n_lo] = acc[4 * i + 1];
    }
    if (n_lo + 8 < N) {
      r0[n_lo + 8] = acc[4 * i + 2];
      r0[N + n_lo + 8] = acc[4 * i + 3];
    }
  }
}

// ---------------------------------------------------------------------------
// The second pass of K2f and K3f: out[c] = sum_r part[r, c] in a fixed order,
// so the result does not depend on how blocks were run. Row group rg of G
// adds rows rg, rg + G, ... in turn and the groups are added in index order;
// G = 1 below 32 rows. The same pass as fused_matmul.cu's.
// ---------------------------------------------------------------------------
template <int COLS, int G>
__global__ void __launch_bounds__(COLS * G)
sum_rows_kernel(const float* __restrict__ part, float* __restrict__ out, int rows, long long cols) {
  __shared__ float sh[G][COLS];
  const int lane = threadIdx.x % COLS, rg = threadIdx.x / COLS;
  const long long c = static_cast<long long>(blockIdx.x) * COLS + lane;
  float acc = 0.f;
  if (c < cols) {
    for (int r = rg; r < rows; r += G) acc += part[static_cast<long long>(r) * cols + c];
  }
  if (G == 1) {
    if (c < cols) out[c] = acc;
    return;
  }
  sh[rg][lane] = acc;
  __syncthreads();
  if (rg == 0 && c < cols) {
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < G; ++i) v += sh[i][lane];
    out[c] = v;
  }
}

int sum_rows(const float* part, float* out, int rows, long long cols, cudaStream_t st) {
  if (rows < 32) {
    const long long blocks = (cols + 255) / 256;
    sum_rows_kernel<256, 1><<<static_cast<unsigned>(blocks), 256, 0, st>>>(part, out, rows, cols);
  } else {
    const long long blocks = (cols + 31) / 32;
    sum_rows_kernel<32, 16><<<static_cast<unsigned>(blocks), 512, 0, st>>>(part, out, rows, cols);
  }
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int M, int K, int N) {
  return M < 1 || K < 4 || N < 4 || K % 4 != 0 || N % 4 != 0;
}


// cuTensorMapEncodeTiled, fetched from the driver at first use.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 2-D TMA map of a row-major f32 [outer, inner] matrix, boxes of box_outer
// rows x 32 columns (128 bytes) in the 128-byte swizzle, zero fill out of
// bounds.
int make_map(CUtensorMap* map, const void* ptr, int inner, int outer, int box_outer) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 4};
  const cuuint32_t box[2] = {32, static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Opt a kernel in to more than 48 KB of dynamic shared memory, once.
template <class Kernel>
int opt_in(Kernel kernel, bool& configured) {
  if (configured) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (e != cudaSuccess) return static_cast<int>(e);
  configured = true;
  return 0;
}

}  // namespace

// All pointers are device pointers to contiguous f32, 16-byte aligned; s, t,
// mean, inv are [K]. res may be null (the variant without a residual). K and
// N are multiples of 4. Each function launches on `stream` and returns
// cudaGetLastError() after its launches (0 when they were accepted).


// K1f. out [M,N]; grid CTAs walk the 128 x 128 tiles (the wrapper's choice:
// at most one per SM and one per tile); w_split [2, N, Kp] f32 scratch for
// W_hi^T and W_lo^T, Kp = K rounded up to a multiple of 32.
extern "C" int dsst_bn_relu_matmul_fwd_f32(const void* y, const void* res, const void* s,
                                           const void* t, const void* w, void* out,
                                           void* w_split, int M, int K, int N, int grid,
                                           void* stream) {
  if (bad_shape(M, K, N) || grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long kp = (K + 31LL) / 32 * 32;
  const long long tiles = (M + 127LL) / 128 * ((N + 127LL) / 128);
  if (kp / 32 > 65535 || grid > tiles || (tiles + grid - 1) / grid * (kp / 32) > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool with_res = res != nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* w_hi = static_cast<uint32_t*>(w_split);
  uint32_t* w_lo = w_hi + static_cast<size_t>(N) * kp;
  split_tf32_t_kernel<<<dim3((N + 31) / 32, static_cast<unsigned>(kp / 32)), 256, 0, st>>>(
      static_cast<const float*>(w), w_hi, w_lo, K, N, static_cast<int>(kp));
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  CUtensorMap tm_y, tm_res, tm_whi, tm_wlo, tm_out;
  rc = make_map(&tm_y, y, K, M, kFwdBM);
  if (rc == 0) rc = make_map(&tm_res, with_res ? res : y, K, M, kFwdBM);
  if (rc == 0) rc = make_map(&tm_whi, w_hi, static_cast<int>(kp), N, kFwdBN);
  if (rc == 0) rc = make_map(&tm_wlo, w_lo, static_cast<int>(kp), N, kFwdBN);
  if (rc == 0) rc = make_map(&tm_out, out, N, M, 64);  // a warpgroup's 64 rows a store
  if (rc != 0) return rc;
  auto kernel = with_res ? fwd_tf32_kernel<true> : fwd_tf32_kernel<false>;
  static bool configured[2] = {};
  rc = opt_in(kernel, configured[with_res]);
  if (rc != 0) return rc;
  const int stages = fwd_stages(with_res);
  kernel<<<grid, kTcThreads, fwd_smem_bytes(with_res, stages), st>>>(
      tm_y, tm_res, tm_whi, tm_wlo, tm_out, static_cast<const float*>(s),
      static_cast<const float*>(t), M, K, N, stages);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of one K1f CTA.
extern "C" int dsst_bn_relu_matmul_fwd_f32_smem_bytes(int with_res) {
  return fwd_smem_bytes(with_res != 0, fwd_stages(with_res != 0));
}

// K2f. gt [M,K]; bn the tile width, 64 or 128 (the wrapper's da_tile_n);
// grid CTAs walk the tiles (the wrapper's choice: at most one per SM and one
// per tile); partial [grid, 2K] f32 scratch, one row per CTA; w_split [2,K,N]
// f32 scratch for W_hi and W_lo; sums [2K] (sum_g, then sum_gx).
extern "C" int dsst_bn_relu_matmul_bwd_da_f32(const void* g, const void* w, const void* y,
                                              const void* res, const void* s, const void* t,
                                              const void* mean, const void* inv, void* gt,
                                              void* partial, void* sums, void* w_split, int M,
                                              int K, int N, int bn, int grid, void* stream) {
  if (bad_shape(M, K, N) || (bn != 64 && bn != 128) || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool with_res = res != nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n4 = static_cast<long long>(K) * N / 4;
  auto* w_hi = static_cast<float*>(w_split);
  float* w_lo = w_hi + static_cast<size_t>(K) * N;
  split_tf32_kernel<<<static_cast<unsigned>(std::min(1024LL, (n4 + 255) / 256)), 256, 0, st>>>(
      static_cast<const float4*>(w), reinterpret_cast<uint4*>(w_hi), reinterpret_cast<uint4*>(w_lo),
      n4);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  CUtensorMap tm_g, tm_whi, tm_wlo;
  rc = make_map(&tm_g, g, N, M, kDaBM);
  if (rc == 0) rc = make_map(&tm_whi, w_hi, N, K, bn);
  if (rc == 0) rc = make_map(&tm_wlo, w_lo, N, K, bn);
  if (rc != 0) return rc;
  const int variant = (bn == 128) * 2 + with_res;
  decltype(&bwd_da_tf32_kernel<64, false>) kernel;
  switch (variant) {
    case 0: kernel = bwd_da_tf32_kernel<64, false>; break;
    case 1: kernel = bwd_da_tf32_kernel<64, true>; break;
    case 2: kernel = bwd_da_tf32_kernel<128, false>; break;
    default: kernel = bwd_da_tf32_kernel<128, true>; break;
  }
  static bool configured[4] = {};
  rc = opt_in(kernel, configured[variant]);
  if (rc != 0) return rc;
  const int stages = da_stages(bn);
  auto* pp = static_cast<float*>(partial);
  kernel<<<grid, kTcThreads, da_smem_bytes(bn, stages), st>>>(
      tm_g, tm_whi, tm_wlo, static_cast<const float*>(y), static_cast<const float*>(res),
      static_cast<const float*>(s), static_cast<const float*>(t),
      static_cast<const float*>(mean), static_cast<const float*>(inv), static_cast<float*>(gt),
      pp, M, K, N, stages);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  return sum_rows(pp, static_cast<float*>(sums), grid, 2LL * K, st);
}

// Dynamic shared memory of one K2f CTA of tile width bn (-1: no such tile).
extern "C" int dsst_bn_relu_matmul_bwd_da_f32_smem_bytes(int bn) {
  if (bn != 64 && bn != 128) return -1;
  return da_smem_bytes(bn, da_stages(bn));
}

// K3f. tile_k the output tile's channels, 64 or 128 (the wrapper's
// dw_tile_k); partial [splits, K, N] f32 scratch, chunk rows of M per split
// (a multiple of 32; splits = ceil(M / chunk)), one CTA per 128-column
// output tile and split; dw [K,N].
extern "C" int dsst_bn_relu_matmul_bwd_dw_f32(const void* y, const void* res, const void* s,
                                              const void* t, const void* g, void* partial,
                                              void* dw, int M, int K, int N, int tile_k,
                                              int splits, int chunk, void* stream) {
  if (bad_shape(M, K, N) || (tile_k != 64 && tile_k != 128) || splits < 1 || chunk < 1 ||
      chunk % kDepth != 0 || static_cast<long long>(splits - 1) * chunk >= M)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool with_res = res != nullptr;
  const int tiles_k = (K + tile_k - 1) / tile_k;
  const long long tiles = static_cast<long long>(tiles_k) * ((N + kDwBN - 1) / kDwBN);
  const long long grid = tiles * splits;
  if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_y, tm_res, tm_g;
  int rc = make_map(&tm_y, y, K, M, kDepth);
  if (rc == 0) rc = make_map(&tm_res, with_res ? res : y, K, M, kDepth);
  if (rc == 0) rc = make_map(&tm_g, g, N, M, kDepth);
  if (rc != 0) return rc;
  const int variant = (tile_k == 128) * 2 + with_res;
  decltype(&bwd_dw_tf32_kernel<64, false>) kernel;
  switch (variant) {
    case 0: kernel = bwd_dw_tf32_kernel<64, false>; break;
    case 1: kernel = bwd_dw_tf32_kernel<64, true>; break;
    case 2: kernel = bwd_dw_tf32_kernel<128, false>; break;
    default: kernel = bwd_dw_tf32_kernel<128, true>; break;
  }
  static bool configured[4] = {};
  rc = opt_in(kernel, configured[variant]);
  if (rc != 0) return rc;
  const int stages = dw_stages(tile_k, with_res);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* pp = static_cast<float*>(partial);
  kernel<<<static_cast<unsigned>(grid), kTcThreads, dw_smem_bytes(tile_k, with_res, stages),
           st>>>(tm_y, tm_res, tm_g, static_cast<const float*>(s), static_cast<const float*>(t),
                 pp, M, K, N, chunk, stages);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  return sum_rows(pp, static_cast<float*>(dw), splits, static_cast<long long>(K) * N, st);
}

// Dynamic shared memory of one K3f CTA of tile_k channels (-1: no such tile).
extern "C" int dsst_bn_relu_matmul_bwd_dw_f32_smem_bytes(int tile_k, int with_res) {
  if (tile_k != 64 && tile_k != 128) return -1;
  return dw_smem_bytes(tile_k, with_res, dw_stages(tile_k, with_res));
}
