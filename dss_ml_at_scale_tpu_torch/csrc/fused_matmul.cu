// Fused BN-apply + ReLU + 1x1 conv (a matrix product) and its two backward
// kernels, for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of
// dss_ml_at_scale_tpu/ops/fused_matmul.py:
//   K1 _fwd_kernel     out[M,N] = bf16(relu(y*s + t [+ res])) @ W[K,N]
//   K2 _bwd_da_kernel  gt[M,K]  = (g[M,N] @ W^T) * [y*s + t (+ res) > 0],
//                      plus sum_g[K] = sum_M gt, sum_gx[K] = sum_M gt * x_hat
//                      with x_hat = (y - mean) * inv, from the f32 gt
//   K3 _bwd_dw_kernel  dW[K,N]  = sum_M bf16(relu(y*s + t [+ res]))^T @ g
// with s = gamma * rsqrt(var + eps) and t = beta - mean * s given per
// channel. The normalized activation a = relu(y*s + t) never reaches device
// memory: K1 and K3 build it in registers, from the y tile in shared memory to
// the register A operand of the product; K2 recomputes the ReLU mask in its
// epilogue.
//
// Design. All three are warp-specialised wgmma kernels built on one
// machinery: TMA loads into a ring of stages driven by mbarriers, fed by
// one thread of a producer warpgroup that hands its registers to two
// consumer warpgroups (setmaxnreg), every tile in the 128-byte swizzle of
// hopper.cuh, out-of-bounds rows and columns zero-filled by TMA. Every
// kernel takes any M and masks the ragged edge; K and N must be multiples
// of 8 (16-byte rows for TMA).
//   K1: 128 x 256 tiles of out, one CTA per SM walking them (its section).
//   K2: 128-row tiles of gt, BN = 64 or 128 channels wide (the wrapper's
//       choice, da_tile_n); one CTA per SM walking them, the channel bands
//       of an M band first. The TPU kernel
//       carries the two channel sums across its sequential grid; here each
//       CTA carries them across its walk in a private [2K] row of f32 partials
//       and a second pass adds the rows in a fixed order.
//   K3: 128 x 256 or 64 x 256 tiles of dW (the wrapper's choice, dw_tile_k:
//       64 channels at K <= 64); a reduction over M (664,832 rows at stage 1
//       against one output tile), so each tile's rows
//       are split over CTAs, each summing a run of M into a [splits, K, N] f32
//       scratch that the same fixed-order pass adds; one CTA per (tile, run),
//       the runs chosen to fill the SMs once.
// No atomics anywhere: the sums, and so the gradients, are the same from run
// to run.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): each ResNet-50
// bottleneck site does M*K*N = 1.09e10 multiply-adds at batch 212. K1 moves
// y and out (2*M*(K+N) bytes): at stage 1 (K=64, N=256) that is 425 MB, so
// bytes bound it (0.127 ms) and not operations (0.022 ms); at stage 4 (K=512,
// N=2048, M=10,388) operations bound it. K2 reads g and y and writes gt; K3
// reads y and g: both are bytes-bound at stages 1-3. K1 and K3 read their
// [M,K] operand once per 256 columns of N; K2 reads g from device memory
// once (the channel bands of an M band run side by side, so all but one
// read it from L2). All three keep loads, products and stores in flight
// together.

#include <algorithm>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kSmemLimit = 232448;  // what one CTA may opt in to on an H100

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// Four 8x8 bf16 matrices from shared memory, each transposed on the way into
// the registers; lane l gives the address of a row of matrix l / 8.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// z = y*s + t (+ res), rounded after each operation as the plain version's
// separate torch ops round (no fused multiply-add): the ReLU mask of K2 and
// the rounded a of K1/K3 then match the plain version bit for bit.
__device__ __forceinline__ float bn_pre(float y, float s, float t) {
  return __fadd_rn(__fmul_rn(y, s), t);
}

// ---------------------------------------------------------------------------
// K1: out = bf16(relu(y*s + t [+ res])) @ W.  y, res [M,K]; W [K,N]; out [M,N].
//
// Persistent: one CTA per SM walks 128 x 256 output tiles, M first within
// a 256-wide band of N, so W's band stays in L2 and, at N <= 256, y is read
// exactly once. Warps 0-7 are two consumer warpgroups (64 rows each), warps
// 8-11 the producer warpgroup, which gives its registers to the consumers
// (setmaxnreg: 40 against 232 a thread) and whose one thread keeps a ring
// of stages full by TMA: a 128 x 64 y tile (and res tile) and a 64 x 256 W
// tile per stage, each in the 128-byte swizzle, with out-of-bounds rows and
// columns zero-filled (the ragged M, K and N). A consumer reads its y
// fragment with ldmatrix from the swizzled tile, applies the BN prologue in
// registers (s and t are staged in shared memory once per CTA) and issues
// wgmma m64n256k16 with that A from registers and W from a shared-memory
// descriptor; the two A buffers let one step's prologue run while the
// previous product is in flight. The epilogue rounds the accumulators to
// bf16 into a swizzled staging tile and TMA-stores it in full 128-byte rows;
// the store runs on while the CTA multiplies its next tile.
// ---------------------------------------------------------------------------
constexpr int kFwdBM = 128, kFwdBN = 256, kFwdBK = 64;
constexpr int kFwdConsumerWarps = 8;
constexpr int kFwdThreads = kFwdConsumerWarps * 32 + 128;
constexpr int kFwdYBytes = kFwdBM * kFwdBK * 2;  // 16 KB, one SW128 block of 128 rows
constexpr int kFwdWBytes = kFwdBK * kFwdBN * 2;  // 32 KB, four SW128 blocks of 64 rows
constexpr int kFwdStageBytes = kFwdBM * kFwdBN * 2;  // 64 KB, two warpgroups' 64 x 256
// Bytes of dynamic shared memory for `stages` ring stages.
__host__ __device__ constexpr int fwd_smem_bytes(int stages, bool res, int k_pad) {
  return 1024 + stages * (kFwdYBytes * (res ? 2 : 1) + kFwdWBytes) + kFwdStageBytes +
         2 * k_pad * 4 + 2 * stages * 8;
}

// As many ring stages as fit beside the rest, up to 4 (fewer than 2: K is
// too large for the ring).
int fwd_stages(int K, bool res) {
  const int k_pad = (K + kFwdBK - 1) / kFwdBK * kFwdBK;
  const int stage = kFwdYBytes * (res ? 2 : 1) + kFwdWBytes;
  return std::min(4, (kSmemLimit - fwd_smem_bytes(0, res, k_pad)) / (stage + 16));
}

__device__ __forceinline__ uint32_t bn_relu2(uint32_t yv, float2 s, float2 t) {
  const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&yv));
  return pack2(fmaxf(bn_pre(y.x, s.x, t.x), 0.f), fmaxf(bn_pre(y.y, s.y, t.y), 0.f));
}

__device__ __forceinline__ uint32_t bn_relu2(uint32_t yv, float2 s, float2 t, uint32_t rv) {
  const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&yv));
  const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rv));
  return pack2(fmaxf(__fadd_rn(bn_pre(y.x, s.x, t.x), r.x), 0.f),
               fmaxf(__fadd_rn(bn_pre(y.y, s.y, t.y), r.y), 0.f));
}

template <bool RES>
__global__ void __launch_bounds__(kFwdThreads, 1)
fwd_kernel(const __grid_constant__ CUtensorMap tm_y, const __grid_constant__ CUtensorMap tm_res,
           const __grid_constant__ CUtensorMap tm_w, const __grid_constant__ CUtensorMap tm_out,
           const float* __restrict__ s, const float* __restrict__ t, int M, int K, int N,
           int stages) {
  constexpr int kYStage = kFwdYBytes * (RES ? 2 : 1);
  constexpr int kStage = kYStage + kFwdWBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  const int k_blocks = (K + kFwdBK - 1) / kFwdBK, k_pad = k_blocks * kFwdBK;
  const int tiles_m = (M + kFwdBM - 1) / kFwdBM;
  const int tiles = tiles_m * ((N + kFwdBN - 1) / kFwdBN);
  const uint32_t s_ring = smem_u32(smem);  // stage i: y [, res], W
  uint8_t* staging = smem + stages * kStage;  // two 32 KB halves, one per warpgroup
  float* s_s = reinterpret_cast<float*>(staging + kFwdStageBytes);
  float* s_t = s_s + k_pad;
  uint64_t* full = reinterpret_cast<uint64_t*>(s_t + k_pad);
  uint64_t* empty = full + stages;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kFwdConsumerWarps);
    }
    mbar_fence_init();
  }
  for (int i = tid; i < k_pad; i += kFwdThreads) {  // zero past K: the padded a is 0
    s_s[i] = i < K ? s[i] : 0.f;
    s_t[i] = i < K ? t[i] : 0.f;
  }
  __syncthreads();

  if (warp >= kFwdConsumerWarps) {
    // Producer: one thread issues every TMA load of this CTA's tiles.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == kFwdConsumerWarps && lane == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % tiles_m) * kFwdBM, n0 = (tile / tiles_m) * kFwdBN;
        for (int kb = 0; kb < k_blocks; ++kb, ++it) {
          const int st = it % stages;
          mbar_wait(&empty[st], ((it / stages) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[st], kStage);
          const uint32_t base = s_ring + st * kStage;
          tma_load_2d(base, &tm_y, &full[st], kb * kFwdBK, m0);
          if (RES) tma_load_2d(base + kFwdYBytes, &tm_res, &full[st], kb * kFwdBK, m0);
#pragma unroll
          for (int b = 0; b < kFwdBN / 64; ++b)
            tma_load_2d(base + kYStage + b * 8192, &tm_w, &full[st], n0 + b * 64, kb * kFwdBK);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of each tile.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warp / 4, wt = tid % 128, wl = warp % 4;
  const int g = lane >> 2, tq = lane & 3;
  const int a_row = wg * 64 + wl * 16 + (lane & 15);  // this lane's ldmatrix row
  uint8_t* stage_out = staging + wg * (kFwdStageBytes / 2);
  float acc[kFwdBN / 2];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile % tiles_m) * kFwdBM, n0 = (tile / tiles_m) * kFwdBN;
    for (int kb = 0; kb < k_blocks; ++kb, ++it) {
      const int st = it % stages;
      mbar_wait(&full[st], (it / stages) & 1);
      const uint32_t base = s_ring + st * kStage;
      uint32_t a[2][4];
#pragma unroll
      for (int ks = 0; ks < kFwdBK / 16; ++ks) {
        // y fragment of rows a_row, channels [16 ks, 16 ks + 16) of the block.
        const uint32_t off = sw128(a_row, ks * 2 + (lane >> 4));
        uint32_t yv[4];
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(yv[0]), "=r"(yv[1]), "=r"(yv[2]), "=r"(yv[3])
                     : "r"(base + off));
        const int kc = kb * kFwdBK + ks * 16 + tq * 2;
        const float2 s0 = *reinterpret_cast<const float2*>(s_s + kc);
        const float2 s1 = *reinterpret_cast<const float2*>(s_s + kc + 8);
        const float2 t0 = *reinterpret_cast<const float2*>(s_t + kc);
        const float2 t1 = *reinterpret_cast<const float2*>(s_t + kc + 8);
        uint32_t(&av)[4] = a[ks & 1];
        if (RES) {
          uint32_t rv[4];
          asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                       : "=r"(rv[0]), "=r"(rv[1]), "=r"(rv[2]), "=r"(rv[3])
                       : "r"(base + kFwdYBytes + off));
          av[0] = bn_relu2(yv[0], s0, t0, rv[0]);
          av[1] = bn_relu2(yv[1], s0, t0, rv[1]);
          av[2] = bn_relu2(yv[2], s1, t1, rv[2]);
          av[3] = bn_relu2(yv[3], s1, t1, rv[3]);
        } else {
          av[0] = bn_relu2(yv[0], s0, t0);
          av[1] = bn_relu2(yv[1], s0, t0);
          av[2] = bn_relu2(yv[2], s1, t1);
          av[3] = bn_relu2(yv[3], s1, t1);
        }
        wgmma_fence();
        wgmma_m64n256k16_rs<1>(acc, av, sw128_desc(base + kYStage + ks * 2048, 8192, 1024),
                               (kb | ks) != 0);
        wgmma_commit();
        wgmma_wait<1>();  // the product before this one is done: its A buffer is free
      }
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    // Epilogue: the previous tile's store must have read the staging tile.
    if (wt == 0) bulk_wait_read<0>();
    named_bar_sync(1 + wg, 128);
    const uint32_t out_base = smem_u32(stage_out);
#pragma unroll
    for (int i = 0; i < kFwdBN / 8; ++i) {
      const int r = wl * 16 + g;
      const uint32_t addr = out_base + (i / 8) * 8192 + sw128(r, i % 8) + tq * 4;
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(pack2(acc[4 * i], acc[4 * i + 1])));
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr + 8 * 128),
                   "r"(pack2(acc[4 * i + 2], acc[4 * i + 3])));
    }
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);
    if (wt == 0 && m0 + wg * 64 < M) {
#pragma unroll
      for (int b = 0; b < kFwdBN / 64; ++b)
        if (n0 + b * 64 < N) tma_store_2d(&tm_out, out_base + b * 8192, n0 + b * 64, m0 + wg * 64);
      bulk_commit();
    }
  }
  if (wt == 0) bulk_wait<0>();
}

// ---------------------------------------------------------------------------
// K2: gt = (g @ W^T) * [y*s + t (+ res) > 0], stored bf16, and the column
// sums of the f32 gt and of gt * x_hat.  g [M,N]; W [K,N]; y, res, gt [M,K].
//
// wgmma m64nBNk16 with A = the g tile (n, the reduction, contiguous: K-major,
// from a shared-memory descriptor) and B = W's rows [k][n] (K-major too).
// Persistent: one CTA per SM walks 128 x BN tiles of gt, the channel bands
// of an M band first, so neighbouring CTAs read the same rows of g at the
// same time and all but one of them find it in L2. The producer thread keeps
// a ring of 64-deep stages full (a 128 x 64 g tile and a BN x 64 W tile) and,
// once per tile, loads the y tile (and res tile) of the output tile into an
// epilogue buffer, after the first ring's worth of the tile's stages so the
// previous tile's epilogue does not hold up the ring. The epilogue reads y
// from that buffer, applies the ReLU mask with bn_pre's rounding, writes the
// bf16 gt over y in place (the same thread reads and writes each element) and
// TMA-stores it; the buffer goes back to the producer when the store has read
// it. Each warp sums its 16 rows of each column (shuffles over the 8 row
// groups of a lane quad), the 8 warps' sums are added in a fixed order
// through shared memory, and each CTA adds them, tile by tile in walk order,
// to its own [2K] row of partials in device memory: one row per CTA (at most
// one per SM) for the fixed-order second pass.
// ---------------------------------------------------------------------------
constexpr int kDaBM = 128;
constexpr int kDaThreads = 8 * 32 + 128;
constexpr int kDaABytes = kDaBM * 64 * 2;  // 16 KB: 128 rows x 64 columns of g

__host__ __device__ constexpr int da_epi_bytes(int bn, bool res) {
  return kDaBM * bn * 2 * (res ? 2 : 1);  // the y tile, then the res tile
}

// Bytes of dynamic shared memory: alignment slack, the ring, the epilogue
// buffer, the 8 warps' column sums, the barriers.
__host__ __device__ constexpr int da_smem_bytes(int bn, bool res, int stages) {
  return 1024 + stages * (kDaABytes + bn * 128) + da_epi_bytes(bn, res) + 8 * 2 * bn * 4 +
         (2 * stages + 2) * 8;
}

// As many ring stages as fit, up to 6 (faster than 4 at the four stage
// shapes: scripts/compare_torch_kernels.py). The ring needs two: a consumer
// frees a slot only once the next stage's products are issued.
int da_stages(int bn, bool res) {
  return std::min(6, (kSmemLimit - da_smem_bytes(bn, res, 0)) / (kDaABytes + bn * 128 + 16));
}

template <int BN>
__device__ __forceinline__ void wgmma_kmajor_ss(float (&d)[BN / 2], uint64_t a, uint64_t b,
                                                int scale_d) {
  static_assert(BN == 64 || BN == 128, "K2 tiles are 64 or 128 channels wide");
  if constexpr (BN == 64) {
    wgmma_m64n64k16_ss<0>(d, a, b, scale_d);
  } else {
    wgmma_m64n128k16_ss<0>(d, a, b, scale_d);
  }
}

template <int BN, bool RES>
__global__ void __launch_bounds__(kDaThreads, 1)
bwd_da_kernel(const __grid_constant__ CUtensorMap tm_g, const __grid_constant__ CUtensorMap tm_w,
              const __grid_constant__ CUtensorMap tm_y, const __grid_constant__ CUtensorMap tm_res,
              const __grid_constant__ CUtensorMap tm_gt, const float* __restrict__ s,
              const float* __restrict__ t, const float* __restrict__ mean,
              const float* __restrict__ inv, float* __restrict__ partial, int M, int K, int N,
              int stages) {
  constexpr int kStage = kDaABytes + BN * 128;
  constexpr int kYBytes = kDaBM * BN * 2;  // the y tile: BN / 64 SW128 blocks of 128 rows
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  const uint32_t s_ring = smem_u32(smem);
  const uint32_t s_epi = s_ring + stages * kStage;
  float* red = reinterpret_cast<float*>(smem + stages * kStage + da_epi_bytes(BN, RES));
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 8 * 2 * BN);
  uint64_t* empty = full + stages;
  uint64_t* epi_full = empty + stages;
  uint64_t* epi_empty = epi_full + 1;
  const int tiles_k = (K + BN - 1) / BN;
  const int tiles = (M + kDaBM - 1) / kDaBM * tiles_k;
  const int n_kb = (N + 63) / 64;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);
    }
    mbar_init(epi_full, 1);
    mbar_init(epi_empty, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {
    // Producer: one thread issues every TMA load of this CTA's tiles.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 8 && lane == 0) {
      const int pre = min(stages, n_kb);
      int it = 0, lt = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++lt) {
        const int m0 = (tile / tiles_k) * kDaBM, k0 = (tile % tiles_k) * BN;
        const int y_blocks = min(BN / 64, (K - k0 + 63) / 64);  // blocks wholly past K stay out
        for (int kb = 0; kb < n_kb; ++kb, ++it) {
          const int st = it % stages;
          mbar_wait(&empty[st], ((it / stages) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[st], kStage);
          const uint32_t base = s_ring + st * kStage;
          tma_load_2d(base, &tm_g, &full[st], kb * 64, m0);
          tma_load_2d(base + kDaABytes, &tm_w, &full[st], kb * 64, k0);
          if (kb == pre - 1) {
            mbar_wait(epi_empty, (lt & 1) ^ 1);
            mbar_arrive_expect_tx(epi_full, y_blocks * 16384 * (RES ? 2 : 1));
            for (int b = 0; b < y_blocks; ++b) {
              tma_load_2d(s_epi + b * 16384, &tm_y, epi_full, k0 + b * 64, m0);
              if (RES) tma_load_2d(s_epi + kYBytes + b * 16384, &tm_res, epi_full, k0 + b * 64, m0);
            }
          }
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of each tile.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warp / 4, wl = warp % 4;
  const int g = lane >> 2, tq = lane & 3;
  // This CTA's row of partials: (sum_g, sum_gx) of column k at [k], [K + k].
  // Entry (which, k) is always added to by thread (which * BN + k % BN) % 256,
  // which zeroes it here: each entry is one thread's, in walk order.
  float* part = partial + static_cast<size_t>(blockIdx.x) * 2 * K;
  for (int band = 0; band < tiles_k; ++band)
    for (int idx = tid; idx < 2 * BN; idx += 256) {
      const int k = band * BN + idx % BN;
      if (k < K) part[(idx / BN) * K + k] = 0.f;
    }
  float* red_w = red + warp * 2 * BN;  // this warp's [sum_g | sum_gx] of the tile's columns
  float acc[BN / 2];
  int it = 0, lt = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++lt) {
    const int m0 = (tile / tiles_k) * kDaBM, k0 = (tile % tiles_k) * BN;
    int prev = 0;
    for (int kb = 0; kb < n_kb; ++kb, ++it) {
      const int st = it % stages;
      mbar_wait(&full[st], (it / stages) & 1);
      const uint32_t base = s_ring + st * kStage;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_kmajor_ss<BN>(acc, sw128_desc(base + wg * 8192 + ks * 32, 16, 1024),
                            sw128_desc(base + kDaABytes + ks * 32, 16, 1024), (kb | ks) != 0);
      wgmma_commit();
      if (kb > 0) {  // the previous stage's products are done: its slot is free
        wgmma_wait<1>();
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      prev = st;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[prev]);

    // Epilogue: the mask from the y tile, gt over y in place, column sums.
    mbar_wait(epi_full, lt & 1);
    const int r0 = wg * 64 + wl * 16 + g;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int c = k0 + 8 * i + 2 * tq;
      float2 sc = make_float2(0.f, 0.f), tc = sc, mc = sc, ic = sc;
      if (c < K) {
        sc = *reinterpret_cast<const float2*>(s + c);
        tc = *reinterpret_cast<const float2*>(t + c);
        mc = *reinterpret_cast<const float2*>(mean + c);
        ic = *reinterpret_cast<const float2*>(inv + c);
      }
      float pg0 = 0.f, pg1 = 0.f, px0 = 0.f, px1 = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint32_t addr = s_epi + (i / 8) * 16384 + sw128(r0 + 8 * half, i % 8) + tq * 4;
        uint32_t yv;
        asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(yv) : "r"(addr));
        const float2 yf = unpack2(yv);
        float z0 = bn_pre(yf.x, sc.x, tc.x), z1 = bn_pre(yf.y, sc.y, tc.y);
        if (RES) {
          uint32_t rv;
          asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(rv) : "r"(addr + kYBytes));
          const float2 rf = unpack2(rv);
          z0 = __fadd_rn(z0, rf.x);
          z1 = __fadd_rn(z1, rf.y);
        }
        const float g0 = z0 > 0.f ? acc[4 * i + 2 * half] : 0.f;
        const float g1 = z1 > 0.f ? acc[4 * i + 2 * half + 1] : 0.f;
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(pack2(g0, g1)));
        pg0 += g0;
        pg1 += g1;
        px0 += g0 * ((yf.x - mc.x) * ic.x);
        px1 += g1 * ((yf.y - mc.y) * ic.y);
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        pg0 += __shfl_xor_sync(0xffffffffu, pg0, off);
        pg1 += __shfl_xor_sync(0xffffffffu, pg1, off);
        px0 += __shfl_xor_sync(0xffffffffu, px0, off);
        px1 += __shfl_xor_sync(0xffffffffu, px1, off);
      }
      if (g == 0) {
        *reinterpret_cast<float2*>(red_w + 8 * i + 2 * tq) = make_float2(pg0, pg1);
        *reinterpret_cast<float2*>(red_w + BN + 8 * i + 2 * tq) = make_float2(px0, px1);
      }
    }
    fence_proxy_async();  // gt in shared memory, visible to the TMA store
    named_bar_sync(1, 256);
    if (tid == 0) {
      for (int b = 0; b < BN / 64; ++b)
        if (k0 + b * 64 < K) tma_store_2d(&tm_gt, s_epi + b * 16384, k0 + b * 64, m0);
      bulk_commit();
      bulk_wait_read<0>();  // the store has read the buffer: the next y tile may land
      mbar_arrive(epi_empty);
    }
    for (int idx = tid; idx < 2 * BN; idx += 256) {
      const int which = idx / BN, c = idx % BN, k = k0 + c;
      if (k < K) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < 8; ++w) v += red[(w * 2 + which) * BN + c];
        part[which * K + k] += v;
      }
    }
    named_bar_sync(1, 256);  // the column sums are read: the next tile may write them
  }
  if (tid == 0) bulk_wait<0>();
}

// ---------------------------------------------------------------------------
// K3: partial[z] = sum over run z of M of bf16(relu(y*s + t [+ res]))^T @ g,
// a [K,N] f32 slab per run.  y, res [M,K]; g [M,N].
//
// wgmma m64n256k16 with dW's rows (the channels k) as its M dimension, 64 per
// consumer warpgroup, N as its N dimension and the rows m of the batch as the
// reduction. One work item per CTA: one output tile (128 channels x 256
// columns, or 64 x 256: tile_k) summed over one run of M, the runs a
// multiple of the ring's 64 rows so no stage crosses into the next run (TMA
// zero-fills only at the tensor's edge). The plan (ops/fused_matmul.py,
// dw_plan) splits M so that the grid fills the SMs once. The producer thread
// keeps a ring of stages full: the y tile (and res tile) of 64 rows x the
// tile's channels and the g tile of 64 rows x 256 columns. The A operand
// a^T comes from the y tile by a transposed ldmatrix, the BN prologue is
// applied in registers (each lane's fragment covers two channels: their s
// and t are four registers), and g is the MN-major B operand, as W is K1's.
// With 64-channel tiles (ALT) the two warpgroups share the one tile and take
// alternate stages; warpgroup 1's sums then pass through shared memory and
// warpgroup 0 adds them to its own, in that order. Rows past M add nothing
// only because g's zero-filled rows multiply them (relu(0*s + t) is not 0).
// ---------------------------------------------------------------------------
constexpr int kDwBM = 64, kDwBN = 256;  // rows of M per stage; output tile width
constexpr int kDwThreads = 8 * 32 + 128;
constexpr int kDwBox = kDwBM * 64 * 2;  // 8 KB: 64 rows x 64 columns, one SW128 block
constexpr int kDwGBytes = kDwBM * kDwBN * 2;  // 32 KB

__host__ __device__ constexpr int dw_y_bytes(bool alt, bool res) {
  return kDwBox * (alt ? 1 : 2) * (res ? 2 : 1);
}

__host__ __device__ constexpr int dw_smem_bytes(bool alt, bool res, int stages) {
  return 1024 + stages * (dw_y_bytes(alt, res) + kDwGBytes + 16);
}

// As many ring stages as fit, up to 4; an even number when the warpgroups
// take alternate stages, so each keeps its own slots.
int dw_stages(bool alt, bool res) {
  const int n = std::min(4, (kSmemLimit - 1024) / (dw_y_bytes(alt, res) + kDwGBytes + 16));
  return alt ? n & ~1 : n;
}

template <bool RES, bool ALT>
__global__ void __launch_bounds__(kDwThreads, 1)
bwd_dw_kernel(const __grid_constant__ CUtensorMap tm_y, const __grid_constant__ CUtensorMap tm_res,
              const __grid_constant__ CUtensorMap tm_g, const float* __restrict__ s,
              const float* __restrict__ t, float* __restrict__ partial, int M, int K, int N,
              int chunk, int stages) {
  constexpr int kTileK = ALT ? 64 : 128;
  constexpr int kYHalf = kDwBox * (ALT ? 1 : 2);  // the y blocks; the res blocks follow
  constexpr int kYStage = dw_y_bytes(ALT, RES);
  constexpr int kStage = kYStage + kDwGBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  const uint32_t s_ring = smem_u32(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * kStage);
  uint64_t* empty = full + stages;
  // Work item blockIdx.x: run z of output tile `tile`; the tiles of one run
  // are neighbours, so CTAs that run together read the same rows of y and g.
  const int tiles_k = (K + kTileK - 1) / kTileK;
  const int tiles = tiles_k * ((N + kDwBN - 1) / kDwBN);
  const int z = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int k0 = (tile % tiles_k) * kTileK, n0 = (tile / tiles_k) * kDwBN;
  const int m_begin = z * chunk;
  const int n_st = max(0, (min(M, m_begin + chunk) - m_begin + kDwBM - 1) / kDwBM);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], ALT ? 4 : 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 8 && lane == 0) {
      // Blocks wholly past K or N stay out: the rows of dW and the columns
      // they would feed are never stored, and no other depends on them.
      const int y_boxes = ALT ? 1 : (k0 + 64 < K ? 2 : 1);
      const int g_boxes = min(4, (N - n0 + 63) / 64);
      const uint32_t bytes = (y_boxes * (RES ? 2 : 1) + g_boxes) * kDwBox;
      for (int j = 0; j < n_st; ++j) {
        const int st = j % stages, m = m_begin + j * kDwBM;
        mbar_wait(&empty[st], ((j / stages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], bytes);
        const uint32_t base = s_ring + st * kStage;
        for (int b = 0; b < y_boxes; ++b) {
          tma_load_2d(base + b * kDwBox, &tm_y, &full[st], k0 + b * 64, m);
          if (RES) tma_load_2d(base + kYHalf + b * kDwBox, &tm_res, &full[st], k0 + b * 64, m);
        }
        for (int b = 0; b < g_boxes; ++b)
          tma_load_2d(base + kYStage + b * 8192, &tm_g, &full[st], n0 + b * 64, m);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warp / 4, wt = tid % 128, wl = warp % 4;
  const int g = lane >> 2, tq = lane & 3;
  // The lane's A fragment: channels c_lo (rows g of its warp's 16) and
  // c_lo + 8; s and t zero past K, so the padded a is 0.
  const int c_lo = k0 + (ALT ? 0 : wg * 64) + wl * 16 + g, c_hi = c_lo + 8;
  const float s_lo = c_lo < K ? s[c_lo] : 0.f, t_lo = c_lo < K ? t[c_lo] : 0.f;
  const float s_hi = c_hi < K ? s[c_hi] : 0.f, t_hi = c_hi < K ? t[c_hi] : 0.f;
  const float2 sl = make_float2(s_lo, s_lo), tl = make_float2(t_lo, t_lo);
  const float2 sh = make_float2(s_hi, s_hi), th = make_float2(t_hi, t_hi);
  // Transposed ldmatrix: lane l gives row l % 8 of matrix l / 8. Matrices 0
  // and 1 hold rows 0-7 of the 16-row step, 2 and 3 rows 8-15; 0 and 2 the
  // warp's channels [16 wl, 16 wl + 8), 1 and 3 the next 8. Transposed, they
  // are the a0..a3 registers of the m64k16 A fragment of a^T.
  const int l_row = ((lane >> 4) << 3) + (lane & 7), l_chunk = wl * 2 + ((lane >> 3) & 1);
  const uint32_t y_off = ALT ? 0u : static_cast<uint32_t>(wg * kDwBox);
  float acc[kDwBN / 2];
#pragma unroll
  for (int i = 0; i < kDwBN / 2; ++i) acc[i] = 0.f;
  for (int j = ALT ? wg : 0; j < n_st; j += ALT ? 2 : 1) {
    const int st = j % stages;
    mbar_wait(&full[st], (j / stages) & 1);
    const uint32_t base = s_ring + st * kStage;
    uint32_t a[2][4];
#pragma unroll
    for (int ks = 0; ks < kDwBM / 16; ++ks) {
      const uint32_t off = y_off + sw128(ks * 16 + l_row, l_chunk);
      uint32_t yv[4];
      ldsm_x4_trans(yv, base + off);
      uint32_t(&av)[4] = a[ks & 1];
      if (RES) {
        uint32_t rv[4];
        ldsm_x4_trans(rv, base + kYHalf + off);
        av[0] = bn_relu2(yv[0], sl, tl, rv[0]);
        av[1] = bn_relu2(yv[1], sh, th, rv[1]);
        av[2] = bn_relu2(yv[2], sl, tl, rv[2]);
        av[3] = bn_relu2(yv[3], sh, th, rv[3]);
      } else {
        av[0] = bn_relu2(yv[0], sl, tl);
        av[1] = bn_relu2(yv[1], sh, th);
        av[2] = bn_relu2(yv[2], sl, tl);
        av[3] = bn_relu2(yv[3], sh, th);
      }
      wgmma_fence();
      wgmma_m64n256k16_rs<1>(acc, av, sw128_desc(base + kYStage + ks * 2048, 8192, 1024), 1);
      wgmma_commit();
      wgmma_wait<1>();  // the product before this one is done: its A buffer is free
    }
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  if (ALT) {
    // Both warpgroups are done with the ring; it now carries warpgroup 1's
    // sums to warpgroup 0.
    float* xfer = reinterpret_cast<float*>(smem);
    named_bar_sync(1, 256);
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < kDwBN / 2; ++i) xfer[i * 128 + wt] = acc[i];
    }
    named_bar_sync(1, 256);
    if (wg == 1) return;
#pragma unroll
    for (int i = 0; i < kDwBN / 2; ++i) acc[i] += xfer[i * 128 + wt];
  }
  float* slab = partial + static_cast<size_t>(z) * K * N;
  const int row = k0 + (ALT ? 0 : wg * 64) + wl * 16 + g;
#pragma unroll
  for (int i = 0; i < kDwBN / 8; ++i) {
    const int col = n0 + 8 * i + 2 * tq;
    if (col >= N) continue;
    if (row < K)
      *reinterpret_cast<float2*>(slab + static_cast<size_t>(row) * N + col) =
          make_float2(acc[4 * i], acc[4 * i + 1]);
    if (row + 8 < K)
      *reinterpret_cast<float2*>(slab + static_cast<size_t>(row + 8) * N + col) =
          make_float2(acc[4 * i + 2], acc[4 * i + 3]);
  }
}

// ---------------------------------------------------------------------------
// The second pass of K2 and K3: out[c] = sum_r part[r, c] in a fixed order,
// so the result does not depend on how blocks were run. Row group rg of G
// adds rows rg, rg + G, ... in turn and the groups are added in index order;
// G = 1 (each thread adds its column's rows in turn) below 32 rows, where
// most of the 16 row groups would idle: K3 at stages 3-4 took 14% and 42%
// less time with it, and from 32 rows it is the slower form (PERF.md).
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

// A 2-D TMA map of a row-major bf16 [outer, inner] matrix, boxes of
// box_outer rows x box_inner columns in the 128-byte swizzle, zero fill
// out of bounds.
int make_map(CUtensorMap* map, const void* ptr, int inner, int outer, int box_inner,
             int box_outer) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner), static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// All pointers are device pointers, 16-byte aligned; y, res, w, g, gt are
// bf16 and contiguous; s, t, mean, inv are [K] f32. res may be null (the
// variant without a residual). Each function launches on `stream` and
// returns cudaGetLastError() after its launches (0 when they were accepted).

// K1. out [M,N] bf16; sm_count CTAs at most (one per SM). The tensor maps
// are encoded here at every call, through the driver's entry point (no
// -lcuda at link time).
extern "C" int dsst_bn_relu_matmul_fwd(const void* y, const void* res, const void* s, const void* t,
                                       const void* w, void* out, int M, int K, int N, int sm_count,
                                       void* stream) {
  const bool with_res = res != nullptr;
  const int k_pad = (K + kFwdBK - 1) / kFwdBK * kFwdBK;
  const int stages = fwd_stages(K, with_res);
  if (stages < 2) return static_cast<int>(cudaErrorInvalidValue);  // K too large for the ring
  CUtensorMap tm_y, tm_res, tm_w, tm_out;
  int rc = make_map(&tm_y, y, K, M, kFwdBK, kFwdBM);
  if (rc == 0) rc = make_map(&tm_res, with_res ? res : y, K, M, kFwdBK, kFwdBM);
  if (rc == 0) rc = make_map(&tm_w, w, N, K, 64, kFwdBK);
  if (rc == 0) rc = make_map(&tm_out, out, N, M, 64, 64);
  if (rc != 0) return rc;
  const int tiles = (M + kFwdBM - 1) / kFwdBM * ((N + kFwdBN - 1) / kFwdBN);
  const int grid = std::min(tiles, sm_count);
  const int bytes = fwd_smem_bytes(stages, with_res, k_pad);
  const auto* sp = static_cast<const float*>(s);
  const auto* tp = static_cast<const float*>(t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel = with_res ? fwd_kernel<true> : fwd_kernel<false>;
  static bool configured[2] = {false, false};  // more than 48 KB needs the opt-in
  if (!configured[with_res]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured[with_res] = true;
  }
  kernel<<<grid, kFwdThreads, bytes, st>>>(tm_y, tm_res, tm_w, tm_out, sp, tp, M, K, N, stages);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of one K1 CTA at reduction depth K.
extern "C" int dsst_bn_relu_matmul_fwd_smem_bytes(int K, int with_res) {
  const int stages = fwd_stages(K, with_res);
  const int k_pad = (K + kFwdBK - 1) / kFwdBK * kFwdBK;
  return stages < 2 ? -1 : fwd_smem_bytes(stages, with_res, k_pad);
}

// K2. gt [M,K] bf16; bn the tile width, 64 or 128 (the wrapper's da_tile_n
// decides); partial [min(tiles, sm_count), 2K] f32 scratch, one row per CTA;
// sums [2K] f32 (sum_g, then sum_gx).
extern "C" int dsst_bn_relu_matmul_bwd_da(const void* g, const void* w, const void* y,
                                          const void* res, const void* s, const void* t,
                                          const void* mean, const void* inv, void* gt,
                                          void* partial, void* sums, int M, int K, int N, int bn,
                                          int sm_count, void* stream) {
  const bool with_res = res != nullptr;
  if (bn != 64 && bn != 128) return static_cast<int>(cudaErrorInvalidValue);
  const int stages = da_stages(bn, with_res);
  CUtensorMap tm_g, tm_w, tm_y, tm_res, tm_gt;
  int rc = make_map(&tm_g, g, N, M, 64, kDaBM);
  if (rc == 0) rc = make_map(&tm_w, w, N, K, 64, bn);
  if (rc == 0) rc = make_map(&tm_y, y, K, M, 64, kDaBM);
  if (rc == 0) rc = make_map(&tm_res, with_res ? res : y, K, M, 64, kDaBM);
  if (rc == 0) rc = make_map(&tm_gt, gt, K, M, 64, kDaBM);
  if (rc != 0) return rc;
  const int tiles = (M + kDaBM - 1) / kDaBM * ((K + bn - 1) / bn);
  const int grid = std::min(tiles, sm_count);
  const int bytes = da_smem_bytes(bn, with_res, stages);
  const auto* sp = static_cast<const float*>(s);
  const auto* tp = static_cast<const float*>(t);
  const auto* mp = static_cast<const float*>(mean);
  const auto* ip = static_cast<const float*>(inv);
  auto* pp = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  decltype(&bwd_da_kernel<64, false>) kernel;
  const int variant = (bn == 128) * 2 + with_res;
  switch (variant) {
    case 0: kernel = bwd_da_kernel<64, false>; break;
    case 1: kernel = bwd_da_kernel<64, true>; break;
    case 2: kernel = bwd_da_kernel<128, false>; break;
    default: kernel = bwd_da_kernel<128, true>; break;
  }
  static bool configured[4] = {};  // more than 48 KB needs the opt-in
  if (!configured[variant]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured[variant] = true;
  }
  kernel<<<grid, kDaThreads, bytes, st>>>(tm_g, tm_w, tm_y, tm_res, tm_gt, sp, tp, mp, ip, pp, M,
                                          K, N, stages);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  return sum_rows(pp, static_cast<float*>(sums), grid, 2LL * K, st);
}

// Dynamic shared memory of one K2 CTA of tile width bn (-1: no such tile).
extern "C" int dsst_bn_relu_matmul_bwd_da_smem_bytes(int bn, int with_res) {
  if (bn != 64 && bn != 128) return -1;
  return da_smem_bytes(bn, with_res, da_stages(bn, with_res));
}

// K3. tile_k the output tile's channels, 64 (the two warpgroups on
// alternate stages) or 128 (the wrapper's dw_tile_k decides); partial
// [splits, K, N] f32 scratch, chunk rows of M per split (a multiple of 64;
// splits = ceil(M / chunk)), one CTA per output tile and split; dw [K,N] f32.
extern "C" int dsst_bn_relu_matmul_bwd_dw(const void* y, const void* res, const void* s,
                                          const void* t, const void* g, void* partial, void* dw,
                                          int M, int K, int N, int tile_k, int splits, int chunk,
                                          void* stream) {
  const bool with_res = res != nullptr, alt = tile_k == 64;
  if ((tile_k != 64 && tile_k != 128) || splits < 1 || chunk < 1 || chunk % kDwBM != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int stages = dw_stages(alt, with_res);
  CUtensorMap tm_y, tm_res, tm_g;
  int rc = make_map(&tm_y, y, K, M, 64, kDwBM);
  if (rc == 0) rc = make_map(&tm_res, with_res ? res : y, K, M, 64, kDwBM);
  if (rc == 0) rc = make_map(&tm_g, g, N, M, 64, kDwBM);
  if (rc != 0) return rc;
  const long long tiles =
      static_cast<long long>((K + tile_k - 1) / tile_k) * ((N + kDwBN - 1) / kDwBN);
  const long long grid = tiles * splits;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = dw_smem_bytes(alt, with_res, stages);
  const auto* sp = static_cast<const float*>(s);
  const auto* tp = static_cast<const float*>(t);
  auto* pp = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int variant = alt * 2 + with_res;
  decltype(&bwd_dw_kernel<false, false>) kernel;
  switch (variant) {
    case 0: kernel = bwd_dw_kernel<false, false>; break;
    case 1: kernel = bwd_dw_kernel<true, false>; break;
    case 2: kernel = bwd_dw_kernel<false, true>; break;
    default: kernel = bwd_dw_kernel<true, true>; break;
  }
  static bool configured[4] = {};  // more than 48 KB needs the opt-in
  if (!configured[variant]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured[variant] = true;
  }
  kernel<<<static_cast<unsigned>(grid), kDwThreads, bytes, st>>>(tm_y, tm_res, tm_g, sp, tp, pp, M,
                                                                 K, N, chunk, stages);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  return sum_rows(pp, static_cast<float*>(dw), splits, static_cast<long long>(K) * N, st);
}

// Dynamic shared memory of one K3 CTA of tile_k channels (-1: no such tile).
extern "C" int dsst_bn_relu_matmul_bwd_dw_smem_bytes(int tile_k, int with_res) {
  if (tile_k != 64 && tile_k != 128) return -1;
  const bool alt = tile_k == 64;
  return dw_smem_bytes(alt, with_res, dw_stages(alt, with_res));
}
