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
// memory: K1 and K3 build it in the prologue of the A tile, between the
// global load and the store to shared memory; K2 recomputes the ReLU mask in
// its epilogue.
//
// Design. K1 is a persistent, warp-specialised wgmma kernel (its section
// below): TMA loads into a ring of stages driven by mbarriers, the prologue
// applied to a register A operand, a TMA-store epilogue. K2 and K3 are one
// CTA of 8 warps per output tile with bf16 mma.sync m16n8k16 (f32
// accumulate), operands staged through shared memory (rows padded by 16
// bytes, read with ldmatrix, free of bank conflicts), a reduction depth of 32
// per stage, and the next stage's global loads issued into registers before
// the current stage's products. Every kernel takes any M and masks the
// ragged edge; K and N must be multiples of 8 (16-byte rows for TMA and
// vector loads).
//   K1: 128 x 256 tiles of out, one CTA per SM walking them.
//   K2: 128 x 64 tiles of gt; grid (K tiles, M tiles). The TPU kernel carries
//       the two channel sums across its sequential grid; GPU blocks run in no
//       order, so each CTA writes its column sums to a [M tiles, 2K] f32
//       scratch and a second pass adds the rows in a fixed order: the sums,
//       and so the gradients, are the same from run to run.
//   K3: 64 x 128 tiles of dW; grid (N tiles, K tiles, M splits). A reduction
//       over M (664,832 rows at stage 1 against 2 output tiles): each CTA
//       sums one M chunk into a [splits, K, N] f32 scratch, and the same
//       fixed-order pass adds the splits.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): each ResNet-50
// bottleneck site does M*K*N = 1.09e10 multiply-adds at batch 212. K1 moves
// y and out (2*M*(K+N) bytes): at stage 1 (K=64, N=256) that is 425 MB, so
// bytes bound it (0.127 ms) and not operations (0.022 ms); at stage 4 (K=512,
// N=2048, M=10,388) operations bound it. K2 reads g and y and writes gt; K3
// reads y and g: both are bytes-bound at stage 1. K1 reads y once per 256
// columns of out (once in all at stage 1) and keeps loads, products and
// stores in flight together. K2 and K3 read each input tile once per output
// tile; they do not yet overlap loads with products beyond the register
// prefetch, nor reach the wgmma rate: later work, on K1's machinery.

#include <algorithm>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kBK = 32;        // reduction depth of one shared-memory stage
constexpr int kPad = 8;        // bf16 elements of padding per shared row

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices; lane l gives the address of a row of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed on the way into registers.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint4 ld16(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// z = y*s + t (+ res), rounded after each operation as the plain version's
// separate torch ops round (no fused multiply-add): the ReLU mask of K2 and
// the rounded a of K1/K3 then match the plain version bit for bit.
__device__ __forceinline__ float bn_pre(float y, float s, float t) {
  return __fadd_rn(__fmul_rn(y, s), t);
}

// The prologue: a = bf16(relu(y*s + t [+ res])) for the 8 channels
// [k, k+8) of the element at `off`, in f32 as the TPU kernel computes it.
template <bool RES>
__device__ __forceinline__ uint4 bn_relu8(const bf16* __restrict__ y, const bf16* __restrict__ res,
                                          const float* __restrict__ s,
                                          const float* __restrict__ t, size_t off, int k) {
  float a[8], r[8];
  unpack8(ld16(y + off), a);
  if (RES) unpack8(ld16(res + off), r);
  const float4 s0 = __ldg(reinterpret_cast<const float4*>(s + k));
  const float4 s1 = __ldg(reinterpret_cast<const float4*>(s + k + 4));
  const float4 t0 = __ldg(reinterpret_cast<const float4*>(t + k));
  const float4 t1 = __ldg(reinterpret_cast<const float4*>(t + k + 4));
  const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  const float tv[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float z = bn_pre(a[i], sv[i], tv[i]);
    if (RES) z = __fadd_rn(z, r[i]);
    a[i] = fmaxf(z, 0.f);
  }
  return pack8(a);
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
constexpr int kSmemLimit = 232448;  // what one CTA may opt in to on an H100

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
// K2: gt = (g @ W^T) * [y*s + t (+ res) > 0], stored bf16; per-CTA column
// sums of the f32 gt and of gt * x_hat into partial[M tile][2K].
// ---------------------------------------------------------------------------
constexpr int kDaBM = 128, kDaBN = 64;

template <bool RES>
__global__ void __launch_bounds__(kThreads)
bwd_da_kernel(const bf16* __restrict__ g, const bf16* __restrict__ w, const bf16* __restrict__ y,
              const bf16* __restrict__ res, const float* __restrict__ s,
              const float* __restrict__ t, const float* __restrict__ mean,
              const float* __restrict__ inv, bf16* __restrict__ gt, float* __restrict__ partial,
              int M, int K, int N) {
  constexpr int BM = kDaBM, BN = kDaBN, WM = 32, WN = 32, MI = WM / 16, NI = WN / 8;
  constexpr int WARPS_M = BM / WM;  // 4 x 2 warps
  constexpr int LDA = kBK + kPad, LDB = kBK + kPad;
  __shared__ __align__(16) bf16 As[BM * LDA];  // g tile [m][n]
  __shared__ __align__(16) bf16 Bs[BN * LDB];  // W tile [k][n]: the B operand W^T, column-major
  __shared__ float red[2][WARPS_M][BN];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int k0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

  uint4 ra[2], rb;
  auto load = [&](int nr0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * kThreads, r = v >> 2, c = (v & 3) * 8;
      const int gm = m0 + r, gn = nr0 + c;
      ra[i] = (gm < M && gn < N) ? ld16(g + static_cast<size_t>(gm) * N + gn) : zero;
    }
    const int r = tid >> 2, c = (tid & 3) * 8;
    const int gk = k0 + r, gn = nr0 + c;
    rb = (gk < K && gn < N) ? ld16(w + static_cast<size_t>(gk) * N + gn) : zero;
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * kThreads;
      *reinterpret_cast<uint4*>(&As[(v >> 2) * LDA + (v & 3) * 8]) = ra[i];
    }
    *reinterpret_cast<uint4*>(&Bs[(tid >> 2) * LDB + (tid & 3) * 8]) = rb;
  };

  const int n_k = (N + kBK - 1) / kBK;
  load(0);
  for (int kt = 0; kt < n_k; ++kt) {
    store();
    __syncthreads();
    if (kt + 1 < n_k) load((kt + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldsm_x4(af[mi], &As[(wm * WM + mi * 16 + (lane & 15)) * LDA + kk + (lane >> 4) * 8]);
#pragma unroll
      for (int j = 0; j < NI / 2; ++j) {
        uint32_t bfr[4];
        ldsm_x4(bfr, &Bs[(wn * WN + j * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDB + kk +
                         ((lane >> 3) & 1) * 8]);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          mma_16816(acc[mi][2 * j], af[mi], bfr[0], bfr[1]);
          mma_16816(acc[mi][2 * j + 1], af[mi], bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();
  }

  // Epilogue: ReLU mask, store, and the column sums of the f32 gt.
  const int gr = lane >> 2, tq = lane & 3;
  float cs_g[NI][2], cs_gx[NI][2];
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) cs_g[ni][0] = cs_g[ni][1] = cs_gx[ni][0] = cs_gx[ni][1] = 0.f;
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    const int col = k0 + wn * WN + ni * 8 + tq * 2;
    if (col >= K) continue;
    const float2 sc = *reinterpret_cast<const float2*>(s + col);
    const float2 tc = *reinterpret_cast<const float2*>(t + col);
    const float2 mc = *reinterpret_cast<const float2*>(mean + col);
    const float2 ic = *reinterpret_cast<const float2*>(inv + col);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * WM + mi * 16 + gr + half * 8;
        if (row >= M) continue;
        const size_t off = static_cast<size_t>(row) * K + col;
        const float2 yv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(y + off));
        float z0 = bn_pre(yv.x, sc.x, tc.x), z1 = bn_pre(yv.y, sc.y, tc.y);
        if (RES) {
          const float2 rv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res + off));
          z0 = __fadd_rn(z0, rv.x);
          z1 = __fadd_rn(z1, rv.y);
        }
        const float g0 = z0 > 0.f ? acc[mi][ni][2 * half] : 0.f;
        const float g1 = z1 > 0.f ? acc[mi][ni][2 * half + 1] : 0.f;
        *reinterpret_cast<uint32_t*>(gt + off) = pack2(g0, g1);
        cs_g[ni][0] += g0;
        cs_g[ni][1] += g1;
        cs_gx[ni][0] += g0 * ((yv.x - mc.x) * ic.x);
        cs_gx[ni][1] += g1 * ((yv.y - mc.y) * ic.y);
      }
    }
  }
  // Sum over the 8 row groups of the warp (lane bits 2..4), then over the
  // warps of the CTA's rows, each in a fixed order.
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        cs_g[ni][e] += __shfl_xor_sync(0xffffffffu, cs_g[ni][e], off);
        cs_gx[ni][e] += __shfl_xor_sync(0xffffffffu, cs_gx[ni][e], off);
      }
    }
  }
  if (gr == 0) {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = wn * WN + ni * 8 + tq * 2 + e;
        red[0][wm][c] = cs_g[ni][e];
        red[1][wm][c] = cs_gx[ni][e];
      }
    }
  }
  __syncthreads();
  if (tid < 2 * BN) {
    const int which = tid / BN, c = tid % BN, col = k0 + c;
    if (col < K) {
      float v = 0.f;
#pragma unroll
      for (int i = 0; i < WARPS_M; ++i) v += red[which][i][c];
      partial[static_cast<size_t>(blockIdx.y) * 2 * K + which * K + col] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// K3: partial[z] = sum over M chunk z of bf16(relu(y*s + t [+ res]))^T @ g,
// a [K,N] f32 slab per chunk.
// ---------------------------------------------------------------------------
constexpr int kDwBM = 64, kDwBN = 128;

template <bool RES>
__global__ void __launch_bounds__(kThreads)
bwd_dw_kernel(const bf16* __restrict__ y, const bf16* __restrict__ res, const float* __restrict__ s,
              const float* __restrict__ t, const bf16* __restrict__ g,
              float* __restrict__ partial, int M, int K, int N, int chunk) {
  constexpr int BM = kDwBM, BN = kDwBN, WM = 32, WN = 32, MI = WM / 16, NI = WN / 8;
  constexpr int LDA = BM + kPad, LDB = BN + kPad;
  __shared__ __align__(16) bf16 As[kBK * LDA];  // a tile [m][k]: the A operand a^T, read transposed
  __shared__ __align__(16) bf16 Bs[kBK * LDB];  // g tile [m][n]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps of 32 x 32
  const int n0 = blockIdx.x * BN, k0 = blockIdx.y * BM;
  const int m_begin = blockIdx.z * chunk;
  const int m_end = min(M, m_begin + chunk);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

  uint4 ra, rb[2];
  auto load = [&](int mr0) {
    {
      const int r = tid >> 3, c = (tid & 7) * 8;
      const int gm = mr0 + r, gk = k0 + c;
      ra = (gm < m_end && gk < K) ? bn_relu8<RES>(y, res, s, t, static_cast<size_t>(gm) * K + gk, gk)
                                  : zero;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * kThreads, r = v >> 4, c = (v & 15) * 8;
      const int gm = mr0 + r, gn = n0 + c;
      rb[i] = (gm < m_end && gn < N) ? ld16(g + static_cast<size_t>(gm) * N + gn) : zero;
    }
  };
  auto store = [&]() {
    *reinterpret_cast<uint4*>(&As[(tid >> 3) * LDA + (tid & 7) * 8]) = ra;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * kThreads;
      *reinterpret_cast<uint4*>(&Bs[(v >> 4) * LDB + (v & 15) * 8]) = rb[i];
    }
  };

  const int n_m = m_end > m_begin ? (m_end - m_begin + kBK - 1) / kBK : 0;
  if (n_m > 0) load(m_begin);
  for (int mt = 0; mt < n_m; ++mt) {
    store();
    __syncthreads();
    if (mt + 1 < n_m) load(m_begin + (mt + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldsm_x4_t(af[mi], &As[(kk + (lane & 7) + ((lane >> 4) << 3)) * LDA + wm * WM + mi * 16 +
                              ((lane >> 3) & 1) * 8]);
#pragma unroll
      for (int j = 0; j < NI / 2; ++j) {
        uint32_t bfr[4];
        ldsm_x4_t(bfr, &Bs[(kk + (lane & 15)) * LDB + wn * WN + j * 16 + (lane >> 4) * 8]);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          mma_16816(acc[mi][2 * j], af[mi], bfr[0], bfr[1]);
          mma_16816(acc[mi][2 * j + 1], af[mi], bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();
  }

  float* slab = partial + static_cast<size_t>(blockIdx.z) * K * N;
  const int gr = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int col = n0 + wn * WN + ni * 8 + tq * 2;
      if (col >= N) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = k0 + wm * WM + mi * 16 + gr + half * 8;
        if (row < K) {
          *reinterpret_cast<float2*>(slab + static_cast<size_t>(row) * N + col) =
              make_float2(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The second pass of K2 and K3: out[c] = sum_r part[r, c], in a fixed order
// (row group rg adds rows rg, rg + 16, ... in turn; the 16 groups are added
// in index order), so the result does not depend on how blocks were run.
// ---------------------------------------------------------------------------
constexpr int kRedCols = 32, kRedGroups = 16;

__global__ void __launch_bounds__(kRedCols * kRedGroups)
sum_rows_kernel(const float* __restrict__ part, float* __restrict__ out, int rows, long long cols) {
  __shared__ float sh[kRedGroups][kRedCols];
  const int lane = threadIdx.x % kRedCols, rg = threadIdx.x / kRedCols;
  const long long c = static_cast<long long>(blockIdx.x) * kRedCols + lane;
  float acc = 0.f;
  if (c < cols) {
    for (int r = rg; r < rows; r += kRedGroups) acc += part[static_cast<long long>(r) * cols + c];
  }
  sh[rg][lane] = acc;
  __syncthreads();
  if (rg == 0 && c < cols) {
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < kRedGroups; ++i) v += sh[i][lane];
    out[c] = v;
  }
}

int sum_rows(const float* part, float* out, int rows, long long cols, cudaStream_t st) {
  const long long blocks = (cols + kRedCols - 1) / kRedCols;
  sum_rows_kernel<<<static_cast<unsigned>(blocks), kRedCols * kRedGroups, 0, st>>>(part, out, rows,
                                                                                  cols);
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

// K2. gt [M,K] bf16; partial [ceil(M/128), 2K] f32 scratch; sums [2K] f32
// (sum_g, then sum_gx).
extern "C" int dsst_bn_relu_matmul_bwd_da(const void* g, const void* w, const void* y,
                                          const void* res, const void* s, const void* t,
                                          const void* mean, const void* inv, void* gt,
                                          void* partial, void* sums, int M, int K, int N,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles_m = (M + kDaBM - 1) / kDaBM;
  const dim3 grid((K + kDaBN - 1) / kDaBN, tiles_m);
  const auto* gp = static_cast<const bf16*>(g);
  const auto* wp = static_cast<const bf16*>(w);
  const auto* yp = static_cast<const bf16*>(y);
  const auto* rp = static_cast<const bf16*>(res);
  const auto* sp = static_cast<const float*>(s);
  const auto* tp = static_cast<const float*>(t);
  const auto* mp = static_cast<const float*>(mean);
  const auto* ip = static_cast<const float*>(inv);
  auto* gtp = static_cast<bf16*>(gt);
  auto* pp = static_cast<float*>(partial);
  if (res != nullptr) {
    bwd_da_kernel<true><<<grid, kThreads, 0, st>>>(gp, wp, yp, rp, sp, tp, mp, ip, gtp, pp, M, K, N);
  } else {
    bwd_da_kernel<false><<<grid, kThreads, 0, st>>>(gp, wp, yp, rp, sp, tp, mp, ip, gtp, pp, M, K, N);
  }
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  return sum_rows(pp, static_cast<float*>(sums), tiles_m, 2LL * K, st);
}

// K3. partial [splits, K, N] f32 scratch, chunk rows of M per split
// (splits = ceil(M / chunk)); dw [K,N] f32.
extern "C" int dsst_bn_relu_matmul_bwd_dw(const void* y, const void* res, const void* s,
                                          const void* t, const void* g, void* partial, void* dw,
                                          int M, int K, int N, int splits, int chunk,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kDwBN - 1) / kDwBN, (K + kDwBM - 1) / kDwBM, splits);
  const auto* yp = static_cast<const bf16*>(y);
  const auto* rp = static_cast<const bf16*>(res);
  const auto* sp = static_cast<const float*>(s);
  const auto* tp = static_cast<const float*>(t);
  const auto* gp = static_cast<const bf16*>(g);
  auto* pp = static_cast<float*>(partial);
  if (res != nullptr) {
    bwd_dw_kernel<true><<<grid, kThreads, 0, st>>>(yp, rp, sp, tp, gp, pp, M, K, N, chunk);
  } else {
    bwd_dw_kernel<false><<<grid, kThreads, 0, st>>>(yp, rp, sp, tp, gp, pp, M, K, N, chunk);
  }
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  return sum_rows(pp, static_cast<float*>(dw), splits, static_cast<long long>(K) * N, st);
}
