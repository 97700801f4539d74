// Flash attention forward for Hopper (sm_90a): blockwise online softmax.
//
// Replaces dss_ml_at_scale_tpu/ops/flash_attention.py::_flash_kernel, the
// Pallas TPU kernel launched by _flash_forward. Same function: causal or
// non-causal attention over [b*h, seq, d], f32 running max, denominator and
// accumulator, a bottom-right causal mask with offset sk - sq, finite -1e30
// masking, and key tiles wholly above the diagonal skipped.
//
// Design. The TPU kernel walks key blocks as the innermost SEQUENTIAL grid
// axis and carries acc/m/l in VMEM scratch between grid steps. Blocks on a
// GPU run in no order, so here one CTA, one warpgroup of 128 threads, owns a
// 64-row query tile and walks a range of its key tiles in a loop, with the
// running statistics in registers. Two such CTAs fit on an SM.
// - Products on wgmma. S = Q·Kᵀ (m64n64k16) reads Q and the K tile from
//   shared memory; O += P·V (m64n{d}k16) takes P from registers: the S
//   accumulator, rounded to bf16, is already the register A-operand layout.
//   V is an MN-major B operand, so no transpose is done anywhere.
// - Copies. Q, K and V reach shared memory by cp.async, 16 bytes a thread,
//   into the 128-byte swizzle that the wgmma descriptors read (hopper.cuh).
//   K/V tiles go into a ring of two stages: tile j+2 loads into tile j's
//   stage as soon as P·V of j is done, a whole step ahead of its use; each
//   stage's mbarrier counts the 128 threads' copies in
//   (cp.async.mbarrier.arrive). cp.async and not TMA: TMA needs a tensor
//   map per distinct pointer, encoded on the host, and q/k/v are fresh
//   tensors at every call of a host-bound serving loop; cp.async needs none
//   and zero-fills the ragged tail itself.
// - Longest first. Causal query tile i walks i+1 key tiles. Batch*heads is
//   grid.x and the work item grid.y, so the hardware starts all heads of the
//   longest tiles first.
// - Key splits. Where the grid would not fill the card, the host's plan
//   (ops/flash_attention.py::split_plan) cuts the long tiles' key ranges
//   into pieces. A piece writes its normalized f32 partial O and its log2
//   sum-exp; a second kernel combines the pieces of a tile in a fixed order,
//   so the output is the same from run to run.
//
// Numerics. Softmax statistics are f32, in the log2 domain (the 1/sqrt(d)
// scale and log2(e) are folded into one multiply, exp2 replaces exp, which
// is the same softmax). P is rounded to bf16 before the P·V product, where
// the TPU kernel multiplies an f32 P; the row sum l is taken over the f32 P.
// Both stay inside the bf16 tolerance the JAX package's own test uses.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): the kernel does
// 4*d flops per visible (query, key) pair and must move q, k, v and o once.
// Causal at sq = sk = s that is 2*d*s^2 flops against 8*d*s bytes per head,
// so it is bound by bytes up to s ~ 1180 (non-causal: ~590) and by
// operations above: the serving buckets (128..1024) are byte-bound. At those
// sizes what a launch costs is latency: a query tile's chain of dependent
// key tiles (S, then its softmax, then P·V, each waiting for the last),
// which the ring shortens by taking the copies off it and the splits by
// cutting it. Issuing S of tile j+1 before the softmax of tile j, to overlap
// the two, made ptxas serialize the wgmmas (C7514/C7515) and ran slower.
//
// Narrower heads. The wrapper zero-pads a head_dim under 128 that is not
// 32, 64 or 128 up to the next of them and passes the true 1/sqrt(d): zero
// columns add nothing to Q·Kᵀ and give zero output columns, which it drops.
//
// Head dim 32. A 32-wide bf16 row is 64 bytes, less than the 128-byte
// swizzle's row, so Q, K and V tiles of D = 32 use the 64-byte swizzle
// (hopper.cuh, SW64) in the cp.async addresses and the wgmma descriptors;
// S takes two k-steps and P·V is m64n32k16. D = 64 and 128 are unchanged.
//
// Wider heads (d > 128). The wrapper zero-pads d to a multiple of 128 and
// the wide kernels take it in column slices of 128: grid.z picks a CTA's
// slice of the output. A bf16 CTA contracts Q·Kᵀ over the whole head in
// 64-wide chunks, each a Q chunk and a K chunk staged through a ring of
// 16 KB slots, so shared memory stays 65 KB whatever d is; the V slice of a
// key tile rides the same ring. Every slice computes the same scores in the
// same order, so the slices agree bit for bit on the softmax statistics.
// The split plan carries the slice: a piece of slice z writes partial slot
// (bh * slices + z, slot). The cost of the design is the scores' recompute,
// once per slice (d/128 times the Q·Kᵀ work); it is slow and right, kept
// apart from the d <= 128 kernels, whose launches it leaves as they were.
//
// A float32 path (one warp per query row, FMA on the CUDA cores) keeps the
// f32 contract of the JAX function. No path of the port takes it yet;
// chip_smoke.py holds it to the f32 tolerance and times it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBlockM = 64;   // query rows per CTA, 16 per warp
constexpr int kBlockN = 64;   // keys per tile
constexpr int kWarps = 4;     // one warpgroup
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;    // K/V ring depth
constexpr float kNegInf = -1e30f;  // finite "minus infinity", as in the JAX kernel
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// Shared memory of the bf16 kernel: Q, then the K ring, then the V ring,
// each a 64 x D SW128 tile of D / 64 blocks of 8 KB (D = 32: one 4 KB SW64
// tile); then the ring's barriers. 1 KB of slack aligns the base.
template <int D>
struct Smem {
  static constexpr int kTile = kBlockN * D * 2;
  static constexpr int kBars = (1 + 2 * kStages) * kTile;
  static constexpr int kBytes = 1024 + kBars + kStages * 8;
};

// Copy rows [row0, row0 + 64) of a [rows, D] slab into an SW128 tile at
// shared address dst, zero-filling rows at or past n_rows.
template <int D>
__device__ __forceinline__ void copy_tile(uint32_t dst, const __nv_bfloat16* src, int row0,
                                          int n_rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int i = threadIdx.x; i < kBlockN * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool valid = row0 + r < n_rows;
    const __nv_bfloat16* p = src + (valid ? static_cast<size_t>(row0 + r) * D + c * 8 : 0);
    if constexpr (D == 32) {
      cp_async16(dst + sw64(r, c), p, valid);
    } else {
      cp_async16(dst + (c / 8) * 8192 + sw128(r, c % 8), p, valid);
    }
  }
}

// Key tiles a causal query tile sees (all of them without the mask).
__device__ __forceinline__ int visible_tiles(int qt, int sq, int sk, int causal) {
  const int n_kt = (sk + kBlockN - 1) / kBlockN;
  if (!causal) return n_kt;
  const int last_row = min((qt + 1) * kBlockM, sq) - 1;
  return min(n_kt, (last_row + sk - sq) / kBlockN + 1);
}

// S = Q·Kᵀ for 64 rows x 64 keys, over D / 16 steps of 16, issued and
// committed as one group (not waited for).
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t s_q, uint32_t s_k) {
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    if constexpr (D == 32) {
      const uint32_t off = ks * 32;
      wgmma_m64n64k16_ss<0>(s, sw64_desc(s_q + off, 16, 512), sw64_desc(s_k + off, 16, 512),
                            ks > 0);
    } else {
      const uint32_t off = (ks / 4) * 8192 + (ks % 4) * 32;
      wgmma_m64n64k16_ss<0>(s, sw128_desc(s_q + off, 16, 1024), sw128_desc(s_k + off, 16, 1024),
                            ks > 0);
    }
  }
  wgmma_commit();
  fence_regs(s);
}

// O += P·V over the 64 keys of a tile, in 4 steps of 16: P from registers,
// V [key][d] as the MN-major B, each step 16 key rows (2 KB; SW64 1 KB)
// further on.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2], const uint32_t (&pa)[4][4],
                                         uint32_t s_v) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (D == 32) {
      wgmma_m64n32k16_rs<1>(acc, pa[kk], sw64_desc(s_v + kk * 1024, 4096, 512), 1);
    } else if constexpr (D == 128) {
      wgmma_m64n128k16_rs<1>(acc, pa[kk], sw128_desc(s_v + kk * 2048, 8192, 1024), 1);
    } else {
      wgmma_m64n64k16_rs<1>(acc, pa[kk], sw128_desc(s_v + kk * 2048, 8192, 1024), 1);
    }
  }
  wgmma_commit();
  fence_regs(acc);
}

// The online softmax of one key tile starting at key k0: scale S into the
// log2 domain, mask, update the running max m and sum l, and leave in s the
// probabilities and in alpha the factor that rescales the accumulator.
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0, const int (&rows)[2],
                                             int sk, int causal, int offset, float scale_log2) {
  const int t = threadIdx.x % 4;
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + nt * 8 + t * 2 + (e & 1);
      const bool live = key < sk && (!causal || key <= rows[e >> 1] + offset);
      const float x = live ? s[4 * nt + e] * scale_log2 : kNegInf;
      s[4 * nt + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    alpha[i] = exp2f(m[i] - m_new);
    m[i] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float p = exp2f(s[i] - m[(i >> 1) & 1]);
    s[i] = p;
    rs[(i >> 1) & 1] += p;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
}

// One work item: query tile qt over key tiles [kt_begin, kt_end). items is
// null without splits (item y = query tile, longest first); else item y is
// items[y] = (qt, kt_begin, kt_end, slot), slot < 0 for a tile that is not
// split. A split piece writes part_o[bh][slot] (64 x D f32, normalized) and
// part_lse[bh][slot] (64 log2 sum-exps).
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      int sq, int sk, int causal, float scale_log2, const int4* __restrict__ items,
                      float* __restrict__ part_o, float* __restrict__ part_lse, int n_slots) {
  constexpr int kTile = Smem<D>::kTile;
  constexpr int kTilesO = D / 8;  // 8-wide column tiles of O
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  const uint32_t s_q = smem_u32(smem);
  const uint32_t s_k = s_q + kTile, s_v = s_q + (1 + kStages) * kTile;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Smem<D>::kBars);

  const int bh = blockIdx.x;
  int qt, kt_begin, kt_end, slot;
  if (items != nullptr) {
    const int4 it = items[blockIdx.y];
    qt = it.x, kt_begin = it.y, kt_end = it.z, slot = it.w;
  } else {
    const int n_qt = (sq + kBlockM - 1) / kBlockM;
    qt = causal ? n_qt - 1 - static_cast<int>(blockIdx.y) : blockIdx.y;
    kt_begin = 0, kt_end = visible_tiles(qt, sq, sk, causal), slot = -1;
  }
  const int q0 = qt * kBlockM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // accumulator row group
  const int t = lane & 3;   // thread within the group
  const __nv_bfloat16* kb = k + static_cast<size_t>(bh) * sk * D;
  const __nv_bfloat16* vb = v + static_cast<size_t>(bh) * sk * D;
  const int offset = sk - sq;  // bottom-right causal alignment
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const int n = kt_end - kt_begin;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(&full[i], kThreads);
    mbar_fence_init();
  }
  __syncthreads();

  // Key tile j of the range lives in stage j % 2; Q rides in with tile 0.
  auto load = [&](int j) {
    const int st = j % kStages;
    copy_tile<D>(s_k + st * kTile, kb, (kt_begin + j) * kBlockN, sk);
    copy_tile<D>(s_v + st * kTile, vb, (kt_begin + j) * kBlockN, sk);
    cp_async_arrive(&full[st]);
  };
  auto ready = [&](int j) {
    mbar_wait(&full[j % kStages], (j / kStages) & 1);
    fence_proxy_async();
  };
  copy_tile<D>(s_q, q + static_cast<size_t>(bh) * sq * D, q0, sq);
  load(0);
  if (n > 1) load(1);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums, reduced at the end
  float s[32] = {};

  for (int j = 0; j < n; ++j) {
    const int st = j % kStages;
    ready(j);
    issue_qk<D>(s, s_q, s_k + st * kTile);
    wgmma_wait<0>();
    fence_regs(s);
    float alpha[2];
    softmax_tile(s, m, l, alpha, (kt_begin + j) * kBlockN, rows, sk, causal, offset, scale_log2);
    fence_regs(acc);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    // P in bf16: the S accumulators of key columns [16kk, 16kk+16) are the
    // register A operand of P·V step kk.
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    }
    issue_pv<D>(acc, pa, s_v + st * kTile);
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // every warp is done with tile j's stage: refill it
    if (j + 2 < n) load(j + 2);
  }

  // Finish: full row sums across the 4 threads of a group, normalise, store.
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / l[i];  // never 0: the row's largest score has p = 1
  }
  if (slot < 0) {
#pragma unroll
    for (int dn = 0; dn < kTilesO; ++dn) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = rows[half];
        if (row < sq) {
          const int col = dn * 8 + t * 2;
          *reinterpret_cast<uint32_t*>(o + (static_cast<size_t>(bh) * sq + row) * D + col) =
              pack_bf16(acc[4 * dn + 2 * half] * inv[half], acc[4 * dn + 2 * half + 1] * inv[half]);
        }
      }
    }
  } else {
    // A piece whose keys are all masked for a row has m = -1e30; its
    // sum-exp is then about -1e30 and its weight in the combine exp2 of it,
    // 0: the piece with key tile 0 always sees a live key.
    const size_t base = static_cast<size_t>(bh) * n_slots + slot;
    float* po = part_o + base * kBlockM * D;
#pragma unroll
    for (int dn = 0; dn < kTilesO; ++dn) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = warp * 16 + g + half * 8;
        *reinterpret_cast<float2*>(po + r * D + dn * 8 + t * 2) =
            make_float2(acc[4 * dn + 2 * half] * inv[half], acc[4 * dn + 2 * half + 1] * inv[half]);
      }
    }
    if (t == 0) {
#pragma unroll
      for (int half = 0; half < 2; ++half)
        part_lse[base * kBlockM + warp * 16 + g + half * 8] = m[half] + log2f(l[half]);
    }
  }
}

// The second pass of a split launch: one CTA per (bh, split query tile,
// column slice); combine[y] = (qt, first slot, pieces, 0). Thread pairs take
// a row, each half of the slice's D columns; the pieces are added in slot
// order. o has rows of ld elements (ld = D, one slice, below d = 128).
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_combine_kernel(const float* __restrict__ part_o, const float* __restrict__ part_lse,
                     const int4* __restrict__ combine, __nv_bfloat16* __restrict__ o, int sq,
                     int n_slots, int ld) {
  constexpr int kHalf = D / 2;
  const int bh = blockIdx.x;
  const int4 c = combine[blockIdx.y];
  const int r = threadIdx.x / 2, c0 = blockIdx.z * D + (threadIdx.x % 2) * kHalf;
  const int row = c.x * kBlockM + r;
  if (row >= sq) return;
  const size_t base = (static_cast<size_t>(bh) * gridDim.z + blockIdx.z) * n_slots + c.y;
  float mx = kNegInf;
  for (int i = 0; i < c.z; ++i) mx = fmaxf(mx, part_lse[(base + i) * kBlockM + r]);
  float out[kHalf];
#pragma unroll
  for (int j = 0; j < kHalf; ++j) out[j] = 0.f;
  float wsum = 0.f;
  for (int i = 0; i < c.z; ++i) {
    const float w = exp2f(part_lse[(base + i) * kBlockM + r] - mx);
    wsum += w;
    const float4* src = reinterpret_cast<const float4*>(
        part_o + ((base + i) * kBlockM + r) * D + (threadIdx.x % 2) * kHalf);
#pragma unroll
    for (int j = 0; j < kHalf / 4; ++j) {
      const float4 x = src[j];
      out[4 * j] += w * x.x;
      out[4 * j + 1] += w * x.y;
      out[4 * j + 2] += w * x.z;
      out[4 * j + 3] += w * x.w;
    }
  }
  const float inv = 1.f / wsum;
  uint4* dst = reinterpret_cast<uint4*>(o + (static_cast<size_t>(bh) * sq + row) * ld + c0);
#pragma unroll
  for (int j = 0; j < kHalf / 8; ++j) {
    uint4 u;
    u.x = pack_bf16(out[8 * j] * inv, out[8 * j + 1] * inv);
    u.y = pack_bf16(out[8 * j + 2] * inv, out[8 * j + 3] * inv);
    u.z = pack_bf16(out[8 * j + 4] * inv, out[8 * j + 5] * inv);
    u.w = pack_bf16(out[8 * j + 6] * inv, out[8 * j + 7] * inv);
    dst[j] = u;
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int bh, int sq, int sk,
                int causal, float scale_log2, const void* items, int n_items, const void* combine,
                int n_combine, void* part_o, void* part_lse, int n_slots, cudaStream_t st) {
  constexpr int kBytes = Smem<D>::kBytes;
  static bool configured = false;  // more than 48 KB needs the opt-in
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  const auto* ip = static_cast<const int4*>(items);
  const int n_y = ip != nullptr ? n_items : (sq + kBlockM - 1) / kBlockM;
  flash_fwd_bf16_kernel<D><<<dim3(bh, n_y), kThreads, kBytes, st>>>(
      qp, kp, vp, op, sq, sk, causal, scale_log2, ip, static_cast<float*>(part_o),
      static_cast<float*>(part_lse), n_slots);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || ip == nullptr || n_combine == 0) return static_cast<int>(e);
  flash_combine_kernel<D><<<dim3(bh, n_combine), kThreads, 0, st>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_lse),
      static_cast<const int4*>(combine), op, sq, n_slots, D);
  return static_cast<int>(cudaGetLastError());
}

// -- wide heads: d a multiple of 128 above 128 -------------------------------

constexpr int kSlice = 128;      // output columns of a wide CTA
constexpr int kWideStages = 4;   // slots of the wide ring

// Shared memory of the wide bf16 kernel: kWideStages slots of 16 KB, each a
// Q chunk and a K chunk (64 x 64, SW128, 8 KB each) or a V slice (64 keys x
// 128 columns, two SW128 blocks); then the slots' barriers.
struct SmemWide {
  static constexpr int kSlotBytes = 2 * kBlockN * 64 * 2;
  static constexpr int kBars = kWideStages * kSlotBytes;
  static constexpr int kBytes = 1024 + kBars + kWideStages * 8;
};

// Copy rows [row0, row0 + 64) x W columns of a slab whose rows are ld
// elements apart into W / 64 SW128 blocks at dst, zero-filling rows at or
// past n_rows.
template <int W>
__device__ __forceinline__ void copy_block(uint32_t dst, const __nv_bfloat16* src, int ld,
                                           int row0, int n_rows) {
  constexpr int kChunks = W / 8;
#pragma unroll
  for (int i = threadIdx.x; i < kBlockN * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool valid = row0 + r < n_rows;
    const __nv_bfloat16* p = src + (valid ? static_cast<size_t>(row0 + r) * ld + c * 8 : 0);
    cp_async16(dst + (c / 8) * 8192 + sw128(r, c % 8), p, valid);
  }
}

// One work item of a wide head (as flash_fwd_bf16_kernel's) for the column
// slice blockIdx.z. Ring load u of key tile j = u / (nc + 1) is its Q/K
// chunk u % (nc + 1), or the tile's V slice when that is nc.
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_wide_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                           int sq, int sk, int d, int causal, float scale_log2,
                           const int4* __restrict__ items, float* __restrict__ part_o,
                           float* __restrict__ part_lse, int n_slots) {
  constexpr int kSlot = SmemWide::kSlotBytes;
  constexpr int kTilesO = kSlice / 8;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  const uint32_t s0 = smem_u32(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SmemWide::kBars);

  const int bh = blockIdx.x, cs = blockIdx.z;
  int qt, kt_begin, kt_end, slot;
  if (items != nullptr) {
    const int4 it = items[blockIdx.y];
    qt = it.x, kt_begin = it.y, kt_end = it.z, slot = it.w;
  } else {
    const int n_qt = (sq + kBlockM - 1) / kBlockM;
    qt = causal ? n_qt - 1 - static_cast<int>(blockIdx.y) : blockIdx.y;
    kt_begin = 0, kt_end = visible_tiles(qt, sq, sk, causal), slot = -1;
  }
  const int q0 = qt * kBlockM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const __nv_bfloat16* qb = q + static_cast<size_t>(bh) * sq * d;
  const __nv_bfloat16* kb = k + static_cast<size_t>(bh) * sk * d;
  const __nv_bfloat16* vb = v + static_cast<size_t>(bh) * sk * d + cs * kSlice;
  const int offset = sk - sq;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const int n = kt_end - kt_begin;
  const int nc = d / 64;      // 64-wide chunks of the contraction
  const int per = nc + 1;     // ring loads per key tile
  const int total = n * per;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kWideStages; ++i) mbar_init(&full[i], kThreads);
    mbar_fence_init();
  }
  __syncthreads();

  auto load = [&](int u) {
    const int j = u / per, c = u % per, st = u % kWideStages;
    const uint32_t dst = s0 + st * kSlot;
    const int key0 = (kt_begin + j) * kBlockN;
    if (c < nc) {
      copy_block<64>(dst, qb + c * 64, d, q0, sq);
      copy_block<64>(dst + kSlot / 2, kb + c * 64, d, key0, sk);
    } else {
      copy_block<kSlice>(dst, vb, d, key0, sk);
    }
    cp_async_arrive(&full[st]);
  };
  auto ready = [&](int u) {
    mbar_wait(&full[u % kWideStages], (u / kWideStages) & 1);
    fence_proxy_async();
  };
  // Every thread waits on the slot and leaves it before any refills it.
  auto release = [&](int u) {
    __syncthreads();
    if (u + kWideStages < total) load(u + kWideStages);
  };
  for (int u = 0; u < kWideStages && u < total; ++u) load(u);

  float acc[kSlice / 2];
#pragma unroll
  for (int i = 0; i < kSlice / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float s[32] = {};

  int u = 0;
  for (int j = 0; j < n; ++j) {
    for (int c = 0; c < nc; ++c, ++u) {
      ready(u);
      const uint32_t base = s0 + (u % kWideStages) * kSlot;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        wgmma_m64n64k16_ss<0>(s, sw128_desc(base + ks * 32, 16, 1024),
                              sw128_desc(base + kSlot / 2 + ks * 32, 16, 1024), c > 0 || ks > 0);
      }
      wgmma_commit();
      fence_regs(s);
      wgmma_wait<0>();
      fence_regs(s);
      release(u);
    }
    float alpha[2];
    softmax_tile(s, m, l, alpha, (kt_begin + j) * kBlockN, rows, sk, causal, offset, scale_log2);
    fence_regs(acc);
#pragma unroll
    for (int i = 0; i < kSlice / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    }
    ready(u);
    issue_pv<kSlice>(acc, pa, s0 + (u % kWideStages) * kSlot);
    wgmma_wait<0>();
    fence_regs(acc);
    release(u);
    ++u;
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / l[i];
  }
  if (slot < 0) {
#pragma unroll
    for (int dn = 0; dn < kTilesO; ++dn) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = rows[half];
        if (row < sq) {
          const int col = cs * kSlice + dn * 8 + t * 2;
          *reinterpret_cast<uint32_t*>(o + (static_cast<size_t>(bh) * sq + row) * d + col) =
              pack_bf16(acc[4 * dn + 2 * half] * inv[half], acc[4 * dn + 2 * half + 1] * inv[half]);
        }
      }
    }
  } else {
    const size_t base = (static_cast<size_t>(bh) * gridDim.z + cs) * n_slots + slot;
    float* po = part_o + base * kBlockM * kSlice;
#pragma unroll
    for (int dn = 0; dn < kTilesO; ++dn) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = warp * 16 + g + half * 8;
        *reinterpret_cast<float2*>(po + r * kSlice + dn * 8 + t * 2) =
            make_float2(acc[4 * dn + 2 * half] * inv[half], acc[4 * dn + 2 * half + 1] * inv[half]);
      }
    }
    if (t == 0) {
#pragma unroll
      for (int half = 0; half < 2; ++half)
        part_lse[base * kBlockM + warp * 16 + g + half * 8] = m[half] + log2f(l[half]);
    }
  }
}

int launch_bf16_wide(const void* q, const void* k, const void* v, void* o, int bh, int sq,
                     int sk, int d, int causal, float scale_log2, const void* items,
                     int n_items, const void* combine, int n_combine, void* part_o,
                     void* part_lse, int n_slots, cudaStream_t st) {
  constexpr int kBytes = SmemWide::kBytes;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_bf16_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  auto* op = static_cast<__nv_bfloat16*>(o);
  const auto* ip = static_cast<const int4*>(items);
  const int n_y = ip != nullptr ? n_items : (sq + kBlockM - 1) / kBlockM;
  const int n_cs = d / kSlice;
  flash_fwd_bf16_wide_kernel<<<dim3(bh, n_y, n_cs), kThreads, kBytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), op, sq, sk, d, causal, scale_log2, ip,
      static_cast<float*>(part_o), static_cast<float*>(part_lse), n_slots);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || ip == nullptr || n_combine == 0) return static_cast<int>(e);
  flash_combine_kernel<kSlice><<<dim3(bh, n_combine, n_cs), kThreads, 0, st>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_lse),
      static_cast<const int4*>(combine), op, sq, n_slots, d);
  return static_cast<int>(cudaGetLastError());
}

// float32 wide heads: one warp per query row and column slice (grid.z);
// the dot over the whole head in a loop of 32-wide steps, the same in
// every slice.
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          int sq, int sk, int d, int causal, float scale_log2) {
  constexpr int kPer = kSlice / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + warp;
  const int bh = blockIdx.y;
  const int col0 = blockIdx.z * kSlice;
  if (row >= sq) return;
  const float* qr = q + (static_cast<size_t>(bh) * sq + row) * d;
  const float* kb = k + static_cast<size_t>(bh) * sk * d;
  const float* vb = v + static_cast<size_t>(bh) * sk * d + col0;
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
  const int k_end = causal ? min(sk, row + (sk - sq) + 1) : sk;
  float m = kNegInf, l = 0.f;
  for (int j = 0; j < k_end; ++j) {
    const float* kr = kb + static_cast<size_t>(j) * d;
    float dot = 0.f;
    for (int i = lane; i < d; i += 32) dot = fmaf(qr[i], kr[i], dot);
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, w);
    const float x = dot * scale_log2;
    const float m_new = fmaxf(m, x);
    const float alpha = exp2f(m - m_new);
    const float p = exp2f(x - m_new);
    l = l * alpha + p;
    const float* vr = vb + static_cast<size_t>(j) * d;
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] = fmaf(p, vr[lane + 32 * i], acc[i] * alpha);
    m = m_new;
  }
  float* orow = o + (static_cast<size_t>(bh) * sq + row) * d + col0;
  const float inv = 1.f / l;
#pragma unroll
  for (int i = 0; i < kPer; ++i) orow[lane + 32 * i] = acc[i] * inv;
}

// float32 inputs: one warp per query row, the same online softmax on FMA.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int sq, int sk, int causal, float scale_log2) {
  constexpr int kPer = D / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + warp;
  const int bh = blockIdx.y;
  if (row >= sq) return;  // the whole warp leaves together
  const float* qr = q + (static_cast<size_t>(bh) * sq + row) * D;
  const float* kb = k + static_cast<size_t>(bh) * sk * D;
  const float* vb = v + static_cast<size_t>(bh) * sk * D;
  float qv[kPer], acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    qv[i] = qr[lane + 32 * i];
    acc[i] = 0.f;
  }
  const int k_end = causal ? min(sk, row + (sk - sq) + 1) : sk;
  float m = kNegInf, l = 0.f;
  for (int j = 0; j < k_end; ++j) {
    const float* kr = kb + static_cast<size_t>(j) * D;
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) dot = fmaf(qv[i], kr[lane + 32 * i], dot);
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, w);
    const float x = dot * scale_log2;
    const float m_new = fmaxf(m, x);
    const float alpha = exp2f(m - m_new);
    const float p = exp2f(x - m_new);
    l = l * alpha + p;
    const float* vr = vb + static_cast<size_t>(j) * D;
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] = fmaf(p, vr[lane + 32 * i], acc[i] * alpha);
    m = m_new;
  }
  float* orow = o + (static_cast<size_t>(bh) * sq + row) * D;
  const float inv = 1.f / l;
#pragma unroll
  for (int i = 0; i < kPer; ++i) orow[lane + 32 * i] = acc[i] * inv;
}

}  // namespace

// q [bh, sq, d], k and v [bh, sk, d], o [bh, sq, d], all contiguous, on the
// device, 16-byte aligned; d is 32, 64, 128 or a multiple of 128. is_bf16: 1
// for bfloat16, 0 for float32. The bf16 kernel takes a split plan
// (ops/flash_attention.py::split_plan): items [n_items] int4 work items and
// combine [n_combine] int4 combine entries on the device, part_o [bh * c,
// n_slots, 64, d / c] and part_lse [bh * c, n_slots, 64] f32 scratch, with c
// = d / 128 column slices above d = 128 and 1 else; items null means no
// split. `scale` multiplies the scores: the
// caller passes 1/sqrt(head_dim) of the unpadded head, since a head narrower
// than d arrives zero-padded to d (last, so that a build before it, which
// ignores it, keeps its ABI). Launches on `stream` and returns
// cudaGetLastError() (0 when the launches were accepted).
extern "C" int dsst_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                        int bh, int sq, int sk, int d, int causal, int is_bf16,
                                        const void* items, int n_items, const void* combine,
                                        int n_combine, void* part_o, void* part_lse, int n_slots,
                                        void* stream, float scale) {
  const float scale_log2 = kLog2e * scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d > 128) {
    if (d % kSlice) return static_cast<int>(cudaErrorInvalidValue);
    if (is_bf16)
      return launch_bf16_wide(q, k, v, o, bh, sq, sk, d, causal, scale_log2, items, n_items,
                              combine, n_combine, part_o, part_lse, n_slots, st);
    flash_fwd_f32_wide_kernel<<<dim3((sq + kWarps - 1) / kWarps, bh, d / kSlice), kThreads, 0,
                                st>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                      static_cast<const float*>(v), static_cast<float*>(o), sq,
                                      sk, d, causal, scale_log2);
    return static_cast<int>(cudaGetLastError());
  }
  if (is_bf16) {
    if (d == 32)
      return launch_bf16<32>(q, k, v, o, bh, sq, sk, causal, scale_log2, items, n_items, combine,
                             n_combine, part_o, part_lse, n_slots, st);
    if (d == 64)
      return launch_bf16<64>(q, k, v, o, bh, sq, sk, causal, scale_log2, items, n_items, combine,
                             n_combine, part_o, part_lse, n_slots, st);
    if (d == 128)
      return launch_bf16<128>(q, k, v, o, bh, sq, sk, causal, scale_log2, items, n_items, combine,
                              n_combine, part_o, part_lse, n_slots, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((sq + kWarps - 1) / kWarps, bh);
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  auto* op = static_cast<float*>(o);
  if (d == 32) {
    flash_fwd_f32_kernel<32><<<grid, kThreads, 0, st>>>(qp, kp, vp, op, sq, sk, causal, scale_log2);
  } else if (d == 64) {
    flash_fwd_f32_kernel<64><<<grid, kThreads, 0, st>>>(qp, kp, vp, op, sq, sk, causal, scale_log2);
  } else if (d == 128) {
    flash_fwd_f32_kernel<128><<<grid, kThreads, 0, st>>>(qp, kp, vp, op, sq, sk, causal, scale_log2);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of one CTA of the bf16 kernel at head_dim d.
extern "C" int dsst_flash_attention_smem_bytes(int d) {
  if (d > 128) return d % kSlice ? -1 : SmemWide::kBytes;
  return d == 32 ? Smem<32>::kBytes : d == 64 ? Smem<64>::kBytes : d == 128 ? Smem<128>::kBytes : -1;
}
