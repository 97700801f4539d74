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
// Wider heads (d > 128). The wrapper zero-pads d to a multiple of 64 (192,
// 256 and 320 run as they are; 160 runs at 192) and takes it in column
// slices: d itself up to 256, else slices of 256 and a last one of the rest
// (d320: 256 + 64; d512: 256 + 256), one CTA per slice, so the scores are
// computed ceil(d / 256) times. A CTA owns 128 query rows, two consumer
// warpgroups of 64, so one K/V tile feeds 128 rows; Q is copied into shared
// memory once, over the whole head; K arrives in chunks of 64 head columns
// through a ring of 8 KB slots and V (64 keys x the slice) through stages,
// by cp.async counted on mbarriers. S = Q·Kᵀ accumulates over the chunks
// (m64n64k16 from shared memory); P·V is one wgmma of the slice's width per
// 16 keys (m64n{64,128,192,256}k16, P from registers). Shared memory (the
// host's wide_layout): d192 Q 48 KB + 16 K slots + 2 V stages of 24 KB;
// d256 64 + 12 x 8 + 2 x 32; d512 128 + 8 x 8 + one stage; from d768 Q no
// longer fits and each K slot carries its Q chunk (24 KB slots).
// - Slices up to 192 columns: warp-specialized (FA3's shape). Warpgroup 2
//   copies; warpgroups 0 and 1 compute, free a slot with one arrival per
//   warp, and where the ring holds a whole tile's K they issue Q·Kᵀ in turn
//   (named barriers 1 and 2), one's softmax under the other's products.
// - 256-column slices: lockstep. The accumulator is 64 x 256 f32, 128
//   registers a thread, beside S (32) and P (16). The register file is cut
//   per SM sub-partition (16K each), so a CTA of 9 to 12 warps caps every
//   thread at 168: with a producer warp or warpgroup, and with setmaxnreg
//   (24 to the producer, 240 to the consumers), ptxas still compiled the
//   consumers at 168 (C7512, wgmma serialized; ~600 B spilled) and d256 ran
//   at 2x PR 12's time. Eight warps get 255: the two consumer warpgroups
//   issue the copies themselves, in the producer's order, each step once
//   its slot is free, behind a __syncthreads after P·V (and after Q·Kᵀ
//   where the ring holds less than two tiles of K).
// - Both wait for P·V before the next tile, and zero S at each tile: the
//   first product ignores S (scale-d 0), but ptxas cannot tell, and kept the
//   last tile's S alive beside the accumulator.
// - Bound: 4 * d flops per visible pair, as above; causal b1 h8 s2048 d256
//   is 17.2 GFLOP, 0.0174 ms on 989 TFLOP/s: operations. One CTA fits an
//   SM, so a causal launch lasts as long as its longest CTA (32 key tiles at
//   s2048, twice the mean): where the grid underfills the card the key-split
//   plan cuts the tiles to the mean load of an SM (128-row tiles, as many
//   waves as the pieces take), combined by flash_combine_kernel<64> in a
//   fixed order, each consumer's 64 rows a combine tile of their own.
// Numerics as at d <= 128: f32 statistics in the log2 domain, P rounded to
// bf16 for P·V, l summed over the f32 P.
//
// float32. A tiled flash kernel on the CUDA cores, one template for every
// width (32, 64, 128 and the wide heads, sliced as above): a CTA of 256
// threads owns 64 query rows, its Q resident in shared memory (up to d =
// 704; above, each K chunk carries its Q chunk), and walks the visible key
// tiles of 64 keys. K arrives in chunks of 32 head columns and V in chunks
// of 8 keys through a three-slot cp.async ring, so each K and V element is
// read from memory once per query tile, not once per query row. S = Q·Kᵀ is
// register-blocked FFMA in full f32 (4 x 4 a thread, float4 reads from
// padded rows), the scale folded into the log2 step; the row max and sum
// reduce over the 16 threads of a row; P goes to shared memory; O += P·V
// (4 rows x slice / 16 columns a thread) stays in registers. Bound: f32
// FFMA at 67 TFLOP/s: causal b1 h8 s2048 d256 is 0.257 ms (operations).
// No split plan. Up to 128 columns two CTAs share an SM (128 registers);
// above, one (no register cap: at 128 a 256-column slice spilled).

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

// -- wide heads: d > 128, a multiple of 64 -----------------------------------

constexpr int kWideRows = 2 * kBlockM;         // query rows of a CTA: 64 per consumer warpgroup
constexpr int kWideSlice = 256;                // output columns of a CTA at most
constexpr int kBlockBytes = kBlockN * 64 * 2;  // one 64 x 64 bf16 SW128 block
constexpr int kSmemOptin = 232448;             // dynamic shared memory a block may opt in to
constexpr int kMaxRing = 24;                   // K slots at most

// Which kernel takes a slice of dv columns: up to 192 the warp-specialized
// one (three warpgroups); at 256 the lockstep one (two), whose threads may
// hold the 128-register accumulator (see the note at the top).
__host__ __device__ constexpr bool wide_lockstep(int dv) { return dv > 192; }
__host__ __device__ constexpr int wide_threads(int dv) {
  return (wide_lockstep(dv) ? 2 : 3) * kThreads;
}

// Shared memory of a wide launch, chosen on the host from d and the slice
// width dv: Q resident (q_res: d / 64 chunks of two blocks, the rows of
// consumer 0 and 1) or, where that leaves no room, carried by every K slot;
// a ring of rk K slots (one 64-key chunk of 64 head columns, plus that
// chunk's Q when Q is not resident); sv stages of V (64 keys x dv). hold:
// the ring holds a whole tile's K (rk >= d / 64), so a warpgroup issues a
// tile's Q·Kᵀ without waiting for slots, and the warp-specialized kernel's
// consumers take turns.
struct WideLayout {
  int q_res, rk, sv, hold, bytes;
};

__host__ __device__ inline int wide_bars(int rk, int sv) { return 8 * (1 + 2 * rk + 2 * sv); }

__host__ inline WideLayout wide_layout(int d, int dv) {
  const int nc = d / 64, v_stage = (dv / 64) * kBlockBytes;
  const int avail = kSmemOptin - 1024 - wide_bars(kMaxRing, 2);
  WideLayout best{-1, 0, 0, 0, 0};
  for (int q_res = 1; q_res >= 0 && best.q_res < 0; --q_res) {
    const int q_bytes = q_res ? nc * 2 * kBlockBytes : 0;
    const int slot = q_res ? kBlockBytes : 3 * kBlockBytes;
    for (int pass = 0; pass < 2 && best.q_res < 0; ++pass) {
      for (int sv = 2; sv >= 1; --sv) {
        const int rest = avail - q_bytes - sv * v_stage;
        const int rk = rest < 0 ? 0 : rest / slot < kMaxRing ? rest / slot : kMaxRing;
        // First pass: room for a whole tile's K; second: two slots.
        if (pass == 0 ? rk >= nc : rk >= 2) {
          best = {q_res, rk, sv, pass == 0, 1024 + q_bytes + rk * slot + sv * v_stage +
                                                wide_bars(rk, sv)};
          break;
        }
      }
    }
  }
  return best;
}

// Copy rows [row0, row0 + 64) x 64 columns of a slab whose rows are ld
// elements apart into one SW128 block at dst, zero-filling rows at or past
// n_rows; thread tid of the kCopiers that copy.
template <int kCopiers>
__device__ __forceinline__ void copy_block64(uint32_t dst, const __nv_bfloat16* src, int ld,
                                             int row0, int n_rows, int tid) {
#pragma unroll
  for (int i = tid; i < kBlockN * 8; i += kCopiers) {
    const int r = i / 8, c = i % 8;
    const bool valid = row0 + r < n_rows;
    const __nv_bfloat16* p = src + (valid ? static_cast<size_t>(row0 + r) * ld + c * 8 : 0);
    cp_async16(dst + sw128(r, c), p, valid);
  }
}

// The copies of a wide item. Q: the CTA's 128 rows, d / 64 chunks of two
// blocks. K chunk c of the tile at key0 (with its Q chunk when Q is not
// resident). V: the tile's DV columns of the slice, DV / 64 blocks.
template <int kCopiers>
__device__ __forceinline__ void copy_q_wide(uint32_t s_q, const __nv_bfloat16* qb, int d, int q0,
                                            int sq, int tid) {
  for (int c = 0; c < d / 64; ++c) {
    copy_block64<kCopiers>(s_q + c * 2 * kBlockBytes, qb + c * 64, d, q0, sq, tid);
    copy_block64<kCopiers>(s_q + c * 2 * kBlockBytes + kBlockBytes, qb + c * 64, d,
                           q0 + kBlockM, sq, tid);
  }
}

template <bool QRES, int kCopiers>
__device__ __forceinline__ void copy_k_chunk(uint32_t dst, const __nv_bfloat16* qb,
                                             const __nv_bfloat16* kb, int d, int c, int key0,
                                             int q0, int sq, int sk, int tid) {
  copy_block64<kCopiers>(dst, kb + c * 64, d, key0, sk, tid);
  if constexpr (!QRES) {
    copy_block64<kCopiers>(dst + kBlockBytes, qb + c * 64, d, q0, sq, tid);
    copy_block64<kCopiers>(dst + 2 * kBlockBytes, qb + c * 64, d, q0 + kBlockM, sq, tid);
  }
}

template <int DV, int kCopiers>
__device__ __forceinline__ void copy_v_wide(uint32_t dst, const __nv_bfloat16* vb, int d,
                                            int key0, int sk, int tid) {
#pragma unroll
  for (int b = 0; b < DV / 64; ++b)
    copy_block64<kCopiers>(dst + b * kBlockBytes, vb + b * 64, d, key0, sk, tid);
}

// Key tiles that a 128-row query tile sees: those of its last row.
__device__ __forceinline__ int visible_tiles_wide(int qt, int sq, int sk, int causal) {
  const int n_kt = (sk + kBlockN - 1) / kBlockN;
  if (!causal) return n_kt;
  const int last_row = min((qt + 1) * kWideRows, sq) - 1;
  return min(n_kt, (last_row + sk - sq) / kBlockN + 1);
}

// A wide CTA's work item: items (as flash_fwd_bf16_kernel's, in 128-row
// query tiles) null: item y is query tile y, longest first.
struct WideItem {
  int q0, kt_begin, n, slot;
};

__device__ __forceinline__ WideItem wide_item(const int4* items, int sq, int sk, int causal) {
  if (items != nullptr) {
    const int4 it = items[blockIdx.y];
    return {it.x * kWideRows, it.y, it.z - it.y, it.w};
  }
  const int n_qt = (sq + kWideRows - 1) / kWideRows;
  const int qt = causal ? n_qt - 1 - static_cast<int>(blockIdx.y) : blockIdx.y;
  return {qt * kWideRows, 0, visible_tiles_wide(qt, sq, sk, causal), -1};
}

// The online softmax of the wide kernels: softmax_tile's, with each row's
// keys live below lim (sk, or causal the row's last visible key + 1).
__device__ __forceinline__ void softmax_tile_lim(float (&s)[32], float (&m)[2], float (&l)[2],
                                                 float (&alpha)[2], int k0, const int (&lim)[2],
                                                 float scale_log2) {
  const int key0 = k0 + (threadIdx.x % 4) * 2;
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    const float x = key0 + (i >> 2) * 8 + (i & 1) < lim[h] ? s[i] * scale_log2 : kNegInf;
    s[i] = x;
    mx[h] = fmaxf(mx[h], x);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    alpha[h] = exp2f(m[h] - m_new);
    m[h] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float p = exp2f(s[i] - m[(i >> 1) & 1]);
    s[i] = p;
    rs[(i >> 1) & 1] += p;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
}

// S (+)= Q·Kᵀ over one 64-column chunk of the head: four m64n64k16 from
// shared memory, committed as one group (not waited for).
__device__ __forceinline__ void issue_qk_chunk(float (&s)[32], uint32_t qc, uint32_t kc,
                                               bool first) {
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    wgmma_m64n64k16_ss<0>(s, sw128_desc(qc + ks * 32, 16, 1024),
                          sw128_desc(kc + ks * 32, 16, 1024), !first || ks > 0);
  }
  wgmma_commit();
  fence_regs(s);
}

// Rescale the accumulator by alpha and give P in bf16 as the A operand of
// P·V: the S accumulators of key columns [16kk, 16kk+16) are step kk's.
template <int R>
__device__ __forceinline__ void rescale_and_pack(float (&acc)[R], const float (&alpha)[2],
                                                 const float (&s)[32], uint32_t (&pa)[4][4]) {
  fence_regs(acc);
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
  }
}

// O += P·V over the 64 keys of a tile for DV output columns: one wgmma of
// width DV per 16 keys, P from registers, V [key][column] MN-major.
template <int DV>
__device__ __forceinline__ void issue_pv_wide(float (&acc)[DV / 2], const uint32_t (&pa)[4][4],
                                              uint32_t s_v) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t desc = sw128_desc(s_v + kk * 2048, kBlockBytes, 1024);
    if constexpr (DV == 256) {
      wgmma_m64n256k16_rs<1>(acc, pa[kk], desc, 1);
    } else if constexpr (DV == 192) {
      wgmma_m64n192k16_rs<1>(acc, pa[kk], desc, 1);
    } else if constexpr (DV == 128) {
      wgmma_m64n128k16_rs<1>(acc, pa[kk], desc, 1);
    } else {
      wgmma_m64n64k16_rs<1>(acc, pa[kk], desc, 1);
    }
  }
  wgmma_commit();
  fence_regs(acc);
}

// The end of a consumer's 64 rows: full row sums, then the output in bf16
// at columns [c0, c0 + DV), or for a split piece (slot >= 0), for each
// 64-column block z of them, partial slot wi * n_slots + slot:
// part_o[bh][z][2 * n_slots][64][64] normalized, part_lse[...][64] its log2
// sum-exp.
template <int DV>
__device__ __forceinline__ void wide_epilogue(const float (&acc)[DV / 2], const float (&m)[2],
                                              float (&l)[2], __nv_bfloat16* __restrict__ o,
                                              int bh, int sq, int d, int c0, const int (&rows)[2],
                                              int wi, int slot, float* __restrict__ part_o,
                                              float* __restrict__ part_lse, int n_slots) {
  const int warp = (threadIdx.x / 32) % kWarps, g = (threadIdx.x % 32) >> 2, t = threadIdx.x & 3;
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / l[i];  // never 0: the row's largest score has p = 1
  }
  if (slot < 0) {
#pragma unroll
    for (int dn = 0; dn < DV / 8; ++dn) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = rows[half];
        if (row < sq) {
          const int col = c0 + dn * 8 + t * 2;
          *reinterpret_cast<uint32_t*>(o + (static_cast<size_t>(bh) * sq + row) * d + col) =
              pack_bf16(acc[4 * dn + 2 * half] * inv[half], acc[4 * dn + 2 * half + 1] * inv[half]);
        }
      }
    }
    return;
  }
  const int n_z = d / 64;
#pragma unroll
  for (int b = 0; b < DV / 64; ++b) {
    const size_t base =
        (static_cast<size_t>(bh) * n_z + c0 / 64 + b) * (2 * n_slots) + wi * n_slots + slot;
    float* po = part_o + base * kBlockM * 64;
#pragma unroll
    for (int dn = 0; dn < 8; ++dn) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = warp * 16 + g + half * 8;
        const int i = 4 * (8 * b + dn) + 2 * half;
        *reinterpret_cast<float2*>(po + r * 64 + dn * 8 + t * 2) =
            make_float2(acc[i] * inv[half], acc[i + 1] * inv[half]);
      }
    }
    if (t == 0) {
#pragma unroll
      for (int half = 0; half < 2; ++half)
        part_lse[base * kBlockM + warp * 16 + g + half * 8] = m[half] + log2f(l[half]);
    }
  }
}

// The warp-specialized wide kernel (slices of 64 to 192 columns): one work
// item for the DV columns from col0 + blockIdx.z * DV. Warpgroup 2 copies;
// warpgroups 0 and 1 compute, 64 query rows each.
template <int DV, bool QRES>
__global__ void __launch_bounds__(3 * kThreads, 1)
flash_fwd_bf16_wide_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                           int sq, int sk, int d, int col0, int causal, float scale_log2,
                           const int4* __restrict__ items, float* __restrict__ part_o,
                           float* __restrict__ part_lse, int n_slots, int rk, int sv, int hold) {
  constexpr int kSlot = QRES ? kBlockBytes : 3 * kBlockBytes;
  constexpr int kVStage = (DV / 64) * kBlockBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  const int nc = d / 64;
  const int q_bytes = QRES ? nc * 2 * kBlockBytes : 0;
  const uint32_t s_q = smem_u32(smem);
  const uint32_t s_k = s_q + q_bytes, s_v = s_k + rk * kSlot;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + q_bytes + rk * kSlot + sv * kVStage);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + rk;
  uint64_t* v_full = k_empty + rk;
  uint64_t* v_empty = v_full + sv;

  const int bh = blockIdx.x, c0 = col0 + blockIdx.z * DV;
  const WideItem it = wide_item(items, sq, sk, causal);
  const int q0 = it.q0, n = it.n;

  if (threadIdx.x == 0) {
    mbar_init(q_full, kThreads);
    for (int i = 0; i < rk; ++i) {
      mbar_init(&k_full[i], kThreads);
      mbar_init(&k_empty[i], 2 * kWarps);
    }
    for (int i = 0; i < sv; ++i) {
      mbar_init(&v_full[i], kThreads);
      mbar_init(&v_empty[i], 2 * kWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 2 * kThreads) {
    // The producer: Q once, then per key tile its K chunks and its V.
    const int pt = threadIdx.x - 2 * kThreads;
    const __nv_bfloat16* qb = q + static_cast<size_t>(bh) * sq * d;
    const __nv_bfloat16* kb = k + static_cast<size_t>(bh) * sk * d;
    const __nv_bfloat16* vb = v + static_cast<size_t>(bh) * sk * d + c0;
    if constexpr (QRES) {
      copy_q_wide<kThreads>(s_q, qb, d, q0, sq, pt);
      cp_async_arrive(q_full);
    }
    int u = 0;
    for (int j = 0; j < n; ++j) {
      const int key0 = (it.kt_begin + j) * kBlockN;
      for (int c = 0; c < nc; ++c, ++u) {
        const int st = u % rk;
        if (u >= rk) mbar_wait(&k_empty[st], ((u / rk) - 1) & 1);
        copy_k_chunk<QRES, kThreads>(s_k + st * kSlot, qb, kb, d, c, key0, q0, sq, sk, pt);
        cp_async_arrive(&k_full[st]);
      }
      const int vs = j % sv;
      if (j >= sv) mbar_wait(&v_empty[vs], ((j / sv) - 1) & 1);
      copy_v_wide<DV, kThreads>(s_v + vs * kVStage, vb, d, key0, sk, pt);
      cp_async_arrive(&v_full[vs]);
    }
    cp_async_wait_all();
    return;
  }
  // A consumer: 64 query rows against every key tile of the item.
  const int wi = threadIdx.x / kThreads;
  const int lane = threadIdx.x % 32;
  const int row0 = q0 + wi * kBlockM + (threadIdx.x / 32) % kWarps * 16 + (lane >> 2);
  const int rows[2] = {row0, row0 + 8};
  const int lim[2] = {causal ? min(sk, rows[0] + sk - sq + 1) : sk,
                      causal ? min(sk, rows[1] + sk - sq + 1) : sk};
  // A slot or a stage is free once every consumer warp's products that read
  // it have completed: one arrival per warp.
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  float acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float s[32];
  if constexpr (QRES) mbar_wait(q_full, 0);
  // Turns (where the ring holds a tile's K): named barrier 1 + w is
  // warpgroup w's; consumer 0 goes first. Without, each chunk's slot is
  // freed as the next chunk is issued.
  if (hold && wi == 1) named_bar_arrive(1, 2 * kThreads);
  int u = 0;
  for (int j = 0; j < n; ++j) {
    // The first product ignores S (scale-d 0), but ptxas cannot tell: zero
    // it, or it keeps the last tile's S alive beside the accumulator.
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    if (hold) named_bar_sync(1 + wi, 2 * kThreads);
    for (int c = 0; c < nc; ++c, ++u) {
      const int st = u % rk;
      mbar_wait(&k_full[st], (u / rk) & 1);
      fence_proxy_async();
      const uint32_t kc = s_k + st * kSlot;
      issue_qk_chunk(s, QRES ? s_q + c * 2 * kBlockBytes + wi * kBlockBytes
                             : kc + kBlockBytes + wi * kBlockBytes,
                     kc, c == 0);
      if (!hold && c > 0) {
        wgmma_wait<1>();  // one group in flight: the one before it is done
        fence_regs(s);
        release(&k_empty[(u - 1) % rk]);
      }
    }
    // The other warpgroup's turn: its products run while this one's
    // softmax does. Consumer 1 owes none after its last tile.
    if (hold && !(wi == 1 && j == n - 1)) named_bar_arrive(2 - wi, 2 * kThreads);
    wgmma_wait<0>();
    fence_regs(s);
    for (int c = hold ? nc : 1; c > 0; --c) release(&k_empty[(u - c) % rk]);
    float alpha[2];
    softmax_tile_lim(s, m, l, alpha, (it.kt_begin + j) * kBlockN, lim, scale_log2);
    uint32_t pa[4][4];
    rescale_and_pack(acc, alpha, s, pa);
    const int vs = j % sv;
    mbar_wait(&v_full[vs], (j / sv) & 1);
    fence_proxy_async();
    issue_pv_wide<DV>(acc, pa, s_v + vs * kVStage);
    // Done before the next tile: the accumulator and P then need not stay
    // pinned beside S.
    wgmma_wait<0>();
    fence_regs(acc);
    release(&v_empty[vs]);
  }
  wide_epilogue<DV>(acc, m, l, o, bh, sq, d, c0, rows, wi, it.slot, part_o, part_lse, n_slots);
}

// The lockstep wide kernel (slices of 256 columns): the same work item,
// computed by two warpgroups of 64 rows each that also do the copies, in
// the same order as the producer's, behind __syncthreads where slots free.
template <int DV, bool QRES>
__global__ void __launch_bounds__(2 * kThreads, 1)
flash_fwd_bf16_wide_lockstep_kernel(const __nv_bfloat16* __restrict__ q,
                                    const __nv_bfloat16* __restrict__ k,
                                    const __nv_bfloat16* __restrict__ v,
                                    __nv_bfloat16* __restrict__ o, int sq, int sk, int d,
                                    int col0, int causal, float scale_log2,
                                    const int4* __restrict__ items, float* __restrict__ part_o,
                                    float* __restrict__ part_lse, int n_slots, int rk, int sv,
                                    int hold) {
  constexpr int kCopiers = 2 * kThreads;
  constexpr int kSlot = QRES ? kBlockBytes : 3 * kBlockBytes;
  constexpr int kVStage = (DV / 64) * kBlockBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  const int nc = d / 64;
  const int q_bytes = QRES ? nc * 2 * kBlockBytes : 0;
  const uint32_t s_q = smem_u32(smem);
  const uint32_t s_k = s_q + q_bytes, s_v = s_k + rk * kSlot;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + q_bytes + rk * kSlot + sv * kVStage);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + rk;

  const int bh = blockIdx.x, c0 = col0 + blockIdx.z * DV;
  const WideItem it = wide_item(items, sq, sk, causal);
  const int q0 = it.q0, n = it.n;
  const int tid = threadIdx.x;
  const __nv_bfloat16* qb = q + static_cast<size_t>(bh) * sq * d;
  const __nv_bfloat16* kb = k + static_cast<size_t>(bh) * sk * d;
  const __nv_bfloat16* vb = v + static_cast<size_t>(bh) * sk * d + c0;

  if (tid == 0) {
    mbar_init(q_full, kCopiers);
    for (int i = 0; i < rk; ++i) mbar_init(&k_full[i], kCopiers);
    for (int i = 0; i < sv; ++i) mbar_init(&v_full[i], kCopiers);
    mbar_fence_init();
  }
  __syncthreads();

  // The copies' cursor: step x of the item is K chunk x % (nc + 1) of tile
  // x / (nc + 1), or that tile's V when x % (nc + 1) == nc. A step is
  // issued when its slot is free; the counts are the same in every thread.
  int x = 0, k_issued = 0, k_freed = 0, v_issued = 0, v_freed = 0;
  auto issue = [&]() {
    for (; x < n * (nc + 1); ++x) {
      const int j = x / (nc + 1), c = x % (nc + 1);
      const int key0 = (it.kt_begin + j) * kBlockN;
      if (c < nc) {
        if (k_issued - k_freed == rk) break;
        const int st = k_issued++ % rk;
        copy_k_chunk<QRES, kCopiers>(s_k + st * kSlot, qb, kb, d, c, key0, q0, sq, sk, tid);
        cp_async_arrive(&k_full[st]);
      } else {
        if (v_issued - v_freed == sv) break;
        const int vs = v_issued++ % sv;
        copy_v_wide<DV, kCopiers>(s_v + vs * kVStage, vb, d, key0, sk, tid);
        cp_async_arrive(&v_full[vs]);
      }
    }
  };
  if constexpr (QRES) {
    copy_q_wide<kCopiers>(s_q, qb, d, q0, sq, tid);
    cp_async_arrive(q_full);
  }
  issue();

  const int wi = tid / kThreads;
  const int row0 = q0 + wi * kBlockM + (tid / 32) % kWarps * 16 + ((tid % 32) >> 2);
  const int rows[2] = {row0, row0 + 8};
  const int lim[2] = {causal ? min(sk, rows[0] + sk - sq + 1) : sk,
                      causal ? min(sk, rows[1] + sk - sq + 1) : sk};
  float acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float s[32];
  if constexpr (QRES) mbar_wait(q_full, 0);
  int u = 0;
  for (int j = 0; j < n; ++j) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;  // as in the warp-specialized kernel
    for (int c = 0; c < nc; ++c, ++u) {
      const int st = u % rk;
      mbar_wait(&k_full[st], (u / rk) & 1);
      fence_proxy_async();
      const uint32_t kc = s_k + st * kSlot;
      issue_qk_chunk(s, QRES ? s_q + c * 2 * kBlockBytes + wi * kBlockBytes
                             : kc + kBlockBytes + wi * kBlockBytes,
                     kc, c == 0);
      if (!hold && c > 0) {
        wgmma_wait<1>();
        fence_regs(s);
        __syncthreads();  // both warpgroups are done with chunk u - 1
        ++k_freed;
        issue();
      }
    }
    wgmma_wait<0>();
    fence_regs(s);
    // The tile's K (or its last chunk) is free. Where the ring holds two
    // tiles of K, the barrier after P·V frees it instead: one barrier a
    // tile, so the warpgroups may drift apart within it.
    const bool late = hold && rk >= 2 * nc;
    if (!late) {
      __syncthreads();
      k_freed += hold ? nc : 1;
      issue();
    }
    float alpha[2];
    softmax_tile_lim(s, m, l, alpha, (it.kt_begin + j) * kBlockN, lim, scale_log2);
    uint32_t pa[4][4];
    rescale_and_pack(acc, alpha, s, pa);
    const int vs = j % sv;
    mbar_wait(&v_full[vs], (j / sv) & 1);
    fence_proxy_async();
    issue_pv_wide<DV>(acc, pa, s_v + vs * kVStage);
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // the tile's V is free
    ++v_freed;
    if (late) k_freed += nc;
    issue();
  }
  cp_async_wait_all();
  wide_epilogue<DV>(acc, m, l, o, bh, sq, d, c0, rows, wi, it.slot, part_o, part_lse, n_slots);
}

template <int DV, bool QRES>
int launch_wide_slices(const void* q, const void* k, const void* v, void* o, int bh, int sq,
                       int sk, int d, int col0, int n_z, int causal, float scale_log2,
                       const int4* items, int n_y, void* part_o, void* part_lse, int n_slots,
                       const WideLayout& lay, cudaStream_t st) {
  auto* kernel = [] {  // only the kernel that takes DV is built
    if constexpr (wide_lockstep(DV)) {
      return flash_fwd_bf16_wide_lockstep_kernel<DV, QRES>;
    } else {
      return flash_fwd_bf16_wide_kernel<DV, QRES>;
    }
  }();
  static bool configured = false;  // more than 48 KB needs the opt-in
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemOptin);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  kernel<<<dim3(bh, n_y, n_z), wide_threads(DV), lay.bytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), sq, sk, d, col0,
      causal, scale_log2, items, static_cast<float*>(part_o), static_cast<float*>(part_lse),
      n_slots, lay.rk, lay.sv, lay.hold);
  return static_cast<int>(cudaGetLastError());
}

template <int DV>
int launch_wide_dv(const void* q, const void* k, const void* v, void* o, int bh, int sq, int sk,
                   int d, int col0, int n_z, int causal, float scale_log2, const int4* items,
                   int n_y, void* part_o, void* part_lse, int n_slots, cudaStream_t st) {
  const WideLayout lay = wide_layout(d, DV);
  if (lay.q_res < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto* f = lay.q_res ? launch_wide_slices<DV, true> : launch_wide_slices<DV, false>;
  return f(q, k, v, o, bh, sq, sk, d, col0, n_z, causal, scale_log2, items, n_y, part_o,
           part_lse, n_slots, lay, st);
}

// Column slices of a wide head: d itself up to 256, else slices of 256 and
// a last one of the rest (a multiple of 64). One launch per slice width.
int launch_bf16_wide(const void* q, const void* k, const void* v, void* o, int bh, int sq,
                     int sk, int d, int causal, float scale_log2, const void* items,
                     int n_items, const void* combine, int n_combine, void* part_o,
                     void* part_lse, int n_slots, cudaStream_t st) {
  const auto* ip = static_cast<const int4*>(items);
  const int n_y = ip != nullptr ? n_items : (sq + kWideRows - 1) / kWideRows;
  const int n_main = d > kWideSlice ? d / kWideSlice : 0;
  const int tail = d - n_main * kWideSlice;
  int e = 0;
  if (n_main > 0)
    e = launch_wide_dv<256>(q, k, v, o, bh, sq, sk, d, 0, n_main, causal, scale_log2, ip, n_y,
                            part_o, part_lse, n_slots, st);
  if (e == 0 && tail > 0) {
    const int col0 = n_main * kWideSlice;
    auto* f = tail == 256   ? launch_wide_dv<256>
              : tail == 192 ? launch_wide_dv<192>
              : tail == 128 ? launch_wide_dv<128>
                            : launch_wide_dv<64>;
    e = f(q, k, v, o, bh, sq, sk, d, col0, 1, causal, scale_log2, ip, n_y, part_o, part_lse,
          n_slots, st);
  }
  if (e != 0 || ip == nullptr || n_combine == 0) return e;
  // combine entries are in 64-row query tiles: consumer w of 128-row tile
  // qt is tile 2 qt + w, its slots w * n_slots + slot.
  flash_combine_kernel<64><<<dim3(bh, n_combine, d / 64), kThreads, 0, st>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_lse),
      static_cast<const int4*>(combine), static_cast<__nv_bfloat16*>(o), sq, 2 * n_slots, d);
  return static_cast<int>(cudaGetLastError());
}

// -- float32 -------------------------------------------------------------------

constexpr int kF32Threads = 256;   // 16 x 16 threads over a 64 x 64 tile
constexpr int kF32Chunk = 32;      // head columns of a K (and Q) chunk
constexpr int kF32Ld = kF32Chunk + 4;  // floats of a chunk row: the pad spreads the banks
constexpr int kF32VKeys = 8;       // keys of a V chunk
constexpr int kF32VSteps = kBlockN / kF32VKeys;
constexpr int kF32Stages = 3;      // ring slots
constexpr int kF32PLd = kBlockN + 4;

// Floats of a ring slot: a K chunk (with its Q chunk when Q is not resident)
// or a V chunk of DV columns, whichever is larger.
__host__ __device__ constexpr int f32_slot_floats(int dv, int q_res) {
  return (q_res ? 1 : 2) * kBlockN * kF32Ld > kF32VKeys * (dv + 4)
             ? (q_res ? 1 : 2) * kBlockN * kF32Ld
             : kF32VKeys * (dv + 4);
}

__host__ __device__ constexpr int f32_smem_bytes(int d, int dv, int q_res) {
  return 4 * ((q_res ? kBlockM * (d + 4) : 0) + kF32Stages * f32_slot_floats(dv, q_res) +
              kBlockM * kF32PLd);
}

// One 64-row query tile (longest first) for the DV columns from col0 +
// blockIdx.z * DV. Thread (ty, tx) = (tid / 16, tid % 16) holds the scores
// of rows ty + 16i and keys tx + 16j, and the output of rows ty + 16i and
// columns 4tx + 64c + e (DV = 32: 2tx + e).
template <int DV, bool QRES>
__global__ void __launch_bounds__(kF32Threads, DV > 128 ? 1 : 2)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int sq, int sk, int d,
                     int col0, int causal, float scale_log2) {
  constexpr int kSlotF = f32_slot_floats(DV, QRES);
  constexpr int kVLd = DV + 4;
  constexpr int kCols = DV / 16;  // output columns of a thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldq = d + 4;
  float* s_q = smem;
  float* s_ring = smem + (QRES ? kBlockM * ldq : 0);
  float* s_p = s_ring + kF32Stages * kSlotF;

  const int bh = blockIdx.x, c0 = col0 + blockIdx.z * DV;
  const int n_qt = (sq + kBlockM - 1) / kBlockM;
  const int qt = causal ? n_qt - 1 - static_cast<int>(blockIdx.y) : blockIdx.y;
  const int q0 = qt * kBlockM;
  const int n = visible_tiles(qt, sq, sk, causal);
  const int nc = d / kF32Chunk;
  const int per = nc + kF32VSteps;  // ring steps per key tile: K chunks, then V chunks
  const int total = n * per;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int offset = sk - sq;
  const float* qb = q + static_cast<size_t>(bh) * sq * d;
  const float* kb = k + static_cast<size_t>(bh) * sk * d;
  const float* vb = v + static_cast<size_t>(bh) * sk * d + c0;

  auto load = [&](int u) {
    float* slot = s_ring + (u % kF32Stages) * kSlotF;
    const int j = u / per, st = u % per;
    const int key0 = j * kBlockN;
    if (st < nc) {
      for (int i = tid; i < kBlockN * (kF32Chunk / 4); i += kF32Threads) {
        const int r = i / (kF32Chunk / 4), c = i % (kF32Chunk / 4);
        const bool valid = key0 + r < sk;
        cp_async16(smem_u32(slot + r * kF32Ld + c * 4),
                   kb + (valid ? static_cast<size_t>(key0 + r) * d + st * kF32Chunk + c * 4 : 0),
                   valid);
        if constexpr (!QRES) {
          const bool qv = q0 + r < sq;
          cp_async16(smem_u32(slot + (kBlockN + r) * kF32Ld + c * 4),
                     qb + (qv ? static_cast<size_t>(q0 + r) * d + st * kF32Chunk + c * 4 : 0), qv);
        }
      }
    } else {
      const int kv0 = key0 + (st - nc) * kF32VKeys;
      for (int i = tid; i < kF32VKeys * (DV / 4); i += kF32Threads) {
        const int r = i / (DV / 4), c = i % (DV / 4);
        const bool valid = kv0 + r < sk;
        cp_async16(smem_u32(slot + r * kVLd + c * 4),
                   vb + (valid ? static_cast<size_t>(kv0 + r) * d + c * 4 : 0), valid);
      }
    }
  };

  if constexpr (QRES) {
    const int row4 = d / 4;
    for (int i = tid; i < kBlockM * row4; i += kF32Threads) {
      const int r = i / row4, c = i % row4;
      const bool valid = q0 + r < sq;
      cp_async16(smem_u32(s_q + r * ldq + c * 4),
                 qb + (valid ? static_cast<size_t>(q0 + r) * d + c * 4 : 0), valid);
    }
  }
#pragma unroll
  for (int u = 0; u < kF32Stages - 1; ++u) {
    if (u < total) load(u);
    cp_async_commit();
  }

  float s[4][4], acc[4][kCols], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int u = 0; u < total; ++u) {
    cp_async_wait<kF32Stages - 2>();
    __syncthreads();  // step u landed for every thread; every thread left step u - 1
    if (u + kF32Stages - 1 < total) load(u + kF32Stages - 1);
    cp_async_commit();
    const float* slot = s_ring + (u % kF32Stages) * kSlotF;
    const int j = u / per, st = u % per;
    if (st < nc) {
      // S += Q·Kᵀ over 32 head columns.
      if (st == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
      }
      const float* qc = QRES ? s_q + st * kF32Chunk : slot + kBlockN * kF32Ld;
      const int ldqc = QRES ? ldq : kF32Ld;
#pragma unroll
      for (int kk = 0; kk < kF32Chunk; kk += 4) {
        float4 kf[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          kf[jj] = *reinterpret_cast<const float4*>(slot + (tx + 16 * jj) * kF32Ld + kk);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 qf = *reinterpret_cast<const float4*>(qc + (ty + 16 * i) * ldqc + kk);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            s[i][jj] = fmaf(qf.x, kf[jj].x, s[i][jj]);
            s[i][jj] = fmaf(qf.y, kf[jj].y, s[i][jj]);
            s[i][jj] = fmaf(qf.z, kf[jj].z, s[i][jj]);
            s[i][jj] = fmaf(qf.w, kf[jj].w, s[i][jj]);
          }
        }
      }
      if (st == nc - 1) {
        // The online softmax of key tile j; P to shared memory for P·V.
        const int key0 = j * kBlockN;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = q0 + ty + 16 * i;
          float mx = kNegInf;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int key = key0 + tx + 16 * jj;
            const bool live = key < sk && (!causal || key <= row + offset);
            s[i][jj] = live ? s[i][jj] * scale_log2 : kNegInf;
            mx = fmaxf(mx, s[i][jj]);
          }
#pragma unroll
          for (int w = 1; w < 16; w <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
          const float m_new = fmaxf(m[i], mx);
          const float alpha = exp2f(m[i] - m_new);
          m[i] = m_new;
          float rs = 0.f;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float p = exp2f(s[i][jj] - m_new);
            rs += p;
            s_p[(ty + 16 * i) * kF32PLd + tx + 16 * jj] = p;
          }
          l[i] = l[i] * alpha + rs;  // this thread's part of the row sum
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
        }
      }
    } else {
      // O += P·V over 8 keys (P written at step nc - 1, behind a barrier).
      const int kv = (st - nc) * kF32VKeys;
#pragma unroll
      for (int kk = 0; kk < kF32VKeys; kk += 4) {
        float4 pf[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pf[i] = *reinterpret_cast<const float4*>(s_p + (ty + 16 * i) * kF32PLd + kv + kk);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* vr = slot + (kk + e) * kVLd;
          if constexpr (DV >= 64) {
#pragma unroll
            for (int cc = 0; cc < DV / 64; ++cc) {
              const float4 vf = *reinterpret_cast<const float4*>(vr + 4 * tx + 64 * cc);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float pe = e == 0 ? pf[i].x : e == 1 ? pf[i].y : e == 2 ? pf[i].z : pf[i].w;
                acc[i][4 * cc] = fmaf(pe, vf.x, acc[i][4 * cc]);
                acc[i][4 * cc + 1] = fmaf(pe, vf.y, acc[i][4 * cc + 1]);
                acc[i][4 * cc + 2] = fmaf(pe, vf.z, acc[i][4 * cc + 2]);
                acc[i][4 * cc + 3] = fmaf(pe, vf.w, acc[i][4 * cc + 3]);
              }
            }
          } else {
            const float2 vf = *reinterpret_cast<const float2*>(vr + 2 * tx);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float pe = e == 0 ? pf[i].x : e == 1 ? pf[i].y : e == 2 ? pf[i].z : pf[i].w;
              acc[i][0] = fmaf(pe, vf.x, acc[i][0]);
              acc[i][1] = fmaf(pe, vf.y, acc[i][1]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int w = 1; w < 16; w <<= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], w);
    const float inv = 1.f / l[i];  // never 0: the row's largest score has p = 1
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    float* orow = o + (static_cast<size_t>(bh) * sq + row) * d + c0;
    if constexpr (DV >= 64) {
#pragma unroll
      for (int cc = 0; cc < DV / 64; ++cc)
        *reinterpret_cast<float4*>(orow + 4 * tx + 64 * cc) =
            make_float4(acc[i][4 * cc] * inv, acc[i][4 * cc + 1] * inv, acc[i][4 * cc + 2] * inv,
                        acc[i][4 * cc + 3] * inv);
    } else {
      *reinterpret_cast<float2*>(orow + 2 * tx) = make_float2(acc[i][0] * inv, acc[i][1] * inv);
    }
  }
}

template <int DV>
int launch_f32_dv(const float* q, const float* k, const float* v, float* o, int bh, int sq,
                  int sk, int d, int col0, int n_z, int causal, float scale_log2,
                  cudaStream_t st) {
  const bool q_res = f32_smem_bytes(d, DV, 1) <= kSmemOptin;
  auto* kernel = q_res ? flash_fwd_f32_kernel<DV, true> : flash_fwd_f32_kernel<DV, false>;
  const int bytes = f32_smem_bytes(d, DV, q_res);
  static bool configured[2] = {false, false};
  if (!configured[q_res]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemOptin);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured[q_res] = true;
  }
  kernel<<<dim3(bh, (sq + kBlockM - 1) / kBlockM, n_z), kF32Threads, bytes, st>>>(
      q, k, v, o, sq, sk, d, col0, causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// float32 at any d a multiple of 32 up to 128 and of 64 above: one slice of
// d up to 256, else slices of 256 and a last one of the rest.
int launch_f32(const void* q, const void* k, const void* v, void* o, int bh, int sq, int sk,
               int d, int causal, float scale_log2, cudaStream_t st) {
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  auto* op = static_cast<float*>(o);
  const int n_main = d > kWideSlice ? d / kWideSlice : 0;
  const int tail = d - n_main * kWideSlice;
  int e = 0;
  if (n_main > 0)
    e = launch_f32_dv<256>(qp, kp, vp, op, bh, sq, sk, d, 0, n_main, causal, scale_log2, st);
  if (e == 0 && tail > 0) {
    auto* f = tail == 256   ? launch_f32_dv<256>
              : tail == 192 ? launch_f32_dv<192>
              : tail == 128 ? launch_f32_dv<128>
              : tail == 64  ? launch_f32_dv<64>
                            : launch_f32_dv<32>;
    e = f(qp, kp, vp, op, bh, sq, sk, d, n_main * kWideSlice, 1, causal, scale_log2, st);
  }
  return e;
}

}  // namespace

// q [bh, sq, d], k and v [bh, sk, d], o [bh, sq, d], all contiguous, on the
// device, 16-byte aligned. is_bf16: 1 for bfloat16, 0 for float32. d is 32,
// 64 or 128, or above 128 a multiple of 64. The bf16 kernels take a split
// plan (ops/flash_attention.py::split_plan): items [n_items] int4 work items
// (in 64-row query tiles up to d = 128, 128-row tiles above) and combine
// [n_combine] int4 combine entries (in 64-row tiles) on the device; part_o
// [bh, n_slots, 64, d] and part_lse [bh, n_slots, 64] f32 scratch up to d =
// 128, part_o [bh, d / 64, 2 * n_slots, 64, 64] and part_lse [bh, d / 64,
// 2 * n_slots, 64] above; items null means no split. The f32 kernel takes
// none (null, 0). `scale` multiplies the scores: the caller passes
// 1/sqrt(head_dim) of the unpadded head, since a head narrower than d
// arrives zero-padded to d (last, so that a build before it, which ignores
// it, keeps its ABI). Launches on `stream` and returns cudaGetLastError()
// (0 when the launches were accepted).
extern "C" int dsst_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                        int bh, int sq, int sk, int d, int causal, int is_bf16,
                                        const void* items, int n_items, const void* combine,
                                        int n_combine, void* part_o, void* part_lse, int n_slots,
                                        void* stream, float scale) {
  const float scale_log2 = kLog2e * scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    if (d <= 0 || d % 32 || d == 96 || (d > 128 && d % 64))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_f32(q, k, v, o, bh, sq, sk, d, causal, scale_log2, st);
  }
  if (d > 128) {
    if (d % 64) return static_cast<int>(cudaErrorInvalidValue);
    return launch_bf16_wide(q, k, v, o, bh, sq, sk, d, causal, scale_log2, items, n_items,
                            combine, n_combine, part_o, part_lse, n_slots, st);
  }
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

// Dynamic shared memory of one CTA of the bf16 kernel at head_dim d (above
// 128: of its first slice's launch).
extern "C" int dsst_flash_attention_smem_bytes(int d) {
  if (d > 128) return d % 64 ? -1 : wide_layout(d, d > kWideSlice ? kWideSlice : d).bytes;
  return d == 32 ? Smem<32>::kBytes : d == 64 ? Smem<64>::kBytes : d == 128 ? Smem<128>::kBytes : -1;
}

// The wide kernel's layout at head_dim d and slice width dv: out = {Q
// resident, K slots, V stages, a whole tile's K held}; returns its shared
// memory bytes, or -1 when no layout fits.
extern "C" int dsst_flash_attention_wide_layout(int d, int dv, int* out) {
  const WideLayout lay = wide_layout(d, dv);
  out[0] = lay.q_res, out[1] = lay.rk, out[2] = lay.sv, out[3] = lay.hold;
  return lay.q_res < 0 ? -1 : lay.bytes;
}

// Dynamic shared memory of one CTA of the f32 kernel at head_dim d and
// slice width dv, and whether Q is resident (out[0]).
extern "C" int dsst_flash_attention_f32_smem_bytes(int d, int dv, int* out) {
  out[0] = f32_smem_bytes(d, dv, 1) <= kSmemOptin;
  return f32_smem_bytes(d, dv, out[0]);
}
