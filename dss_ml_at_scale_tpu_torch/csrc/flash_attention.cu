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
// GPU run in no order, so here one CTA owns one (b*h, 64-row query tile) and
// walks the key tiles in a loop, with the running statistics in registers.
// Four warps each own 16 query rows. Q·Kᵀ and P·V run on the tensor cores as
// mma.sync m16n8k16 (bf16 in, f32 accumulate); the S accumulator's register
// layout is the A-operand layout of the P·V product, so P never leaves
// registers. K and V tiles (64 x d bf16, rows padded by 16 bytes so the
// fragment loads are free of bank conflicts) sit in static shared memory;
// Q is staged through the K buffer once and then kept as fragments.
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
// operations above: the serving buckets (128..1024) are byte-bound. The
// design keeps S and P out of device memory, so it reads each input once
// per query tile and writes o once; it does nothing yet to hide the tile
// loads (no cp.async or TMA pipelining) or to reach the wgmma rate. Those
// are later work.
//
// A float32 path (one warp per query row, FMA on the CUDA cores) keeps the
// f32 contract of the JAX function. No path of the port takes it yet;
// chip_smoke.py holds it to the f32 tolerance and times it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;  // query rows per CTA, 16 per warp
constexpr int kBlockN = 64;  // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;  // finite "minus infinity", as in the JAX kernel
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [row0, row0 + 64) of a [rows, D] slab into shared memory with
// row stride D + 8, zero-filling rows at or past n_rows.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int row0, int n_rows) {
  constexpr int kVec = D / 8;  // 16-byte vectors per row
  constexpr int kLd = D + 8;
  for (int i = threadIdx.x; i < kBlockN * kVec; i += kThreads) {
    const int r = i / kVec;
    const int c = (i % kVec) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows) {
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      int sq, int sk, int causal, float scale_log2) {
  constexpr int kLd = D + 8;
  constexpr int kSteps = D / 16;     // k-steps of Q·Kᵀ over head_dim
  constexpr int kTilesS = kBlockN / 8;  // 8-key column tiles of S
  constexpr int kTilesO = D / 8;     // 8-wide column tiles of O
  __shared__ __align__(16) __nv_bfloat16 Ks[kBlockN * kLd];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBlockN * kLd];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread within the group
  const __nv_bfloat16* qb = q + static_cast<size_t>(bh) * sq * D;
  const __nv_bfloat16* kb = k + static_cast<size_t>(bh) * sk * D;
  const __nv_bfloat16* vb = v + static_cast<size_t>(bh) * sk * D;
  const int offset = sk - sq;  // bottom-right causal alignment
  const int r_lo = warp * 16 + g;  // this thread's first tile row; the second is +8
  const int rows[2] = {q0 + r_lo, q0 + r_lo + 8};

  // Q fragments (A operand, row-major 16x16 per k-step), staged through Ks.
  load_tile<D>(Ks, qb, q0, sq);
  __syncthreads();
  uint32_t qf[kSteps][4];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    const int c = ks * 16 + t * 2;
    qf[ks][0] = ld32(&Ks[r_lo * kLd + c]);
    qf[ks][1] = ld32(&Ks[(r_lo + 8) * kLd + c]);
    qf[ks][2] = ld32(&Ks[r_lo * kLd + c + 8]);
    qf[ks][3] = ld32(&Ks[(r_lo + 8) * kLd + c + 8]);
  }
  __syncthreads();

  float acc[kTilesO][4];
#pragma unroll
  for (int dn = 0; dn < kTilesO; ++dn) {
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  }
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums, reduced at the end

  int n_tiles = (sk + kBlockN - 1) / kBlockN;
  if (causal) {
    // Key tiles past the last visible key of this query tile contribute
    // nothing; skip them (the TPU kernel's pl.when(live)).
    const int last_row = min(q0 + kBlockM, sq) - 1;
    n_tiles = min(n_tiles, (last_row + offset) / kBlockN + 1);
  }
  const uint16_t* vh = reinterpret_cast<const uint16_t*>(Vs);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockN;
    load_tile<D>(Ks, kb, k0, sk);
    load_tile<D>(Vs, vb, k0, sk);
    __syncthreads();

    // S = Q·Kᵀ for this warp's 16 rows x 64 keys.
    float s[kTilesS][4];
#pragma unroll
    for (int nt = 0; nt < kTilesS; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        const __nv_bfloat16* kp = &Ks[(nt * 8 + g) * kLd + ks * 16 + t * 2];
        mma_16816(s[nt], qf[ks], ld32(kp), ld32(kp + 8));
      }
    }

    // Scale into the log2 domain, mask, and take the row maxima.
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kTilesS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + t * 2 + (e & 1);
        const bool live = key < sk && (!causal || key <= rows[e >> 1] + offset);
        const float x = live ? s[nt][e] * scale_log2 : kNegInf;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
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
    for (int nt = 0; nt < kTilesS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
    for (int dn = 0; dn < kTilesO; ++dn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dn][e] *= alpha[e >> 1];
    }

    // O += P·V: the S accumulators of key columns [16kk, 16kk+16) are the
    // A fragment of one k-step; V (row-major [key, d]) is the col-major B.
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
      const int kr = kk * 16 + t * 2;
#pragma unroll
      for (int dn = 0; dn < kTilesO; ++dn) {
        const int col = dn * 8 + g;
        const uint32_t b0 = static_cast<uint32_t>(vh[kr * kLd + col]) |
                            (static_cast<uint32_t>(vh[(kr + 1) * kLd + col]) << 16);
        const uint32_t b1 = static_cast<uint32_t>(vh[(kr + 8) * kLd + col]) |
                            (static_cast<uint32_t>(vh[(kr + 9) * kLd + col]) << 16);
        mma_16816(acc[dn], pa, b0, b1);
      }
    }
    __syncthreads();  // before the next tile overwrites Ks/Vs
  }

  // Finish: full row sums across the 4 threads of a group, normalise, store.
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / l[i];  // never 0: every row sees at least key 0
  }
#pragma unroll
  for (int dn = 0; dn < kTilesO; ++dn) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = rows[half];
      if (row < sq) {
        const int col = dn * 8 + t * 2;
        *reinterpret_cast<uint32_t*>(o + (static_cast<size_t>(bh) * sq + row) * D + col) =
            pack_bf16(acc[dn][2 * half] * inv[half], acc[dn][2 * half + 1] * inv[half]);
      }
    }
  }
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
// device, 16-byte aligned. is_bf16: 1 for bfloat16, 0 for float32. Launches on
// `stream` and returns cudaGetLastError() (0 when the launch was accepted).
extern "C" int dsst_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                        int bh, int sq, int sk, int d, int causal,
                                        int is_bf16, void* stream) {
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(d));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const dim3 grid((sq + kBlockM - 1) / kBlockM, bh);
    const auto* qp = static_cast<const __nv_bfloat16*>(q);
    const auto* kp = static_cast<const __nv_bfloat16*>(k);
    const auto* vp = static_cast<const __nv_bfloat16*>(v);
    auto* op = static_cast<__nv_bfloat16*>(o);
    if (d == 64) {
      flash_fwd_bf16_kernel<64><<<grid, kThreads, 0, st>>>(qp, kp, vp, op, sq, sk, causal, scale_log2);
    } else if (d == 128) {
      flash_fwd_bf16_kernel<128><<<grid, kThreads, 0, st>>>(qp, kp, vp, op, sq, sk, causal, scale_log2);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    const dim3 grid((sq + kWarps - 1) / kWarps, bh);
    const auto* qp = static_cast<const float*>(q);
    const auto* kp = static_cast<const float*>(k);
    const auto* vp = static_cast<const float*>(v);
    auto* op = static_cast<float*>(o);
    if (d == 64) {
      flash_fwd_f32_kernel<64><<<grid, kThreads, 0, st>>>(qp, kp, vp, op, sq, sk, causal, scale_log2);
    } else if (d == 128) {
      flash_fwd_f32_kernel<128><<<grid, kThreads, 0, st>>>(qp, kp, vp, op, sq, sk, causal, scale_log2);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
