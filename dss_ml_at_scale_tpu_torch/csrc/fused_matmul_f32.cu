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
// Bound. JAX's f32 tests hold these to 1e-5, which one-pass TF32 (about
// three decimal digits) cannot meet, so the products run in full f32 on the
// CUDA cores: 67 TFLOP/s on an H100 SXM. Every ResNet-50 bottleneck site does
// M*K*N = 1.09e10 multiply-adds at batch 212, so each launch is bound by
// operations at 0.325 ms at all four stages (its bytes, each input read and
// each output written once in f32, take 0.03-0.31 ms at 3.35 TB/s).
//
// Design: a register-blocked FFMA product. A CTA of 256 threads computes a
// 128 x 128 tile of its result (128 x 64 where the result has 64 channels:
// K2f's gt and K3f's dW at stage 1, which would leave half a 128-wide tile
// idle), each thread an 8 x 8 (or 8 x 4 / 4 x 8) block of it in registers,
// summing the reduction in slabs of 8 that are staged into shared memory,
// double buffered: each thread loads the next slab's float4 of each operand
// from device memory into registers while the CTA multiplies the current
// one, and stores it after, with one barrier per slab. An operand whose
// reduction index is contiguous in memory is transposed on that store, so
// every inner step reads its fragments as float4 from shared memory (two
// addresses per warp for A, a broadcast; sixteen neighbouring float4 for B).
// K1f and K3f apply the BN prologue to y's float4 in registers on its way
// to shared memory, so the normalized activation never reaches device
// memory; K2f recomputes the ReLU mask in its epilogue. Each prologue rounds
// after every operation (no fused multiply-add), as the plain version's
// separate torch ops do, so a and the mask equal the plain version's bit for
// bit. The ragged M edge is masked in the kernel (rows past M load as zero
// and are not stored); K and N must be multiples of 4 (16-byte rows), which
// the wrapper's zero padding guarantees.
//   K1f: one CTA per 128 x 128 tile of out, M first within a band of N.
//   K2f: a persistent walk, as the bf16 K2's: CTA c takes tiles c, c + grid,
//        ... (the channel bands of an M band first), and carries the two
//        channel sums across its walk in its own [2K] row of f32 partials;
//        a second pass adds the rows in a fixed order. The TPU kernel carries
//        the sums across its sequential grid, which no Hopper block can.
//   K3f: a reduction over M (664,832 rows at stage 1 against two output
//        tiles), so M is split into runs over CTAs that fill the SMs, each
//        summing its run into a [splits, K, N] f32 scratch that the same
//        fixed-order pass adds.
// No atomics anywhere: the sums, and so the gradients, are the same from run
// to run.

#include <climits>

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kBK = 8;         // reduction depth of one slab
constexpr int kPad = 4;        // floats past each row of a staged slab

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

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

// One operand of the product, staged slab by slab. E is its extent along
// the result (rows of the tile for A, columns for B); a slab is kBK x E,
// kept in shared memory as [kBK][E + kPad]. RED_CONTIG: the source is
// [E-index][reduction] row-major (the reduction index contiguous: the
// float4 is transposed on its store); otherwise [reduction][E-index]. BNPRO
// applies relu(y*s + t [+ res]) to the source y, per channel (the
// reduction index of a RED_CONTIG operand, else the E index).
template <int E, bool RED_CONTIG, bool BNPRO, bool RES>
struct Operand {
  static constexpr int kVecs = E * kBK / 4;  // float4 per slab: at most one per thread
  static_assert(kVecs <= kThreads, "a slab is one float4 per thread at most");

  const float* src;
  const float* res;
  const float* s;
  const float* t;
  int ld;     // the source's row length
  int e0;     // first E index of the tile
  int e_end;  // E indices at or past this are zero
  int r_end;  // reduction indices at or past this are zero
  float4 v;

  __device__ __forceinline__ void coords(int& e, int& r) const {
    const int i = threadIdx.x;
    if (RED_CONTIG) {
      e = i / (kBK / 4);
      r = (i % (kBK / 4)) * 4;
    } else {
      r = i / (E / 4);
      e = (i % (E / 4)) * 4;
    }
  }

  __device__ __forceinline__ void load(int r0) {
    if (threadIdx.x >= kVecs) return;
    int e, r;
    coords(e, r);
    const int ge = e0 + e, gr = r0 + r;
    v = make_float4(0.f, 0.f, 0.f, 0.f);
    // Whole float4 in or out: the contiguous extent is a multiple of 4.
    if (ge >= e_end || gr >= r_end) return;
    const size_t off = RED_CONTIG ? static_cast<size_t>(ge) * ld + gr
                                  : static_cast<size_t>(gr) * ld + ge;
    v = ldg4(src + off);
    if (BNPRO) {
      const int ch = RED_CONTIG ? gr : ge;
      float4 z = bn_z(v, ldg4(s + ch), ldg4(t + ch));
      if (RES) z = add4(z, ldg4(res + off));
      v = make_float4(fmaxf(z.x, 0.f), fmaxf(z.y, 0.f), fmaxf(z.z, 0.f), fmaxf(z.w, 0.f));
    }
  }

  __device__ __forceinline__ void store(float* sm) const {
    if (threadIdx.x >= kVecs) return;
    int e, r;
    coords(e, r);
    if (RED_CONTIG) {
      sm[(r + 0) * (E + kPad) + e] = v.x;
      sm[(r + 1) * (E + kPad) + e] = v.y;
      sm[(r + 2) * (E + kPad) + e] = v.z;
      sm[(r + 3) * (E + kPad) + e] = v.w;
    } else {
      *reinterpret_cast<float4*>(sm + r * (E + kPad) + e) = v;
    }
  }
};

// Thread (tx, ty) = (t % 16, t / 16) holds rows h * BM/2 + 4 ty + i of the
// tile (h < BM/64, i < 4) and columns h * BN/2 + 4 tx + j: two (or one)
// float4 of each fragment per inner step.
__device__ __forceinline__ int tile_row(int i, int bm) {
  return (i / 4) * (bm / 2) + (threadIdx.x / 16) * 4 + i % 4;
}

__device__ __forceinline__ int tile_col(int j, int bn) {
  return (j / 4) * (bn / 2) + (threadIdx.x % 16) * 4 + j % 4;
}

// acc += A[rows, r_begin:r_end] @ B[r_begin:r_end, cols], slab by slab.
template <int BM, int BN, class OA, class OB>
__device__ __forceinline__ void product(OA& oa, OB& ob, float (*as)[kBK * (BM + kPad)],
                                        float (*bs)[kBK * (BN + kPad)], int r_begin,
                                        int r_end, float (&acc)[BM / 16][BN / 16]) {
  constexpr int TM = BM / 16, TN = BN / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int slabs = (r_end - r_begin + kBK - 1) / kBK;
  oa.load(r_begin);
  ob.load(r_begin);
  oa.store(as[0]);
  ob.store(bs[0]);
  __syncthreads();
  for (int sl = 0; sl < slabs; ++sl) {
    const int cur = sl & 1;
    const bool more = sl + 1 < slabs;
    if (more) {
      oa.load(r_begin + (sl + 1) * kBK);
      ob.load(r_begin + (sl + 1) * kBK);
    }
    const float* a_s = as[cur];
    const float* b_s = bs[cur];
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int h = 0; h < TM / 4; ++h) {
        const float4 x = *reinterpret_cast<const float4*>(a_s + k * (BM + kPad) + h * (BM / 2) + ty * 4);
        a[4 * h] = x.x, a[4 * h + 1] = x.y, a[4 * h + 2] = x.z, a[4 * h + 3] = x.w;
      }
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        const float4 x = *reinterpret_cast<const float4*>(b_s + k * (BN + kPad) + h * (BN / 2) + tx * 4);
        b[4 * h] = x.x, b[4 * h + 1] = x.y, b[4 * h + 2] = x.z, b[4 * h + 3] = x.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {
      oa.store(as[cur ^ 1]);
      ob.store(bs[cur ^ 1]);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K1f: out = relu(y*s + t [+ res]) @ W.  y, res [M,K]; W [K,N]; out [M,N].
// One CTA per 128 x 128 tile of out; tile i is row tile i % tiles_m of column
// band i / tiles_m (M first within a band of N, so W's band stays in L2).
// ---------------------------------------------------------------------------
template <bool RES>
__global__ void __launch_bounds__(kThreads, 2)
fwd_f32_kernel(const float* __restrict__ y, const float* __restrict__ res,
               const float* __restrict__ s, const float* __restrict__ t,
               const float* __restrict__ w, float* __restrict__ out, int M, int K, int N,
               int tiles_m) {
  __shared__ __align__(16) float as[2][kBK * (128 + kPad)];
  __shared__ __align__(16) float bs[2][kBK * (128 + kPad)];
  const int m0 = (blockIdx.x % tiles_m) * 128, n0 = (blockIdx.x / tiles_m) * 128;
  Operand<128, true, true, RES> oa{y, res, s, t, K, m0, M, K};
  Operand<128, false, false, false> ob{w, nullptr, nullptr, nullptr, N, n0, N, K};
  float acc[8][8] = {};
  product<128, 128>(oa, ob, as, bs, 0, K, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + tile_row(i, 128);
    if (row >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + tile_col(4 * h, 128);
      if (col < N)
        *reinterpret_cast<float4*>(out + static_cast<size_t>(row) * N + col) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// K2f: gt = (g @ W^T) * [y*s + t (+ res) > 0] and the channel sums.
// g [M,N]; W [K,N]; y, res, gt [M,K]; partial [gridDim.x, 2K].
// Persistent: CTA c walks tiles c, c + grid, ... of 128 x BN; tile i is
// channel band i % tiles_k of row tile i / tiles_k. Each tile's column sums
// (each thread its 8 rows, then the 16 row groups in order) are added to the
// CTA's own partial row, always by the same thread for the same channel.
// ---------------------------------------------------------------------------
template <int BN, bool RES>
__global__ void __launch_bounds__(kThreads, 2)
bwd_da_f32_kernel(const float* __restrict__ g, const float* __restrict__ w,
                  const float* __restrict__ y, const float* __restrict__ res,
                  const float* __restrict__ s, const float* __restrict__ t,
                  const float* __restrict__ mean, const float* __restrict__ inv,
                  float* __restrict__ gt, float* __restrict__ partial, int M, int K, int N) {
  constexpr int TN = BN / 16;
  __shared__ __align__(16) float as[2][kBK * (128 + kPad)];
  __shared__ __align__(16) float bs[2][kBK * (BN + kPad)];
  __shared__ float red[2][16][BN];
  const int ty = threadIdx.x / 16;
  const int tiles_k = (K + BN - 1) / BN;
  const int tiles = (M + 127) / 128 * tiles_k;
  float* prow = partial + static_cast<size_t>(blockIdx.x) * 2 * K;
  for (int c = threadIdx.x; c < 2 * K; c += kThreads) prow[c] = 0.f;
  __syncthreads();
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / tiles_k) * 128, k0 = (tile % tiles_k) * BN;
    Operand<128, true, false, false> oa{g, nullptr, nullptr, nullptr, N, m0, M, N};
    Operand<BN, true, false, false> ob{w, nullptr, nullptr, nullptr, N, k0, K, N};
    float acc[8][TN] = {};
    product<128, BN>(oa, ob, as, bs, 0, N, acc);
    float sum_g[TN] = {}, sum_gx[TN] = {};
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int col = k0 + tile_col(4 * h, BN);
      if (col >= K) continue;
      const float4 s4 = ldg4(s + col), t4 = ldg4(t + col);
      const float4 m4 = ldg4(mean + col), i4 = ldg4(inv + col);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = m0 + tile_row(i, 128);
        if (row >= M) continue;
        const size_t off = static_cast<size_t>(row) * K + col;
        const float4 y4 = ldg4(y + off);
        float4 z = bn_z(y4, s4, t4);
        if (RES) z = add4(z, ldg4(res + off));
        const float4 o = make_float4(z.x > 0.f ? acc[i][4 * h] : 0.f,
                                     z.y > 0.f ? acc[i][4 * h + 1] : 0.f,
                                     z.z > 0.f ? acc[i][4 * h + 2] : 0.f,
                                     z.w > 0.f ? acc[i][4 * h + 3] : 0.f);
        *reinterpret_cast<float4*>(gt + off) = o;
        sum_g[4 * h] += o.x, sum_g[4 * h + 1] += o.y;
        sum_g[4 * h + 2] += o.z, sum_g[4 * h + 3] += o.w;
        sum_gx[4 * h] = fmaf(o.x, __fmul_rn(__fsub_rn(y4.x, m4.x), i4.x), sum_gx[4 * h]);
        sum_gx[4 * h + 1] = fmaf(o.y, __fmul_rn(__fsub_rn(y4.y, m4.y), i4.y), sum_gx[4 * h + 1]);
        sum_gx[4 * h + 2] = fmaf(o.z, __fmul_rn(__fsub_rn(y4.z, m4.z), i4.z), sum_gx[4 * h + 2]);
        sum_gx[4 * h + 3] = fmaf(o.w, __fmul_rn(__fsub_rn(y4.w, m4.w), i4.w), sum_gx[4 * h + 3]);
      }
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      red[0][ty][tile_col(j, BN)] = sum_g[j];
      red[1][ty][tile_col(j, BN)] = sum_gx[j];
    }
    __syncthreads();
    if (threadIdx.x < BN && k0 + threadIdx.x < K) {
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        a += red[0][r][threadIdx.x];
        b += red[1][r][threadIdx.x];
      }
      prow[k0 + threadIdx.x] += a;
      prow[K + k0 + threadIdx.x] += b;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K3f: dW = relu(y*s + t [+ res])^T @ g over a run of M.
// y, res [M,K]; g [M,N]; partial [splits, K, N]. CTA b computes tile
// b % tiles (channel band tile % tiles_k of column band tile / tiles_k, BM x
// 128) over rows [split * chunk, min(M, (split + 1) * chunk)), split =
// b / tiles, into partial[split].
// ---------------------------------------------------------------------------
template <int BM, bool RES>
__global__ void __launch_bounds__(kThreads, 2)
bwd_dw_f32_kernel(const float* __restrict__ y, const float* __restrict__ res,
                  const float* __restrict__ s, const float* __restrict__ t,
                  const float* __restrict__ g, float* __restrict__ partial, int M, int K, int N,
                  int chunk, int tiles_k, int tiles) {
  constexpr int TM = BM / 16;
  __shared__ __align__(16) float as[2][kBK * (BM + kPad)];
  __shared__ __align__(16) float bs[2][kBK * (128 + kPad)];
  const int tile = blockIdx.x % tiles, split = blockIdx.x / tiles;
  const int k0 = (tile % tiles_k) * BM, n0 = (tile / tiles_k) * 128;
  const int r_begin = split * chunk;
  const int r_end = min(M, r_begin + chunk);
  Operand<BM, false, true, RES> oa{y, res, s, t, K, k0, K, r_end};
  Operand<128, false, false, false> ob{g, nullptr, nullptr, nullptr, N, n0, N, r_end};
  float acc[TM][8] = {};
  product<BM, 128>(oa, ob, as, bs, r_begin, r_end, acc);
  float* slab = partial + static_cast<size_t>(split) * K * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = k0 + tile_row(i, BM);
    if (row >= K) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + tile_col(4 * h, 128);
      if (col < N)
        *reinterpret_cast<float4*>(slab + static_cast<size_t>(row) * N + col) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
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

}  // namespace

// All pointers are device pointers to contiguous f32, 16-byte aligned; s, t,
// mean, inv are [K]. res may be null (the variant without a residual). K and
// N are multiples of 4. Each function launches on `stream` and returns
// cudaGetLastError() after its launches (0 when they were accepted).

// K1f. out [M,N]; one CTA per 128 x 128 tile.
extern "C" int dsst_bn_relu_matmul_fwd_f32(const void* y, const void* res, const void* s,
                                           const void* t, const void* w, void* out, int M, int K,
                                           int N, void* stream) {
  if (bad_shape(M, K, N)) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles_m = (M + 127LL) / 128;
  const long long tiles = tiles_m * ((N + 127LL) / 128);
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel = res != nullptr ? fwd_f32_kernel<true> : fwd_f32_kernel<false>;
  kernel<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
      static_cast<const float*>(y), static_cast<const float*>(res), static_cast<const float*>(s),
      static_cast<const float*>(t), static_cast<const float*>(w), static_cast<float*>(out), M, K,
      N, static_cast<int>(tiles_m));
  return static_cast<int>(cudaGetLastError());
}

// K2f. gt [M,K]; bn the tile width, 64 or 128 (the wrapper's da_tile_n);
// grid CTAs walk the tiles (the wrapper's choice, at most one per tile);
// partial [grid, 2K] f32 scratch, one row per CTA; sums [2K] (sum_g, then
// sum_gx).
extern "C" int dsst_bn_relu_matmul_bwd_da_f32(const void* g, const void* w, const void* y,
                                              const void* res, const void* s, const void* t,
                                              const void* mean, const void* inv, void* gt,
                                              void* partial, void* sums, int M, int K, int N,
                                              int bn, int grid, void* stream) {
  if (bad_shape(M, K, N) || (bn != 64 && bn != 128) || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool with_res = res != nullptr;
  decltype(&bwd_da_f32_kernel<64, false>) kernel;
  switch ((bn == 128) * 2 + with_res) {
    case 0: kernel = bwd_da_f32_kernel<64, false>; break;
    case 1: kernel = bwd_da_f32_kernel<64, true>; break;
    case 2: kernel = bwd_da_f32_kernel<128, false>; break;
    default: kernel = bwd_da_f32_kernel<128, true>; break;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* pp = static_cast<float*>(partial);
  kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(g), static_cast<const float*>(w), static_cast<const float*>(y),
      static_cast<const float*>(res), static_cast<const float*>(s), static_cast<const float*>(t),
      static_cast<const float*>(mean), static_cast<const float*>(inv), static_cast<float*>(gt), pp,
      M, K, N);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  return sum_rows(pp, static_cast<float*>(sums), grid, 2LL * K, st);
}

// K3f. tile_k the output tile's channels, 64 or 128 (the wrapper's
// dw_tile_k); partial [splits, K, N] f32 scratch, chunk rows of M per split
// (splits = ceil(M / chunk)), one CTA per output tile and split; dw [K,N].
extern "C" int dsst_bn_relu_matmul_bwd_dw_f32(const void* y, const void* res, const void* s,
                                              const void* t, const void* g, void* partial,
                                              void* dw, int M, int K, int N, int tile_k,
                                              int splits, int chunk, void* stream) {
  if (bad_shape(M, K, N) || (tile_k != 64 && tile_k != 128) || splits < 1 || chunk < 1 ||
      static_cast<long long>(splits - 1) * chunk >= M)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_k = (K + tile_k - 1) / tile_k;
  const long long tiles = static_cast<long long>(tiles_k) * ((N + 127) / 128);
  const long long grid = tiles * splits;
  if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const bool with_res = res != nullptr;
  decltype(&bwd_dw_f32_kernel<64, false>) kernel;
  switch ((tile_k == 128) * 2 + with_res) {
    case 0: kernel = bwd_dw_f32_kernel<64, false>; break;
    case 1: kernel = bwd_dw_f32_kernel<64, true>; break;
    case 2: kernel = bwd_dw_f32_kernel<128, false>; break;
    default: kernel = bwd_dw_f32_kernel<128, true>; break;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* pp = static_cast<float*>(partial);
  kernel<<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
      static_cast<const float*>(y), static_cast<const float*>(res), static_cast<const float*>(s),
      static_cast<const float*>(t), static_cast<const float*>(g), pp, M, K, N, chunk, tiles_k,
      static_cast<int>(tiles));
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  return sum_rows(pp, static_cast<float*>(dw), splits, static_cast<long long>(K) * N, st);
}
