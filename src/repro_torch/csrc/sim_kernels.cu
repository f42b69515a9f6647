// Fused similarity kernels of the query engine, for Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels of the stratification pass:
//   K1  src/repro/kernels/sim_sweep/kernel.py  _kernel    (fp32 / bf16 sweep)
//   K2  src/repro/kernels/sim_sweep/kernel.py  _kernel_q  (int8 sweep)
//   K3  src/repro/kernels/sim_topk/kernel.py   _kernel    (per-row top-k)
//   K4  src/repro/kernels/sim_hist/kernel.py   _kernel    (weight histogram)
// All four are one template: a blocked score tile of E1 @ E2^T followed by
// up to three epilogues over it -- the weight histogram (count tiles), the
// running per-row top-k of the clipped score, and the compensated walk
// sums -- switched on at compile time.
//
// What bounds it on this card: operations.  One pass does 2*M*N*d
// multiply-adds on the CUDA cores (fp32 and bf16 inputs multiply in f32;
// int8 uses __dp4a with int32 accumulation) and reads only the two tables,
// so at the main-path shapes (32768 x 32768 x 384) it is about 8e11 FLOP
// against ~100 MB of input: three orders of magnitude above the ridge
// point.  The design keeps everything but the inputs out of device memory:
// the (BM x BN) score tile lives in registers, the histogram of a CTA in
// shared memory (int32, atomics), the running top-k lists in shared memory,
// and the (hi, lo) walk-sum pairs in registers.  This first version is a
// plain SIMT tile (64 x 64 per CTA, 4 x 4 per thread, no tensor cores, no
// TMA or pipelining): right and simple first, fast in a later change.
//
// What the TPU design did that does not carry over:
// * The TPU grid walks the column blocks in order and carries the running
//   top-k and sums in scratch between grid steps.  Here blocks run in no
//   order, so the loop over column blocks sits inside the CTA: each CTA owns
//   BM rows for the whole width, and the summation order is fixed from run
//   to run.
// * TPUs have no scatter-add, so the Pallas epilogue bins with one-hot
//   matmuls (kernels/binning.py).  Here each thread run-length encodes its
//   bins (most pairs land in the floor bin) and adds runs into a shared
//   int32 histogram with atomicAdd; the CTA then adds its histogram into the
//   global count tile of its row group.  Integer atomics keep the counts
//   deterministic.
// * Top-k: candidates that beat a row's current k-th entry are buffered in
//   shared memory and inserted into the row's sorted list by one warp (the
//   slot by counting the entries that beat the candidate, then a parallel
//   shift of the tail), so a wide list costs k / 32 steps a candidate.  The
//   order is (value descending, column ascending), a total order, so the
//   result does not depend on the order candidates arrive in, and ties go to
//   the lower column as in the reference.
// * Few rows, many columns: a top-k launch over few rows (the raised-k
//   retry runs on a handful of rows) would fill one CTA and leave the other
//   SMs idle.  Such a launch splits the columns across a second grid
//   dimension; each CTA keeps the exact top-k of its column range, and a
//   second kernel merges the per-range lists of a row (one warp a row).  The
//   top-k under a total order is unique, so the merged lists equal an
//   unsplit launch's bit for bit.
//
// Exactness: the fp32 score of a pair is one fmaf chain over k = 0..d-1 in
// order, whatever the tile or launch it is computed in, so the fp32 sweep is
// bit-identical to the two-pass (histogram, top-k) launches.  The walk sums
// use error-free two-sum steps written with __fadd_rn / __fsub_rn, which
// nvcc can neither contract nor reorder.  Never build with --use_fast_math.
//
// Interface: plain C, called through ctypes.  The wrapper allocates every
// output (count tiles zeroed), pads d to a multiple of 4 (fp32, bf16) or 16
// (int8) with zero columns, and passes PyTorch's current stream.  The
// function returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int BM = 64;      // rows of a CTA tile
constexpr int BN = 64;      // columns of a CTA tile
constexpr int NT = 256;     // threads of a CTA: 16 x 16, 4 x 4 pairs each
constexpr int LDF = 36;     // smem row stride of a 32-deep f32 tile (floats)
constexpr int LDI = 20;     // smem row stride of a 64-deep int8 tile (ints)
constexpr float NEG = -1e30f;

enum Mode { F32 = 0, BF16 = 1, I8 = 2 };
enum Flag { HIST = 1, TOPK = 2, SUMS = 4 };

struct Params {
  const void* e1;       // (M, d) row-major: float, bf16 or int8
  const void* e2;       // (N, d) row-major, same type
  const float* rs1;     // (M) int8 row scales
  const float* rs2;     // (N) int8 row scales
  const float* scale;   // (M) per-row weight scale (chain prefix weights)
  const float* v;       // (N) backward vector of the walk sums
  int M, N, d;
  int n_bins;
  float exponent, rs_exponent, floor_w;
  int pow1, rs_pow1;    // exponent == 1, rs_exponent == 1: skip powf
  int k;                // top-k width
  int bm;               // rows per count tile
  int split_cols;       // columns per CTA along grid y (a multiple of BN)
  int* block_counts;    // (ceil(M / bm), n_bins), zeroed by the caller
  float* vals;          // (M, gridDim.y, k): one list per column range
  int* idx;             // (M, gridDim.y, k)
  float* row_sums;      // (M)
};

__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  float bv = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bv)), __fsub_rn(b, bv));
}

// (value, column) ordering of the top-k lists: larger value first, then the
// lower column.
__device__ __forceinline__ bool beats(float x, int c, float y, int cy) {
  return x > y || (x == y && c < cy);
}

// ---- the score tile --------------------------------------------------------
// Loads one k-slice of the A (rows r0..) and B (cols c0..) tiles into shared
// memory, zero-filling rows past M / N and columns past d.

template <int MODE>
struct Tile;

template <>
struct Tile<F32> {
  static constexpr int BK = 32;
  using Acc = float;
  static __device__ __forceinline__ void load(const Params& p, const void* src,
                                              int rows, int r0, int k0,
                                              float* dst, int tid) {
    const float* g = static_cast<const float*>(src);
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      int e = tid + l * NT;
      int row = e >> 3, kq = (e & 7) << 2;
      int gr = r0 + row, gk = k0 + kq;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gr < rows && gk < p.d)
        val = *reinterpret_cast<const float4*>(g + (size_t)gr * p.d + gk);
      *reinterpret_cast<float4*>(dst + row * LDF + kq) = val;
    }
  }
  static __device__ __forceinline__ void mma(const float* As, const float* Bs,
                                             int ty, int tx, float acc[4][4]) {
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(As + (ty + 16 * i) * LDF + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(Bs + (tx + 16 * j) * LDF + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
        }
    }
  }
};

template <>
struct Tile<BF16> {
  static constexpr int BK = 32;
  using Acc = float;
  static __device__ __forceinline__ void load(const Params& p, const void* src,
                                              int rows, int r0, int k0,
                                              float* dst, int tid) {
    const __nv_bfloat16* g = static_cast<const __nv_bfloat16*>(src);
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      int e = tid + l * NT;
      int row = e >> 3, kq = (e & 7) << 2;
      int gr = r0 + row, gk = k0 + kq;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gr < rows && gk < p.d) {
        const __nv_bfloat162* h =
            reinterpret_cast<const __nv_bfloat162*>(g + (size_t)gr * p.d + gk);
        float2 lo = __bfloat1622float2(h[0]);
        float2 hi = __bfloat1622float2(h[1]);
        val = make_float4(lo.x, lo.y, hi.x, hi.y);
      }
      *reinterpret_cast<float4*>(dst + row * LDF + kq) = val;
    }
  }
  static __device__ __forceinline__ void mma(const float* As, const float* Bs,
                                             int ty, int tx, float acc[4][4]) {
    Tile<F32>::mma(As, Bs, ty, tx, acc);
  }
};

template <>
struct Tile<I8> {
  static constexpr int BK = 64;
  using Acc = int;
  static __device__ __forceinline__ void load(const Params& p, const void* src,
                                              int rows, int r0, int k0,
                                              float* dst, int tid) {
    const int8_t* g = static_cast<const int8_t*>(src);
    int* di = reinterpret_cast<int*>(dst);
    int row = tid >> 2, q = (tid & 3) << 4;  // 16 bytes a thread
    int gr = r0 + row, gk = k0 + q;
    int4 val = make_int4(0, 0, 0, 0);
    if (gr < rows && gk < p.d)
      val = *reinterpret_cast<const int4*>(g + (size_t)gr * p.d + gk);
    *reinterpret_cast<int4*>(di + row * LDI + (q >> 2)) = val;
  }
  static __device__ __forceinline__ void mma(const float* As, const float* Bs,
                                             int ty, int tx, int acc[4][4]) {
    const int* Ai = reinterpret_cast<const int*>(As);
    const int* Bi = reinterpret_cast<const int*>(Bs);
#pragma unroll
    for (int q = 0; q < BK / 4; q += 4) {
      int4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const int4*>(Ai + (ty + 16 * i) * LDI + q);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const int4*>(Bi + (tx + 16 * j) * LDI + q);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = __dp4a(a[i].x, b[j].x, acc[i][j]);
          acc[i][j] = __dp4a(a[i].y, b[j].y, acc[i][j]);
          acc[i][j] = __dp4a(a[i].z, b[j].z, acc[i][j]);
          acc[i][j] = __dp4a(a[i].w, b[j].w, acc[i][j]);
        }
    }
  }
};

// Shared-memory carve-up; the A/B tiles are reused for the final walk-sum
// reduction (BM x 16 (hi, lo) pairs).
__host__ __device__ inline size_t ab_bytes(int mode) {
  size_t tiles = (mode == I8 ? 2u * BM * LDI : 2u * BM * LDF) * 4u;
  size_t red = 2u * BM * 16u * 4u;
  return tiles > red ? tiles : red;
}

__host__ __device__ inline size_t smem_bytes(int mode, int flags, int n_bins,
                                             int k) {
  size_t b = ab_bytes(mode);
  if (flags & HIST) b += (size_t)n_bins * 4u;
  if (flags & TOPK) b += (size_t)BM * (k + 1) * 8u + (size_t)BM * BN * 8u + BM * 4u;
  return b;
}

template <int MODE, bool HIST_ON, bool TOPK_ON, bool SUMS_ON>
__global__ void __launch_bounds__(NT) sim_kernel(Params p) {
  using T = Tile<MODE>;
  using Acc = typename T::Acc;
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = As + (MODE == I8 ? BM * LDI : BM * LDF);
  unsigned char* cur = smem + ab_bytes(MODE);
  int* hist = reinterpret_cast<int*>(cur);
  if (HIST_ON) cur += (size_t)p.n_bins * 4u;
  const int KS = p.k + 1;  // top-k list stride (odd for k a power of two)
  float* lv = reinterpret_cast<float*>(cur);
  int* lc = reinterpret_cast<int*>(lv + BM * KS);
  float* cv = reinterpret_cast<float*>(lc + BM * KS);
  int* cc = reinterpret_cast<int*>(cv + BM * BN);
  int* cn = cc + BM * BN;

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int r0 = blockIdx.x * BM;
  const int c_begin = blockIdx.y * p.split_cols;
  const int c_end = min(p.N, c_begin + p.split_cols);

  if (HIST_ON)
    for (int b = tid; b < p.n_bins; b += NT) hist[b] = 0;
  if (TOPK_ON) {
    for (int e = tid; e < BM * KS; e += NT) {
      lv[e] = NEG;
      lc[e] = INT_MAX;
    }
    for (int e = tid; e < BM; e += NT) cn[e] = 0;
  }

  float row_scale[4], row_rs[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int r = r0 + ty + 16 * i;
    row_scale[i] = (HIST_ON && r < p.M) ? p.scale[r] : 0.f;
    row_rs[i] = (MODE == I8 && r < p.M) ? p.rs1[r] : 0.f;
  }
  float s_hi[4] = {0.f, 0.f, 0.f, 0.f};
  float s_lo[4] = {0.f, 0.f, 0.f, 0.f};
  int run_bin = -1, run_cnt = 0;
  __syncthreads();

  for (int c0 = c_begin; c0 < c_end; c0 += BN) {
    Acc acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = Acc(0);

    for (int k0 = 0; k0 < p.d; k0 += T::BK) {
      __syncthreads();
      T::load(p, p.e1, p.M, r0, k0, As, tid);
      T::load(p, p.e2, p.N, c0, k0, Bs, tid);
      __syncthreads();
      T::mma(As, Bs, ty, tx, acc);
    }

    float thr_v[4];
    int thr_c[4];
    if (TOPK_ON) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int rl = ty + 16 * i;
        thr_v[i] = lv[rl * KS + p.k - 1];
        thr_c[i] = lc[rl * KS + p.k - 1];
      }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int col = c0 + tx + 16 * j;
      if (col >= c_end) continue;
      float cv_j = SUMS_ON ? p.v[col] : 0.f;
      float crs = MODE == I8 ? p.rs2[col] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int rl = ty + 16 * i;
        if (r0 + rl >= p.M) continue;
        float s;
        if (MODE == I8)
          s = __fmul_rn(__fmul_rn(__int2float_rn((int)acc[i][j]), row_rs[i]), crs);
        else
          s = (float)acc[i][j];
        float sc = fminf(fmaxf(s, 0.f), 1.f);
        float base = fmaxf(sc, p.floor_w);
        if (HIST_ON) {
          float w = p.pow1 ? base : powf(base, p.exponent);
          w = __fmul_rn(w, row_scale[i]);
          float x = __fmul_rn(w, (float)p.n_bins);
          int b = (int)x;  // truncation, saturating
          b = b < 0 ? 0 : (b > p.n_bins - 1 ? p.n_bins - 1 : b);
          if (b == run_bin) {
            ++run_cnt;
          } else {
            if (run_cnt) atomicAdd(&hist[run_bin], run_cnt);
            run_bin = b;
            run_cnt = 1;
          }
        }
        if (SUMS_ON) {
          float wr = p.rs_pow1 ? base : powf(base, p.rs_exponent);
          wr = __fmul_rn(wr, cv_j);
          float t, e;
          two_sum(s_hi[i], wr, t, e);
          s_hi[i] = t;
          s_lo[i] = __fadd_rn(s_lo[i], e);
        }
        if (TOPK_ON && beats(sc, col, thr_v[i], thr_c[i])) {
          int slot = atomicAdd(&cn[rl], 1);
          cv[rl * BN + slot] = sc;
          cc[rl * BN + slot] = col;
        }
      }
    }

    if (TOPK_ON) {
      __syncthreads();
      // one warp a row: a candidate's slot is the number of list entries
      // that beat it; the entries from that slot on move down one place,
      // 32 at a time from the end of the list, and the candidate goes in
      const int warp = tid >> 5, lane = tid & 31;
      for (int rl = warp; rl < BM; rl += NT / 32) {
        float* V = lv + rl * KS;
        int* C = lc + rl * KS;
        int n = cn[rl];
        for (int t = 0; t < n; ++t) {
          float x = cv[rl * BN + t];
          int c = cc[rl * BN + t];
          int above = 0;
          for (int q = lane; q < p.k; q += 32) above += beats(V[q], C[q], x, c);
          int pos = __reduce_add_sync(0xffffffffu, above);
          if (pos >= p.k) continue;
          for (int b = ((p.k - 2) / 32) * 32; b >= 0; b -= 32) {
            int q = b + lane;
            bool move = q >= pos && q < p.k - 1;
            float mv = move ? V[q] : 0.f;
            int mc = move ? C[q] : 0;
            __syncwarp();
            if (move) {
              V[q + 1] = mv;
              C[q + 1] = mc;
            }
            __syncwarp();
          }
          if (lane == 0) {
            V[pos] = x;
            C[pos] = c;
          }
          __syncwarp();
        }
        if (lane == 0) cn[rl] = 0;
      }
      // the next block's threshold reads wait for the barrier at the top of
      // its k loop
    }
  }

  if (HIST_ON && run_cnt) atomicAdd(&hist[run_bin], run_cnt);
  __syncthreads();

  if (HIST_ON) {
    int* tile = p.block_counts + (size_t)(r0 / p.bm) * p.n_bins;
    for (int b = tid; b < p.n_bins; b += NT)
      if (hist[b]) atomicAdd(&tile[b], hist[b]);
  }

  if (TOPK_ON) {
    for (int e = tid; e < BM * p.k; e += NT) {
      int rl = e / p.k, t = e - rl * p.k;
      int r = r0 + rl;
      if (r < p.M) {
        size_t o = ((size_t)r * gridDim.y + blockIdx.y) * p.k + t;
        p.vals[o] = lv[rl * KS + t];
        p.idx[o] = lc[rl * KS + t];
      }
    }
  }

  if (SUMS_ON) {
    // fixed-order reduction of the 16 per-thread (hi, lo) pairs of a row
    float* red_hi = As;
    float* red_lo = As + BM * 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int rl = ty + 16 * i;
      red_hi[rl * 16 + tx] = s_hi[i];
      red_lo[rl * 16 + tx] = s_lo[i];
    }
    __syncthreads();
    for (int rl = tid; rl < BM; rl += NT) {
      float h = 0.f, l = 0.f;
      for (int t = 0; t < 16; ++t) {
        float s, e;
        two_sum(h, red_hi[rl * 16 + t], s, e);
        h = s;
        l = __fadd_rn(l, __fadd_rn(red_lo[rl * 16 + t], e));
      }
      if (r0 + rl < p.M) p.row_sums[r0 + rl] = __fadd_rn(h, l);
    }
  }
}

// (value, column, list) order of the merge: the list breaks the ties of
// empty slots, which all read (NEG, INT_MAX).
__device__ __forceinline__ bool beats3(float x, int c, int s, float y, int cy,
                                       int sy) {
  return x > y || (x == y && (c < cy || (c == cy && s < sy)));
}

constexpr int MERGE_J = 8;  // lists a lane holds: at most 32 * MERGE_J ranges

// Merges the S sorted per-range top-k lists of each row into its top-k.
// One warp a row; lane l holds the heads of lists l, l + 32, ...; each step
// takes the warp's best head under beats3 and advances that list.
__global__ void __launch_bounds__(128) topk_merge(const float* pv, const int* pc,
                                                  int M, int S, int k,
                                                  float* vals, int* idx) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const float* V = pv + (size_t)row * S * k;
  const int* C = pc + (size_t)row * S * k;
  float hv[MERGE_J];
  int hc[MERGE_J], hp[MERGE_J];
#pragma unroll
  for (int j = 0; j < MERGE_J; ++j) {
    int s = lane + 32 * j;
    hp[j] = 0;
    hv[j] = s < S ? V[(size_t)s * k] : NEG;
    hc[j] = s < S ? C[(size_t)s * k] : INT_MAX;
  }
  for (int t = 0; t < k; ++t) {
    float bv = hv[0];
    int bc = hc[0], bs = lane;
#pragma unroll
    for (int j = 1; j < MERGE_J; ++j)
      if (beats3(hv[j], hc[j], lane + 32 * j, bv, bc, bs)) {
        bv = hv[j];
        bc = hc[j];
        bs = lane + 32 * j;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      int oc = __shfl_xor_sync(0xffffffffu, bc, off);
      int os = __shfl_xor_sync(0xffffffffu, bs, off);
      if (beats3(ov, oc, os, bv, bc, bs)) {
        bv = ov;
        bc = oc;
        bs = os;
      }
    }
    if (lane == 0) {
      vals[(size_t)row * k + t] = bv;
      idx[(size_t)row * k + t] = bc;
    }
    if ((bs & 31) == lane) {
#pragma unroll
      for (int j = 0; j < MERGE_J; ++j)
        if (j == (bs >> 5)) {
          int q = ++hp[j];
          hv[j] = q < k ? V[(size_t)bs * k + q] : NEG;
          hc[j] = q < k ? C[(size_t)bs * k + q] : INT_MAX;
        }
    }
  }
}

template <int MODE, bool H, bool K, bool S>
cudaError_t launch(const Params& p, int splits, cudaStream_t stream) {
  size_t bytes = smem_bytes(MODE, (H ? HIST : 0) | (K ? TOPK : 0) | (S ? SUMS : 0),
                            p.n_bins, p.k);
  auto fn = sim_kernel<MODE, H, K, S>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((p.M + BM - 1) / BM, splits);
  fn<<<grid, NT, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory a launch of (mode, flags) needs, in bytes.
size_t repro_sim_smem_bytes(int mode, int flags, int n_bins, int k) {
  return smem_bytes(mode, flags, n_bins, k);
}

// One launch.  mode: 0 fp32, 1 bf16, 2 int8.  flags: 1 histogram, 2 top-k,
// 4 walk sums.  Supported: sweep (7) for every mode, histogram (1) and top-k
// (2) for fp32.  A top-k launch with splits > 1 splits the columns into that
// many ranges of whole BN-column tiles (splits must be the number of ranges
// ceil(N / BN / splits) tiles each make), writes the per-range lists to
// part_vals / part_idx (M, splits, k), and merges them into vals / idx.
// Returns a cudaError_t (0 on success; cudaErrorInvalidValue for an
// unsupported combination or bad arguments).
int repro_sim_launch(int mode, int flags, const void* e1, const void* e2,
                     const float* rs1, const float* rs2, const float* scale,
                     const float* v, int M, int N, int d, int n_bins,
                     float exponent, float rs_exponent, float floor_w, int k,
                     int bm, int splits, float* part_vals, int* part_idx,
                     int* block_counts, float* vals, int* idx,
                     float* row_sums, void* stream) {
  Params p;
  p.e1 = e1; p.e2 = e2; p.rs1 = rs1; p.rs2 = rs2; p.scale = scale; p.v = v;
  p.M = M; p.N = N; p.d = d; p.n_bins = n_bins;
  p.exponent = exponent; p.rs_exponent = rs_exponent; p.floor_w = floor_w;
  p.pow1 = exponent == 1.0f; p.rs_pow1 = rs_exponent == 1.0f;
  p.k = k; p.bm = bm;
  p.block_counts = block_counts; p.vals = vals; p.idx = idx;
  p.row_sums = row_sums;
  if (M <= 0 || N <= 0 || d <= 0 || bm <= 0) return (int)cudaErrorInvalidValue;
  if ((flags & TOPK) && (k < 1 || k > N || k > 1024)) return (int)cudaErrorInvalidValue;
  if ((flags & HIST) && n_bins < 1) return (int)cudaErrorInvalidValue;
  if (splits < 1 || splits > 32 * MERGE_J) return (int)cudaErrorInvalidValue;
  const int tiles = (N + BN - 1) / BN;
  const int per = (tiles + splits - 1) / splits;
  if ((tiles + per - 1) / per != splits) return (int)cudaErrorInvalidValue;
  if (splits > 1 && (flags != TOPK || !part_vals || !part_idx))
    return (int)cudaErrorInvalidValue;
  p.split_cols = per * BN;
  if (splits > 1) {
    p.vals = part_vals;
    p.idx = part_idx;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (flags == (HIST | TOPK | SUMS)) {
    if (mode == F32) err = launch<F32, true, true, true>(p, 1, s);
    else if (mode == BF16) err = launch<BF16, true, true, true>(p, 1, s);
    else if (mode == I8) err = launch<I8, true, true, true>(p, 1, s);
    else return (int)cudaErrorInvalidValue;
  } else if (flags == HIST && mode == F32) {
    err = launch<F32, true, false, false>(p, 1, s);
  } else if (flags == TOPK && mode == F32) {
    err = launch<F32, false, true, false>(p, splits, s);
    if (err == cudaSuccess && splits > 1) {
      topk_merge<<<(M + 3) / 4, 128, 0, s>>>(part_vals, part_idx, M, splits, k,
                                             vals, idx);
      err = cudaGetLastError();
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // extern "C"
