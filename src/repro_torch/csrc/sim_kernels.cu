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
// multiply-adds (fp32 on the CUDA cores: the fp32 path may not use TF32;
// bf16 on the tensor cores, bf16 x bf16 -> f32; int8 on the tensor cores,
// s8 x s8 -> s32) and reads only the two tables, so at the main-path shapes
// (32768 x 32768 x 384) it is about 8e11 FLOP against ~100 MB of input:
// three orders of magnitude above the ridge point.  The design keeps
// everything but the inputs out of device memory: the score tile lives in
// registers and then in shared memory, and the histogram (int32, atomics),
// the running top-k lists and the (hi, lo) walk-sum pairs of a CTA's rows
// in shared memory.
//
// The product.  A CTA owns a square tile of BM = BN = 128 rows and columns,
// or 64 where the count tiles are not a multiple of 128 rows.  The k-slices
// (128 bytes of a row: 32 f32, 64 bf16 or 128 int8) stream through a 2-stage
// cp.async ring, rows 144 bytes apart, with one barrier of the product
// warps per slice, over the flat sequence (column tile, k-slice), so the
// next slice's loads -- across column tiles too -- overlap this slice's
// arithmetic.
//   fp32 (SIMT, and bit for bit equal to the two-pass kernels): 256
//   product threads (16 x 16; a warp is 4 x 8 of them) own rows ty + 16 i
//   and columns tx + 16 j each, an 8 x 8 block of scores (4 x 4 in the 64
//   tile).  Each 4-deep step a thread reads 8 A and 8 B float4 from shared
//   memory for 256 FMAs; a warp's A reads are broadcasts of 4 rows and its B
//   reads 8 rows 144 bytes apart, one wavefront each.
//   bf16 and int8 (TcProduct): mma.sync from ldmatrix'd ring rows, the 8
//   product warps as 4 x 2 warp tiles of 32 x 64 scores; a k-step is 32
//   bytes of a row (m16n8k16 bf16 -> f32, m16n8k32 s8 -> s32), whose A and
//   B fragments have the same byte layout at both types.  At bf16 a k-slice
//   accumulates into a zeroed fragment that is then added to the running
//   f32 sum with __fadd_rn, which bounds the error however the tensor cores
//   round inside an mma; int8 sums are exact in s32 (|q| <= 127 cannot
//   overflow below d = 133,144) and accumulate straight into the score.
//   What bounds either is not the tensor cores: a CTA reads its 128 E1 rows
//   again for every column tile (shared memory has no room to keep them),
//   12.6 GB from L2 over a 32,768^2 x 384 sweep at bf16 and 6.3 GB at int8,
//   and the epilogues take longer than the product.
//
// The epilogues run in warps of their own (warp specialization): when the
// product warps finish a column tile they stage its scores in shared memory
// (BM x (BN + 8) words) and go on with the next tile, while the epilogue
// warps take the staged tile one warp a row (lane l has columns l, l + 32,
// ...).  Two named barriers pass the tile: "free" (the epilogue warps are
// done with it) and "full" (it is staged).  One CTA an SM of 512 threads:
// 8 epilogue warps, as 4 fall behind the fp32 product with all three
// epilogues on.  The CTA launches with 128 registers a thread, and
// setmaxnreg moves them to where they are needed: the product's two
// warpgroups take 200 a thread (the 64 accumulators and the fragments), the
// epilogue's two give up all but 56.  On the tensor cores (bf16, int8) the
// product warps finish a tile's mmas early: they then claim rows of the
// staged tile beside the epilogue warps (a shared row counter; each row
// goes to one warp, so its
// sums and top-k list take its columns in order and the results do not
// depend on which warp ran it), and the bin of the floor's weight, where
// most scores of a join land, is counted per warp and added with one atomic
// a row instead of 32 that would serialize.  Per-CTA shared memory in the
// 128 tile at k = 32 and 4,096 bins: the ring 73,728 B, the scores 69,632
// B, the rows' scales 1,024 B, the walk sums 32,768 B, the histogram 16,384
// B and the lists 33,792 B: 227,328 B, of the 232,448 a block may use.  A
// wider top-k list takes the 64 tile.  The epilogue warps issue only where
// the FFMA-bound fp32 product warps leave a slot, so their instructions are
// kept few: a row without candidates costs one warp vote.
//
// What the TPU design did that does not carry over:
// * The TPU grid walks the column blocks in order and carries the running
//   top-k and sums in scratch between grid steps.  Here blocks run in no
//   order, so the loop over column blocks sits inside the CTA: each CTA owns
//   BM rows for its column range, and the summation order is fixed from run
//   to run.
// * TPUs have no scatter-add, so the Pallas epilogue bins with one-hot
//   matmuls (kernels/binning.py).  Here each epilogue lane adds its
//   elements' bins into a shared int32 histogram with atomicAdd; the CTA
//   then adds its histogram into the global count tile of its row group.
//   Integer atomics keep the counts deterministic.
// * Top-k: a row's candidates (scores that beat its current k-th entry, one
//   warp ballot per 32 columns) enter its sorted list one at a time.  For k
//   <= 32 the warp holds the list in registers, entry l in lane l: the slot
//   is the number of entries that beat the candidate (a ballot), and the
//   lanes past it shift by one (a shuffle); an empty list (a range's first
//   tile) takes the tile's top k by k warp-wide argmax steps instead.  Wider
//   lists stay in shared memory, where the warp counts in 32-entry strides
//   and shifts the tail.  The order is (value descending, column
//   ascending), a total order, so the result does not depend on the order
//   candidates arrive in, and ties go to the lower column as in the
//   reference.
// * Walk sums: each epilogue lane keeps a (hi, lo) pair per row in shared
//   memory and adds its elements with two-sum steps, in column order; at
//   the end one thread a row adds the 32 lanes' pairs in lane order.
// * Few rows, many columns: a launch with fewer than two CTAs per SM would
//   leave SMs idle (the 3-way chain's 4,096-row prefix is 32 CTAs of 128
//   rows).  Such a launch splits the columns across a second grid
//   dimension, for about four CTAs per SM.  Count tiles merge by their
//   integer atomics; each CTA keeps the exact top-k of its column range and
//   the (hi, lo) walk sums of its columns, and a second kernel merges a
//   row's lists (one warp a row: the top-k under a total order is unique,
//   so the merged lists equal an unsplit launch's bit for bit) and its sums,
//   in range order by two-sum steps (deterministic; they differ from an
//   unsplit launch's only in their last bits).
// * A top-k launch over few rows (the raised-k retry: 8 rows against 32,768
//   at k 128) is bound by reading E2 once: 50 MB, 0.015 ms.  The tile
//   kernel would compute 64 rows for 8, insert wide lists one candidate at
//   a time and merge 256 partial lists.  At fp32 and at most FR_ROWS rows
//   it takes two kernels of its own instead (fewrow_scores, fewrow_select
//   below): one pass over E2 writes every clipped score as a sortable key,
//   and one CTA a row radix-selects its k-th key and sorts the k above it.
//   The order is the same total order, so the lists equal the tile
//   kernel's bit for bit.
//
// Exactness: the fp32 score of a pair is one fmaf chain over k = 0..d-1 in
// order, whatever the tile or launch it is computed in, so the fp32 sweep is
// bit-identical to the two-pass (histogram, top-k) launches; a bf16 score
// takes the same slices, mmas and flushes in every tile and launch, so the
// bf16 sweep equals its two-pass launches and a split launch an unsplit
// one; an int8 score is an exact integer sum, scaled as the reference
// scales it (two f32 products in a fixed order).  The walk sums
// use error-free two-sum steps written with __fadd_rn / __fsub_rn, which
// nvcc can neither contract nor reorder.  Never build with --use_fast_math.
//
// Interface: plain C, called through ctypes.  The wrapper allocates every
// output (count tiles zeroed), pads d so that a row is a multiple of 16
// bytes (4 f32, 8 bf16, 16 int8) with zero columns, picks the kernel (a
// fp32 top-k launch over at most FR_ROWS rows takes the few-row kernels),
// the tile rows and the column split, and passes PyTorch's current stream.
// Each function returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <limits.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr int NT = 256;     // product threads of a CTA: 16 x 16
constexpr int ET = 256;     // epilogue threads of a CTA: 8 warps
// registers a thread of each side takes with setmaxnreg (the CTA launches
// with 128 a thread, 65,536 in all)
constexpr int REG_PRODUCT = 200;
constexpr int REG_EPILOGUE = 56;
static_assert(NT * REG_PRODUCT + ET * REG_EPILOGUE <= 65536, "the register file");
constexpr int STAGES = 2;   // k-slices of the cp.async ring
constexpr int ROWB = 128;   // bytes of a row in one k-slice
constexpr int LDW = ROWB / 4 + 4;  // smem row stride of a k-slice, in 32-bit words
constexpr int CH = ROWB / 16;      // 16-byte chunks of a row in one k-slice
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
  float* row_sums;      // (M), or (M, gridDim.y, 2) (hi, lo) when split
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

// ---- the cp.async ring -----------------------------------------------------

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issues the copies of one k-slice (bytes kb .. kb + ROWB - 1 of rows r0 .. r0 +
// NR - 1) into dst, NR rows of LDW words.
template <int NR>
__device__ __forceinline__ void load_slice(const unsigned char* g, int rows,
                                           int row_bytes, int r0, int kb,
                                           uint32_t* dst, int tid) {
#pragma unroll
  for (int l = 0; l < NR * CH / NT; ++l) {
    const int e = tid + l * NT;
    const int row = e / CH, c = e % CH;
    const int gr = r0 + row, gb = kb + 16 * c;
    const bool in = gr < rows && gb < row_bytes;
    cp_async16(dst + row * LDW + 4 * c,
               in ? g + (size_t)gr * row_bytes + gb : g, in);
  }
}

// ---- the score tile --------------------------------------------------------
// SIMT (fp32): mma<RI, CJ> takes one landed k-slice into the thread's RI x
// CJ block, one fmaf chain per score in k order.

// One 4-deep step of a fp32 score's fmaf chain, in k order.  Every fp32
// score (the tile's and fewrow_scores') is a chain of these steps over the
// same 128-byte slices, which is what makes them equal bit for bit.
__device__ __forceinline__ float fma_step(const float4 a, const float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int MODE>
struct Tile;

template <>
struct Tile<F32> {
  static constexpr int ESIZE = 4;
  using Acc = float;
  template <int RI, int CJ>
  static __device__ __forceinline__ void mma(const uint32_t* As, const uint32_t* Bs,
                                             int ty, int tx, float (&acc)[RI][CJ]) {
    const float* A = reinterpret_cast<const float*>(As);
    const float* B = reinterpret_cast<const float*>(Bs);
#pragma unroll
    for (int kk = 0; kk < ROWB / 4; kk += 4) {
      float4 b[CJ];
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * LDW + kk);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LDW + kk);
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = fma_step(a, b[j], acc[i][j]);
      }
    }
  }
};

// bf16 and int8: the element size and score type; the product is
// TcProduct<MODE, BM>
template <>
struct Tile<BF16> {
  static constexpr int ESIZE = 2;
  using Acc = float;
};

template <>
struct Tile<I8> {
  static constexpr int ESIZE = 1;
  using Acc = int;
};

// The product warps' share of a CTA's BM x BN score tile (BN = BM), one
// landed k-slice at a time: slice() takes a slice, stage() writes the
// tile's scores into the staged tile St (row stride BM + 8) and zeroes the
// accumulators (keep: leaves them, for the epilogue-floor build).  Product
// is the fp32 one, TcProduct (below) the tensor cores'.
template <int MODE, int BM>
struct Product {  // SIMT: 16 x 16 threads, rows ty + 16 i, columns tx + 16 j
  using T = Tile<MODE>;
  using Acc = typename T::Acc;
  static constexpr int RI = BM / 16, CJ = BM / 16;
  int ty, tx;
  Acc acc[RI][CJ];
  // a warp is 4 rows x 8 columns of threads, so its B reads are 8 rows
  // (one wavefront) and its A reads 4 (a broadcast)
  __device__ __forceinline__ Product(int warp, int lane)
      : ty((warp >> 1) * 4 + (lane >> 3)), tx((warp & 1) * 8 + (lane & 7)) {
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] = Acc(0);
  }
  __device__ __forceinline__ void slice(const uint32_t* st) {
    T::template mma<RI, CJ>(st, st + BM * LDW, ty, tx, acc);
  }
  __device__ __forceinline__ void stage(float* St, bool keep) {
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        St[(ty + 16 * i) * (BM + 8) + tx + 16 * j] = acc[i][j];
        if (!keep) acc[i][j] = Acc(0);
      }
  }
};

// c += a b for a 16 x 32 s8 A (row-major fragment), a 32 x 8 s8 B (column
// fragment) and an s32 16 x 8 C: the int8 counterpart of mma_bf16, whose
// fragments hold the same bytes (a k-step is 32 bytes of a row at both)
__device__ __forceinline__ void mma_tc(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tc(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  mma_bf16(c, a, b0, b1);
}

// bf16 and int8 on the tensor cores: mma.sync from ldmatrix'd ring rows
// (144-byte stride: the 8 rows of an ldmatrix fall in distinct banks).  The
// 8 product warps are 4 x 2, a warp's tile BM / 4 rows x BM / 2 columns.  A
// k-slice (128 bytes: 64 bf16 or 128 int8) is four k-steps of 32 bytes;
// offsets are in bytes, so the addressing is the same at both types.
//   bf16: each k-slice accumulates into a zeroed fragment, which is then
//   added to the running sum with __fadd_rn: however the tensor cores round
//   inside an mma (undocumented; truncation has been measured on earlier
//   cards), a score's error stays within (2 * 64 + d / 64) u sum |a b|,
//   inside checks.exact_scores' gamma_d.
//   int8: integer sums are exact in any order, so the mmas accumulate
//   straight into the s32 sum.  The score is (float(sum) * rs1_i) * rs2_j,
//   as the reference scales it, and the product warps scale while they
//   stage, so the staged tile holds f32 scores at every type and the
//   epilogues do not depend on it.  The rows' scales are read once, the
//   tile's columns' (0 past the range) before each staging.
// Every score takes the same k order in every tile and launch.
template <int MODE, int BM>
struct TcProduct {
  using Acc = typename Tile<MODE>::Acc;
  static constexpr int MI = BM / 64, NJ = BM / 16;  // 16-row and 8-column blocks
  static constexpr int LDB = 4 * LDW;               // ring row stride in bytes
  int r0, c0, lane;
  Acc acc[MI][NJ][4];
  float rsr[MI][2], rsc[NJ][2];  // int8: the fragment's rows' and columns' scales
  __device__ __forceinline__ TcProduct(int warp, int lane_)
      : r0((warp >> 1) * (BM / 4)), c0((warp & 1) * (BM / 2)), lane(lane_) {
    zero(acc);
  }
  __device__ __forceinline__ void row_scales(const float* rrs) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) rsr[i][h] = rrs[r0 + 16 * i + (lane >> 2) + 8 * h];
  }
  // rs2 of the tile whose first column is cb (columns from ce on are 0)
  __device__ __forceinline__ void col_scales(const float* rs2, int cb, int ce) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = cb + c0 + 8 * j + 2 * (lane & 3) + e;
        rsc[j][e] = col < ce ? rs2[col] : 0.f;
      }
  }
  static __device__ __forceinline__ void zero(Acc (&c)[MI][NJ][4]) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[i][j][e] = Acc(0);
  }
  // c += the k-slice's products
  __device__ __forceinline__ void mmas(const uint32_t* st, Acc (&c)[MI][NJ][4]) const {
    const unsigned char* A = reinterpret_cast<const unsigned char*>(st);
    const unsigned char* B = A + BM * LDB;
#pragma unroll
    for (int ks = 0; ks < ROWB / 32; ++ks) {
      uint32_t a[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldmatrix_x4(a[i], A + (r0 + 16 * i + (lane & 15)) * LDB + 32 * ks + (lane >> 4) * 16);
#pragma unroll
      for (int j2 = 0; j2 < NJ / 2; ++j2) {
        uint32_t b[4];
        const int col = c0 + 16 * j2 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(b, B + col * LDB + 32 * ks + ((lane >> 3) & 1) * 16);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          mma_tc(c[i][2 * j2], a[i], b[0], b[1]);
          mma_tc(c[i][2 * j2 + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  __device__ __forceinline__ void slice(const uint32_t* st) {
    if constexpr (MODE == I8) {
      mmas(st, acc);
    } else {
      float part[MI][NJ][4];
      zero(part);
      mmas(st, part);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = __fadd_rn(acc[i][j][e], part[i][j][e]);
    }
  }
  __device__ __forceinline__ float score(int i, int j, int e) const {
    if constexpr (MODE == I8)
      return __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][e]), rsr[i][e >> 1]), rsc[j][e & 1]);
    else
      return acc[i][j][e];
  }
  // the C fragment: lane (g, t) = (lane / 4, lane % 4) holds rows g and g + 8,
  // columns 2t and 2t + 1 of each 16 x 8 block
  __device__ __forceinline__ void stage(float* St, bool keep) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float* p = St + (r0 + 16 * i + g) * (BM + 8) + c0 + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(p) = make_float2(score(i, j, 0), score(i, j, 1));
        *reinterpret_cast<float2*>(p + 8 * (BM + 8)) = make_float2(score(i, j, 2), score(i, j, 3));
        if (!keep)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = Acc(0);
      }
  }
};

// Shared-memory carve-up: the ring, the staged
// score tile (BM x (BN + 8) words), the rows' weight and int8 scales, the
// (hi, lo) walk sums of each (row, epilogue lane), then the histogram and
// the top-k lists.
// CTA tiles are square: BM = BN = bm (128 or 64)
__host__ __device__ inline size_t ring_bytes(int bm) {
  return (size_t)STAGES * (2 * bm) * LDW * 4u;
}

__host__ __device__ inline size_t smem_bytes(int flags, int n_bins, int k, int bm) {
  size_t b = ring_bytes(bm) + (size_t)bm * (bm + 8) * 4u + 2u * bm * 4u;
  if (flags & SUMS) b += (size_t)bm * 64u * 4u;
  if (flags & HIST) b += (size_t)n_bins * 4u;
  if (flags & TOPK) b += (size_t)bm * (k + 1) * 8u;
  return b;
}

// Named barriers: the product warps' own per-slice barrier, and the two
// that pass the staged score tile between them and the epilogue warps.
enum Barrier { BAR_PRODUCT = 1, BAR_FREE = 2, BAR_FULL = 3 };
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// One warp inserts candidate (x, c) into a row's sorted list (V, C) of k
// entries in shared memory: its slot is the number of entries that beat it;
// the entries from that slot on move down one place, 32 at a time from the
// end of the list.
__device__ __forceinline__ void list_insert(float* V, int* C, int k, float x, int c,
                                            int lane) {
  int above = 0;
  for (int u = lane; u < k; u += 32) above += beats(V[u], C[u], x, c);
  const int pos = __reduce_add_sync(0xffffffffu, above);
  if (pos >= k) return;
  for (int b = ((k - 2) / 32) * 32; b >= 0; b -= 32) {
    const int u = b + lane;
    const bool move = u >= pos && u < k - 1;
    const float mv = move ? V[u] : 0.f;
    const int mc = move ? C[u] : 0;
    __syncwarp();
    if (move) {
      V[u + 1] = mv;
      C[u + 1] = mc;
    }
    __syncwarp();
  }
  if (lane == 0) {
    V[pos] = x;
    C[pos] = c;
  }
  __syncwarp();
}

// One warp offers a row's candidates (NQ a lane; ok marks the real ones) to
// its list (V, C): a warp ballot finds those that beat the k-th entry, and
// they enter one at a time, each ballot dropping what the raised k-th entry
// now beats.  For k <= 32 the list sits in registers while the warp works on
// it, entry l in lane l: a candidate's slot is the number of entries that
// beat it (a prefix, by ballot), and the lanes past it take their left
// neighbour's entry (a shuffle).
template <int NQ>
__device__ __forceinline__ void offer_row(float* V, int* C, int k, const float (&sc)[NQ],
                                          const int (&col)[NQ], const bool (&ok)[NQ],
                                          int lane) {
  {  // most rows of most tiles have no candidate: one vote says so
    const float tv = V[k - 1];
    const int tc = C[k - 1];
    bool any = false;
#pragma unroll
    for (int q = 0; q < NQ; ++q) any |= ok[q] && beats(sc[q], col[q], tv, tc);
    if (!__any_sync(0xffffffffu, any)) return;
  }
  if (k <= 32 && V[0] == NEG && C[0] == INT_MAX) {
    // an empty list (a range's first tile): its entries are the candidates'
    // top k, picked by k warp-wide argmax steps
    float cs[NQ];
    int cc[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      cs[q] = ok[q] ? sc[q] : NEG;
      cc[q] = ok[q] ? col[q] : INT_MAX;
    }
    float vl = NEG;
    int cl = INT_MAX;
    for (int e = 0; e < k; ++e) {
      float bv = cs[0];
      int bc = cc[0];
#pragma unroll
      for (int q = 1; q < NQ; ++q)
        if (beats(cs[q], cc[q], bv, bc)) {
          bv = cs[q];
          bc = cc[q];
        }
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oc = __shfl_xor_sync(0xffffffffu, bc, off);
        if (beats(ov, oc, bv, bc)) {
          bv = ov;
          bc = oc;
        }
      }
      if (lane == e) {
        vl = bv;
        cl = bc;
      }
#pragma unroll
      for (int q = 0; q < NQ; ++q)  // columns are distinct: drop the winner
        if (cc[q] == bc) {
          cs[q] = NEG;
          cc[q] = INT_MAX;
        }
    }
    if (lane < k) {
      V[lane] = vl;
      C[lane] = cl;
    }
  } else if (k <= 32) {
    float vl = lane < k ? V[lane] : NEG;
    int cl = lane < k ? C[lane] : INT_MAX;
    float thr_v = __shfl_sync(0xffffffffu, vl, k - 1);
    int thr_c = __shfl_sync(0xffffffffu, cl, k - 1);
    bool dirty = false;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      unsigned m = __ballot_sync(0xffffffffu, ok[q] && beats(sc[q], col[q], thr_v, thr_c));
      while (m) {
        const int src = __ffs(m) - 1;
        const float x = __shfl_sync(0xffffffffu, sc[q], src);
        const int c = __shfl_sync(0xffffffffu, col[q], src);
        const int pos = __popc(__ballot_sync(0xffffffffu, lane < k && beats(vl, cl, x, c)));
        const float pv = __shfl_up_sync(0xffffffffu, vl, 1);
        const int pc = __shfl_up_sync(0xffffffffu, cl, 1);
        if (lane > pos) {
          vl = pv;
          cl = pc;
        } else if (lane == pos) {
          vl = x;
          cl = c;
        }
        thr_v = __shfl_sync(0xffffffffu, vl, k - 1);
        thr_c = __shfl_sync(0xffffffffu, cl, k - 1);
        dirty = true;
        m &= ~(1u << src) &
             __ballot_sync(0xffffffffu, ok[q] && beats(sc[q], col[q], thr_v, thr_c));
      }
    }
    if (dirty && lane < k) {
      V[lane] = vl;
      C[lane] = cl;
    }
  } else {
    float thr_v = V[k - 1];
    int thr_c = C[k - 1];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      unsigned m = __ballot_sync(0xffffffffu, ok[q] && beats(sc[q], col[q], thr_v, thr_c));
      while (m) {
        const int src = __ffs(m) - 1;
        const float x = __shfl_sync(0xffffffffu, sc[q], src);
        const int c = __shfl_sync(0xffffffffu, col[q], src);
        list_insert(V, C, k, x, c, lane);
        thr_v = V[k - 1];
        thr_c = C[k - 1];
        m &= ~(1u << src) &
             __ballot_sync(0xffffffffu, ok[q] && beats(sc[q], col[q], thr_v, thr_c));
      }
    }
  }
  __syncwarp();
}

template <bool B>
struct BoolTag {
  static constexpr bool value = B;
};

// The bin of weight w: truncation, saturating
__device__ __forceinline__ int bin_of(float w, int n_bins) {
  const int b = (int)__fmul_rn(w, (float)n_bins);
  return b < 0 ? 0 : (b > n_bins - 1 ? n_bins - 1 : b);
}

// The epilogue-floor build (-DREPRO_SIM_EPILOGUE_FLOOR, scripts/
// compare_kernels.py --epilogue-floor): the bf16 and int8 product warps compute a
// CTA's first column tile only and stage its scores again for every other
// column tile, so a launch times the epilogues with a product that costs
// next to nothing.  Never the build the port runs.
#ifdef REPRO_SIM_EPILOGUE_FLOOR
constexpr bool EPILOGUE_FLOOR = true;
#else
constexpr bool EPILOGUE_FLOOR = false;
#endif

template <int MODE, int BM, bool HIST_ON, bool TOPK_ON, bool SUMS_ON>
__global__ void __launch_bounds__(NT + ET, 1) sim_kernel(Params p) {
  using T = Tile<MODE>;
  // the tensor-core product (bf16, int8) leaves its warps idle most of a
  // tile: they claim rows of the staged tile beside the epilogue warps, and
  // each row's hot bin is counted per warp
  constexpr bool SHARE = MODE != F32;
  constexpr bool FLOOR = EPILOGUE_FLOOR && MODE != F32;
  constexpr int BN = BM;
  constexpr int CPL = BN / 32;         // columns of an epilogue lane
  constexpr int STAGE_W = (BM + BN) * LDW;
  constexpr int LDT = BN + 8;          // score-tile row stride (words)
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int row_next;             // the staged tile's next unclaimed row
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem);
  float* St = reinterpret_cast<float*>(ring + STAGES * STAGE_W);  // f32 scores
  float* rscale = reinterpret_cast<float*>(St + BM * LDT);
  float* rrs = rscale + BM;
  float* psum = rrs + BM;  // (hi, lo) of each (row, epilogue lane)
  unsigned char* cur = reinterpret_cast<unsigned char*>(psum + (SUMS_ON ? BM * 64 : 0));
  int* hist = reinterpret_cast<int*>(cur);
  if (HIST_ON) cur += (size_t)p.n_bins * 4u;
  const int KS = p.k + 1;  // top-k list stride (odd for k a power of two)
  float* lv = reinterpret_cast<float*>(cur);
  int* lc = reinterpret_cast<int*>(lv + BM * KS);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.x * BM;
  const int rows = min(BM, p.M - r0);  // the CTA's rows that exist
  const int c_begin = blockIdx.y * p.split_cols;
  const int c_end = min(p.N, c_begin + p.split_cols);
  const int n_ct = (c_end - c_begin + BN - 1) / BN;

  if (HIST_ON)
    for (int b = tid; b < p.n_bins; b += NT + ET) hist[b] = 0;
  if (TOPK_ON)
    for (int e = tid; e < BM * KS; e += NT + ET) {
      lv[e] = NEG;
      lc[e] = INT_MAX;
    }
  if (SUMS_ON)
    for (int e = tid; e < BM * 64; e += NT + ET) psum[e] = 0.f;
  for (int rl = tid; rl < BM; rl += NT + ET) {
    const int r = r0 + rl;
    rscale[rl] = (HIST_ON && r < p.M) ? p.scale[r] : 0.f;
    rrs[rl] = (MODE == I8 && r < p.M) ? p.rs1[r] : 0.f;
  }
  if (tid == 0) row_next = 0;
  __syncthreads();

  // ---- the epilogues of one staged row rl; lane l takes columns l, l + 32,
  // ... of column tile ct ----
  struct Cols {
    float vq[CPL];
    int col[CPL];
    bool ok[CPL];
  };
  auto cols_of = [&](int ct, Cols& c) {
    const int c0 = c_begin + ct * BN;
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      c.col[q] = c0 + lane + 32 * q;
      c.ok[q] = c.col[q] < c_end;
      c.vq[q] = (SUMS_ON && c.ok[q]) ? p.v[c.col[q]] : 0.f;
    }
  };
  // pow1: exponent and rs_exponent both 1 (the tag makes it a constant of
  // the element loop, so the loop has no per-element branch on it)
  auto row_impl = [&](int rl, const Cols& c, auto pow1) {
    constexpr bool POW1 = decltype(pow1)::value;
    float sc[CPL];
    float h = 0.f, lo = 0.f;
    if (SUMS_ON) {
      h = psum[(rl * 32 + lane) * 2];
      lo = psum[(rl * 32 + lane) * 2 + 1];
    }
    // the bin of the floor's weight, where most scores of a join land: its
    // elements are counted per warp, one atomic a row
    int hot = 0, hot_bin = -1;
    if (HIST_ON && SHARE)
      hot_bin = bin_of(__fmul_rn(POW1 || p.pow1 ? p.floor_w : powf(p.floor_w, p.exponent),
                                 rscale[rl]), p.n_bins);
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      sc[q] = fminf(fmaxf(St[rl * LDT + lane + 32 * q], 0.f), 1.f);
      // SHARE: no branch per element; a column past the range adds nothing
      // (its vq is 0, so its walk-sum term is an exact 0, and it is not
      // binned)
      if (!SHARE && !c.ok[q]) continue;
      const float base = fmaxf(sc[q], p.floor_w);
      if (HIST_ON) {
        const float w = POW1 || p.pow1 ? base : powf(base, p.exponent);
        const int b = bin_of(__fmul_rn(w, rscale[rl]), p.n_bins);
        if (!SHARE) {
          atomicAdd(&hist[b], 1);
        } else {
          hot += c.ok[q] && b == hot_bin;
          if (c.ok[q] && b != hot_bin) atomicAdd(&hist[b], 1);
        }
      }
      if (SUMS_ON) {
        float wr = POW1 || p.rs_pow1 ? base : powf(base, p.rs_exponent);
        wr = __fmul_rn(wr, c.vq[q]);
        float s2, e;
        two_sum(h, wr, s2, e);
        h = s2;
        lo = __fadd_rn(lo, e);
      }
    }
    if (HIST_ON && SHARE) {
      hot = __reduce_add_sync(0xffffffffu, hot);
      if (lane == 0 && hot) atomicAdd(&hist[hot_bin], hot);
    }
    if (SUMS_ON) {
      psum[(rl * 32 + lane) * 2] = h;
      psum[(rl * 32 + lane) * 2 + 1] = lo;
    }
    if (TOPK_ON) offer_row<CPL>(lv + rl * KS, lc + rl * KS, p.k, sc, c.col, c.ok, lane);
  };
  auto row = [&](int rl, const Cols& c) {
    if (SHARE && p.pow1 && p.rs_pow1)
      row_impl(rl, c, BoolTag<true>());
    else
      row_impl(rl, c, BoolTag<false>());
  };
  // claims rows of the staged tile one at a time until none is left (each row
  // is taken by one warp, so its sums and list see its columns in order)
  auto claim_rows = [&](const Cols& c) {
    for (;;) {
      int rl = 0;
      if (lane == 0) rl = atomicAdd(&row_next, 1);
      rl = __shfl_sync(0xffffffffu, rl, 0);
      if (rl >= rows) break;
      row(rl, c);
    }
  };

  if (tid < NT) {
    // the product's warpgroups take the registers the epilogue's give up
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REG_PRODUCT));
    // ---- the product warps: the score tiles, staged in St one by one ----
    const int row_bytes = p.d * T::ESIZE;
    const int nks = (row_bytes + ROWB - 1) / ROWB;
    const int total = n_ct * nks;
    const int loads = FLOOR ? min(total, nks) : total;
    const unsigned char* g1 = static_cast<const unsigned char*>(p.e1);
    const unsigned char* g2 = static_cast<const unsigned char*>(p.e2);
    auto issue = [&](int t) {
      uint32_t* st = ring + (t % STAGES) * STAGE_W;
      const int ct = t / nks, kb = (t - ct * nks) * ROWB;
      load_slice<BM>(g1, p.M, row_bytes, r0, kb, st, tid);
      load_slice<BN>(g2, p.N, row_bytes, c_begin + ct * BN, kb, st + BM * LDW, tid);
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < loads) issue(s);
      cp_async_commit();
    }
    std::conditional_t<MODE == F32, Product<MODE, BM>, TcProduct<MODE, BM>> pr(warp, lane);
    if constexpr (MODE == I8) pr.row_scales(rrs);
    for (int t = 0; t < total; ++t) {
      if (t < loads) {
        cp_async_wait<STAGES - 2>();
        // slice t has landed for every product thread, and every one is
        // done with the stage that the next issue overwrites (read in step
        // t - 1)
        bar_sync(BAR_PRODUCT, NT);
        if (t + STAGES - 1 < loads) issue(t + STAGES - 1);
        cp_async_commit();
        pr.slice(ring + (t % STAGES) * STAGE_W);
      }
      if ((t + 1) % nks) continue;
      const int ct = t / nks;
      if constexpr (MODE == I8) pr.col_scales(p.rs2, c_begin + ct * BN, c_end);
      if (SHARE && ct > 0) {
        Cols c;
        cols_of(ct - 1, c);
        claim_rows(c);
      }
      bar_sync(BAR_FREE, NT + ET);  // every row of the previous tile is done
      pr.stage(St, FLOOR);
      if (SHARE && tid == 0) row_next = 0;
      bar_sync(BAR_FULL, NT + ET);  // St holds the tile's scores
    }
    cp_async_wait<0>();
    if (SHARE && n_ct > 0) {
      Cols c;
      cols_of(n_ct - 1, c);
      claim_rows(c);
    }
  } else {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REG_EPILOGUE));
    // ---- the epilogue warps: rows ew, ew + 8, ... of each staged tile, or
    // (SHARE) the rows they claim ----
    const int ew = warp - NT / 32;
    for (int ct = 0; ct < n_ct; ++ct) {
      Cols c;
      cols_of(ct, c);
      bar_sync(BAR_FREE, NT + ET);
      bar_sync(BAR_FULL, NT + ET);
      if (SHARE) {
        claim_rows(c);
      } else {
        for (int rl = ew; rl < rows; rl += ET / 32) row(rl, c);
      }
    }
  }
  __syncthreads();

  if (HIST_ON) {
    int* tile = p.block_counts + (size_t)(r0 / p.bm) * p.n_bins;
    for (int b = tid; b < p.n_bins; b += NT + ET)
      if (hist[b]) atomicAdd(&tile[b], hist[b]);
  }

  if (TOPK_ON) {
    for (int e = tid; e < BM * p.k; e += NT + ET) {
      const int rl = e / p.k, q = e - rl * p.k;
      const int r = r0 + rl;
      if (r < p.M) {
        const size_t o = ((size_t)r * gridDim.y + blockIdx.y) * p.k + q;
        p.vals[o] = lv[rl * KS + q];
        p.idx[o] = lc[rl * KS + q];
      }
    }
  }

  if (SUMS_ON) {
    // fixed-order reduction of the 32 per-lane (hi, lo) pairs of a row
    for (int rl = tid; rl < BM; rl += NT + ET) {
      const int r = r0 + rl;
      if (r >= p.M) continue;
      float h = 0.f, l = 0.f;
      for (int q = 0; q < 32; ++q) {
        float s, e;
        two_sum(h, psum[(rl * 32 + q) * 2], s, e);
        h = s;
        l = __fadd_rn(l, __fadd_rn(psum[(rl * 32 + q) * 2 + 1], e));
      }
      if (gridDim.y == 1) {
        p.row_sums[r] = __fadd_rn(h, l);
      } else {
        float* o = p.row_sums + ((size_t)r * gridDim.y + blockIdx.y) * 2;
        o[0] = h;
        o[1] = l;
      }
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

// Merges what the S column ranges of each row produced: their sorted top-k
// lists (pv, pc: (M, S, k)) into the row's top-k, and their (hi, lo) walk
// sums (ps: (M, S, 2)) into its sum.  One warp a row; lane l holds the heads
// of lists l, l + 32, ...; each step takes the warp's best head under beats3
// and advances that list.  Lane 0 adds the sums in range order.
__global__ void __launch_bounds__(128) split_merge(const float* pv, const int* pc,
                                                   const float* ps, int M, int S,
                                                   int k, float* vals, int* idx,
                                                   float* row_sums) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  if (ps && lane == 0) {
    const float* P = ps + (size_t)row * S * 2;
    float h = 0.f, l = 0.f;
    for (int s = 0; s < S; ++s) {
      float t, e;
      two_sum(h, P[2 * s], t, e);
      h = t;
      l = __fadd_rn(l, __fadd_rn(P[2 * s + 1], e));
    }
    row_sums[row] = __fadd_rn(h, l);
  }
  if (!pv) return;
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

// ---- K3 over few rows ------------------------------------------------------
// fewrow_scores: a CTA of FR_COLS threads takes FR_COLS columns, one a
// thread, against all M <= FR_ROWS rows.  Both tables stream through a
// FR_STAGES-deep cp.async ring in 128-byte k-slices (the tile kernel's
// slicing and its fma_step, so a score is the same fmaf chain over the same
// zero-filled slices, bit for bit); E2's rows are read once, coalesced, and a thread's
// B reads are one wavefront a quarter warp (row stride 144 bytes), its A
// reads broadcasts.  A thread keeps 8 rows' scores a row group, up to 4
// groups.  The clipped score goes out as its key: the float's bits, which
// order non-negative floats as the floats, with -0.0 taken to +0.0.  The
// CTA also counts its keys by their top 8 bits, a histogram a row (the
// selection's first radix pass), and adds it into the row's in top.
constexpr int FR_ROWS = 32;    // rows a few-row launch takes at most
constexpr int FR_COLS = 256;   // columns of a CTA, one a thread (= NT)
constexpr int FR_STAGES = 4;
constexpr int FR_STAGE_W = (FR_ROWS + FR_COLS) * LDW;
static_assert(FR_COLS == NT, "load_slice spreads a slice over NT threads");

__host__ __device__ inline size_t fewrow_smem_bytes() {
  return (size_t)FR_STAGES * FR_STAGE_W * 4u + FR_ROWS * 256u * 4u;
}

__global__ void __launch_bounds__(FR_COLS) fewrow_scores(const float* e1, const float* e2,
                                                         int M, int N, int d,
                                                         uint32_t* keys, int* top) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem);
  unsigned* hist = reinterpret_cast<unsigned*>(ring + FR_STAGES * FR_STAGE_W);  // FR_ROWS x 256
  const int tid = threadIdx.x;
  for (int e = tid; e < FR_ROWS * 256; e += FR_COLS) hist[e] = 0;  // the loop's barrier follows
  const int c0 = blockIdx.x * FR_COLS;
  const int groups = (M + 7) / 8;
  const int row_bytes = d * 4;
  const int nks = (row_bytes + ROWB - 1) / ROWB;
  const unsigned char* g1 = reinterpret_cast<const unsigned char*>(e1);
  const unsigned char* g2 = reinterpret_cast<const unsigned char*>(e2);
  auto issue = [&](int t) {
    uint32_t* st = ring + (t % FR_STAGES) * FR_STAGE_W;
    load_slice<FR_ROWS>(g1, M, row_bytes, 0, t * ROWB, st, tid);
    load_slice<FR_COLS>(g2, N, row_bytes, c0, t * ROWB, st + FR_ROWS * LDW, tid);
  };
#pragma unroll
  for (int s = 0; s < FR_STAGES - 1; ++s) {
    if (s < nks) issue(s);
    cp_async_commit();
  }
  float acc[FR_ROWS / 8][8];
#pragma unroll
  for (int g = 0; g < FR_ROWS / 8; ++g)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
  for (int t = 0; t < nks; ++t) {
    cp_async_wait<FR_STAGES - 2>();
    __syncthreads();  // slice t has landed; slice t - 1's stage is free
    if (t + FR_STAGES - 1 < nks) issue(t + FR_STAGES - 1);
    cp_async_commit();
    const float* A = reinterpret_cast<const float*>(ring + (t % FR_STAGES) * FR_STAGE_W);
    const float* B = A + (FR_ROWS + tid) * LDW;
#pragma unroll
    for (int kk = 0; kk < ROWB / 4; kk += 4) {
      const float4 b = *reinterpret_cast<const float4*>(B + kk);
#pragma unroll
      for (int g = 0; g < FR_ROWS / 8; ++g) {
        if (g >= groups) break;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(A + (8 * g + i) * LDW + kk);
          acc[g][i] = fma_step(a, b, acc[g][i]);
        }
      }
    }
  }
  cp_async_wait<0>();
  const int c = c0 + tid;
  if (c < N) {
#pragma unroll
    for (int g = 0; g < FR_ROWS / 8; ++g)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = 8 * g + i;
        if (r < M) {
          uint32_t u = __float_as_uint(fminf(fmaxf(acc[g][i], 0.f), 1.f));
          u = u == 0x80000000u ? 0u : u;
          keys[(size_t)r * N + c] = u;
          atomicAdd(&hist[r * 256 + (u >> 24)], 1u);
        }
      }
  }
  __syncthreads();
  for (int e = tid; e < M * 256; e += FR_COLS)
    if (hist[e]) atomicAdd(&top[e], (int)hist[e]);
}

// fewrow_select: one CTA a row.  A column's 64-bit key is (its score key,
// ~column): larger keys win, so the order is beats' order, and keys are
// distinct.  Radix passes of 8 bits from the top find the k-th largest key:
// a pass counts the keys that match the digits chosen so far by their next
// digit and takes the digit where the count from the top reaches k; the
// passes stop once the chosen bin holds exactly the keys still needed.  The
// bits of ~column above those that N - 1 needs are all ones and are
// skipped.
//   The first pass is fewrow_scores' histogram.  One read of the row's keys
//   then takes the keys above the chosen top digit (fewer than k: they are
//   in) into the list, and keeps those of the chosen digit in shared memory
//   (SEL_CAND of them; a bin that holds more is read again from device
//   memory by each pass).  Later passes count those alone, in a histogram
//   with a private copy for each lane of a warp (bin b, lane l at word 32 b
//   + l: a warp's adds never share a bank).  The kept keys at or above the
//   threshold join the list (exactly k in all), and each takes its place by
//   the number of keys above it.  Warps append to the lists with one atomic
//   each.
constexpr int SEL_T = 1024;      // threads of a row's CTA: 4 a bin
constexpr int SEL_U = 16;        // keys a thread loads before it counts them
constexpr int SEL_K = 1024;      // widest list (repro_sim_launch's limit too)
constexpr int SEL_CAND = 16384;  // keys of the chosen top digit kept in shared memory
static_assert(SEL_T == 4 * 256, "a bin's total is summed by 4 threads");

__host__ __device__ inline size_t select_smem_bytes() {
  return 256u * 32u * 4u + (size_t)(SEL_K + SEL_CAND) * 8u;
}

__global__ void __launch_bounds__(SEL_T) fewrow_select(const uint32_t* keys, const int* top,
                                                       int N, int k, float* vals, int* idx) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* hist = reinterpret_cast<unsigned*>(smem);  // 256 bins x 32 lanes
  unsigned long long* list = reinterpret_cast<unsigned long long*>(hist + 256 * 32);
  unsigned long long* cand = list + SEL_K;
  __shared__ unsigned long long prefix_s;
  __shared__ int need_s, done_s, fill_s, ncand_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t* K = keys + (size_t)blockIdx.x * N;
  const int* T = top + (size_t)blockIdx.x * 256;
  // the bits of ~column that vary, rounded up to whole digits
  const int cbits = N > 1 ? ((32 - __clz(N - 1)) + 7) & ~7 : 0;
  unsigned long long prefix = cbits < 32 ? (0xFFFFFFFFull << cbits) & 0xFFFFFFFFull : 0ull;
  int need = k;
  auto key = [](int c, uint32_t u) {
    return ((unsigned long long)u << 32) | (0xFFFFFFFFu - (unsigned)c);
  };
  // warp 0: the digit at shift s from the counts of the matching keys (lane
  // l has bins 8 l .. 8 l + 7; the count from the top is a suffix sum)
  auto choose = [&](const unsigned (&cnt)[8], int s) {
    unsigned sum = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) sum += cnt[j];
    unsigned suf = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned o = __shfl_down_sync(0xffffffffu, suf, off);
      if (lane + off < 32) suf += o;
    }
    unsigned above = suf - sum;  // matching keys in the bins of higher lanes
    if (above < (unsigned)need && (unsigned)need <= suf) {
      int bin = -1;
      unsigned in_bin = 0;
#pragma unroll
      for (int j = 7; j >= 0; --j)
        if (bin < 0) {
          if (above + cnt[j] >= (unsigned)need) {
            bin = 8 * lane + j;
            in_bin = cnt[j];
          } else {
            above += cnt[j];
          }
        }
      prefix_s = prefix | ((unsigned long long)bin << s);
      need_s = need - (int)above;
      done_s = in_bin == (unsigned)(need - (int)above);
    }
  };
  // a warp appends the keys its lanes take to dst (one atomic a warp)
  auto append = [&](bool take, unsigned long long x, unsigned long long* dst, int* count,
                    int cap) {
    const unsigned m = __ballot_sync(0xffffffffu, take);
    if (!m) return;
    const int leader = __ffs(m) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(count, __popc(m));
    base = __shfl_sync(0xffffffffu, base, leader);
    const int slot = base + __popc(m & ((1u << lane) - 1u));
    if (take && slot < cap) dst[slot] = x;
  };
  // f(valid, key, top digit) for every key of the row, from device memory
  auto each_key = [&](auto f) {
    for (int c0 = 0; c0 < N; c0 += SEL_T * SEL_U) {
      uint32_t u[SEL_U];
#pragma unroll
      for (int q = 0; q < SEL_U; ++q) {
        const int c = c0 + q * SEL_T + tid;
        u[q] = c < N ? K[c] : 0u;
      }
#pragma unroll
      for (int q = 0; q < SEL_U; ++q) {
        const int c = c0 + q * SEL_T + tid;
        f(c < N, key(c, u[q]), u[q] >> 24);
      }
    }
  };

  if (warp == 0) {
    unsigned cnt[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) cnt[j] = (unsigned)T[8 * lane + j];
    choose(cnt, 56);
  }
  if (tid == 0) fill_s = ncand_s = 0;
  __syncthreads();
  prefix = prefix_s;
  need = need_s;
  const bool done = done_s;
  const unsigned top_digit = (unsigned)(prefix >> 56);
  const bool kept = !done && T[top_digit] <= SEL_CAND;
  each_key([&](bool ok, unsigned long long x, unsigned d1) {
    append(ok && (d1 > top_digit || (done && d1 == top_digit)), x, list, &fill_s, SEL_K);
    if (kept) append(ok && d1 == top_digit, x, cand, &ncand_s, SEL_CAND);
  });
  __syncthreads();
  const int ncand = ncand_s;
  // f(valid, key) for every key of the chosen top digit
  auto each_in_bin = [&](auto f) {
    if (kept) {
      for (int e0 = 0; e0 < ncand; e0 += SEL_T) {
        const int e = e0 + tid;
        f(e < ncand, e < ncand ? cand[e] : 0ull);
      }
    } else {
      each_key([&](bool ok, unsigned long long x, unsigned d1) { f(ok && d1 == top_digit, x); });
    }
  };
  if (!done) {
    for (int s = 48;;) {
      for (int e = tid; e < 256 * 32; e += SEL_T) hist[e] = 0;
      __syncthreads();
      const unsigned long long mask = ~0ull << (s + 8);
      each_in_bin([&](bool ok, unsigned long long x) {
        if (ok && ((x ^ prefix) & mask) == 0)
          atomicAdd(&hist[((unsigned)(x >> s) & 0xFFu) * 32 + lane], 1u);
      });
      __syncthreads();
      {  // bin b's total: 4 threads of 8 copies each, read rotated (no bank conflicts)
        const int b = tid >> 2, part = tid & 3;
        unsigned tot = 0;
#pragma unroll
        for (int l = 0; l < 8; ++l) tot += hist[b * 32 + ((8 * part + l + b) & 31)];
        tot += __shfl_xor_sync(0xffffffffu, tot, 1);
        tot += __shfl_xor_sync(0xffffffffu, tot, 2);
        if (part == 0) hist[b * 32] = tot;  // its other readers are this thread's quad
      }
      __syncthreads();
      if (warp == 0) {
        unsigned cnt[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) cnt[j] = hist[(8 * lane + j) * 32];
        choose(cnt, s);
      }
      __syncthreads();
      prefix = prefix_s;
      need = need_s;
      // the next digit: the value's 32 bits, then the column's that vary
      const int next = s > 32 ? s - 8 : (s == 32 ? cbits - 8 : s - 8);
      // (warp 0 writes the shared results again only two barriers on)
      if (done_s || next < 0) break;
      s = next;
    }
    each_in_bin([&](bool ok, unsigned long long x) {
      append(ok && x >= prefix, x, list, &fill_s, SEL_K);
    });
  }
  __syncthreads();
  // exactly k keys; each goes to its place: the number of keys above it
  for (int e = tid; e < k; e += SEL_T) {
    const unsigned long long x = list[e];
    int place = 0;
    for (int j = 0; j < k; ++j) place += list[j] > x;
    vals[(size_t)blockIdx.x * k + place] = __uint_as_float((unsigned)(x >> 32));
    idx[(size_t)blockIdx.x * k + place] = (int)(0xFFFFFFFFu - (unsigned)x);
  }
}

template <int MODE, int BM, bool H, bool K, bool S>
cudaError_t launch_bm(const Params& p, int splits, cudaStream_t stream) {
  const size_t bytes = smem_bytes((H ? HIST : 0) | (K ? TOPK : 0) | (S ? SUMS : 0),
                                  p.n_bins, p.k, BM);
  auto fn = sim_kernel<MODE, BM, H, K, S>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((p.M + BM - 1) / BM, splits);  // split_cols: whole BM-column tiles
  fn<<<grid, NT + ET, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int MODE, bool H, bool K, bool S>
cudaError_t launch(const Params& p, int cta_rows, int splits, cudaStream_t stream) {
  return cta_rows == 128 ? launch_bm<MODE, 128, H, K, S>(p, splits, stream)
                         : launch_bm<MODE, 64, H, K, S>(p, splits, stream);
}

}  // namespace

extern "C" {

// Shared memory a launch of (flags, tile rows) needs, in bytes.
size_t repro_sim_smem_bytes(int flags, int n_bins, int k, int cta_rows) {
  return smem_bytes(flags, n_bins, k, cta_rows);
}

// One launch.  mode: 0 fp32, 1 bf16, 2 int8.  flags: 1 histogram, 2 top-k,
// 4 walk sums.  Supported: sweep (7) for every mode, histogram (1) and top-k
// (2) for fp32 and bf16.  cta_rows: 128 or 64, the rows of a CTA tile, which must
// divide the count-tile rows bm when there is more than one count tile.  A
// launch with splits > 1 splits the columns into that many ranges of whole
// BN-column tiles (splits must be the number of ranges ceil(N / BN /
// splits) tiles each make), writes the per-range top-k lists to part_vals /
// part_idx (M, splits, k) and (hi, lo) walk sums to part_sums (M, splits,
// 2), and merges them into vals / idx / row_sums.  Returns a cudaError_t (0
// on success; cudaErrorInvalidValue for an unsupported combination or bad
// arguments).
int repro_sim_launch(int mode, int flags, const void* e1, const void* e2,
                     const float* rs1, const float* rs2, const float* scale,
                     const float* v, int M, int N, int d, int n_bins,
                     float exponent, float rs_exponent, float floor_w, int k,
                     int bm, int cta_rows, int splits, float* part_vals,
                     int* part_idx, float* part_sums, int* block_counts,
                     float* vals, int* idx, float* row_sums, void* stream) {
  Params p;
  p.e1 = e1; p.e2 = e2; p.rs1 = rs1; p.rs2 = rs2; p.scale = scale; p.v = v;
  p.M = M; p.N = N; p.d = d; p.n_bins = n_bins;
  p.exponent = exponent; p.rs_exponent = rs_exponent; p.floor_w = floor_w;
  p.pow1 = exponent == 1.0f; p.rs_pow1 = rs_exponent == 1.0f;
  p.k = k; p.bm = bm;
  p.block_counts = block_counts; p.vals = vals; p.idx = idx;
  p.row_sums = row_sums;
  const int esize = mode == F32 ? 4 : (mode == BF16 ? 2 : 1);
  if (M <= 0 || N <= 0 || d <= 0 || bm <= 0 || (d * esize) % 16)
    return (int)cudaErrorInvalidValue;
  if (cta_rows != 64 && cta_rows != 128) return (int)cudaErrorInvalidValue;
  if ((flags & HIST) && (n_bins < 1 || (bm < M && bm % cta_rows)))
    return (int)cudaErrorInvalidValue;
  if ((flags & TOPK) && (k < 1 || k > N || k > 1024)) return (int)cudaErrorInvalidValue;
  if (splits < 1 || splits > 32 * MERGE_J) return (int)cudaErrorInvalidValue;
  const int tiles = (N + cta_rows - 1) / cta_rows;  // column tiles (BN = BM)
  const int per = (tiles + splits - 1) / splits;
  if ((tiles + per - 1) / per != splits) return (int)cudaErrorInvalidValue;
  if (splits > 1 && (((flags & TOPK) && (!part_vals || !part_idx)) ||
                     ((flags & SUMS) && !part_sums)))
    return (int)cudaErrorInvalidValue;
  p.split_cols = per * cta_rows;
  if (splits > 1) {
    p.vals = part_vals;
    p.idx = part_idx;
    p.row_sums = part_sums;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (flags == (HIST | TOPK | SUMS)) {
    if (mode == F32) err = launch<F32, true, true, true>(p, cta_rows, splits, s);
    else if (mode == BF16) err = launch<BF16, true, true, true>(p, cta_rows, splits, s);
    else if (mode == I8) err = launch<I8, true, true, true>(p, cta_rows, splits, s);
    else return (int)cudaErrorInvalidValue;
  } else if (flags == HIST && mode == F32) {
    err = launch<F32, true, false, false>(p, cta_rows, splits, s);
  } else if (flags == TOPK && mode == F32) {
    err = launch<F32, false, true, false>(p, cta_rows, splits, s);
  } else if (flags == HIST && mode == BF16) {
    err = launch<BF16, true, false, false>(p, cta_rows, splits, s);
  } else if (flags == TOPK && mode == BF16) {
    err = launch<BF16, false, true, false>(p, cta_rows, splits, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err == cudaSuccess && splits > 1 && (flags & (TOPK | SUMS))) {
    split_merge<<<(M + 3) / 4, 128, 0, s>>>(
        (flags & TOPK) ? part_vals : nullptr, part_idx,
        (flags & SUMS) ? part_sums : nullptr, M, splits, k, vals, idx, row_sums);
    err = cudaGetLastError();
  }
  return (int)err;
}

// Dynamic shared memory of fewrow_scores (which = 0) or fewrow_select (1),
// in bytes.
size_t repro_topk_few_rows_smem_bytes(int which) {
  return which ? select_smem_bytes() : fewrow_smem_bytes();
}

// The fp32 top-k of M <= 32 rows (FR_ROWS): e1 (M, d), e2 (N, d) f32 with d
// a multiple of 4; keys (M, N) and top (M, 256) are the wrapper's scratch
// (top is zeroed here); vals / idx (M, k) the lists, value descending and then column
// ascending.  1 <= k <= min(N, 1024).  Returns a cudaError_t
// (cudaErrorInvalidValue for bad arguments).
int repro_topk_few_rows(const float* e1, const float* e2, int M, int N, int d, int k,
                        uint32_t* keys, int* top, float* vals, int* idx, void* stream) {
  if (M < 1 || M > FR_ROWS || N < 1 || d < 1 || d % 4 || k < 1 || k > N || k > SEL_K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(top, 0, (size_t)M * 256u * 4u, s);
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = fewrow_smem_bytes();
  err = cudaFuncSetAttribute(
      fewrow_scores, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  fewrow_scores<<<(N + FR_COLS - 1) / FR_COLS, FR_COLS, bytes, s>>>(e1, e2, M, N, d, keys,
                                                                   top);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t sel_bytes = select_smem_bytes();
  err = cudaFuncSetAttribute(fewrow_select, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sel_bytes);
  if (err != cudaSuccess) return (int)err;
  fewrow_select<<<M, SEL_T, sel_bytes, s>>>(keys, top, N, k, vals, idx);
  return (int)cudaGetLastError();
}

}  // extern "C"
