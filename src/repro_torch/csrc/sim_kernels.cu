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
// bf16 on the tensor cores, bf16 x bf16 -> f32; int8 by __dp4a with int32
// accumulation) and reads only the two tables, so at the main-path shapes
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
//   fp32, int8 (SIMT, and bit for bit equal to the two-pass kernels): 256
//   product threads (16 x 16; a warp is 4 x 8 of them) own rows ty + 16 i
//   and columns tx + 16 j each, an 8 x 8 block of scores (4 x 4 in the 64
//   tile).  Each 4-deep step a thread reads 8 A and 8 B float4 from shared
//   memory for 256 FMAs; a warp's A reads are broadcasts of 4 rows and its B
//   reads 8 rows 144 bytes apart, one wavefront each.
//   bf16 (Product<BF16>): mma.sync m16n8k16 from ldmatrix'd ring rows, the
//   8 product warps as 4 x 2 warp tiles of 32 x 64 scores.  A k-slice
//   accumulates into a zeroed fragment that is then added to the running
//   f32 sum with __fadd_rn, which bounds the error however the tensor cores
//   round inside an mma.  What bounds it is not the tensor cores: a CTA
//   reads its 128 E1 rows again for every column tile (shared memory has no
//   room to keep them), about 12.6 GB from L2 over a 32,768^2 x 384 sweep,
//   so the product alone runs near the L2's rate and the epilogues take
//   about as long again.
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
// epilogue's two give up all but 56.  At bf16 the product warps finish a
// tile's mmas early: they then claim rows of the staged tile beside the
// epilogue warps (a shared row counter; each row goes to one warp, so its
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
//   rows; the raised-k retry runs on a handful of rows).  Such a launch
//   splits the columns across a second grid dimension, for about four CTAs
//   per SM.  Count tiles merge by their integer atomics; each CTA keeps the
//   exact top-k of its column range and the (hi, lo) walk sums of its
//   columns, and a second kernel merges a row's lists (one warp a row: the
//   top-k under a total order is unique, so the merged lists equal an
//   unsplit launch's bit for bit) and its sums, in range order by two-sum
//   steps (deterministic; they differ from an unsplit launch's only in
//   their last bits).
//
// Exactness: the fp32 score of a pair is one fmaf chain over k = 0..d-1 in
// order, whatever the tile or launch it is computed in, so the fp32 sweep is
// bit-identical to the two-pass (histogram, top-k) launches; a bf16 score
// takes the same slices, mmas and flushes in every tile and launch, so the
// bf16 sweep equals its two-pass launches and a split launch an unsplit one.  The walk sums
// use error-free two-sum steps written with __fadd_rn / __fsub_rn, which
// nvcc can neither contract nor reorder.  Never build with --use_fast_math.
//
// Interface: plain C, called through ctypes.  The wrapper allocates every
// output (count tiles zeroed), pads d so that a row is a multiple of 16
// bytes (4 f32, 8 bf16, 16 int8) with zero columns, picks the tile rows and
// the column split, and passes PyTorch's current stream.  The function
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <limits.h>

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
// SIMT (fp32, int8): mma<RI, CJ> takes one landed k-slice into the thread's
// RI x CJ block, one fmaf (dp4a) chain per score in k order.

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
        for (int j = 0; j < CJ; ++j) {
          acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
        }
      }
    }
  }
};

// bf16: the element size and score type; the product is Product<BF16, BM>
template <>
struct Tile<BF16> {
  static constexpr int ESIZE = 2;
  using Acc = float;
};

template <>
struct Tile<I8> {
  static constexpr int ESIZE = 1;
  using Acc = int;
  template <int RI, int CJ>
  static __device__ __forceinline__ void mma(const uint32_t* As, const uint32_t* Bs,
                                             int ty, int tx, int (&acc)[RI][CJ]) {
#pragma unroll
    for (int kw = 0; kw < ROWB / 4; kw += 4) {  // 16 int8 a step
      int4 b[CJ];
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        b[j] = *reinterpret_cast<const int4*>(Bs + (tx + 16 * j) * LDW + kw);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int4 a = *reinterpret_cast<const int4*>(As + (ty + 16 * i) * LDW + kw);
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          acc[i][j] = __dp4a(a.x, b[j].x, acc[i][j]);
          acc[i][j] = __dp4a(a.y, b[j].y, acc[i][j]);
          acc[i][j] = __dp4a(a.z, b[j].z, acc[i][j]);
          acc[i][j] = __dp4a(a.w, b[j].w, acc[i][j]);
        }
      }
    }
  }
};

// The product warps' share of a CTA's BM x BN score tile (BN = BM), one
// landed k-slice at a time: slice() takes a slice, stage() writes the
// tile's scores into the staged tile St (row stride BM + 8) and zeroes the
// accumulators (keep: leaves them, for the epilogue-floor build).
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
  __device__ __forceinline__ void stage(Acc* St, bool keep) {
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        St[(ty + 16 * i) * (BM + 8) + tx + 16 * j] = acc[i][j];
        if (!keep) acc[i][j] = Acc(0);
      }
  }
};

// bf16 on the tensor cores: mma.sync m16n8k16 (bf16 x bf16 -> f32) from
// ldmatrix'd ring rows (144-byte stride: the 8 rows of an ldmatrix fall in
// distinct banks).  The 8 product warps are 4 x 2, a warp's tile BM / 4 rows
// x BM / 2 columns.  Each k-slice (64 columns: four k-steps) accumulates
// into a zeroed fragment, which is then added to the running sum with
// __fadd_rn: however the tensor cores round inside an mma (undocumented;
// truncation has been measured on earlier cards), a score's error stays
// within (2 * 64 + d / 64) u sum |a b|, inside checks.exact_scores' gamma_d.
// Every score takes the same k order in every tile and launch.
template <int BM>
struct Product<BF16, BM> {
  static constexpr int MI = BM / 64, NJ = BM / 16;  // 16-row and 8-column blocks
  static constexpr int LDB = 2 * LDW;               // ring row stride in bf16
  int r0, c0, lane;
  float acc[MI][NJ][4];
  __device__ __forceinline__ Product(int warp, int lane_)
      : r0((warp >> 1) * (BM / 4)), c0((warp & 1) * (BM / 2)), lane(lane_) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }
  __device__ __forceinline__ void slice(const uint32_t* st) {
    const __nv_bfloat16* A = reinterpret_cast<const __nv_bfloat16*>(st);
    const __nv_bfloat16* B = A + BM * LDB;
    float part[MI][NJ][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < ROWB / 32; ++ks) {  // k-steps of 16 bf16
      uint32_t a[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldmatrix_x4(a[i], A + (r0 + 16 * i + (lane & 15)) * LDB + 16 * ks + (lane >> 4) * 8);
#pragma unroll
      for (int j2 = 0; j2 < NJ / 2; ++j2) {
        uint32_t b[4];
        const int col = c0 + 16 * j2 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(b, B + col * LDB + 16 * ks + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          mma_bf16(part[i][2 * j2], a[i], b[0], b[1]);
          mma_bf16(part[i][2 * j2 + 1], a[i], b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = __fadd_rn(acc[i][j][e], part[i][j][e]);
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
        *reinterpret_cast<float2*>(p) = make_float2(acc[i][j][0], acc[i][j][1]);
        *reinterpret_cast<float2*>(p + 8 * (BM + 8)) = make_float2(acc[i][j][2], acc[i][j][3]);
        if (!keep)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
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
// compare_kernels.py --epilogue-floor): the bf16 product warps compute a
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
  using Acc = typename T::Acc;
  // bf16's tensor-core product leaves its warps idle most of a tile: they
  // claim rows of the staged tile beside the epilogue warps, and each row's
  // hot bin is counted per warp
  constexpr bool SHARE = MODE == BF16;
  constexpr bool FLOOR = EPILOGUE_FLOOR && MODE == BF16;
  constexpr int BN = BM;
  constexpr int CPL = BN / 32;         // columns of an epilogue lane
  constexpr int STAGE_W = (BM + BN) * LDW;
  constexpr int LDT = BN + 8;          // score-tile row stride (words)
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int row_next;             // the staged tile's next unclaimed row
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem);
  Acc* St = reinterpret_cast<Acc*>(ring + STAGES * STAGE_W);
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
    float vq[CPL], rsq[CPL];
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
      c.rsq[q] = (MODE == I8 && c.ok[q]) ? p.rs2[c.col[q]] : 0.f;
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
      float s;
      if (MODE == I8)
        s = __fmul_rn(__fmul_rn(__int2float_rn((int)St[rl * LDT + lane + 32 * q]), rrs[rl]),
                      c.rsq[q]);
      else
        s = (float)St[rl * LDT + lane + 32 * q];
      sc[q] = fminf(fmaxf(s, 0.f), 1.f);
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
    Product<MODE, BM> pr(warp, lane);
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

}  // extern "C"
