// Kernels of the Oracle model stack, for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of the model stack:
//   K5  src/repro/kernels/flash_attention/kernel.py  _kernel  (GQA flash attention)
//   K6  src/repro/kernels/rwkv6_scan/kernel.py       _kernel  (RWKV6 recurrence)
//   K7  src/repro/kernels/rglru_scan/kernel.py       _kernel  (RG-LRU recurrence)
// K7 is a plain version on the CUDA cores; K6 is a per-warp recurrence on the
// CUDA cores redesigned for Hopper; K5 runs bf16 on the tensor cores.  None
// of them asserts a block multiple: every kernel masks its own ragged edge
// (the scorer's sequence buckets are 16, 32 and 48 tokens).
//
// K5, flash attention.  out = softmax(q k^T * d**-0.5 + mask) v per (batch,
// q head), with the q head's KV head h / (Hq / Hkv), so K and V are never
// repeated.  Causal and sliding-window masks by position (q and k both
// count from 0), masked scores set to -1e30 as in the TPU kernel, so a
// masked row gives what the reference gives; keys past Skv score -inf (no
// part of the softmax); the output is acc / max(l, 1e-30) in q's type.
// Scores, softmax and P.V are f32 (the TPU kernel casts p to v's f32 type
// too), over KV tiles of 64 keys with the running max and sum per row.
// Tiles wholly above the causal diagonal or wholly outside the window are
// skipped when Sq <= Skv: then every row has a valid key, the skipped tiles
// would add exactly 0 (after the diagonal) or be scaled away by alpha =
// exp(-1e30 - m) = 0 (before the window), so skipping changes no bit.
//   Bound: at the scorer's shapes (S 16 to 48) bytes; at long sequences
//   operations (4 * Sq * Skv_eff * d per head).
//   bf16 (flash_attention_bf16_kernel): the tensor cores, mma.sync
//   m16n8k16 (bf16 x bf16 -> f32).  A unit is one 16-row q tile of one
//   (batch, q head), a warp's mma rows, so the scorer's 16/32/48-token
//   buckets waste no rows (wgmma's 64-row minimum would waste up to 75% at
//   S 16).  A CTA of 4 warps takes 4 consecutive units in (batch, KV head,
//   q head, q tile) order, so under GQA its warps share one KV head and K
//   and V go to shared memory once for all of them (one slot per KV head
//   the 4 units span: 1 for recurrentgemma's 16/1 heads, at most 2 at S 48
//   under MHA).  Q, K and V stay bf16 in shared memory, copied by 16-byte
//   cp.async with rows padded by 16 bytes (ldmatrix rows fall in distinct
//   banks): 64 keys of K and V are 36,864 B at d 256, against 213,760 B of
//   f32 tiles in the SIMT kernel; with more than one KV tile, two KV
//   buffers where two CTAs still fit an SM, so the next tile's copies
//   overlap this tile's mmas.  Q's A fragments stay in registers at d
//   <= 128 and are read again by ldmatrix each tile at d 256, where the 16 x
//   256 f32 accumulator takes 128 registers a thread.  S = Q K^T from
//   ldmatrix'd K; the online softmax runs in the mma's C-fragment layout (a
//   thread holds 2 rows x 16 keys; a row's max and sum are two quad
//   shuffles), and a tile that no mask touches skips the masks.  P.V must compute what the TPU kernel computes, f32 P times
//   V: each f32 p splits exactly into bf16 hi = bf16(p), mid = bf16(p - hi)
//   and lo = p - hi - mid (24 bits in three 8-bit terms), and three mmas
//   (lo, mid, hi) take them against V (exact in bf16, ldmatrix.trans) into
//   the f32 accumulator.  One bf16 P would be off by 2^-9 of sum p|v| / l,
//   beyond the bf16 rule wherever outputs cancel.  Where a CTA's KV slots
//   would not fit (d 256, one unit per group), each (batch, KV head) group
//   takes CTAs of its own and spare warps idle.
//   f32 (flash_attention_kernel, SIMT; TF32 is not allowed on an f32
//   path): one CTA per (batch * q head, 64-row q tile), 256 threads as 16 x
//   16; a thread owns 4 rows (ty + 16 i) and 4 score columns (tx + 16 j) of
//   a 64 x 64 score tile, and 4 rows x d/16 columns of the output, with the
//   running max, sum and accumulator in registers.  Q, K, V and P tiles sit
//   in shared memory as f32 (213,760 B at d = 256, hence
//   cudaFuncSetAttribute); Q and K rows are padded by one float so the 16
//   threads of a row group read 16 banks; the 16 threads of a row are one
//   half-warp, so row max and row sum are four xor shuffles.
//
// K6, RWKV6 scan.  Per (batch, head), from S = 0 (hd x hd), all in f32:
//   out_t = r_t (S + u * k_t^T v_t),  S <- diag(w_t) S + k_t^T v_t.
//   Bound: at the rwkv6-1.6b path (B 256, H 32, T 48, hd 64) operations
//   and bytes about alike: a multiply and two FMAs per (row i, column j,
//   step) of S against 5 values of hd moved per step (r, k, v read as the
//   model holds them, bf16 or f32; w f32; out f32).  Column j of S evolves
//   on its own and only the read-out sums over the rows i, so the state is
//   cut by columns and never leaves the registers (the TPU kernel kept it
//   in VMEM).
//   * Per element: the bonus term is hoisted, out_j = sum_i r_i S_ij + v_j
//     beta with beta = sum_i (r_i u_i) k_i once per step, so an element
//     costs kv = k_i v_j (a multiply), acc += r_i S_ij and S_ij = w_i S_ij
//     + kv (two FMAs).  The read-out keeps NP partial sums (rows i mod NP)
//     so no chain is hd deep.  Rounding: a state term passes at most t + 1
//     roundings in S, RPL / NP + 2 in its partial sums, log2(RG) in the
//     row-group butterfly and 1 in the final fma; beta's terms 1 + hd / 32
//     + 5 + 1.  Both stay within checks.rwkv6_scan_bound's 2t + hd + 6.
//   * Layout: a CTA is one warp and owns one (batch, head, column slice);
//     a lane holds RPL rows x CPL columns of S in registers.  What limits
//     a step is the shared-memory reads of r, k and w (each serves CPL
//     columns) and, with few warps, the latency of a step's loads and
//     butterfly.  Per head (split 0, the scorer's 8,192 heads): at hd 64 a
//     lane holds 32 rows of 4 columns (128 registers; two row groups meet
//     by one shuffle), a warp a head; hd 32 and 128 likewise at 2 and 4
//     columns (hd 128: 4 warps a head), hd 16 half the rows of 1 column.
//     Column split (split 1, few heads, as at B 1, T 4096: 32 heads): 8
//     columns a warp, 1 a lane, the rows in 4 groups, so a head takes hd /
//     8 warps that share nothing; 4 steps are unrolled so one step's loads
//     and FMAs overlap the previous one's butterfly and store, and the
//     stores are unconditional (every row group holds the same sum) so no
//     branch stops that.  Row groups are padded by 4 floats in shared
//     memory, so their 16-byte loads fall in distinct banks.
//   * Operands as the model holds them: r, k, v (bf16 or f32) and w (f32)
//     are read through their strides, so the model's (B, T, H, hd)
//     projections need no copy, and out is written through its own strides.
//     A chunk of steps (8 per head at hd 64, 32 in the column split) is
//     copied by 16-byte cp.async into a copy buffer while the previous
//     chunk's steps run, then widened to f32 in one pass (as the TPU
//     kernel's astype(float32)).  The chunk's beta_t come from one
//     butterfly over the warp that halves the steps a lane carries at each
//     level, so its shuffles are independent of each other.
// K7, RG-LRU scan.  h_t = a_t * h_{t-1} + g_t from h = 0, per (batch,
//   channel).  Bound: bytes (12 bytes per element: a, g read, h written, all
//   f32).  One thread per (batch, channel) walks T, so neighbouring threads
//   read neighbouring channels (coalesced); the loop is unrolled so the loads
//   of later steps, which do not depend on h, are in flight early.  The
//   step is one fmaf, summed in time order (the TPU kernel's doubling scan
//   sums in another order).
//
// Interface: plain C, called through ctypes.  The wrappers allocate every
// output and pass contiguous tensors (K6: strided views) and PyTorch's
// current stream; each
// function returns cudaGetLastError() after its launch (or
// cudaErrorInvalidValue for arguments it does not take).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

// ----------------------------------------------------------------------------
// K5: flash attention
// ----------------------------------------------------------------------------

constexpr float FA_NEG = -1e30f;
constexpr int FA_BQ = 64;    // q rows of a CTA
constexpr int FA_BKV = 64;   // keys of a KV tile
constexpr int FA_NT = 256;   // threads of a CTA: 16 x 16
constexpr size_t FA_MAX_SMEM = 232448;  // shared memory a block may use


size_t fa_smem_bytes(int d) {
  // Q and K tiles with padded rows, V tile, P tile with padded rows
  return sizeof(float) * ((size_t)FA_BQ * (d + 1) + (size_t)FA_BKV * (d + 1) +
                          (size_t)FA_BKV * d + (size_t)FA_BQ * (FA_BKV + 1));
}

template <int D>
__global__ void __launch_bounds__(FA_NT)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, int Hq,
                       int Hkv, int Sq, int Skv, int causal, int window,
                       float scale) {
  extern __shared__ float smem[];
  constexpr int LDQ = D + 1;
  constexpr int LDP = FA_BKV + 1;
  constexpr int RPT = FA_BQ / 16;   // rows of a thread
  constexpr int CPT = FA_BKV / 16;  // score columns of a thread
  constexpr int OPT = D / 16;       // output columns of a thread
  float* Qs = smem;
  float* Ks = Qs + FA_BQ * LDQ;
  float* Vs = Ks + FA_BKV * LDQ;
  float* Ps = Vs + FA_BKV * D;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq;
  const int kvh = h / (Hq / Hkv);
  const int q0 = blockIdx.y * FA_BQ;
  const float* qb = q + (size_t)bh * Sq * D;
  const float* kb = k + (size_t)(b * Hkv + kvh) * Skv * D;
  const float* vb = v + (size_t)(b * Hkv + kvh) * Skv * D;
  float* ob = o + (size_t)bh * Sq * D;

  for (int i = tid; i < FA_BQ * D; i += FA_NT) {
    const int r = i / D, c = i % D;
    Qs[r * LDQ + c] = (q0 + r < Sq) ? qb[(size_t)(q0 + r) * D + c] : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][OPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = FA_NEG;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < OPT; ++jj) acc[i][jj] = 0.f;
  }

  // the KV tiles a row of this CTA may attend to (see the header)
  int kv_begin = 0, kv_end = Skv;
  if (Sq <= Skv) {
    const int q_last = min(q0 + FA_BQ, Sq) - 1;
    if (causal) kv_end = min(Skv, q_last + 1);
    if (window > 0) kv_begin = (max(0, q0 - window + 1) / FA_BKV) * FA_BKV;
  }

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += FA_BKV) {
    __syncthreads();  // the previous tile's readers are done (and Qs is written)
    for (int i = tid; i < FA_BKV * D; i += FA_NT) {
      const int r = i / D, c = i % D;
      const bool in = kv0 + r < Skv;
      Ks[r * LDQ + c] = in ? kb[(size_t)(kv0 + r) * D + c] : 0.f;
      Vs[r * D + c] = in ? vb[(size_t)(kv0 + r) * D + c] : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(ty + 16 * i) * LDQ + kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Ks[(tx + 16 * j) * LDQ + kk];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kp = kv0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (kp >= Skv) {
          x = -INFINITY;  // past the keys: no part of the softmax
        } else if ((causal && qp < kp) || (window > 0 && qp - kp >= window)) {
          x = FA_NEG;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < OPT; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < FA_BKV; ++c) {
      float vv[OPT];
#pragma unroll
      for (int jj = 0; jj < OPT; ++jj) vv[jj] = Vs[c * D + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float p = Ps[(ty + 16 * i) * LDP + c];
#pragma unroll
        for (int jj = 0; jj < OPT; ++jj) acc[i][jj] = fmaf(p, vv[jj], acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp < Sq) {
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int jj = 0; jj < OPT; ++jj)
        ob[(size_t)qp * D + tx + 16 * jj] = acc[i][jj] / den;
    }
  }
}

template <int D>
cudaError_t fa_launch(const void* q, const void* k, const void* v, void* o,
                      int B, int Hq, int Hkv, int Sq, int Skv, int causal,
                      int window, float scale, cudaStream_t s) {
  const size_t smem = fa_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(B * Hq), (unsigned)((Sq + FA_BQ - 1) / FA_BQ));
  flash_attention_kernel<D><<<grid, FA_NT, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Hq, Hkv, Sq, Skv, causal,
      window, scale);
  return cudaGetLastError();
}

cudaError_t fa_dispatch(int d, const void* q, const void* k, const void* v,
                        void* o, int B, int Hq, int Hkv, int Sq, int Skv,
                        int causal, int window, float scale, cudaStream_t s) {
  switch (d) {
    case 16: return fa_launch<16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, scale, s);
    case 32: return fa_launch<32>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, scale, s);
    case 64: return fa_launch<64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, scale, s);
    case 128: return fa_launch<128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, scale, s);
    case 256: return fa_launch<256>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---- K5 at bf16: mma.sync on the tensor cores -------------------------------

constexpr int FB_BQ = 16;    // q rows of a unit: one warp's mma rows
constexpr int FB_WARPS = 4;  // units of a CTA
constexpr int FB_NT = 32 * FB_WARPS;

// x = hi + mid + lo exactly, each term a bf16: hi = bf16(x), mid = bf16(x -
// hi), lo = x - hi - mid (the residuals are exact in f32; 24 bits in three
// 8-bit terms)
__device__ __forceinline__ void split3(float x, float& hi, float& mid, float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(x));
  const float r = x - hi;
  mid = __bfloat162float(__float2bfloat16_rn(r));
  lo = r - mid;
}

// KV tiles a unit's 16 rows attend to, [begin, end), as in the f32 kernel
__device__ __forceinline__ void fb_range(int q0, int Sq, int Skv, int causal,
                                         int window, int& b, int& e) {
  b = 0;
  e = Skv;
  if (Sq <= Skv) {
    const int q_last = min(q0 + FB_BQ, Sq) - 1;
    if (causal) e = min(Skv, q_last + 1);
    if (window > 0) b = (max(0, q0 - window + 1) / FA_BKV) * FA_BKV;
  }
}

size_t fb_smem_bytes(int d, int slots, int nbuf) {
  const size_t ld = (size_t)d + 8;
  return 2 * ld * ((size_t)FB_WARPS * FB_BQ + (size_t)nbuf * slots * 2 * FA_BKV);
}

// Units: (batch, KV head, q head of the group, 16-row q tile), in that order,
// U = (Hq / Hkv) * ceil(Sq / 16) of them per (batch, KV head) group.  With
// cpg == 0 CTA c takes units 4c .. 4c + 3 of the whole order and loads one
// K/V slot per group they span; with cpg > 0 (where those slots would not
// fit) a group owns cpg CTAs of its own and the last one's spare warps idle.
template <int D>
__global__ void __launch_bounds__(FB_NT)
flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ o, int Hq, int Hkv,
                            int Sq, int Skv, int causal, int window,
                            float scale, int n_units, int cpg, int slots,
                            int nbuf) {
  constexpr int LD = D + 8;  // smem row stride (bf16): rows 16 B apart in banks
  constexpr int KD = D / 16;
  extern __shared__ __align__(16) unsigned char fb_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(fb_smem);
  // buffer b, slot s: K at 2 (b slots + s), V after it
  __nv_bfloat16* KVs = Qs + FB_WARPS * FB_BQ * LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = Hq / Hkv, nqt = (Sq + FB_BQ - 1) / FB_BQ, U = G * nqt;

  // unit of warp w: its group and its index in the group (-1: none)
  auto unit_of = [&](int w, int& grp, int& loc) {
    if (cpg > 0) {
      grp = blockIdx.x / cpg;
      loc = (blockIdx.x % cpg) * FB_WARPS + w;
      if (loc >= U) loc = -1;
    } else {
      const int u = blockIdx.x * FB_WARPS + w;
      grp = u / U;
      loc = u < n_units ? u % U : -1;
    }
  };
  int grp0, loc0;
  unit_of(0, grp0, loc0);
  // the KV tiles the CTA loads (the union of its units'), and its slots
  int cta_b = INT_MAX, cta_e = 0, n_slots = 1;
  for (int w = 0; w < FB_WARPS; ++w) {
    int g, l, b, e;
    unit_of(w, g, l);
    if (l < 0) continue;
    fb_range((l % nqt) * FB_BQ, Sq, Skv, causal, window, b, e);
    cta_b = min(cta_b, b);
    cta_e = max(cta_e, e);
    n_slots = g - grp0 + 1;
  }
  int grp, loc;
  unit_of(warp, grp, loc);
  const int slot = loc < 0 ? 0 : grp - grp0;
  const int q0 = loc < 0 ? 0 : (loc % nqt) * FB_BQ;
  const int h = (grp % Hkv) * G + (loc < 0 ? 0 : loc / nqt);
  const size_t bh = (size_t)(grp / Hkv) * Hq + h;
  int my_b = 0, my_e = 0;
  if (loc >= 0) fb_range(q0, Sq, Skv, causal, window, my_b, my_e);

  // this warp's 16 q rows
  __nv_bfloat16* Qw = Qs + warp * FB_BQ * LD;
  if (loc >= 0) {
    const __nv_bfloat16* qb = q + bh * Sq * D;
    for (int e = lane; e < FB_BQ * D / 8; e += 32) {
      const int r = e / (D / 8), c = (e % (D / 8)) * 8;
      const bool in = q0 + r < Sq;
      cp_async16(Qw + r * LD + c, in ? qb + (size_t)(q0 + r) * D + c : qb, in);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);

  const int g4 = lane >> 2, t4 = lane & 3;
  float m[2] = {FA_NEG, FA_NEG}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
  // Q's A fragments in registers where they fit (d <= 128); at d = 256 they
  // are read again from shared memory each tile, so that the 16 x 256 f32
  // accumulator does not spill
  constexpr bool QREG = D <= 128;
  uint32_t qf[QREG ? KD : 1][4];
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;  // ldmatrix of A
  bool q_ready = false;

  // the KV tile at kv0 of every slot into buffer buf; with two buffers the
  // next tile's copies overlap this tile's mmas
  auto load_kv = [&](int kv0, int buf) {
    for (int s = 0; s < n_slots; ++s) {
      const size_t base = (size_t)(grp0 + s) * Skv * D;  // batch * Hkv + KV head
      __nv_bfloat16* Ks = KVs + (2 * (buf * slots + s)) * FA_BKV * LD;
      __nv_bfloat16* Vs = Ks + FA_BKV * LD;
      for (int e = tid; e < FA_BKV * D / 8; e += FB_NT) {
        const int r = e / (D / 8), c = (e % (D / 8)) * 8;
        const bool in = kv0 + r < Skv;
        const size_t off = base + (size_t)(kv0 + r) * D + c;
        cp_async16(Ks + r * LD + c, in ? k + off : k, in);
        cp_async16(Vs + r * LD + c, in ? v + off : v, in);
      }
    }
  };
  if (cta_b < cta_e) load_kv(cta_b, 0);
  asm volatile("cp.async.commit_group;\n" ::);

  int it = 0;
  for (int kv0 = cta_b; kv0 < cta_e; kv0 += FA_BKV, ++it) {
    const int buf = nbuf == 2 ? (it & 1) : 0;
    if (it > 0) __syncthreads();  // the readers of the buffer loaded next are done
    if (nbuf == 2) {
      if (kv0 + FA_BKV < cta_e) load_kv(kv0 + FA_BKV, buf ^ 1);
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      if (it > 0) {
        load_kv(kv0, 0);
        asm volatile("cp.async.commit_group;\n" ::);
      }
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    if (loc < 0 || kv0 < my_b || kv0 >= my_e) continue;
    if (QREG && !q_ready) {
#pragma unroll
      for (int ks = 0; ks < (QREG ? KD : 1); ++ks)
        ldmatrix_x4(qf[ks], Qw + a_row * LD + ks * 16 + a_col);
      q_ready = true;
    }
    const __nv_bfloat16* Ks = KVs + (2 * (buf * slots + slot)) * FA_BKV * LD;
    const __nv_bfloat16* Vs = Ks + FA_BKV * LD;

    // S = Q K^T: 16 rows x 64 keys, 8 blocks of 8 keys
    float sc[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nb][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KD; ++ks) {
      uint32_t a[4];
      if (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[QREG ? ks : 0][e];
      } else {
        ldmatrix_x4(a, Qw + a_row * LD + ks * 16 + a_col);
      }
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        uint32_t b[4];
        const int key = n2 * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(b, Ks + key * LD + ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(sc[2 * n2], a, b[0], b[1]);
        mma_bf16(sc[2 * n2 + 1], a, b[2], b[3]);
      }
    }

    // online softmax over rows g4 (e = 0, 1) and g4 + 8 (e = 2, 3); a tile
    // that no mask touches for any of the 16 rows skips the masks
    const bool whole = kv0 + FA_BKV <= Skv && (!causal || kv0 + FA_BKV - 1 <= q0) &&
                       (window <= 0 || q0 + FB_BQ - 1 - kv0 < window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = kv0 + nb * 8 + 2 * t4 + (e & 1);
        const int qp = q0 + g4 + (e >> 1) * 8;
        float x = sc[nb][e] * scale;
        if (!whole) {
          if (kp >= Skv) {
            x = -INFINITY;  // past the keys: no part of the softmax
          } else if ((causal && qp < kp) || (window > 0 && qp - kp >= window)) {
            x = FA_NEG;
          }
        }
        sc[nb][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[nb][e] - m[e >> 1]);
        sc[nb][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nb][e] *= alpha[e >> 1];

    // O += P V with the f32 P as three bf16 terms (V is exact in bf16), the
    // smallest term first
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 16 keys a step
      uint32_t ph[4], pm[4], pl[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        // A fragment f: rows g4 (f even) or g4 + 8, keys 2 t4 (+ 8 for f >= 2)
        const int nb = 2 * kk + (f >> 1), e0 = (f & 1) * 2;
        float h0, m0, l0, h1, m1, l1;
        split3(sc[nb][e0], h0, m0, l0);
        split3(sc[nb][e0 + 1], h1, m1, l1);
        ph[f] = pack_bf16(h0, h1);
        pm[f] = pack_bf16(m0, m1);
        pl[f] = pack_bf16(l0, l1);
      }
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t b[4];
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(b, Vs + key * LD + n2 * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * n2], pl, b[0], b[1]);
        mma_bf16(acc[2 * n2], pm, b[0], b[1]);
        mma_bf16(acc[2 * n2], ph, b[0], b[1]);
        mma_bf16(acc[2 * n2 + 1], pl, b[2], b[3]);
        mma_bf16(acc[2 * n2 + 1], pm, b[2], b[3]);
        mma_bf16(acc[2 * n2 + 1], ph, b[2], b[3]);
      }
    }
  }

  if (loc < 0) return;
  __nv_bfloat16* ob = o + bh * Sq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = q0 + g4 + 8 * r;
    if (qp >= Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)qp * D + nb * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[nb][2 * r] / den, acc[nb][2 * r + 1] / den);
  }
}

// K/V slots a CTA of the flat order needs, for U units a group: 4
// consecutive units span one group (U a multiple of 4), at most two (U >= 2),
// or four (U = 1)
int fb_slots(int U) { return U % FB_WARPS == 0 ? 1 : (U >= 2 ? 2 : FB_WARPS); }

// (cpg, slots, nbuf, bytes) of a bf16 launch: the flat order where its
// slots fit; two KV buffers where there is more than one KV tile and two
// CTAs still fit an SM (228 KB, 1 KB reserved a CTA)
void fb_plan(int d, int Hq, int Hkv, int Sq, int Skv, int& cpg, int& slots,
             int& nbuf, size_t& bytes) {
  const int U = (Hq / Hkv) * ((Sq + FB_BQ - 1) / FB_BQ);
  slots = fb_slots(U);
  cpg = 0;
  nbuf = 1;
  bytes = fb_smem_bytes(d, slots, 1);
  if (bytes > FA_MAX_SMEM) {
    cpg = (U + FB_WARPS - 1) / FB_WARPS;
    slots = 1;
    bytes = fb_smem_bytes(d, 1, 1);
  }
  if (Skv > FA_BKV && 2 * (fb_smem_bytes(d, slots, 2) + 1024) <= 233472) {
    nbuf = 2;
    bytes = fb_smem_bytes(d, slots, 2);
  }
}

template <int D>
cudaError_t fb_launch(const void* q, const void* k, const void* v, void* o,
                      int B, int Hq, int Hkv, int Sq, int Skv, int causal,
                      int window, float scale, cudaStream_t s) {
  int cpg, slots, nbuf;
  size_t smem;
  fb_plan(D, Hq, Hkv, Sq, Skv, cpg, slots, nbuf, smem);
  const long long U = (long long)(Hq / Hkv) * ((Sq + FB_BQ - 1) / FB_BQ);
  const long long n_units = (long long)B * Hkv * U;
  const long long ctas = cpg > 0 ? (long long)B * Hkv * cpg
                                 : (n_units + FB_WARPS - 1) / FB_WARPS;
  if (n_units > 0x7fffffffLL || ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  flash_attention_bf16_kernel<D><<<(unsigned)ctas, FB_NT, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Hq,
      Hkv, Sq, Skv, causal, window, scale, (int)n_units, cpg, slots, nbuf);
  return cudaGetLastError();
}

cudaError_t fb_dispatch(int d, const void* q, const void* k, const void* v,
                        void* o, int B, int Hq, int Hkv, int Sq, int Skv,
                        int causal, int window, float scale, cudaStream_t s) {
  switch (d) {
    case 16: return fb_launch<16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, scale, s);
    case 32: return fb_launch<32>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, scale, s);
    case 64: return fb_launch<64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, scale, s);
    case 128: return fb_launch<128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, scale, s);
    case 256: return fb_launch<256>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// ----------------------------------------------------------------------------
// K6: RWKV6 scan
// ----------------------------------------------------------------------------

// The operands by their strides: (batch, head, time) of r, k, v, w and out
// in elements; the head width is contiguous.
struct RwArgs {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  float* out;
  long long sr[3], sk[3], sv[3], sw[3], so[3];
  int H, T, slices;
};

__device__ __forceinline__ float4 rw_load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// four bf16 widened to f32 (a bf16 is the top half of its f32: exact)
__device__ __forceinline__ float4 rw_load4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}

// One warp (a CTA of 32 threads) owns one (batch, head, column slice of SW
// columns).  Lane = (row group rg of RG, column lane cl of 32 / RG); it holds
// rows rg * RPL .. + RPL - 1 of its CPL columns cl + (32 / RG) c of S.
// In the widened chunk a step's rows are stored by row group, each group
// padded by 4 floats when RG > 1, so that the groups' 16-byte loads fall in
// distinct banks.
template <int HD, int CPL, int RG, int CT_>
struct RwLayout {
  static constexpr int RPL = HD / RG;          // rows of S a lane holds
  static constexpr int NCL = 32 / RG;          // lanes of a row group
  static constexpr int SW = NCL * CPL;         // columns of S a warp owns
  static constexpr int CT = CT_;               // steps of a staged chunk
  static constexpr int GS = RPL + (RG > 1 ? 4 : 0);  // row-group stride
  static constexpr int HDP = RG * GS;          // a widened step's stride
  static_assert(RPL % 4 == 0 && SW <= HD && CT <= 32 && (CT & (CT - 1)) == 0,
                "the lane layout");
};

// CT steps a chunk; NP partial sums of the read-out a column (rows i mod
// NP); UNR steps unrolled
template <int HD, int CPL, int RG, int CT_, int NP, int UNR, typename TIN>
__global__ void __launch_bounds__(32) rwkv6_scan_kernel(RwArgs p) {
  using L = RwLayout<HD, CPL, RG, CT_>;
  constexpr int RPL = L::RPL, NCL = L::NCL, SW = L::SW, CT = L::CT;
  constexpr int GS = L::GS, HDP = L::HDP;
  constexpr int EPC = 16 / (int)sizeof(TIN);  // elements of a 16-byte copy
  constexpr int UPL = (HD + 31) / 32;         // rows of the bonus scalar a lane sums
  static_assert(SW % EPC == 0, "v's slice is whole 16-byte copies");
  extern __shared__ __align__(16) unsigned char rw_smem[];
  // the chunk as copied (r, k: CT x HD and v: CT x SW as TIN; w: CT x HD),
  // then widened to f32 (R, K, W: CT x HDP; V: CT x SW) with each step's
  // bonus scalar
  TIN* cr = reinterpret_cast<TIN*>(rw_smem);
  TIN* ck = cr + CT * HD;
  TIN* cv = ck + CT * HD;
  float* cw = reinterpret_cast<float*>(cv + CT * SW);
  float* fr = cw + CT * HD;
  float* fk = fr + CT * HDP;
  float* fw = fk + CT * HDP;
  float* fv = fw + CT * HDP;
  float* beta = fv + CT * SW;

  const int lane = threadIdx.x;
  const int bh = blockIdx.x / p.slices, c0 = (blockIdx.x % p.slices) * SW;
  const int b = bh / p.H, h = bh % p.H;
  const int rg = lane / NCL, cl = lane % NCL;
  const TIN* rb = static_cast<const TIN*>(p.r) + b * p.sr[0] + h * p.sr[1];
  const TIN* kb = static_cast<const TIN*>(p.k) + b * p.sk[0] + h * p.sk[1];
  const TIN* vb = static_cast<const TIN*>(p.v) + b * p.sv[0] + h * p.sv[1] + c0;
  const float* wb = p.w + b * p.sw[0] + h * p.sw[1];
  float* ob = p.out + b * p.so[0] + h * p.so[1] + c0;

  // the copies of the chunk at t0: whole rows of r, k and w, v's slice;
  // steps past T are zero-filled
  auto copy = [&](auto* dst, const auto* src, long long stride, int per, int width, int t0) {
    for (int e = lane; e < CT * per; e += 32) {
      const int tt = e / per, c = (e - tt * per) * (16 / (int)sizeof(*src));
      const bool in = t0 + tt < p.T;
      cp_async16(dst + tt * width + c, src + (in ? t0 + tt : 0) * stride + c, in);
    }
  };
  auto issue = [&](int t0) {
    copy(cr, rb, p.sr[2], HD / EPC, HD, t0);
    copy(ck, kb, p.sk[2], HD / EPC, HD, t0);
    copy(cv, vb, p.sv[2], SW / EPC, SW, t0);
    copy(cw, wb, p.sw[2], HD / 4, HD, t0);
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // a row's place in a widened step
  auto at = [](int i) { return (i / RPL) * GS + i % RPL; };

  float uu[UPL];
#pragma unroll
  for (int m = 0; m < UPL; ++m) {
    const int i = lane + 32 * m;
    uu[m] = i < HD ? p.u[h * HD + i] : 0.f;
  }
  float S[RPL][CPL];
#pragma unroll
  for (int i = 0; i < RPL; ++i)
#pragma unroll
    for (int c = 0; c < CPL; ++c) S[i][c] = 0.f;

  issue(0);
  for (int t0 = 0; t0 < p.T; t0 += CT) {
    const int n = min(CT, p.T - t0);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncwarp();
    for (int e = lane; e < CT * HD / 4; e += 32) {
      const int tt = e / (HD / 4), d = tt * HDP + at(4 * e - tt * HD);
      *reinterpret_cast<float4*>(fr + d) = rw_load4(cr + 4 * e);
      *reinterpret_cast<float4*>(fk + d) = rw_load4(ck + 4 * e);
      *reinterpret_cast<float4*>(fw + d) = rw_load4(cw + 4 * e);
    }
    for (int e = lane; e < CT * SW / 4; e += 32)
      *reinterpret_cast<float4*>(fv + 4 * e) = rw_load4(cv + 4 * e);
    __syncwarp();
    // the copy buffer is free: the next chunk's copies overlap these steps
    if (t0 + CT < p.T) issue(t0 + CT);
    // beta_t = sum_i (r_i u_i) k_i of the chunk's CT steps: lane l sums rows
    // l, l + 32, ... of every step, then one butterfly over the warp halves
    // the steps a lane carries at each level while it has more than one
    // (so the shuffles of a level are independent) and sums across the
    // lanes that share a step after
    float part[CT];
#pragma unroll
    for (int tt = 0; tt < CT; ++tt) {
      part[tt] = 0.f;
#pragma unroll
      for (int m = 0; m < UPL; ++m) {
        const int i = lane + 32 * m;
        if (i < HD)
          part[tt] = fmaf(__fmul_rn(fr[tt * HDP + at(i)], uu[m]), fk[tt * HDP + at(i)], part[tt]);
      }
    }
    int step = 0;  // the step whose sum this lane ends with
#pragma unroll
    for (int lvl = 0; lvl < 5; ++lvl) {
      const int o = 16 >> lvl, half = (CT >> lvl) / 2;
      const bool up = lane & o;
      if (half > 0) {
#pragma unroll
        for (int j = 0; j < half; ++j) {
          const float send = up ? part[j] : part[j + half];
          const float keep = up ? part[j + half] : part[j];
          part[j] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, o));
        }
        step += up ? half : 0;
      } else {
        part[0] = __fadd_rn(part[0], __shfl_xor_sync(0xffffffffu, part[0], o));
      }
    }
    beta[step] = part[0];  // the lanes of a step hold the same sum
    __syncwarp();

    const float* Rg = fr + rg * GS;
    const float* Kg = fk + rg * GS;
    const float* Wg = fw + rg * GS;
#pragma unroll (UNR)
    for (int tt = 0; tt < n; ++tt) {
      float vj[CPL], acc[CPL][NP];
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        vj[c] = fv[tt * SW + cl + NCL * c];
#pragma unroll
        for (int e = 0; e < NP; ++e) acc[c][e] = 0.f;
      }
#pragma unroll
      for (int q = 0; q < RPL / 4; ++q) {
        const float4 r4 = rw_load4(Rg + tt * HDP + 4 * q);
        const float4 k4 = rw_load4(Kg + tt * HDP + 4 * q);
        const float4 w4 = rw_load4(Wg + tt * HDP + 4 * q);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int c = 0; c < CPL; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& s = S[4 * q + e][c];
            const float kv = __fmul_rn(kk[e], vj[c]);
            acc[c][e % NP] = fmaf(rr[e], s, acc[c][e % NP]);
            s = fmaf(ww[e], s, kv);
          }
      }
      const float bt = beta[tt];
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        float s = NP == 4 ? __fadd_rn(__fadd_rn(acc[c][0], acc[c][1]),
                                      __fadd_rn(acc[c][2], acc[c][NP - 1]))
                          : __fadd_rn(acc[c][0], acc[c][NP - 1]);
#pragma unroll
        for (int off = NCL; off < 32; off <<= 1)
          s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
        // every row group holds the same sum: all write it, with no branch
        // to keep the next step's loads from moving up
        ob[(t0 + tt) * p.so[2] + cl + NCL * c] = fmaf(vj[c], bt, s);
      }
    }
  }
}

template <int HD, int CPL, int RG, int CT, int NP, int UNR, typename TIN>
cudaError_t rw_launch(RwArgs p, int B, cudaStream_t s) {
  using L = RwLayout<HD, CPL, RG, CT>;
  p.slices = HD / L::SW;
  const long long units = (long long)B * p.H * p.slices;
  if (units > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = (size_t)CT * ((2 * HD + L::SW) * sizeof(TIN) + 4 * HD +
                                    4 * (3 * L::HDP + L::SW + 1));
  auto fn = rwkv6_scan_kernel<HD, CPL, RG, CT, NP, UNR, TIN>;
  const cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fn<<<(unsigned)units, 32, smem, s>>>(p);
  return cudaGetLastError();
}

// The per-head layout (split 0) or the column split (split 1), as
// (columns a lane, row groups, chunk steps, partial sums, unrolled steps).
// At hd 64, timed on the H100 (scripts/compare_kernels.py shapes): the
// per-head layout 4 columns x 32 rows a lane (2 row groups) and the column
// split 1 column x 16 rows with 32-step chunks and 4 steps unrolled, so
// that one warp an SM partition overlaps the steps' loads and butterflies.
template <typename TIN>
cudaError_t rw_dispatch(const RwArgs& p, int B, int hd, int split, cudaStream_t s) {
  switch (hd) {
    case 16: return split ? rw_launch<16, 1, 4, 32, 4, 4, TIN>(p, B, s)
                          : rw_launch<16, 1, 2, 32, 4, 2, TIN>(p, B, s);
    case 32: return split ? rw_launch<32, 1, 4, 32, 4, 4, TIN>(p, B, s)
                          : rw_launch<32, 2, 2, 16, 4, 2, TIN>(p, B, s);
    case 64: return split ? rw_launch<64, 1, 4, 32, 4, 4, TIN>(p, B, s)
                          : rw_launch<64, 4, 2, 8, 2, 1, TIN>(p, B, s);
    case 128: return split ? rw_launch<128, 1, 4, 16, 4, 4, TIN>(p, B, s)
                           : rw_launch<128, 4, 4, 4, 4, 2, TIN>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

// ----------------------------------------------------------------------------
// K7: RG-LRU scan
// ----------------------------------------------------------------------------

constexpr int LRU_NT = 64;  // channels of a CTA: few CTAs at batch 1 still spread over SMs

__global__ void __launch_bounds__(LRU_NT)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ g,
                  float* __restrict__ out, int T, int R) {
  const int c = blockIdx.x * LRU_NT + threadIdx.x;
  if (c >= R) return;
  const size_t base = (size_t)blockIdx.y * T * R + c;
  float h = 0.f;
#pragma unroll 8
  for (int t = 0; t < T; ++t) {
    const size_t off = base + (size_t)t * R;
    h = fmaf(a[off], h, g[off]);
    out[off] = h;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one flash-attention CTA in bytes: dtype 0 (f32)
// at head width d, dtype 1 (bf16) for Hq / Hkv heads, Sq and Skv too.
size_t repro_flash_smem_bytes(int dtype, int d, int Hq, int Hkv, int Sq, int Skv) {
  if (dtype == 0) return fa_smem_bytes(d);
  int cpg, slots, nbuf;
  size_t bytes;
  fb_plan(d, Hq, Hkv, Sq, Skv, cpg, slots, nbuf, bytes);
  return bytes;
}

// K5.  dtype: 0 float32 (the SIMT kernel), 1 bfloat16 (the tensor-core
// kernel); q, k, v and o alike.  q, o: (B, Hq, Sq, d); k, v: (B, Hkv, Skv,
// d); Hq a multiple of Hkv; d in {16, 32, 64, 128, 256}; window 0 for none.
int repro_flash_attention(int dtype, const void* q, const void* k,
                          const void* v, void* o, int B, int Hq, int Hkv,
                          int Sq, int Skv, int d, int causal, int window,
                          float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || Sq <= 0 || Skv <= 0 ||
      window < 0 || (long long)B * Hq > 0x7fffffffLL ||
      (Sq + FA_BQ - 1) / FA_BQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)fa_dispatch(d, q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, scale, s);
  if (dtype == 1)
    return (int)fb_dispatch(d, q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

// K6.  dtype 0: r, k, v float32; 1: bfloat16; w, u and out float32.  r, k,
// v, w, out: (B, H, T, hd) by their strides (strides: (batch, head, time) of
// r, k, v, w, out in that order, in elements, each a multiple of 16 bytes;
// the head width contiguous); u: (H, hd) contiguous; hd in {16, 32, 64,
// 128}; split 1 takes the column-split layout.
int repro_rwkv6_scan(int dtype, const void* r, const void* k, const void* v,
                     const float* w, const float* u, float* out,
                     const long long* strides, int B, int H, int T, int hd,
                     int split, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || !strides) return (int)cudaErrorInvalidValue;
  RwArgs p;
  p.r = r; p.k = k; p.v = v; p.w = w; p.u = u; p.out = out;
  long long* dst[5] = {p.sr, p.sk, p.sv, p.sw, p.so};
  for (int a = 0; a < 5; ++a)
    for (int j = 0; j < 3; ++j) dst[a][j] = strides[3 * a + j];
  p.H = H;
  p.T = T;
  p.slices = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)rw_dispatch<float>(p, B, hd, split, s);
  if (dtype == 1) return (int)rw_dispatch<__nv_bfloat16>(p, B, hd, split, s);
  return (int)cudaErrorInvalidValue;
}

// K7.  a, g, out: (B, T, R) float32.
int repro_rglru_scan(const float* a, const float* g, float* out, int B, int T,
                     int R, void* stream) {
  if (B <= 0 || T <= 0 || R <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((R + LRU_NT - 1) / LRU_NT), (unsigned)B);
  rglru_scan_kernel<<<grid, LRU_NT, 0, static_cast<cudaStream_t>(stream)>>>(a, g, out, T, R);
  return (int)cudaGetLastError();
}

}  // extern "C"
