// K8: the bootstrap-t's resample draws and moments (core/bootstrap.py), for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference draws each stratum's resample
// indices with numpy's Generator, rng.integers(0, n_i, size=(n_boot, n_i)),
// and reduces the gathered terms on the host (src/repro/core/bootstrap.py).
// It was added because that host work left the card idle for about a
// quarter of a 262,144^2 query.  The kernels make the same draws: the
// Generator is numpy's PCG64 (a 128-bit LCG, multiplier
// 0x2360ED051FC65DA44385DF649FCCF645, stepped and then output by XSL-RR),
// and numpy's integers() on a range under 2^32 takes one 32-bit word a
// draw, the low half of a 64-bit output first, the high half held in the
// Generator's state (has_uint32, uinteger) across calls, and accepts it by
// Lemire's rule: m = u * n, rejected while (m mod 2^32) < 2^32 mod n, the
// draw m >> 32.  Every stratum's draws follow the last one's in one stream
// of words.  The word w of that stream is a pure function of w (a jump
// ahead of the LCG by O(log w) 128-bit multiply-adds), so any thread can
// make any draw, once it knows how many words were rejected before it.
//
// Three kernels, one call of the wrapper (kernels/bootstrap_t/kernel.py):
// * boot_detect_kernel: every word a stratum could read (its draws' words
//   plus a slack for the rejections before them) is tested under that
//   stratum's n; the rejected (word, stratum) pairs, a few a query, go back
//   to the host, which walks them in word order and finds the draws whose
//   word was rejected (plain.resolve_rejections; the slack and the list's
//   room are raised and the kernel run again where either ran short).
// * boot_moments_kernel: one CTA a (stratum, 16 resamples), one warp a
//   resample, each lane a run of its n_i draws: it counts the rejections
//   before its run (a binary search in the sorted list), jumps to its first
//   word and gathers the stratum-centred terms at its draws, from shared
//   memory where the stratum's terms fit, else from L2.  A first pass sums
//   the terms for the resample's mean, a second (the same draws again) sums
//   the squared and cross deviations from it: the two passes take the same
//   steps as numpy's mean and var, so a resample that draws one value n
//   times has a deviation of exactly 0 there too.  A warp's sums meet in a
//   xor butterfly, so every run adds in the same order.  Only what the
//   aggregate reads is computed: the sum terms (SUM), the count terms
//   (COUNT), both and their cross deviations (AVG).
// * boot_reduce_kernel: one thread a resample adds the strata's moments in
//   stratum order, as the host loop adds them, into 5 x n_boot f64.
//   Deterministic: the same seed gives the same CI bit for bit.
//
// Bound: the f64 operations on the gathered terms, 2 a draw and aggregate
// read (a sum and a squared deviation), 6 under AVG with the cross term,
// over the FP64 peak, against the terms read once and 5 x n_boot written.
// Both are far under the integer work that makes the draws (a 128-bit
// multiply-add per two words, on the CUDA cores' 32-bit multipliers), and
// under the launches and copies around them; what the design buys is that
// 2e7 draws a query run on 132 SMs instead of one host core.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned __int128 u128;
typedef unsigned long long u64;
typedef long long i64;

constexpr int BOOT_THREADS = 256;
constexpr int BOOT_WARPS = BOOT_THREADS / 32;
constexpr int RESAMPLES_PER_CTA = 16;
constexpr int DETECT_RUN = 64;         // words a detecting thread tests
constexpr int MAX_SMEM = 232448;       // shared memory a block may use on Hopper

__device__ __forceinline__ u128 make128(u64 lo, u64 hi) {
  return (static_cast<u128>(hi) << 64) | lo;
}

// PCG64's output: XSL-RR of the stepped state
__device__ __forceinline__ u64 xsl_rr(u128 s) {
  const u64 x = static_cast<u64>(s >> 64) ^ static_cast<u64>(s);
  const unsigned rot = static_cast<unsigned>(s >> 122);
  return (x >> rot) | (x << ((64u - rot) & 63u));
}

// The Generator's 32-bit words, counted from the state the wrapper read.
// Word w is the buffered half-word when the state holds one (w = 0), else
// half (w - h) & 1 of output (w - h) >> 1, output j being XSL-RR of the
// state after j + 1 steps.  A thread reads its words in increasing order.
struct Words {
  const u64* tab;   // 64 x (A lo, A hi, C lo, C hi): the LCG's 2^b steps
  u128 s;           // the state after j + 1 steps (the wrapper's state at j = -1)
  u128 inc;
  i64 j;
  u64 out;
  int h;            // has_uint32
  unsigned buf;     // uinteger

  __device__ void seek(i64 jt) {
    i64 k = jt - j;
    if (k <= 8) {
      const u128 mul = make128(0x4385DF649FCCF645ULL, 0x2360ED051FC65DA4ULL);
      for (; k > 0; --k) s = s * mul + inc;
    } else {
      for (int b = 0; k; ++b, k >>= 1) {
        if (k & 1) {
          const u64* t = tab + 4 * b;
          s = make128(__ldg(t), __ldg(t + 1)) * s + make128(__ldg(t + 2), __ldg(t + 3));
        }
      }
    }
    j = jt;
    out = xsl_rr(s);
  }

  __device__ __forceinline__ unsigned word(i64 w) {
    const i64 wp = w - h;
    if (wp < 0) return buf;
    const i64 jt = wp >> 1;
    if (jt != j) seek(jt);
    return (wp & 1) ? static_cast<unsigned>(out >> 32) : static_cast<unsigned>(out);
  }
};

__device__ __forceinline__ Words make_words(const u64* tab, u64 s_lo, u64 s_hi, u64 inc_lo,
                                            u64 inc_hi, int h, unsigned buf) {
  Words g;
  g.tab = tab;
  g.s = make128(s_lo, s_hi);
  g.inc = make128(inc_lo, inc_hi);
  g.j = -1;
  g.out = 0;
  g.h = h;
  g.buf = buf;
  return g;
}

__global__ void __launch_bounds__(BOOT_THREADS) boot_detect_kernel(
    const u64* __restrict__ tab, u64 s_lo, u64 s_hi, u64 inc_lo, u64 inc_hi, int h,
    unsigned buf, int n_strata, const i64* __restrict__ wstart, const i64* __restrict__ wcount,
    const unsigned* __restrict__ high, const unsigned* __restrict__ thr,
    const i64* __restrict__ run_prefix, int cap, i64* __restrict__ cand_w,
    int* __restrict__ cand_s, int* __restrict__ n_cand) {
  const i64 r = static_cast<i64>(blockIdx.x) * BOOT_THREADS + threadIdx.x;
  if (r >= run_prefix[n_strata]) return;
  // the stratum: the last st with run_prefix[st] <= r (strata with no runs
  // share their prefix with the next)
  int lo = 0, hi = n_strata;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (run_prefix[mid] <= r) lo = mid; else hi = mid;
  }
  const int st = lo;
  const i64 first = wstart[st] + (r - run_prefix[st]) * DETECT_RUN;
  const i64 end = min(first + DETECT_RUN, wstart[st] + wcount[st]);
  const u64 n = high[st];
  const unsigned t = thr[st];
  Words g = make_words(tab, s_lo, s_hi, inc_lo, inc_hi, h, buf);
  for (i64 w = first; w < end; ++w) {
    const u64 m = static_cast<u64>(g.word(w)) * n;
    if (static_cast<unsigned>(m) < t) {
      const int i = atomicAdd(n_cand, 1);
      if (i < cap) {
        cand_w[i] = w;
        cand_s[i] = st;
      }
    }
  }
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// first index of the sorted rej[0, n) that is >= d
__device__ __forceinline__ int lower_bound(const i64* __restrict__ rej, int n, i64 d) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (rej[mid] < d) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// part: (n_strata, 5, n_boot) f64, rows mean of the sum terms, mean of the
// count terms, their ddof-1 variances over n_i, their cross deviations over
// (n_i - 1) n_i.  flags: 1 sum terms, 2 count terms, 4 the cross term.
__global__ void __launch_bounds__(BOOT_THREADS) boot_moments_kernel(
    const u64* __restrict__ tab, u64 s_lo, u64 s_hi, u64 inc_lo, u64 inc_hi, int h,
    unsigned buf, int n_boot, const i64* __restrict__ base, const unsigned* __restrict__ high,
    const i64* __restrict__ toff, const double* __restrict__ xs_all,
    const double* __restrict__ xc_all, int flags, const i64* __restrict__ rej, int n_rej,
    int smem_bytes, double* __restrict__ part) {
  extern __shared__ double smem[];
  const int st = blockIdx.y;
  const int n = static_cast<int>(high[st]);
  const bool use_s = flags & 1, use_c = flags & 2, use_x = (flags & 4) && use_s && use_c;
  const double* xs = use_s ? xs_all + toff[st] : nullptr;
  const double* xc = use_c ? xc_all + toff[st] : nullptr;
  const int arrays = (use_s ? 1 : 0) + (use_c ? 1 : 0);
  if (static_cast<i64>(n) * arrays * 8 <= smem_bytes) {
    double* dst = smem;
    if (use_s) {
      for (int i = threadIdx.x; i < n; i += BOOT_THREADS) dst[i] = xs[i];
      xs = dst;
      dst += n;
    }
    if (use_c) {
      for (int i = threadIdx.x; i < n; i += BOOT_THREADS) dst[i] = xc[i];
      xc = dst;
    }
    __syncthreads();
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per = (n + 31) / 32;
  const int lo = min(lane * per, n), hi = min(lo + per, n);
  const u64 nn = static_cast<u64>(n);
  const double dn = static_cast<double>(n);
  const int b_end = min(n_boot, static_cast<int>(blockIdx.x + 1) * RESAMPLES_PER_CTA);
  for (int b = blockIdx.x * RESAMPLES_PER_CTA + warp; b < b_end; b += BOOT_WARPS) {
    const i64 d0 = base[st] + static_cast<i64>(b) * n + lo;
    const i64 d1 = base[st] + static_cast<i64>(b) * n + hi;
    const int p = lower_bound(rej, n_rej, d0);
    Words g0 = make_words(tab, s_lo, s_hi, inc_lo, inc_hi, h, buf);
    if (d0 < d1) g0.word(d0 + p);  // jump once; both passes start here
    double a_s = 0.0, a_c = 0.0;
    {
      Words g = g0;
      int q = p;
      for (i64 d = d0; d < d1; ++d) {
        while (q < n_rej && rej[q] == d) ++q;
        const unsigned idx = static_cast<unsigned>((static_cast<u64>(g.word(d + q)) * nn) >> 32);
        if (use_s) a_s += xs[idx];
        if (use_c) a_c += xc[idx];
      }
    }
    const double ms = warp_sum(a_s) / dn, mc = warp_sum(a_c) / dn;
    double v_s = 0.0, v_c = 0.0, v_x = 0.0;
    {
      Words g = g0;
      int q = p;
      for (i64 d = d0; d < d1; ++d) {
        while (q < n_rej && rej[q] == d) ++q;
        const unsigned idx = static_cast<unsigned>((static_cast<u64>(g.word(d + q)) * nn) >> 32);
        const double ds = use_s ? xs[idx] - ms : 0.0;
        const double dc = use_c ? xc[idx] - mc : 0.0;
        v_s += ds * ds;
        v_c += dc * dc;
        if (use_x) v_x += ds * dc;
      }
    }
    v_s = warp_sum(v_s);
    v_c = warp_sum(v_c);
    v_x = warp_sum(v_x);
    if (lane == 0) {
      double* o = part + static_cast<i64>(st) * 5 * n_boot + b;
      if (use_s) {
        o[0] = ms;
        o[2 * n_boot] = v_s / (dn - 1.0) / dn;
      }
      if (use_c) {
        o[n_boot] = mc;
        o[3 * n_boot] = v_c / (dn - 1.0) / dn;
      }
      if (use_x) o[4 * n_boot] = v_x / ((dn - 1.0) * dn);
    }
  }
}

// out: (5, n_boot), row r the sum over strata (in order) of part's row r
__global__ void boot_reduce_kernel(const double* __restrict__ part, int n_strata, int n_boot,
                                   int flags, double* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_boot) return;
  const bool use_s = flags & 1, use_c = flags & 2, use_x = (flags & 4) && use_s && use_c;
  const bool rows[5] = {use_s, use_c, use_s, use_c, use_x};
  for (int r = 0; r < 5; ++r) {
    if (!rows[r]) continue;
    double acc = 0.0;
    for (int st = 0; st < n_strata; ++st) acc += part[(static_cast<i64>(st) * 5 + r) * n_boot + b];
    out[static_cast<i64>(r) * n_boot + b] = acc;
  }
}

}  // namespace

extern "C" {

// The runs of DETECT_RUN words each stratum tests (run_prefix, n_strata + 1
// entries; n_runs its last).  n_cand is zeroed here, on the stream.
int repro_boot_detect(const u64* tab, u64 s_lo, u64 s_hi, u64 inc_lo, u64 inc_hi, int h,
                      unsigned buf, int n_strata, const i64* wstart, const i64* wcount,
                      const unsigned* high, const unsigned* thr, const i64* run_prefix,
                      i64 n_runs, int cap, i64* cand_w, int* cand_s, int* n_cand,
                      void* stream) {
  if (n_strata <= 0 || n_runs < 0 || cap < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(n_cand, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_runs == 0) return static_cast<int>(cudaGetLastError());
  const i64 blocks = (n_runs + BOOT_THREADS - 1) / BOOT_THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  boot_detect_kernel<<<static_cast<unsigned>(blocks), BOOT_THREADS, 0, s>>>(
      tab, s_lo, s_hi, inc_lo, inc_hi, h, buf, n_strata, wstart, wcount, high, thr, run_prefix,
      cap, cand_w, cand_s, n_cand);
  return static_cast<int>(cudaGetLastError());
}

// The moments (part, n_strata x 5 x n_boot f64) and their sum over strata
// (out, 5 x n_boot f64).  smem_bytes: the dynamic shared memory of each CTA;
// a stratum whose terms take more reads them from device memory.
int repro_boot_moments(const u64* tab, u64 s_lo, u64 s_hi, u64 inc_lo, u64 inc_hi, int h,
                       unsigned buf, int n_strata, int n_boot, const i64* base,
                       const unsigned* high, const i64* toff, const double* xs_all,
                       const double* xc_all, int flags, const i64* rej, int n_rej,
                       int smem_bytes, double* part, double* out, void* stream) {
  if (n_strata <= 0 || n_strata > 65535 || n_boot <= 0 || smem_bytes < 0 ||
      smem_bytes > MAX_SMEM || n_rej < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // always the same value, so threads launching at once cannot undo
  // each other's setting
  cudaError_t err = cudaFuncSetAttribute(
      boot_moments_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_boot + RESAMPLES_PER_CTA - 1) / RESAMPLES_PER_CTA, n_strata);
  boot_moments_kernel<<<grid, BOOT_THREADS, smem_bytes, s>>>(
      tab, s_lo, s_hi, inc_lo, inc_hi, h, buf, n_boot, base, high, toff, xs_all, xc_all, flags,
      rej, n_rej, smem_bytes, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  boot_reduce_kernel<<<(n_boot + 127) / 128, 128, 0, s>>>(part, n_strata, n_boot, flags, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
