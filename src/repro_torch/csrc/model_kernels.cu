// Kernels of the Oracle model stack, for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of the model stack:
//   K5  src/repro/kernels/flash_attention/kernel.py  _kernel  (GQA flash attention)
//   K6  src/repro/kernels/rwkv6_scan/kernel.py       _kernel  (RWKV6 recurrence)
//   K7  src/repro/kernels/rglru_scan/kernel.py       _kernel  (RG-LRU recurrence)
// Each one is a first, plain version on the CUDA cores: right and simple
// first, fast in a later change.  None of them asserts a block multiple:
// every kernel masks its own ragged edge (the scorer's sequence buckets are
// 16, 32 and 48 tokens).
//
// K5, flash attention.  out = softmax(q k^T * d**-0.5 + mask) v per (batch,
// q head), with the q head's KV head h / (Hq / Hkv), so K and V are never
// repeated.  Causal and sliding-window masks by position (q and k both
// count from 0), masked scores set to -1e30 as in the TPU kernel, so a
// masked row gives what the reference gives; the output is acc / max(l,
// 1e-30) in q's type.  Scores, softmax and P.V are f32 (the TPU kernel
// casts p to v's f32 type too).
//   Bound: at the scorer's shapes (S = 48) bytes and launch; at long
//   sequences operations (4 * Sq * Skv_eff * d per head).  This version does
//   them as f32 FMAs on the CUDA cores, not on the tensor cores.
//   Design: one CTA per (batch * q head, 64-row q tile), 256 threads as
//   16 x 16; a thread owns 4 rows (ty + 16 i) and 4 score columns (tx + 16 j)
//   of a 64 x 64 score tile, and 4 rows x d/16 columns of the output.  The
//   CTA loops over the KV tiles itself (the TPU grid's sequential third
//   dimension), keeping the running max, sum and accumulator of its rows in
//   registers.  Q, K, V and P tiles sit in shared memory as f32 (213,760 B
//   at d = 256, hence cudaFuncSetAttribute); Q and K rows are padded by one
//   float so the 16 threads of a row group read 16 banks.  The 16 threads
//   of a row are one half-warp, so row max and row sum are four xor
//   shuffles.  Tiles wholly above the causal diagonal or wholly outside the
//   window are skipped when Sq <= Skv: then every row has a valid key, the
//   skipped tiles would add exactly 0 (after the diagonal) or be scaled
//   away by alpha = exp(-1e30 - m) = 0 (before the window), so skipping
//   changes no bit.
//
// K6, RWKV6 scan.  Per (batch, head), from S = 0 (hd x hd):
//   out_t = r_t (S + u * k_t^T v_t),  S <- diag(w_t) S + k_t^T v_t.
//   Bound: operations, ~6 * hd^2 f32 flops per (batch, head, step) against
//   5 * hd floats moved.  Column j of S evolves on its own (it needs only
//   v_t[j] and the k, w, r, u vectors), so thread j of a CTA of hd threads
//   owns column j of S in registers: the state never leaves the chip, as
//   the TPU kernel kept it in VMEM.  A chunk of r, k, v, w (2,048 / hd
//   steps) is staged in shared memory, where every thread reads the same
//   r_t[i], k_t[i], w_t[i] (broadcast) and its own v_t[j].  Time runs in
//   order inside the CTA; the final state is not returned (forward discards
//   it).
//
// K7, RG-LRU scan.  h_t = a_t * h_{t-1} + g_t from h = 0, per (batch,
//   channel).  Bound: bytes (12 bytes per element: a, g read, h written, all
//   f32).  One thread per (batch, channel) walks T, so neighbouring threads
//   read neighbouring channels (coalesced); the loop is unrolled so the loads
//   of later steps, which do not depend on h, are in flight early.  The
//   step is one fmaf, summed in time order (the TPU kernel's doubling scan
//   sums in another order).
//
// Interface: plain C, called through ctypes.  The wrappers allocate every
// output and pass contiguous tensors and PyTorch's current stream; each
// function returns cudaGetLastError() after its launch (or
// cudaErrorInvalidValue for arguments it does not take).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

// ----------------------------------------------------------------------------
// K5: flash attention
// ----------------------------------------------------------------------------

constexpr float FA_NEG = -1e30f;
constexpr int FA_BQ = 64;    // q rows of a CTA
constexpr int FA_BKV = 64;   // keys of a KV tile
constexpr int FA_NT = 256;   // threads of a CTA: 16 x 16

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

size_t fa_smem_bytes(int d) {
  // Q and K tiles with padded rows, V tile, P tile with padded rows
  return sizeof(float) * ((size_t)FA_BQ * (d + 1) + (size_t)FA_BKV * (d + 1) +
                          (size_t)FA_BKV * d + (size_t)FA_BQ * (FA_BKV + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(FA_NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Hq,
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
  const T* qb = q + (size_t)bh * Sq * D;
  const T* kb = k + (size_t)(b * Hkv + kvh) * Skv * D;
  const T* vb = v + (size_t)(b * Hkv + kvh) * Skv * D;
  T* ob = o + (size_t)bh * Sq * D;

  for (int i = tid; i < FA_BQ * D; i += FA_NT) {
    const int r = i / D, c = i % D;
    Qs[r * LDQ + c] = (q0 + r < Sq) ? to_f32(qb[(size_t)(q0 + r) * D + c]) : 0.f;
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
      Ks[r * LDQ + c] = in ? to_f32(kb[(size_t)(kv0 + r) * D + c]) : 0.f;
      Vs[r * D + c] = in ? to_f32(vb[(size_t)(kv0 + r) * D + c]) : 0.f;
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
        ob[(size_t)qp * D + tx + 16 * jj] = from_f32<T>(acc[i][jj] / den);
    }
  }
}

template <typename T, int D>
cudaError_t fa_launch(const void* q, const void* k, const void* v, void* o,
                      int B, int Hq, int Hkv, int Sq, int Skv, int causal,
                      int window, float scale, cudaStream_t s) {
  const size_t smem = fa_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(B * Hq), (unsigned)((Sq + FA_BQ - 1) / FA_BQ));
  flash_attention_kernel<T, D><<<grid, FA_NT, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Skv, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fa_dispatch(int d, const void* q, const void* k, const void* v,
                        void* o, int B, int Hq, int Hkv, int Sq, int Skv,
                        int causal, int window, float scale, cudaStream_t s) {
  switch (d) {
    case 16: return fa_launch<T, 16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, scale, s);
    case 32: return fa_launch<T, 32>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, scale, s);
    case 64: return fa_launch<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, scale, s);
    case 128: return fa_launch<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, scale, s);
    case 256: return fa_launch<T, 256>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// ----------------------------------------------------------------------------
// K6: RWKV6 scan
// ----------------------------------------------------------------------------

constexpr int RW_STAGE = 2048;  // floats of one staged array: CT = 2048 / hd steps

template <int HD>
__global__ void __launch_bounds__(HD)
rwkv6_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, float* __restrict__ out, int H,
                  int T) {
  constexpr int CT = RW_STAGE / HD;
  __shared__ float rs[CT][HD], ks[CT][HD], vs[CT][HD], ws[CT][HD], us[HD];
  const int bh = blockIdx.x;
  const int j = threadIdx.x;
  const size_t base = (size_t)bh * T * HD;
  us[j] = u[(bh % H) * HD + j];
  float S[HD];  // column j of the state
#pragma unroll
  for (int i = 0; i < HD; ++i) S[i] = 0.f;

  for (int t0 = 0; t0 < T; t0 += CT) {
    const int n = min(CT, T - t0);
    __syncthreads();  // the previous chunk's readers are done (and us is written)
    for (int tt = 0; tt < n; ++tt) {
      const size_t off = base + (size_t)(t0 + tt) * HD + j;
      rs[tt][j] = r[off];
      ks[tt][j] = k[off];
      vs[tt][j] = v[off];
      ws[tt][j] = w[off];
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = vs[tt][j];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < HD; ++i) {
        const float kv = ks[tt][i] * vj;
        acc = fmaf(rs[tt][i], fmaf(us[i], kv, S[i]), acc);
        S[i] = fmaf(ws[tt][i], S[i], kv);
      }
      out[base + (size_t)(t0 + tt) * HD + j] = acc;
    }
  }
}

template <int HD>
cudaError_t rw_launch(const float* r, const float* k, const float* v,
                      const float* w, const float* u, float* out, int B, int H,
                      int T, cudaStream_t s) {
  rwkv6_scan_kernel<HD><<<(unsigned)(B * H), HD, 0, s>>>(r, k, v, w, u, out, H, T);
  return cudaGetLastError();
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

// Dynamic shared memory of one flash-attention CTA at head width d, in bytes.
size_t repro_flash_smem_bytes(int d) { return fa_smem_bytes(d); }

// K5.  dtype: 0 float32, 1 bfloat16 (q, k, v and o alike).  q, o: (B, Hq,
// Sq, d); k, v: (B, Hkv, Skv, d); Hq a multiple of Hkv; d in {16, 32, 64,
// 128, 256}; window 0 for none.
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
    return (int)fa_dispatch<float>(d, q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, scale, s);
  if (dtype == 1)
    return (int)fa_dispatch<__nv_bfloat16>(d, q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

// K6.  r, k, v, w, out: (B, H, T, hd) float32; u: (H, hd) float32; hd in
// {16, 32, 64, 128}.
int repro_rwkv6_scan(const float* r, const float* k, const float* v,
                     const float* w, const float* u, float* out, int B, int H,
                     int T, int hd, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return (int)rw_launch<16>(r, k, v, w, u, out, B, H, T, s);
    case 32: return (int)rw_launch<32>(r, k, v, w, u, out, B, H, T, s);
    case 64: return (int)rw_launch<64>(r, k, v, w, u, out, B, H, T, s);
    case 128: return (int)rw_launch<128>(r, k, v, w, u, out, B, H, T, s);
    default: return (int)cudaErrorInvalidValue;
  }
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
