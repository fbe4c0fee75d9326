// Paged attention of LM serving, hand-written for Hopper (sm_90a): the SLA2
// paged decode (and its multi-row verify window), the dense paged decode
// (and its verify window) and the chunked-prefill flash attention over the
// page pool.
//
// Replaces (the Pallas TPU kernels):
//   sla2_decode   repro/kernels/sla2_decode_paged.py::_decode_kernel, via
//                 sla2_decode_fused (W = 1) and sla2_decode_verify (W > 1);
//   dense_decode  repro/kernels/sla2_decode_paged.py::_dense_decode_kernel,
//                 via dense_decode_fused (W = 1) and dense_decode_verify;
//   paged_prefill repro/kernels/sla2_decode_paged.py::_prefill_kernel, via
//                 paged_flash_prefill.
//
// The K/V cache is a pool of physical pages (P, Hkv, bk, Dh): f32 or bf16,
// or int8 / e4m3 codes with one f32 scale per token row (kv_quant), which
// are dequantised on load as codes * scale.
//
// sla2_decode: one block per (slot x KV head, window row).  It walks the
// row's K_sel routed entries in ascending jj and skips invalid ones without
// loading anything (the trash page is never read).  For each routed page:
//   - the K and V tiles (bk x Dh) are loaded once, as f32 in shared memory;
//   - S = q k^T for the n_rep query heads of the group, f32, times sm_scale;
//     with quant_bits int8 / fp8 the per-tile codes of kernel 1 (q, k and v
//     per tile, P at the fixed scale 1/127 for int8 and per tile for fp8;
//     int8 products are exact in f32 sums);
//   - the mask cols < t with NEG_INF = -1e30 and the m_safe / corr online
//     softmax of the reference; a row's P sum is taken as p[kk] + p[kk+32]
//     per lane and then a butterfly over the warp (the plain version
//     repeats that order);
//   - when the block is complete, phi(q) phi(k)^T v and its row sum go into
//     lnum / lden from the same resident tiles (phi = softmax over Dh).
// The finalize reads h_tot once: o_l = (phi(q) h_tot - lnum) / (phi(q) z_tot
// - lden) with the 1e-4 * den_tot + 1e-12 threshold, a_eff = 1 where the
// complement is empty, and the sigmoid combine.  A row whose entries are all
// invalid writes the defined output of the reference (o_s = 0).
// Products and sums that the reference rounds separately are written with
// __fmul_rn / __fadd_rn so that nvcc does not contract them into FMAs.
//
// Bound (qwen3-14b, 4 slots): each block moves K_sel pages of K and V
// (26 x 2 x 16 KiB in bf16), h_tot (64 KiB) and q / o; about 0.9 MiB per
// block, 29 MiB per layer, ~9 us at 3.35 TB/s, and a few MFLOP: bound by
// bytes.  This first design runs on CUDA cores (M = n_rep = 5 rows leaves
// tensor-core fragments mostly empty) with one block per (slot, KV head):
// 32 blocks fill a quarter of the 132 SMs.  Splitting K_sel across blocks
// (flash-decoding, with lnum / lden combined as well) is left for later.
//
// dense_decode: one block per (slot x KV head, window row), the GQA group's
// n_rep rows together.  No router: the block walks, in ascending order, only
// the logical pages its row can see, computed from the row length t (its own
// token included), the sliding window and the prefix: the prefix pages
// [0, ceil(prefix_len / bk)) when a window is set, then
// [floor(max(t - window, 0) / bk), ceil(t / bk)).  A wholly masked page
// leaves the online softmax unchanged, so skipping the others is exact; no
// entry of the page table past the row's length is read.  Per page, as in
// sla2_decode: K / V tiles in shared memory (dequantised under kv_quant),
// S = q k^T (the QAT tiles under quant_bits), the position mask cols < t and,
// with a window, cols >= t - window | cols < prefix_len, the same online
// softmax and P sum order, acc = acc * corr + P V.  The next page's raw K / V
// are loaded into registers while the current page is computed.  A row that
// sees nothing writes acc / max(l, 1e-20) = 0.
// Bound: every visible K / V byte read once (the 8192-token prompt of the
// qwen3-14b run: 129 pages x 2 x 16 KiB per KV head in bf16); a few MFLOP.
// Bytes-bound; the first design runs on CUDA cores with one block per row
// and no split of the pages across blocks (flash-decoding is left for later).
//
// paged_prefill: one block per (64-row tile of the n_rep * C stacked query
// rows, KV head).  Stacked row r is query head h * n_rep + r / C at chunk
// position offset + r % C.  The block loops in ascending order over the
// pages the reference visits (p * bk < offset + C, less the pages wholly
// below the window start unless inside the prefix) and skips those its own
// rows cannot see at all; a wholly masked page leaves the online-softmax
// state unchanged, so skipping it is exact.  The mask is rows >= cols, then
// cols >= rows - window + 1, then | cols < prefix_len, as in the reference.
// Each thread keeps a 4 x (Dh / 16) tile of the output in registers; Q.K^T
// and P.V both run as f32 FMA on CUDA cores (P stays f32, as the reference
// keeps it).  Bound: 4 H C keys Dh operations; bf16 tensor cores would be
// the fast path for Q.K^T, left for later.
// No --use_fast_math: it would change expf and the divisions.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DMAX = 128;               // largest head dim
constexpr int BKMAX = 64;               // largest block_k (page size)
constexpr int RMAX = 16;                // largest n_rep
constexpr int NT = 256;                 // threads per block
constexpr int NWARP = NT / 32;
constexpr float NEG_INF = -1e30f;
constexpr float HALF_NEG = -5e29f;      // NEG_INF * 0.5

enum { Q_NONE = 0, Q_INT8 = 1, Q_FP8 = 2 };
enum { P_F32 = 0, P_BF16 = 1, P_I8 = 2, P_E4M3 = 3 };

__device__ __forceinline__ float ldf(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float ldf(const int8_t* p, size_t i) {
  return (float)p[i];
}
__device__ __forceinline__ float ldf(const __nv_fp8_e4m3* p, size_t i) {
  return static_cast<float>(p[i]);
}
__device__ __forceinline__ float tof(float x) { return x; }
__device__ __forceinline__ float tof(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float tof(int8_t x) { return (float)x; }
__device__ __forceinline__ float tof(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

// Max over the block; every thread must call it.
__device__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < NWARP; ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Butterfly sum over the warp: every lane ends with the same value, the
// sum (v_i + v_{i+16}), then halves of 8, 4, 2, 1 (commutativity makes the
// lanes agree bit for bit).
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float tile_scale(int quant, float amax) {
  return quant == Q_INT8 ? fmaxf(amax / 127.0f, 1e-8f)
                         : fmaxf(amax / 448.0f, 1e-12f);
}

__device__ __forceinline__ float code(int quant, float x, float s) {
  if (quant == Q_INT8) return fminf(fmaxf(rintf(x / s), -127.0f), 127.0f);
  return static_cast<float>(__nv_fp8_e4m3(x / s));   // RNE, saturating
}

// Softmax over Dh of row `src` (stride 1) into `dst`, one warp per row:
// exp(x - max) / sum, as phi computes it.
__device__ __forceinline__ void warp_softmax(const float* src, float* dst,
                                             int dh, int lane) {
  float x[DMAX / 32];
  float mx = NEG_INF;
#pragma unroll
  for (int i = 0; i < DMAX / 32; ++i) {
    const int d = lane + 32 * i;
    x[i] = d < dh ? src[d] : NEG_INF;
    mx = fmaxf(mx, x[i]);
  }
  mx = warp_max(mx);
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < DMAX / 32; ++i) {
    const int d = lane + 32 * i;
    x[i] = d < dh ? expf(x[i] - mx) : 0.0f;
    sum = __fadd_rn(sum, x[i]);
  }
  sum = warp_sum(sum);
#pragma unroll
  for (int i = 0; i < DMAX / 32; ++i) {
    const int d = lane + 32 * i;
    if (d < dh) dst[d] = x[i] / sum;
  }
}

// ===========================================================================
// sla2_decode
// ===========================================================================

struct DecodeLayout {
  size_t qv, qc, qf, kv, kc, kf, vv, vc, sc, ls, red, row, total;
};

__host__ __device__ inline DecodeLayout decode_layout(int n_rep, int bk,
                                                      int dh) {
  DecodeLayout L;
  const size_t kst = dh + 1;            // odd stride: conflict-free rows
  size_t off = 0;                       // in floats
  L.qv = off;  off += (size_t)n_rep * dh;
  L.qc = off;  off += (size_t)n_rep * dh;
  L.qf = off;  off += (size_t)n_rep * dh;
  L.kv = off;  off += (size_t)bk * kst;
  L.kc = off;  off += (size_t)bk * kst;
  L.kf = off;  off += (size_t)bk * kst;
  L.vv = off;  off += (size_t)bk * dh;
  L.vc = off;  off += (size_t)bk * dh;
  L.sc = off;  off += (size_t)n_rep * (bk + 1);
  L.ls = off;  off += (size_t)n_rep * (bk + 1);
  L.red = off; off += 32;
  L.row = off; off += 4 * RMAX;         // m, l, corr, lden per row
  L.total = off * sizeof(float);
  return L;
}

template <typename QT, typename PT>
__global__ void __launch_bounds__(NT)
sla2_decode_kernel(const QT* __restrict__ q, const PT* __restrict__ kp,
                   const PT* __restrict__ vp, const float* __restrict__ kscale,
                   const float* __restrict__ vscale,
                   const int* __restrict__ phys, const int* __restrict__ jlog,
                   const int* __restrict__ valid,
                   const int* __restrict__ comp, const int* __restrict__ tnew,
                   const float* __restrict__ htot,
                   const float* __restrict__ ztot,
                   const float* __restrict__ alpha, float* __restrict__ o,
                   int W, int hkv, int n_rep, int dh, int bk, int k_sel,
                   int quant, int n_pages, float sm_scale) {
  extern __shared__ __align__(16) float sm[];
  const DecodeLayout L = decode_layout(n_rep, bk, dh);
  float* qv = sm + L.qv;                // q values, [n_rep][dh]
  float* qc = sm + L.qc;                // q codes (QAT)
  float* qf = sm + L.qf;                // phi(q)
  float* kv = sm + L.kv;                // k values, [bk][dh + 1]
  float* kc = sm + L.kc;                // k codes (QAT)
  float* kf = sm + L.kf;                // phi(k)
  float* vv = sm + L.vv;                // v values, [bk][dh]
  float* vc = sm + L.vc;                // v codes (QAT)
  float* sc = sm + L.sc;                // scores, then P (codes), [n_rep][bk + 1]
  float* lsc = sm + L.ls;               // phi(q) phi(k)^T, [n_rep][bk + 1]
  float* red = sm + L.red;
  float* m_r = sm + L.row;              // per row: m, l, corr, lden
  float* l_r = m_r + RMAX;
  float* c_r = l_r + RMAX;
  float* d_r = c_r + RMAX;

  const int g = blockIdx.x;             // slot * hkv + kv head
  const int w = blockIdx.y;             // window row
  const int b = g / hkv, head = g - b * hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kst = dh + 1, sst = bk + 1;
  const size_t gw = (size_t)g * W + w;
  const int t = tnew[(size_t)b * W + w];
  const int nq = n_rep * dh;

  // ---- q: values, phi(q), per-tile codes ----
  const QT* qrow = q + gw * nq;
  float amax = 0.0f;
  for (int e = tid; e < nq; e += NT) {
    const float x = ldf(qrow, e);
    qv[e] = x;
    amax = fmaxf(amax, fabsf(x));
  }
  if (tid < RMAX) {
    m_r[tid] = NEG_INF;
    l_r[tid] = 0.0f;
    c_r[tid] = 1.0f;
    d_r[tid] = 0.0f;
  }
  float q_scale = 1.0f;
  if (quant != Q_NONE) q_scale = tile_scale(quant, block_max(amax, red));
  else __syncthreads();
  for (int r = warp; r < n_rep; r += NWARP)
    warp_softmax(qv + r * dh, qf + r * dh, dh, lane);
  if (quant != Q_NONE)
    for (int e = tid; e < nq; e += NT) qc[e] = code(quant, qv[e], q_scale);

  // each thread owns the (row, col) pairs e = tid + NT * i of the output
  constexpr int PAIRS = RMAX * DMAX / NT;
  float acc[PAIRS], lnum[PAIRS];
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) acc[i] = lnum[i] = 0.0f;

  const int* ph_row = phys + gw * k_sel;
  const int* jl_row = jlog + gw * k_sel;
  const int* va_row = valid + gw * k_sel;
  const int* co_row = comp + gw * k_sel;
  const int ntile = bk * dh;

  for (int jj = 0; jj < k_sel; ++jj) {
    const int ph = ph_row[jj];
    if (va_row[jj] != 1 || ph < 0 || ph >= n_pages) continue;   // uniform
    const int j = jl_row[jj];
    const bool cm = co_row[jj] == 1;
    __syncthreads();                    // previous tiles no longer read

    // ---- K and V tiles, dequantised codes * row scale ----
    const size_t pbase = ((size_t)ph * hkv + head) * (size_t)ntile;
    const float* ksr = kscale ? kscale + ((size_t)ph * hkv + head) * bk : nullptr;
    const float* vsr = vscale ? vscale + ((size_t)ph * hkv + head) * bk : nullptr;
    float kmax = 0.0f, vmax = 0.0f;
    for (int e = tid; e < ntile; e += NT) {
      const int row = e / dh, col = e - row * dh;
      float kx = ldf(kp, pbase + e), vx = ldf(vp, pbase + e);
      if (ksr) kx = __fmul_rn(kx, ksr[row]);
      if (vsr) vx = __fmul_rn(vx, vsr[row]);
      kv[row * kst + col] = kx;
      vv[e] = vx;
      kmax = fmaxf(kmax, fabsf(kx));
      vmax = fmaxf(vmax, fabsf(vx));
    }
    float k_scale = 1.0f, v_scale = 1.0f;
    if (quant != Q_NONE) {
      k_scale = tile_scale(quant, block_max(kmax, red));
      v_scale = tile_scale(quant, block_max(vmax, red));
      for (int e = tid; e < ntile; e += NT) {
        const int row = e / dh, col = e - row * dh;
        kc[row * kst + col] = code(quant, kv[row * kst + col], k_scale);
        vc[e] = code(quant, vv[e], v_scale);
      }
    } else {
      __syncthreads();
    }
    if (cm)
      for (int r = warp; r < bk; r += NWARP)
        warp_softmax(kv + r * kst, kf + r * kst, dh, lane);
    __syncthreads();

    // ---- scores (and phi(q) phi(k)^T) for the n_rep x bk tile ----
    const float* qa = quant != Q_NONE ? qc : qv;
    const float* ka = quant != Q_NONE ? kc : kv;
    const float qk = __fmul_rn(q_scale, k_scale);
    for (int e = tid; e < n_rep * bk; e += NT) {
      const int r = e / bk, kk = e - r * bk;
      const float* qr = qa + r * dh;
      const float* kr = ka + kk * kst;
      float s = 0.0f;
      for (int d = 0; d < dh; ++d) s = fmaf(qr[d], kr[d], s);
      s = quant != Q_NONE ? __fmul_rn(__fmul_rn(s, qk), sm_scale)
                          : __fmul_rn(s, sm_scale);
      sc[r * sst + kk] = j * bk + kk < t ? s : NEG_INF;
      if (cm) {
        const float* fr = qf + r * dh;
        const float* gr = kf + kk * kst;
        float x = 0.0f;
        for (int d = 0; d < dh; ++d) x = fmaf(fr[d], gr[d], x);
        lsc[r * sst + kk] = x;
      }
    }
    __syncthreads();

    // ---- online softmax, one warp per row ----
    for (int r = warp; r < n_rep; r += NWARP) {
      float* srow = sc + r * sst;
      const float s0 = lane < bk ? srow[lane] : NEG_INF;
      const float s1 = lane + 32 < bk ? srow[lane + 32] : NEG_INF;
      const float m_prev = m_r[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float m_safe = m_new > HALF_NEG ? m_new : 0.0f;
      const float p0 = s0 > HALF_NEG ? expf(s0 - m_safe) : 0.0f;
      const float p1 = s1 > HALF_NEG ? expf(s1 - m_safe) : 0.0f;
      const float psum = warp_sum(__fadd_rn(p0, p1));
      const float corr = expf((m_prev > HALF_NEG ? m_prev : m_safe) - m_safe);
      if (lane < bk) srow[lane] = quant == Q_INT8 ? rintf(__fmul_rn(p0, 127.0f)) : p0;
      if (lane + 32 < bk)
        srow[lane + 32] = quant == Q_INT8 ? rintf(__fmul_rn(p1, 127.0f)) : p1;
      if (cm) {
        const float* lrow = lsc + r * sst;
        const float x0 = lane < bk ? lrow[lane] : 0.0f;
        const float x1 = lane + 32 < bk ? lrow[lane + 32] : 0.0f;
        const float lsum = warp_sum(__fadd_rn(x0, x1));
        if (lane == 0) d_r[r] = __fadd_rn(d_r[r], lsum);
      }
      if (lane == 0) {
        l_r[r] = __fadd_rn(__fmul_rn(l_r[r], corr), psum);
        m_r[r] = m_new;
        c_r[r] = corr;
      }
    }
    __syncthreads();
    float pvs = 1.0f;
    if (quant == Q_INT8) {
      pvs = __fmul_rn((float)(1.0 / 127.0), v_scale);
    } else if (quant == Q_FP8) {
      float pmax = 0.0f;
      for (int e = tid; e < n_rep * bk; e += NT) {
        const int r = e / bk, kk = e - r * bk;
        pmax = fmaxf(pmax, fabsf(sc[r * sst + kk]));
      }
      const float p_scale = tile_scale(Q_FP8, block_max(pmax, red));
      for (int e = tid; e < n_rep * bk; e += NT) {
        const int r = e / bk, kk = e - r * bk;
        sc[r * sst + kk] = code(Q_FP8, sc[r * sst + kk], p_scale);
      }
      pvs = __fmul_rn(p_scale, v_scale);
      __syncthreads();
    }

    // ---- acc = acc * corr + P V; lnum += (phi(q) phi(k)^T) V ----
    const float* va = quant != Q_NONE ? vc : vv;
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int e = tid + NT * i;
      if (e >= nq) break;
      const int r = e / dh, c = e - r * dh;
      const float* prow = sc + r * sst;
      float x = 0.0f;
      for (int kk = 0; kk < bk; ++kk) x = fmaf(prow[kk], va[kk * dh + c], x);
      if (quant != Q_NONE) x = __fmul_rn(x, pvs);
      acc[i] = __fadd_rn(__fmul_rn(acc[i], c_r[r]), x);
      if (cm) {
        const float* lrow = lsc + r * sst;
        float y = 0.0f;
        for (int kk = 0; kk < bk; ++kk) y = fmaf(lrow[kk], vv[kk * dh + c], y);
        lnum[i] = __fadd_rn(lnum[i], y);
      }
    }
  }

  // ---- finalize: linear complement from h_tot / z_tot, alpha combine ----
  __syncthreads();
  const float* z = ztot + gw * dh;
  for (int r = warp; r < n_rep; r += NWARP) {
    float x = 0.0f;
    for (int d = lane; d < DMAX; d += 32)
      x = __fadd_rn(x, d < dh ? __fmul_rn(qf[r * dh + d], z[d]) : 0.0f);
    x = warp_sum(x);
    if (lane == 0) c_r[r] = x;          // den_tot (corr is no longer needed)
  }
  __syncthreads();
  const float* h = htot + gw * (size_t)dh * dh;
  float* orow = o + gw * nq;
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    const int e = tid + NT * i;
    if (e >= nq) break;
    const int r = e / dh, c = e - r * dh;
    const float* fr = qf + r * dh;
    float num = 0.0f;
    for (int d = 0; d < dh; ++d) num = fmaf(fr[d], h[(size_t)d * dh + c], num);
    num = __fadd_rn(num, -lnum[i]);
    const float den_tot = c_r[r];
    float den = __fadd_rn(den_tot, -d_r[r]);
    den = den > __fadd_rn(__fmul_rn(1e-4f, den_tot), 1e-12f) ? den : 0.0f;
    const float o_l = den > 0.0f ? num / fmaxf(den, 1e-12f) : 0.0f;
    const float a = 1.0f / (1.0f + expf(-alpha[(size_t)g * n_rep + r]));
    const float a_eff = den > 0.0f ? a : 1.0f;
    const float o_s = acc[i] / fmaxf(l_r[r], 1e-20f);
    orow[e] = __fadd_rn(__fmul_rn(a_eff, o_s),
                        __fmul_rn(__fadd_rn(1.0f, -a_eff), o_l));
  }
}

// ===========================================================================
// dense_decode
// ===========================================================================

struct DenseLayout {
  size_t qv, qc, kv, kc, vv, vc, sc, red, row, total;
};

__host__ __device__ inline DenseLayout dense_layout(int n_rep, int bk,
                                                    int dh) {
  DenseLayout L;
  const size_t kst = dh + 1;            // odd stride: conflict-free rows
  size_t off = 0;                       // in floats
  L.qv = off;  off += (size_t)n_rep * dh;
  L.qc = off;  off += (size_t)n_rep * dh;
  L.kv = off;  off += (size_t)bk * kst;
  L.kc = off;  off += (size_t)bk * kst;
  L.vv = off;  off += (size_t)bk * dh;
  L.vc = off;  off += (size_t)bk * dh;
  L.sc = off;  off += (size_t)n_rep * (bk + 1);
  L.red = off; off += 32;
  L.row = off; off += 3 * RMAX;         // m, l, corr per row
  L.total = off * sizeof(float);
  return L;
}

constexpr int LPT = BKMAX * DMAX / NT;  // tile elements a thread loads

// Start the loads of physical page ph's K and V tiles into registers (the
// values are first read when the next page is stored to shared memory, so
// the loads overlap this page's compute).  Returns ph, or -1 for an id
// outside the pool (nothing loaded).
template <typename PT>
__device__ __forceinline__ int fetch_page(const PT* __restrict__ kp,
                                          const PT* __restrict__ vp, int ph,
                                          int n_pages, int hkv, int head,
                                          int ntile, int tid, PT (&kr)[LPT],
                                          PT (&vr)[LPT]) {
  if (ph < 0 || ph >= n_pages) return -1;
  const size_t pbase = ((size_t)ph * hkv + head) * (size_t)ntile;
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int e = tid + NT * k;
    if (e < ntile) {
      kr[k] = kp[pbase + e];
      vr[k] = vp[pbase + e];
    }
  }
  return ph;
}

template <typename QT, typename PT>
__global__ void __launch_bounds__(NT)
dense_decode_kernel(const QT* __restrict__ q, const PT* __restrict__ kp,
                    const PT* __restrict__ vp,
                    const float* __restrict__ kscale,
                    const float* __restrict__ vscale,
                    const int* __restrict__ table,
                    const int* __restrict__ tnew, float* __restrict__ o,
                    int W, int hkv, int n_rep, int dh, int bk, int max_p,
                    int window, int prefix_len, int quant, int n_pages,
                    float sm_scale) {
  extern __shared__ __align__(16) float sm[];
  const DenseLayout L = dense_layout(n_rep, bk, dh);
  float* qv = sm + L.qv;                // q values, [n_rep][dh]
  float* qc = sm + L.qc;                // q codes (QAT)
  float* kv = sm + L.kv;                // k values, [bk][dh + 1]
  float* kc = sm + L.kc;                // k codes (QAT)
  float* vv = sm + L.vv;                // v values, [bk][dh]
  float* vc = sm + L.vc;                // v codes (QAT)
  float* sc = sm + L.sc;                // scores, then P (codes), [n_rep][bk + 1]
  float* red = sm + L.red;
  float* m_r = sm + L.row;              // per row: m, l, corr
  float* l_r = m_r + RMAX;
  float* c_r = l_r + RMAX;

  const int g = blockIdx.x;             // slot * hkv + kv head
  const int w = blockIdx.y;             // window row
  const int b = g / hkv, head = g - b * hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kst = dh + 1, sst = bk + 1;
  const size_t gw = (size_t)g * W + w;
  const int t = tnew[(size_t)b * W + w];
  const int nq = n_rep * dh;
  const int ntile = bk * dh;

  // ---- q: values, per-tile codes ----
  const QT* qrow = q + gw * nq;
  float amax = 0.0f;
  for (int e = tid; e < nq; e += NT) {
    const float x = ldf(qrow, e);
    qv[e] = x;
    amax = fmaxf(amax, fabsf(x));
  }
  if (tid < RMAX) {
    m_r[tid] = NEG_INF;
    l_r[tid] = 0.0f;
    c_r[tid] = 1.0f;
  }
  float q_scale = 1.0f;
  if (quant != Q_NONE) q_scale = tile_scale(quant, block_max(amax, red));
  else __syncthreads();
  if (quant != Q_NONE)
    for (int e = tid; e < nq; e += NT) qc[e] = code(quant, qv[e], q_scale);

  // ---- the pages this row can see, ascending: the prefix pages (with a
  // window), then [floor(max(t - window, 0) / bk), ceil(t / bk)) ----
  const int hi = min(max_p, (t + bk - 1) / bk);
  int n_pref = 0, lo = 0;
  if (window >= 0) {
    lo = max(t - window, 0) / bk;
    n_pref = min(hi, (prefix_len + bk - 1) / bk);
  }
  const int lo2 = max(lo, n_pref);
  const int n_vis = n_pref + max(0, hi - lo2);
  const int* trow = table + (size_t)b * max_p;
  auto page_of = [&](int i) { return i < n_pref ? i : lo2 + (i - n_pref); };

  // the next page's raw K/V stay in registers while this page is computed
  PT kr[LPT], vr[LPT];
  auto fetch = [&](int i) {
    return fetch_page(kp, vp, trow[page_of(i)], n_pages, hkv, head, ntile,
                      tid, kr, vr);
  };

  constexpr int PAIRS = RMAX * DMAX / NT;
  float acc[PAIRS];
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) acc[i] = 0.0f;

  int ph_next = n_vis > 0 ? fetch(0) : -1;
  for (int i = 0; i < n_vis; ++i) {
    const int j = page_of(i);
    const int ph = ph_next;
    __syncthreads();                    // previous tiles no longer read
    if (ph < 0) {                       // uniform: an unmapped entry
      if (i + 1 < n_vis) ph_next = fetch(i + 1);
      continue;
    }

    // ---- K and V tiles from the registers, dequantised codes * row scale
    const float* ksr = kscale ? kscale + ((size_t)ph * hkv + head) * bk : nullptr;
    const float* vsr = vscale ? vscale + ((size_t)ph * hkv + head) * bk : nullptr;
    float kmax = 0.0f, vmax = 0.0f;
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int e = tid + NT * k;
      if (e < ntile) {
        const int row = e / dh, col = e - row * dh;
        float kx = tof(kr[k]), vx = tof(vr[k]);
        if (ksr) kx = __fmul_rn(kx, ksr[row]);
        if (vsr) vx = __fmul_rn(vx, vsr[row]);
        kv[row * kst + col] = kx;
        vv[e] = vx;
        kmax = fmaxf(kmax, fabsf(kx));
        vmax = fmaxf(vmax, fabsf(vx));
      }
    }
    if (i + 1 < n_vis) ph_next = fetch(i + 1);
    float k_scale = 1.0f, v_scale = 1.0f;
    if (quant != Q_NONE) {
      k_scale = tile_scale(quant, block_max(kmax, red));
      v_scale = tile_scale(quant, block_max(vmax, red));
      for (int e = tid; e < ntile; e += NT) {
        const int row = e / dh, col = e - row * dh;
        kc[row * kst + col] = code(quant, kv[row * kst + col], k_scale);
        vc[e] = code(quant, vv[e], v_scale);
      }
    }
    __syncthreads();

    // ---- scores for the n_rep x bk tile, with the row's position mask ----
    const float* qa = quant != Q_NONE ? qc : qv;
    const float* ka = quant != Q_NONE ? kc : kv;
    const float qk = __fmul_rn(q_scale, k_scale);
    for (int e = tid; e < n_rep * bk; e += NT) {
      const int r = e / bk, kk = e - r * bk;
      const float* qr = qa + r * dh;
      const float* kr_ = ka + kk * kst;
      float s = 0.0f;
      for (int d = 0; d < dh; ++d) s = fmaf(qr[d], kr_[d], s);
      s = quant != Q_NONE ? __fmul_rn(__fmul_rn(s, qk), sm_scale)
                          : __fmul_rn(s, sm_scale);
      const int col = j * bk + kk;
      bool vis = col < t;
      if (window >= 0) vis = vis && (col >= t - window || col < prefix_len);
      sc[r * sst + kk] = vis ? s : NEG_INF;
    }
    __syncthreads();

    // ---- online softmax, one warp per row ----
    for (int r = warp; r < n_rep; r += NWARP) {
      float* srow = sc + r * sst;
      const float s0 = lane < bk ? srow[lane] : NEG_INF;
      const float s1 = lane + 32 < bk ? srow[lane + 32] : NEG_INF;
      const float m_prev = m_r[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float m_safe = m_new > HALF_NEG ? m_new : 0.0f;
      const float p0 = s0 > HALF_NEG ? expf(s0 - m_safe) : 0.0f;
      const float p1 = s1 > HALF_NEG ? expf(s1 - m_safe) : 0.0f;
      const float psum = warp_sum(__fadd_rn(p0, p1));
      const float corr = expf((m_prev > HALF_NEG ? m_prev : m_safe) - m_safe);
      if (lane < bk) srow[lane] = quant == Q_INT8 ? rintf(__fmul_rn(p0, 127.0f)) : p0;
      if (lane + 32 < bk)
        srow[lane + 32] = quant == Q_INT8 ? rintf(__fmul_rn(p1, 127.0f)) : p1;
      if (lane == 0) {
        l_r[r] = __fadd_rn(__fmul_rn(l_r[r], corr), psum);
        m_r[r] = m_new;
        c_r[r] = corr;
      }
    }
    __syncthreads();
    float pvs = 1.0f;
    if (quant == Q_INT8) {
      pvs = __fmul_rn((float)(1.0 / 127.0), v_scale);
    } else if (quant == Q_FP8) {
      float pmax = 0.0f;
      for (int e = tid; e < n_rep * bk; e += NT) {
        const int r = e / bk, kk = e - r * bk;
        pmax = fmaxf(pmax, fabsf(sc[r * sst + kk]));
      }
      const float p_scale = tile_scale(Q_FP8, block_max(pmax, red));
      for (int e = tid; e < n_rep * bk; e += NT) {
        const int r = e / bk, kk = e - r * bk;
        sc[r * sst + kk] = code(Q_FP8, sc[r * sst + kk], p_scale);
      }
      pvs = __fmul_rn(p_scale, v_scale);
      __syncthreads();
    }

    // ---- acc = acc * corr + P V ----
    const float* va = quant != Q_NONE ? vc : vv;
#pragma unroll
    for (int i2 = 0; i2 < PAIRS; ++i2) {
      const int e = tid + NT * i2;
      if (e >= nq) break;
      const int r = e / dh, c = e - r * dh;
      const float* prow = sc + r * sst;
      float x = 0.0f;
      for (int kk = 0; kk < bk; ++kk) x = fmaf(prow[kk], va[kk * dh + c], x);
      if (quant != Q_NONE) x = __fmul_rn(x, pvs);
      acc[i2] = __fadd_rn(__fmul_rn(acc[i2], c_r[r]), x);
    }
  }

  // ---- o = acc / max(l, 1e-20): a row that saw nothing writes 0 ----
  __syncthreads();
  float* orow = o + gw * nq;
#pragma unroll
  for (int i2 = 0; i2 < PAIRS; ++i2) {
    const int e = tid + NT * i2;
    if (e >= nq) break;
    orow[e] = acc[i2] / fmaxf(l_r[e / dh], 1e-20f);
  }
}

// ===========================================================================
// paged_prefill
// ===========================================================================

constexpr int TM = 64;                  // stacked query rows per block

struct PrefillLayout {
  size_t q, k, v, p, total;
};

__host__ __device__ inline PrefillLayout prefill_layout(int bk, int dh) {
  PrefillLayout L;
  size_t off = 0;                       // in floats
  L.q = off; off += (size_t)TM * (dh + 1);
  L.k = off; off += (size_t)bk * (dh + 1);
  L.v = off; off += (size_t)bk * dh;
  L.p = off; off += (size_t)TM * (bk + 1);
  L.total = off * sizeof(float);
  return L;
}

template <typename QT, typename PT>
__global__ void __launch_bounds__(NT)
paged_prefill_kernel(const QT* __restrict__ q, const PT* __restrict__ kp,
                     const PT* __restrict__ vp,
                     const float* __restrict__ kscale,
                     const float* __restrict__ vscale,
                     const int* __restrict__ page_row, float* __restrict__ o,
                     int c, int n_rep, int dh, int bk, int max_p, int offset,
                     int window, int prefix_len, int n_pages, int hkv,
                     float sm_scale) {
  extern __shared__ __align__(16) float sm[];
  const PrefillLayout L = prefill_layout(bk, dh);
  float* qs = sm + L.q;                 // [TM][dh + 1]
  float* kt = sm + L.k;                 // [bk][dh + 1]
  float* vt = sm + L.v;                 // [bk][dh]
  float* pt = sm + L.p;                 // [TM][bk + 1]
  const int tile = blockIdx.x, head = blockIdx.y;
  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;   // rows 4 rg + i; keys / cols cg + 16 j
  const int nrows = n_rep * c;
  const int r0 = tile * TM;
  const int qst = dh + 1, pst = bk + 1;
  const int nk = bk / 16, nc = dh / 16;

  // ---- Q tile (stacked rows r0 .. r0 + 63 of this KV head) ----
  const QT* qh = q + (size_t)head * nrows * dh;
  for (int e = tid; e < TM * dh; e += NT) {
    const int r = e / dh, col = e - r * dh;
    qs[r * qst + col] = r0 + r < nrows ? ldf(qh, (size_t)(r0 + r) * dh + col) : 0.0f;
  }
  int pos[4];
  int pos_min = 1 << 30, pos_max = -1;
  for (int r = 0; r < TM && r0 + r < nrows; ++r) {
    const int ps = offset + (r0 + r) % c;
    pos_min = min(pos_min, ps);
    pos_max = max(pos_max, ps);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) pos[i] = offset + (r0 + 4 * rg + i) % c;

  float acc[4][DMAX / 16], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int jc = 0; jc < DMAX / 16; ++jc) acc[i][jc] = 0.0f;
  }

  for (int p = 0; p < max_p && p * bk < offset + c; ++p) {
    const bool in_prefix = p * bk < prefix_len;
    if (window >= 0 && (p + 1) * bk <= offset - window + 1 && !in_prefix)
      continue;                         // the reference's page flags
    // pages no row of this tile can see (exact to skip)
    if (p * bk > pos_max && !in_prefix) continue;
    if (window >= 0 && (p + 1) * bk <= pos_min - window + 1 && !in_prefix)
      continue;
    const int ph = page_row[p];
    if (ph < 0 || ph >= n_pages) continue;
    __syncthreads();                    // previous tiles no longer read
    const size_t pbase = ((size_t)ph * hkv + head) * (size_t)bk * dh;
    const float* ksr = kscale ? kscale + ((size_t)ph * hkv + head) * bk : nullptr;
    const float* vsr = vscale ? vscale + ((size_t)ph * hkv + head) * bk : nullptr;
    for (int e = tid; e < bk * dh; e += NT) {
      const int row = e / dh, col = e - row * dh;
      float kx = ldf(kp, pbase + e), vx = ldf(vp, pbase + e);
      if (ksr) kx = __fmul_rn(kx, ksr[row]);
      if (vsr) vx = __fmul_rn(vx, vsr[row]);
      kt[row * qst + col] = kx;
      vt[e] = vx;
    }
    __syncthreads();

    // ---- S for rows 4 rg + i, keys cg + 16 jk ----
    float s[4][BKMAX / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jk = 0; jk < BKMAX / 16; ++jk) s[i][jk] = 0.0f;
    for (int d = 0; d < dh; ++d) {
      float a[4], bb[BKMAX / 16];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(4 * rg + i) * qst + d];
#pragma unroll
      for (int jk = 0; jk < BKMAX / 16; ++jk)
        bb[jk] = jk < nk ? kt[(cg + 16 * jk) * qst + d] : 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jk = 0; jk < BKMAX / 16; ++jk) s[i][jk] = fmaf(a[i], bb[jk], s[i][jk]);
    }

    // ---- mask, online softmax (a row lives on 16 lanes), P to smem ----
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int jk = 0; jk < BKMAX / 16; ++jk) {
        if (jk >= nk) continue;
        const int col = p * bk + cg + 16 * jk;
        bool vis = pos[i] >= col;
        if (window >= 0) vis = vis && col >= pos[i] - window + 1;
        if (prefix_len) vis = vis || col < prefix_len;
        s[i][jk] = vis ? __fmul_rn(s[i][jk], sm_scale) : NEG_INF;
        mx = fmaxf(mx, s[i][jk]);
      }
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = m_new > HALF_NEG ? m_new : 0.0f;
      float ps = 0.0f;
#pragma unroll
      for (int jk = 0; jk < BKMAX / 16; ++jk) {
        if (jk >= nk) continue;
        const float pr = s[i][jk] > HALF_NEG ? expf(s[i][jk] - m_safe) : 0.0f;
        pt[(4 * rg + i) * pst + cg + 16 * jk] = pr;
        ps = __fadd_rn(ps, pr);
      }
      for (int off = 8; off > 0; off >>= 1)
        ps = __fadd_rn(ps, __shfl_xor_sync(0xffffffffu, ps, off));
      corr[i] = expf((m[i] > HALF_NEG ? m[i] : m_safe) - m_safe);
      l[i] = __fadd_rn(__fmul_rn(l[i], corr[i]), ps);
      m[i] = m_new;
    }
    __syncthreads();

    // ---- acc = acc * corr + P V for rows 4 rg + i, cols cg + 16 jc ----
    float x[4][DMAX / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jc = 0; jc < DMAX / 16; ++jc) x[i][jc] = 0.0f;
    for (int kk = 0; kk < bk; ++kk) {
      float a[4], bb[DMAX / 16];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = pt[(4 * rg + i) * pst + kk];
#pragma unroll
      for (int jc = 0; jc < DMAX / 16; ++jc)
        bb[jc] = jc < nc ? vt[kk * dh + cg + 16 * jc] : 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jc = 0; jc < DMAX / 16; ++jc) x[i][jc] = fmaf(a[i], bb[jc], x[i][jc]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jc = 0; jc < DMAX / 16; ++jc)
        acc[i][jc] = __fadd_rn(__fmul_rn(acc[i][jc], corr[i]), x[i][jc]);
  }

  // ---- o = acc / l_safe for the valid stacked rows ----
  float* oh = o + (size_t)head * nrows * dh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * rg + i;
    if (r >= nrows) continue;
    const float ls = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int jc = 0; jc < DMAX / 16; ++jc)
      if (jc < nc) oh[(size_t)r * dh + cg + 16 * jc] = acc[i][jc] / ls;
  }
}

// ===========================================================================
// launch
// ===========================================================================

struct DecodeArgs {
  const void *q, *kp, *vp, *ks, *vs, *phys, *jlog, *valid, *comp, *tnew,
      *h, *z, *alpha;
  void* o;
  int b, W, hkv, n_rep, dh, bk, k_sel, quant, n_pages;
  float sm_scale;
  cudaStream_t stream;
};

template <typename QT, typename PT>
int run_decode(const DecodeArgs& a) {
  const size_t smem = decode_layout(a.n_rep, a.bk, a.dh).total;
  auto kern = sla2_decode_kernel<QT, PT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.b * a.hkv, a.W);
  kern<<<grid, NT, smem, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const PT*>(a.kp),
      static_cast<const PT*>(a.vp), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.phys),
      static_cast<const int*>(a.jlog), static_cast<const int*>(a.valid),
      static_cast<const int*>(a.comp), static_cast<const int*>(a.tnew),
      static_cast<const float*>(a.h), static_cast<const float*>(a.z),
      static_cast<const float*>(a.alpha), static_cast<float*>(a.o), a.W,
      a.hkv, a.n_rep, a.dh, a.bk, a.k_sel, a.quant, a.n_pages, a.sm_scale);
  return (int)cudaGetLastError();
}

struct DenseArgs {
  const void *q, *kp, *vp, *ks, *vs, *table, *tnew;
  void* o;
  int b, W, hkv, n_rep, dh, bk, max_p, window, prefix_len, quant, n_pages;
  float sm_scale;
  cudaStream_t stream;
};

template <typename QT, typename PT>
int run_dense(const DenseArgs& a) {
  const size_t smem = dense_layout(a.n_rep, a.bk, a.dh).total;
  auto kern = dense_decode_kernel<QT, PT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.b * a.hkv, a.W);
  kern<<<grid, NT, smem, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const PT*>(a.kp),
      static_cast<const PT*>(a.vp), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.table),
      static_cast<const int*>(a.tnew), static_cast<float*>(a.o), a.W, a.hkv,
      a.n_rep, a.dh, a.bk, a.max_p, a.window, a.prefix_len, a.quant,
      a.n_pages, a.sm_scale);
  return (int)cudaGetLastError();
}

struct PrefillArgs {
  const void *q, *kp, *vp, *ks, *vs, *page_row;
  void* o;
  int h, c, n_rep, dh, bk, max_p, offset, window, prefix_len, n_pages, hkv;
  float sm_scale;
  cudaStream_t stream;
};

template <typename QT, typename PT>
int run_prefill(const PrefillArgs& a) {
  const size_t smem = prefill_layout(a.bk, a.dh).total;
  auto kern = paged_prefill_kernel<QT, PT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nrows = a.n_rep * a.c;
  const dim3 grid((nrows + TM - 1) / TM, a.hkv);
  kern<<<grid, NT, smem, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const PT*>(a.kp),
      static_cast<const PT*>(a.vp), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.page_row),
      static_cast<float*>(a.o), a.c, a.n_rep, a.dh, a.bk, a.max_p, a.offset,
      a.window, a.prefix_len, a.n_pages, a.hkv, a.sm_scale);
  return (int)cudaGetLastError();
}

template <typename QT>
int decode_pool(int pool, const DecodeArgs& a) {
  switch (pool) {
    case P_F32: return run_decode<QT, float>(a);
    case P_BF16: return run_decode<QT, __nv_bfloat16>(a);
    case P_I8: return run_decode<QT, int8_t>(a);
    case P_E4M3: return run_decode<QT, __nv_fp8_e4m3>(a);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename QT>
int dense_pool(int pool, const DenseArgs& a) {
  switch (pool) {
    case P_F32: return run_dense<QT, float>(a);
    case P_BF16: return run_dense<QT, __nv_bfloat16>(a);
    case P_I8: return run_dense<QT, int8_t>(a);
    case P_E4M3: return run_dense<QT, __nv_fp8_e4m3>(a);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename QT>
int prefill_pool(int pool, const PrefillArgs& a) {
  switch (pool) {
    case P_F32: return run_prefill<QT, float>(a);
    case P_BF16: return run_prefill<QT, __nv_bfloat16>(a);
    case P_I8: return run_prefill<QT, int8_t>(a);
    case P_E4M3: return run_prefill<QT, __nv_fp8_e4m3>(a);
  }
  return (int)cudaErrorInvalidValue;
}

bool shapes_ok(int dh, int bk, int n_rep) {
  return (dh == 64 || dh == 128) && bk % 16 == 0 && bk >= 16 &&
         bk <= BKMAX && n_rep >= 1 && n_rep <= RMAX;
}

}  // namespace

// C entries, bound with ctypes.  Each returns cudaGetLastError() after the
// launch (0 on success); the caller raises on anything else.
extern "C" int sla2_decode(const void* q, const void* kp, const void* vp,
                           const void* ks, const void* vs, const void* phys,
                           const void* jlog, const void* valid,
                           const void* comp, const void* tnew, const void* h,
                           const void* z, const void* alpha, void* o, int b,
                           int W, int hkv, int n_rep, int dh, int bk,
                           int k_sel, int quant, int q_bf16, int pool,
                           int n_pages, float sm_scale, void* stream) {
  if (!shapes_ok(dh, bk, n_rep) || quant < Q_NONE || quant > Q_FP8 ||
      (pool >= P_I8 && (ks == nullptr || vs == nullptr)))
    return (int)cudaErrorInvalidValue;
  const DecodeArgs a{q,  kp, vp,    ks,    vs, phys, jlog,  valid, comp,
                     tnew, h, z, alpha, o,  b,    W,     hkv,   n_rep,
                     dh, bk, k_sel, quant, n_pages, sm_scale,
                     static_cast<cudaStream_t>(stream)};
  return q_bf16 ? decode_pool<__nv_bfloat16>(pool, a) : decode_pool<float>(pool, a);
}

extern "C" int dense_decode(const void* q, const void* kp, const void* vp,
                            const void* ks, const void* vs, const void* table,
                            const void* tnew, void* o, int b, int W, int hkv,
                            int n_rep, int dh, int bk, int max_p, int window,
                            int prefix_len, int quant, int q_bf16, int pool,
                            int n_pages, float sm_scale, void* stream) {
  if (!shapes_ok(dh, bk, n_rep) || quant < Q_NONE || quant > Q_FP8 ||
      (pool >= P_I8 && (ks == nullptr || vs == nullptr)))
    return (int)cudaErrorInvalidValue;
  const DenseArgs a{q,     kp,    vp,         ks,    vs,      table,
                    tnew,  o,     b,          W,     hkv,     n_rep,
                    dh,    bk,    max_p,      window, prefix_len, quant,
                    n_pages, sm_scale, static_cast<cudaStream_t>(stream)};
  return q_bf16 ? dense_pool<__nv_bfloat16>(pool, a) : dense_pool<float>(pool, a);
}

extern "C" int paged_prefill(const void* q, const void* kp, const void* vp,
                             const void* ks, const void* vs,
                             const void* page_row, void* o, int h, int c,
                             int n_rep, int dh, int bk, int max_p, int offset,
                             int window, int prefix_len, int q_bf16, int pool,
                             int n_pages, int hkv, float sm_scale,
                             void* stream) {
  if (!shapes_ok(dh, bk, n_rep) || h != n_rep * hkv || offset % bk ||
      (pool >= P_I8 && (ks == nullptr || vs == nullptr)))
    return (int)cudaErrorInvalidValue;
  const PrefillArgs a{q,     kp,     vp,         ks,      vs,  page_row,
                      o,     h,      c,          n_rep,   dh,  bk,
                      max_p, offset, window,     prefix_len, n_pages, hkv,
                      sm_scale, static_cast<cudaStream_t>(stream)};
  return q_bf16 ? prefill_pool<__nv_bfloat16>(pool, a) : prefill_pool<float>(pool, a);
}
