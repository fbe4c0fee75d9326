// Paged decode attention of LM serving, hand-written for Hopper (sm_90a):
// the SLA2 paged decode (and its multi-row verify window) and the dense
// paged decode (and its verify window).  The chunked-prefill flash
// attention over the same pool is in paged_prefill.cu.
//
// Replaces (the Pallas TPU kernels):
//   sla2_decode   repro/kernels/sla2_decode_paged.py::_decode_kernel, via
//                 sla2_decode_fused (W = 1) and sla2_decode_verify (W > 1);
//   dense_decode  repro/kernels/sla2_decode_paged.py::_dense_decode_kernel,
//                 via dense_decode_fused (W = 1) and dense_decode_verify.
//
// The K/V cache is a pool of physical pages (P, Hkv, bk, Dh): f32 or bf16,
// or int8 / e4m3 codes with one f32 scale per token row (kv_quant), which
// are dequantised on load as codes * scale.
//
// sla2_decode computes, per (slot x KV head, window row), what the Pallas
// _decode_kernel computes: the row's K_sel routed entries in ascending jj,
// invalid ones skipped without loading anything (the trash page is never
// read); for each routed page S = q k^T for the n_rep query heads of the
// group (f32, times sm_scale; with quant_bits int8 / fp8 the per-tile codes
// of kernel 1), the mask cols < t with NEG_INF = -1e30, the m_safe / corr
// online softmax; for a complete block phi(q) phi(k)^T V and its row sum
// into lnum / lden (phi = softmax over Dh); then the finalize: o_l =
// (phi(q) h_tot - lnum) / (phi(q) z_tot - lden) with the 1e-4 * den_tot +
// 1e-12 threshold, a_eff = 1 where the complement is empty, and the sigmoid
// combine.  A row whose entries are all invalid writes the reference's
// defined output (o_s = 0).  A row's P sum is p[kk] + p[kk+32] per lane,
// then a butterfly over the warp (the plain versions repeat that order).
// Products and sums that the reference rounds separately are written with
// __fmul_rn / __fadd_rn so that nvcc does not contract them into FMAs.
//
// Bound (qwen3-14b, 4 slots, W 1): the distinct routed K / V pages (26 x 2
// x 16 KiB in bf16 per slot and KV head), h_tot (64 KiB a row) and q / o:
// ~29 MiB a layer, ~9 us at 3.35 TB/s, and a few MFLOP: bound by bytes, and
// by latency at this size: one block per row walking its 26 pages
// serially would put 32 blocks on 132 SMs.  Two kernels, selected by
// quant_bits (a selection by input, not a fallback on failure):
//
// sla2_decode_split_kernel + sla2_decode_combine_kernel (quant_bits none,
// the serving path): flash-decoding.  Grid (slot x KV head, window row,
// split); a split takes eps consecutive routed entries, eps chosen by the
// wrapper from the grid's size at one window row (about 8 blocks per SM,
// but at least 2 entries a split: at one, the combine's partials cost more
// than the extra blocks buy; 2 at the lm-serve shape, 13 splits).  The
// window width does not enter the choice: a row's sums depend on its
// splits, and a verify pass must compute each row bit for bit as the
// decode step does, or greedy speculative tokens drift from the plain
// decode's (a verify window with its own split size moved a full-width
// lm-spec token whose top-2 margin was 0.051).  Window rows stay in
// separate blocks: each row of a verify window routes its own pages
// (phys[b, h, w, :]), so a union across rows would buy little; pages that
// rows share come from L2.  Per split:
//   - its page-table entries and flags are read first (a warp ballot keeps
//     the valid ones, in order, in shared memory); a split with none
//     writes only its count, and the combine skips it;
//   - K / V pages flow through a 2-page cp.async ring of 16-byte loads in
//     their storage type (bf16, f32 or int8 / e4m3 codes with their row
//     scales); S reads a key's row in quads from a rotated start;
//   - the reference's mask and online softmax; a complete page's phi(k)
//     rows are formed by a warp each from the resident tile, their dots
//     with phi(q) a butterfly, and lnum / lden take phi(q) phi(k)^T V and
//     its row sum; under kv_quant the row scales multiply S's and P's
//     columns, (q Kc^T) ks and (P vs) Vc;
//   - the partials (acc, m, l, lnum, lden) per (row, head) go to f32
//     scratch.
// The combine (one block per slot x KV head and window row) rescales the
// softmax partials with the m > HALF_NEG guards of dense_combine_kernel
// (w_s = exp(m_s' - M'), o_s = sum_s acc_s w_s / max(sum_s l_s w_s,
// 1e-20)), sums lnum and lden over the splits in ascending order (plain
// sums, no max to rescale), and runs the finalize above.
//
// sla2_decode_kernel (quant_bits int8 / fp8, QAT tiles): P's codes depend
// on the running max of all earlier pages, so a split would change them.
// One block per (slot x KV head, window row) walks the row's routed pages
// serially, as the reference does: K / V tiles dequantised to f32 in
// shared memory, scalar dot products, per-tile codes of q, k, v and P.
//
// dense_decode: no router; every (slot, KV head) reads, in ascending order,
// only the logical pages its rows can see, computed from the row length t
// (its own token included), the sliding window and the prefix: the prefix
// pages [0, ceil(prefix_len / bk)) when a window is set, then
// [floor(max(t - window, 0) / bk), ceil(t / bk)).  A wholly masked page
// leaves the online softmax unchanged, so skipping the others is exact; no
// entry of the page table past the rows' lengths is read.  Bound: every
// visible K / V byte read once (the lm-serve contexts of qwen3-14b: 197
// pages x 8 KV heads x 2 x 16 KiB = 51.6 MB in bf16, 15.5 us at the H100
// SXM's 3.35 TB/s);
// a few MFLOP, so CUDA cores suffice and what matters is bytes in flight.
// Two kernels, selected by quant_bits (a selection by input, not a fallback
// on failure):
//
// dense_split_kernel + dense_combine_kernel (quant_bits none, the serving
// path): flash-decoding.  Grid (slot x KV head, split, window-row group);
// one block takes all window rows (up to 64 rows of window rows x n_rep) of
// its (slot, KV head), each row masked by its own t, so a verify window
// reads each page once.  The group's visible pages (the union over its
// rows) are cut into splits of pages_per_split = max(2, ceil(n_vis /
// n_split)) consecutive pages; n_split is chosen by the wrapper from the
// grid's size (about 8 blocks per SM) and the table's width, so the longest
// row takes about 4 pages a block at the lm-serve contexts.  A split past
// the last visible page exits at once.  Per split:
//   - its page-table entries are read first, into shared memory;
//   - K / V pages flow through a 2-page cp.async ring of 16-byte loads in
//     their storage type (bf16, f32 or codes with their row scales), no
//     f32 copy; Q K^T reads a row in quads from a rotated start per key,
//     so the 32 lanes of a warp hit distinct banks;
//   - the reference's online softmax (m_safe, corr, the p[kk] + p[kk+32]
//     then butterfly P sum) on the split's pages, acc = acc * corr + P V
//     with acc in shared memory; under kv_quant the row scales multiply
//     S's and P's columns, (Q Kc^T) ks and (P vs) Vc;
//   - the card is latency-bound here: each thread's dot products run in
//     four independent partial sums, and 3 blocks share an SM (72 KB of
//     shared memory at W 1 on a bf16 pool, at most 85 registers);
//   - the partials (acc, m, l) per (row, head) go to f32 scratch.
// The combine (one block per row: slot x KV head, window row, head) reads
// the splits that hold pages: M = max_s m_s and w_s = exp(m_s' - M') with
// the m > HALF_NEG guards of the kernel's corr (one warp; the l_s w_s sum in
// lane partials, then a butterfly); o = sum_s acc_s w_s (ascending s, the
// loads unrolled: it is bound by their latency) / max(sum_s l_s w_s,
// 1e-20); a row that sees nothing writes 0.
//
// dense_decode_kernel (quant_bits int8 / fp8, QAT tiles): P's codes depend
// on the running max of all earlier pages, so a split would change them.
// One block per (slot x KV head, window row) walks the row's pages
// serially, as the reference does: K / V tiles dequantised to f32 in shared
// memory, the QAT tiles of sla2_decode, the next page's raw K / V loaded
// into registers while the current page is computed.
// No --use_fast_math: it would change expf and the divisions.

#include "paged_common.cuh"

namespace {

// Softmax over Dh of a row held by a warp, x[i] its element lane + 32 i:
// exp(x - max) / sum, as phi computes it (0 past dh).
__device__ __forceinline__ void warp_softmax_regs(float (&x)[DMAX / 32],
                                                  int dh, int lane) {
  float mx = NEG_INF;
#pragma unroll
  for (int i = 0; i < DMAX / 32; ++i) mx = fmaxf(mx, x[i]);
  mx = warp_max(mx);
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < DMAX / 32; ++i) {
    x[i] = lane + 32 * i < dh ? expf(x[i] - mx) : 0.0f;
    sum = __fadd_rn(sum, x[i]);
  }
  sum = warp_sum(sum);
#pragma unroll
  for (int i = 0; i < DMAX / 32; ++i) x[i] = x[i] / sum;
}

// Softmax over Dh of row `src` (stride 1) into `dst`, one warp per row.
__device__ __forceinline__ void warp_softmax(const float* src, float* dst,
                                             int dh, int lane) {
  float x[DMAX / 32];
#pragma unroll
  for (int i = 0; i < DMAX / 32; ++i) {
    const int d = lane + 32 * i;
    x[i] = d < dh ? src[d] : NEG_INF;
  }
  warp_softmax_regs(x, dh, lane);
#pragma unroll
  for (int i = 0; i < DMAX / 32; ++i) {
    const int d = lane + 32 * i;
    if (d < dh) dst[d] = x[i];
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
// sla2_decode, routed entries split across blocks (quant_bits none)
// ===========================================================================

constexpr int DSPLIT_STAGES = 2;        // pages in the ring
constexpr int EPS_MAX = 64;             // routed entries of a split, at most

__host__ __device__ inline int up16(int x) { return (x + 15) & ~15; }

struct DSplitLayout {
  int qv, qf, sc, ls, row, ent, ring, stage, total;   // bytes
};

__host__ __device__ inline DSplitLayout dsplit_layout(int n_rep, int bk,
                                                      int dh, int es) {
  DSplitLayout L;
  int off = 0;                                // each section 16-byte aligned
  L.qv = off;  off += n_rep * dh * 4;         // q, f32 [n_rep][dh]
  L.qf = off;  off += n_rep * dh * 4;         // phi(q)
  L.sc = off;  off += up16(n_rep * (bk + 1) * 4);   // S, then P
  L.ls = off;  off += up16(n_rep * (bk + 1) * 4);   // phi(q) phi(k)^T
  L.row = off; off += 4 * RMAX * 4;           // m, l, corr, lden per row
  L.ent = off; off += 3 * EPS_MAX * 4 + 16;   // page, block, complete; count
  off = (off + 127) & ~127;
  L.ring = off;
  L.stage = 2 * bk * dh * es + 2 * bk * 4;    // K, V, their row scales
  off += DSPLIT_STAGES * L.stage;
  L.total = off;
  return L;
}

// One block per (slot x KV head, window row, split): the split's routed
// entries [sp * eps, sp * eps + eps) through the online softmax and the
// linear correction, into f32 partials part_o (acc, lnum: 2 x n_rep x Dh)
// and part_s (m, l, lden: 3 x n_rep, then the count of valid entries).
template <typename QT, typename PT>
__global__ void __launch_bounds__(NT, 3)
sla2_decode_split_kernel(const QT* __restrict__ q, const PT* __restrict__ kp,
                         const PT* __restrict__ vp,
                         const float* __restrict__ kscale,
                         const float* __restrict__ vscale,
                         const int* __restrict__ phys,
                         const int* __restrict__ jlog,
                         const int* __restrict__ valid,
                         const int* __restrict__ comp,
                         const int* __restrict__ tnew,
                         float* __restrict__ part_o,
                         float* __restrict__ part_s, int W, int hkv,
                         int n_rep, int dh, int bk, int k_sel, int n_pages,
                         int eps, int n_split, float sm_scale) {
  constexpr bool SCALED = sizeof(PT) == 1;
  extern __shared__ __align__(128) unsigned char smem[];
  const int g = blockIdx.x, w = blockIdx.y, sp = blockIdx.z;
  const int b = g / hkv, head = g - b * hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t gw = (size_t)g * W + w;
  const DSplitLayout L = dsplit_layout(n_rep, bk, dh, sizeof(PT));
  float* qv = reinterpret_cast<float*>(smem + L.qv);
  float* qf = reinterpret_cast<float*>(smem + L.qf);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  float* lsc = reinterpret_cast<float*>(smem + L.ls);
  float* m_r = reinterpret_cast<float*>(smem + L.row);
  float* l_r = m_r + RMAX;
  float* c_r = l_r + RMAX;
  float* d_r = c_r + RMAX;
  int* e_ph = reinterpret_cast<int*>(smem + L.ent);   // physical page
  int* e_j = e_ph + EPS_MAX;                          // logical block
  int* e_cm = e_j + EPS_MAX;                          // complete
  int* e_n = e_cm + EPS_MAX;
  const int sst = bk + 1, nq = n_rep * dh;
  float* ps = part_s + (gw * n_split + sp) * (3 * n_rep + 1);

  // ---- the split's valid entries, ascending (warp 0, a ballot) ----
  const int j0 = sp * eps, ne = min(eps, k_sel - j0);
  if (tid < 32) {
    int c = 0;
    for (int base = 0; base < ne; base += 32) {
      const int e = base + lane;
      const size_t at = gw * k_sel + j0 + e;
      const int ph = e < ne ? phys[at] : -1;
      const bool ok = e < ne && valid[at] == 1 && ph >= 0 && ph < n_pages;
      const unsigned m = __ballot_sync(0xffffffffu, ok);
      if (ok) {
        const int pos = c + __popc(m & ((1u << lane) - 1u));
        e_ph[pos] = ph;
        e_j[pos] = jlog[at];
        e_cm[pos] = comp[at] == 1;
      }
      c += __popc(m);
    }
    if (lane == 0) {
      *e_n = c;
      ps[3 * n_rep] = (float)c;
    }
  }
  __syncthreads();
  const int n = *e_n;
  if (n == 0) return;                   // uniform: the combine skips it

  // ---- the ring: page i of the split lands in stage i % DSPLIT_STAGES ----
  const int tile_bytes = bk * dh * (int)sizeof(PT);
  const int chunks = tile_bytes / 16;
  auto issue = [&](int i) {
    if (i < n) {
      unsigned char* st = smem + L.ring + (i % DSPLIT_STAGES) * L.stage;
      const size_t pg = (size_t)e_ph[i] * hkv + head;
      const unsigned char* ksrc =
          reinterpret_cast<const unsigned char*>(kp + pg * bk * dh);
      const unsigned char* vsrc =
          reinterpret_cast<const unsigned char*>(vp + pg * bk * dh);
      for (int e = tid; e < chunks; e += NT) {
        cp_async16(st + e * 16, ksrc + (size_t)e * 16);
        cp_async16(st + tile_bytes + e * 16, vsrc + (size_t)e * 16);
      }
      if (SCALED)
        for (int e = tid; e < bk / 4; e += NT) {
          cp_async16(st + 2 * tile_bytes + e * 16, kscale + pg * bk + 4 * e);
          cp_async16(st + 2 * tile_bytes + bk * 4 + e * 16,
                     vscale + pg * bk + 4 * e);
        }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < DSPLIT_STAGES - 1; ++i) issue(i);

  // ---- q, phi(q) and the row state, while the first page is in flight ----
  const QT* qrow = q + gw * nq;
  for (int e = tid; e < nq; e += NT) qv[e] = ldf(qrow, e);
  if (tid < RMAX) {
    m_r[tid] = NEG_INF;
    l_r[tid] = 0.0f;
    c_r[tid] = 1.0f;
    d_r[tid] = 0.0f;
  }
  __syncthreads();
  for (int r = warp; r < n_rep; r += NWARP)
    warp_softmax(qv + r * dh, qf + r * dh, dh, lane);

  // each thread owns the column pairs (r, 2c, 2c + 1) e = tid + NT * u
  constexpr int PAIRS = RMAX * DMAX / 2 / NT;
  const int half = dh / 2, nq4 = dh / 4;
  float2 acc[PAIRS], lnum[PAIRS];
#pragma unroll
  for (int u = 0; u < PAIRS; ++u) acc[u] = lnum[u] = make_float2(0.0f, 0.0f);
  const int t = tnew[(size_t)b * W + w];

  for (int i = 0; i < n; ++i) {
    cp_async_wait<DSPLIT_STAGES - 2>();
    __syncthreads();                    // page i landed; page i - 1 read
    issue(i + DSPLIT_STAGES - 1);       // into page i - 1's stage
    const unsigned char* st = smem + L.ring + (i % DSPLIT_STAGES) * L.stage;
    const PT* kt = reinterpret_cast<const PT*>(st);
    const PT* vt = reinterpret_cast<const PT*>(st + tile_bytes);
    const float* ksc = reinterpret_cast<const float*>(st + 2 * tile_bytes);
    const float* vsc = ksc + bk;
    const int j = e_j[i];
    const bool cm = e_cm[i] != 0;

    // ---- S for the n_rep x bk tile, masked by cols < t: a key's row read
    // in quads from a rotated start (the lanes of a warp hit distinct
    // banks), in four partial sums ----
    for (int e = tid; e < n_rep * bk; e += NT) {
      const int r = e / bk, kk = e - r * bk;
      const float* qr = qv + r * dh;
      const PT* kr = kt + kk * dh;
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
      for (int u = 0; u < nq4; u += 2) {
        const int d0 = 4 * ((u + kk) & (nq4 - 1));
        const int d1 = 4 * ((u + 1 + kk) & (nq4 - 1));
        const float4 a0 = *reinterpret_cast<const float4*>(qr + d0);
        const float4 a1 = *reinterpret_cast<const float4*>(qr + d1);
        const float4 k0 = ld4(kr + d0), k1 = ld4(kr + d1);
        s0 = fmaf(a0.y, k0.y, fmaf(a0.x, k0.x, s0));
        s1 = fmaf(a0.w, k0.w, fmaf(a0.z, k0.z, s1));
        s2 = fmaf(a1.y, k1.y, fmaf(a1.x, k1.x, s2));
        s3 = fmaf(a1.w, k1.w, fmaf(a1.z, k1.z, s3));
      }
      float x = __fadd_rn(__fadd_rn(s0, s1), __fadd_rn(s2, s3));
      if (SCALED) x = __fmul_rn(x, ksc[kk]);
      x = __fmul_rn(x, sm_scale);
      sc[r * sst + kk] = j * bk + kk < t ? x : NEG_INF;
    }

    // ---- a complete block: phi(q) phi(k)^T.  A warp takes 4 key rows at
    // once, 8 lanes a row (elements sl + 8 i): exp(k - max) stays in
    // registers, its max, sum and dots with the phi(q) rows reduce over 8
    // lanes, and each dot is divided by the row's sum once ----
    if (cm) {
      const int kg = lane >> 3, sl = lane & 7;
      for (int k0 = 4 * warp; k0 < bk; k0 += 4 * NWARP) {
        const int kk = k0 + kg;                   // bk % 16 == 0: kk < bk
        float x[DMAX / 8];
        float mx = NEG_INF;
#pragma unroll
        for (int u = 0; u < DMAX / 8; ++u) {
          const int d = sl + 8 * u;
          float kx = NEG_INF;
          if (d < dh) {
            kx = tof(kt[kk * dh + d]);
            if (SCALED) kx = __fmul_rn(kx, ksc[kk]);
          }
          x[u] = kx;
          mx = fmaxf(mx, kx);
        }
        for (int o = 4; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        float sum = 0.0f;
#pragma unroll
        for (int u = 0; u < DMAX / 8; ++u) {
          x[u] = sl + 8 * u < dh ? expf(x[u] - mx) : 0.0f;
          sum = __fadd_rn(sum, x[u]);
        }
        for (int o = 4; o > 0; o >>= 1)
          sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
        for (int r0 = 0; r0 < n_rep; r0 += 8) {   // 8 rows' dots at once
          float y[8];
#pragma unroll
          for (int r = 0; r < 8; ++r) y[r] = 0.0f;
#pragma unroll
          for (int u = 0; u < DMAX / 8; ++u) {
            const int d = sl + 8 * u;
            if (d >= dh) break;
#pragma unroll
            for (int r = 0; r < 8; ++r)
              if (r0 + r < n_rep) y[r] = fmaf(qf[(r0 + r) * dh + d], x[u], y[r]);
          }
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            if (r0 + r >= n_rep) break;
            for (int o = 4; o > 0; o >>= 1)
              y[r] = __fadd_rn(y[r], __shfl_xor_sync(0xffffffffu, y[r], o));
            if (sl == 0) lsc[(r0 + r) * sst + kk] = y[r] / sum;
          }
        }
      }
    }
    __syncthreads();

    // ---- online softmax, one warp per row; lden from the same rows ----
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
      // P (and below phi(q) phi(k)^T) times V's row scales under kv_quant
      if (lane < bk) srow[lane] = SCALED ? __fmul_rn(p0, vsc[lane]) : p0;
      if (lane + 32 < bk)
        srow[lane + 32] = SCALED ? __fmul_rn(p1, vsc[lane + 32]) : p1;
      if (cm) {
        float* lrow = lsc + r * sst;
        const float x0 = lane < bk ? lrow[lane] : 0.0f;
        const float x1 = lane + 32 < bk ? lrow[lane + 32] : 0.0f;
        const float lsum = warp_sum(__fadd_rn(x0, x1));
        if (lane == 0) d_r[r] = __fadd_rn(d_r[r], lsum);
        if (SCALED) {
          if (lane < bk) lrow[lane] = __fmul_rn(x0, vsc[lane]);
          if (lane + 32 < bk) lrow[lane + 32] = __fmul_rn(x1, vsc[lane + 32]);
        }
      }
      if (lane == 0) {
        l_r[r] = __fadd_rn(__fmul_rn(l_r[r], corr), psum);
        m_r[r] = m_new;
        c_r[r] = corr;
      }
    }
    __syncthreads();

    // ---- acc = acc * corr + P V; lnum += (phi(q) phi(k)^T) V: columns 2c
    // and 2c + 1 of a row, even and odd keys in separate sums ----
#pragma unroll
    for (int u = 0; u < PAIRS; ++u) {
      const int e = tid + NT * u;
      if (e >= n_rep * half) break;
      const int r = e / half, c2 = 2 * (e - r * half);
      const PT* vc = vt + c2;
      const float* prow = sc + r * sst;
      float x0 = 0.0f, x1 = 0.0f, y0 = 0.0f, y1 = 0.0f;
      for (int k = 0; k < bk; k += 2) {
        const float2 v0 = ld2(vc + k * dh), v1 = ld2(vc + (k + 1) * dh);
        x0 = fmaf(prow[k], v0.x, x0);
        x1 = fmaf(prow[k], v0.y, x1);
        y0 = fmaf(prow[k + 1], v1.x, y0);
        y1 = fmaf(prow[k + 1], v1.y, y1);
      }
      const float cr = c_r[r];
      acc[u].x = __fadd_rn(__fmul_rn(acc[u].x, cr), __fadd_rn(x0, y0));
      acc[u].y = __fadd_rn(__fmul_rn(acc[u].y, cr), __fadd_rn(x1, y1));
      if (cm) {
        const float* lrow = lsc + r * sst;
        x0 = x1 = y0 = y1 = 0.0f;
        for (int k = 0; k < bk; k += 2) {
          const float2 v0 = ld2(vc + k * dh), v1 = ld2(vc + (k + 1) * dh);
          x0 = fmaf(lrow[k], v0.x, x0);
          x1 = fmaf(lrow[k], v0.y, x1);
          y0 = fmaf(lrow[k + 1], v1.x, y0);
          y1 = fmaf(lrow[k + 1], v1.y, y1);
        }
        lnum[u].x = __fadd_rn(lnum[u].x, __fadd_rn(x0, y0));
        lnum[u].y = __fadd_rn(lnum[u].y, __fadd_rn(x1, y1));
      }
    }
  }

  // ---- the partials of this split ----
  float* po = part_o + (gw * n_split + sp) * 2 * nq;
#pragma unroll
  for (int u = 0; u < PAIRS; ++u) {
    const int e = tid + NT * u;
    if (e >= n_rep * half) break;
    const int r = e / half, c2 = 2 * (e - r * half);
    *reinterpret_cast<float2*>(po + r * dh + c2) = acc[u];
    *reinterpret_cast<float2*>(po + nq + r * dh + c2) = lnum[u];
  }
  if (tid < n_rep) {
    ps[tid] = m_r[tid];
    ps[n_rep + tid] = l_r[tid];
    ps[2 * n_rep + tid] = d_r[tid];
  }
}

__host__ __device__ inline int combine_smem(int n_rep, int dh, int n_split) {
  return (dh * dh + 2 * n_rep * dh + 2 * n_split * RMAX + 3 * RMAX) * 4 +
         n_split * 4 + 16;
}

// One block per (slot x KV head, window row): the splits' softmax partials
// rescaled with the corr guards, lnum and lden summed in ascending split
// order, then the finalize of sla2_decode_kernel.  h_tot (64 KiB a row at
// Dh 128) is copied into shared memory first, while the weights are
// formed: the product phi(q) h_tot then runs on resident values, not on a
// chain of HBM loads.
template <typename QT>
__global__ void __launch_bounds__(NT)
sla2_decode_combine_kernel(const QT* __restrict__ q,
                           const float* __restrict__ part_o,
                           const float* __restrict__ part_s,
                           const float* __restrict__ htot,
                           const float* __restrict__ ztot,
                           const float* __restrict__ alpha,
                           float* __restrict__ o, int W, int n_rep, int dh,
                           int n_split) {
  extern __shared__ __align__(16) float cm[];
  const int nq = n_rep * dh, stats = 3 * n_rep + 1;
  float* hs = cm;                       // h_tot, [dh][dh]
  float* qv = hs + dh * dh;             // q, [n_rep][dh]
  float* qf = qv + nq;                  // phi(q)
  float* wts = qf + nq;                 // split weights, [n_split][RMAX],
                                        // then the lden partials
  float* l_s = wts + 2 * n_split * RMAX;   // per row: max(sum l w, 1e-20),
  float* ld_s = l_s + RMAX;             // lden and den_tot
  float* dt_s = ld_s + RMAX;
  int* used = reinterpret_cast<int*>(dt_s + RMAX);    // [n_split]: the
  int* n_used = used + n_split;         // splits with entries, ascending
  const int g = blockIdx.x, w = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t gw = (size_t)g * W + w;
  const float* ps = part_s + gw * n_split * stats;

  const float* h = htot + gw * (size_t)dh * dh;
  for (int e = tid; e < dh * dh / 4; e += NT) cp_async16(hs + 4 * e, h + 4 * e);
  cp_async_commit();
  const QT* qrow = q + gw * nq;
  for (int e = tid; e < nq; e += NT) qv[e] = ldf(qrow, e);
  if (tid < 32) {                       // warp 0 lists them with a ballot
    int c = 0;
    for (int base = 0; base < n_split; base += 32) {
      const int s = base + lane;
      const bool ok = s < n_split && ps[(size_t)s * stats + 3 * n_rep] > 0.0f;
      const unsigned m = __ballot_sync(0xffffffffu, ok);
      if (ok) used[c + __popc(m & ((1u << lane) - 1u))] = s;
      c += __popc(m);
    }
    if (lane == 0) *n_used = c;
  }
  __syncthreads();
  for (int r = warp; r < n_rep; r += NWARP)
    warp_softmax(qv + r * dh, qf + r * dh, dh, lane);
  __syncthreads();
  const int nu = *n_used;

  // ---- per row: w_s = exp(m_s' - M') with the corr guards over the splits
  // that hold entries, sum l_s w_s (lane partials, then a butterfly); lden
  // in ascending split order; den_tot = phi(q) . z_tot ----
  const float* z = ztot + gw * dh;
  for (int r = warp; r < n_rep; r += NWARP) {
    float m = NEG_INF;
    for (int i = lane; i < nu; i += 32)
      m = fmaxf(m, ps[(size_t)used[i] * stats + r]);
    m = warp_max(m);
    const float m_safe = m > HALF_NEG ? m : 0.0f;
    float l = 0.0f;
    for (int i = lane; i < nu; i += 32) {
      const float* st = ps + (size_t)used[i] * stats;
      const float ms = st[r];
      const float wt = expf((ms > HALF_NEG ? ms : m_safe) - m_safe);
      l = __fadd_rn(l, __fmul_rn(st[n_rep + r], wt));
      wts[i * RMAX + r] = wt;
    }
    l = warp_sum(l);
    float x = 0.0f;
    for (int d = lane; d < DMAX; d += 32)
      x = __fadd_rn(x, d < dh ? __fmul_rn(qf[r * dh + d], z[d]) : 0.0f);
    x = warp_sum(x);
    for (int i = lane; i < nu; i += 32)   // lden partials, summed below
      wts[i * RMAX + r + RMAX * n_split] = ps[(size_t)used[i] * stats + 2 * n_rep + r];
    __syncwarp();
    if (lane == 0) {
      float ld = 0.0f;
      for (int i = 0; i < nu; ++i)
        ld = __fadd_rn(ld, wts[i * RMAX + r + RMAX * n_split]);
      l_s[r] = fmaxf(l, 1e-20f);
      ld_s[r] = ld;
      dt_s[r] = x;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // ---- o: thread (column c, row group) takes rows rg, rg + ng, ...: acc
  // and lnum summed over the splits (ascending), phi(q) h_tot from the
  // resident copy, the linear complement and the alpha combine ----
  constexpr int RPT = RMAX * DMAX / NT;           // rows a thread takes
  const int ng = NT / dh, c = tid % dh, rg = tid / dh;
  const float* po = part_o + gw * n_split * 2 * (size_t)nq;
  float a[RPT], ln[RPT], num[RPT];
#pragma unroll
  for (int u = 0; u < RPT; ++u) a[u] = ln[u] = num[u] = 0.0f;
  // the partials are read four splits at a time (rows past n_rep read a
  // valid row again and are not added), then added in ascending order
  for (int i0 = 0; i0 < nu; i0 += 4) {
    float va[4][RPT], vl[4][RPT];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* ps_o = po + (size_t)used[min(i0 + j, nu - 1)] * 2 * nq;
#pragma unroll
      for (int u = 0; u < RPT; ++u) {
        const int r = min(rg + ng * u, n_rep - 1);
        va[j][u] = ps_o[r * dh + c];
        vl[j][u] = ps_o[nq + r * dh + c];
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (i0 + j >= nu) break;
#pragma unroll
      for (int u = 0; u < RPT; ++u) {
        const int r = rg + ng * u;
        if (r >= n_rep) break;
        a[u] = __fadd_rn(a[u], __fmul_rn(va[j][u], wts[(i0 + j) * RMAX + r]));
        ln[u] = __fadd_rn(ln[u], vl[j][u]);
      }
    }
  }
  for (int d = 0; d < dh; ++d) {
    const float hv = hs[d * dh + c];
#pragma unroll
    for (int u = 0; u < RPT; ++u) {
      const int r = rg + ng * u;
      if (r >= n_rep) break;
      num[u] = fmaf(qf[r * dh + d], hv, num[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < RPT; ++u) {
    const int r = rg + ng * u;
    if (r >= n_rep) break;
    const float nm = __fadd_rn(num[u], -ln[u]);
    const float den_tot = dt_s[r];
    float den = __fadd_rn(den_tot, -ld_s[r]);
    den = den > __fadd_rn(__fmul_rn(1e-4f, den_tot), 1e-12f) ? den : 0.0f;
    const float o_l = den > 0.0f ? nm / fmaxf(den, 1e-12f) : 0.0f;
    const float al = 1.0f / (1.0f + expf(-alpha[(size_t)g * n_rep + r]));
    const float a_eff = den > 0.0f ? al : 1.0f;
    const float o_s = a[u] / l_s[r];
    o[gw * nq + r * dh + c] = __fadd_rn(
        __fmul_rn(a_eff, o_s), __fmul_rn(__fadd_rn(1.0f, -a_eff), o_l));
  }
}

// The pages rows of lengths t_lo .. t_hi see, ascending: [0, n_pref), then
// [lo2, lo2 + n_vis - n_pref).
struct VisPages {
  int n_pref, lo2, n_vis;
};

__device__ __forceinline__ VisPages vis_pages(int t_lo, int t_hi, int bk,
                                              int max_p, int window,
                                              int prefix_len) {
  const int hi = min(max_p, (t_hi + bk - 1) / bk);
  int n_pref = 0, lo = 0;
  if (window >= 0) {
    lo = max(t_lo - window, 0) / bk;
    n_pref = min(hi, (prefix_len + bk - 1) / bk);
  }
  const int lo2 = max(lo, n_pref);
  return {n_pref, lo2, n_pref + max(0, hi - lo2)};
}

// ===========================================================================
// dense_decode with QAT tiles: one block per row, pages in order
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
  const VisPages V = vis_pages(t, t, bk, max_p, window, prefix_len);
  const int n_pref = V.n_pref, lo2 = V.lo2, n_vis = V.n_vis;
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
// dense_decode, split across blocks (quant_bits none)
// ===========================================================================

constexpr int SPLIT_ROWS = 64;          // window rows x n_rep of a block
constexpr int SPLIT_STAGES = 2;         // pages in the ring
constexpr int PPS_MIN = 2;              // pages per split, at least
constexpr int PPS_MAX = 64;             // and at most

struct SplitLayout {
  int q, sc, acc, row, tr, pg, ring, stage, total;   // bytes
};

__host__ __device__ inline SplitLayout split_layout(int rows, int bk, int dh,
                                                    int es) {
  SplitLayout L;
  int off = 0;                                // each section 16-byte aligned
  L.q = off;   off += rows * dh * 4;          // q, f32 [rows][dh]
  L.acc = off; off += rows * dh * 4;          // acc, f32 [rows][dh]
  L.row = off; off += 3 * SPLIT_ROWS * 4;     // m, l, corr per row
  L.tr = off;  off += SPLIT_ROWS * 4;         // t per row
  L.pg = off;  off += 2 * PPS_MAX * 4;        // logical, physical page
  L.sc = off;  off += rows * (bk + 1) * 4;    // S, then P
  off = (off + 127) & ~127;
  L.ring = off;
  L.stage = 2 * bk * dh * es + 2 * bk * 4;    // K, V, their row scales
  off += SPLIT_STAGES * L.stage;
  L.total = off;
  return L;
}

// The lengths of window rows w0 .. w0 + nw - 1 of slot b: min and max.
__device__ __forceinline__ void row_span(const int* tnew, int b, int W,
                                         int w0, int nw, int& t_lo,
                                         int& t_hi) {
  t_lo = 1 << 30;
  t_hi = 0;
  for (int w = 0; w < nw; ++w) {
    const int t = tnew[(size_t)b * W + w0 + w];
    t_lo = min(t_lo, t);
    t_hi = max(t_hi, t);
  }
}

__device__ __forceinline__ int split_pages(int n_vis, int n_split) {
  return max(PPS_MIN, (n_vis + n_split - 1) / n_split);
}

template <typename QT, typename PT>
__global__ void __launch_bounds__(NT, 3)
dense_split_kernel(const QT* __restrict__ q, const PT* __restrict__ kp,
                   const PT* __restrict__ vp,
                   const float* __restrict__ kscale,
                   const float* __restrict__ vscale,
                   const int* __restrict__ table,
                   const int* __restrict__ tnew, float* __restrict__ part_acc,
                   float* __restrict__ part_ml, int W, int wg, int hkv,
                   int n_rep, int dh, int bk, int max_p, int window,
                   int prefix_len, int n_pages, int n_split, float sm_scale) {
  constexpr bool SCALED = sizeof(PT) == 1;
  extern __shared__ __align__(128) unsigned char smem[];
  const int g = blockIdx.x, sp = blockIdx.y, w0 = blockIdx.z * wg;
  const int b = g / hkv, head = g - b * hkv;
  const int nw = min(wg, W - w0), R = nw * n_rep;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  int t_lo, t_hi;
  row_span(tnew, b, W, w0, nw, t_lo, t_hi);
  const VisPages V = vis_pages(t_lo, t_hi, bk, max_p, window, prefix_len);
  const int pps = split_pages(V.n_vis, n_split);
  const int i0 = sp * pps, n = min(V.n_vis - i0, pps);
  if (n <= 0) return;                   // past the last page: no partial

  const SplitLayout L = split_layout(R, bk, dh, sizeof(PT));
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  float* accs = reinterpret_cast<float*>(smem + L.acc);
  float* m_r = reinterpret_cast<float*>(smem + L.row);
  float* l_r = m_r + SPLIT_ROWS;
  float* c_r = l_r + SPLIT_ROWS;
  int* t_r = reinterpret_cast<int*>(smem + L.tr);
  int* pj = reinterpret_cast<int*>(smem + L.pg);   // logical page
  int* pph = pj + PPS_MAX;                          // physical, -1 unmapped
  const int sst = bk + 1, half = dh / 2;
  const int tile_bytes = bk * dh * (int)sizeof(PT);

  // ---- page-table entries, q, row state ----
  for (int i = tid; i < n; i += NT) {
    const int ii = i0 + i;
    const int j = ii < V.n_pref ? ii : V.lo2 + (ii - V.n_pref);
    const int ph = table[(size_t)b * max_p + j];
    pj[i] = j;
    pph[i] = ph < 0 || ph >= n_pages ? -1 : ph;
  }
  __syncthreads();

  // ---- the ring: page i of the split lands in stage i % SPLIT_STAGES ----
  const int chunks = tile_bytes / 16;
  auto issue = [&](int i) {
    if (i < n && pph[i] >= 0) {
      unsigned char* st = smem + L.ring + (i % SPLIT_STAGES) * L.stage;
      const size_t pg = (size_t)pph[i] * hkv + head;
      const unsigned char* ksrc =
          reinterpret_cast<const unsigned char*>(kp + pg * bk * dh);
      const unsigned char* vsrc =
          reinterpret_cast<const unsigned char*>(vp + pg * bk * dh);
      for (int e = tid; e < chunks; e += NT) {
        cp_async16(st + e * 16, ksrc + (size_t)e * 16);
        cp_async16(st + tile_bytes + e * 16, vsrc + (size_t)e * 16);
      }
      if (SCALED)
        for (int e = tid; e < bk / 4; e += NT) {
          cp_async16(st + 2 * tile_bytes + e * 16, kscale + pg * bk + 4 * e);
          cp_async16(st + 2 * tile_bytes + bk * 4 + e * 16,
                     vscale + pg * bk + 4 * e);
        }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < SPLIT_STAGES - 1; ++i) issue(i);

  // ---- q and the row state, while the first page is in flight ----
  const size_t row0 = ((size_t)g * W + w0) * n_rep;   // (g, w, h) order
  const QT* qb = q + row0 * dh;
  for (int e = tid; e < R * dh; e += NT) {
    qs[e] = ldf(qb, e);
    accs[e] = 0.0f;
  }
  if (tid < R) {
    m_r[tid] = NEG_INF;
    l_r[tid] = 0.0f;
    c_r[tid] = 1.0f;
    t_r[tid] = tnew[(size_t)b * W + w0 + tid / n_rep];
  }

  const int nq4 = dh / 4;               // quads of a row (a power of two)
  for (int i = 0; i < n; ++i) {
    issue(i + SPLIT_STAGES - 1);
    cp_async_wait<SPLIT_STAGES - 1>();
    __syncthreads();                    // page i landed for every thread
    if (pph[i] >= 0) {                  // uniform: skip an unmapped entry
      const int j = pj[i];
      const unsigned char* st = smem + L.ring + (i % SPLIT_STAGES) * L.stage;
      const PT* kt = reinterpret_cast<const PT*>(st);
      const PT* vt = reinterpret_cast<const PT*>(st + tile_bytes);
      const float* ksc = reinterpret_cast<const float*>(st + 2 * tile_bytes);
      const float* vsc = ksc + bk;

      // ---- S for the rows x bk tile, each row masked by its own t.  A
      // key's row is read in quads from a rotated start (the lanes of a warp
      // hit distinct banks), in four partial sums ----
      for (int e = tid; e < R * bk; e += NT) {
        const int r = e / bk, kk = e - r * bk;
        const float* qr = qs + r * dh;
        const PT* kr = kt + kk * dh;
        float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
        for (int u = 0; u < nq4; u += 2) {
          const int d0 = 4 * ((u + kk) & (nq4 - 1));
          const int d1 = 4 * ((u + 1 + kk) & (nq4 - 1));
          const float4 a0 = *reinterpret_cast<const float4*>(qr + d0);
          const float4 a1 = *reinterpret_cast<const float4*>(qr + d1);
          const float4 k0 = ld4(kr + d0), k1 = ld4(kr + d1);
          s0 = fmaf(a0.y, k0.y, fmaf(a0.x, k0.x, s0));
          s1 = fmaf(a0.w, k0.w, fmaf(a0.z, k0.z, s1));
          s2 = fmaf(a1.y, k1.y, fmaf(a1.x, k1.x, s2));
          s3 = fmaf(a1.w, k1.w, fmaf(a1.z, k1.z, s3));
        }
        float x = __fadd_rn(__fadd_rn(s0, s1), __fadd_rn(s2, s3));
        if (SCALED) x = __fmul_rn(x, ksc[kk]);
        x = __fmul_rn(x, sm_scale);
        const int col = j * bk + kk, t = t_r[r];
        bool vis = col < t;
        if (window >= 0) vis = vis && (col >= t - window || col < prefix_len);
        sc[r * sst + kk] = vis ? x : NEG_INF;
      }
      __syncthreads();

      // ---- online softmax, one warp per row ----
      for (int r = warp; r < R; r += NWARP) {
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
        if (lane < bk) srow[lane] = SCALED ? __fmul_rn(p0, vsc[lane]) : p0;
        if (lane + 32 < bk)
          srow[lane + 32] = SCALED ? __fmul_rn(p1, vsc[lane + 32]) : p1;
        if (lane == 0) {
          l_r[r] = __fadd_rn(__fmul_rn(l_r[r], corr), psum);
          m_r[r] = m_new;
          c_r[r] = corr;
        }
      }
      __syncthreads();

      // ---- acc = acc * corr + P V, columns 2 c and 2 c + 1 of a row, in
      // four partial sums ----
      for (int e = tid; e < R * half; e += NT) {
        const int r = e / half, c2 = 2 * (e - r * half);
        const float* prow = sc + r * sst;
        const PT* vc = vt + c2;
        float x0 = 0.0f, x1 = 0.0f, y0 = 0.0f, y1 = 0.0f;
        for (int k = 0; k < bk; k += 2) {
          const float2 v0 = ld2(vc + k * dh), v1 = ld2(vc + (k + 1) * dh);
          const float p0 = prow[k], p1 = prow[k + 1];
          x0 = fmaf(p0, v0.x, x0);
          x1 = fmaf(p0, v0.y, x1);
          y0 = fmaf(p1, v1.x, y0);
          y1 = fmaf(p1, v1.y, y1);
        }
        float2* a = reinterpret_cast<float2*>(accs + r * dh + c2);
        const float cr = c_r[r];
        float2 av = *a;
        av.x = __fadd_rn(__fmul_rn(av.x, cr), __fadd_rn(x0, y0));
        av.y = __fadd_rn(__fmul_rn(av.y, cr), __fadd_rn(x1, y1));
        *a = av;
      }
    }
    __syncthreads();                    // stage i may be refilled
  }

  // ---- the partials of this split ----
  for (int e = tid; e < R * dh; e += NT) {
    const int r = e / dh;
    part_acc[((row0 + r) * n_split + sp) * dh + (e - r * dh)] = accs[e];
  }
  if (tid < R) {
    part_ml[((row0 + tid) * n_split + sp) * 2] = m_r[tid];
    part_ml[((row0 + tid) * n_split + sp) * 2 + 1] = l_r[tid];
  }
}

// One block of Dh threads per (slot x KV head, row group, row).
__global__ void __launch_bounds__(DMAX)
dense_combine_kernel(const int* __restrict__ tnew,
                     const float* __restrict__ part_acc,
                     const float* __restrict__ part_ml, float* __restrict__ o,
                     int W, int wg, int hkv, int n_rep, int dh, int bk,
                     int max_p, int window, int prefix_len, int n_split) {
  extern __shared__ __align__(16) float wts[];    // [n_split]
  __shared__ float lsum;
  const int g = blockIdx.x, w0 = blockIdx.y * wg, r = blockIdx.z;
  const int b = g / hkv;
  const int nw = min(wg, W - w0);
  if (r >= nw * n_rep) return;
  const int tid = threadIdx.x;
  int t_lo, t_hi;
  row_span(tnew, b, W, w0, nw, t_lo, t_hi);
  const VisPages V = vis_pages(t_lo, t_hi, bk, max_p, window, prefix_len);
  const int pps = split_pages(V.n_vis, n_split);
  const int n_used = (V.n_vis + pps - 1) / pps;    // splits that hold pages
  const size_t row = ((size_t)g * W + w0) * n_rep + r;

  // ---- warp 0: w_s = exp(m_s' - M') with the corr guards, and
  // max(sum_s l_s w_s, 1e-20) (lane partials, then a butterfly) ----
  if (tid < 32) {
    const float* ml = part_ml + row * n_split * 2;
    float m = NEG_INF;
    for (int s = tid; s < n_used; s += 32) m = fmaxf(m, ml[2 * s]);
    m = warp_max(m);
    const float m_safe = m > HALF_NEG ? m : 0.0f;
    float l = 0.0f;
    for (int s = tid; s < n_used; s += 32) {
      const float ms = ml[2 * s];
      const float w = expf((ms > HALF_NEG ? ms : m_safe) - m_safe);
      wts[s] = w;
      l = __fadd_rn(l, __fmul_rn(ml[2 * s + 1], w));
    }
    l = warp_sum(l);
    if (tid == 0) lsum = fmaxf(l, 1e-20f);
  }
  __syncthreads();

  // ---- o = sum_s acc_s w_s (ascending s) / max(sum_s l_s w_s, 1e-20) ----
  if (tid < dh) {
    const float* pa = part_acc + row * n_split * dh + tid;
    float a = 0.0f;
#pragma unroll 8
    for (int s = 0; s < n_used; ++s)
      a = __fadd_rn(a, __fmul_rn(pa[(size_t)s * dh], wts[s]));
    o[row * dh + tid] = a / lsum;
  }
}

// ===========================================================================
// launch
// ===========================================================================

struct DecodeArgs {
  const void *q, *kp, *vp, *ks, *vs, *phys, *jlog, *valid, *comp, *tnew,
      *h, *z, *alpha;
  void *o, *part_o, *part_s;
  int b, W, hkv, n_rep, dh, bk, k_sel, quant, n_pages, n_split, eps;
  float sm_scale;
  cudaStream_t stream;
};

template <typename QT, typename PT>
int run_decode_serial(const DecodeArgs& a) {
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

template <typename QT, typename PT>
int run_decode_split(const DecodeArgs& a) {
  const int smem = dsplit_layout(a.n_rep, a.bk, a.dh, sizeof(PT)).total;
  auto kern = sla2_decode_split_kernel<QT, PT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(a.b * a.hkv, a.W, a.n_split), NT, smem, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const PT*>(a.kp),
      static_cast<const PT*>(a.vp), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.phys),
      static_cast<const int*>(a.jlog), static_cast<const int*>(a.valid),
      static_cast<const int*>(a.comp), static_cast<const int*>(a.tnew),
      static_cast<float*>(a.part_o), static_cast<float*>(a.part_s), a.W,
      a.hkv, a.n_rep, a.dh, a.bk, a.k_sel, a.n_pages, a.eps, a.n_split,
      a.sm_scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int csmem = combine_smem(a.n_rep, a.dh, a.n_split);
  auto comb = sla2_decode_combine_kernel<QT>;
  e = cudaFuncSetAttribute(comb, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           csmem);
  if (e != cudaSuccess) return (int)e;
  comb<<<dim3(a.b * a.hkv, a.W), NT, csmem, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const float*>(a.part_o),
      static_cast<const float*>(a.part_s), static_cast<const float*>(a.h),
      static_cast<const float*>(a.z), static_cast<const float*>(a.alpha),
      static_cast<float*>(a.o), a.W, a.n_rep, a.dh, a.n_split);
  return (int)cudaGetLastError();
}

template <typename QT, typename PT>
int run_decode(const DecodeArgs& a) {
  return a.quant == Q_NONE ? run_decode_split<QT, PT>(a)
                           : run_decode_serial<QT, PT>(a);
}

struct DenseArgs {
  const void *q, *kp, *vp, *ks, *vs, *table, *tnew;
  void *o, *part_acc, *part_ml;
  int b, W, hkv, n_rep, dh, bk, max_p, window, prefix_len, quant, n_pages,
      n_split, wg;
  float sm_scale;
  cudaStream_t stream;
};

template <typename QT, typename PT>
int run_dense_qat(const DenseArgs& a) {
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

template <typename QT, typename PT>
int run_dense_split(const DenseArgs& a) {
  const int rows = (a.wg < a.W ? a.wg : a.W) * a.n_rep;
  const int smem = split_layout(rows, a.bk, a.dh, sizeof(PT)).total;
  auto kern = dense_split_kernel<QT, PT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int nz = (a.W + a.wg - 1) / a.wg;
  kern<<<dim3(a.b * a.hkv, a.n_split, nz), NT, smem, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const PT*>(a.kp),
      static_cast<const PT*>(a.vp), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.table),
      static_cast<const int*>(a.tnew), static_cast<float*>(a.part_acc),
      static_cast<float*>(a.part_ml), a.W, a.wg, a.hkv, a.n_rep, a.dh, a.bk,
      a.max_p, a.window, a.prefix_len, a.n_pages, a.n_split, a.sm_scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int wsmem = a.n_split * 4;                     // the weights
  e = cudaFuncSetAttribute(dense_combine_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, wsmem);
  if (e != cudaSuccess) return (int)e;
  dense_combine_kernel<<<dim3(a.b * a.hkv, nz, rows), DMAX, wsmem, a.stream>>>(
      static_cast<const int*>(a.tnew), static_cast<const float*>(a.part_acc),
      static_cast<const float*>(a.part_ml), static_cast<float*>(a.o), a.W,
      a.wg, a.hkv, a.n_rep, a.dh, a.bk, a.max_p, a.window, a.prefix_len,
      a.n_split);
  return (int)cudaGetLastError();
}

template <typename QT, typename PT>
int run_dense(const DenseArgs& a) {
  return a.quant == Q_NONE ? run_dense_split<QT, PT>(a)
                           : run_dense_qat<QT, PT>(a);
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

}  // namespace

// C entries, bound with ctypes.  Each returns cudaGetLastError() after the
// launch (0 on success); the caller raises on anything else.
//
// sla2_decode: quant_bits none runs the split kernel and the combine:
// part_o (rows x n_split x 2 x n_rep x Dh) and part_s (rows x n_split x
// (3 n_rep + 1)) f32 scratch, rows = B x Hkv x W; eps routed entries per
// split (at most 64) and n_split = ceil(K_sel / eps) splits.  QAT tiles run
// sla2_decode_kernel (the scratch may be null).
extern "C" int sla2_decode(const void* q, const void* kp, const void* vp,
                           const void* ks, const void* vs, const void* phys,
                           const void* jlog, const void* valid,
                           const void* comp, const void* tnew, const void* h,
                           const void* z, const void* alpha, void* o,
                           void* part_o, void* part_s, int b, int W, int hkv,
                           int n_rep, int dh, int bk, int k_sel, int quant,
                           int q_bf16, int pool, int n_pages, int n_split,
                           int eps, float sm_scale, void* stream) {
  if (!shapes_ok(dh, bk, n_rep) || quant < Q_NONE || quant > Q_FP8 ||
      (pool >= P_I8 && (ks == nullptr || vs == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (quant == Q_NONE &&
      (part_o == nullptr || part_s == nullptr || eps < 1 || eps > EPS_MAX ||
       n_split < 1 || (long long)n_split * eps < k_sel ||
       (long long)(n_split - 1) * eps >= k_sel))
    return (int)cudaErrorInvalidValue;
  const DecodeArgs a{q,      kp,     vp,   ks,    vs,     phys,    jlog,
                     valid,  comp,   tnew, h,     z,      alpha,   o,
                     part_o, part_s, b,    W,     hkv,    n_rep,   dh,
                     bk,     k_sel,  quant, n_pages, n_split, eps, sm_scale,
                     static_cast<cudaStream_t>(stream)};
  return q_bf16 ? decode_pool<__nv_bfloat16>(pool, a) : decode_pool<float>(pool, a);
}

// quant_bits none runs the split kernel and the combine: part_acc (rows x
// n_split x Dh) and part_ml (rows x n_split x 2) f32 scratch, rows = B x
// Hkv x W x n_rep; wg window rows per block (wg x n_rep <= 64) and n_split
// splits (n_split x 64 >= max_p).  QAT tiles run dense_decode_kernel.
extern "C" int dense_decode(const void* q, const void* kp, const void* vp,
                            const void* ks, const void* vs, const void* table,
                            const void* tnew, void* o, void* part_acc,
                            void* part_ml, int b, int W, int hkv, int n_rep,
                            int dh, int bk, int max_p, int window,
                            int prefix_len, int quant, int q_bf16, int pool,
                            int n_pages, int n_split, int wg, float sm_scale,
                            void* stream) {
  if (!shapes_ok(dh, bk, n_rep) || quant < Q_NONE || quant > Q_FP8 ||
      (pool >= P_I8 && (ks == nullptr || vs == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (quant == Q_NONE &&
      (part_acc == nullptr || part_ml == nullptr || wg < 1 ||
       wg * n_rep > SPLIT_ROWS || n_split < 1 ||
       (long long)n_split * PPS_MAX < max_p))
    return (int)cudaErrorInvalidValue;
  const DenseArgs a{q,      kp,     vp,      ks,         vs,       table,
                    tnew,   o,      part_acc, part_ml,   b,        W,
                    hkv,    n_rep,  dh,      bk,         max_p,    window,
                    prefix_len, quant, n_pages, n_split, wg,       sm_scale,
                    static_cast<cudaStream_t>(stream)};
  return q_bf16 ? dense_pool<__nv_bfloat16>(pool, a) : dense_pool<float>(pool, a);
}

// Dynamic shared memory per block of sla2_decode_split_kernel for n_rep
// query heads and a pool of element size es.
extern "C" int sla2_decode_split_smem(int n_rep, int bk, int dh, int es) {
  return dsplit_layout(n_rep, bk, dh, es).total;
}

// Dynamic shared memory per block of dense_split_kernel for `rows` rows
// (window rows x n_rep) and a pool of element size es.
extern "C" int dense_split_smem(int rows, int bk, int dh, int es) {
  return split_layout(rows, bk, dh, es).total;
}
