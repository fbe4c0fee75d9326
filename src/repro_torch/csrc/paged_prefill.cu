// Chunked-prefill flash attention over the page pool of LM serving,
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/sla2_decode_paged.py::
// _prefill_kernel, via paged_flash_prefill.
//
// The work: for each KV head, the n_rep * C stacked query rows of the
// chunk (2560 at qwen3-14b's n_rep 5 and C 512) run an online softmax over
// the slot's visible pages, in ascending order.  Stacked row r is query
// head h * n_rep + r / C at position offset + r % C.  The mask is
// rows >= cols, then cols >= rows - window + 1, then | cols < prefix_len,
// as in the reference.  The pool holds pages (P, Hkv, bk, Dh): bf16 or f32,
// or int8 / e4m3 codes with one f32 scale per token row (kv_quant).
//
// Bound: 4 Dh operations per visible (query, key) pair over every query
// head at the H100 SXM's 989 TFLOP/s on bf16 tensor cores: 13.6 us for a
// 512-token chunk at offset 1024 (qwen3-14b); the pages are read from L2 by
// the 40 row tiles of a head, so bytes bound it less.
//
// Two kernels, selected by the operands' dtypes (a selection by input, not
// a fallback on failure):
//
// prefill_tc_kernel, a bf16 q over a bf16 or int8 / e4m3 pool (the serving
// path).  One 128-thread block per (64 stacked rows, KV head), one warp per
// 16 rows (a tile may straddle two query heads when C is not a multiple of
// 64).
//   - The block's visible pages are computed from its rows' positions, the
//     window and the prefix: the prefix pages, then the pages from the
//     window start of its first row to the position of its last.  A page no
//     row of the tile can see leaves the online softmax unchanged, so
//     skipping it is exact.  Their page-table entries are read first, into
//     shared memory.
//   - K and V pages flow through a 2-stage ring in shared memory, filled
//     with 16-byte cp.async while the previous page is computed; rows are
//     padded by 16 bytes so that ldmatrix reads them without bank
//     conflicts.  Codes are exact in bf16: each landed page is converted
//     once to bf16 rows for the four warps.
//   - Q stays in mma A-fragments (bf16) for the whole block.
//   - The card is latency-bound here, so occupancy decides: two stages
//     (70 KB) and a cap of 168 registers let three blocks share an SM (a
//     few hundred bytes spill at Dh 128; on an H100 80GB HBM3 at 700 W
//     that ran faster than reading Q's fragments from L1 for each page).
//   - S = Q K^T with mma.sync m16n8k16 bf16, f32 accumulators (bf16 x bf16
//     products are exact in f32; only the summation order departs from the
//     plain version).  Under kv_quant the row scale multiplies S's column:
//     (Q Kc^T) ks, the reference's Q (Kc ks)^T up to f32 rounding.
//   - The mask and the m_safe / corr online softmax run on the accumulator
//     fragments in registers (FA2), the row statistics reduced over each
//     fragment's quad; acc *= corr.
//   - P V: P is f32 in the reference and 2e-5 does not survive rounding it
//     to bf16, so P (times the V row scale under kv_quant) is split into
//     bf16 terms, p1 = bf16(P), p2 = bf16(P - p1), p3 = bf16(P - p1 - p2),
//     one mma per term against bf16 V (ldmatrix.trans).  Three terms
//     (PV_TERMS) carry P's 24 bits.  On chip_smoke.py's 36-case prefill
//     sweep (offsets 0 / 1024 / 7680, window, prefix, bf16 / int8 / e4m3
//     pools; H100 80GB HBM3, 700 W) the largest relative error from the
//     plain version was 1.925e-06 with three terms and 5.924e-06 with two,
//     both under the bound of 2e-5.  Two terms issue a third fewer P V
//     mma, but with them chip_smoke.py's full-width n-gram serving run
//     chose another greedy token than the run without drafts where the
//     top-2 logit margin (0.0358) was above the bf16 resolution of the
//     logit, which its token check refuses; with three it passes.  So
//     three are kept.
//   - A row that sees nothing writes acc / max(l, 1e-20) = 0.
//
// prefill_f32_kernel, an f32 q or an f32 pool (the 2-layer f32 paths): one
// 256-thread block per (64-row tile, KV head), Q, K, V and P staged as f32
// in shared memory, Q K^T and P V as f32 FMA on CUDA cores, P kept f32.
//
// No --use_fast_math: it would change expf and the divisions.

#include "paged_common.cuh"

namespace {

constexpr int PV_TERMS = 3;             // bf16 terms of P in P V

// ===========================================================================
// prefill_tc_kernel: bf16 tensor cores, cp.async page ring
// ===========================================================================

constexpr int TC_ROWS = 64;             // stacked query rows per block
constexpr int TC_THREADS = 128;         // 4 warps x 16 rows
constexpr int TC_STAGES = 2;            // pages in the ring

struct TcLayout {
  int rs, page, stage, conv, crs, phs, total;       // bytes
};

__host__ __device__ inline TcLayout tc_layout(int dh, int bk, int es,
                                              int n_pg) {
  TcLayout L;
  L.rs = dh * es + 16;                  // padded row of a landed page
  L.page = bk * L.rs;
  L.stage = 2 * L.page + 2 * bk * 4;    // K, V; k, v row scales
  int off = TC_STAGES * L.stage;
  L.conv = off;                         // codes: K, V converted to bf16
  L.crs = dh * 2 + 16;
  if (es == 1) off += 2 * bk * L.crs;
  L.phs = off;                          // physical page of each visible page
  off += n_pg * 4;
  L.total = off;
  return L;
}

__device__ __forceinline__ void store_bf16x4(unsigned char* dst, float4 x) {
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
}

template <int DH, typename PT>
__global__ void __launch_bounds__(TC_THREADS, 3)
prefill_tc_kernel(const __nv_bfloat16* __restrict__ q,
                  const PT* __restrict__ kp, const PT* __restrict__ vp,
                  const float* __restrict__ kscale,
                  const float* __restrict__ vscale,
                  const int* __restrict__ page_row, float* __restrict__ o,
                  int c, int n_rep, int bk, int n_pg, int offset, int window,
                  int prefix_len, int n_pages, int hkv, float sm_scale) {
  constexpr int KS = DH / 16;           // k-steps of Q K^T
  constexpr int NO = DH / 8;            // n-tiles of a row block of o
  constexpr bool CODES = sizeof(PT) == 1;
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ __align__(128) unsigned char smem[];
  const TcLayout L = tc_layout(DH, bk, sizeof(PT), n_pg);
  int* phs = reinterpret_cast<int*>(smem + L.phs);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;    // fragment row, column pair
  const int head = blockIdx.y, nrows = n_rep * c;
  const int r0 = blockIdx.x * TC_ROWS;
  const int ra = r0 + warp * 16 + gq, rb = ra + 8;   // this thread's rows
  const int pos_a = offset + ra % c, pos_b = offset + rb % c;
  const int r_end = min(nrows, r0 + TC_ROWS);
  const bool one_head = r0 / c == (r_end - 1) / c;
  const int pos_min = offset + (one_head ? r0 % c : 0);
  const int pos_max = offset + (one_head ? (r_end - 1) % c : c - 1);

  // ---- the visible pages, ascending: the prefix pages, then [lo2, hi) ----
  const int hi = min(n_pg, pos_max / bk + 1);
  int lo = 0;
  if (window >= 0) {
    const int x = pos_min - window + 1;
    lo = x > 0 ? x / bk : 0;
  }
  const int n_pref = min(n_pg, (prefix_len + bk - 1) / bk);
  const int lo2 = max(lo, n_pref);
  const int n_vis = n_pref + max(0, hi - lo2);
  for (int i = tid; i < n_vis; i += TC_THREADS) {
    const int ph = page_row[i < n_pref ? i : lo2 + (i - n_pref)];
    phs[i] = ph < 0 || ph >= n_pages ? -1 : ph;
  }

  // ---- Q as A-fragments: rows ra / rb, columns 16 ks + 2 tq (+ 8) ----
  const __nv_bfloat16* qh = q + (size_t)head * nrows * DH;
  const uint32_t* qa_row = reinterpret_cast<const uint32_t*>(qh + (size_t)ra * DH);
  const uint32_t* qb_row = reinterpret_cast<const uint32_t*>(qh + (size_t)rb * DH);
  const bool va = ra < nrows, vb = rb < nrows;
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int w = ks * 8 + tq;
    qa[ks][0] = va ? qa_row[w] : 0u;
    qa[ks][1] = vb ? qb_row[w] : 0u;
    qa[ks][2] = va ? qa_row[w + 4] : 0u;
    qa[ks][3] = vb ? qb_row[w + 4] : 0u;
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.0f, l_b = 0.0f;

  // ---- the ring: page i lands in stage i % TC_STAGES ----
  const int cpr = DH * (int)sizeof(PT) / 16;        // 16-byte pieces a row
  const int chunks = bk * cpr;
  auto issue = [&](int i) {
    if (i < n_vis && phs[i] >= 0) {
      unsigned char* st = smem + (i % TC_STAGES) * L.stage;
      const size_t pg = (size_t)phs[i] * hkv + head;
      const unsigned char* ksrc =
          reinterpret_cast<const unsigned char*>(kp + pg * bk * DH);
      const unsigned char* vsrc =
          reinterpret_cast<const unsigned char*>(vp + pg * bk * DH);
      for (int e = tid; e < chunks; e += TC_THREADS) {
        const int row = e / cpr;
        const int d = row * L.rs + (e - row * cpr) * 16;
        cp_async16(st + d, ksrc + (size_t)e * 16);
        cp_async16(st + L.page + d, vsrc + (size_t)e * 16);
      }
      if (CODES)
        for (int e = tid; e < bk / 4; e += TC_THREADS) {
          cp_async16(st + 2 * L.page + e * 16, kscale + pg * bk + 4 * e);
          cp_async16(st + 2 * L.page + bk * 4 + e * 16,
                     vscale + pg * bk + 4 * e);
        }
    }
    cp_async_commit();
  };

  __syncthreads();                      // phs
#pragma unroll
  for (int i = 0; i < TC_STAGES - 1; ++i) issue(i);

  const int nkp = bk / 16;              // 16-key steps of a page
  // ldmatrix row addresses (key, dim) of this lane for K and for V^T
  const int k_key = (lane & 7) + ((lane >> 4) << 3);
  const int k_dim = ((lane >> 3) & 1) << 3;
  const int v_key = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int v_dim = (lane >> 4) << 3;

  for (int i = 0; i < n_vis; ++i) {
    issue(i + TC_STAGES - 1);
    cp_async_wait<TC_STAGES - 1>();
    __syncthreads();                    // page i landed for every thread
    if (phs[i] >= 0) {                  // uniform: skip an unmapped entry
      const int p = i < n_pref ? i : lo2 + (i - n_pref);
      unsigned char* st = smem + (i % TC_STAGES) * L.stage;
      const float* ksc = reinterpret_cast<const float*>(st + 2 * L.page);
      const float* vsc = ksc + bk;
      const unsigned char* kb = st;
      const unsigned char* vb = st + L.page;
      int rs = L.rs;
      if (CODES) {                      // codes -> bf16 rows, once a page
        unsigned char* kc = smem + L.conv;
        unsigned char* vc = kc + bk * L.crs;
        for (int e = tid; e < bk * DH / 4; e += TC_THREADS) {
          const int row = e / (DH / 4), col = 4 * (e - row * (DH / 4));
          const PT* ks_row = reinterpret_cast<const PT*>(st + row * L.rs);
          const PT* vs_row = reinterpret_cast<const PT*>(st + L.page + row * L.rs);
          store_bf16x4(kc + row * L.crs + col * 2, ld4(ks_row + col));
          store_bf16x4(vc + row * L.crs + col * 2, ld4(vs_row + col));
        }
        kb = kc;
        vb = vc;
        rs = L.crs;
        __syncthreads();
      }
      const unsigned kaddr = smem_u32(kb), vaddr = smem_u32(vb);

      // ---- S = Q K^T: 16 rows x bk keys of this warp ----
      float s[BKMAX / 8][4];
#pragma unroll
      for (int n = 0; n < BKMAX / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int np = 0; np < BKMAX / 16; ++np)
          if (np < nkp) {
            uint32_t b0, b1, b2, b3;
            ldsm_x4(kaddr + (np * 16 + k_key) * rs + (ks * 16 + k_dim) * 2,
                    b0, b1, b2, b3);
            mma_bf16(s[2 * np], qa[ks], b0, b1);
            mma_bf16(s[2 * np + 1], qa[ks], b2, b3);
          }

      // ---- mask (none where every row of the tile sees the whole page),
      // online softmax on the fragments ----
      const bool whole = (p + 1) * bk - 1 <= pos_min &&
                         (window < 0 || p * bk >= pos_max - window + 1);
      float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
      for (int n = 0; n < BKMAX / 8; ++n) {
        if (n * 8 >= bk) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = n * 8 + 2 * tq + (e & 1);
          bool vis = true;
          if (!whole) {
            const int col = p * bk + kk, pos = e < 2 ? pos_a : pos_b;
            vis = pos >= col;
            if (window >= 0) vis = vis && col >= pos - window + 1;
            if (prefix_len) vis = vis || col < prefix_len;
          }
          float x = s[n][e];
          if (CODES) x = __fmul_rn(x, ksc[kk]);
          x = vis ? __fmul_rn(x, sm_scale) : NEG_INF;
          s[n][e] = x;
          if (e < 2) mx_a = fmaxf(mx_a, x);
          else mx_b = fmaxf(mx_b, x);
        }
      }
      mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL, mx_b, 2));
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float ms_a = mn_a > HALF_NEG ? mn_a : 0.0f;
      const float ms_b = mn_b > HALF_NEG ? mn_b : 0.0f;
      float ps_a = 0.0f, ps_b = 0.0f;
#pragma unroll
      for (int n = 0; n < BKMAX / 8; ++n) {
        if (n * 8 >= bk) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[n][e];
          const float pr = x > HALF_NEG ? expf(x - (e < 2 ? ms_a : ms_b)) : 0.0f;
          s[n][e] = pr;
          if (e < 2) ps_a = __fadd_rn(ps_a, pr);
          else ps_b = __fadd_rn(ps_b, pr);
        }
      }
      ps_a = __fadd_rn(ps_a, __shfl_xor_sync(FULL, ps_a, 1));
      ps_a = __fadd_rn(ps_a, __shfl_xor_sync(FULL, ps_a, 2));
      ps_b = __fadd_rn(ps_b, __shfl_xor_sync(FULL, ps_b, 1));
      ps_b = __fadd_rn(ps_b, __shfl_xor_sync(FULL, ps_b, 2));
      const float cr_a = expf((m_a > HALF_NEG ? m_a : ms_a) - ms_a);
      const float cr_b = expf((m_b > HALF_NEG ? m_b : ms_b) - ms_b);
      l_a = __fadd_rn(__fmul_rn(l_a, cr_a), ps_a);
      l_b = __fadd_rn(__fmul_rn(l_b, cr_b), ps_b);
      m_a = mn_a;
      m_b = mn_b;
      // ---- P as A-fragments of bf16 terms, keys 16 kk .. 16 kk + 15 ----
      uint32_t pa[BKMAX / 16][PV_TERMS][4];
#pragma unroll
      for (int kk = 0; kk < BKMAX / 16; ++kk) {
        if (kk >= nkp) continue;
        float x[8] = {s[2 * kk][0],     s[2 * kk][1],     s[2 * kk][2],
                      s[2 * kk][3],     s[2 * kk + 1][0], s[2 * kk + 1][1],
                      s[2 * kk + 1][2], s[2 * kk + 1][3]};
        if (CODES) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            x[j] = __fmul_rn(x[j], vsc[kk * 16 + ((j >> 2) << 3) + 2 * tq + (j & 1)]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float lo = x[2 * j], hi = x[2 * j + 1];
#pragma unroll
          for (int t = 0; t < PV_TERMS; ++t) {
            pa[kk][t][j] = pack_bf16(lo, hi);
            lo = __fsub_rn(lo, __bfloat162float(__float2bfloat16_rn(lo)));
            hi = __fsub_rn(hi, __bfloat162float(__float2bfloat16_rn(hi)));
          }
        }
      }

      // ---- acc = acc * corr + P V: the page's P V in fresh accumulators
      // (a tensor core truncates what it adds to a large accumulator; the
      // sum over pages is rounded in f32, as the reference's), four 16-column
      // slices at a time for eight independent mma chains ----
#pragma unroll
      for (int dg = 0; dg < DH / 64; ++dg) {
        float x[8][4];
#pragma unroll
        for (int u = 0; u < 8; ++u) x[u][0] = x[u][1] = x[u][2] = x[u][3] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < BKMAX / 16; ++kk) {
          if (kk >= nkp) continue;
#pragma unroll
          for (int d4 = 0; d4 < 4; ++d4) {
            const int dn = dg * 4 + d4;
            uint32_t b0, b1, b2, b3;
            ldsm_x4_t(vaddr + (kk * 16 + v_key) * rs + (dn * 16 + v_dim) * 2,
                      b0, b1, b2, b3);
#pragma unroll
            for (int t = PV_TERMS - 1; t >= 0; --t) {   // smallest first
              mma_bf16(x[2 * d4], pa[kk][t], b0, b1);
              mma_bf16(x[2 * d4 + 1], pa[kk][t], b2, b3);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 8; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float cr = e < 2 ? cr_a : cr_b;
            acc[dg * 8 + u][e] =
                __fadd_rn(__fmul_rn(acc[dg * 8 + u][e], cr), x[u][e]);
          }
      }
    }
    __syncthreads();                    // stage i % TC_STAGES may be refilled
  }

  // ---- o = acc / max(l, 1e-20) for the valid stacked rows ----
  float* oh = o + (size_t)head * nrows * DH;
  const float la = fmaxf(l_a, 1e-20f), lb = fmaxf(l_b, 1e-20f);
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (va)
      *reinterpret_cast<float2*>(oh + (size_t)ra * DH + n * 8 + 2 * tq) =
          make_float2(acc[n][0] / la, acc[n][1] / la);
    if (vb)
      *reinterpret_cast<float2*>(oh + (size_t)rb * DH + n * 8 + 2 * tq) =
          make_float2(acc[n][2] / lb, acc[n][3] / lb);
  }
}

// ===========================================================================
// prefill_f32_kernel: f32 operands on CUDA cores
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
prefill_f32_kernel(const QT* __restrict__ q, const PT* __restrict__ kp,
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

struct PrefillArgs {
  const void *q, *kp, *vp, *ks, *vs, *page_row;
  void* o;
  int h, c, n_rep, dh, bk, max_p, offset, window, prefix_len, n_pages, hkv;
  float sm_scale;
  cudaStream_t stream;
};

// Pages the chunk can reach: p * bk < offset + C, at most max_p.
inline int chunk_pages(const PrefillArgs& a) {
  return a.max_p < (a.offset + a.c + a.bk - 1) / a.bk
             ? a.max_p : (a.offset + a.c + a.bk - 1) / a.bk;
}

template <int DH, typename PT>
int run_tc(const PrefillArgs& a) {
  const int n_pg = chunk_pages(a);
  const int smem = tc_layout(DH, a.bk, sizeof(PT), n_pg).total;
  auto kern = prefill_tc_kernel<DH, PT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int nrows = a.n_rep * a.c;
  const dim3 grid((nrows + TC_ROWS - 1) / TC_ROWS, a.hkv);
  kern<<<grid, TC_THREADS, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const PT*>(a.kp),
      static_cast<const PT*>(a.vp), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.page_row),
      static_cast<float*>(a.o), a.c, a.n_rep, a.bk, n_pg, a.offset, a.window,
      a.prefix_len, a.n_pages, a.hkv, a.sm_scale);
  return (int)cudaGetLastError();
}

template <typename PT>
int tc_dh(const PrefillArgs& a) {
  return a.dh == 64 ? run_tc<64, PT>(a) : run_tc<128, PT>(a);
}

template <typename QT, typename PT>
int run_f32(const PrefillArgs& a) {
  const size_t smem = prefill_layout(a.bk, a.dh).total;
  auto kern = prefill_f32_kernel<QT, PT>;
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

}  // namespace

// C entries, bound with ctypes.  paged_prefill returns cudaGetLastError()
// after the launch (0 on success); the caller raises on anything else.
// A bf16 q over a bf16 / int8 / e4m3 pool runs prefill_tc_kernel; an f32 q
// or an f32 pool runs prefill_f32_kernel.
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
  if (q_bf16 && pool == P_BF16) return tc_dh<__nv_bfloat16>(a);
  if (q_bf16 && pool == P_I8) return tc_dh<int8_t>(a);
  if (q_bf16 && pool == P_E4M3) return tc_dh<__nv_fp8_e4m3>(a);
  switch (pool) {
    case P_F32:
      return q_bf16 ? run_f32<__nv_bfloat16, float>(a) : run_f32<float, float>(a);
    case P_BF16: return run_f32<float, __nv_bfloat16>(a);
    case P_I8: return run_f32<float, int8_t>(a);
    case P_E4M3: return run_f32<float, __nv_fp8_e4m3>(a);
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory per block of prefill_tc_kernel at these shapes
// (element size es of the pool, n_pg pages within the chunk's reach).
extern "C" int paged_prefill_smem(int dh, int bk, int es, int n_pg) {
  return tc_layout(dh, bk, es, n_pg).total;
}
