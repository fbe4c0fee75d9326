// Backward of the SLA2 sparse branch (paper Algorithm 3), hand-written for
// Hopper (sm_90a): dQ and dK/dV, each as a bf16 tensor-core kernel and an
// f32 CUDA-core kernel, chosen by the operands' dtype (a choice by input,
// not a fallback on failure).
//
// Replaces: repro/kernels/sla2_bwd.py::_dq_kernel (sla2_bwd_dq_tc,
// sla2_bwd_dq) and ::_dkv_kernel (sla2_bwd_dkv_tc, sla2_bwd_dkv), the
// Pallas TPU kernels behind sparse_flash_bwd.  All compute what the Pallas
// kernels compute, always in full precision (the QAT backward, even after
// an int8 forward):
//   s   = q k^T * sm_scale, sm_scale = 1/sqrt(d); NEG_INF = -1e30 where the
//         causal mask hides (rows >= cols, OR cols < prefix_len);
//   p   = exp(s - lse_safe), lse_safe = lse > NEG_INF/2 ? lse : 0, and 0
//         where s or lse is masked;
//   dp  = dO v^T;  ds = p (dp - dd) sm_scale, dd = rowsum(dO . O) (f32,
//         computed by the wrapper);
//   dQ_i += ds k_j;  dV_j += p^T dO_i;  dK_j += ds^T q_i.
// dK/dV follows the TPU's monotone revisit schedule: the wrapper sorts the
// (i, jj) -> j pairs stably by j (sort_pairs) and gives each j the offsets
// of its run; a block walks its run in ascending i.  No atomics: every
// output tile has one writer, so results do not change from run to run.  A
// kv block that no valid pair visits gets zeros (the reference's gate).
//
// Bounds at the main shape (wan-dit-1.3b training at 32k latents: BH = 12,
// N = 32768, d = 128, bq = 128, bk = 64, K_sel = 26, 79,872 routed pairs):
//   operations: dQ 3 products x 2*128*64*128 x 79,872 = 502.5 GFLOP (+654 M
//     exp), 0.508 ms on the bf16 tensor-core peak (989 TFLOP/s); dK/dV 4
//     products, 670.0 GFLOP, 0.677 ms.  (7.50 / 10.0 ms on the f32
//     CUDA-core peak of 67 TFLOP/s.)  Each tile read once: 0.51 / 0.61 GB,
//     0.15 / 0.18 ms at 3.35 TB/s, so both bound by operations.
//   gathered bytes: a routed design reads a tile per pair.  dQ gathers a
//     64 x 128 bf16 K and V tile per pair, 2.62 GB, 0.78 ms at 3.35 TB/s;
//     dK/dV a 128 x 128 bf16 Q and dO tile per pair, 5.23 GB, 1.56 ms.
//     Only the 50 MB L2 catches repeats (one head's K and V, or Q and dO,
//     is 16.8 MB), so a routed backward lands at a few ms, above both.
//
// bf16 design (the DiT's path):
//   - S = Q K^T and dP = dO V^T on mma.sync m16n8k16 (bf16 operands, f32
//     accumulators) from the stored bf16 tiles: the products are exact,
//     only the order of the sums departs from the reference.
//   - P and dS in f32 on the accumulator fragments, masks as above, expf
//     (no --use_fast_math).
//   - dQ += dS K, dV += P^T dO and dK += dS^T Q have an f32 operand: P and
//     dS enter as TERMS = 2 bf16 terms, hi = bf16(x), lo = bf16(x - hi),
//     each multiplied by the bf16 partner (per-element error near 2^-17,
//     below the bf16 rounding of the outputs).  One term, the usual GPU
//     practice, rounds P and dS to bf16: tools/bwd_variants.py builds it
//     beside the two (PERF.md has both errors).  Every tile's (dQ) or
//     16-query chunk's (dK/dV) product goes into fresh fragments that are
//     added into f32 register sums: a tensor core truncates what it adds to
//     a large accumulator, which biased the paged prefill's P V.
//   - Tiles land in shared memory through 16-byte cp.async, rows padded by
//     16 bytes so that ldmatrix (plain and .trans) is free of bank
//     conflicts.  mma.sync and cp.async, the route of paged_prefill.cu,
//     rather than wgmma and TMA: the fragments of S and dP stay in
//     registers as the A operands of the next products, and the port's
//     CPU emulation of the PTX (see the verify notes) covers mma.sync and
//     ldmatrix.
//   - sla2_bwd_dq_tc: one block per (bh, query block i) covering all bq
//     rows, a warp per 16 rows (8 warps at bq 128, fewer below), so each
//     routed K/V tile is gathered once per pair.  Q and dO are staged once;
//     the row's valid entries are compacted first (idx and valid read
//     ahead), and their K/V tiles flow through a DQ_STAGES-deep ring, the
//     next tile's copy issued before this tile's mma.
//   - sla2_bwd_dkv_tc: one block of 8 warps per work item.  A kv block's
//     run is as long as the number of query blocks that route it: at the
//     main shape mean 13.0, p99 115, max 196 valid pairs, so one block per
//     run left the longest as a tail.  The wrapper cuts each run into items
//     of at most DKV_ITEM pairs (a plan derived on the device from the run
//     offsets, no host sync); a run of one item writes dK, dV, the items of
//     a longer run write f32 partials that sla2_bwd_dkv_combine adds in
//     item order (no atomics).  K_j, V_j are staged once per item; the
//     item's valid pairs are compacted, and each pair's Q_i, dO_i, lse and
//     dd rows flow through a DKV_STAGES-deep ring.  Warp w takes kv rows
//     16 (w % 4) and every other 16-query chunk: S^T = K Q^T and
//     dP^T = V dO^T leave P^T and dS^T in kv-row-major fragments that are
//     already the A operands of P^T dO and dS^T Q (dO, Q by
//     ldmatrix.trans).  The two halves' sums meet in shared memory at the
//     end, in a fixed order.
//   - The main tiling (MAIN_D, MAIN_BQ, MAIN_BK) is compiled with its sizes
//     fixed: dQ 240 registers, no spills; dK/dV 255 registers and 4 bytes
//     spilled; 175,120 and 177,168 bytes of dynamic shared memory, one
//     block of 256 threads per SM.  With run-time sizes: 210 and 203
//     registers, no spills (ptxas -v, chip_smoke.py phase 2).
//   - At the main shape (chip_smoke.py phase 6, H100 80GB HBM3, 700 W):
//     see PERF.md; about 16% and 13% of the operations bound, 25% and 30%
//     of the gathered-bytes floor.  What holds them back: every warp reads
//     the whole K/V (dQ) or Q/dO (dK/dV) tile through ldmatrix, so shared
//     memory bandwidth and issue, not the tensor cores, set the pace, with
//     one block of 8 warps per SM to hide the latency.  wgmma reading B from
//     shared memory once per warpgroup is the next step.
//
// f32 design (the f32 tests and paths): the CUDA-core kernels of the first
// port, unchanged: every product as f32 FMA from odd-stride f32 tiles
// (129, 65) in shared memory, a 16 x 16 thread grid with 4 x 4 (S, dP) and
// 4 x 8 (dQ, dK, dV) register tiles; dQ over 64-row chunks.
// No --use_fast_math: it would change expf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int BKMAX = 64;               // largest block_k
constexpr int DMAX = 128;               // largest head dim
constexpr float NEG_INF = -1e30f;
constexpr float HALF_NEG = -5e29f;      // NEG_INF * 0.5

// ===========================================================================
// f32 operands: CUDA-core kernels
// ===========================================================================

constexpr int NT = 256;                 // threads: a 16 x 16 grid
constexpr int RT = 64;                  // query rows per chunk
constexpr int LD = DMAX + 1;            // row stride of (rows, d) tiles
constexpr int LDP = BKMAX + 1;          // row stride of (rows, bk) tiles

// A (rows, d) tile, row-major with stride d in global memory, into shared
// memory as f32 with stride LD.
__device__ __forceinline__ void load_tile(float* dst, const float* src, int rows,
                                          int d) {
  for (int e = threadIdx.x; e < rows * d; e += NT) {
    const int r = e / d, c = e - r * d;
    dst[r * LD + c] = src[e];
  }
}

// acc[a][b] = sum_k A[ty + 16a][k] * B[tx + 16b][k], both tiles stride LD.
__device__ __forceinline__ void tile_abt(const float* A, const float* B,
                                         int d, float acc[4][4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
#pragma unroll 4
  for (int k = 0; k < d; ++k) {
    float x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = A[(ty + 16 * a) * LD + k];
#pragma unroll
    for (int b = 0; b < 4; ++b) y[b] = B[(tx + 16 * b) * LD + k];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(x[a], y[b], acc[a][b]);
  }
}

// For the thread's 4 x 4 entries (row r = ty + 16a, key c = tx + 16b) of a
// (query chunk at row0, kv block at col0) tile: turns the s sums into p and
// the dp sums into ds, in place.
__device__ __forceinline__ void probs_and_ds(
    float s[4][4], float dp[4][4], const float* lse_s, const float* dd_s,
    int row0, int col0, int causal, int prefix_len, float sm_scale) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    const float l = lse_s[r];
    const bool l_ok = l > HALF_NEG;
    const float l_safe = l_ok ? l : 0.0f;
    const float ddr = dd_s[r];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int col = col0 + tx + 16 * b;
      float sv = s[a][b] * sm_scale;
      if (causal && !(row0 + r >= col || col < prefix_len)) sv = NEG_INF;
      const float p = (sv > HALF_NEG && l_ok) ? expf(sv - l_safe) : 0.0f;
      s[a][b] = p;
      dp[a][b] = p * (dp[a][b] - ddr) * sm_scale;
    }
  }
}

// ===========================================================================
// dQ: one block per (bh, chunk of min(bq, 64) query rows)
// ===========================================================================

__global__ void __launch_bounds__(NT, 1)
sla2_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dO,
            const float* __restrict__ lse, const float* __restrict__ dd,
            const int* __restrict__ idx, const int* __restrict__ valid,
            float* __restrict__ dq, int n_q, int n_kv, int d, int bq, int bk,
            int k_sel, int causal, int prefix_len, float sm_scale) {
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;
  float* dOs = Qs + RT * LD;
  float* Ks = dOs + RT * LD;
  float* Vs = Ks + BKMAX * LD;
  float* Ps = Vs + BKMAX * LD;                     // ds of the current tile
  float* lse_s = Ps + RT * LDP;
  float* dd_s = lse_s + RT;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int rows = bq < RT ? bq : RT;
  const int chunks = bq / rows;
  const int i = blockIdx.x / chunks;
  const int row0 = i * bq + (blockIdx.x - i * chunks) * rows;
  const int b = blockIdx.y;
  const size_t qoff = ((size_t)b * n_q + row0) * d;

  load_tile(Qs, q + qoff, rows, d);
  load_tile(dOs, dO + qoff, rows, d);
  for (int r = tid; r < rows; r += NT) {
    lse_s[r] = lse[(size_t)b * n_q + row0 + r];
    dd_s[r] = dd[(size_t)b * n_q + row0 + r];
  }
  float acc[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[a][e] = 0.0f;

  const size_t row_ix = ((size_t)b * (n_q / bq) + i) * k_sel;
  for (int jj = 0; jj < k_sel; ++jj) {
    if (valid[row_ix + jj] != 1) continue;         // uniform over the block
    const int j = idx[row_ix + jj];
    __syncthreads();          // the last tile's readers are done
    const size_t koff = ((size_t)b * n_kv + (size_t)j * bk) * d;
    load_tile(Ks, k + koff, bk, d);
    load_tile(Vs, v + koff, bk, d);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_abt(Qs, Ks, d, s);
    tile_abt(dOs, Vs, d, dp);
    probs_and_ds(s, dp, lse_s, dd_s, row0, j * bk, causal, prefix_len,
                 sm_scale);                        // dp now holds ds
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        Ps[(ty + 16 * a) * LDP + tx + 16 * c] = dp[a][c];
    __syncthreads();
    // dQ[r][e] += sum_c ds[r][c] k[c][e], r = ty + 16a, e = tx + 16e'
#pragma unroll 4
    for (int c = 0; c < bk; ++c) {
      float x[4], y[8];
#pragma unroll
      for (int a = 0; a < 4; ++a) x[a] = Ps[(ty + 16 * a) * LDP + c];
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] = Ks[c * LD + tx + 16 * e];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[a][e] = fmaf(x[a], y[e], acc[a][e]);
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    if (r >= rows) continue;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int col = tx + 16 * e;
      if (col < d) dq[qoff + (size_t)r * d + col] = acc[a][e];
    }
  }
}

// ===========================================================================
// dK / dV: one block per (bh, kv block j), along its run of sorted pairs
// ===========================================================================

__global__ void __launch_bounds__(NT, 1)
sla2_bwd_dkv(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dO,
             const float* __restrict__ lse, const float* __restrict__ dd,
             const int* __restrict__ is_, const int* __restrict__ vs,
             const int* __restrict__ off, float* __restrict__ dk,
             float* __restrict__ dv, int n_q, int n_kv, int d, int bq, int bk,
             int k_sel, int causal, int prefix_len, float sm_scale) {
  extern __shared__ __align__(16) float sm[];
  float* Ks = sm;
  float* Vs = Ks + BKMAX * LD;
  float* Qs = Vs + BKMAX * LD;
  float* dOs = Qs + RT * LD;
  float* Ps = dOs + RT * LD;
  float* dSs = Ps + RT * LDP;
  float* lse_s = dSs + RT * LDP;
  float* dd_s = lse_s + RT;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int j = blockIdx.x, b = blockIdx.y;
  const int t_n = n_kv / bk;
  const int rows = bq < RT ? bq : RT;
  const int chunks = bq / rows;
  const size_t n_pairs = (size_t)(n_q / bq) * k_sel;
  const size_t koff = ((size_t)b * n_kv + (size_t)j * bk) * d;

  load_tile(Ks, k + koff, bk, d);
  load_tile(Vs, v + koff, bk, d);
  float dk_acc[4][8], dv_acc[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < 8; ++e) dk_acc[a][e] = dv_acc[a][e] = 0.0f;

  const int p0 = off[(size_t)b * (t_n + 1) + j];
  const int p1 = off[(size_t)b * (t_n + 1) + j + 1];
  for (int p = p0; p < p1; ++p) {
    if (vs[b * n_pairs + p] != 1) continue;        // uniform over the block
    const int i = is_[b * n_pairs + p];
    for (int h = 0; h < chunks; ++h) {
      const int row0 = i * bq + h * rows;
      const size_t qoff = ((size_t)b * n_q + row0) * d;
      __syncthreads();        // the last chunk's readers are done
      load_tile(Qs, q + qoff, rows, d);
      load_tile(dOs, dO + qoff, rows, d);
      for (int r = tid; r < rows; r += NT) {
        lse_s[r] = lse[(size_t)b * n_q + row0 + r];
        dd_s[r] = dd[(size_t)b * n_q + row0 + r];
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      tile_abt(Qs, Ks, d, s);
      tile_abt(dOs, Vs, d, dp);
      probs_and_ds(s, dp, lse_s, dd_s, row0, j * bk, causal, prefix_len,
                   sm_scale);                      // s holds p, dp holds ds
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          Ps[(ty + 16 * a) * LDP + tx + 16 * c] = s[a][c];
          dSs[(ty + 16 * a) * LDP + tx + 16 * c] = dp[a][c];
        }
      __syncthreads();
      // dV[c][e] += sum_r p[r][c] dO[r][e];  dK[c][e] += sum_r ds[r][c] q[r][e]
      // with key c = ty + 16a and column e = tx + 16e'
#pragma unroll 2
      for (int r = 0; r < rows; ++r) {
        float xp[4], xs[4], yo[8], yq[8];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          xp[a] = Ps[r * LDP + ty + 16 * a];
          xs[a] = dSs[r * LDP + ty + 16 * a];
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          yo[e] = dOs[r * LD + tx + 16 * e];
          yq[e] = Qs[r * LD + tx + 16 * e];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            dv_acc[a][e] = fmaf(xp[a], yo[e], dv_acc[a][e]);
            dk_acc[a][e] = fmaf(xs[a], yq[e], dk_acc[a][e]);
          }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int c = ty + 16 * a;
    if (c >= bk) continue;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int col = tx + 16 * e;
      if (col < d) {
        dk[koff + (size_t)c * d + col] = dk_acc[a][e];
        dv[koff + (size_t)c * d + col] = dv_acc[a][e];
      }
    }
  }
}

// ===========================================================================
// bf16 operands: tensor-core kernels
// ===========================================================================

constexpr int TERMS = 2;                // bf16 terms of P and dS (hi, lo)
constexpr int TC_THREADS = 256;         // 8 warps
constexpr int DQ_STAGES = 3;            // K/V tiles in the dQ ring
constexpr int DKV_STAGES = 2;           // Q/dO tiles in the dK/dV ring
constexpr int LIST = 256;               // routed entries compacted at once
constexpr int DKV_ITEM = 32;            // pairs of a dK/dV work item, at most
static_assert(DKV_ITEM <= LIST, "an item's pairs are compacted at once");
constexpr unsigned FULL = 0xffffffffu;
// The DiT's tiling (wan-dit-1.3b: d 128, bq 128, bk 64), for which each
// kernel is also built with the sizes known at compile time: every loop
// then unrolls without run-time guards, about a quarter faster for dQ and a
// sixth for dK/dV (tools/bwd_variants.py, PERF.md).  Other shapes take the
// same code with the sizes as arguments.
constexpr int MAIN_D = 128, MAIN_BQ = 128, MAIN_BK = 64;

// Shared-memory rows of bf16 tiles are padded by 16 bytes: the 8 rows an
// ldmatrix reads then fall on distinct banks for every d % 16 == 0.
__host__ __device__ inline int row_bytes(int d) { return d * 2 + 16; }

// rows x d bf16, row-major in global memory, into padded shared rows with
// 16-byte cp.async pieces (issued, not waited for).
__device__ __forceinline__ void load_rows(unsigned char* dst,
                                          const __nv_bfloat16* src, int rows,
                                          int d) {
  const int cpr = d / 8, rs = row_bytes(d);
  for (int e = threadIdx.x; e < rows * cpr; e += blockDim.x) {
    const int r = e / cpr, c = e - r * cpr;
    cp_async16(dst + r * rs + c * 16, src + (size_t)r * d + c * 8);
  }
}

// The n entries vals[e] with flags[e] == 1, in ascending e, into list;
// returns their count.  Warp 0 compacts with a ballot; every thread calls.
__device__ int compact(const int* vals, const int* flags, int n, int* list,
                       int* count) {
  __syncthreads();                      // the last list and count are read
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int c = 0;
    for (int base = 0; base < n; base += 32) {
      const int e = base + lane;
      const bool ok = e < n && flags[e] == 1;
      const unsigned m = __ballot_sync(FULL, ok);
      if (ok) list[c + __popc(m & ((1u << lane) - 1u))] = vals[e];
      c += __popc(m);
    }
    if (lane == 0) *count = c;
  }
  __syncthreads();
  return *count;
}

// x as bf16 terms: t[0] = bf16(x), t[1] = bf16(x - t[0]), ... (pairs of
// values packed as one A-fragment register each).
__device__ __forceinline__ void split_terms(float lo, float hi,
                                            uint32_t (&t)[TERMS]) {
#pragma unroll
  for (int k = 0; k < TERMS; ++k) {
    t[k] = pack_bf16(lo, hi);
    lo = __fsub_rn(lo, __bfloat162float(__float2bfloat16_rn(lo)));
    hi = __fsub_rn(hi, __bfloat162float(__float2bfloat16_rn(hi)));
  }
}

// p = exp(s * scale - lse_safe) under the masks, and ds = p (dp - dd) scale,
// for one (query row, key column) entry.
__device__ __forceinline__ void prob_ds(float& s, float& dp, float l, float dd,
                                        int row, int col, int causal,
                                        int prefix_len, float sm_scale) {
  float sv = s * sm_scale;
  if (causal && !(row >= col || col < prefix_len)) sv = NEG_INF;
  const bool l_ok = l > HALF_NEG;
  const float p = (sv > HALF_NEG && l_ok) ? expf(sv - (l_ok ? l : 0.0f)) : 0.0f;
  s = p;
  dp = p * (dp - dd) * sm_scale;
}

// ---------------------------------------------------------------------------
// dQ: one block per (bh, query block i), a warp per 16 of its bq rows
// ---------------------------------------------------------------------------

struct DqLayout {
  int q, o, ring, stage, list, count, total;   // bytes
};

__host__ __device__ inline DqLayout dq_layout(int d, int bq, int bk) {
  DqLayout L;
  const int rs = row_bytes(d);
  L.q = 0;
  L.o = bq * rs;
  L.ring = 2 * bq * rs;
  L.stage = 2 * bk * rs;                // K, V
  L.list = L.ring + DQ_STAGES * L.stage;
  L.count = L.list + LIST * 4;
  L.total = L.count + 16;
  return L;
}

template <bool MAIN>
__global__ void __launch_bounds__(TC_THREADS, 1)
sla2_bwd_dq_tc(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const __nv_bfloat16* __restrict__ dO,
               const float* __restrict__ lse, const float* __restrict__ dd,
               const int* __restrict__ idx, const int* __restrict__ valid,
               __nv_bfloat16* __restrict__ dq, int n_q, int n_kv, int d,
               int bq, int bk, int k_sel, int causal, int prefix_len,
               float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (MAIN) {
    d = MAIN_D;
    bq = MAIN_BQ;
    bk = MAIN_BK;
  }
  const DqLayout L = dq_layout(d, bq, bk);
  int* list = reinterpret_cast<int*>(smem + L.list);
  const int rs = row_bytes(d);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;    // fragment row, column pair
  const int i = blockIdx.x, b = blockIdx.y;
  const int nks = d / 16, nkp = bk / 16;
  const int ra = i * bq + warp * 16 + gq, rb = ra + 8;   // this thread's rows
  const size_t qoff = ((size_t)b * n_q + (size_t)i * bq) * d;
  const size_t row_ix = ((size_t)b * (n_q / bq) + i) * k_sel;

  load_rows(smem + L.q, q + qoff, bq, d);
  load_rows(smem + L.o, dO + qoff, bq, d);
  cp_async_commit();
  const float l_a = lse[(size_t)b * n_q + ra], l_b = lse[(size_t)b * n_q + rb];
  const float dd_a = dd[(size_t)b * n_q + ra], dd_b = dd[(size_t)b * n_q + rb];

  float acc[DMAX / 8][4];
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  // ldmatrix row addresses of this lane: A tiles (rows, k), B tiles stored
  // (n, k) and, transposed, (k, n)
  const int a_row = warp * 16 + (lane & 15), a_col = (lane >> 4) << 3;
  const int b_n = (lane & 7) + ((lane >> 4) << 3), b_k = ((lane >> 3) & 1) << 3;
  const int tr_k = (lane & 7) + (((lane >> 3) & 1) << 3), tr_n = (lane >> 4) << 3;
  const unsigned qaddr = smem_u32(smem + L.q), oaddr = smem_u32(smem + L.o);

  for (int w0 = 0; w0 < k_sel; w0 += LIST) {
    const int n = compact(idx + row_ix + w0, valid + row_ix + w0,
                          min(LIST, k_sel - w0), list,
                          reinterpret_cast<int*>(smem + L.count));
    auto issue = [&](int t) {
      if (t < n) {
        unsigned char* st = smem + L.ring + (t % DQ_STAGES) * L.stage;
        const size_t koff = ((size_t)b * n_kv + (size_t)list[t] * bk) * d;
        load_rows(st, k + koff, bk, d);
        load_rows(st + bk * rs, v + koff, bk, d);
      }
      cp_async_commit();
    };
#pragma unroll
    for (int t = 0; t < DQ_STAGES - 1; ++t) issue(t);
    for (int t = 0; t < n; ++t) {
      issue(t + DQ_STAGES - 1);
      cp_async_wait<DQ_STAGES - 1>();
      __syncthreads();                  // tile t (and Q, dO) landed
      const unsigned kaddr = smem_u32(smem + L.ring + (t % DQ_STAGES) * L.stage);
      const unsigned vaddr = kaddr + bk * rs;
      const int col0 = list[t] * bk;

      // ---- S = Q K^T and dP = dO V^T: 16 rows x bk keys of this warp ----
      float s[BKMAX / 8][4], dp[BKMAX / 8][4];
#pragma unroll
      for (int c = 0; c < BKMAX / 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[c][e] = dp[c][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < DMAX / 16; ++ks) {
        if (ks >= nks) continue;
        uint32_t qa[4], oa[4];
        ldsm_x4(qaddr + a_row * rs + (ks * 16 + a_col) * 2, qa[0], qa[1], qa[2], qa[3]);
        ldsm_x4(oaddr + a_row * rs + (ks * 16 + a_col) * 2, oa[0], oa[1], oa[2], oa[3]);
#pragma unroll
        for (int np = 0; np < BKMAX / 16; ++np) {
          if (np >= nkp) continue;
          const unsigned off = (np * 16 + b_n) * rs + (ks * 16 + b_k) * 2;
          uint32_t b0, b1, b2, b3;
          ldsm_x4(kaddr + off, b0, b1, b2, b3);
          mma_bf16(s[2 * np], qa, b0, b1);
          mma_bf16(s[2 * np + 1], qa, b2, b3);
          ldsm_x4(vaddr + off, b0, b1, b2, b3);
          mma_bf16(dp[2 * np], oa, b0, b1);
          mma_bf16(dp[2 * np + 1], oa, b2, b3);
        }
      }

      // ---- P, dS in f32 on the fragments; dS as bf16 A-fragment terms ----
      uint32_t da[BKMAX / 16][4][TERMS];
#pragma unroll
      for (int kk = 0; kk < BKMAX / 16; ++kk) {
        if (kk >= nkp) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 2 * kk + h;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            prob_ds(s[c][e], dp[c][e], e < 2 ? l_a : l_b, e < 2 ? dd_a : dd_b,
                    e < 2 ? ra : rb, col0 + c * 8 + 2 * tq + (e & 1), causal,
                    prefix_len, sm_scale);
          split_terms(dp[c][0], dp[c][1], da[kk][2 * h]);
          split_terms(dp[c][2], dp[c][3], da[kk][2 * h + 1]);
        }
      }

      // ---- dQ += dS K: each tile's product in fresh fragments (a tensor
      // core truncates what it adds to a large accumulator), added in f32;
      // 64 columns at a time, K^T from ldmatrix.trans ----
#pragma unroll
      for (int dg = 0; dg < DMAX / 64; ++dg) {
        if (dg * 4 >= nks) continue;
        float x[8][4];
#pragma unroll
        for (int u = 0; u < 8; ++u) x[u][0] = x[u][1] = x[u][2] = x[u][3] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < BKMAX / 16; ++kk) {
          if (kk >= nkp) continue;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int dn = dg * 4 + u;
            if (dn >= nks) continue;
            uint32_t b0, b1, b2, b3;
            ldsm_x4_t(kaddr + (kk * 16 + tr_k) * rs + (dn * 16 + tr_n) * 2, b0, b1, b2, b3);
#pragma unroll
            for (int tm = TERMS - 1; tm >= 0; --tm) {   // smallest first
              const uint32_t a[4] = {da[kk][0][tm], da[kk][1][tm], da[kk][2][tm],
                                     da[kk][3][tm]};
              mma_bf16(x[2 * u], a, b0, b1);
              mma_bf16(x[2 * u + 1], a, b2, b3);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 8; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[dg * 8 + u][e] += x[u][e];
      }
      __syncthreads();                  // stage t % DQ_STAGES may be refilled
    }
  }
  cp_async_wait<0>();

  __nv_bfloat16* dqa = dq + ((size_t)b * n_q + ra) * d + 2 * tq;
  __nv_bfloat16* dqb = dq + ((size_t)b * n_q + rb) * d + 2 * tq;
#pragma unroll
  for (int c = 0; c < DMAX / 8; ++c) {
    if (c * 8 >= d) continue;
    *reinterpret_cast<uint32_t*>(dqa + c * 8) = pack_bf16(acc[c][0], acc[c][1]);
    *reinterpret_cast<uint32_t*>(dqb + c * 8) = pack_bf16(acc[c][2], acc[c][3]);
  }
}

// ---------------------------------------------------------------------------
// dK / dV: one block per work item, at most DKV_ITEM consecutive pairs of
// one kv block's run (bh, j); warp w takes kv rows 16 (w % 4) .. + 15 and
// every other 16-query chunk of each pair, from chunk w / 4
// ---------------------------------------------------------------------------

struct DkvLayout {
  int k, v, ring, stage, lse, list, count, total;   // bytes
};

__host__ __device__ inline DkvLayout dkv_layout(int d, int bq, int bk) {
  DkvLayout L;
  const int rs = row_bytes(d);
  L.k = 0;
  L.v = bk * rs;
  L.ring = 2 * bk * rs;
  L.lse = 2 * bq * rs;                  // in a stage: Q, dO, lse, dd
  L.stage = L.lse + 2 * bq * 4;
  // the ring is reused at the end to hand the second half's sums over:
  // 4 warps x 32 lanes x (dK, dV) x d / 8 n-tiles x 4 floats = 128 d floats
  const int ring = DKV_STAGES * L.stage, handover = 128 * d * 4;
  L.list = L.ring + (ring > handover ? ring : handover);
  L.count = L.list + LIST * 4;
  L.total = L.count + 16;
  return L;
}

template <bool MAIN>
__global__ void __launch_bounds__(TC_THREADS, 1)
sla2_bwd_dkv_tc(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const __nv_bfloat16* __restrict__ dO,
                const float* __restrict__ lse, const float* __restrict__ dd,
                const int* __restrict__ is_, const int* __restrict__ vs,
                const int* __restrict__ off, const int* __restrict__ plan,
                const int* __restrict__ part_base, float* __restrict__ part,
                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                int n_q, int n_kv, int d, int bq, int bk, int k_sel,
                int causal, int prefix_len, float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int run = plan[2 * blockIdx.x], item = plan[2 * blockIdx.x + 1];
  if (run < 0) return;                  // past the last work item
  if (MAIN) {
    d = MAIN_D;
    bq = MAIN_BQ;
    bk = MAIN_BK;
  }
  const DkvLayout L = dkv_layout(d, bq, bk);
  int* list = reinterpret_cast<int*>(smem + L.list);
  const int rs = row_bytes(d);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int rg = warp & 3, half = warp >> 2;  // kv rows 16 rg..; chunk parity
  const int t_n = n_kv / bk, nks = d / 16, nqc = bq / 16;
  const int b = run / t_n, j = run - b * t_n;
  const bool rows_ok = rg * 16 < bk;
  const size_t n_pairs = (size_t)(n_q / bq) * k_sel;
  const size_t koff = ((size_t)b * n_kv + (size_t)j * bk) * d;
  const int r0 = off[(size_t)b * (t_n + 1) + j];
  const int p0 = r0 + item * DKV_ITEM;
  const int p1 = min(off[(size_t)b * (t_n + 1) + j + 1], p0 + DKV_ITEM);

  // the item's valid pairs (ascending i), then K_j, V_j unless there are none
  const int n = compact(is_ + b * n_pairs + p0, vs + b * n_pairs + p0,
                        max(p1 - p0, 0), list,
                        reinterpret_cast<int*>(smem + L.count));
  if (n > 0) {
    load_rows(smem + L.k, k + koff, bk, d);
    load_rows(smem + L.v, v + koff, bk, d);
  }
  cp_async_commit();

  float dk_acc[DMAX / 8][4], dv_acc[DMAX / 8][4];
#pragma unroll
  for (int c = 0; c < DMAX / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[c][e] = dv_acc[c][e] = 0.0f;

  const int a_row = rg * 16 + (lane & 15), a_col = (lane >> 4) << 3;
  const int b_n = (lane & 7) + ((lane >> 4) << 3), b_k = ((lane >> 3) & 1) << 3;
  const int tr_k = (lane & 7) + (((lane >> 3) & 1) << 3), tr_n = (lane >> 4) << 3;
  const unsigned kaddr = smem_u32(smem + L.k), vaddr = smem_u32(smem + L.v);
  const int c_a = j * bk + rg * 16 + gq;      // kv positions of this thread

  auto issue = [&](int t) {
    if (t < n) {
      unsigned char* st = smem + L.ring + (t % DKV_STAGES) * L.stage;
      const size_t qoff = ((size_t)b * n_q + (size_t)list[t] * bq) * d;
      load_rows(st, q + qoff, bq, d);
      load_rows(st + bq * rs, dO + qoff, bq, d);
      const float* lsrc = lse + (size_t)b * n_q + (size_t)list[t] * bq;
      const float* dsrc = dd + (size_t)b * n_q + (size_t)list[t] * bq;
      for (int e = tid; e < bq / 4; e += TC_THREADS) {
        cp_async16(st + L.lse + e * 16, lsrc + 4 * e);
        cp_async16(st + L.lse + bq * 4 + e * 16, dsrc + 4 * e);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < DKV_STAGES - 1; ++t) issue(t);
  for (int t = 0; t < n; ++t) {
    issue(t + DKV_STAGES - 1);
    cp_async_wait<DKV_STAGES - 1>();
    __syncthreads();                  // pair t (and K_j, V_j) landed
    unsigned char* st = smem + L.ring + (t % DKV_STAGES) * L.stage;
    const unsigned qaddr = smem_u32(st), oaddr = qaddr + bq * rs;
    const float* lse_s = reinterpret_cast<const float*>(st + L.lse);
    const float* dd_s = lse_s + bq;
    const int row0 = list[t] * bq;
    if (rows_ok) {
      for (int qc = half; qc < nqc; qc += 2) {
        // ---- S^T = K Q^T and dP^T = V dO^T: 16 kv rows x 16 queries ----
        float s[2][4], dp[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[h][e] = dp[h][e] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < DMAX / 16; ++ks) {
          if (ks >= nks) continue;
          const unsigned aoff = a_row * rs + (ks * 16 + a_col) * 2;
          const unsigned boff = (qc * 16 + b_n) * rs + (ks * 16 + b_k) * 2;
          uint32_t ka[4], va[4], b0, b1, b2, b3;
          ldsm_x4(kaddr + aoff, ka[0], ka[1], ka[2], ka[3]);
          ldsm_x4(qaddr + boff, b0, b1, b2, b3);
          mma_bf16(s[0], ka, b0, b1);
          mma_bf16(s[1], ka, b2, b3);
          ldsm_x4(vaddr + aoff, va[0], va[1], va[2], va[3]);
          ldsm_x4(oaddr + boff, b0, b1, b2, b3);
          mma_bf16(dp[0], va, b0, b1);
          mma_bf16(dp[1], va, b2, b3);
        }
        // ---- P^T, dS^T on the fragments (query columns carry lse, dd):
        // already the A operands of P^T dO and dS^T Q ----
        uint32_t pa[4][TERMS], sa[4][TERMS];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = qc * 16 + h * 8 + 2 * tq;   // query in the block
          const float2 l2 = *reinterpret_cast<const float2*>(lse_s + r);
          const float2 d2 = *reinterpret_cast<const float2*>(dd_s + r);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            prob_ds(s[h][e], dp[h][e], (e & 1) ? l2.y : l2.x,
                    (e & 1) ? d2.y : d2.x, row0 + r + (e & 1),
                    c_a + ((e >> 1) << 3), causal, prefix_len, sm_scale);
          split_terms(s[h][0], s[h][1], pa[2 * h]);
          split_terms(s[h][2], s[h][3], pa[2 * h + 1]);
          split_terms(dp[h][0], dp[h][1], sa[2 * h]);
          split_terms(dp[h][2], dp[h][3], sa[2 * h + 1]);
        }
        // ---- dV += P^T dO, dK += dS^T Q: each chunk's products in fresh
        // fragments, added in f32; 32 columns at a time ----
#pragma unroll
        for (int dg = 0; dg < DMAX / 32; ++dg) {
          if (dg * 2 >= nks) continue;
          float xv[4][4], xk[4][4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) xv[u][e] = xk[u][e] = 0.0f;
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int dn = dg * 2 + u;
            if (dn >= nks) continue;
            const unsigned toff = (qc * 16 + tr_k) * rs + (dn * 16 + tr_n) * 2;
            uint32_t b0, b1, b2, b3, c0, c1, c2, c3;
            ldsm_x4_t(oaddr + toff, b0, b1, b2, b3);
            ldsm_x4_t(qaddr + toff, c0, c1, c2, c3);
#pragma unroll
            for (int tm = TERMS - 1; tm >= 0; --tm) {   // smallest first
              const uint32_t ap[4] = {pa[0][tm], pa[1][tm], pa[2][tm], pa[3][tm]};
              const uint32_t as[4] = {sa[0][tm], sa[1][tm], sa[2][tm], sa[3][tm]};
              mma_bf16(xv[2 * u], ap, b0, b1);
              mma_bf16(xv[2 * u + 1], ap, b2, b3);
              mma_bf16(xk[2 * u], as, c0, c1);
              mma_bf16(xk[2 * u + 1], as, c2, c3);
            }
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              dv_acc[dg * 4 + u][e] += xv[u][e];
              dk_acc[dg * 4 + u][e] += xk[u][e];
            }
        }
      }
    }
    __syncthreads();                  // stage t % DKV_STAGES may be refilled
  }
  cp_async_wait<0>();
  __syncthreads();                      // the ring is free: hand over

  // ---- the second half's sums go to the first through shared memory, added
  // in a fixed order (no atomics: the same result on every run) ----
  float* hand = reinterpret_cast<float*>(smem + L.ring);
  const int slot_of_lane = rg * 32 + lane;
  if (half == 1 && rows_ok) {
#pragma unroll
    for (int c = 0; c < DMAX / 8; ++c) {
      if (c * 8 >= d) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hand[((c * 4 + e) * 2) * 128 + slot_of_lane] = dk_acc[c][e];
        hand[((c * 4 + e) * 2 + 1) * 128 + slot_of_lane] = dv_acc[c][e];
      }
    }
  }
  __syncthreads();
  if (half == 0 && rows_ok) {
    // a run of one item writes dK, dV; the items of a longer run write f32
    // partials that sla2_bwd_dkv_combine adds in item order
    const int slot = part_base[run] < 0 ? -1 : part_base[run] + item;
    const size_t row = (size_t)(rg * 16 + gq) * d + 2 * tq;
    float* pk = part + (size_t)(slot < 0 ? 0 : slot) * 2 * bk * d + row;
    float* pv = pk + (size_t)bk * d;
    __nv_bfloat16* dka = dk + koff + row;
    __nv_bfloat16* dva = dv + koff + row;
#pragma unroll
    for (int c = 0; c < DMAX / 8; ++c) {
      if (c * 8 >= d) continue;
      float xk[4], xv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        xk[e] = dk_acc[c][e] + hand[((c * 4 + e) * 2) * 128 + slot_of_lane];
        xv[e] = dv_acc[c][e] + hand[((c * 4 + e) * 2 + 1) * 128 + slot_of_lane];
      }
      if (slot < 0) {
        *reinterpret_cast<uint32_t*>(dka + c * 8) = pack_bf16(xk[0], xk[1]);
        *reinterpret_cast<uint32_t*>(dka + 8 * d + c * 8) = pack_bf16(xk[2], xk[3]);
        *reinterpret_cast<uint32_t*>(dva + c * 8) = pack_bf16(xv[0], xv[1]);
        *reinterpret_cast<uint32_t*>(dva + 8 * d + c * 8) = pack_bf16(xv[2], xv[3]);
      } else {
        *reinterpret_cast<float2*>(pk + c * 8) = make_float2(xk[0], xk[1]);
        *reinterpret_cast<float2*>(pk + 8 * d + c * 8) = make_float2(xk[2], xk[3]);
        *reinterpret_cast<float2*>(pv + c * 8) = make_float2(xv[0], xv[1]);
        *reinterpret_cast<float2*>(pv + 8 * d + c * 8) = make_float2(xv[2], xv[3]);
      }
    }
  }
}

// dK, dV of the runs cut into several items: their f32 partials summed in
// item order, one block per (bh, kv block j).
__global__ void __launch_bounds__(256)
sla2_bwd_dkv_combine(const int* __restrict__ off,
                     const int* __restrict__ part_base,
                     const float* __restrict__ part,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int n_kv, int d, int bk) {
  const int j = blockIdx.x, b = blockIdx.y, t_n = n_kv / bk;
  const int base = part_base[(size_t)b * t_n + j];
  if (base < 0) return;                 // written by its only item
  const int len = off[(size_t)b * (t_n + 1) + j + 1] -
                  off[(size_t)b * (t_n + 1) + j];
  const int items = (len + DKV_ITEM - 1) / DKV_ITEM;
  const size_t tile = (size_t)bk * d, koff = ((size_t)b * n_kv + (size_t)j * bk) * d;
  for (int e = 4 * threadIdx.x; e < (int)tile; e += 4 * blockDim.x) {
    float4 sk = make_float4(0.0f, 0.0f, 0.0f, 0.0f), sv = sk;
    for (int it = 0; it < items; ++it) {
      const float* pk = part + (size_t)(base + it) * 2 * tile + e;
      const float4 xk = *reinterpret_cast<const float4*>(pk);
      const float4 xv = *reinterpret_cast<const float4*>(pk + tile);
      sk.x += xk.x; sk.y += xk.y; sk.z += xk.z; sk.w += xk.w;
      sv.x += xv.x; sv.y += xv.y; sv.z += xv.z; sv.w += xv.w;
    }
    *reinterpret_cast<uint2*>(dk + koff + e) =
        make_uint2(pack_bf16(sk.x, sk.y), pack_bf16(sk.z, sk.w));
    *reinterpret_cast<uint2*>(dv + koff + e) =
        make_uint2(pack_bf16(sv.x, sv.y), pack_bf16(sv.z, sv.w));
  }
}

// ===========================================================================
// launch
// ===========================================================================

constexpr size_t DQ_SMEM =
    sizeof(float) * (2 * RT * LD + 2 * BKMAX * LD + RT * LDP + 2 * RT);
constexpr size_t DKV_SMEM =
    sizeof(float) * (2 * BKMAX * LD + 2 * RT * LD + 2 * RT * LDP + 2 * RT);

bool shapes_ok(int n_q, int n_kv, int d, int bq, int bk) {
  const int rows = bq < RT ? bq : RT;
  return d % 16 == 0 && d <= DMAX && bk % 16 == 0 && bk <= BKMAX &&
         bq % 16 == 0 && bq <= 2 * RT && bq % rows == 0 && n_q % bq == 0 &&
         n_kv % bk == 0;
}

struct BwdArgs {
  const void *q, *k, *v, *dO, *lse, *dd;
  int bh, n_q, n_kv, d, bq, bk, k_sel, causal, prefix_len;
  float sm_scale;
  cudaStream_t stream;
};

bool is_main(const BwdArgs& a) {
  return a.d == MAIN_D && a.bq == MAIN_BQ && a.bk == MAIN_BK;
}

int launch_dq(const BwdArgs& a, const void* idx, const void* valid, void* dq,
              bool bf16) {
  const auto* lse = static_cast<const float*>(a.lse);
  const auto* dd = static_cast<const float*>(a.dd);
  const auto* ix = static_cast<const int*>(idx);
  const auto* va = static_cast<const int*>(valid);
  cudaError_t e;
  if (bf16) {
    using B = __nv_bfloat16;
    const int smem = dq_layout(a.d, a.bq, a.bk).total;
    auto kern = is_main(a) ? sla2_bwd_dq_tc<true> : sla2_bwd_dq_tc<false>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(a.n_q / a.bq, a.bh);
    kern<<<grid, a.bq * 2, smem, a.stream>>>(
        static_cast<const B*>(a.q), static_cast<const B*>(a.k),
        static_cast<const B*>(a.v), static_cast<const B*>(a.dO), lse, dd, ix,
        va, static_cast<B*>(dq), a.n_q, a.n_kv, a.d, a.bq, a.bk, a.k_sel,
        a.causal, a.prefix_len, a.sm_scale);
  } else {
    e = cudaFuncSetAttribute(sla2_bwd_dq,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)DQ_SMEM);
    if (e != cudaSuccess) return (int)e;
    const int rows = a.bq < RT ? a.bq : RT;
    const dim3 grid(a.n_q / rows, a.bh);
    sla2_bwd_dq<<<grid, NT, DQ_SMEM, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dO), lse,
        dd, ix, va, static_cast<float*>(dq), a.n_q, a.n_kv, a.d, a.bq, a.bk,
        a.k_sel, a.causal, a.prefix_len, a.sm_scale);
  }
  return (int)cudaGetLastError();
}

int launch_dkv(const BwdArgs& a, const void* is_, const void* vs,
               const void* off, const void* plan, const void* part_base,
               void* part, int n_items, void* dk, void* dv, bool bf16) {
  const auto* lse = static_cast<const float*>(a.lse);
  const auto* dd = static_cast<const float*>(a.dd);
  const auto* ii = static_cast<const int*>(is_);
  const auto* vv = static_cast<const int*>(vs);
  const auto* of = static_cast<const int*>(off);
  const dim3 grid(a.n_kv / a.bk, a.bh);
  cudaError_t e;
  if (bf16) {
    using B = __nv_bfloat16;
    const auto* pb = static_cast<const int*>(part_base);
    const int smem = dkv_layout(a.d, a.bq, a.bk).total;
    auto kern = is_main(a) ? sla2_bwd_dkv_tc<true> : sla2_bwd_dkv_tc<false>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<n_items, TC_THREADS, smem, a.stream>>>(
        static_cast<const B*>(a.q), static_cast<const B*>(a.k),
        static_cast<const B*>(a.v), static_cast<const B*>(a.dO), lse, dd, ii,
        vv, of, static_cast<const int*>(plan), pb, static_cast<float*>(part),
        static_cast<B*>(dk), static_cast<B*>(dv), a.n_q, a.n_kv, a.d, a.bq,
        a.bk, a.k_sel, a.causal, a.prefix_len, a.sm_scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    sla2_bwd_dkv_combine<<<grid, 256, 0, a.stream>>>(
        of, pb, static_cast<const float*>(part), static_cast<B*>(dk),
        static_cast<B*>(dv), a.n_kv, a.d, a.bk);
  } else {
    e = cudaFuncSetAttribute(sla2_bwd_dkv,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)DKV_SMEM);
    if (e != cudaSuccess) return (int)e;
    sla2_bwd_dkv<<<grid, NT, DKV_SMEM, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dO), lse,
        dd, ii, vv, of, static_cast<float*>(dk), static_cast<float*>(dv),
        a.n_q, a.n_kv, a.d, a.bq, a.bk, a.k_sel, a.causal, a.prefix_len,
        a.sm_scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C entries, bound with ctypes.  Each returns cudaGetLastError() after its
// launch (0 on success); the caller raises on anything else.  bf16 operands
// run the tensor-core kernels, f32 operands the CUDA-core kernels.
extern "C" int sla2_sparse_bwd_dq(
    const void* q, const void* k, const void* v, const void* dO,
    const void* lse, const void* dd, const void* idx, const void* valid,
    void* dq, int bh, int n_q, int n_kv, int d, int bq, int bk, int k_sel,
    int causal, int prefix_len, int is_bf16, float sm_scale, void* stream) {
  if (!shapes_ok(n_q, n_kv, d, bq, bk)) return (int)cudaErrorInvalidValue;
  const BwdArgs a{q,  k,  v,  dO,    lse,    dd,         bh,
                  n_q, n_kv, d, bq, bk, k_sel, causal, prefix_len,
                  sm_scale, static_cast<cudaStream_t>(stream)};
  return launch_dq(a, idx, valid, dq, is_bf16 != 0);
}

// bf16 operands also take the work-item plan of sla2_bwd_dkv_tc: plan
// (n_items x 2 ints: run bh * T_n + j, item; run -1 past the last item),
// part_base (BH x T_n ints: the first partial slot of a run cut into several
// items, -1 for a run of one item) and part (the f32 partials, 2 x bk x d
// floats a slot); f32 operands ignore them.
extern "C" int sla2_sparse_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dO,
    const void* lse, const void* dd, const void* is_, const void* vs,
    const void* off, const void* plan, const void* part_base, void* part,
    void* dk, void* dv, int bh, int n_q, int n_kv, int d, int bq, int bk,
    int k_sel, int causal, int prefix_len, int is_bf16, int n_items,
    float sm_scale, void* stream) {
  if (!shapes_ok(n_q, n_kv, d, bq, bk) ||
      (is_bf16 && (plan == nullptr || part_base == nullptr || n_items < 1)))
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{q,  k,  v,  dO,    lse,    dd,         bh,
                  n_q, n_kv, d, bq, bk, k_sel, causal, prefix_len,
                  sm_scale, static_cast<cudaStream_t>(stream)};
  return launch_dkv(a, is_, vs, off, plan, part_base, part, n_items, dk, dv,
                    is_bf16 != 0);
}

// Dynamic shared memory per block of the tensor-core kernels at these shapes.
extern "C" int sla2_bwd_dq_smem(int d, int bq, int bk) {
  return dq_layout(d, bq, bk).total;
}
extern "C" int sla2_bwd_dkv_smem(int d, int bq, int bk) {
  return dkv_layout(d, bq, bk).total;
}
