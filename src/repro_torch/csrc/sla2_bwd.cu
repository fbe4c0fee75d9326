// Backward of the SLA2 sparse branch (paper Algorithm 3), hand-written for
// Hopper (sm_90a): two kernels, dQ and dK/dV.
//
// Replaces: repro/kernels/sla2_bwd.py::_dq_kernel and ::_dkv_kernel (the
// Pallas TPU kernels behind sparse_flash_bwd).  Both compute what the Pallas
// kernels compute, in f32 from the upcast tiles, always in full precision
// (the QAT backward, even after an int8 forward):
//   s   = q k^T * sm_scale, sm_scale = 1/sqrt(d); NEG_INF = -1e30 where the
//         causal mask hides (rows >= cols, OR cols < prefix_len);
//   p   = exp(s - lse_safe), lse_safe = lse > NEG_INF/2 ? lse : 0, and 0
//         where s or lse is masked;
//   dp  = dO v^T;  ds = p (dp - dd) sm_scale, dd = rowsum(dO . O) (f32,
//         computed by the wrapper).
//
// sla2_bwd_dq: one block per (bh, 64 query rows).  An ascending loop over
//   the row's K_sel routed kv blocks takes the place of the TPU's sequential
//   grid axis; invalid entries are skipped.  dQ += ds k accumulates in f32
//   registers and is written once, in q's dtype.
// sla2_bwd_dkv: one block per (bh, kv block j).  This is the Hopper form of
//   the TPU's monotone revisit schedule: the wrapper sorts the (i, jj) -> j
//   pairs stably by j (sort_pairs, as the reference does outside its kernel)
//   and gives each j the offsets of its run.  The block walks its run in
//   ascending order (ascending i), skips invalid pairs, and accumulates
//   dV += p^T dO and dK += ds^T q in f32 registers.  No atomics: every
//   output tile has one writer, so results do not change from run to run.
//   A block whose run holds no valid pair writes zeros (the reference's
//   visited-gate).
//
// Bounds at the main shape (wan-dit-1.3b training at 32k latents: BH = 12,
// N = 32768, d = 128, bq = 128, bk = 64, K_sel = 26, 79,872 routed pairs):
//   dQ    3 products x 2*128*64*128 x 79,872 = 502.5 GFLOP (+654 M exp);
//         bytes q, k, v, dO, dQ 5 x 100.7 MB + lse, dd: 0.51 GB, 0.15 ms.
//         0.508 ms on the bf16 tensor-core peak (989 TFLOP/s), 7.50 ms on
//         the f32 CUDA-core peak (67 TFLOP/s).
//   dK/dV 4 products: 670.0 GFLOP (+654 M exp); 0.61 GB, 0.18 ms.
//         0.677 ms (bf16 tensor cores), 10.0 ms (f32 CUDA cores).
// Both are bound by operations.  P and dS are f32 by the reference's
// semantics, so this first design runs every product as f32 FMA on the
// CUDA cores (its floor is the 67 TFLOP/s column).  Each block is a 16 x 16
// thread grid with 4 x 4 (S, dP) and 4 x 8 (dQ, dK, dV) register tiles; the
// tiles live in shared memory as f32 with an odd row stride (129, 65), so
// that both row walks and column walks are free of bank conflicts.  No
// tensor cores, no TMA, no pipelining: later work.
// No --use_fast_math: it would change expf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;                 // threads: a 16 x 16 grid
constexpr int RT = 64;                  // query rows per chunk
constexpr int BKMAX = 64;               // largest block_k
constexpr int DMAX = 128;               // largest head dim
constexpr int LD = DMAX + 1;            // row stride of (rows, d) tiles
constexpr int LDP = BKMAX + 1;          // row stride of (rows, bk) tiles
constexpr float NEG_INF = -1e30f;
constexpr float HALF_NEG = -5e29f;      // NEG_INF * 0.5

__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st1(float* p, float x) { *p = x; }
__device__ __forceinline__ void st1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// A (rows, d) tile, row-major with stride d in global memory, into shared
// memory as f32 with stride LD.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int rows,
                                          int d) {
  for (int e = threadIdx.x; e < rows * d; e += NT) {
    const int r = e / d, c = e - r * d;
    dst[r * LD + c] = ld1(src + e);
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

template <typename T>
__global__ void __launch_bounds__(NT, 1)
sla2_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dO,
            const float* __restrict__ lse, const float* __restrict__ dd,
            const int* __restrict__ idx, const int* __restrict__ valid,
            T* __restrict__ dq, int n_q, int n_kv, int d, int bq, int bk,
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
      if (col < d) st1(dq + qoff + (size_t)r * d + col, acc[a][e]);
    }
  }
}

// ===========================================================================
// dK / dV: one block per (bh, kv block j), along its run of sorted pairs
// ===========================================================================

template <typename T>
__global__ void __launch_bounds__(NT, 1)
sla2_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dO,
             const float* __restrict__ lse, const float* __restrict__ dd,
             const int* __restrict__ is_, const int* __restrict__ vs,
             const int* __restrict__ off, T* __restrict__ dk,
             T* __restrict__ dv, int n_q, int n_kv, int d, int bq, int bk,
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
        st1(dk + koff + (size_t)c * d + col, dk_acc[a][e]);
        st1(dv + koff + (size_t)c * d + col, dv_acc[a][e]);
      }
    }
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

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dO,
              const void* lse, const void* dd, const void* idx,
              const void* valid, void* dq, int bh, int n_q, int n_kv, int d,
              int bq, int bk, int k_sel, int causal, int prefix_len,
              float sm_scale, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      sla2_bwd_dq<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)DQ_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int rows = bq < RT ? bq : RT;
  const dim3 grid(n_q / rows, bh);
  sla2_bwd_dq<T><<<grid, NT, DQ_SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dO),
      static_cast<const float*>(lse), static_cast<const float*>(dd),
      static_cast<const int*>(idx), static_cast<const int*>(valid),
      static_cast<T*>(dq), n_q, n_kv, d, bq, bk, k_sel, causal, prefix_len,
      sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dO,
               const void* lse, const void* dd, const void* is_,
               const void* vs, const void* off, void* dk, void* dv, int bh,
               int n_q, int n_kv, int d, int bq, int bk, int k_sel,
               int causal, int prefix_len, float sm_scale,
               cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      sla2_bwd_dkv<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)DKV_SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(n_kv / bk, bh);
  sla2_bwd_dkv<T><<<grid, NT, DKV_SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dO),
      static_cast<const float*>(lse), static_cast<const float*>(dd),
      static_cast<const int*>(is_), static_cast<const int*>(vs),
      static_cast<const int*>(off), static_cast<T*>(dk), static_cast<T*>(dv),
      n_q, n_kv, d, bq, bk, k_sel, causal, prefix_len, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// C entries, bound with ctypes.  Each returns cudaGetLastError() after its
// launch (0 on success); the caller raises on anything else.
extern "C" int sla2_sparse_bwd_dq(
    const void* q, const void* k, const void* v, const void* dO,
    const void* lse, const void* dd, const void* idx, const void* valid,
    void* dq, int bh, int n_q, int n_kv, int d, int bq, int bk, int k_sel,
    int causal, int prefix_len, int is_bf16, float sm_scale, void* stream) {
  if (!shapes_ok(n_q, n_kv, d, bq, bk)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? launch_dq<__nv_bfloat16>(q, k, v, dO, lse, dd, idx, valid, dq,
                                        bh, n_q, n_kv, d, bq, bk, k_sel,
                                        causal, prefix_len, sm_scale, s)
             : launch_dq<float>(q, k, v, dO, lse, dd, idx, valid, dq, bh, n_q,
                                n_kv, d, bq, bk, k_sel, causal, prefix_len,
                                sm_scale, s);
}

extern "C" int sla2_sparse_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dO,
    const void* lse, const void* dd, const void* is_, const void* vs,
    const void* off, void* dk, void* dv, int bh, int n_q, int n_kv, int d,
    int bq, int bk, int k_sel, int causal, int prefix_len, int is_bf16,
    float sm_scale, void* stream) {
  if (!shapes_ok(n_q, n_kv, d, bq, bk)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? launch_dkv<__nv_bfloat16>(q, k, v, dO, lse, dd, is_, vs, off,
                                         dk, dv, bh, n_q, n_kv, d, bq, bk,
                                         k_sel, causal, prefix_len, sm_scale,
                                         s)
             : launch_dkv<float>(q, k, v, dO, lse, dd, is_, vs, off, dk, dv,
                                 bh, n_q, n_kv, d, bq, bk, k_sel, causal,
                                 prefix_len, sm_scale, s);
}
