// Block-sparse flash forward of the SLA2 sparse branch (paper Algorithm 2),
// hand-written for Hopper (sm_90a).
//
// Replaces: repro/kernels/sla2_fwd.py::sparse_flash_fwd / _fwd_kernel (the
// Pallas TPU kernel).  It computes what _fwd_kernel computes, in the same
// order: per (bh, query block i) an ascending loop over the K_sel routed
// kv blocks takes the place of the TPU's sequential grid axis; entries
// with valid != 1 are skipped and leave the state untouched.
//   scores   f32 from the upcast tiles, times sm_scale.  int8: per-tile
//            scale s = max(absmax/127, 1e-8), codes clip(rint(x/s), +-127),
//            exact int32 product, (float)acc * (q_s*k_s) * sm_scale.
//            fp8: per-tile e4m3 (RNE) with s = max(absmax/448, 1e-12).
//   masks    NEG_INF = -1e30: causal rows >= cols OR cols < prefix_len;
//            ragged tail cols < kv_len.
//   softmax  the m_safe / corr online update of the Pallas kernel.
//   P.V      int8: P at the fixed scale 1/127 (rint(p*127), p <= 1), V per
//            tile, exact int32 product times ((1/127) * v_s).  fp8: P and V
//            per tile.  acc = acc*corr + o_tmp.
//   finalise o = acc / max(l, 1e-20); lse = m + log(l_safe) or NEG_INF.
// Products and sums that the reference rounds separately are written with
// __fmul_rn / __fadd_rn so that nvcc does not contract them into FMAs.  A
// row's P sum is taken as (s0 + s1) + (s2 + s3), s_t the sequential sum of
// the keys 8n + 2t + e (n ascending, then e), which is the order of the
// tensor-core path below; the plain version repeats it.
//
// Bound at the main shape (wan-dit-1.3b at 32k latents: BH = 12 per request,
// N = 32768, d = 128, bq = 128, bk = 64, K_sel = 26, int8, bidirectional):
//   operations  2 products * 2*128*64*128 * 26 * 256 * 12 = 335 G int8 ops
//               per request and layer: 0.17 ms at 1,979 TOPS (dense int8).
//   bytes       q, k, v and o at 4 * 100.7 MB: 0.12 ms at 3.35 TB/s.
//   gathered    a routed design reads a K and a V code tile per valid pair:
//               16 KiB x ~79.9 k pairs = 1.31 GB, 0.39 ms at 3.35 TB/s,
//               plus the pre-pass (0.30 GB, 0.09 ms), unless the 50 MB L2
//               catches the repeats (a head's codes are 8 MiB).
//   exp         128*64 * 26 * 256 * 12 = 654 M expf per request and layer,
//               on the SFU (16/clk/SM): about 0.18 ms more, not overlapped.
//
// int8 design (the DiT's path), two kernels:
//   - sla2_fwd_quant_kv, the pre-pass: one block per (bh, kv block) and
//     tensor quantises the K or V tile once per call and writes the codes where
//     the main kernel's tensor-core operands read them: K row-major, V as
//     V^T rows with the keys of each 32 permuted (vperm) so that the S
//     accumulator fragment becomes the P operand without shuffles; plus
//     one f32 scale per tile and tensor.  Each kv tile is routed by ~13
//     query blocks; quantising it in each of them would cost two
//     block-wide absmax reductions and the code writes per routed pair,
//     for the same bits.
//   - sla2_fwd_int8_mma: one block of 8 warps per (query block i, bh),
//     the query block on x so that the blocks in flight share one head's
//     code tiles in L2.  Each warp owns 16 query rows, keeps its Q
//     fragments and its output accumulator in registers; S = Q K^T and
//     O += P V run on mma.sync m16n8k32 (s8 x s8 -> s32, exact).  The
//     row's valid routed entries are compacted first (a warp ballot, with
//     their tile scales); the code tiles (8 KiB K + 8 KiB V^T at the main
//     shape) flow through a STAGES-deep ring of 16-byte cp.async copies
//     into rows padded by 16 bytes (conflict-free fragment reads), tiles
//     t+1 .. t+STAGES-1 in flight while t computes, one barrier per tile.
//     The main tiling (MAIN_D, MAIN_BQ, MAIN_BK) is compiled with its
//     sizes fixed and __launch_bounds__ for MIN_BLOCKS blocks per SM
//     (79,952 bytes of shared memory a block); other shapes take the same
//     code with run-time sizes.  With the loads and reductions off the loop,
//     the mma.sync issue and the expf of the online softmax bound it;
//     wgmma (m64nNk32 s8) is the next step.
// The arithmetic did not change with the pre-pass: on the card the kernel
// equals its plain version bit for bit at the main shape (chip_smoke.py).
// The f32 and fp8 paths (not on the main path) run a one-thread-per-row
// kernel on CUDA cores with the same arithmetic.
// No --use_fast_math: it would change expf and the divisions.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int BKMAX = 64;               // largest block_k
constexpr int DMAX = 128;               // largest head dim
constexpr int BQMAX = 128;              // largest block_q
constexpr float NEG_INF = -1e30f;
constexpr float HALF_NEG = -5e29f;      // NEG_INF * 0.5

enum { Q_NONE = 0, Q_INT8 = 1, Q_FP8 = 2 };

__host__ __device__ inline size_t a16(size_t x) { return (x + 15) & ~size_t(15); }

__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void st1(float* p, float x) { *p = x; }
__device__ __forceinline__ void st1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float amax4(float a, float4 x) {
  return fmaxf(a, fmaxf(fmaxf(fabsf(x.x), fabsf(x.y)),
                        fmaxf(fabsf(x.z), fabsf(x.w))));
}

// Max over the block (NWARP warps); every thread must call it.
template <int NWARP>
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

template <int QM>
__device__ __forceinline__ float tile_scale(float amax) {
  if (QM == Q_INT8) return fmaxf(amax / 127.0f, 1e-8f);
  if (QM == Q_FP8) return fmaxf(amax / 448.0f, 1e-12f);
  return 1.0f;
}

__device__ __forceinline__ int int8_code(float x, float s) {
  return (int)fminf(fmaxf(rintf(x / s), -127.0f), 127.0f);
}

__device__ __forceinline__ float fp8_code(float x, float s) {
  return float(__nv_fp8_e4m3(x / s));   // round to nearest even, saturating
}

template <int QM>
__device__ __forceinline__ float float_code(float x, float s) {
  return QM == Q_FP8 ? fp8_code(x, s) : x;
}

__device__ __forceinline__ int pack4(int a, int b, int c, int d) {
  return (a & 0xff) | ((b & 0xff) << 8) | ((c & 0xff) << 16) | (d << 24);
}

__device__ __forceinline__ int pack2(int a, int b) {
  return (a & 0xff) | ((b & 0xff) << 8);
}

// Masked score of key column `col` for query row `row`.
__device__ __forceinline__ float mask(float s, int row, int col, int causal,
                                      int prefix_len, int kv_len) {
  if (causal && !(row >= col || col < prefix_len)) s = NEG_INF;
  if (kv_len && col >= kv_len) s = NEG_INF;
  return s;
}

// Online-softmax state update of one row from this tile's row max and
// P sum (both already combined over the row's threads).
__device__ __forceinline__ float online_update(float& m_i, float& l_i,
                                               float m_new, float psum,
                                               float m_safe) {
  const float corr = expf((m_i > HALF_NEG ? m_i : m_safe) - m_safe);
  l_i = __fadd_rn(__fmul_rn(l_i, corr), psum);
  m_i = m_new;
  return corr;
}

// ===========================================================================
// int8: a pre-pass quantises every K and V tile once; the main kernel
// streams the routed code tiles through a cp.async ring onto the tensor
// cores (mma.sync m16n8k32 s8), 8 warps, 16 query rows per warp
// ===========================================================================

constexpr int MMA_NT = 256;
constexpr int MMA_NWARP = MMA_NT / 32;
constexpr int STAGES = 3;               // code tiles in the ring
constexpr int LIST = 256;               // routed entries compacted at once
constexpr int MIN_BLOCKS = 2;           // blocks per SM of the main tiling
constexpr unsigned FULL = 0xffffffffu;
// The DiT's tiling (wan-dit-1.3b: d 128, bq 128, bk 64), also built with
// the sizes fixed at compile time; other shapes take the same code with
// the sizes as arguments.
constexpr int MAIN_D = 128, MAIN_BQ = 128, MAIN_BK = 64;

// Keys of a V^T code row: block_k rounded up to the 32 keys of a P.V
// k-step (the padding keys hold code 0).
__host__ __device__ inline int vt_keys(int bk) { return (bk + 31) / 32 * 32; }

// Position of key k (0 <= k < 32 within its 32-key chunk) in the permuted
// V^T row: the S accumulator holds keys 8n + 2t + e of a row in thread t
// (tile n, element e), and the P operand wants k-index 4t + j in thread t,
// so key 8n + 2t + e sits at 16*(n/2) + 4t + 2*(n%2) + e.
__device__ __forceinline__ int vperm(int k) {
  const int n = k >> 3, r = k & 7;
  return 16 * (n >> 1) + 4 * (r >> 1) + 2 * (n & 1) + (r & 1);
}

// The pre-pass: one block per (kv block j, bh, tensor), blockIdx.z 0 for K
// and 1 for V.  K's codes row-major [bk][d], as Q K^T's B operand reads
// them; V's codes as V^T rows [d][vt_keys(bk)], keys permuted per 32 by
// vperm, as P.V's B operand reads them; the scale s = max(absmax / 127,
// 1e-8) of the whole tile, padding keys included (the Pallas kernel
// quantises the whole tile).
template <typename T>
__global__ void __launch_bounds__(MMA_NT)
sla2_fwd_quant_kv(const T* __restrict__ k, const T* __restrict__ v,
                  int8_t* __restrict__ kc, int8_t* __restrict__ vc,
                  float* __restrict__ ks, float* __restrict__ vs, int n_kv,
                  int d, int bk) {
  // V^T codes; rows of vt_keys(bk) + 4 bytes (17 words at bk 64), so that
  // the lanes of a warp, on consecutive columns, write distinct banks
  __shared__ __align__(16) int8_t vts[DMAX * (BKMAX + 4)];
  __shared__ float red[MMA_NWARP];
  const int tid = threadIdx.x;
  const bool is_v = blockIdx.z == 1;
  const int bkp = vt_keys(bk), vrow = bkp + 4;
  const size_t tile = (size_t)blockIdx.y * (n_kv / bk) + blockIdx.x;
  const T* src = (is_v ? v : k) + tile * bk * d;
  const int n4 = bk * d / 4;
  constexpr int REG = BKMAX * DMAX / 4 / MMA_NT;
  float4 x[REG];
  float amax = 0.0f;
#pragma unroll
  for (int r = 0; r < REG; ++r) {
    const int ch = tid + r * MMA_NT;
    if (ch >= n4) continue;
    if (is_v) {                                    // keys k4..k4+3 of column c
      const int c = ch % d, k4 = (ch / d) * 4;
      x[r] = make_float4(ld1(src + (k4 + 0) * d + c), ld1(src + (k4 + 1) * d + c),
                         ld1(src + (k4 + 2) * d + c), ld1(src + (k4 + 3) * d + c));
    } else {
      x[r] = ld4(src + 4 * ch);
    }
    amax = amax4(amax, x[r]);
  }
  if (is_v && bkp != bk)                           // padding keys: code 0
    for (int e = tid; e < d * vrow / 4; e += MMA_NT)
      reinterpret_cast<int*>(vts)[e] = 0;
  const float s = tile_scale<Q_INT8>(block_max<MMA_NWARP>(amax, red));

  if (!is_v) {
    int8_t* kct = kc + tile * bk * d;
#pragma unroll
    for (int r = 0; r < REG; ++r) {
      const int ch = tid + r * MMA_NT;
      if (ch < n4)
        *reinterpret_cast<int*>(kct + 4 * ch) = pack4(
            int8_code(x[r].x, s), int8_code(x[r].y, s), int8_code(x[r].z, s),
            int8_code(x[r].w, s));
    }
    if (tid == 0) ks[tile] = s;
    return;
  }
#pragma unroll
  for (int r = 0; r < REG; ++r) {
    const int ch = tid + r * MMA_NT;
    if (ch >= n4) continue;
    const int c = ch % d, k4 = (ch / d) * 4;
    int8_t* row = vts + c * vrow + (k4 & ~31);
    // keys k4, k4+1 and k4+2, k4+3 are two adjacent pairs after vperm
    *reinterpret_cast<int16_t*>(row + vperm(k4 & 31)) =
        (int16_t)pack2(int8_code(x[r].x, s), int8_code(x[r].y, s));
    *reinterpret_cast<int16_t*>(row + vperm((k4 + 2) & 31)) =
        (int16_t)pack2(int8_code(x[r].z, s), int8_code(x[r].w, s));
  }
  __syncthreads();
  int8_t* vct = vc + tile * d * bkp;
  const int wpr = bkp / 4;                         // words of a V^T row
  for (int e = tid; e < d * wpr; e += MMA_NT) {
    const int r = e / wpr, w = e - r * wpr;
    *reinterpret_cast<int*>(vct + r * bkp + 4 * w) =
        *reinterpret_cast<const int*>(vts + r * vrow + 4 * w);
  }
  if (tid == 0) vs[tile] = s;
}

struct MmaLayout {
  int q, ring, stage, vt, list, ks, vs, count, red, total;   // bytes
  int qs, kst, vst;                     // row strides in bytes
};

__host__ __device__ inline MmaLayout mma_layout(int bq, int bk, int d) {
  MmaLayout L;
  L.qs = d + 16;                        // 16-byte rows, conflict-free
  L.kst = d + 16;
  L.vst = vt_keys(bk) + 16;             // V^T rows, keys permuted per 32
  int off = 0;
  L.q = off;     off += (int)a16((size_t)bq * L.qs);
  L.ring = off;                         // a stage: K codes, then V^T codes
  L.vt = (int)a16((size_t)bk * L.kst);
  L.stage = L.vt + (int)a16((size_t)d * L.vst);
  off += STAGES * L.stage;
  L.list = off;  off += LIST * 4;       // routed kv blocks, compacted
  L.ks = off;    off += LIST * 4;       // their K and V tile scales
  L.vs = off;    off += LIST * 4;
  L.count = off; off += 16;
  L.red = off;   off += 64;
  L.total = off;
  return L;
}

// The n entries vals[e] with flags[e] == 1, in ascending e, into list, and
// their tiles' scales ks[vals[e]], vs[vals[e]] into lks, lvs; returns their
// count.  Warp 0 compacts with a ballot; every thread calls.
__device__ int compact(const int* vals, const int* flags, int n,
                       const float* ks, const float* vs, int* list,
                       float* lks, float* lvs, int* count) {
  __syncthreads();                      // the last list is no longer read
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int c = 0;
    for (int base = 0; base < n; base += 32) {
      const int e = base + lane;
      const bool ok = e < n && flags[e] == 1;
      const unsigned m = __ballot_sync(FULL, ok);
      if (ok) {
        const int at = c + __popc(m & ((1u << lane) - 1u)), j = vals[e];
        list[at] = j;
        lks[at] = ks[j];
        lvs[at] = vs[j];
      }
      c += __popc(m);
    }
    if (lane == 0) *count = c;
  }
  __syncthreads();
  return *count;
}

template <typename T, bool MAIN>
__global__ void __launch_bounds__(MMA_NT, MAIN ? MIN_BLOCKS : 1)
sla2_fwd_int8_mma(const T* __restrict__ q, const int8_t* __restrict__ kc,
                  const int8_t* __restrict__ vc, const float* __restrict__ ks,
                  const float* __restrict__ vs, const int* __restrict__ idx,
                  const int* __restrict__ valid, T* __restrict__ o,
                  float* __restrict__ lse, int n_q, int n_kv, int d, int bq,
                  int bk, int k_sel, int causal, int prefix_len, int kv_len,
                  float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (MAIN) {
    d = MAIN_D;
    bq = MAIN_BQ;
    bk = MAIN_BK;
  }
  const MmaLayout L = mma_layout(bq, bk, d);
  int8_t* qs8 = reinterpret_cast<int8_t*>(smem + L.q);
  int* list = reinterpret_cast<int*>(smem + L.list);
  float* lks = reinterpret_cast<float*>(smem + L.ks);
  float* lvs = reinterpret_cast<float*>(smem + L.vs);
  float* red = reinterpret_cast<float*>(smem + L.red);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;       // mma group / thread in group
  const int i = blockIdx.x;
  const int b = blockIdx.y;
  const int t_m = n_q / bq, t_n = n_kv / bk, bkp = vt_keys(bk);
  const int n_tiles = bk / 8;                  // S tiles of 8 keys
  const int kd = d / 32;                       // k-steps of Q.K^T
  const int kv_steps = bkp / 32;               // k-steps of P.V
  const bool has_rows = warp < bq / 16;
  const int r0 = warp * 16 + g;                // local rows r0, r0 + 8
  const int row0 = i * bq + r0, row1 = row0 + 8;

  // ---- Q tile: per-tile scale, int8 codes into shared memory ----
  const T* qt = q + ((size_t)b * n_q + (size_t)i * bq) * d;
  constexpr int QREG = BQMAX * DMAX / 4 / MMA_NT;
  float4 xq[QREG];
  float amax = 0.0f;
#pragma unroll
  for (int r = 0; r < QREG; ++r) {
    const int c = tid + r * MMA_NT;
    if (c < bq * d / 4) { xq[r] = ld4(qt + 4 * c); amax = amax4(amax, xq[r]); }
  }
  const float q_scale = tile_scale<Q_INT8>(block_max<MMA_NWARP>(amax, red));
#pragma unroll
  for (int r = 0; r < QREG; ++r) {
    const int c = tid + r * MMA_NT;
    if (c >= bq * d / 4) continue;
    const int e = 4 * c, row = e / d, col = e - row * d;
    *reinterpret_cast<int*>(qs8 + row * L.qs + col) = pack4(
        int8_code(xq[r].x, q_scale), int8_code(xq[r].y, q_scale),
        int8_code(xq[r].z, q_scale), int8_code(xq[r].w, q_scale));
  }
  __syncthreads();
  int qa[DMAX / 32][4];
#pragma unroll
  for (int s = 0; s < DMAX / 32; ++s) {
    if (has_rows && s < kd) {
      qa[s][0] = *reinterpret_cast<const int*>(qs8 + r0 * L.qs + 32 * s + 4 * t4);
      qa[s][1] = *reinterpret_cast<const int*>(qs8 + (r0 + 8) * L.qs + 32 * s + 4 * t4);
      qa[s][2] = *reinterpret_cast<const int*>(qs8 + r0 * L.qs + 32 * s + 16 + 4 * t4);
      qa[s][3] = *reinterpret_cast<const int*>(qs8 + (r0 + 8) * L.qs + 32 * s + 16 + 4 * t4);
    }
  }

  float acc[DMAX / 8][4];
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f;

  // ---- the ring: routed tile t lands in stage t % STAGES ----
  const size_t row_ix = ((size_t)b * t_m + i) * k_sel;
  const int8_t* kbase = kc + (size_t)b * t_n * bk * d;
  const int8_t* vbase = vc + (size_t)b * t_n * d * bkp;
  const int kcpr = d / 16, vcpr = bkp / 16;    // 16-byte pieces of a row
  auto issue = [&](int t, int n) {
    if (t < n) {
      unsigned char* st = smem + L.ring + (t % STAGES) * L.stage;
      const int8_t* kt = kbase + (size_t)list[t] * bk * d;
      const int8_t* vt = vbase + (size_t)list[t] * d * bkp;
      for (int e = tid; e < bk * kcpr; e += MMA_NT) {
        const int r = e / kcpr, c = e - r * kcpr;
        cp_async16(st + r * L.kst + c * 16, kt + r * d + c * 16);
      }
      for (int e = tid; e < d * vcpr; e += MMA_NT) {
        const int r = e / vcpr, c = e - r * vcpr;
        cp_async16(st + L.vt + r * L.vst + c * 16, vt + r * bkp + c * 16);
      }
    }
    cp_async_commit();
  };

  for (int w0 = 0; w0 < k_sel; w0 += LIST) {
    const int n = compact(idx + row_ix + w0, valid + row_ix + w0,
                          min(LIST, k_sel - w0), ks + (size_t)b * t_n,
                          vs + (size_t)b * t_n, list, lks, lvs,
                          reinterpret_cast<int*>(smem + L.count));
#pragma unroll
    for (int t = 0; t < STAGES - 1; ++t) issue(t, n);
    for (int t = 0; t < n; ++t) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();                  // tile t landed; tile t - 1 read
      issue(t + STAGES - 1, n);         // into tile t - 1's stage
      if (!has_rows) continue;
      const int8_t* ks8 = reinterpret_cast<const int8_t*>(
          smem + L.ring + (t % STAGES) * L.stage);
      const int8_t* vs8 = ks8 + L.vt;
      const int j = list[t];
      const float k_scale = lks[t], v_scale = lvs[t];

      // ---- S = Q K^T on the tensor cores, exact int32 ----
      int sc[BKMAX / 8][4];
#pragma unroll
      for (int n8 = 0; n8 < BKMAX / 8; ++n8) {
        sc[n8][0] = sc[n8][1] = sc[n8][2] = sc[n8][3] = 0;
        if (n8 < n_tiles) {
          const int8_t* krow = ks8 + (8 * n8 + g) * L.kst + 4 * t4;
#pragma unroll
          for (int s = 0; s < DMAX / 32; ++s) {
            if (s < kd) {
              mma_s8(sc[n8], qa[s], *reinterpret_cast<const int*>(krow + 32 * s),
                     *reinterpret_cast<const int*>(krow + 32 * s + 16));
            }
          }
        }
      }

      // ---- scores, masks, online softmax (a row lives on 4 threads) ----
      const float qk = __fmul_rn(q_scale, k_scale);
      float p[BKMAX / 8][4];
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int n8 = 0; n8 < BKMAX / 8; ++n8) {
        if (n8 < n_tiles) {
          const int col = j * bk + 8 * n8 + 2 * t4;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float s = __fmul_rn(__fmul_rn((float)sc[n8][e], qk), sm_scale);
            p[n8][e] = mask(s, e < 2 ? row0 : row1, col + (e & 1), causal,
                            prefix_len, kv_len);
          }
          mx0 = fmaxf(mx0, fmaxf(p[n8][0], p[n8][1]));
          mx1 = fmaxf(mx1, fmaxf(p[n8][2], p[n8][3]));
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float ms0 = mn0 > HALF_NEG ? mn0 : 0.0f;
      const float ms1 = mn1 > HALF_NEG ? mn1 : 0.0f;
      float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
      for (int n8 = 0; n8 < BKMAX / 8; ++n8) {
        if (n8 < n_tiles) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float ms = e < 2 ? ms0 : ms1;
            p[n8][e] = p[n8][e] > HALF_NEG ? expf(p[n8][e] - ms) : 0.0f;
          }
          ps0 = __fadd_rn(__fadd_rn(ps0, p[n8][0]), p[n8][1]);
          ps1 = __fadd_rn(__fadd_rn(ps1, p[n8][2]), p[n8][3]);
        }
      }
      ps0 = __fadd_rn(ps0, __shfl_xor_sync(FULL, ps0, 1));
      ps0 = __fadd_rn(ps0, __shfl_xor_sync(FULL, ps0, 2));
      ps1 = __fadd_rn(ps1, __shfl_xor_sync(FULL, ps1, 1));
      ps1 = __fadd_rn(ps1, __shfl_xor_sync(FULL, ps1, 2));
      const float corr0 = online_update(m0, l0, mn0, ps0, ms0);
      const float corr1 = online_update(m1, l1, mn1, ps1, ms1);

      // ---- P codes at the fixed scale 1/127, as the P operand ----
      int pa[BKMAX / 32][4];
#pragma unroll
      for (int s = 0; s < BKMAX / 32; ++s) {
        int c[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int n8 = 4 * s + u;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            c[u][e] = n8 < n_tiles ? (int)rintf(__fmul_rn(p[n8][e], 127.0f)) : 0;
        }
        pa[s][0] = pack4(c[0][0], c[0][1], c[1][0], c[1][1]);
        pa[s][1] = pack4(c[0][2], c[0][3], c[1][2], c[1][3]);
        pa[s][2] = pack4(c[2][0], c[2][1], c[3][0], c[3][1]);
        pa[s][3] = pack4(c[2][2], c[2][3], c[3][2], c[3][3]);
      }

      // ---- O += P V on the tensor cores: exact int32 per tile ----
      const float pvs = __fmul_rn((float)(1.0 / 127.0), v_scale);
#pragma unroll
      for (int n8 = 0; n8 < DMAX / 8; ++n8) {
        if (8 * n8 < d) {
          int oc[4] = {0, 0, 0, 0};
          const int8_t* vrow = vs8 + (8 * n8 + g) * L.vst + 4 * t4;
#pragma unroll
          for (int s = 0; s < BKMAX / 32; ++s) {
            if (s < kv_steps) {
              mma_s8(oc, pa[s], *reinterpret_cast<const int*>(vrow + 32 * s),
                     *reinterpret_cast<const int*>(vrow + 32 * s + 16));
            }
          }
          acc[n8][0] = __fadd_rn(__fmul_rn(acc[n8][0], corr0), __fmul_rn((float)oc[0], pvs));
          acc[n8][1] = __fadd_rn(__fmul_rn(acc[n8][1], corr0), __fmul_rn((float)oc[1], pvs));
          acc[n8][2] = __fadd_rn(__fmul_rn(acc[n8][2], corr1), __fmul_rn((float)oc[2], pvs));
          acc[n8][3] = __fadd_rn(__fmul_rn(acc[n8][3], corr1), __fmul_rn((float)oc[3], pvs));
        }
      }
    }
  }
  cp_async_wait<0>();

  // ---- finalise: o = acc / l_safe, lse ----
  if (!has_rows) return;
  const float ls0 = fmaxf(l0, 1e-20f), ls1 = fmaxf(l1, 1e-20f);
  T* o0 = o + ((size_t)b * n_q + row0) * d;
  T* o1 = o + ((size_t)b * n_q + row1) * d;
#pragma unroll
  for (int n8 = 0; n8 < DMAX / 8; ++n8) {
    if (8 * n8 < d) {
      const int col = 8 * n8 + 2 * t4;
      st1(o0 + col, acc[n8][0] / ls0);
      st1(o0 + col + 1, acc[n8][1] / ls0);
      st1(o1 + col, acc[n8][2] / ls1);
      st1(o1 + col + 1, acc[n8][3] / ls1);
    }
  }
  if (t4 == 0) {
    lse[(size_t)b * n_q + row0] = m0 > HALF_NEG ? m0 + logf(ls0) : NEG_INF;
    lse[(size_t)b * n_q + row1] = m1 > HALF_NEG ? m1 + logf(ls1) : NEG_INF;
  }
}

// ===========================================================================
// f32 ('none') and fp8: CUDA cores, 128 threads, one thread per query row
// ===========================================================================

constexpr int NT = 128;
constexpr int KREG = BKMAX * DMAX / 4 / NT;

struct Layout {
  size_t acc, q, k, v, red, lrow, total;
  int q_stride, v_stride;               // in floats
};

__host__ __device__ inline Layout make_layout(int bq, int bk, int d) {
  Layout L;
  L.q_stride = d + 4;                   // rows 16-byte aligned
  L.v_stride = bk + 4;                  // V^T rows, padded
  size_t off = 0;
  L.acc = off;  off += a16((size_t)bq * (d + 1) * 4);   // acc, Q staging
  L.q = off;    off += a16((size_t)bq * L.q_stride * 4);
  L.k = off;    off += a16((size_t)bk * d * 4);
  L.v = off;    off += a16((size_t)d * L.v_stride * 4);
  L.red = off;  off += 32;
  L.lrow = off; off += a16((size_t)bq * 4);
  L.total = off;
  return L;
}

template <int QM, typename T>
__global__ void __launch_bounds__(NT)
sla2_fwd_float(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ idx,
               const int* __restrict__ valid, T* __restrict__ o,
               float* __restrict__ lse, int n_q, int n_kv, int d, int bq,
               int bk, int k_sel, int causal, int prefix_len, int kv_len,
               float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(bq, bk, d);
  float* acc_s = reinterpret_cast<float*>(smem + L.acc);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* lrow = reinterpret_cast<float*>(smem + L.lrow);
  float* qf = reinterpret_cast<float*>(smem + L.q);
  float* kf = reinterpret_cast<float*>(smem + L.k);
  float* vf = reinterpret_cast<float*>(smem + L.v);   // V^T [d][v_stride]

  const int tid = threadIdx.x;
  const int i = blockIdx.x;
  const int b = blockIdx.y;
  const int t_m = n_q / bq;
  const int acc_stride = d + 1;          // conflict-free per-row access

  // ---- Q tile: stage as f32, per-tile scale, store values/codes once ----
  const T* qt = q + ((size_t)b * n_q + (size_t)i * bq) * d;
  float amax = 0.0f;
  for (int c = tid; c < bq * d / 4; c += NT) {
    const float4 x = ld4(qt + 4 * c);
    reinterpret_cast<float4*>(acc_s)[c] = x;
    amax = amax4(amax, x);
  }
  float q_scale = 1.0f;
  if (QM != Q_NONE) q_scale = tile_scale<QM>(block_max<NT / 32>(amax, red));
  else __syncthreads();
  for (int e = tid; e < bq * d; e += NT) {
    const int r = e / d, c = e - r * d;
    qf[r * L.q_stride + c] = float_code<QM>(acc_s[e], q_scale);
  }
  __syncthreads();
  for (int e = tid; e < bq * acc_stride; e += NT) acc_s[e] = 0.0f;

  float m_i = NEG_INF, l_i = 0.0f;
  const int row = i * bq + tid;
  const int* idx_row = idx + ((size_t)b * t_m + i) * k_sel;
  const int* val_row = valid + ((size_t)b * t_m + i) * k_sel;
  const T* kbase = k + (size_t)b * n_kv * d;
  const T* vbase = v + (size_t)b * n_kv * d;
  const int n4 = bk * d / 4;

  for (int jj = 0; jj < k_sel; ++jj) {
    if (val_row[jj] != 1) continue;      // uniform over the block
    const int j = idx_row[jj];
    __syncthreads();                     // previous tiles no longer read

    // ---- K tile, row-major [bk][d] ----
    const T* kt = kbase + (size_t)j * bk * d;
    float4 xr[KREG];
    amax = 0.0f;
#pragma unroll
    for (int r = 0; r < KREG; ++r) {
      const int c = tid + r * NT;
      if (c < n4) { xr[r] = ld4(kt + 4 * c); amax = amax4(amax, xr[r]); }
    }
    float k_scale = 1.0f;
    if (QM != Q_NONE) k_scale = tile_scale<QM>(block_max<NT / 32>(amax, red));
#pragma unroll
    for (int r = 0; r < KREG; ++r) {
      const int c = tid + r * NT;
      if (c >= n4) continue;
      reinterpret_cast<float4*>(kf)[c] = make_float4(
          float_code<QM>(xr[r].x, k_scale), float_code<QM>(xr[r].y, k_scale),
          float_code<QM>(xr[r].z, k_scale), float_code<QM>(xr[r].w, k_scale));
    }

    // ---- V tile, stored transposed [d][bk]: chunk = 4 keys of one column ----
    const T* vt = vbase + (size_t)j * bk * d;
    amax = 0.0f;
#pragma unroll
    for (int r = 0; r < KREG; ++r) {
      const int ch = tid + r * NT;
      if (ch < n4) {
        const int c = ch % d, k4 = (ch / d) * 4;
        xr[r] = make_float4(ld1(vt + (k4 + 0) * d + c), ld1(vt + (k4 + 1) * d + c),
                            ld1(vt + (k4 + 2) * d + c), ld1(vt + (k4 + 3) * d + c));
        amax = amax4(amax, xr[r]);
      }
    }
    float v_scale = 1.0f;
    if (QM != Q_NONE) v_scale = tile_scale<QM>(block_max<NT / 32>(amax, red));
#pragma unroll
    for (int r = 0; r < KREG; ++r) {
      const int ch = tid + r * NT;
      if (ch >= n4) continue;
      const int c = ch % d, k4 = (ch / d) * 4;
      *reinterpret_cast<float4*>(vf + c * L.v_stride + k4) = make_float4(
          float_code<QM>(xr[r].x, v_scale), float_code<QM>(xr[r].y, v_scale),
          float_code<QM>(xr[r].z, v_scale), float_code<QM>(xr[r].w, v_scale));
    }
    __syncthreads();

    // ---- scores, masks and the online softmax: one thread per row ----
    float s[BKMAX];
    float corr = 1.0f;
    if (tid < bq) {
#pragma unroll
      for (int kk = 0; kk < BKMAX; ++kk) s[kk] = 0.0f;
      const float* qrow = qf + tid * L.q_stride;
      for (int c = 0; c < d; c += 4) {
        const float4 qa = *reinterpret_cast<const float4*>(qrow + c);
#pragma unroll
        for (int kk = 0; kk < BKMAX; ++kk) {
          if (kk < bk) {
            const float4 kb = *reinterpret_cast<const float4*>(kf + kk * d + c);
            s[kk] = fmaf(qa.x, kb.x, s[kk]);
            s[kk] = fmaf(qa.y, kb.y, s[kk]);
            s[kk] = fmaf(qa.z, kb.z, s[kk]);
            s[kk] = fmaf(qa.w, kb.w, s[kk]);
          }
        }
      }
      const float qk = __fmul_rn(q_scale, k_scale);
      float mx = NEG_INF;
#pragma unroll
      for (int kk = 0; kk < BKMAX; ++kk) {
        if (kk < bk) {
          s[kk] = QM == Q_FP8 ? __fmul_rn(__fmul_rn(s[kk], qk), sm_scale)
                              : __fmul_rn(s[kk], sm_scale);
          s[kk] = mask(s[kk], row, j * bk + kk, causal, prefix_len, kv_len);
          mx = fmaxf(mx, s[kk]);
        }
      }
      const float m_new = fmaxf(m_i, mx);
      const float m_safe = m_new > HALF_NEG ? m_new : 0.0f;
      float ps[4] = {0.0f, 0.0f, 0.0f, 0.0f};   // keys 8n + 2t + e -> ps[t]
#pragma unroll
      for (int kk = 0; kk < BKMAX; ++kk) {
        if (kk < bk) {
          s[kk] = s[kk] > HALF_NEG ? expf(s[kk] - m_safe) : 0.0f;
          ps[(kk >> 1) & 3] = __fadd_rn(ps[(kk >> 1) & 3], s[kk]);
        }
      }
      const float psum = __fadd_rn(__fadd_rn(ps[0], ps[1]), __fadd_rn(ps[2], ps[3]));
      corr = online_update(m_i, l_i, m_new, psum, m_safe);
    }

    // ---- P.V ----
    float p_scale = 1.0f;
    if (QM == Q_FP8) {
      float pmax = 0.0f;
      if (tid < bq) {
#pragma unroll
        for (int kk = 0; kk < BKMAX; ++kk)
          if (kk < bk) pmax = fmaxf(pmax, fabsf(s[kk]));
      }
      p_scale = tile_scale<Q_FP8>(block_max<NT / 32>(pmax, red));
    }
    if (tid < bq) {
      float* arow = acc_s + tid * acc_stride;
      if (QM == Q_FP8) {
#pragma unroll
        for (int kk = 0; kk < BKMAX; ++kk)
          if (kk < bk) s[kk] = fp8_code(s[kk], p_scale);
      }
      const float pvs = __fmul_rn(p_scale, v_scale);
      for (int c = 0; c < d; ++c) {
        const float* vrow = vf + c * L.v_stride;
        float acc = 0.0f;
#pragma unroll
        for (int w = 0; w < BKMAX / 4; ++w) {
          if (4 * w < bk) {
            const float4 vv = *reinterpret_cast<const float4*>(vrow + 4 * w);
            acc = fmaf(s[4 * w + 0], vv.x, acc);
            acc = fmaf(s[4 * w + 1], vv.y, acc);
            acc = fmaf(s[4 * w + 2], vv.z, acc);
            acc = fmaf(s[4 * w + 3], vv.w, acc);
          }
        }
        if (QM == Q_FP8) acc = __fmul_rn(acc, pvs);
        arow[c] = __fadd_rn(__fmul_rn(arow[c], corr), acc);
      }
    }
  }

  // ---- finalise: o = acc / l_safe, lse ----
  __syncthreads();
  if (tid < bq) {
    const float l_safe = fmaxf(l_i, 1e-20f);
    lrow[tid] = l_safe;
    lse[(size_t)b * n_q + row] = m_i > HALF_NEG ? m_i + logf(l_safe) : NEG_INF;
  }
  __syncthreads();
  T* ot = o + ((size_t)b * n_q + (size_t)i * bq) * d;
  for (int e = tid; e < bq * d; e += NT) {
    const int r = e / d, c = e - r * d;
    st1(ot + e, acc_s[r * acc_stride + c] / lrow[r]);
  }
}

// ===========================================================================
// launch
// ===========================================================================

struct Args {
  const void *q, *k, *v, *idx, *valid, *kc, *vc, *ks, *vs;
  void *o, *lse;
  int bh, n_q, n_kv, d, bq, bk, k_sel, causal, prefix_len, kv_len;
  float sm_scale;
  cudaStream_t stream;
};

template <typename T>
int run_int8(const Args& a) {
  const bool main = a.d == MAIN_D && a.bq == MAIN_BQ && a.bk == MAIN_BK;
  auto kern = main ? sla2_fwd_int8_mma<T, true> : sla2_fwd_int8_mma<T, false>;
  const int smem = mma_layout(a.bq, a.bk, a.d).total;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.n_q / a.bq, a.bh);
  kern<<<grid, MMA_NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const int8_t*>(a.kc),
      static_cast<const int8_t*>(a.vc), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.idx),
      static_cast<const int*>(a.valid), static_cast<T*>(a.o),
      static_cast<float*>(a.lse), a.n_q, a.n_kv, a.d, a.bq, a.bk, a.k_sel,
      a.causal, a.prefix_len, a.kv_len, a.sm_scale);
  return (int)cudaGetLastError();
}

template <int QM, typename T>
int run_float(const Args& a) {
  const size_t smem = make_layout(a.bq, a.bk, a.d).total;
  auto kern = sla2_fwd_float<QM, T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.n_q / a.bq, a.bh);
  kern<<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const int*>(a.idx),
      static_cast<const int*>(a.valid), static_cast<T*>(a.o),
      static_cast<float*>(a.lse), a.n_q, a.n_kv, a.d, a.bq, a.bk, a.k_sel,
      a.causal, a.prefix_len, a.kv_len, a.sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int quant, const Args& a) {
  switch (quant) {
    case Q_INT8: return run_int8<T>(a);
    case Q_NONE: return run_float<Q_NONE, T>(a);
    case Q_FP8: return run_float<Q_FP8, T>(a);
  }
  return (int)cudaErrorInvalidValue;
}

bool shapes_ok(int n_kv, int d, int bk) {
  return d % 32 == 0 && d <= DMAX && bk % 16 == 0 && bk <= BKMAX &&
         n_kv % bk == 0;
}

}  // namespace

// C entries, bound with ctypes.  Each returns cudaGetLastError() after its
// launch (0 on success); the caller raises on anything else.
//
// The int8 pre-pass: kc (BH x T_n x bk x d int8), vc (BH x T_n x d x
// vt_keys(bk) int8), ks and vs (BH x T_n f32).
extern "C" int sla2_fwd_quantize_kv(const void* k, const void* v, void* kc,
                                    void* vc, void* ks, void* vs, int bh,
                                    int n_kv, int d, int bk, int is_bf16,
                                    void* stream) {
  if (!shapes_ok(n_kv, d, bk)) return (int)cudaErrorInvalidValue;
  const dim3 grid(n_kv / bk, bh, 2);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* c8 = static_cast<int8_t*>(kc);
  auto* v8 = static_cast<int8_t*>(vc);
  auto* kf = static_cast<float*>(ks);
  auto* vf = static_cast<float*>(vs);
  if (is_bf16) {
    using B = __nv_bfloat16;
    sla2_fwd_quant_kv<B><<<grid, MMA_NT, 0, s>>>(
        static_cast<const B*>(k), static_cast<const B*>(v), c8, v8, kf, vf,
        n_kv, d, bk);
  } else {
    sla2_fwd_quant_kv<float><<<grid, MMA_NT, 0, s>>>(
        static_cast<const float*>(k), static_cast<const float*>(v), c8, v8,
        kf, vf, n_kv, d, bk);
  }
  return (int)cudaGetLastError();
}

// The forward.  quant int8 reads the pre-pass's codes and scales (kc, vc,
// ks, vs) for K and V; none and fp8 read k and v (the codes may be null).
extern "C" int sla2_sparse_flash_fwd(
    const void* q, const void* k, const void* v, const void* idx,
    const void* valid, const void* kc, const void* vc, const void* ks,
    const void* vs, void* o, void* lse, int bh, int n_q, int n_kv, int d,
    int bq, int bk, int k_sel, int causal, int prefix_len, int kv_len,
    int quant, int is_bf16, float sm_scale, void* stream) {
  if (!shapes_ok(n_kv, d, bk) || bq % 16 || bq > BQMAX || bq < 16 ||
      n_q % bq ||
      (quant == Q_INT8 && (!kc || !vc || !ks || !vs)))
    return (int)cudaErrorInvalidValue;
  const Args a{q,  k,  v,  idx,   valid,  kc,         vc,     ks,
               vs, o,  lse, bh,   n_q,    n_kv,       d,      bq,
               bk, k_sel, causal, prefix_len, kv_len, sm_scale,
               static_cast<cudaStream_t>(stream)};
  return is_bf16 ? dispatch<__nv_bfloat16>(quant, a) : dispatch<float>(quant, a);
}

// Dynamic shared memory per block of the int8 kernel at these shapes.
extern "C" int sla2_fwd_int8_smem(int d, int bq, int bk) {
  return mma_layout(bq, bk, d).total;
}
