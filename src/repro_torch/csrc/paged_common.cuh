// Helpers shared by the paged-attention sources (sla2_decode_paged.cu,
// paged_prefill.cu): pool element loads, warp and block reductions, the QAT
// tile codes; the PTX of the Hopper paths (cp.async, ldmatrix, mma.sync bf16)
// comes from mma_sm90.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int DMAX = 128;               // largest head dim
constexpr int BKMAX = 64;               // largest block_k (page size)
constexpr int RMAX = 16;                // largest n_rep
constexpr int NT = 256;                 // threads per block (CUDA-core kernels)
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

// Four consecutive elements from p (aligned to 4 elements).
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 ld4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
}
__device__ __forceinline__ float4 ld4(const __nv_fp8_e4m3* p) {
  return make_float4(static_cast<float>(p[0]), static_cast<float>(p[1]),
                     static_cast<float>(p[2]), static_cast<float>(p[3]));
}

// Two consecutive elements from p (aligned to 2 elements).
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 ld2(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2((float)c.x, (float)c.y);
}
__device__ __forceinline__ float2 ld2(const __nv_fp8_e4m3* p) {
  return make_float2(static_cast<float>(p[0]), static_cast<float>(p[1]));
}

// Max over the block of NT threads; every thread must call it.
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

__host__ inline bool shapes_ok(int dh, int bk, int n_rep) {
  return (dh == 64 || dh == 128) && bk % 16 == 0 && bk >= 16 &&
         bk <= BKMAX && n_rep >= 1 && n_rep <= RMAX;
}

}  // namespace
