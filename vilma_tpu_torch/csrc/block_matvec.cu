// Fused low-rank block matvec for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vilma_tpu/ops/pallas/block_matvec.py
// (`_kernel`, reached from bucket_matvec_multi):
//
//     y[b, c] = U_b (s_b * (U_b^T x[b, c])) + d_b * x[b, c]
//
// for B padded [P, R] LD blocks and C <= 3 cohorts sharing the panel.
// x is rounded to U's type before the first contraction and t = s * U^T x
// before the second; products accumulate in f32 (the semantics of
// block_matvec.py:52-61 and blocks.py:480-490).
//
// What bounds it: device-memory bandwidth. U is P*R elements per block
// (1 MB for a 1024 x 512 bf16 block) against 4*(R + P + 2*C*P) bytes of
// everything else, and each element of U feeds 2*C multiply-adds, far
// below the card's ~300 operations per byte.
//
// Design: one CTA (8 warps) per block b. The TPU kernel holds a whole
// block in VMEM and reads U once; a 1 MB tile does not fit Hopper's
// 227 KB of shared memory, so this simple version reads U twice:
//   phase 1: warp w walks rows p = w, w+8, ...; each lane holds a strip
//            of columns and loads 16 bytes of a row at a time (a warp
//            reads 512 contiguous bytes), accumulating t[c][r] for all C
//            cohorts in registers. The 8 warp partials are added into
//            shared memory in fixed warp order, then scaled by s and
//            rounded to U's type.
//   phase 2: the same row walk; each lane multiplies its strip of U by
//            its strip of t (held in registers), a butterfly shuffle sums
//            the row, and lane 0 writes y[c][p] (+ d*x on the last
//            column chunk).
// Every sum runs in a fixed order, so results repeat bit for bit. Reading
// U once (thread-block clusters sharing a block through distributed
// shared memory, or keeping the tile resident) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStrips = 4;  // 16-byte loads per lane per column chunk

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16 bytes of U as floats
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // little-endian: the low half-word is the earlier element
    out[2 * j] = __uint_as_float(w[j] << 16);
    out[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

// round a float to U's type (round to nearest even, as astype does)
template <typename TU>
__device__ __forceinline__ float round_to(float v);

template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename TU, int C>
__global__ void __launch_bounds__(kThreads)
    block_matvec_kernel(const TU* __restrict__ u, const float* __restrict__ s,
                        const float* __restrict__ d,
                        const float* __restrict__ x, float* __restrict__ y,
                        int P, int R) {
  constexpr int VEC = 16 / sizeof(TU);
  constexpr int CHUNK = 32 * VEC * kStrips;  // columns per register chunk
  extern __shared__ float ts[];              // [C][R]

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const TU* ub = u + (size_t)b * P * R;
  const float* xb = x + (size_t)b * C * P;
  const float* sb = s + (size_t)b * R;
  const float* db = d + (size_t)b * P;
  float* yb = y + (size_t)b * C * P;

  // phase 1: t[c][r] = sum_p U[p][r] * round(x[c][p])
  for (int c0 = 0; c0 < R; c0 += CHUNK) {
    float acc[kStrips][VEC][C];
#pragma unroll
    for (int i = 0; i < kStrips; ++i)
#pragma unroll
      for (int v = 0; v < VEC; ++v)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][v][c] = 0.f;

    for (int p = warp; p < P; p += kWarps) {
      float xr[C];
#pragma unroll
      for (int c = 0; c < C; ++c) xr[c] = round_to<TU>(xb[c * P + p]);
      const TU* row = ub + (size_t)p * R;
#pragma unroll
      for (int i = 0; i < kStrips; ++i) {
        const int col = c0 + (i * 32 + lane) * VEC;
        if (col < R) {
          float uv[VEC];
          load16(row + col, uv);
#pragma unroll
          for (int v = 0; v < VEC; ++v)
#pragma unroll
            for (int c = 0; c < C; ++c) acc[i][v][c] += uv[v] * xr[c];
        }
      }
    }
    // warp partials into shared memory, in fixed warp order
    for (int w = 0; w < kWarps; ++w) {
      if (warp == w) {
#pragma unroll
        for (int i = 0; i < kStrips; ++i) {
          const int col = c0 + (i * 32 + lane) * VEC;
          if (col < R) {
#pragma unroll
            for (int v = 0; v < VEC; ++v)
#pragma unroll
              for (int c = 0; c < C; ++c) {
                float* dst = ts + c * R + col + v;
                *dst = (w == 0) ? acc[i][v][c] : *dst + acc[i][v][c];
              }
          }
        }
      }
      __syncthreads();
    }
  }
  for (int j = threadIdx.x; j < C * R; j += kThreads)
    ts[j] = round_to<TU>(ts[j] * sb[j % R]);
  __syncthreads();

  // phase 2: y[c][p] = sum_r U[p][r] * t[c][r] + d[p] * x[c][p]
  for (int c0 = 0; c0 < R; c0 += CHUNK) {
    float tr[kStrips][VEC][C];
#pragma unroll
    for (int i = 0; i < kStrips; ++i) {
      const int col = c0 + (i * 32 + lane) * VEC;
#pragma unroll
      for (int v = 0; v < VEC; ++v)
#pragma unroll
        for (int c = 0; c < C; ++c)
          tr[i][v][c] = (col < R) ? ts[c * R + col + v] : 0.f;
    }
    const bool last = c0 + CHUNK >= R;
    for (int p = warp; p < P; p += kWarps) {
      const TU* row = ub + (size_t)p * R;
      float part[C];
#pragma unroll
      for (int c = 0; c < C; ++c) part[c] = 0.f;
#pragma unroll
      for (int i = 0; i < kStrips; ++i) {
        const int col = c0 + (i * 32 + lane) * VEC;
        if (col < R) {
          float uv[VEC];
          load16(row + col, uv);
#pragma unroll
          for (int v = 0; v < VEC; ++v)
#pragma unroll
            for (int c = 0; c < C; ++c) part[c] += uv[v] * tr[i][v][c];
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) part[c] = warp_sum(part[c]);
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          // the owning warp's lane 0 carries y across column chunks
          float v = (c0 == 0 ? 0.f : yb[c * P + p]) + part[c];
          if (last) v += db[p] * xb[c * P + p];
          yb[c * P + p] = v;
        }
      }
    }
  }
}

template <typename TU, int C>
cudaError_t launch(const void* u, const void* s, const void* d, const void* x,
                   void* y, int B, int P, int R, cudaStream_t stream) {
  const size_t smem = (size_t)C * R * sizeof(float);
  auto kernel = block_matvec_kernel<TU, C>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<B, kThreads, smem, stream>>>(
      static_cast<const TU*>(u), static_cast<const float*>(s),
      static_cast<const float*>(d), static_cast<const float*>(x),
      static_cast<float*>(y), P, R);
  return cudaGetLastError();
}

template <typename TU>
cudaError_t dispatch_c(const void* u, const void* s, const void* d,
                       const void* x, void* y, int B, int P, int R, int C,
                       cudaStream_t stream) {
  switch (C) {
    case 1:
      return launch<TU, 1>(u, s, d, x, y, B, P, R, stream);
    case 2:
      return launch<TU, 2>(u, s, d, x, y, B, P, R, stream);
    case 3:
      return launch<TU, 3>(u, s, d, x, y, B, P, R, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// u [B, P, R] (f32, or bf16 when u_bf16); s [B, R], d [B, P],
// x and y [B, C, P] f32. Returns the launch's cudaError_t.
extern "C" int vilma_block_matvec(const void* u, const void* s, const void* d,
                                  const void* x, void* y, int B, int P, int R,
                                  int C, int u_bf16, void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      u_bf16 ? dispatch_c<__nv_bfloat16>(u, s, d, x, y, B, P, R, C, st)
             : dispatch_c<float>(u, s, d, x, y, B, P, R, C, st);
  return (int)err;
}
