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
// below the card's ~300 operations per byte. So U must cross HBM once.
//
// Cluster route (cluster_matvec_kernel), what the TPU kernel does with
// VMEM: the whole block stays on chip and U is read once. A block does not
// fit one SM's 227 KB, so a thread-block cluster of G CTAs splits it by
// rows (the planner in ops/cuda/block_matvec.py picks the smallest G that
// fits: 8 CTAs of 128 KB for a 1 MB bf16 block, 16 for its 2 MB f32 form).
// As many clusters as the card holds stay resident and walk the blocks
// (cluster i takes blocks i, i + n, ...). Per block, in CTA g (rows
// [g P/G, (g+1) P/G)):
//   0. TMA copies bring the slice into shared memory: bf16 as one tensor
//      copy per 64-column block with the hardware's 128-byte swizzle (so
//      ldmatrix reads 8 rows without bank conflicts) into a ring of
//      column-block slots (12 at the 1 MB block: the next block's first 4
//      column blocks land while this one finishes); f32 one bulk copy per
//      row into a padded pitch, after step 3; x, d and s as three more
//      bulk copies into a double buffer. Each set completes on its own
//      mbarriers.
//   1. The partial t_g[c][r] = sum over the slice's rows of U[p][r] x[c][p]:
//      bf16 on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//      accumulate; the cohorts are the rows of A, x rounded to bf16), warp
//      w on column block w as soon as that block has landed; f32 on the
//      CUDA cores, warp w on rows w, w+8, ... as their chunks land, the 8
//      warp partials added in warp order.
//   2. A cluster barrier; each CTA adds the G partials [C][R] through
//      distributed shared memory in cluster-rank order (so every CTA forms
//      the same t and results repeat bit for bit), scales by s and rounds
//      to U's type. The partials are double-buffered by block, so one
//      cluster barrier per block keeps them alive until all have read them.
//   3. The second contraction from the resident slice (bf16: mma with U's
//      rows as A, warp w on 16-row tiles; f32: warp per row, a butterfly
//      shuffle per row), then y = that + d x in one coalesced pass.
// Why it is not faster: steps 1-3 of a block are serial within an SM, and
// only half of the next block's slice fits beside this one's; 16 CTAs of
// 64 KB (fewer resident clusters, steps 1-3 twice as often) were slower.
//
// Two-read route (block_matvec_kernel), for blocks too large for a
// 16-CTA cluster (chosen by shape alone): one CTA per block reads U twice,
//   phase 1: warp w walks rows p = w, w+8, ...; each lane holds a strip
//            of columns and loads 16 bytes of a row at a time, accumulating
//            t[c][r] for all C cohorts in registers. The 8 warp partials are
//            added into shared memory in fixed warp order, then scaled by s
//            and rounded to U's type.
//   phase 2: the same row walk with t in registers, a butterfly shuffle
//            per row, lane 0 writes y[c][p] (+ d*x on the last chunk).
// Every sum of both routes runs in a fixed order.
#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap (the encoder is found at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStrips = 4;  // two-read route: 16-byte loads per lane per chunk

// cluster route
constexpr int kMaxCluster = 16;     // non-portable above 8 on H100
constexpr int kMaxChunks = 16;      // f32: row chunks (mbarriers) per slice
constexpr int kMaxSlots = 32;       // bf16: column-block slots of the ring
constexpr int kChunkBytes = 16384;  // target bytes of one bulk copy
constexpr int kMaxRank = 2048;      // widest rank the route takes
constexpr int kCols = 512;          // columns of a lane-strip pass

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

// ---------------------------------------------------------------------------
// mbarriers, bulk copies and cluster barriers (PTX)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// this CTA's shared memory, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// cluster route
// ---------------------------------------------------------------------------

// Shared memory of one CTA (byte offsets from a 1024-byte aligned base):
// the mbarriers (one per U chunk or slot, one per x/d/s buffer); U; two
// buffers of x [C][rows16], d [rows16] and s
// [r16]; the partial t [2][C][r16] f32 (two blocks in flight); the rounded
// t [C][r16 + 16 / itemsize] in U's type; y [C][rows16]; and (f32 U) the 8
// warps' phase-1 partials [kWarps][C][min(r16, kCols)]. rows16 and r16 are
// the slice's rows and U's rank rounded up to 16, the tensor-core tile.
//   bf16 U lands by TMA tensor copies, one per column block of 64 (128
//   bytes), into a ring of `slots` slots of rows16 rows of 128 bytes, with
//   the hardware's 128-byte swizzle: the 16-byte units of row r permuted by
//   r % 8, so the 8 rows an ldmatrix reads sit in 8 different bank groups
//   (swz()). With more slots than a block's column blocks, the next
//   block's first column blocks land while this one is worked on.
//   f32 U lands one row per bulk copy at a pitch of r16 * 4 + 16 bytes.
// ops/cuda/block_matvec.py::cluster_smem computes the same total.
struct Layout {
  int rows16, r16, ncb, pitch, tpitch;
  size_t slot, ubytes, ubuf, vbuf, vstride, vd, vs, part, ts, ys, wp, total;
};

__host__ __device__ inline Layout cluster_layout(int P, int R, int C, int G,
                                                 int itemsize, int slots) {
  Layout L;
  L.rows16 = (P / G + 15) / 16 * 16;
  L.r16 = (R + 15) / 16 * 16;
  L.ncb = (R + 63) / 64;
  L.pitch = L.r16 * itemsize + 16;
  L.tpitch = L.r16 + 16 / itemsize;
  L.slot = (size_t)L.rows16 * 128;
  L.ubytes = itemsize == 2 ? slots * L.slot : (size_t)L.rows16 * L.pitch;
  L.ubuf = ((size_t)(kMaxSlots + 2) * 8 + 1023) / 1024 * 1024;
  L.vbuf = L.ubuf + L.ubytes;
  L.vd = 4 * (size_t)C * L.rows16;
  L.vs = L.vd + 4 * (size_t)L.rows16;
  L.vstride = L.vs + 4 * (size_t)L.r16;
  size_t off = L.vbuf + 2 * L.vstride;
  L.part = off;
  off += 2 * 4 * (size_t)C * L.r16;
  L.ts = off;
  off += (size_t)itemsize * C * L.tpitch;
  L.ys = off;
  off += 4 * (size_t)C * L.rows16;
  L.wp = off;
  if (itemsize == 4)
    off += 4 * (size_t)kWarps * C * (L.r16 < kCols ? L.r16 : kCols);
  L.total = off + 1024;  // room to align the base
  return L;
}

// byte offset in a swizzled column-block slot of the 8 bf16 elements
// (r, c..c+7), c < 64
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * 128 + (((c >> 3) ^ (r & 7)) << 4));
}

// box (64 columns from c, rows from r) of the tensor map into dst (1024-
// byte aligned), completing on bar
__device__ __forceinline__ void tile_load(void* dst, const CUtensorMap* map,
                                          int c, int r, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r),
      "r"(smem_addr(bar))
      : "memory");
}

// tensor-core helpers (bf16 U): mma.sync m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__device__ __forceinline__ void store_t(float* p, float v) { *p = v; }

__device__ __forceinline__ void store_t(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Step 1 on the tensor cores (bf16 U): D[c][r] = sum_p X[c][p] U[p][r] as
// m16n8k16 products with the cohorts as the 16 rows of A (x rounded to
// bf16, rows c >= C zero) and U's slice as B (ldmatrix.trans). Warp w owns
// column blocks w, w+8, ... (four pairs of 8-column tiles each), waits for
// a block's copy (sequence q0 + cb of the ring) and walks all rows in
// k-steps of 16; no cross-warp sum.
template <int C>
__device__ __forceinline__ void partial_t_mma(const Layout& L,
                                              const unsigned char* ring,
                                              int slots, int q0,
                                              const float* xs, float* part,
                                              int R, uint64_t* bars) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  for (int cb = warp; cb < L.ncb; cb += kWarps) {
    const int seq = q0 + cb, slot = seq % slots;
    mbar_wait(&bars[slot], (uint32_t)(seq / slots) & 1u);
    const unsigned char* us = ring + slot * L.slot;
    float acc[4][2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][h][e] = 0.f;
    for (int k0 = 0; k0 < L.rows16; k0 += 16) {
      uint32_t a[4] = {0u, 0u, 0u, 0u};
      if (g < C) {
        const float* xr = xs + g * L.rows16 + k0 + 2 * q;
        a[0] = pack_bf16(xr[0], xr[1]);
        a[2] = pack_bf16(xr[8], xr[9]);
      }
      const int r = k0 + (lane & 15);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, us + swz(r, 16 * j + 8 * (lane >> 4)));
        mma_bf16(acc[j][0], a, bfr[0], bfr[1]);
        mma_bf16(acc[j][1], a, bfr[2], bfr[3]);
      }
    }
    // row g of D is cohort g; a lane holds columns 2q, 2q + 1 of a tile
    if (g < C) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = 64 * cb + 16 * j + 8 * h + 2 * q;
          if (n < R)
            *reinterpret_cast<float2*>(part + g * L.r16 + n) =
                make_float2(acc[j][h][0], acc[j][h][1]);
        }
    }
  }
}

// Step 1 on the CUDA cores (f32 U): warp w takes rows w, w+8, ... (waiting
// for each row's chunk the first time), a lane holds a strip of columns
// (16-byte loads); the 8 warp partials are added in warp order.
template <int C>
__device__ __forceinline__ void partial_t_fma(
    const Layout& L, const unsigned char* us, const float* xs, float* part,
    float* wp, int R, int rows, uint64_t* bars, uint32_t parity,
    int chunk_rows, int nchunks) {
  constexpr int VEC = 4;
  constexpr int NSTRIP = kCols / (32 * VEC);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int width = min(L.r16, kCols);
  int landed = 0;
  for (int c0 = 0; c0 < R; c0 += kCols) {
    float acc[NSTRIP][VEC][C];
#pragma unroll
    for (int i = 0; i < NSTRIP; ++i)
#pragma unroll
      for (int v = 0; v < VEC; ++v)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][v][c] = 0.f;
#pragma unroll 2
    for (int r = warp; r < rows; r += kWarps) {
      while (landed * chunk_rows <= r) mbar_wait(&bars[landed++], parity);
      float xr[C];
#pragma unroll
      for (int c = 0; c < C; ++c) xr[c] = xs[c * L.rows16 + r];
      const float* row =
          reinterpret_cast<const float*>(us + (size_t)r * L.pitch);
#pragma unroll
      for (int i = 0; i < NSTRIP; ++i) {
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
#pragma unroll
    for (int i = 0; i < NSTRIP; ++i) {
      const int col = (i * 32 + lane) * VEC;  // within the column pass
      if (c0 + col < R) {
#pragma unroll
        for (int c = 0; c < C; ++c)
          *reinterpret_cast<float4*>(wp + (warp * C + c) * width + col) =
              make_float4(acc[i][0][c], acc[i][1][c], acc[i][2][c],
                          acc[i][3][c]);
      }
    }
    __syncthreads();
    for (int j = tid; j < C * width; j += kThreads) {
      const int c = j / width, col = j - c * width;
      if (c0 + col < R) {
        float v = wp[j];
        for (int w = 1; w < kWarps; ++w) v += wp[w * C * width + j];
        part[c * L.r16 + c0 + col] = v;
      }
    }
    __syncthreads();
  }
}

// Step 3 on the tensor cores: Y[p][c] = sum_r U[p][r] T[r][c] with U's
// rows as A (ldmatrix) and the rounded t as B (cohorts as the 8 columns,
// c >= C zero). Warp w owns the 16-row tiles w, w+8, ...; the four
// k-steps of a column block accumulate in four chains, added at the end.
template <int C>
__device__ __forceinline__ void rows_mma(const Layout& L,
                                         const unsigned char* ring, int slots,
                                         int q0, const __nv_bfloat16* ts,
                                         float* ys, int rows) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  for (int p0 = 16 * warp; p0 < L.rows16; p0 += 16 * kWarps) {
    float acc[4][4] = {};
    const int r = p0 + (lane & 15);
    const __nv_bfloat16* tg = ts + g * L.tpitch + 2 * q;
    int slot = q0 % slots;
    for (int cb = 0; cb < L.ncb; ++cb) {
      const unsigned char* us = ring + slot * L.slot;
      slot = slot + 1 == slots ? 0 : slot + 1;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k0 = 64 * cb + 16 * kk;
        if (k0 < L.r16) {
          uint32_t a[4];
          ldmatrix_x4(a, us + swz(r, 16 * kk + 8 * (lane >> 4)));
          uint32_t b0 = 0u, b1 = 0u;
          if (g < C) {
            b0 = *reinterpret_cast<const uint32_t*>(tg + k0);
            b1 = *reinterpret_cast<const uint32_t*>(tg + k0 + 8);
          }
          mma_bf16(acc[kk], a, b0, b1);
        }
      }
    }
    // a lane holds rows g and g + 8 of the tile, cohorts 2q and 2q + 1
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 2 * q + e, row = p0 + g + 8 * h, i = 2 * h + e;
        if (c < C && row < rows)
          ys[c * L.rows16 + row] =
              (acc[0][i] + acc[1][i]) + (acc[2][i] + acc[3][i]);
      }
  }
}

// Step 3 on the CUDA cores (f32 U): warp w takes rows w, w+8, ...; a lane
// holds a strip of t in registers and a butterfly shuffle sums the row.
template <int C>
__device__ __forceinline__ void rows_fma(const Layout& L,
                                         const unsigned char* us,
                                         const float* ts, float* ys, int R,
                                         int rows) {
  constexpr int VEC = 4;
  constexpr int NSTRIP = kCols / (32 * VEC);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c0 = 0; c0 < R; c0 += kCols) {
    float tr[NSTRIP][VEC][C];
#pragma unroll
    for (int i = 0; i < NSTRIP; ++i) {
      const int col = c0 + (i * 32 + lane) * VEC;
#pragma unroll
      for (int v = 0; v < VEC; ++v)
#pragma unroll
        for (int c = 0; c < C; ++c)
          tr[i][v][c] = (col < R) ? ts[c * L.tpitch + col + v] : 0.f;
    }
#pragma unroll 2
    for (int r = warp; r < rows; r += kWarps) {
      const float* row =
          reinterpret_cast<const float*>(us + (size_t)r * L.pitch);
      float sum[C];
#pragma unroll
      for (int c = 0; c < C; ++c) sum[c] = 0.f;
#pragma unroll
      for (int i = 0; i < NSTRIP; ++i) {
        const int col = c0 + (i * 32 + lane) * VEC;
        if (col < R) {
          float uv[VEC];
          load16(row + col, uv);
#pragma unroll
          for (int v = 0; v < VEC; ++v)
#pragma unroll
            for (int c = 0; c < C; ++c) sum[c] += uv[v] * tr[i][v][c];
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) sum[c] = warp_sum(sum[c]);
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < C; ++c)
          ys[c * L.rows16 + r] =
              (c0 == 0 ? 0.f : ys[c * L.rows16 + r]) + sum[c];
      }
    }
  }
}

// Persistent: cluster i takes LD blocks i, i + n, i + 2n, ... (n clusters
// fill the card). bf16 slots: the ring's size (see Layout); f32 takes 1.
template <typename TU, int C>
__global__ void __launch_bounds__(kThreads)
    cluster_matvec_kernel(const __grid_constant__ CUtensorMap umap,
                          const TU* __restrict__ u, const float* __restrict__ s,
                          const float* __restrict__ d,
                          const float* __restrict__ x, float* __restrict__ y,
                          int B, int P, int R, int slots) {
  constexpr bool kTensorCores = std::is_same<TU, __nv_bfloat16>::value;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks();
  const int g = (int)cluster.block_rank();
  const int nclust = gridDim.x / G;
  const int rows = P / G;
  const int row0 = g * rows;
  const int tid = threadIdx.x;
  const Layout L = cluster_layout(P, R, C, G, (int)sizeof(TU), slots);

  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // [kMaxSlots + 2]
  uint64_t* vbars = bars + kMaxSlots;
  unsigned char* us = smem + L.ubuf;
  float* part0 = reinterpret_cast<float*>(smem + L.part);  // [2][C][r16]
  TU* ts = reinterpret_cast<TU*>(smem + L.ts);             // [C][tpitch]
  float* ys = reinterpret_cast<float*>(smem + L.ys);       // [C][rows16]

  // f32: U's rows land in chunks of ~kChunkBytes, at most kMaxChunks of
  // them, one bulk copy per row into the padded pitch, spread over the
  // threads, each set of copies armed first by thread 0 (one
  // expected-bytes count per mbarrier)
  const int row_bytes = R * (int)sizeof(TU);
  int chunk_rows = max(1, kChunkBytes / row_bytes);
  chunk_rows = max(chunk_rows, (rows + kMaxChunks - 1) / kMaxChunks);
  const int nchunks = (rows + chunk_rows - 1) / chunk_rows;
  auto arm_rows = [&]() {
    for (int j = 0; j < nchunks; ++j)
      mbar_expect_tx(&bars[j],
                     (uint32_t)(min(chunk_rows, rows - j * chunk_rows) *
                                row_bytes));
  };
  auto issue_rows = [&](int blk) {
    const TU* src = u + ((size_t)blk * P + row0) * R;
    for (int r = tid; r < rows; r += kThreads)
      bulk_load(us + (size_t)r * L.pitch, src + (size_t)r * R,
                (uint32_t)row_bytes, &bars[r / chunk_rows]);
  };
  // bf16: column block cb of this cluster's j-th block is sequence
  // j * ncb + cb of the ring, in slot seq % slots; thread 0 issues every
  // sequence below `limit` (a slot's previous sequence is done by then)
  const int first = blockIdx.x / G;
  const int total = (B - first + nclust - 1) / nclust * L.ncb;
  int issued = 0, islot = 0, icb = 0, iblk = first;  // thread 0's
  auto issue_ring = [&](int limit) {
    for (; issued < min(limit, total); ++issued) {
      mbar_expect_tx(&bars[islot], (uint32_t)(128 * rows));
      tile_load(us + islot * L.slot, &umap, 64 * icb, iblk * P + row0,
                &bars[islot]);
      if (++islot == slots) islot = 0;
      if (++icb == L.ncb) {
        icb = 0;
        iblk += nclust;
      }
    }
  };
  // x/d/s buffer v takes block blk's x, d and s
  auto arm_vec = [&](int v) {
    mbar_expect_tx(&vbars[v], (uint32_t)(4 * ((C + 1) * rows + R)));
  };
  auto issue_vec = [&](int v, int blk) {
    unsigned char* base = smem + L.vbuf + v * L.vstride;
    if (tid < C)
      bulk_load(base + 4 * (size_t)tid * L.rows16,
                x + ((size_t)blk * C + tid) * P + row0, 4 * rows, &vbars[v]);
    else if (tid == C)
      bulk_load(base + L.vd, d + (size_t)blk * P + row0, 4 * rows, &vbars[v]);
    else if (tid == C + 1)
      bulk_load(base + L.vs, s + (size_t)blk * R, 4 * R, &vbars[v]);
  };

  // once: the barriers, zeros in every pad the copies never write, and the
  // first block's copies (bf16: as many sequences as there are slots)
  if (tid == 0) {
    for (int j = 0; j < kMaxSlots + 2; ++j) mbar_init(&bars[j], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if constexpr (kTensorCores) issue_ring(slots);
    else arm_rows();
    arm_vec(0);
  }
  if constexpr (!kTensorCores) {  // (the tensor copies zero bf16's pads)
    for (int j = tid; j < L.rows16 * L.r16; j += kThreads) {
      const int r = j / L.r16, col = j - r * L.r16;
      if (r >= rows || col >= R)
        store_t(reinterpret_cast<TU*>(us + (size_t)r * L.pitch) + col, 0.f);
    }
  }
  for (int v = 0; v < 2; ++v) {
    float* vb = reinterpret_cast<float*>(smem + L.vbuf + v * L.vstride);
    for (int j = tid; j < (C + 1) * L.rows16; j += kThreads)
      if (j % L.rows16 >= rows) vb[j] = 0.f;  // x's and d's pad rows
    for (int j = R + tid; j < L.r16; j += kThreads)
      vb[L.vs / 4 + j] = 0.f;
  }
  for (int j = tid; j < C * L.tpitch; j += kThreads)
    if (j % L.tpitch >= R) store_t(ts + j, 0.f);
  __syncthreads();
  if constexpr (!kTensorCores) issue_rows(first);
  issue_vec(0, first);

  int it = 0;
  for (int blk = first; blk < B; blk += nclust, ++it) {
    const int v = it & 1;
    const int next = blk + nclust;
    const int q0 = it * L.ncb;  // bf16: this block's first ring sequence
    const unsigned char* vb = smem + L.vbuf + v * L.vstride;
    const float* xs = reinterpret_cast<const float*>(vb);
    const float* ds = reinterpret_cast<const float*>(vb + L.vd);
    const float* ss = reinterpret_cast<const float*>(vb + L.vs);
    float* part = part0 + v * C * L.r16;
    mbar_wait(&vbars[v], (uint32_t)(it >> 1) & 1u);

    // 1. this slice's partial t_g[c][r] = sum_p U[p][r] x[c][p]
    if constexpr (kTensorCores) {
      partial_t_mma<C>(L, us, slots, q0, xs, part, R, bars);
      // step 3 reads every column block
      for (int seq = q0; seq < q0 + L.ncb; ++seq)
        mbar_wait(&bars[seq % slots], (uint32_t)(seq / slots) & 1u);
    } else {
      partial_t_fma<C>(L, us, xs, part,
                       reinterpret_cast<float*>(smem + L.wp), R, rows, bars,
                       (uint32_t)it & 1u, chunk_rows, nchunks);
    }
    // thread 0 has waited on this block's barriers and arms them for the
    // next block (its copies come after step 3; other threads still waiting
    // on this phase see it complete)
    if (tid == 0 && next < B) {
      if constexpr (!kTensorCores) arm_rows();
      arm_vec(v ^ 1);
    }
    cluster_arrive();
    cluster_wait();
    if (next < B) issue_vec(v ^ 1, next);

    // 2. t = round(s * sum of the G partials), added in cluster-rank order
    //    (eight loads in flight at a time). A CTA overwrites this partial
    //    buffer two blocks later, after the next cluster barrier, which no
    //    CTA passes before every CTA has finished reading it here.
    for (int j = 4 * tid; j < C * L.r16; j += 4 * kThreads) {
      float4* mine = reinterpret_cast<float4*>(part + j);
      float4 acc = *cluster.map_shared_rank(mine, 0);
#pragma unroll 1
      for (int r0 = 1; r0 < G; r0 += 8) {
        float4 w[8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          if (r0 + r < G) w[r] = *cluster.map_shared_rank(mine, r0 + r);
#pragma unroll
        for (int r = 0; r < 8; ++r)
          if (r0 + r < G) {
            acc.x += w[r].x;
            acc.y += w[r].y;
            acc.z += w[r].z;
            acc.w += w[r].w;
          }
      }
      const int c = j / L.r16, col = j - c * L.r16;
      const float e[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (col + q < R) store_t(ts + c * L.tpitch + col + q, e[q] * ss[col + q]);
    }
    __syncthreads();

    // 3. y[c][p] = sum_r U[p][r] t[c][r] from the resident slice, + d x
    if constexpr (kTensorCores)
      rows_mma<C>(L, us, slots, q0, ts, ys, rows);
    else
      rows_fma<C>(L, us, ts, ys, R, rows);
    __syncthreads();  // this block's slice is free
    if constexpr (kTensorCores) {
      if (tid == 0) issue_ring(q0 + L.ncb + slots);
    } else if (next < B) {
      issue_rows(next);
    }
    float* yb = y + (size_t)blk * C * P + row0;
    for (int j = tid; j < C * rows; j += kThreads) {
      const int c = j / rows, r = j - c * rows;
      yb[(size_t)c * P + r] =
          ys[c * L.rows16 + r] + ds[r] * xs[c * L.rows16 + r];
    }
    __syncthreads();  // x/d/s buffer v and y are free
  }
  // no CTA leaves while another may read its partials
  cluster_arrive();
  cluster_wait();
}

template <typename TU, int C>
cudaError_t prepare_cluster(int G, size_t smem) {
  auto kernel = cluster_matvec_kernel<TU, C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && G > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

cudaLaunchConfig_t cluster_config(int nclusters, int G, size_t smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = G;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nclusters * G);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the [B * P, R] bf16 U as a 2-D tensor map: boxes of 64 columns by
// `rows` rows, 128-byte swizzle, zeros past R; the encoder comes from the
// driver at run time, so the library links no libcuda
cudaError_t encode_umap(CUtensorMap* map, const void* u, int B, int P, int R,
                        int rows) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
        cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess) return cudaErrorNotSupported;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)R, (cuuint64_t)B * P};
  const cuuint64_t strides[1] = {(cuuint64_t)R * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(u), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename TU, int C>
cudaError_t launch_cluster(const void* u, const void* s, const void* d,
                           const void* x, void* y, int B, int P, int R, int G,
                           int slots, int nclusters, size_t smem,
                           cudaStream_t stream) {
  cudaError_t err = prepare_cluster<TU, C>(G, smem);
  if (err != cudaSuccess) return err;
  CUtensorMap umap = {};
  if (std::is_same<TU, __nv_bfloat16>::value) {
    err = encode_umap(&umap, u, B, P, R, P / G);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(nclusters, G, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, cluster_matvec_kernel<TU, C>, umap,
                           static_cast<const TU*>(u),
                           static_cast<const float*>(s),
                           static_cast<const float*>(d),
                           static_cast<const float*>(x),
                           static_cast<float*>(y), B, P, R, slots);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename TU, int C>
cudaError_t clusters_placeable(int G, size_t smem, int* count) {
  cudaError_t err = prepare_cluster<TU, C>(G, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(1, G, smem, 0, &attr);
  return cudaOccupancyMaxActiveClusters(count, cluster_matvec_kernel<TU, C>,
                                        &cfg);
}

// ---------------------------------------------------------------------------
// two-read route
// ---------------------------------------------------------------------------

template <typename TU, int C>
__global__ void __launch_bounds__(kThreads)
    block_matvec_kernel(const TU* __restrict__ u, const float* __restrict__ s,
                        const float* __restrict__ d,
                        const float* __restrict__ x, float* __restrict__ y,
                        int P, int R) {
  constexpr int VEC = 16 / sizeof(TU);
  constexpr int CHUNK = 32 * VEC * kStrips;  // columns per register chunk
  extern __shared__ float tsh[];             // [C][R]

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
                float* dst = tsh + c * R + col + v;
                *dst = (w == 0) ? acc[i][v][c] : *dst + acc[i][v][c];
              }
          }
        }
      }
      __syncthreads();
    }
  }
  for (int j = threadIdx.x; j < C * R; j += kThreads)
    tsh[j] = round_to<TU>(tsh[j] * sb[j % R]);
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
          tr[i][v][c] = (col < R) ? tsh[c * R + col + v] : 0.f;
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

// the cluster route's shape rules; smem must be what cluster_layout gives,
// so the host's planner and the kernel's layout agree
bool cluster_shape_ok(int P, int R, int C, int G, int itemsize, int slots,
                      size_t smem) {
  const int rank_cap = itemsize == 2 ? 64 * (kMaxSlots / 2) : kMaxRank;
  const bool ring_ok = itemsize == 2
                           ? slots >= (R + 63) / 64 && slots <= kMaxSlots
                           : slots == 1;
  const int rows_cap = itemsize == 2 ? 256 : P;  // a tensor copy's box
  return G >= 1 && G <= kMaxCluster && P % G == 0 && (P / G) % 16 == 0 &&
         P / G <= rows_cap && R % 8 == 0 && R <= rank_cap && C >= 1 &&
         C <= 3 && ring_ok &&
         smem == cluster_layout(P, R, C, G, itemsize, slots).total;
}

template <typename TU>
cudaError_t dispatch_cluster(const void* u, const void* s, const void* d,
                             const void* x, void* y, int B, int P, int R,
                             int C, int G, int slots, int nclusters,
                             size_t smem, cudaStream_t stream) {
  switch (C) {
    case 1:
      return launch_cluster<TU, 1>(u, s, d, x, y, B, P, R, G, slots,
                                   nclusters, smem, stream);
    case 2:
      return launch_cluster<TU, 2>(u, s, d, x, y, B, P, R, G, slots,
                                   nclusters, smem, stream);
    case 3:
      return launch_cluster<TU, 3>(u, s, d, x, y, B, P, R, G, slots,
                                   nclusters, smem, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TU>
cudaError_t placeable_c(int C, int G, size_t smem, int* count) {
  switch (C) {
    case 1:
      return clusters_placeable<TU, 1>(G, smem, count);
    case 2:
      return clusters_placeable<TU, 2>(G, smem, count);
    case 3:
      return clusters_placeable<TU, 3>(G, smem, count);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Two-read route. u [B, P, R] (f32, or bf16 when u_bf16); s [B, R],
// d [B, P], x and y [B, C, P] f32. Returns the launch's cudaError_t.
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

// Cluster route: operands as above; G CTAs per block, `slots` column-block
// slots in each CTA's ring (bf16; 1 for f32), smem bytes of dynamic shared
// memory per CTA, and nclusters persistent clusters (at most what
// vilma_block_matvec_cluster_fit reports).
extern "C" int vilma_block_matvec_cluster(const void* u, const void* s,
                                          const void* d, const void* x,
                                          void* y, int B, int P, int R, int C,
                                          int u_bf16, int G, int slots,
                                          int nclusters, int smem,
                                          void* stream) {
  if (!cluster_shape_ok(P, R, C, G, u_bf16 ? 2 : 4, slots, (size_t)smem) ||
      nclusters < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      u_bf16 ? dispatch_cluster<__nv_bfloat16>(u, s, d, x, y, B, P, R, C, G,
                                               slots, nclusters, smem, st)
             : dispatch_cluster<float>(u, s, d, x, y, B, P, R, C, G, slots,
                                       nclusters, smem, st);
  return (int)err;
}

// How many clusters of the cluster route's configuration the current
// device can hold at once (0: it cannot place one), into *count.
extern "C" int vilma_block_matvec_cluster_fit(int P, int R, int C, int u_bf16,
                                              int G, int slots, int smem,
                                              int* count) {
  *count = 0;
  if (!cluster_shape_ok(P, R, C, G, u_bf16 ? 2 : 4, slots, (size_t)smem))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = u_bf16 ? placeable_c<__nv_bfloat16>(C, G, smem, count)
                           : placeable_c<float>(C, G, smem, count);
  return (int)err;
}
