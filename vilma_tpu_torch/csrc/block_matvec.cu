// Fused low-rank block matvec for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vilma_tpu/ops/pallas/block_matvec.py
// (`_kernel`, reached from bucket_matvec_multi):
//
//     y[b, c] = U_b (s_b * (U_b^T x[b, c])) + d_b * x[b, c]
//
// for B padded [P, R] LD blocks and C cohorts sharing the panel, C one of
// kCohorts (1, 2, 3, 4, 8; the wrapper runs 5-7 cohorts as 8, the extra
// rows of x zero, and more as several launches).
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
// Group route (group_matvec_kernel), for the blocks the cluster route does
// not take (too large for 16 CTAs of shared memory, ranks above 1024 bf16
// or 2048 f32, under 16 rows per CTA). A block is spread over a group of G
// CTAs on as many SMs (up to 128: even a bucket of one block runs on the
// whole card), split by COLUMNS of U: CTA g owns a few 16-byte column
// groups (a [2048, 1024] f32 block: 8 columns, a 64 KB slice of all 2048
// rows). Then t = s * U^T x needs no sum across CTAs (each owns its t
// entries) and both products are local: only the second one,
// y = sum over CTAs of U_g t_g, meets across the group, once per block. A
// cooperative launch keeps every CTA resident (it is refused, and the
// wrapper raises, where the card cannot hold the grid); as many groups as
// fit walk the blocks. Per block, in CTA g:
//   0. its slice lands in shared memory by TMA tensor copies (two buffers:
//      the next block's lands while this one is worked on), read from device
//      memory once; where two slices do not fit (e.g. [4096, 4096] bf16)
//      both products read U from device memory, the second from L2, and one
//      group (the whole card) works on one block at a time;
//   1. t_g = round(s_g * U_g^T round(x)) on the CUDA cores (each element of
//      U feeds 2C multiply-adds: 8 operations per byte of f32 U at C = 8,
//      below the card's ~20 per HBM byte);
//   2. its partial y_g = U_g t_g [C][P], written to a workspace past L1,
//      then an arrival on the group's barrier (counters in device memory,
//      release/acquire);
//   3. an iteration later (the barrier's wait overlaps the next block's
//      steps 1 and 2), its share of y's rows: the G partials added in rank
//      order, + d x.
// No float atomics: every sum of both routes runs in a fixed order, so
// results repeat bit for bit.
#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap (the encoder is found at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// the cohort counts C the kernels are built for (the bf16 tensor-core
// steps hold up to 8 cohorts in an m16n8k16 tile's rows or columns)
__host__ __device__ constexpr bool cohorts_ok(int C) {
  return C == 1 || C == 2 || C == 3 || C == 4 || C == 8;
}

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

constexpr int kMaxDevices = 64;

// What a kernel's attributes were set to on each device (one per kernel).
struct Grant {
  std::mutex mu;
  size_t smem[kMaxDevices] = {};
  bool wide[kMaxDevices] = {};
};

// Raises `kernel`'s dynamic shared-memory limit on the current device to
// smem and, when `wide`, allows clusters above 8 CTAs, each only when it
// grows: the limit bounds a launch's shared memory and does not set it, so
// later launches of the kernel make no driver call for it.
cudaError_t allow(Grant& grant, const void* kernel, size_t smem, bool wide) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(grant.mu);
  if (smem > grant.smem[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    grant.smem[dev] = smem;
  }
  if (wide && !grant.wide[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    grant.wide[dev] = true;
  }
  return cudaSuccess;
}

template <typename TU, int C>
cudaError_t prepare_cluster(int G, size_t smem) {
  static Grant grant;
  return allow(grant,
               reinterpret_cast<const void*>(cluster_matvec_kernel<TU, C>),
               smem, G > 8);
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

// what a tensor map encodes: U's address and shape, the box, the swizzle
struct MapKey {
  const void* u;
  int B, P, R, cols, rows;
  bool bf16, swizzle;
  bool operator==(const MapKey& o) const {
    return u == o.u && B == o.B && P == o.P && R == o.R && cols == o.cols &&
           rows == o.rows && bf16 == o.bf16 && swizzle == o.swizzle;
  }
};

// the [B * P, R] U (bf16 or f32) as a 2-D tensor map: boxes of `cols`
// columns by `rows` rows, zeros past R; the 128-byte swizzle (bf16
// cluster route) or none. The last kMaps maps are kept: a map depends on
// its key alone, so a fit's buckets, called again at the same address,
// reuse theirs. The encoder is looked up at run time
// (cudaGetDriverEntryPoint), so the library links no libcuda.
cudaError_t encode_map(CUtensorMap* map, const void* u, bool bf16, int B,
                       int P, int R, int cols, int rows, bool swizzle) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);
  constexpr int kMaps = 32;
  static std::mutex mu;
  static MapKey keys[kMaps] = {};
  static CUtensorMap maps[kMaps];
  static int filled = 0, slot = 0;
  static Encode encode = nullptr;
  const MapKey key = {u, B, P, R, cols, rows, bf16, swizzle};
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < filled; ++i)
    if (keys[i] == key) {
      *map = maps[i];
      return cudaSuccess;
    }
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
        cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess) return cudaErrorNotSupported;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)R, (cuuint64_t)B * P};
  const cuuint64_t strides[1] = {(cuuint64_t)R * (bf16 ? 2 : 4)};
  const cuuint32_t box[2] = {(cuuint32_t)cols, (cuuint32_t)rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult res = encode(
      map,
      bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      2, const_cast<void*>(u), dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return cudaErrorInvalidValue;
  keys[slot] = key;
  maps[slot] = *map;
  slot = (slot + 1) % kMaps;
  if (filled < kMaps) ++filled;
  return cudaSuccess;
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
    err = encode_map(&umap, u, true, B, P, R, 64, P / G, true);
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
// group route
// ---------------------------------------------------------------------------

constexpr size_t kBarBytes = 128;  // the mbarrier area (unused slots pad it)
// a group-route CTA: 12 warps work on one block (steps 1 and 2) while 4
// warps wait for and reduce the block before (step 3)
constexpr int kComputeWarps = 12;
constexpr int kReduceWarps = 4;
constexpr int kComputeThreads = 32 * kComputeWarps;
constexpr int kReduceThreads = 32 * kReduceWarps;
constexpr int kGroupThreads = kComputeThreads + kReduceThreads;
// a group barrier counts arrivals on up to kSub counters (CTA g on counter
// g % kSub), kSubStride words apart, so that no one address takes more
// than G / kSub atomics per barrier
constexpr int kSub = 8;
constexpr int kSubStride = 32;
// partial-y buffers and barrier slots in the workspace (block j uses slot
// j % kYBufs)
constexpr int kYBufs = 4;

// CTA g of a group owns `cgc` column groups of 16 bytes (columns
// [g cgc vec, (g + 1) cgc vec) of U, vec = 16 / itemsize; cgc a power of
// two <= 32) and rows [g rpc, (g + 1) rpc) of y. Its shared memory (byte
// offsets from a 128-byte aligned base): the mbarriers; nbuf slices of U's
// P rows by its cgc column groups (row pitch 16 cgc bytes) and as many
// buffers of the block's x [C][P]; three buffers (blocks j - 1, j, j + 1)
// of its share of s [cgc vec], of d [rpc] and of x [C][rpc]; t [C][cgc
// vec]; the compute warps' sums of step 1 [kComputeWarps][cgc][vec][C];
// and the reduce warps' lane sums [kReduceThreads].
// ops/cuda/block_matvec.py::group_smem computes the same total (with 128
// bytes to align the base).
struct GroupLayout {
  int cgc, rpc, vec;
  size_t slice, xfull, vbuf, vstride, ts, red, redr, total;
};

__host__ __device__ inline GroupLayout group_layout(int P, int R, int C,
                                                   int G, int itemsize,
                                                   int nbuf) {
  GroupLayout L;
  L.vec = 16 / itemsize;
  const int ncg = R / L.vec;
  const int per = (ncg + G - 1) / G;
  L.cgc = 1;
  while (L.cgc < per) L.cgc *= 2;
  L.rpc = (P + G - 1) / G;
  // (each rounded up to 128 bytes, where the tensor copies land)
  L.slice = ((size_t)P * L.cgc * 16 + 127) / 128 * 128;
  L.xfull = (4 * (size_t)C * P + 127) / 128 * 128;
  L.vbuf = kBarBytes + nbuf * (L.slice + L.xfull);
  L.vstride = (4 * ((size_t)L.cgc * L.vec + (C + 1) * L.rpc) + 15) / 16 * 16;
  L.ts = L.vbuf + 3 * L.vstride;
  L.red = L.ts + (4 * (size_t)C * L.cgc * L.vec + 15) / 16 * 16;
  L.redr = L.red + 4 * (size_t)kComputeWarps * L.cgc * L.vec * C;
  L.total = L.redr + 4 * kReduceThreads + 128;  // room to align the base
  return L;
}

// 4 bytes from device memory into shared memory, asynchronously
// (cp.async; complete after cp_async_wait_all in the issuing thread)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// this thread's copies have landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// a barrier among n threads of the CTA (id 1: the compute warps, 2: the
// reduce warps; 0 is __syncthreads)
__device__ __forceinline__ void warps_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Split-phase group barrier of one block slot: nsub = min(kSub, G)
// counters in device memory. Arrive (the compute warps): the CTA's writes
// are published (fence), then CTA g adds one to counter g % nsub. Wait
// (the reduce warps): until every counter reads k G / nsub at the slot's
// k-th use (acquire; reduce thread i polls counter i). The counters start
// at 0 (the launch before zeroed them) and only grow. A counter sums arrivals of
// several CTAs, so a slot must not be reused while a CTA may still owe an
// arrival to its previous use.
__device__ __forceinline__ void group_arrive(unsigned int* ctrs, int g,
                                             int nsub) {
  warps_sync(1, kComputeThreads);
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(ctrs + (g % nsub) * kSubStride, 1u);
  }
}

__device__ __forceinline__ void group_wait(unsigned int* ctrs, int nsub,
                                           unsigned int target) {
  const int rt = threadIdx.x - kComputeThreads;
  if (rt < nsub) {
    const unsigned int* ctr = ctrs + rt * kSubStride;
    unsigned int seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen)
                   : "l"(ctr)
                   : "memory");
    } while (seen < target);
    __threadfence();
  }
  warps_sync(2, kReduceThreads);
}

// Steps 1 and 2 of a block, local to the CTA, by its compute warps. us:
// its slice (row p at us + p * pitch elements; cgl of the cgc groups at
// cgl * vec); ncl of its column groups exist (the rest lie past R). xb:
// the block's x [C][P] (in shared memory with HOLD, else in device
// memory); sv its share of s.
// 1. t[c][k] = round(s[k] * sum_p U[p][k] round(x[c][p])): compute thread
//    (part, cgl), part = tid / cgc of nparts = kComputeThreads / cgc, adds
//    rows part, part + nparts, ... in order; a butterfly shuffle adds the
//    parts of a warp (offsets 16, 8, ..., cgc), then one thread sums the
//    warps in warp order.
// 2. ypart[c][p] = sum_k U[p][k] t[c][k]: thread p (p = tid, tid +
//    kComputeThreads, ...) adds its row's column groups in order; written
//    past L1 to the block's partial-y buffer [C][P].
template <typename TU, int C, bool HOLD>
__device__ __forceinline__ void group_local(const GroupLayout& L,
                                            const TU* us, size_t pitch,
                                            int ncl, int P, const float* xb,
                                            const float* sv, float* ts,
                                            float* red, float* ypart) {
  constexpr int VEC = 16 / sizeof(TU);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cgl = tid % L.cgc, part = tid / L.cgc;
  const int nparts = kComputeThreads / L.cgc;
  float acc[VEC][C];
#pragma unroll
  for (int v = 0; v < VEC; ++v)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[v][c] = 0.f;
  if (cgl < ncl) {
    const TU* col = us + cgl * VEC;
#pragma unroll 4
    for (int p = part; p < P; p += nparts) {
      float uv[VEC];
      load16(col + (size_t)p * pitch, uv);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float xr = round_to<TU>(HOLD ? xb[(size_t)c * P + p]
                                           : __ldg(xb + (size_t)c * P + p));
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v][c] += uv[v] * xr;
      }
    }
  }
#pragma unroll
  for (int v = 0; v < VEC; ++v)
#pragma unroll
    for (int c = 0; c < C; ++c)
      for (int o = 16; o >= L.cgc; o >>= 1)
        acc[v][c] += __shfl_xor_sync(0xffffffffu, acc[v][c], o);
  if (lane < L.cgc) {
#pragma unroll
    for (int v = 0; v < VEC; ++v)
#pragma unroll
      for (int c = 0; c < C; ++c)
        red[((warp * L.cgc + lane) * VEC + v) * C + c] = acc[v][c];
  }
  warps_sync(1, kComputeThreads);
  const int nt = L.cgc * VEC * C;  // t values of the CTA
  for (int e = tid; e < nt; e += kComputeThreads) {
    float tot = red[e];
    for (int w = 1; w < kComputeWarps; ++w) tot += red[w * nt + e];
    const int c = e % C, k = e / C;  // k = cgl * VEC + v
    ts[c * L.cgc * VEC + k] =
        k < ncl * VEC ? round_to<TU>(tot * sv[k]) : 0.f;
  }
  warps_sync(1, kComputeThreads);
  for (int p = tid; p < P; p += kComputeThreads) {
    const TU* row = us + (size_t)p * pitch;
    float y[C];
#pragma unroll
    for (int c = 0; c < C; ++c) y[c] = 0.f;
    for (int g = 0; g < ncl; ++g) {
      float uv[VEC];
      load16(row + g * VEC, uv);
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          y[c] += uv[v] * ts[c * L.cgc * VEC + g * VEC + v];
    }
#pragma unroll
    for (int c = 0; c < C; ++c) __stcg(ypart + (size_t)c * P + p, y[c]);
  }
}

// Step 3 of a block, by the reduce warps: CTA g's rows [r0, r0 + w) of
// y = sum over the G CTAs' partials + d x. L lanes share a value (L the
// largest power of two with L * values <= kReduceThreads and L <= G); lane
// q adds ranks [q G/L, (q+1) G/L) in rank order (sixteen loads in flight),
// then the value's lane 0 adds the L lane sums in lane order. Neighbouring
// threads take neighbouring rows, so a warp's loads are contiguous. dv, xv:
// the CTA's rows of d and x [C][rpc] in shared memory.
__device__ __forceinline__ void group_reduce(const float* parts, int G,
                                             int C, int P, int r0, int w,
                                             int rpc, const float* dv,
                                             const float* xv, float* y,
                                             float* red) {
  const int rt = threadIdx.x - kComputeThreads;
  const int S = C * w;
  if (S == 0) return;
  int L = 1;
  while (2 * L * S <= kReduceThreads && 2 * L <= G) L *= 2;
  const int per = G / L;
  const int nv = kReduceThreads / L;  // values a round
  const size_t stride = (size_t)C * P;
  const int q = rt / nv, vi = rt - q * nv;
  for (int v0 = 0; v0 < S; v0 += nv) {
    const int v = v0 + vi;
    const int c = v / w, j = v - c * w;
    float acc = 0.f;
    if (v < S) {
      const float* p = parts + (size_t)q * per * stride + (size_t)c * P +
                       r0 + j;
      acc = __ldcg(p);
#pragma unroll 1
      for (int k0 = 1; k0 < per; k0 += 16) {
        float x16[16];
#pragma unroll
        for (int k = 0; k < 16; ++k)
          if (k0 + k < per) x16[k] = __ldcg(p + (k0 + k) * stride);
#pragma unroll
        for (int k = 0; k < 16; ++k)
          if (k0 + k < per) acc += x16[k];
      }
    }
    red[rt] = acc;
    warps_sync(2, kReduceThreads);
    if (q == 0 && v < S) {
      float tot = red[vi];
      for (int k = 1; k < L; ++k) tot += red[k * nv + vi];
      y[(size_t)c * P + r0 + j] = tot + dv[j] * xv[c * rpc + j];
    }
    warps_sync(2, kReduceThreads);
  }
}

// Persistent: group i (G consecutive CTAs) takes LD blocks i, i + n,
// i + 2n, ... (n groups resident at once). Iteration j of a CTA, its two
// warp roles at once:
//   compute warps: steps 1 and 2 of block j from its slice, the partial y
//   into buffer j % kYBufs, arrive;
//   reduce warps: start the copies of block j + 1 (its slice and x with
//   HOLD, by TMA; its shares of s, d and x by cp.async), wait for every
//   CTA's arrival of block j - 1, step 3 of block j - 1, then wait for
//   their cp.async copies;
// and a CTA-wide barrier. The barrier the reduce warps wait on was arrived
// at an iteration earlier. A partial buffer is rewritten only after every
// CTA has passed step 3 of the block that used it four blocks earlier: a
// CTA writes block j's partial after its wait for block j - 2, and every
// CTA arrived for block j - 2 after its iteration j - 3, hence after its
// step 3 of block j - 4. The same bound keeps the barrier slots apart: no
// CTA arrives for block j before every CTA has arrived for block j - 2, so
// slot j % kYBufs is free of block j - 4's. HOLD: the slice (TMA tensor
// copies of 16 cgc bytes by up to 256 rows, from umap) and x (one bulk
// copy per cohort) land in shared memory, two buffers, on one mbarrier
// each. Else steps 1 and 2 read U from device memory, step 2 from L2, and
// step 1 reads x through L1. The workspace holds two sets of barrier
// counters: the launch counts on `ctrs` and zeroes the group's counters in
// `next`, the set of the launch after it (launches on one stream run in
// order, and the host alternates the sets).
template <typename TU, int C, bool HOLD>
__global__ void __launch_bounds__(kGroupThreads)
    group_matvec_kernel(const __grid_constant__ CUtensorMap umap,
                        const TU* __restrict__ u, const float* __restrict__ s,
                        const float* __restrict__ d,
                        const float* __restrict__ x, float* __restrict__ y,
                        float* __restrict__ parts,
                        unsigned int* __restrict__ ctrs,
                        unsigned int* __restrict__ next, int B, int P, int R,
                        int G, int nbuf) {
  constexpr int VEC = 16 / sizeof(TU);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((128u - (smem_addr(smem_raw) & 127u)) & 127u);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  const GroupLayout L = group_layout(P, R, C, G, (int)sizeof(TU), nbuf);
  const int ngroups = gridDim.x / G;
  const int gi = blockIdx.x / G, g = blockIdx.x - gi * G;
  const int ncg = R / VEC;
  const int cg0 = min(ncg, g * L.cgc);
  const int ncl = min(ncg, cg0 + L.cgc) - cg0;
  const int r0 = min(P, g * L.rpc);
  const int w = min(P, r0 + L.rpc) - r0;
  const int nblk = (B - gi + ngroups - 1) / ngroups;
  const int tid = threadIdx.x;
  const bool computes = tid < kComputeThreads;
  const int rt = tid - kComputeThreads;  // reduce thread
  float* ts = reinterpret_cast<float*>(smem + L.ts);
  float* gparts = parts + (size_t)gi * kYBufs * G * C * P;
  unsigned int* ctr = ctrs + (size_t)gi * kYBufs * kSub * kSubStride;
  const int nsub = min(kSub, G);
  const unsigned int per_sub = (unsigned int)(G / nsub);
  auto slot = [&](int j) { return ctr + (j % kYBufs) * kSub * kSubStride; };
  auto blk_of = [&](int j) { return gi + j * ngroups; };
  auto vec_of = [&](int j) {
    return reinterpret_cast<float*>(smem + L.vbuf + (j % 3) * L.vstride);
  };
  auto part_of = [&](int j) {
    return gparts + (size_t)(j % kYBufs) * G * C * P;
  };
  auto slice_at = [&](int j) {
    return smem + kBarBytes + (j & 1) * (L.slice + L.xfull);
  };
  const int box_rows = min(P, 256);
  // block j's copies, by the reduce warps: with HOLD its slice and x
  // (reduce thread 0, TMA, on mbarrier j & 1); its shares of s (sv
  // [cgc vec]), d (dv [rpc]) and x (xv [C][rpc]) by cp.async
  auto issue = [&](int j) {
    const int blk = blk_of(j);
    if constexpr (HOLD) {
      if (rt == 0) {
        unsigned char* dst = slice_at(j);
        mbar_expect_tx(&bars[j & 1],
                       (uint32_t)(P * L.cgc * 16 + 4 * C * P));
        // the buffers' last reads (generic proxy) before the copies
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        for (int r = 0; r < P; r += box_rows)
          tile_load(dst + (size_t)r * L.cgc * 16, &umap, cg0 * VEC,
                    blk * P + r, &bars[j & 1]);
        for (int c = 0; c < C; ++c)
          bulk_load(dst + L.slice + 4 * (size_t)c * P,
                    x + ((size_t)blk * C + c) * P, 4 * P, &bars[j & 1]);
      }
    }
    float* sv = vec_of(j);
    float* dv = sv + L.cgc * VEC;
    float* xv = dv + L.rpc;
    for (int e = rt; e < ncl * VEC; e += kReduceThreads)
      cp_async4(sv + e, s + (size_t)blk * R + cg0 * VEC + e);
    for (int e = rt; e < w; e += kReduceThreads)
      cp_async4(dv + e, d + (size_t)blk * P + r0 + e);
    for (int e = rt; e < C * w; e += kReduceThreads) {
      const int c = e / w, r = e - c * w;
      cp_async4(xv + c * L.rpc + r, x + ((size_t)blk * C + c) * P + r0 + r);
    }
  };
  auto reduce = [&](int j) {
    group_wait(slot(j), nsub, (unsigned int)(j / kYBufs + 1) * per_sub);
    const float* dv = vec_of(j) + L.cgc * VEC;
    group_reduce(part_of(j), G, C, P, r0, w, L.rpc, dv, dv + L.rpc,
                 y + (size_t)blk_of(j) * C * P,
                 reinterpret_cast<float*>(smem + L.redr));
  };

  if (HOLD && tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the next launch's counters of this group: slot rt / kSub, counter
  // rt % kSub
  if (g == 0 && !computes && rt < kYBufs * kSub)
    next[((size_t)gi * kYBufs * kSub + rt) * kSubStride] = 0u;
  __syncthreads();
  if (!computes && nblk > 0) {
    issue(0);
    cp_async_wait_all();
  }
  __syncthreads();
  for (int j = 0; j < nblk; ++j) {
    if (computes) {
      const int blk = blk_of(j);
      const TU* us;
      const float* xb;
      size_t pitch;
      if constexpr (HOLD) {
        mbar_wait(&bars[j & 1], (uint32_t)(j >> 1) & 1u);
        us = reinterpret_cast<const TU*>(slice_at(j));
        xb = reinterpret_cast<const float*>(slice_at(j) + L.slice);
        pitch = (size_t)L.cgc * VEC;
      } else {
        us = u + (size_t)blk * P * R + cg0 * VEC;
        xb = x + (size_t)blk * C * P;
        pitch = (size_t)R;
      }
      group_local<TU, C, HOLD>(L, us, pitch, ncl, P, xb, vec_of(j), ts,
                               reinterpret_cast<float*>(smem + L.red),
                               part_of(j) + (size_t)g * C * P);
      group_arrive(slot(j), g, nsub);
    } else {
      if (j + 1 < nblk) issue(j + 1);
      if (j > 0) reduce(j - 1);
      cp_async_wait_all();
    }
    __syncthreads();
  }
  if (!computes && nblk > 0) reduce(nblk - 1);
}

template <typename TU, int C, bool HOLD>
cudaError_t prepare_group(size_t smem) {
  static Grant grant;
  return allow(grant,
               reinterpret_cast<const void*>(group_matvec_kernel<TU, C, HOLD>),
               smem, false);
}

template <typename TU, int C, bool HOLD>
cudaError_t launch_group(const void* u, const void* s, const void* d,
                         const void* x, void* y, void* ws, int parity, int B,
                         int P, int R, int G, int nbuf, int ngroups,
                         size_t smem, cudaStream_t stream) {
  auto kernel = group_matvec_kernel<TU, C, HOLD>;
  cudaError_t err = prepare_group<TU, C, HOLD>(smem);
  if (err != cudaSuccess) return err;
  CUtensorMap umap = {};
  if (HOLD) {
    const GroupLayout L = group_layout(P, R, C, G, (int)sizeof(TU), nbuf);
    err = encode_map(&umap, u, sizeof(TU) == 2, B, P, R,
                     L.cgc * L.vec, P < 256 ? P : 256, false);
    if (err != cudaSuccess) return err;
  }
  float* parts = static_cast<float*>(ws);
  unsigned int* sets = reinterpret_cast<unsigned int*>(
      parts + (size_t)ngroups * kYBufs * G * C * P);
  const size_t set_words = (size_t)ngroups * kYBufs * kSub * kSubStride;
  unsigned int* ctrs = sets + parity * set_words;
  unsigned int* next = sets + (1 - parity) * set_words;
  const TU* up = static_cast<const TU*>(u);
  const float* sp = static_cast<const float*>(s);
  const float* dp = static_cast<const float*>(d);
  const float* xp = static_cast<const float*>(x);
  float* yp = static_cast<float*>(y);
  void* args[] = {&umap, &up, &sp, &dp, &xp, &yp, &parts, &ctrs,
                  &next, &B, &P, &R, &G, &nbuf};
  // every CTA of a group must be resident: a cooperative launch is
  // refused (and nothing runs) if the card cannot hold the grid
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(ngroups * G), dim3(kGroupThreads),
                                    args, smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// CTAs of this configuration the current device holds at once
template <typename TU, int C, bool HOLD>
cudaError_t group_capacity(size_t smem, int* count) {
  auto kernel = group_matvec_kernel<TU, C, HOLD>;
  cudaError_t err = prepare_group<TU, C, HOLD>(smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kGroupThreads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *count = per_sm * sms;
  return err;
}

// the group route's shape rules; smem must be what group_layout gives
bool group_shape_ok(int P, int R, int C, int G, int itemsize, int nbuf,
                    size_t smem) {
  const int vec = 16 / itemsize;
  if (!(G >= 1 && (G & (G - 1)) == 0 && cohorts_ok(C) && R >= vec &&
        R % vec == 0 && G <= R / vec && P >= 1 &&
        (nbuf == 0 || (nbuf == 2 && P % 4 == 0))))
    return false;
  const GroupLayout L = group_layout(P, R, C, G, itemsize, nbuf);
  return L.cgc <= 32 && smem == L.total;
}

template <typename TU, int C>
cudaError_t dispatch_hold(bool hold, const void* u, const void* s,
                          const void* d, const void* x, void* y, void* ws,
                          int parity, int B, int P, int R, int G, int nbuf,
                          int ngroups, size_t smem, cudaStream_t stream,
                          int* count) {
  if (count != nullptr)
    return hold ? group_capacity<TU, C, true>(smem, count)
                : group_capacity<TU, C, false>(smem, count);
  return hold ? launch_group<TU, C, true>(u, s, d, x, y, ws, parity, B, P, R,
                                          G, nbuf, ngroups, smem, stream)
              : launch_group<TU, C, false>(u, s, d, x, y, ws, parity, B, P,
                                           R, G, nbuf, ngroups, smem, stream);
}

// the group launch (count null) or its capacity query (into *count)
template <typename TU>
cudaError_t dispatch_group(const void* u, const void* s, const void* d,
                           const void* x, void* y, void* ws, int parity, int B,
                           int P, int R, int C, int G, int nbuf, int ngroups,
                           size_t smem, cudaStream_t stream, int* count) {
  const bool hold = nbuf > 0;
  switch (C) {
    case 1:
      return dispatch_hold<TU, 1>(hold, u, s, d, x, y, ws, parity, B, P, R, G,
                                  nbuf, ngroups, smem, stream, count);
    case 2:
      return dispatch_hold<TU, 2>(hold, u, s, d, x, y, ws, parity, B, P, R, G,
                                  nbuf, ngroups, smem, stream, count);
    case 3:
      return dispatch_hold<TU, 3>(hold, u, s, d, x, y, ws, parity, B, P, R, G,
                                  nbuf, ngroups, smem, stream, count);
    case 4:
      return dispatch_hold<TU, 4>(hold, u, s, d, x, y, ws, parity, B, P, R, G,
                                  nbuf, ngroups, smem, stream, count);
    case 8:
      return dispatch_hold<TU, 8>(hold, u, s, d, x, y, ws, parity, B, P, R, G,
                                  nbuf, ngroups, smem, stream, count);
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
         P / G <= rows_cap && R % 8 == 0 && R <= rank_cap &&
         cohorts_ok(C) && ring_ok &&
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
    case 4:
      return launch_cluster<TU, 4>(u, s, d, x, y, B, P, R, G, slots,
                                   nclusters, smem, stream);
    case 8:
      return launch_cluster<TU, 8>(u, s, d, x, y, B, P, R, G, slots,
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
    case 4:
      return clusters_placeable<TU, 4>(G, smem, count);
    case 8:
      return clusters_placeable<TU, 8>(G, smem, count);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Group route. u [B, P, R] (f32, or bf16 when u_bf16); s [B, R],
// d [B, P], x and y [B, C, P] f32; G CTAs per block, nbuf slice buffers per
// CTA (2; 0: U read from device memory in both products), smem bytes of
// dynamic shared memory per CTA, ngroups groups (ngroups * G CTAs, at most
// what vilma_block_matvec_group_fit reports); ws holds
// ngroups * 4 * (G * C * P + 2 * 8 * 32) floats of workspace: the partials,
// then two sets of barrier counters, zero before the first launch. The
// launch counts on set `parity` and zeroes the other; the caller passes
// the other set's parity to the next launch on the same stream. Returns the
// launch's cudaError_t.
extern "C" int vilma_block_matvec_group(const void* u, const void* s,
                                        const void* d, const void* x, void* y,
                                        void* ws, int parity, int B, int P,
                                        int R, int C, int u_bf16, int G,
                                        int nbuf, int ngroups, int smem,
                                        void* stream) {
  if (!group_shape_ok(P, R, C, G, u_bf16 ? 2 : 4, nbuf, (size_t)smem) ||
      ngroups < 1 || (parity != 0 && parity != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      u_bf16 ? dispatch_group<__nv_bfloat16>(u, s, d, x, y, ws, parity, B, P,
                                             R, C, G, nbuf, ngroups, smem, st,
                                             nullptr)
             : dispatch_group<float>(u, s, d, x, y, ws, parity, B, P, R, C, G,
                                     nbuf, ngroups, smem, st, nullptr);
  return (int)err;
}

// How many CTAs of the group route's configuration the current device
// holds at once, into *count.
extern "C" int vilma_block_matvec_group_fit(int P, int R, int C, int u_bf16,
                                            int G, int nbuf, int smem,
                                            int* count) {
  *count = 0;
  if (!group_shape_ok(P, R, C, G, u_bf16 ? 2 : 4, nbuf, (size_t)smem))
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      u_bf16 ? dispatch_group<__nv_bfloat16>(nullptr, nullptr, nullptr,
                                             nullptr, nullptr, nullptr, 0, 0,
                                             P, R, C, G, nbuf, 0, smem, 0,
                                             count)
             : dispatch_group<float>(nullptr, nullptr, nullptr, nullptr,
                                     nullptr, nullptr, 0, 0, P, R, C, G, nbuf,
                                     0, smem, 0, count);
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
