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
// or 2048 f32, under 16 rows per CTA): a 4-8 MB block needs 19-37 SMs'
// shared memory just to be held once, so no one CTA or cluster holds it.
// Spreading a block over many column-split CTAs makes its partials of y
// meet across the card every block: a latency, 5.4-5.7 us a block against
// 1.3-2.5 of bytes (PERF.md section 6). So a block is cut both ways: a
// thread-block cluster of G CTAs (at most 256 rows each) takes a PANEL of
// W columns (~64 KB a CTA), splits its rows, and exchanges its partial t
// through distributed shared memory (bulk copies into every CTA,
// completing on the receiver's mbarrier); a cluster walks a block's panels
// in order, adding each panel's product into y in shared memory, with 2-4
// panels in flight by TMA (one producer thread) and step 1 of the next
// panel running while the partials arrive. Buckets of many blocks need no
// sum across clusters; a bucket of fewer blocks than the card holds
// clusters cuts each block into panel groups whose sums meet by ticket in
// device memory, no CTA waiting for one outside its cluster (a plain
// cluster launch). bf16 products run on the tensor cores (mma.sync, as
// in the cluster route), f32 on the CUDA cores. What bounds it now: the
// synchronization a panel costs (a cluster barrier, the exchange, the
// CTA barriers between its steps, 0.6-1.1 us each), not bytes.
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

// an arrival that orders no memory access (the caller's loads have
// returned their values)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// the address in CTA `rank` of the cluster of this CTA's shared address a
__device__ __forceinline__ uint32_t cluster_addr(uint32_t a, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(a), "r"(rank));
  return out;
}

// bytes (a multiple of 16) of this CTA's shared memory into another CTA's
// (dst and bar: cluster addresses), counted on its mbarrier as completed
// transaction bytes; the copy runs on its own (the async proxy)
__device__ __forceinline__ void copy_remote(uint32_t dst, const void* src,
                                            uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(smem_addr(src)), "r"(bytes), "r"(bar)
      : "memory");
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

// Phase stamps, in the measurement build only (nvcc -DVILMA_MATVEC_STAMPS;
// ops/cuda/build.py VARIANTS): thread 0 of CTA 0 records clock64 at the
// points kStampNames names, and %globaltimer (ns) at the first, for each
// panel it works on, into g_stamps[n][kStampPoints][2] (n < g_stamp_cap,
// its n-th panel; [0] globaltimer, [1] clock64). Elsewhere STAMP compiles
// to nothing.
constexpr int kStampPoints = 7;
#ifdef VILMA_MATVEC_STAMPS
__device__ unsigned long long* g_stamps;
__device__ int g_stamp_cap;
__device__ __forceinline__ void stamp(int n, int k) {
  if (blockIdx.x != 0 || threadIdx.x != 0 || n >= g_stamp_cap) return;
  unsigned long long* at = g_stamps + (size_t)(n * kStampPoints + k) * 2;
  if (k == 0) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    at[0] = ns;
  }
  at[1] = (unsigned long long)clock64();
}
#define STAMP(n, k) stamp(n, k)
#else
#define STAMP(n, k) ((void)0)
#endif
// a panel's start; step 1 of the next panel done; this panel's partials
// received; t formed (and the cluster barrier passed); step 2 done (y
// accumulated); the next panel's partial pushed; at an item's last
// panel, its y written (or its sums and ticket)
constexpr const char* kStampNames =
    "start,next_step1,received,t,step2,pushed,item_end";

// The group route's shapes (ops/cuda/block_matvec.py::plan makes them):
// G CTAs per cluster split the rows (rows = ceil(P / G) each), and a
// block's columns are cut into panels of W (bf16: a multiple of 64, at
// most kGroupPanelBf16; f32: a multiple of 32, at most kGroupPanelF32); a
// CTA's slice of a panel lands by TMA in nbox boxes of box_rows rows (a
// box holds at most 256), as ncb sequences of the ring (bf16: one per 64
// columns, in the cluster route's swizzled 128-byte rows; f32: one per
// panel, rows of W * 4 bytes), the panel's s riding on its first.
constexpr int kGroupPanelBf16 = 512;
constexpr int kGroupPanelF32 = 128;

// Shared memory of one group-route CTA (byte offsets from a 1024-byte
// aligned base): the mbarriers (one per ring slot, two for the receive
// buffers) and the last-arriver flag; the ring of `slots` slots of rows16
// rows; s [stages][W] (a panel's s with its stage, slots / ncb stages);
// two buffers of x [C][rows16] and d [rows16] (an item's rows); the
// partial t [2][C][W] f32 (two panels); what the cluster's CTAs push of
// theirs, [2][G][C][W] f32 (two panels); the warps' step-1 partials
// (f32: [8][C][W]; bf16: [8 / ncb][C][W], 512 C floats); the rounded t
// [C][W + 16 / itemsize] in U's type (padded to 16 bytes); and y
// [C][rows16] f32 (summed over an item's panels). rows16 = nbox *
// box_rows rounded up to 16 (the rows past `rows` stay zero or hold rows
// of the next block, whose x is zero here). `h` holds the slot geometry
// the step helpers read. ops/cuda/block_matvec.py::group_smem computes
// the same total.
struct GroupLayout {
  Layout h;
  int rows, W, cbw, box_rows, nbox;
  size_t sbuf, vbuf, vstride, vd, part, recv, wp, ts, ys, flag, total;
};

__host__ __device__ inline GroupLayout group_layout(int P, int C, int G,
                                                   int W, int itemsize,
                                                   int slots) {
  GroupLayout L;
  L.rows = (P + G - 1) / G;
  L.W = W;
  L.nbox = (L.rows + 255) / 256;
  L.box_rows = ((L.rows + L.nbox - 1) / L.nbox + 7) / 8 * 8;
  L.cbw = itemsize == 2 ? 64 : W;
  Layout& h = L.h;
  h.rows16 = (L.nbox * L.box_rows + 15) / 16 * 16;
  h.r16 = W;
  h.ncb = W / L.cbw;
  h.pitch = L.cbw * itemsize;
  h.tpitch = W + 16 / itemsize;
  h.slot = (size_t)h.rows16 * h.pitch;
  h.ubytes = (size_t)slots * h.slot;
  h.ubuf = ((size_t)(kMaxSlots + 2) * 8 + 1023) / 1024 * 1024;
  L.flag = 8 * (size_t)(kMaxSlots + 2);  // in the mbarriers' area
  L.sbuf = h.ubuf + h.ubytes;
  L.vbuf = L.sbuf + 4 * (size_t)(slots / h.ncb) * W;
  L.vd = 4 * (size_t)C * h.rows16;
  L.vstride = L.vd + 4 * (size_t)h.rows16;
  size_t off = L.vbuf + 2 * L.vstride;
  L.part = off;
  off += 2 * 4 * (size_t)C * W;
  L.recv = off;
  off += 2 * 4 * (size_t)G * C * W;
  L.wp = off;
  off += 4 * (size_t)C * (itemsize == 4 ? kWarps * W : 512);
  L.ts = off;
  off += ((size_t)itemsize * C * h.tpitch + 15) / 16 * 16;
  L.ys = off;
  off += 4 * (size_t)C * h.rows16;
  L.total = off + 1024;  // room to align the base
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

// Group step 1 on the tensor cores (bf16 U): the cluster route's
// partial_t_mma with the rows split over the warps too, so that all 8
// work whatever the panel's column blocks ncb (a power of two up to 8):
// warp w takes column block w % ncb and the k-steps of 16 rows kp, kp +
// np, ... (kp = w / ncb of np = 8 / ncb row parts), its sums in wp[kp];
// then the np row parts are added in order into part [C][W] (once every
// warp has passed the push that may still read it).
template <int C>
__device__ __forceinline__ void panel_t_mma(const Layout& L,
                                            const unsigned char* ring,
                                            int slots, int q0, const float* xs,
                                            float* part, float* wp,
                                            uint64_t* bars) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int np = kWarps / L.ncb, cb = warp % L.ncb, kp = warp / L.ncb;
  const int W = L.r16;
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
  for (int k0 = 16 * kp; k0 < L.rows16; k0 += 16 * np) {
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
  // row g of D is cohort g; a lane holds columns 2q, 2q + 1 of a tile.
  // Through wp even with one row part: `part` may still be read by the
  // push of the panel before.
  float* dst = wp + kp * C * W;
  if (g < C) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = 64 * cb + 16 * j + 8 * h + 2 * q;
        *reinterpret_cast<float2*>(dst + g * W + n) =
            make_float2(acc[j][h][0], acc[j][h][1]);
      }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < C * W; j += kThreads) {
    float v = wp[j];
    for (int p = 1; p < np; ++p) v += wp[p * C * W + j];
    part[j] = v;
  }
}

// Group step 1 on the CUDA cores (f32 U): lane l of warp w holds the
// 16-byte chunk ch = l % nch (nch = W / 4) of the rows rg, rg + 8 (32 /
// nch), ... (rg = w 32 / nch + l / nch), so a quarter warp reads 128
// contiguous bytes of one row; the lanes of a chunk are added by a
// butterfly (offsets nch, 2 nch, ..., 16), then the 8 warps in warp order
// into part [C][W].
template <int C>
__device__ __forceinline__ void panel_t_fma(const Layout& L,
                                            const unsigned char* us,
                                            const float* xs, float* part,
                                            float* wp) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = L.r16, nch = W / 4, lpw = 32 / nch;
  const int ch = lane % nch, rg = warp * lpw + lane / nch;
  float acc[4][C];
#pragma unroll
  for (int v = 0; v < 4; ++v)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[v][c] = 0.f;
#pragma unroll 4
  for (int r = rg; r < L.rows16; r += kWarps * lpw) {
    float uv[4];
    load16(reinterpret_cast<const float*>(us + (size_t)r * L.pitch) + 4 * ch,
           uv);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float xr = xs[c * L.rows16 + r];
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[v][c] += uv[v] * xr;
    }
  }
  for (int o = nch; o < 32; o <<= 1)
#pragma unroll
    for (int v = 0; v < 4; ++v)
#pragma unroll
      for (int c = 0; c < C; ++c)
        acc[v][c] += __shfl_xor_sync(0xffffffffu, acc[v][c], o);
  if (lane < nch) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      *reinterpret_cast<float4*>(wp + (warp * C + c) * W + 4 * ch) =
          make_float4(acc[0][c], acc[1][c], acc[2][c], acc[3][c]);
  }
  __syncthreads();
  for (int j = tid; j < C * W; j += kThreads) {
    float v = wp[j];
    for (int w = 1; w < kWarps; ++w) v += wp[w * C * W + j];
    part[j] = v;
  }
}

// Group step 2 on the tensor cores (bf16 U): the cluster route's rows_mma,
// adding each panel's product to y [C][rows16] (`first`: the item's first
// panel, which sets it).
template <int C>
__device__ __forceinline__ void panel_rows_mma(const Layout& L,
                                               const unsigned char* ring,
                                               int slots, int q0,
                                               const __nv_bfloat16* ts,
                                               float* ys, bool first) {
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
    // a lane holds rows g and g + 8 of the tile, cohorts 2q and 2q + 1
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 2 * q + e, row = p0 + g + 8 * h, i = 2 * h + e;
        if (c < C) {
          float* at = ys + c * L.rows16 + row;
          const float v = (acc[0][i] + acc[1][i]) + (acc[2][i] + acc[3][i]);
          *at = first ? v : *at + v;
        }
      }
  }
}

// Group step 2 on the CUDA cores (f32 U): thread p takes row p (p, p +
// 256, ...), adding U[p][k] t[c][k] over the panel's 16-byte chunks from
// chunk p % nch on (so a quarter warp reads 8 different chunks: no bank
// conflict), then adds the row's sum to y [C][rows16] (`first` sets it).
template <int C>
__device__ __forceinline__ void panel_rows_fma(const Layout& L,
                                               const unsigned char* us,
                                               const float* ts, float* ys,
                                               bool first) {
  const int nch = L.r16 / 4;
  for (int p = threadIdx.x; p < L.rows16; p += kThreads) {
    const float* row = reinterpret_cast<const float*>(us + (size_t)p * L.pitch);
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;
    int ch = p % nch;
#pragma unroll 4
    for (int k = 0; k < nch; ++k) {
      float uv[4];
      load16(row + 4 * ch, uv);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float4 t4 =
            *reinterpret_cast<const float4*>(ts + c * L.tpitch + 4 * ch);
        acc[c] += uv[0] * t4.x + uv[1] * t4.y + uv[2] * t4.z + uv[3] * t4.w;
      }
      ch = ch + 1 == nch ? 0 : ch + 1;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float* at = ys + c * L.rows16 + p;
      *at = first ? acc[c] : *at + acc[c];
    }
  }
}

// Persistent: a work item is panel group pg of LD block b (panels [pg
// ppi, pg ppi + ppi) of its npanel = ceil(R / W), ngrp = ceil(npanel /
// ppi) groups a block); cluster i of n takes the items i, i + n, ..., item
// k being (b, pg) = (k / ngrp, k % ngrp). Per panel of an item, in CTA g
// (rows [g rows, (g + 1) rows) of the block, the panel's W columns):
//   0. its slice lands by TMA in the ring (thread 0 keeps `slots`
//      sequences in flight, across panels and items), with the panel's
//      s; an item's rows of x and d come by cp.async, an item ahead;
//   1. the partial t_g[c][k] = sum over its rows of U[p][k] x[c][p]:
//      panel_t_mma (bf16) or panel_t_fma (f32);
//   2. its partial pushed to every CTA of the cluster (bulk copies into
//      distributed shared memory, counted on the receiver's mbarrier); step
//      1 of the next panel; the wait for the G partials; then t = round(s *
//      the G partials added in rank order), zero past R;
//   3. y[c][p] += sum_k U[p][k] t[c][k] for its rows (panel_rows_mma /
//      panel_rows_fma), in panel order; the slots are then free.
// At an item's end: with one group a block (ngrp = 1), y = that + d x.
// Else the CTA stores its rows of the group's sum to the block's slab of
// the workspace (parts [B][ngrp][C][P]) and takes a ticket on the block's
// row share (tickets [B][G]): the last of the ngrp to arrive adds the
// groups' sums in group order, + d x, into y and resets the ticket to 0.
// No CTA waits for one outside its cluster.
template <typename TU, int C>
__global__ void __launch_bounds__(kThreads)
    group_matvec_kernel(const __grid_constant__ CUtensorMap umap,
                        const float* __restrict__ s,
                        const float* __restrict__ d,
                        const float* __restrict__ x, float* __restrict__ y,
                        float* __restrict__ parts,
                        unsigned int* __restrict__ tickets, int B, int P,
                        int R, int W, int slots, int ppi) {
  constexpr bool kTensorCores = std::is_same<TU, __nv_bfloat16>::value;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks();
  const int g = (int)cluster.block_rank();
  const int nclust = gridDim.x / G;
  const int first = blockIdx.x / G;
  const GroupLayout L = group_layout(P, C, G, W, (int)sizeof(TU), slots);
  const int rows16 = L.h.rows16, ncb = L.h.ncb;
  const int npanel = (R + W - 1) / W;
  const int ngrp = (npanel + ppi - 1) / ppi;
  const int nloc = (B * ngrp - first + nclust - 1) / nclust;
  const int row0 = g * L.rows;
  const int w = max(0, min(P, row0 + L.rows) - row0);  // rows of y it owns
  const int tid = threadIdx.x;

  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // [kMaxSlots + 2]
  unsigned char* us = smem + L.h.ubuf;
  float* sbuf = reinterpret_cast<float*>(smem + L.sbuf);   // [stages][W]
  float* part0 = reinterpret_cast<float*>(smem + L.part);  // [2][C][W]
  float* recv0 = reinterpret_cast<float*>(smem + L.recv);  // [2][G][C][W]
  float* wp = reinterpret_cast<float*>(smem + L.wp);
  TU* ts = reinterpret_cast<TU*>(smem + L.ts);        // [C][tpitch]
  float* ys = reinterpret_cast<float*>(smem + L.ys);  // [C][rows16]
  int* flag = reinterpret_cast<int*>(smem + L.flag);
  auto item = [&](int it, int* b, int* p0, int* np) {
    const int k = first + it * nclust;
    *b = k / ngrp;
    *p0 = (k - *b * ngrp) * ppi;
    *np = min(npanel, *p0 + ppi) - *p0;
  };

  // the ring: this CTA's sequences in order (items, their panels, the
  // column blocks), sequence q in slot q % slots; thread 0 issues every
  // sequence below `limit` (a slot's previous sequence is done by then)
  const uint32_t seq_bytes = (uint32_t)(L.nbox * L.box_rows * L.h.pitch);
  int issued = 0, islot = 0, iit = 0, ipj = 0, icb = 0;  // thread 0's
  auto issue_ring = [&](int limit) {
    for (; issued < limit && iit < nloc; ++issued) {
      int b, p0, np;
      item(iit, &b, &p0, &np);
      const int pc = p0 + ipj;
      const int wv = min(W, R - pc * W);
      unsigned char* dst = us + (size_t)islot * L.h.slot;
      mbar_expect_tx(&bars[islot],
                     seq_bytes + (icb == 0 ? 4u * (uint32_t)wv : 0u));
      for (int bx = 0; bx < L.nbox; ++bx)
        tile_load(dst + (size_t)bx * L.box_rows * L.h.pitch, &umap,
                  pc * W + icb * L.cbw, b * P + row0 + bx * L.box_rows,
                  &bars[islot]);
      if (icb == 0)
        bulk_load(sbuf + (size_t)(islot / ncb) * W, s + (size_t)b * R + pc * W,
                  4u * (uint32_t)wv, &bars[islot]);
      if (++islot == slots) islot = 0;
      if (++icb == ncb) {
        icb = 0;
        if (++ipj == np) {
          ipj = 0;
          ++iit;
        }
      }
    }
  };
  // item it's rows of x and d into buffer it & 1, by every thread
  auto issue_vec = [&](int it) {
    int b, p0, np;
    item(it, &b, &p0, &np);
    float* vb = reinterpret_cast<float*>(smem + L.vbuf + (it & 1) * L.vstride);
    float* dv = vb + L.vd / 4;
    for (int e = tid; e < C * w; e += kThreads) {
      const int c = e / w, r = e - c * w;
      cp_async4(vb + c * rows16 + r, x + ((size_t)b * C + c) * P + row0 + r);
    }
    for (int e = tid; e < w; e += kThreads)
      cp_async4(dv + e, d + (size_t)b * P + row0 + e);
  };

  // once: the barriers; zeros in the slots' rows no copy writes and in
  // the x and d rows past w; the first items' copies
  if (tid == 0) {
    for (int j = 0; j < slots; ++j) mbar_init(&bars[j], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  {
    const size_t loaded = (size_t)L.nbox * L.box_rows * L.h.pitch;
    const size_t pad = (L.h.slot - loaded) / 16;
    for (size_t j = tid; j < (size_t)slots * pad; j += kThreads) {
      const size_t sl = j / pad, e = j - sl * pad;
      *reinterpret_cast<uint4*>(us + sl * L.h.slot + loaded + 16 * e) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
  for (int v = 0; v < 2; ++v) {
    float* vb = reinterpret_cast<float*>(smem + L.vbuf + v * L.vstride);
    for (int j = tid; j < (C + 1) * rows16; j += kThreads)
      if (j % rows16 >= w) vb[j] = 0.f;
  }
  __syncthreads();
  if (tid == 0) issue_ring(slots);
  issue_vec(0);
  if (nloc > 1) issue_vec(1);
  cp_async_wait_all();
  __syncthreads();

  // step 1 of this CTA's panel n (of item it, first ring sequence q),
  // into part buffer n & 1 (its last reader, the copies of panel n - 2,
  // had landed before the cluster barrier of panel n - 2 completed)
  auto step1 = [&](int n, int it, int q) {
    const float* xs =
        reinterpret_cast<const float*>(smem + L.vbuf + (it & 1) * L.vstride);
    float* part = part0 + (n & 1) * C * W;
    if constexpr (kTensorCores) {
      panel_t_mma<C>(L.h, us, slots, q, xs, part, wp, bars);
      // step 2 reads every column block
      for (int k = q; k < q + ncb; ++k)
        mbar_wait(&bars[k % slots], (uint32_t)(k / slots) & 1u);
    } else {
      mbar_wait(&bars[q % slots], (uint32_t)(q / slots) & 1u);
      panel_t_fma<C>(L.h, us + (size_t)(q % slots) * L.h.slot, xs, part, wp);
    }
    // the writes of part before the bulk copies (the async proxy) read it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };
  // part buffer n & 1 copied into slot g of every CTA's receive buffer
  // n & 1, whose mbarrier rbar[n & 1] counts the bytes: G bulk copies by
  // one thread, once the CTA's writes of it are done
  uint64_t* rbar = bars + kMaxSlots;  // [2]
  const uint32_t rbytes = (uint32_t)(4 * G * C * W);
  auto push = [&](int n) {
    if (tid != 32) return;
    const float* recv = recv0 + (size_t)(n & 1) * G * C * W;
    const uint32_t dst = smem_addr(recv + (size_t)g * C * W);
    const uint32_t bar = smem_addr(&rbar[n & 1]);
    for (int r = 0; r < G; ++r)
      copy_remote(cluster_addr(dst, r), part0 + (n & 1) * C * W,
                  (uint32_t)(4 * C * W), cluster_addr(bar, r));
  };

  // Software-pipelined by one panel: step 1 of panel n + 1 runs while the
  // partials of panel n arrive. Phase n of the cluster barrier (arrival
  // once a CTA has received and read receive buffer n & 1, wait at the
  // top of panel n + 1's iteration) keeps a CTA from pushing panel n + 2
  // into a buffer another CTA still reads, and from rewriting part buffer
  // n & 1 (step 1 of panel n + 2) before its copies have landed. Every CTA's receive mbarriers are armed (expecting the G
  // partials' bytes) before any CTA pushes: one cluster barrier after
  // their initialization, and each re-armed before the arrival of the
  // panel that read it.
  if (tid == 0) {
    for (int k = 0; k < 2; ++k) {
      mbar_init(&rbar[k], 1);
      mbar_expect_tx(&rbar[k], rbytes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_arrive();
  cluster_wait();
  int it = 0, j = 0, q0 = 0;  // panel n's item, its panel of the item, ring
  if (nloc > 0) {
    step1(0, 0, 0);
    __syncthreads();
    push(0);
  }
  for (int n = 0; it < nloc; ++n, q0 += ncb) {
    int b, p0, np;
    item(it, &b, &p0, &np);
    const int it1 = j + 1 < np ? it : it + 1;  // panel n + 1's item
    const int j1 = j + 1 < np ? j + 1 : 0;
    const bool more = it1 < nloc;
    STAMP(n, 0);
    if (n > 0) cluster_wait();  // phase n - 1: buffers (n + 1) & 1 free
    if (more) {
      if (j1 == 0) {  // the next item's x and d have landed
        cp_async_wait_all();
        __syncthreads();
      }
      step1(n + 1, it1, q0 + ncb);
    }
    STAMP(n, 1);
    mbar_wait(&rbar[n & 1], (uint32_t)(n >> 1) & 1u);
    STAMP(n, 2);

    // 2. t = round(s * sum of the G partials), added in cluster-rank
    //    order from the receive buffer; zero past R
    const float* recv = recv0 + (size_t)(n & 1) * G * C * W;
    const float* ss = sbuf + (size_t)(q0 % slots / ncb) * W;
    const int wv = min(W, R - (p0 + j) * W);  // columns inside R
    for (int j4 = 4 * tid; j4 < C * W; j4 += 4 * kThreads) {
      float4 acc = *reinterpret_cast<const float4*>(recv + j4);
      for (int r = 1; r < G; ++r) {
        const float4 v =
            *reinterpret_cast<const float4*>(recv + (size_t)r * C * W + j4);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      const int c = j4 / W, col = j4 - c * W;
      const float e[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        store_t(ts + c * L.h.tpitch + col + k,
                col + k < wv ? e[k] * ss[col + k] : 0.f);
    }
    __syncthreads();
    if (tid == 0) mbar_expect_tx(&rbar[n & 1], rbytes);  // for panel n + 2
    cluster_arrive_relaxed();
    STAMP(n, 3);

    // 3. its rows' y[c][p] += sum_k U[p][k] t[c][k]
    if constexpr (kTensorCores)
      panel_rows_mma<C>(L.h, us, slots, q0, ts, ys, j == 0);
    else
      panel_rows_fma<C>(L.h, us + (size_t)(q0 % slots) * L.h.slot, ts, ys,
                        j == 0);
    __syncthreads();  // panel n's slots are free
    STAMP(n, 4);
    if (tid == 0) issue_ring(q0 + ncb + slots);
    if (more) push(n + 1);
    STAMP(n, 5);

    if (j == np - 1) {
      // the item's end: y, directly (one group a block) or through the
      // block's slab and ticket
      const unsigned char* vb = smem + L.vbuf + (it & 1) * L.vstride;
      const float* xs = reinterpret_cast<const float*>(vb);
      const float* ds = reinterpret_cast<const float*>(vb + L.vd);
      float* yb = y + (size_t)b * C * P + row0;
      if (ngrp == 1) {
        for (int e = tid; e < C * w; e += kThreads) {
          const int c = e / w, r = e - c * w;
          yb[(size_t)c * P + r] =
              ys[c * rows16 + r] + ds[r] * xs[c * rows16 + r];
        }
      } else {
        const size_t slab = (size_t)C * P;
        const int pg = p0 / ppi;
        float* mine = parts + ((size_t)b * ngrp + pg) * slab + row0;
        for (int e = tid; e < C * w; e += kThreads) {
          const int c = e / w, r = e - c * w;
          __stcg(mine + (size_t)c * P + r, ys[c * rows16 + r]);
        }
        __syncthreads();
        if (tid == 0) {
          __threadfence();  // this CTA's sums before its ticket
          unsigned int* ticket = tickets + (size_t)b * G + g;
          const bool last = atomicAdd(ticket, 1u) == (unsigned int)ngrp - 1;
          if (last) {
            atomicExch(ticket, 0u);
            __threadfence();  // every group's sums after the ticket
          }
          *flag = last;
        }
        __syncthreads();
        if (*flag) {
          const float* base = parts + (size_t)b * ngrp * slab + row0;
          for (int e = tid; e < C * w; e += kThreads) {
            const int c = e / w, r = e - c * w;
            const float* p = base + (size_t)c * P + r;
            float acc = __ldcg(p);
#pragma unroll 1
            for (int k0 = 1; k0 < ngrp; k0 += 8) {
              float pv[8];
#pragma unroll
              for (int k = 0; k < 8; ++k)
                if (k0 + k < ngrp) pv[k] = __ldcg(p + (k0 + k) * slab);
#pragma unroll
              for (int k = 0; k < 8; ++k)
                if (k0 + k < ngrp) acc += pv[k];
            }
            yb[(size_t)c * P + r] = acc + ds[r] * xs[c * rows16 + r];
          }
        }
      }
      __syncthreads();  // x/d buffer it & 1, y and the flag are free
      if (it + 2 < nloc) issue_vec(it + 2);
      STAMP(n, 6);
    }
    it = it1;
    j = j1;
  }
  // the last phase: every copy from this CTA has landed
  if (nloc > 0) cluster_wait();
}

template <typename TU, int C>
cudaError_t prepare_group(int G, size_t smem) {
  static Grant grant;
  return allow(grant, reinterpret_cast<const void*>(group_matvec_kernel<TU, C>),
               smem, G > 8);
}

template <typename TU, int C>
cudaError_t launch_group(const void* u, const void* s, const void* d,
                         const void* x, void* y, void* parts, void* tickets,
                         int B, int P, int R, int G, int W, int slots, int ppi,
                         int nclusters, size_t smem, cudaStream_t stream) {
  cudaError_t err = prepare_group<TU, C>(G, smem);
  if (err != cudaSuccess) return err;
  const GroupLayout L = group_layout(P, C, G, W, (int)sizeof(TU), slots);
  CUtensorMap umap = {};
  err = encode_map(&umap, u, sizeof(TU) == 2, B, P, R, L.cbw, L.box_rows,
                   sizeof(TU) == 2);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(nclusters, G, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, group_matvec_kernel<TU, C>, umap,
                           static_cast<const float*>(s),
                           static_cast<const float*>(d),
                           static_cast<const float*>(x),
                           static_cast<float*>(y), static_cast<float*>(parts),
                           static_cast<unsigned int*>(tickets), B, P, R, W,
                           slots, ppi);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename TU, int C>
cudaError_t groups_placeable(int G, size_t smem, int* count) {
  cudaError_t err = prepare_group<TU, C>(G, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(1, G, smem, 0, &attr);
  return cudaOccupancyMaxActiveClusters(count, group_matvec_kernel<TU, C>,
                                        &cfg);
}

// the group route's shape rules; smem must be what group_layout gives
bool group_shape_ok(int P, int R, int C, int G, int W, int itemsize,
                    int slots, size_t smem) {
  const int vec = 16 / itemsize;
  const int unit = itemsize == 2 ? 64 : 32;
  const int wmax = itemsize == 2 ? kGroupPanelBf16 : kGroupPanelF32;
  // W: a power of two times the unit (the steps' lane and warp splits)
  const bool w_ok = W >= unit && W <= wmax && W % unit == 0 &&
                    ((W / unit) & (W / unit - 1)) == 0;
  if (!(G >= 1 && G <= kMaxCluster && (G & (G - 1)) == 0 && cohorts_ok(C) &&
        P >= 1 && R >= vec && R % vec == 0 && w_ok && slots >= 1 &&
        slots <= kMaxSlots))
    return false;
  // two panels resident: step 1 of the next beside step 2 of this one
  const GroupLayout L = group_layout(P, C, G, W, itemsize, slots);
  return slots >= 2 * L.h.ncb && smem == L.total;
}

// the group launch (count null) or its placement query (clusters the
// current device holds at once, into *count)
template <typename TU>
cudaError_t dispatch_group(const void* u, const void* s, const void* d,
                           const void* x, void* y, void* parts,
                           void* tickets, int B, int P, int R, int C, int G,
                           int W, int slots, int ppi, int nclusters,
                           size_t smem, cudaStream_t stream, int* count) {
#define VILMA_GROUP_CASE(CC)                                                 \
  case CC:                                                                   \
    return count != nullptr                                                  \
               ? groups_placeable<TU, CC>(G, smem, count)                    \
               : launch_group<TU, CC>(u, s, d, x, y, parts, tickets, B, P, R, \
                                      G, W, slots, ppi, nclusters, smem,      \
                                      stream);
  switch (C) {
    VILMA_GROUP_CASE(1)
    VILMA_GROUP_CASE(2)
    VILMA_GROUP_CASE(3)
    VILMA_GROUP_CASE(4)
    VILMA_GROUP_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef VILMA_GROUP_CASE
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
// d [B, P], x and y [B, C, P] f32; G CTAs per cluster (rows), panels of W
// columns, `slots` ring slots per CTA, ppi panels a work item (ngrp =
// ceil(ceil(R / W) / ppi) items a block), smem bytes of dynamic shared
// memory per CTA, nclusters persistent clusters (at most what
// vilma_block_matvec_group_fit reports, at most B * ngrp). With ngrp > 1:
// parts holds B * ngrp * C * P floats of workspace and tickets B * G
// zeros (left zero by the launch). Returns the launch's cudaError_t.
extern "C" int vilma_block_matvec_group(const void* u, const void* s,
                                        const void* d, const void* x, void* y,
                                        void* parts, void* tickets, int B,
                                        int P, int R, int C, int u_bf16, int G,
                                        int W, int slots, int ppi,
                                        int nclusters, int smem,
                                        void* stream) {
  const int npanel = W > 0 ? (R + W - 1) / W : 0;
  if (!group_shape_ok(P, R, C, G, W, u_bf16 ? 2 : 4, slots, (size_t)smem) ||
      nclusters < 1 || ppi < 1 ||
      (ppi < npanel && (parts == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      u_bf16 ? dispatch_group<__nv_bfloat16>(u, s, d, x, y, parts, tickets, B,
                                             P, R, C, G, W, slots, ppi,
                                             nclusters, smem, st, nullptr)
             : dispatch_group<float>(u, s, d, x, y, parts, tickets, B, P, R, C,
                                     G, W, slots, ppi, nclusters, smem, st,
                                     nullptr);
  return (int)err;
}

// How many clusters of the group route's configuration the current
// device holds at once (0: it cannot place one), into *count.
extern "C" int vilma_block_matvec_group_fit(int P, int R, int C, int u_bf16,
                                            int G, int W, int slots, int smem,
                                            int* count) {
  *count = 0;
  if (!group_shape_ok(P, R, C, G, W, u_bf16 ? 2 : 4, slots, (size_t)smem))
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      u_bf16 ? dispatch_group<__nv_bfloat16>(nullptr, nullptr, nullptr,
                                             nullptr, nullptr, nullptr,
                                             nullptr, 0, P, R, C, G, W, slots,
                                             1, 0, smem, 0, count)
             : dispatch_group<float>(nullptr, nullptr, nullptr, nullptr,
                                     nullptr, nullptr, nullptr, 0, P, R, C, G,
                                     W, slots, 1, 0, smem, 0, count);
  return (int)err;
}

#ifdef VILMA_MATVEC_STAMPS
// The measurement build: where the group route's CTA 0 writes its stamps
// (cap blocks' worth of kStampPoints x {globaltimer ns, clock64} u64s; a
// null buf stops them), and the stamp points' names, comma-separated.
extern "C" int vilma_block_matvec_stamps(void* buf, int cap) {
  unsigned long long* p = static_cast<unsigned long long*>(buf);
  const int n = buf == nullptr ? 0 : cap;
  cudaError_t err = cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_stamp_cap, &n, sizeof(n));
  return (int)err;
}

extern "C" const char* vilma_block_matvec_stamp_points() {
  return kStampNames;
}
#endif

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
