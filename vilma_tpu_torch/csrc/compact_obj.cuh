// Shared body of the fused compact-objective kernels (compact_obj.cu,
// compact_obj_epochs.cu) for Hopper (sm_90a).
//
// Per SNP i and mixture component k, with the closed-form
// (prec_k + diag(dterm_i))^-1 algebra for P in {1, 2, 3}:
//
//     z_k   = 0.5 (quad_k - logdet_k) + scores[a_i, k]
//     vd_k  = max(softmax_k(z), eps),  log_vd_k = max(z_k - m - log s, log eps)
//     prologue:   post_means, post_vars [P, I] and the beta-KL scalar
//     delta_sums: S[k, a] = sum_{i: a_i = a} vd_k(i)
//
// The forms differ only in where the component's mean y_k and quad_k come
// from:
//   kShared  the shared [P, I] natural mean n: y_k = sigma_k n
//   kKdim    the per-component [K, P, I] natural mean of --learn-scaling
//            fits: y_k = sigma_k n_k
//   kEpochs  the epoch-history state: y_k = sigma_k^cur u +
//            sum_e c_e sigma_k^(e) v_e, quad_k = y_k (prec_k + dterm) y_k
//
// Pad SNPs (a_i == A) stay out of the KL and the sums
// (vilma_tpu/ops/pallas/compact_obj.py:353, 640); their selected scores
// read column A-1.
//
// Design: one thread per SNP (the prologues: one or two), templated on P,
// with a runtime loop over K, so any K runs (no VMEM tile ceiling). The
// coefficient table and the scores are staged through shared memory in
// component tiles (once per CTA when all of K fits).
//
// Prologues, all three forms: one pass over K with online softmax
// accumulators (struct Online) in base 2, rescaled when a logit passes the
// running reference by kRescale2 and folded into totals every kFold
// components (prologue(), below). What bounds them is issue slots: a few
// dozen instructions a (SNP, component) pair, three of them SFU ops, and
// no byte a pair from device memory (the shared form). So the body is
// written for the fewest instructions a pair:
//   * one KL accumulator. The KL term of a component is
//     log vd_k - log hd_k + 0.5 (quadform + ldp + logdet + matches) with
//     log vd_k = z_k - m - log s0, z_k = 0.5 (quad - logdet) + sel, and
//     log hd_k = sel + 0.5 ldp; the scores, ldp and logdet cancel, so it is
//     h_k - m - log s0 with h = 0.5 (quad + quadform + matches). With
//     M = prec + diag(dt) and quad = y' M y (every form's quad is that),
//     quadform = quad - sum_p dt_p y_p^2 and matches = tr(prec M^-1) =
//     P - sum_p dt_p diag_p, so h = quad + P/2 - sum_p dt_p (diag_p +
//     y_p^2) / 2: the last sum is the second-moment sum ssec the moments
//     need anyway, and dt is the SNP's, so it is taken once per SNP. Per
//     pair only sum_k w_k quad_k is left, and the shared form reads even
//     that off its mean sum: sum_k w_k y_k . n = n . sy. Neither quadform
//     nor matches is formed;
//   * logits in base 2: z2 = log2(e) z from the SFU's lg2 of the
//     determinant, the staged scores already scaled by log2(e), and the
//     weights from the SFU's ex2: no multiply around either. The reference
//     m2 is kept in base 2 and turned into nats once per SNP;
//   * the adjugate: y = adj(M) n / det M, diag M^-1 = diag adj(M) / det M,
//     and the products of prec's off-diagonal entries that det M and
//     adj(M) need staged once a tile beside the component's precision;
//     the weights are applied through w / det M, so y enters the sums
//     once;
//   * two SNPs a thread (S = 2) where I gives every resident CTA a tile of
//     2 x 256 SNPs: each component's staged row and its loop step serve
//     two pairs, and the two independent chains hide the SFU and
//     shared-memory latencies; four components' scores of a SNP come in
//     one 16-byte load (the staged scores are annotation-major). An epoch
//     state with live epochs keeps one SNP a thread: its per-epoch solves
//     take the registers a second SNP needs (on the card, two were 5-21%
//     slower there, at 1 to 12 live epochs).
// The SFU ops are the ones the body always used (rcp, lg2, ex2 approx),
// in their flush-to-zero form, which drops the range handling the plain
// forms issue around them: an operand or result below 2^-126 flushes.
// No determinant comes near that (det M >= prod_p dt_p), and a weight
// below 2^-126 of a sum s0 >= 1 is far inside the clamp argument below.
// Every per-SNP operation (the reciprocal of s0, its log, the rescale's
// exponential) stays IEEE or as accurate as before.
// They drop the clamp, which changes no result the band can see, whatever
// the form: a component the clamp touches has vd_k < eps = 1e-30 (f32),
// and there the clamped form adds eps (resp. eps log eps) where the
// unclamped one adds vd_k (resp. vd_k log vd_k), so each sum moves by at
// most K eps max|f_k| (the term f_k: y_k, diag_k + y_k^2, or the KL term,
// with |x log x| <= eps |log eps| below eps). The forms differ only in y_k
// and quad_k, so the bound holds for each; at K <= a few thousand it is
// ~1e-25 of quantities of order 1e-8 and up: far below half an ulp of any
// sum.
//
// Sums, all three forms: they add vd_k(i) across SNPs and each term needs
// its SNP's final normalizer, so they make two passes over K per thread:
// pass 1 an online max and normalizer, pass 2 the clamped weights; no
// [K]-sized per-thread state. Both passes derive z_k alone (z_form,
// z_epochs: no diagonal, matches or quadform; SFU reciprocals, logarithm
// and exponential; kKdim reads nat[k, p, i] once a pass). Once per SNP
// tile the CTA sorts its 256 SNPs by annotation (stable counting sort),
// then stages the weights of kChunk components at their sorted places; one
// thread per (component, annotation) adds its contiguous segment into the
// CTA's [Kg, A] partial in shared memory, which goes to device memory
// once. Kg = K where the partial fits beside the component tile (K = 582
// with A up to ~90); else K is taken in groups of Kg components, the CTA
// walking its SNP tiles once per group, and pass 1 (in the first group)
// leaves each SNP's max and 1/normalizer in a [2, I] workspace for the
// later groups. So any K·A runs whose single component row fits.
//
// K-split forms (--mesh comp=M: each shard holds a slice of the K
// components; the softmax over K is reduced across shards):
//   prologue partial  the one-pass body over the slice, writing each SNP's
//                     online-softmax accumulators unnormalized, against the
//                     slice's own reference m (in nats): acc[acc_rows(P)][I]
//                     = m, s0, q = sum_k w_k (h_k - m), sy[P], ssec[P]
//                     (SPLIT = kPartial);
//   merge             merge_kernel: the M partials of one SNP column, each
//                     rescaled by exp(m_j - max_j m_j), finished as the
//                     whole-K prologue finishes (pm, pv), and the KL
//                     scalar, in one launch (see merge_kernel);
//   sums pass 1       the online max and normalizer over the slice alone,
//                     written as (m, s) into a [2, I] array (kPartial);
//   sums pass 2       the whole-K sums body over the slice (kGiven), given
//                     the M pass-1 partials [M][2][I] of the SNP column:
//                     each thread merges its SNP's global normalizer (max_j
//                     m_j, 1 / sum_j s_j e^(m_j - max)) in registers before
//                     its K loop (merged_norm), so no merged [2, I] array
//                     is written or read.
// The dropped clamp stays valid under the split: each slice accumulates
// against its own reference and the merge only rescales, so every weight
// is the unclamped one, and the KL subtracts log S once per SNP, in the
// merge.
//
// The TPU accumulates the KL and the sums across its sequential grid; here
// each CTA writes a partial in fixed order and the partials are added in
// fixed order (by a second kernel, or by the merge's last CTA). No float
// atomics touch device memory, so every result repeats bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace vilma {

enum Form { kShared = 0, kKdim = 1, kEpochs = 2 };

// whole K, the K-split partial over a slice, or (sums) pass 2 with the
// global normalizer given
enum Split { kWhole = 0, kPartial = 1, kGiven = 2 };

// rows of a prologue partial per SNP: m, s0, q, sy[P], ssec[P]
__host__ __device__ inline int acc_rows(int P) { return 3 + 2 * P; }

// The per-SNP operands of a form (pointers into device memory).
struct Operands {
  const float* dterm;       // [P, I]: dterm, or (kEpochs) raw scaled_ld_diags
  const float* nat;         // [P, I]; kKdim [K, P, I]; kEpochs accumulator u
  const float* hist;        // kEpochs: [B, P, I] epoch vectors
  const float* inv_scales;  // kEpochs: [B+1, P], row 0 the current scaling
  const float* hist_c;      // kEpochs: [B] coefficients
  int I;
  int nlive;                // kEpochs: epochs read (<= B)
};

// floats of small tables a form stages in shared memory: kEpochs keeps
// the inverse scalings [nlive + 1][P], then the coefficients [nlive]
__host__ __device__ inline int table_floats(int form, int P, int nlive) {
  return form == kEpochs ? (nlive + 1) * P + nlive : 0;
}

// each translation unit keeps its own copy of these kernels
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <int P>
__host__ __device__ constexpr int ncol() {
  return P * (P + 1) / 2 + 1;
}

// the reciprocal of a determinant: IEEE, or from the SFU (kFast)
template <bool kFast>
__device__ __forceinline__ float rcp(float x) {
  return kFast ? __fdividef(1.0f, x) : 1.0f / x;
}

// y = (prec + diag(dt))^-1 n for one (SNP, component); returns
// det(prec + diag(dt)). c is the component's coefficient row (precision
// upper triangle, then logdet).
template <int P, bool kFast = false>
__device__ __forceinline__ float solve(const float* c, const float* dt,
                                       const float* n, float* y) {
  if constexpr (P == 1) {
    const float a = c[0] + dt[0];
    y[0] = n[0] * rcp<kFast>(a);
    return a;
  } else if constexpr (P == 2) {
    const float a = c[0] + dt[0];
    const float b = c[1];
    const float d = c[2] + dt[1];
    const float det = a * d - b * b;
    const float inv = rcp<kFast>(det);
    y[0] = (d * n[0] - b * n[1]) * inv;
    y[1] = (a * n[1] - b * n[0]) * inv;
    return det;
  } else {
    const float pa = c[0] + dt[0];
    const float pb = c[1], pc = c[2];
    const float pd = c[3] + dt[1];
    const float pe = c[4];
    const float pf = c[5] + dt[2];
    const float A3 = pd * pf - pe * pe;
    const float B3 = pc * pe - pb * pf;
    const float C3 = pb * pe - pc * pd;
    const float D3 = pa * pf - pc * pc;
    const float E3 = pb * pc - pa * pe;
    const float F3 = pa * pd - pb * pb;
    const float det = pa * A3 + pb * B3 + pc * C3;
    const float inv = rcp<kFast>(det);
    y[0] = (A3 * n[0] + B3 * n[1] + C3 * n[2]) * inv;
    y[1] = (B3 * n[0] + D3 * n[1] + E3 * n[2]) * inv;
    y[2] = (C3 * n[0] + E3 * n[1] + F3 * n[2]) * inv;
    return det;
  }
}

// entry (p, q) of prec + diag(dt): c holds the upper triangle row-major
template <int P>
__device__ __forceinline__ float prec_entry(const float* c, const float* dt,
                                            int p, int q) {
  const int lo = p < q ? p : q, hi = p < q ? q : p;
  const float v = c[lo * P - lo * (lo - 1) / 2 + (hi - lo)];
  return p == q ? v + dt[p] : v;
}

// quad = nat . y with nat = (prec + diag(dt)) y
template <int P>
__device__ __forceinline__ float quad_of_mean(const float* c, const float* dt,
                                              const float* y) {
  float quad = 0.f;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    float nat = prec_entry<P>(c, dt, p, 0) * y[0];
#pragma unroll
    for (int q = 1; q < P; ++q) nat += prec_entry<P>(c, dt, p, q) * y[q];
    quad = p == 0 ? nat * y[0] : quad + nat * y[p];
  }
  return quad;
}

// per-thread registers of one SNP: the diagonal term (kEpochs: the raw
// scaled LD diagonal) and the natural mean (kEpochs: the accumulator)
template <int P>
struct Snp {
  float dt[P], n[P];
  int i;
  bool live;
};

template <int P, int FORM>
__device__ __forceinline__ void load_snp(const Operands& op, Snp<P>& s,
                                         int i, bool live) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    // dead lanes carry an inert pad slot (diagonal 1, zero natural mean)
    s.dt[p] = live ? op.dterm[(size_t)p * op.I + i] : 1.0f;
    s.n[p] = (live && FORM != kKdim) ? op.nat[(size_t)p * op.I + i] : 0.0f;
  }
  s.i = i;
  s.live = live;
}

// the natural mean of component k (kShared: the SNP's own; kKdim: lane i
// reads nat[k, p, i], so a warp's loads are contiguous)
template <int P, int FORM>
__device__ __forceinline__ void nat_of(const Operands& op, const Snp<P>& s,
                                       int k, float* n) {
#pragma unroll
  for (int p = 0; p < P; ++p)
    n[p] = FORM != kKdim ? s.n[p]
           : s.live    ? op.nat[((size_t)k * P + p) * op.I + s.i]
                       : 0.0f;
}

// Registers of one epoch-state SNP: the current scaled diagonal and, with
// NL >= 0 live epochs held in registers, each epoch's scaled diagonal,
// vector and coefficient. With NL < 0 the live count is read at run time
// and the epochs come through L1 per component.
template <int P, int NL>
struct EpochRegs {
  static constexpr int N = NL > 0 ? NL : 1;
  float dc[P];
  float dte[N][P], v[N][P], ce[N];
};

template <int P, int NL>
__device__ __forceinline__ void load_epochs(const Operands& op,
                                            const Snp<P>& s, const float* tab,
                                            EpochRegs<P, NL>& r) {
#pragma unroll
  for (int p = 0; p < P; ++p) r.dc[p] = s.dt[p] * tab[p];
  if constexpr (NL > 0) {
    const float* coef = tab + (NL + 1) * P;  // op.nlive == NL
#pragma unroll
    for (int e = 0; e < NL; ++e) {
      r.ce[e] = coef[e];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        r.dte[e][p] = s.dt[p] * tab[(e + 1) * P + p];
        r.v[e][p] = s.live ? op.hist[((size_t)e * P + p) * op.I + s.i] : 0.0f;
      }
    }
  }
}

// y += sum_e c_e (prec + diag(dte_e))^-1 v_e over the live epochs, from
// the registers r (NL >= 0) or through L1 (NL < 0); kFast: SFU reciprocals
template <int P, int NL, bool kFast>
__device__ __forceinline__ void add_epochs(const Operands& op,
                                           const Snp<P>& s,
                                           const EpochRegs<P, NL>& r,
                                           const float* tab, const float* c,
                                           float* y) {
  if constexpr (NL >= 0) {
#pragma unroll
    for (int e = 0; e < NL; ++e) {
      float ye[P];
      solve<P, kFast>(c, r.dte[e], r.v[e], ye);
#pragma unroll
      for (int p = 0; p < P; ++p) y[p] = y[p] + r.ce[e] * ye[p];
    }
  } else {
    const float* coef = tab + (op.nlive + 1) * P;
    for (int e = 0; e < op.nlive; ++e) {
      float dte[P], v[P], ye[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        dte[p] = s.dt[p] * tab[(e + 1) * P + p];
        v[p] = s.live ? op.hist[((size_t)e * P + p) * op.I + s.i] : 0.0f;
      }
      solve<P, kFast>(c, dte, v, ye);
      const float ce = coef[e];
#pragma unroll
      for (int p = 0; p < P; ++p) y[p] = y[p] + ce * ye[p];
    }
  }
}

// the logit z_k of an epoch-state SNP alone, for the sums: the
// current-scaling solve and the log-determinant from one determinant, the
// epoch solves, quad = y (prec + diag(dc)) y; every reciprocal, the
// logarithm and (in the caller) the exponential from the SFU
template <int P, int NL>
__device__ __forceinline__ float z_epochs(const Operands& op,
                                          const Snp<P>& s,
                                          const EpochRegs<P, NL>& r,
                                          const float* tab, const float* c,
                                          float sel) {
  float y[P];
  const float det = solve<P, true>(c, r.dc, s.n, y);
  add_epochs<P, NL, true>(op, s, r, tab, c, y);
  return 0.5f * (quad_of_mean<P>(c, r.dc, y) - __logf(det)) + sel;
}

// the logit z_k of a [P, I] or kdim SNP alone, for the sums: y = sigma_k n_k
// and the log-determinant from one determinant and one SFU reciprocal,
// quad = y . n; no diagonal, matches or quadform. kKdim reads nat[k, p, i]
// once.
template <int P, int FORM>
__device__ __forceinline__ float z_form(const Operands& op, const Snp<P>& s,
                                        const float* c, int k, float sel) {
  float n[P], y[P];
  nat_of<P, FORM>(op, s, k, n);
  const float det = solve<P, true>(c, s.dt, n, y);
  float quad = y[0] * n[0];
#pragma unroll
  for (int p = 1; p < P; ++p) quad += y[p] * n[p];
  return 0.5f * (quad - __logf(det)) + sel;
}

// The global normalizer of SNP i from the M sums pass-1 partials
// parts[M][2][I] = (m_j, s_j) of its column, in comp order: m = max_j m_j,
// inv_s = 1 / sum_j s_j exp(m_j - m), fixed order over j.
__device__ __forceinline__ void merged_norm(const float* __restrict__ parts,
                                            int M, int I, int i, float& m,
                                            float& inv_s) {
  float mx = -INFINITY;
  for (int j = 0; j < M; ++j) mx = fmaxf(mx, parts[2 * (size_t)j * I + i]);
  float s = 0.f;
  for (int j = 0; j < M; ++j)
    s += parts[(2 * (size_t)j + 1) * I + i] *
         expf(parts[2 * (size_t)j * I + i] - mx);
  m = mx;
  inv_s = 1.0f / s;
}

// the sums stage the weights of kChunk components per SNP tile, one row of
// kWStride floats each (the odd stride spreads a warp's rows over the banks)
constexpr int kChunk = 16;
constexpr int kWStride = kThreads + 1;

// floats of the sums' shared memory past the [kt] component tiles:
//   pass 1 alone (sums = false)  kWarps (unused)
//   pass 2 (sums = true)  the CTA's partial of one component group [kg][A],
//             the staged weights [kChunk][kWStride], the per-warp
//             annotation counts [A + 1][kWarps] and segment starts [A + 2]
//             (ints)
// then the form's table (table_floats). ops/cuda/compact_obj.py
// (_launch_shape) sizes the tiles and groups by the same count.
__host__ __device__ inline int extra_floats(bool sums, int kg, int A) {
  if (!sums) return kWarps;
  return kg * A + kChunk * kWStride + (A + 1) * kWarps + A + 2;
}

// ---------------------------------------------------------------------------
// The one-pass prologue (see the note at the top)
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.44269504088896341f;
constexpr float kLn2 = 0.693147180559945309f;

// a logit must pass the running reference m2 by this many bits (~8.3
// nats) to move it
constexpr float kRescale2 = 12.0f;

// the one-pass prologue folds its run sums into its totals every kFold
// components: one f32 run over all of K drifts by ~sqrt(K) ulps (1.2e-5
// of the posterior means at K = 42,999), runs of kFold by ~sqrt(kFold) +
// sqrt(K / kFold)
constexpr int kFold = 128;

// the SFU's approximations, subnormals flushed (see the note at the top)
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// floats of a component's row as the prologue stages it: prec's upper
// triangle, then the products of its off-diagonal entries that det M and
// adj(M) take (P = 2: -p01^2; P = 3: -p12^2, -p02^2, -p01^2, p02 p12,
// p01 p12, p01 p02). The table's log-determinant column is not staged:
// the prologue does not read it.
__host__ __device__ constexpr int row_floats(int P) {
  return P == 1 ? 1 : P == 2 ? 4 : 12;
}

template <int P>
__device__ __forceinline__ void stage_row(const float* __restrict__ c,
                                          float* r) {
#pragma unroll
  for (int j = 0; j < P * (P + 1) / 2; ++j) r[j] = c[j];
  if constexpr (P == 2) {
    r[3] = -c[1] * c[1];
  } else if constexpr (P == 3) {
    r[6] = -c[4] * c[4];
    r[7] = -c[2] * c[2];
    r[8] = -c[1] * c[1];
    r[9] = c[2] * c[4];
    r[10] = c[1] * c[4];
    r[11] = c[1] * c[2];
  }
}

// a staged row from shared memory, in 16-byte loads
template <int P>
__device__ __forceinline__ void load_row(const float* s, float* r) {
  if constexpr (P == 1) {
    r[0] = s[0];
  } else {
#pragma unroll
    for (int j = 0; j < row_floats(P); j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(s + j);
      r[j] = v.x;
      r[j + 1] = v.y;
      r[j + 2] = v.z;
      r[j + 3] = v.w;
    }
  }
}

// components a step of the prologue's loop: a SNP's kStep scores come in
// one 16-byte load (on the card, steps of 2 were 4-5% slower)
constexpr int kStep = 4;
static_assert(kStep == 4, "load_scores reads four floats");

__device__ __forceinline__ void load_scores(const float* s, float* v) {
  const float4 x = *reinterpret_cast<const float4*>(s);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

// The staged scores' row stride (a row an annotation): an odd multiple of
// 4 floats, so four components' scores come in one 16-byte load and up to
// 8 annotations' rows fall on distinct bank quads.
__host__ __device__ inline int score_stride(int kt) {
  const int s = (kt + 3) / 4 * 4;
  return (s / 4) % 2 ? s : s + 4;
}

// floats of the prologue's shared memory: the staged rows [kt][row] (to a
// multiple of 4), the scores [A][score_stride(kt)], the warps' KL sums
// [kWarps], then the form's table (table_floats). ops/cuda/compact_obj.py
// (prologue_floats, _prologue_shape) sizes the tile by the same count.
__host__ __device__ inline int prologue_floats(int P, int kt, int A,
                                               int table) {
  return (kt * row_floats(P) + 3) / 4 * 4 + A * score_stride(kt) + kWarps +
         table;
}

// det M, t = adj(M) n and the diagonal of adj(M), M = prec + diag(dt), from
// a staged row r: y = t / det M, diag M^-1 = dn / det M
template <int P>
struct Adj {
  float det, t[P], dn[P];
};

template <int P>
__device__ __forceinline__ void adjugate(const float* r, const float* dt,
                                         const float* n, Adj<P>& o) {
  if constexpr (P == 1) {
    o.det = r[0] + dt[0];
    o.t[0] = n[0];
    o.dn[0] = 1.0f;
  } else if constexpr (P == 2) {
    const float a = r[0] + dt[0];
    const float b = r[1];
    const float d = r[2] + dt[1];
    o.det = fmaf(a, d, r[3]);
    o.t[0] = fmaf(d, n[0], -b * n[1]);
    o.t[1] = fmaf(a, n[1], -b * n[0]);
    o.dn[0] = d;
    o.dn[1] = a;
  } else {
    const float pa = r[0] + dt[0];
    const float pb = r[1], pc = r[2];
    const float pd = r[3] + dt[1];
    const float pe = r[4];
    const float pf = r[5] + dt[2];
    const float A3 = fmaf(pd, pf, r[6]);
    const float B3 = fmaf(-pb, pf, r[9]);
    const float C3 = fmaf(-pc, pd, r[10]);
    const float D3 = fmaf(pa, pf, r[7]);
    const float E3 = fmaf(-pa, pe, r[11]);
    const float F3 = fmaf(pa, pd, r[8]);
    o.det = fmaf(pa, A3, fmaf(pb, B3, pc * C3));
    o.t[0] = fmaf(A3, n[0], fmaf(B3, n[1], C3 * n[2]));
    o.t[1] = fmaf(B3, n[0], fmaf(D3, n[1], E3 * n[2]));
    o.t[2] = fmaf(C3, n[0], fmaf(E3, n[1], F3 * n[2]));
    o.dn[0] = A3;
    o.dn[1] = D3;
    o.dn[2] = F3;
  }
}

// One SNP of a prologue thread: its operands as loaded, the diagonal term
// of M (kEpochs: the current scaled diagonal), 0.5 log2(e) n (the shared
// form's logit takes y . nh) and its annotation's row of the staged scores
template <int P, int FORM, int NL>
struct Lane {
  Snp<P> s;
  EpochRegs<P, NL> er;
  float dt[P], nh[P];
  const float* sel;
};

template <int P, int FORM, int NL>
__device__ __forceinline__ void load_lane(const Operands& op,
                                          const int* __restrict__ ann,
                                          const float* tab,
                                          const float* score_s, int ktp,
                                          int A, int i, Lane<P, FORM, NL>& l) {
  const bool live = i < op.I;
  load_snp<P, FORM>(op, l.s, i, live);
  l.sel = score_s + (live ? min(ann[i], A - 1) : A - 1) * ktp;
  if constexpr (FORM == kEpochs) load_epochs<P, NL>(op, l.s, tab, l.er);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    l.dt[p] = FORM == kEpochs ? l.er.dc[p] : l.s.dt[p];
    l.nh[p] = (0.5f * kLog2e) * l.s.n[p];
  }
}

// Online softmax accumulators of one SNP over K, in base 2. With
// w_k = 2^(z2_k - m2), z2 = log2(e) z, under a running reference m2:
//   s0 = sum w_k,  sy = sum w_k y_k,  ssec = sum w_k (diag_k + y_k^2),
//   sq = sum w_k quad_k (kQuad; the shared form reads it off n . sy).
// The KL needs nothing more (kl_sum). add() adds to the current run's sums
// (r*); fold() adds the run into the totals (s*) and starts a new one,
// which the caller does every kFold components and last. m2 moves only
// when a logit passes it by more than kRescale2 (so w_k <= 2^kRescale2 and
// rescales are rare); a move multiplies every sum, run and total, by
// 2^(m2_old - m2_new).
template <int P, bool kQuad>
struct Online {
  float m2, s0, sy[P], ssec[P], sq;
  float r0, ry[P], rsec[P], rq;

  __device__ __forceinline__ Online()
      : m2(-INFINITY), s0(0.f), sq(0.f), r0(0.f), rq(0.f) {
#pragma unroll
    for (int p = 0; p < P; ++p) sy[p] = ssec[p] = ry[p] = rsec[p] = 0.f;
  }

  __device__ __forceinline__ void rescale(float z2) {
    const float alpha = exp2f(m2 - z2);  // 0 at the first component
    s0 *= alpha;
    r0 *= alpha;
    if (kQuad) {
      sq *= alpha;
      rq *= alpha;
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      sy[p] *= alpha;
      ssec[p] *= alpha;
      ry[p] *= alpha;
      rsec[p] *= alpha;
    }
    m2 = z2;
  }

  // a component of weight w whose mean is y = o.t / det (u = w / det):
  // w y = u t, w (diag + y^2) = u (dn + t y)
  __device__ __forceinline__ void add_adj(float w, float u, const Adj<P>& o,
                                          const float* y, float quad) {
    r0 += w;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      ry[p] = fmaf(u, o.t[p], ry[p]);
      rsec[p] = fmaf(u, fmaf(o.t[p], y[p], o.dn[p]), rsec[p]);
    }
    if (kQuad) rq = fmaf(w, quad, rq);
  }

  // any mean y (the epoch form with live epochs), inv = 1 / det
  __device__ __forceinline__ void add(float w, float inv, const Adj<P>& o,
                                      const float* y, float quad) {
    r0 += w;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      ry[p] = fmaf(w, y[p], ry[p]);
      rsec[p] = fmaf(w, fmaf(y[p], y[p], inv * o.dn[p]), rsec[p]);
    }
    if (kQuad) rq = fmaf(w, quad, rq);
  }

  __device__ __forceinline__ void fold() {
    s0 += r0;
    r0 = 0.f;
    if (kQuad) {
      sq += rq;
      rq = 0.f;
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      sy[p] += ry[p];
      ssec[p] += rsec[p];
      ry[p] = rsec[p] = 0.f;
    }
  }
};

// A SNP's reference in nats, m, and q = sum_k w_k (h_k - m) (the note at
// the top): sum_k w_k quad_k - sum_p dt_p ssec_p / 2 + (P/2 - m) s0
template <int P, int FORM, int NL, bool kQuad>
__device__ __forceinline__ float kl_sum(const Lane<P, FORM, NL>& l,
                                        const Online<P, kQuad>& acc,
                                        float& m) {
  m = acc.m2 * kLn2;
  float h = acc.sq;
  if constexpr (!kQuad) {
    h = l.s.n[0] * acc.sy[0];
#pragma unroll
    for (int p = 1; p < P; ++p) h = fmaf(l.s.n[p], acc.sy[p], h);
  }
#pragma unroll
  for (int p = 0; p < P; ++p) h = fmaf(-0.5f * l.dt[p], acc.ssec[p], h);
  return fmaf(0.5f * P - m, acc.s0, h);
}

// Component k (the staged row rs) of each of a thread's S SNPs, sel2 their
// base-2 scores: the logits, a rescale where one moves its reference, the
// weights, the sums
template <int P, int FORM, int NL, int S, bool kQuad>
__device__ __forceinline__ void prologue_step(const Operands& op,
                                              const Lane<P, FORM, NL>* ln,
                                              Online<P, kQuad>* acc,
                                              const float* rs,
                                              const float* tab,
                                              const float* sel2, int k) {
  // y = adj(M) n / det M, the form whose sums take u = w / det M
  constexpr bool kAdj = FORM != kEpochs || NL == 0;
  float r[row_floats(P)];
  load_row<P>(rs, r);
  Adj<P> o[S];
  float inv[S], y[S][P], z2[S], quad[S], dz[S];
  bool move = false;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    float n[P];
    nat_of<P, FORM>(op, ln[j].s, k, n);
    adjugate<P>(r, ln[j].dt, n, o[j]);
    inv[j] = rcp_approx(o[j].det);
    const float lgs = fmaf(lg2_approx(o[j].det), -0.5f, sel2[j]);
#pragma unroll
    for (int p = 0; p < P; ++p) y[j][p] = o[j].t[p] * inv[j];
    if constexpr (FORM == kShared) {
      float zz = lgs;
#pragma unroll
      for (int p = P - 1; p >= 0; --p) zz = fmaf(y[j][p], ln[j].nh[p], zz);
      z2[j] = zz;
      quad[j] = 0.f;
    } else {
      if constexpr (FORM == kEpochs) {
        add_epochs<P, NL, false>(op, ln[j].s, ln[j].er, tab, r, y[j]);
        quad[j] = quad_of_mean<P>(r, ln[j].dt, y[j]);
      } else {
        quad[j] = y[j][0] * n[0];
#pragma unroll
        for (int p = 1; p < P; ++p) quad[j] = fmaf(y[j][p], n[p], quad[j]);
      }
      z2[j] = fmaf(quad[j], 0.5f * kLog2e, lgs);
    }
    dz[j] = z2[j] - acc[j].m2;
    move |= dz[j] > kRescale2;
  }
  if (move) {
#pragma unroll
    for (int j = 0; j < S; ++j)
      if (dz[j] > kRescale2) {
        acc[j].rescale(z2[j]);
        dz[j] = 0.f;
      }
  }
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const float w = ex2_approx(dz[j]);
    if constexpr (kAdj)
      acc[j].add_adj(w, w * inv[j], o[j], y[j], quad[j]);
    else
      acc[j].add(w, inv[j], o[j], y[j], quad[j]);
  }
}

// The prologue of form FORM: S SNPs a thread (lane j of thread tid takes
// SNP base + j kThreads + tid, so both lanes' loads coalesce), a
// grid-stride loop over tiles of S kThreads SNPs, one pass over K in
// component tiles of kt staged in smem (once per CTA when K fits); pm, pv
// and the CTA's KL partial in part[blockIdx], or (SPLIT = kPartial) each
// SNP's accumulators into pm_out as [acc_rows(P)][I].
template <int P, int FORM, int NL, int SPLIT, int S>
__device__ __forceinline__ void prologue(
    const Operands& op, const float* __restrict__ coeffs,
    const float* __restrict__ scores_t, const int* __restrict__ ann,
    float* __restrict__ pm_out, float* __restrict__ pv_out,
    float* __restrict__ part, float* smem, int I, int K, int A, int kt) {
  constexpr int NCOL = ncol<P>();
  constexpr int ROW = row_floats(P);
  constexpr bool kQuad = FORM != kShared;
  const int ktp = score_stride(kt);
  float* coef_s = smem;                               // [kt][ROW]
  float* score_s = coef_s + (kt * ROW + 3) / 4 * 4;   // [A][ktp], base 2
  float* warp_kl = score_s + A * ktp;                 // [kWarps]
  float* tab = warp_kl + kWarps;                      // table_floats
  const int tid = threadIdx.x;
  const int ntiles = (K + kt - 1) / kt;

  auto stage = [&](int t) {
    const int k0 = t * kt;
    const int cnt = min(kt, K - k0);
    for (int k = tid; k < cnt; k += kThreads)
      stage_row<P>(coeffs + (size_t)(k0 + k) * NCOL, coef_s + k * ROW);
    for (int j = tid; j < cnt * A; j += kThreads) {
      const int k = j / A;
      score_s[(j - k * A) * ktp + k] = scores_t[(size_t)k0 * A + j] * kLog2e;
    }
  };
  if (FORM == kEpochs) {
    for (int j = tid; j < (op.nlive + 1) * P; j += kThreads)
      tab[j] = op.inv_scales[j];
    for (int j = tid; j < op.nlive; j += kThreads)
      tab[(op.nlive + 1) * P + j] = op.hist_c[j];
  }
  if (ntiles == 1) stage(0);
  __syncthreads();

  float kl = 0.f;
  // every thread of a CTA runs the same number of iterations, so the
  // barriers below are uniform
  for (int base = blockIdx.x * kThreads * S; base < I;
       base += gridDim.x * kThreads * S) {
    Lane<P, FORM, NL> ln[S];
#pragma unroll
    for (int j = 0; j < S; ++j)
      load_lane<P, FORM, NL>(op, ann, tab, score_s, ktp, A,
                             base + j * kThreads + tid, ln[j]);
    Online<P, kQuad> acc[S];
    for (int t = 0; t < ntiles; ++t) {
      if (ntiles > 1) {
        __syncthreads();
        stage(t);
        __syncthreads();
      }
      const int cnt = min(kt, K - t * kt);
      for (int k0 = 0; k0 < cnt; k0 += kFold) {
        const int k1 = min(cnt, k0 + kFold);
        int c = k0;
        for (; c + kStep <= k1; c += kStep) {
          float v[S][kStep], sl[kStep][S];
#pragma unroll
          for (int j = 0; j < S; ++j) load_scores(ln[j].sel + c, v[j]);
#pragma unroll
          for (int u = 0; u < kStep; ++u) {
#pragma unroll
            for (int j = 0; j < S; ++j) sl[u][j] = v[j][u];
            prologue_step<P, FORM, NL, S>(op, ln, acc,
                                          coef_s + (c + u) * ROW, tab,
                                          sl[u], t * kt + c + u);
          }
        }
        for (; c < k1; ++c) {
          float sl[S];
#pragma unroll
          for (int j = 0; j < S; ++j) sl[j] = ln[j].sel[c];
          prologue_step<P, FORM, NL, S>(op, ln, acc, coef_s + c * ROW, tab,
                                        sl, t * kt + c);
        }
#pragma unroll
        for (int j = 0; j < S; ++j) acc[j].fold();
      }
    }
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int i = base + j * kThreads + tid;
      if (i >= I) continue;
      float m;
      const float q = kl_sum(ln[j], acc[j], m);
      if (SPLIT == kPartial) {
        pm_out[i] = m;
        pm_out[(size_t)I + i] = acc[j].s0;
        pm_out[2 * (size_t)I + i] = q;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          pm_out[(size_t)(3 + p) * I + i] = acc[j].sy[p];
          pm_out[(size_t)(3 + P + p) * I + i] = acc[j].ssec[p];
        }
      } else {
        const float inv = 1.0f / acc[j].s0;  // one reciprocal per SNP
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float pm = acc[j].sy[p] * inv;
          pm_out[(size_t)p * I + i] = pm;
          pv_out[(size_t)p * I + i] = acc[j].ssec[p] * inv - pm * pm;
        }
        if (ann[i] < A) kl += q * inv - logf(acc[j].s0);  // pads: id A
      }
    }
  }
  if (SPLIT == kPartial) return;
  const float v = warp_sum(kl);
  if ((tid & 31) == 0) warp_kl[tid >> 5] = v;
  __syncthreads();
  if (tid == 0) {
    float tot = 0.f;
    for (int w = 0; w < kWarps; ++w) tot += warp_kl[w];
    part[blockIdx.x] = tot;
  }
}

// The annotation sums of form FORM (see compact_kernel), one SNP a thread.
template <int P, int FORM, int NL, int SPLIT>
__device__ __forceinline__ void sums(
    const Operands& op, const float* __restrict__ coeffs,
    const float* __restrict__ scores_t, const int* __restrict__ ann,
    float* __restrict__ part, float* __restrict__ norm, float* smem, int I,
    int K, int A, int kt, int kg, float eps, int nparts) {
  constexpr int NCOL = ncol<P>();
  // the sorted per-CTA reduction (the sums' pass 2)
  constexpr bool kSorted = SPLIT != kPartial;
  float* coef_s = smem;                 // [kt][NCOL]
  float* score_s = coef_s + kt * NCOL;  // [kt][A]
  float* extra = score_s + kt * A;      // see extra_floats
  float* tab = extra + extra_floats(kSorted, kg, A);
  float* part_s = extra;                // sums: [kg][A]
  float* w_s = part_s + kg * A;         // sums: [kChunk][kWStride]
  int* cnt_s = reinterpret_cast<int*>(w_s + kChunk * kWStride);
  int* seg_s = cnt_s + (A + 1) * kWarps;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ntiles = (K + kt - 1) / kt;

  auto load_tile = [&](int t) {
    const int k0 = t * kt;
    const int cnt = min(kt, K - k0);
    for (int j = tid; j < cnt * NCOL; j += kThreads)
      coef_s[j] = coeffs[(size_t)k0 * NCOL + j];
    for (int j = tid; j < cnt * A; j += kThreads)
      score_s[j] = scores_t[(size_t)k0 * A + j];
  };
  // the next component tile, once every thread is done with the last
  auto next_tile = [&](int t) {
    if (ntiles > 1) {
      __syncthreads();
      load_tile(t);
      __syncthreads();
    }
  };

  if (FORM == kEpochs) {
    for (int j = tid; j < (op.nlive + 1) * P; j += kThreads)
      tab[j] = op.inv_scales[j];
    for (int j = tid; j < op.nlive; j += kThreads)
      tab[(op.nlive + 1) * P + j] = op.hist_c[j];
  }
  if (ntiles == 1) load_tile(0);
  __syncthreads();

  if constexpr (SPLIT == kPartial) {
    // pass 1 alone over the slice: each SNP's max and normalizer
    for (int base = blockIdx.x * kThreads; base < I;
         base += gridDim.x * kThreads) {
      const int i = base + tid;
      const bool live = i < I;
      Snp<P> snp;
      load_snp<P, FORM>(op, snp, i, live);
      const int asel = min(live ? ann[i] : A, A - 1);
      EpochRegs<P, NL> er;
      if constexpr (FORM == kEpochs) load_epochs<P, NL>(op, snp, tab, er);
      float s = 0.f, m = -INFINITY;
      for (int t = 0; t < ntiles; ++t) {
        next_tile(t);
        const int cnt = min(kt, K - t * kt);
#pragma unroll 4
        for (int kl_ = 0; kl_ < cnt; ++kl_) {
          const float* c = coef_s + kl_ * NCOL;
          const float sel = score_s[kl_ * A + asel];
          float z;
          if constexpr (FORM == kEpochs)
            z = z_epochs<P, NL>(op, snp, er, tab, c, sel);
          else
            z = z_form<P, FORM>(op, snp, c, t * kt + kl_, sel);
          if (z > m) {
            s = s * __expf(m - z) + 1.0f;
            m = z;
          } else {
            s += __expf(z - m);
          }
        }
      }
      if (live) {
        norm[i] = m;
        norm[(size_t)I + i] = s;
      }
    }
  } else {
    for (int g0 = 0; g0 < K; g0 += kg) {
      const int gcnt = min(kg, K - g0);
      for (int j = tid; j < gcnt * A; j += kThreads) part_s[j] = 0.f;
      for (int base = blockIdx.x * kThreads; base < I;
           base += gridDim.x * kThreads) {
        const int i = base + tid;
        const bool live = i < I;
        // kGiven: the SNP's global normalizer, merged from the comp
        // partials where ptxas spills least (-Xptxas -v): the kKdim form
        // first, before the SNP's other registers load; the others at
        // its use below
        constexpr bool kMergeFirst = FORM == kKdim;
        float given_m = 0.f, given_inv = 0.f;
        if (SPLIT == kGiven && kMergeFirst && live)
          merged_norm(norm, nparts, I, i, given_m, given_inv);
        Snp<P> snp;
        load_snp<P, FORM>(op, snp, i, live);
        const int a = live ? ann[i] : A;
        const int asel = min(a, A - 1);
        EpochRegs<P, NL> er;
        if constexpr (FORM == kEpochs) load_epochs<P, NL>(op, snp, tab, er);
        // the logit of the tile's component kl_ (component k)
        auto z_of = [&](int kl_, int k) {
          const float* c = coef_s + kl_ * NCOL;
          const float sel = score_s[kl_ * A + asel];
          if constexpr (FORM == kEpochs)
            return z_epochs<P, NL>(op, snp, er, tab, c, sel);
          else
            return z_form<P, FORM>(op, snp, c, k, sel);
        };
        // The tile's SNPs in annotation order, stable: pos is this SNP's
        // place, annotation aa holds places [seg_s[aa], seg_s[aa + 1]).
        // Pad SNPs (id A) sort last and are never read.
        for (int j = tid; j < (A + 1) * kWarps; j += kThreads) cnt_s[j] = 0;
        __syncthreads();
        const unsigned same = __match_any_sync(kFull, a);
        const int rank = __popc(same & ((1u << lane) - 1u));
        if (rank == 0) cnt_s[a * kWarps + warp] = __popc(same);
        __syncthreads();
        if (tid == 0) {
          int run = 0;
          for (int aa = 0; aa <= A; ++aa) {
            seg_s[aa] = run;
            for (int w = 0; w < kWarps; ++w) {
              const int c = cnt_s[aa * kWarps + w];
              cnt_s[aa * kWarps + w] = run;
              run += c;
            }
          }
          seg_s[A + 1] = run;
        }
        __syncthreads();
        const int pos = cnt_s[a * kWarps + warp] + rank;

        // pass 1 (first group): online max and normalizer of z over K
        float m, inv_s;
        if (SPLIT == kWhole && g0 == 0) {
          float s = 0.f;
          m = -INFINITY;
          for (int t = 0; t < ntiles; ++t) {
            next_tile(t);
            const int cnt = min(kt, K - t * kt);
            // (unrolled by four: the loads and special-function latencies
            // of four components overlap)
#pragma unroll 4
            for (int kl_ = 0; kl_ < cnt; ++kl_) {
              const float z = z_of(kl_, t * kt + kl_);
              if (z > m) {
                s = s * __expf(m - z) + 1.0f;
                m = z;
              } else {
                s += __expf(z - m);
              }
            }
          }
          inv_s = 1.0f / s;
          if (kg < K && live) {
            norm[i] = m;
            norm[(size_t)I + i] = inv_s;
          }
        } else if (SPLIT == kGiven) {
          m = given_m;
          inv_s = given_inv;
          if (!kMergeFirst && live) merged_norm(norm, nparts, I, i, m, inv_s);
        } else {  // this thread's own writes of the first group
          m = live ? norm[i] : 0.f;
          inv_s = live ? norm[(size_t)I + i] : 0.f;
        }

        // pass 2: the clamped weights of the group's components, kChunk at
        // a time, staged at their sorted places; one thread per
        // (component, annotation) adds its segment, in place order, into
        // the CTA's partial
        for (int t = g0 / kt; t * kt < g0 + gcnt; ++t) {
          next_tile(t);
          const int cnt = min(kt, K - t * kt);
          for (int c0 = 0; c0 < cnt; c0 += kChunk) {
            const int nc = min(kChunk, cnt - c0);
#pragma unroll 4
            for (int j = 0; j < nc; ++j) {
              const float z = z_of(c0 + j, t * kt + c0 + j);
              if (a < A)
                w_s[j * kWStride + pos] = fmaxf(__expf(z - m) * inv_s, eps);
            }
            __syncthreads();
            for (int q = tid; q < nc * A; q += kThreads) {
              const int aa = q / nc, j = q - aa * nc;
              const float* row = w_s + j * kWStride;
              float v = 0.f;
              for (int r = seg_s[aa]; r < seg_s[aa + 1]; ++r) v += row[r];
              part_s[(t * kt + c0 + j - g0) * A + aa] += v;
            }
            __syncthreads();
          }
        }
      }
      __syncthreads();
      float* dst = part + (size_t)blockIdx.x * K * A + (size_t)g0 * A;
      for (int j = tid; j < gcnt * A; j += kThreads) dst[j] = part_s[j];
      __syncthreads();
    }
  }
}

// SUMS = false: prologue (pm, pv, per-CTA KL partial in part[blockIdx]),
// one pass over K, S SNPs a thread (see prologue); SPLIT = kPartial: the
// accumulators of the slice into pm_out as [acc_rows(P)][I], nothing else.
// SUMS = true, SPLIT = kPartial: pass 1 alone, (m, s) into norm[2][I].
// SUMS = true, SPLIT = kGiven: norm holds the nparts pass-1 partials
// [nparts][2][I]; every group merges its SNP's (m, 1/s) from them.
// SUMS = true: per-CTA annotation sums in part[blockIdx][K][A], written
// once, component group by component group (kg components, a multiple of
// kt, or all K). The first group's pass 1 leaves each SNP's (m, 1/s) in
// norm[2][I] for the later groups (unused when kg == K).
// NL: the live epochs held in registers (-1: read at run time; the
// kShared and kKdim kernels ignore it).
template <int P, bool SUMS, int FORM, int NL = -1, int SPLIT = kWhole,
          int S = 1>
__global__ void __launch_bounds__(kThreads)
    compact_kernel(Operands op, const float* __restrict__ coeffs,
                   const float* __restrict__ scores_t,
                   const int* __restrict__ ann, float* __restrict__ pm_out,
                   float* __restrict__ pv_out, float* __restrict__ part,
                   float* __restrict__ norm, int I, int K, int A, int kt,
                   int kg, float eps, int nparts) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (SUMS)
    sums<P, FORM, NL, SPLIT>(op, coeffs, scores_t, ann, part, norm, smem, I,
                             K, A, kt, kg, eps, nparts);
  else
    prologue<P, FORM, NL, SPLIT, S>(op, coeffs, scores_t, ann, pm_out, pv_out,
                                    part, smem, I, K, A, kt);
}

// out[0] = sum of n partials, in a fixed order (one CTA)
__global__ void __launch_bounds__(kThreads)
    reduce_scalar(const float* __restrict__ part, int n,
                  float* __restrict__ out) {
  __shared__ double red[kThreads];
  double v = 0.0;
  for (int j = threadIdx.x; j < n; j += kThreads) v += part[j];
  red[threadIdx.x] = v;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = (float)red[0];
}

// out[j] = sum_b part[b][j] over nb partial rows of width m, in a fixed
// order: a CTA takes 32 columns (a lane each); warp w adds rows w, w + 8,
// w + 16, ... in f64, four loads in flight, then the warps' sums are added
// in warp order
__global__ void __launch_bounds__(kThreads)
    reduce_rows(const float* __restrict__ part, int nb, int m,
                float* __restrict__ out) {
  __shared__ double red[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane;
  double v = 0.0;
  if (j < m) {
    int b = warp;
    for (; b + 3 * kWarps < nb; b += 4 * kWarps) {
      const float x0 = part[(size_t)b * m + j];
      const float x1 = part[(size_t)(b + kWarps) * m + j];
      const float x2 = part[(size_t)(b + 2 * kWarps) * m + j];
      const float x3 = part[(size_t)(b + 3 * kWarps) * m + j];
      v += x0;
      v += x1;
      v += x2;
      v += x3;
    }
    for (; b < nb; b += kWarps) v += part[(size_t)b * m + j];
  }
  red[warp][lane] = v;
  __syncthreads();
  if (warp == 0 && j < m) {
    double tot = red[0][lane];
    for (int w = 1; w < kWarps; ++w) tot += red[w][lane];
    out[j] = (float)tot;
  }
}

// W consecutive floats or ints (W = 4: one 16-byte load or store, the
// address 16-byte aligned), loads through the read-only path
template <int W, typename T>
__device__ __forceinline__ void load_w(const T* __restrict__ p, T* v) {
  if constexpr (W == 4) {
    using V = typename std::conditional<std::is_same<T, int>::value, int4,
                                        float4>::type;
    const V x = __ldg(reinterpret_cast<const V*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int W>
__device__ __forceinline__ void store_w(float* __restrict__ p,
                                        const float* v) {
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    p[0] = v[0];
}

// The merge of SNPs i .. i + W - 1 (see merge_kernel); returns their KL
// terms, added in SNP order. MT > 0: M == MT partials, all of their rows
// loaded before any is used (one round trip to device memory); MT == 0:
// any M, a partial at a time.
template <int P, int W, int MT>
__device__ __forceinline__ float merge_snps(const float* __restrict__ parts,
                                            const int* __restrict__ ann,
                                            float* __restrict__ pm_out,
                                            float* __restrict__ pv_out,
                                            int I, int M, int A, size_t i) {
  constexpr int R = 3 + 2 * P;
  constexpr int MR = MT > 0 ? MT : 1;
  const size_t stride = (size_t)R * I;
  const int nm = MT > 0 ? MT : M;
  float held[MR][R][W];
  if constexpr (MT > 0) {
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int r = 0; r < R; ++r)
        load_w<W>(parts + j * stride + (size_t)r * I + i, held[j][r]);
  }
  float mx[W];
#pragma unroll
  for (int w = 0; w < W; ++w) mx[w] = -INFINITY;
#pragma unroll
  for (int j = 0; j < nm; ++j) {
    float m[W];
    if constexpr (MT > 0) {
#pragma unroll
      for (int w = 0; w < W; ++w) m[w] = held[j][0][w];
    } else {
      load_w<W>(parts + j * stride + i, m);
    }
#pragma unroll
    for (int w = 0; w < W; ++w) mx[w] = fmaxf(mx[w], m[w]);
  }
  float s0[W], q[W], sy[P][W], ssec[P][W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    s0[w] = q[w] = 0.f;
#pragma unroll
    for (int p = 0; p < P; ++p) sy[p][w] = ssec[p][w] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < nm; ++j) {
    float x[R][W];
    if constexpr (MT > 0) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int w = 0; w < W; ++w) x[r][w] = held[j][r][w];
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r)
        load_w<W>(parts + j * stride + (size_t)r * I + i, x[r]);
    }
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float a = expf(x[0][w] - mx[w]);
      s0[w] += a * x[1][w];
      q[w] += a * (x[2][w] + (x[0][w] - mx[w]) * x[1][w]);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        sy[p][w] += a * x[3 + p][w];
        ssec[p][w] += a * x[3 + P + p][w];
      }
    }
  }
  int an[W];
  load_w<W>(ann + i, an);
  float kl = 0.f;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const float inv = 1.0f / s0[w];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float pm = sy[p][w] * inv;
      sy[p][w] = pm;
      ssec[p][w] = ssec[p][w] * inv - pm * pm;
    }
    if (an[w] < A) kl += q[w] * inv - logf(s0[w]);
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    store_w<W>(pm_out + (size_t)p * I + i, sy[p]);
    store_w<W>(pv_out + (size_t)p * I + i, ssec[p]);
  }
  return kl;
}

// Merge of the K-split prologue, in one launch: parts [M][acc_rows(P)][I]
// (the M comp slices' partials of one SNP column, in comp order) -> pm, pv
// [P, I] and the KL scalar kl_out[0]. Each partial j is rescaled by a_j =
// exp(m_j - mx), mx = max_j m_j; its q_j, taken against m_j, also takes
// the shift (m_j - mx) s0_j, so that q = sum_k w_k (z_k - mx + g_k) and
// kl_i = q / S - log S with S = sum_j a_j s0_j: the log-normalizer is
// subtracted once per SNP. Fixed order over j.
//
// Bound by bytes: (3 + 2P) M + 1 floats in and 2P out per SNP (76 MB at
// 1M SNPs, M = P = 2), a few flops and one exponential per partial. So
// each thread takes 4 consecutive SNPs of the first 4 nvec (nvec = I / 4
// where I is a multiple of 4 and the operands 16-byte aligned, else 0)
// with 16-byte loads and stores, and the rest one by one, over a
// grid-stride loop of a few waves; with MT = M (2, component sharding's
// usual split) every row of a group is in flight at once. Each CTA writes
// its KL partial to part[blockIdx] and takes a ticket (an atomic count in
// ticket[0], after a fence); the CTA that draws the last ticket adds the
// partials in a fixed order in f64 (each thread a strided run, then the
// warps' butterflies, then the warps in order), writes kl_out and resets
// the ticket to 0 for the next launch. Launches on one stream run in
// order, so the wrapper keeps one ticket per (device, stream). The result
// repeats bit for bit.
template <int P, int MT>
__global__ void __launch_bounds__(kThreads)
    merge_kernel(const float* __restrict__ parts, const int* __restrict__ ann,
                 float* __restrict__ pm_out, float* __restrict__ pv_out,
                 float* __restrict__ kl_out, float* __restrict__ part,
                 unsigned* __restrict__ ticket, int I, int M, int A,
                 int nvec) {
  __shared__ float warp_kl[kWarps];
  __shared__ double warp_tot[kWarps];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int step = gridDim.x * kThreads;
  float kl = 0.f;
  for (int v = blockIdx.x * kThreads + tid; v < nvec; v += step)
    kl += merge_snps<P, 4, MT>(parts, ann, pm_out, pv_out, I, M, A,
                               4 * (size_t)v);
  for (int i = 4 * nvec + blockIdx.x * kThreads + tid; i < I; i += step)
    kl += merge_snps<P, 1, MT>(parts, ann, pm_out, pv_out, I, M, A, i);
  const float v = warp_sum(kl);
  if (lane == 0) warp_kl[warp] = v;
  __syncthreads();
  if (tid == 0) {
    float tot = 0.f;
    for (int w = 0; w < kWarps; ++w) tot += warp_kl[w];
    part[blockIdx.x] = tot;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // every other CTA fenced its partial before its ticket: read them past L1
  double s = 0.0;
  for (int j = tid; j < gridDim.x; j += kThreads) s += __ldcg(part + j);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  if (lane == 0) warp_tot[warp] = s;
  __syncthreads();
  if (tid == 0) {
    double tot = warp_tot[0];
    for (int w = 1; w < kWarps; ++w) tot += warp_tot[w];
    kl_out[0] = (float)tot;
    *ticket = 0u;
  }
}

// The prologue's launch: S = 2 SNPs a thread where tiles of 2 kThreads
// SNPs still give every CTA the card holds at once one (the card's SMs
// times the kernel's occupancy at this shared memory), else (and on an
// epoch state with live epochs) S = 1; a grid
// of at most that many CTAs, each striding over the tiles, and at most
// nblocks (part's length). Then, unless SPLIT = kPartial, the fixed-order
// reduction of its grid's KL partials into out.
template <int P, int FORM, int NL, int SPLIT>
cudaError_t launch_prologue(const Operands& op, const void* coeffs,
                            const void* scores_t, const void* ann, void* pm,
                            void* pv, void* part, void* out, int I, int K,
                            int A, int kt, int nblocks, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) *
      (size_t)prologue_floats(P, kt, A, table_floats(FORM, P, op.nlive));
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // the kernels at one and two SNPs a thread; an epoch state with live
  // epochs takes one (kTwo false): its epoch solves need the registers
  constexpr bool kTwo = FORM != kEpochs || NL == 0;
  decltype(&compact_kernel<P, false, FORM, NL, SPLIT, 1>) const kernels[] = {
      compact_kernel<P, false, FORM, NL, SPLIT, 1>,
      compact_kernel<P, false, FORM, NL, SPLIT, kTwo ? 2 : 1>};
  int snps = kTwo ? 2 : 1, tiles = 0, resident = 0;
  for (;; --snps) {
    const auto kernel = kernels[snps - 1];
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    resident = sms * per_sm;
    tiles = (I + snps * kThreads - 1) / (snps * kThreads);
    if (snps == 1 || tiles >= resident) break;
  }
  const int grid = max(1, min(nblocks, min(tiles, resident)));
  kernels[snps - 1]<<<grid, kThreads, smem, stream>>>(
      op, static_cast<const float*>(coeffs),
      static_cast<const float*>(scores_t), static_cast<const int*>(ann),
      static_cast<float*>(pm), static_cast<float*>(pv),
      static_cast<float*>(part), nullptr, I, K, A, kt, K, 0.f, 0);
  err = cudaGetLastError();
  if (err != cudaSuccess || SPLIT == kPartial) return err;
  reduce_scalar<<<1, kThreads, 0, stream>>>(
      static_cast<const float*>(part), grid, static_cast<float*>(out));
  return cudaGetLastError();
}

// Launch the compact kernel of form FORM, then the fixed-order reduction
// of its partials: out is the KL scalar (prologue) or the [K, A] sums.
// norm: [2, I] floats of scratch for the sums when kg < K (else unused).
// SPLIT = kPartial writes the partial alone (pm: the prologue's
// accumulators; norm: the sums' (m, s)), with no reduction launched.
// SPLIT = kGiven: norm holds the nparts sums pass-1 partials [nparts][2][I].
// The prologue takes nblocks as the most CTAs it may use (launch_prologue).
template <int P, bool SUMS, int FORM, int NL = -1, int SPLIT = kWhole>
cudaError_t launch(const Operands& op, const void* coeffs,
                   const void* scores_t, const void* ann, void* pm, void* pv,
                   void* part, void* norm, void* out, int I, int K, int A,
                   int kt, int kg, int nblocks, float eps,
                   cudaStream_t stream, int nparts = 0) {
  if constexpr (!SUMS) {
    return launch_prologue<P, FORM, NL, SPLIT>(op, coeffs, scores_t, ann, pm,
                                               pv, part, out, I, K, A, kt,
                                               nblocks, stream);
  } else {
    const size_t smem =
        sizeof(float) *
        ((size_t)kt * (ncol<P>() + A) +
         (size_t)extra_floats(SPLIT != kPartial, kg, A) +
         (size_t)table_floats(FORM, P, op.nlive));
    auto kernel = compact_kernel<P, true, FORM, NL, SPLIT>;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    kernel<<<nblocks, kThreads, smem, stream>>>(
        op, static_cast<const float*>(coeffs),
        static_cast<const float*>(scores_t), static_cast<const int*>(ann),
        static_cast<float*>(pm), static_cast<float*>(pv),
        static_cast<float*>(part), static_cast<float*>(norm), I, K, A, kt,
        kg, eps, nparts);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || SPLIT == kPartial) return err;
    const int m = K * A;
    reduce_rows<<<(m + 31) / 32, kThreads, 0, stream>>>(
        static_cast<const float*>(part), nblocks, m, static_cast<float*>(out));
    return cudaGetLastError();
  }
}

}  // namespace
}  // namespace vilma
