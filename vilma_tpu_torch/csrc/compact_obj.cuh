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
// Design: one thread per SNP, templated on P, with a runtime loop over K,
// so any K runs (no VMEM tile ceiling). The coefficient table and the
// scores are staged through shared memory in component tiles (once per CTA
// when all of K fits).
//
// Prologues, all three forms: one pass over K with online softmax
// accumulators (struct Online, weights by __expf) rescaled when the
// running max moves and folded into totals every kFold components, then
// pm = sy/s0, pv = ssec/s0 - pm^2, kl_i = (sz + sg)/s0 - log s0. Each
// component is derived once, its solve and summaries sharing one
// determinant and one SFU reciprocal (solve_summaries; kKdim reads each
// nat[k, p, i] once). They drop the
// clamp, which changes no result the band can see, whatever the form: a
// component the clamp touches has vd_k < eps = 1e-30 (f32), and there the
// clamped form adds eps (resp. eps log eps) where the unclamped one adds
// vd_k (resp. vd_k log vd_k), so each sum moves by at most K eps max|f_k|
// (the term f_k: y_k, diag_k + y_k^2, or the KL term, with |x log x| <=
// eps |log eps| below eps). The forms differ only in y_k and quad_k, so
// the bound holds for each; at K <= a few thousand it is ~1e-25 of
// quantities of order 1e-8 and up: far below half an ulp of any sum.
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
//                     slice's own reference m: acc[kAccRows(P)][I] = m, s0,
//                     q = sz + sg, sy[P], ssec[P] (SPLIT = kPartial);
//   merge             merge_kernel: the M partials of one SNP column, each
//                     rescaled by exp(m_j - max_j m_j), finished as the
//                     whole-K prologue finishes (pm, pv, the KL per CTA);
//   sums pass 1       the online max and normalizer over the slice alone,
//                     written as (m, s) into a [2, I] array (kPartial);
//   norm merge        norm_merge_kernel: (max_j m_j, 1 / sum_j s_j e^(m_j -
//                     max)), the global normalizer;
//   sums pass 2       the whole-K sums body with the global normalizer read
//                     from its [2, I] workspace for every group (kGiven).
// The dropped clamp stays valid under the split: each slice accumulates
// against its own reference and the merge only rescales, so every weight
// is the unclamped one, and the KL subtracts log S once per SNP, in the
// merge.
//
// The TPU accumulates the KL and the sums across its sequential grid; here
// each CTA writes a partial in fixed order and a second kernel adds the
// partials in fixed order. No float atomics touch device memory, so every
// result repeats bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

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
struct Comp {
  float y[P];
  float diag[P];
  float logdet, quad, quadform, matches, ldp;
};

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

// y' prec y with c a component's coefficient row
template <int P>
__device__ __forceinline__ float quadform_of(const float* c, const float* y);

template <>
__device__ __forceinline__ float quadform_of<1>(const float* c,
                                                const float* y) {
  return c[0] * y[0] * y[0];
}

template <>
__device__ __forceinline__ float quadform_of<2>(const float* c,
                                                const float* y) {
  return c[0] * y[0] * y[0] + 2.0f * c[1] * y[0] * y[1] + c[2] * y[1] * y[1];
}

template <>
__device__ __forceinline__ float quadform_of<3>(const float* c,
                                                const float* y) {
  return c[0] * y[0] * y[0] + c[3] * y[1] * y[1] + c[5] * y[2] * y[2] +
         2.0f * (c[1] * y[0] * y[1] + c[2] * y[0] * y[2] +
                 c[4] * y[1] * y[2]);
}

// solve<P> and the current-scaling summaries at one dt sharing one
// determinant and one reciprocal: o.y = (prec + diag(dt))^-1 n, the
// diagonal of sigma, its log-determinant and trace(prec sigma) (the caller
// forms o.quadform = y' prec y once y is final). The reciprocal and the
// log-determinant come from the SFU (__fdividef, __logf: a few ulp, far
// inside the prologues' bands on the card).
template <int P>
__device__ __forceinline__ void solve_summaries(const float* c,
                                                const float* dt,
                                                const float* n, Comp<P>& o);

template <>
__device__ __forceinline__ void solve_summaries<1>(const float* c,
                                                   const float* dt,
                                                   const float* n,
                                                   Comp<1>& o) {
  const float a = c[0] + dt[0];
  o.ldp = c[1];
  const float inv = __fdividef(1.0f, a);
  o.y[0] = n[0] * inv;
  o.diag[0] = inv;
  o.logdet = __logf(a);
  o.matches = c[0] * inv;
}

template <>
__device__ __forceinline__ void solve_summaries<2>(const float* c,
                                                   const float* dt,
                                                   const float* n,
                                                   Comp<2>& o) {
  const float a = c[0] + dt[0];
  const float b = c[1];
  const float d = c[2] + dt[1];
  o.ldp = c[3];
  const float det = a * d - b * b;
  const float inv = __fdividef(1.0f, det);
  o.y[0] = (d * n[0] - b * n[1]) * inv;
  o.y[1] = (a * n[1] - b * n[0]) * inv;
  o.diag[0] = d * inv;
  o.diag[1] = a * inv;
  o.logdet = __logf(det);
  o.matches = (c[0] * d - 2.0f * c[1] * b + c[2] * a) * inv;
}

template <>
__device__ __forceinline__ void solve_summaries<3>(const float* c,
                                                   const float* dt,
                                                   const float* n,
                                                   Comp<3>& o) {
  const float pa = c[0] + dt[0];
  const float pb = c[1], pc = c[2];
  const float pd = c[3] + dt[1];
  const float pe = c[4];
  const float pf = c[5] + dt[2];
  o.ldp = c[6];
  const float A3 = pd * pf - pe * pe;
  const float B3 = pc * pe - pb * pf;
  const float C3 = pb * pe - pc * pd;
  const float D3 = pa * pf - pc * pc;
  const float E3 = pb * pc - pa * pe;
  const float F3 = pa * pd - pb * pb;
  const float det = pa * A3 + pb * B3 + pc * C3;
  const float inv = __fdividef(1.0f, det);
  o.y[0] = (A3 * n[0] + B3 * n[1] + C3 * n[2]) * inv;
  o.y[1] = (B3 * n[0] + D3 * n[1] + E3 * n[2]) * inv;
  o.y[2] = (C3 * n[0] + E3 * n[1] + F3 * n[2]) * inv;
  o.diag[0] = A3 * inv;
  o.diag[1] = D3 * inv;
  o.diag[2] = F3 * inv;
  o.logdet = __logf(det);
  o.matches = (c[0] * A3 + c[3] * D3 + c[5] * F3 +
               2.0f * (c[1] * B3 + c[2] * C3 + c[4] * E3)) *
              inv;
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

// component k of a [P, I] or kdim SNP for the one-pass prologue
// (compact_obj._derive_tile): y = sigma n, quad = y . n, the solve and the
// summaries sharing one determinant and one SFU reciprocal
template <int P, int FORM>
__device__ __forceinline__ void derive_once(const Operands& op,
                                            const Snp<P>& s, const float* c,
                                            int k, Comp<P>& o) {
  float n[P];
  nat_of<P, FORM>(op, s, k, n);
  solve_summaries<P>(c, s.dt, n, o);
  o.quadform = quadform_of<P>(c, o.y);
  o.quad = o.y[0] * n[0];
#pragma unroll
  for (int p = 1; p < P; ++p) o.quad += o.y[p] * n[p];
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

// component k of an epoch-state SNP for the prologue
// (compact_obj._derive_tile_epochs), one determinant shared between the
// current-scaling solve and the summaries
template <int P, int NL>
__device__ __forceinline__ void derive_epochs(const Operands& op,
                                              const Snp<P>& s,
                                              const EpochRegs<P, NL>& r,
                                              const float* tab,
                                              const float* c, Comp<P>& o) {
  solve_summaries<P>(c, r.dc, s.n, o);
  add_epochs<P, NL, false>(op, s, r, tab, c, o.y);
  o.quadform = quadform_of<P>(c, o.y);
  o.quad = quad_of_mean<P>(c, r.dc, o.y);
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
// and the log-determinant from one determinant and one SFU reciprocal (as
// solve_summaries), quad = y . n; no diagonal, matches or quadform. kKdim
// reads nat[k, p, i] once.
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

// a logit must pass the running reference m by this many nats to move it
constexpr float kRescale = 8.0f;

// the one-pass prologue folds its run sums into its totals every kFold
// components: one f32 run over all of K drifts by ~sqrt(K) ulps (1.2e-5
// of the posterior means at K = 42,999), runs of kFold by ~sqrt(kFold) +
// sqrt(K / kFold)
constexpr int kFold = 128;

// Online softmax accumulators of one SNP over K (the one-pass prologue).
// With w_k = exp(z_k - m) under a running reference m:
//   s0 = sum w_k,  sy = sum w_k y_k,  ssec = sum w_k (diag_k + y_k^2),
//   sz = sum w_k (z_k - m),
//   sg = sum w_k (0.5 quadform_k + 0.5 ss_k - log_hd_k).
// add() adds to the current run's sums (r*); fold() adds the run into the
// totals (s*) and starts a new one, which the caller does every kFold
// components and last. m moves only when a logit passes it by more than
// kRescale nats (so w_k <= e^kRescale and rescales are rare); a move
// multiplies every sum, run and total, by exp(m_old - m_new), and sz and
// rz also take the shift (m_old - m_new) times their s0.
template <int P>
struct Online {
  float m, s0, sz, sg, sy[P], ssec[P];
  float r0, rz, rg, ry[P], rsec[P];

  __device__ __forceinline__ Online() : m(-INFINITY), s0(0.f), sz(0.f),
                                        sg(0.f), r0(0.f), rz(0.f), rg(0.f) {
#pragma unroll
    for (int p = 0; p < P; ++p) sy[p] = ssec[p] = ry[p] = rsec[p] = 0.f;
  }

  __device__ __forceinline__ void add(const Comp<P>& o, float z, float sel) {
    if (z > m + kRescale) {
      const float alpha = expf(m - z);  // 0 at the first component
      sz = s0 > 0.f ? (sz + (m - z) * s0) * alpha : 0.f;
      rz = r0 > 0.f ? (rz + (m - z) * r0) * alpha : 0.f;
      s0 *= alpha;
      sg *= alpha;
      r0 *= alpha;
      rg *= alpha;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        sy[p] *= alpha;
        ssec[p] *= alpha;
        ry[p] *= alpha;
        rsec[p] *= alpha;
      }
      m = z;
    }
    const float dz = z - m;
    const float w = __expf(dz);
    r0 += w;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      ry[p] += w * o.y[p];
      rsec[p] += w * (o.diag[p] + o.y[p] * o.y[p]);
    }
    rz += w * dz;
    const float log_hd = sel + 0.5f * o.ldp;
    const float ss = o.ldp + o.logdet + o.matches;
    rg += w * ((0.5f * o.quadform + 0.5f * ss) - log_hd);
  }

  __device__ __forceinline__ void fold() {
    s0 += r0;
    sz += rz;
    sg += rg;
    r0 = rz = rg = 0.f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      sy[p] += ry[p];
      ssec[p] += rsec[p];
      ry[p] = rsec[p] = 0.f;
    }
  }
};

// the sums stage the weights of kChunk components per SNP tile, one row of
// kWStride floats each (the odd stride spreads a warp's rows over the banks)
constexpr int kChunk = 16;
constexpr int kWStride = kThreads + 1;

// floats of shared memory past the [kt] component tiles:
//   prologue  the warps' KL sums [kWarps]
//   sums      the CTA's partial of one component group [kg][A], the staged
//             weights [kChunk][kWStride], the per-warp annotation counts
//             [A + 1][kWarps] and segment starts [A + 2] (ints)
// then the form's table (table_floats). ops/cuda/compact_obj.py
// (_launch_shape) sizes the tiles and groups by the same count.
__host__ __device__ inline int extra_floats(bool sums, int kg, int A) {
  if (!sums) return kWarps;
  return kg * A + kChunk * kWStride + (A + 1) * kWarps + A + 2;
}

// SUMS = false: prologue (pm, pv, per-CTA KL partial in part[blockIdx]),
// one pass over K; SPLIT = kPartial: the accumulators of the slice into
// pm_out as [acc_rows(P)][I], nothing else.
// SUMS = true, SPLIT = kPartial: pass 1 alone, (m, s) into norm[2][I].
// SUMS = true, SPLIT = kGiven: every group reads (m, 1/s) from norm.
// SUMS = true: per-CTA annotation sums in part[blockIdx][K][A], written
// once, component group by component group (kg components, a multiple of
// kt, or all K). The first group's pass 1 leaves each SNP's (m, 1/s) in
// norm[2][I] for the later groups (unused when kg == K).
// NL: the live epochs held in registers (-1: read at run time; the
// kShared and kKdim kernels ignore it).
template <int P, bool SUMS, int FORM, int NL = -1, int SPLIT = kWhole>
__global__ void __launch_bounds__(kThreads)
    compact_kernel(Operands op, const float* __restrict__ coeffs,
                   const float* __restrict__ scores_t,
                   const int* __restrict__ ann, float* __restrict__ pm_out,
                   float* __restrict__ pv_out, float* __restrict__ part,
                   float* __restrict__ norm, int I, int K, int A, int kt,
                   int kg, float eps) {
  constexpr int NCOL = ncol<P>();
  // the sorted per-CTA reduction (the sums' pass 2)
  constexpr bool kSorted = SUMS && SPLIT != kPartial;
  extern __shared__ float smem[];
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

  if constexpr (!SUMS) {
    float kl = 0.f;
    // grid-stride over SNP tiles; every thread of a CTA runs the same
    // number of iterations, so the barriers below are uniform
    for (int base = blockIdx.x * kThreads; base < I;
         base += gridDim.x * kThreads) {
      const int i = base + tid;
      const bool live = i < I;
      // dead lanes carry an inert pad slot (dterm 1, natural mean 0, id A)
      Snp<P> snp;
      load_snp<P, FORM>(op, snp, i, live);
      const int a = live ? ann[i] : A;
      const int asel = min(a, A - 1);
      EpochRegs<P, NL> er;
      if constexpr (FORM == kEpochs) load_epochs<P, NL>(op, snp, tab, er);
      Online<P> acc;
      for (int t = 0; t < ntiles; ++t) {
        next_tile(t);
        const int cnt = min(kt, K - t * kt);
        for (int k0 = 0; k0 < cnt; k0 += kFold) {
          const int k1 = min(cnt, k0 + kFold);
          for (int kl_ = k0; kl_ < k1; ++kl_) {
            Comp<P> o;
            const float* c = coef_s + kl_ * NCOL;
            if constexpr (FORM == kEpochs)
              derive_epochs<P, NL>(op, snp, er, tab, c, o);
            else
              derive_once<P, FORM>(op, snp, c, t * kt + kl_, o);
            const float sel = score_s[kl_ * A + asel];
            acc.add(o, 0.5f * (o.quad - o.logdet) + sel, sel);
          }
          acc.fold();
        }
      }
      if (live && SPLIT == kPartial) {
        pm_out[i] = acc.m;
        pm_out[(size_t)I + i] = acc.s0;
        pm_out[2 * (size_t)I + i] = acc.sz + acc.sg;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          pm_out[(size_t)(3 + p) * I + i] = acc.sy[p];
          pm_out[(size_t)(3 + P + p) * I + i] = acc.ssec[p];
        }
      } else if (live) {
        const float inv = 1.0f / acc.s0;  // one reciprocal per SNP
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float pm = acc.sy[p] * inv;
          pm_out[(size_t)p * I + i] = pm;
          pv_out[(size_t)p * I + i] = acc.ssec[p] * inv - pm * pm;
        }
        if (a < A) kl += (acc.sz + acc.sg) * inv - logf(acc.s0);
      }
    }
    if (SPLIT == kPartial) return;
    const float v = warp_sum(kl);
    if (lane == 0) extra[warp] = v;
    __syncthreads();
    if (tid == 0) {
      float tot = 0.f;
      for (int w = 0; w < kWarps; ++w) tot += extra[w];
      part[blockIdx.x] = tot;
    }
  } else if constexpr (SPLIT == kPartial) {
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
        } else {  // this thread's own writes of the first group, or
                  // (kGiven) the global normalizer
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

// Merge of the K-split prologue: parts [M][acc_rows(P)][I] (the M comp
// slices' partials of one SNP column, in comp order) -> pm, pv [P, I] and
// the per-CTA KL partial in part[blockIdx]. Each partial j is rescaled by
// a_j = exp(m_j - mx), mx = max_j m_j; its q_j, taken against m_j, also
// takes the shift (m_j - mx) s0_j, so that q = sum_k w_k (z_k - mx + g_k)
// and kl_i = q / S - log S with S = sum_j a_j s0_j: the log-normalizer is
// subtracted once per SNP. Fixed order over j: bit-for-bit repeatable.
template <int P>
__global__ void __launch_bounds__(kThreads)
    merge_kernel(const float* __restrict__ parts, const int* __restrict__ ann,
                 float* __restrict__ pm_out, float* __restrict__ pv_out,
                 float* __restrict__ part, int I, int M, int A) {
  __shared__ float warp_kl[kWarps];
  const size_t stride = (size_t)acc_rows(P) * I;
  float kl = 0.f;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < I;
       i += gridDim.x * kThreads) {
    float mx = -INFINITY;
    for (int j = 0; j < M; ++j) mx = fmaxf(mx, parts[j * stride + i]);
    float s0 = 0.f, q = 0.f, sy[P], ssec[P];
#pragma unroll
    for (int p = 0; p < P; ++p) sy[p] = ssec[p] = 0.f;
    for (int j = 0; j < M; ++j) {
      const float* pj = parts + j * stride;
      const float mj = pj[i];
      const float a = expf(mj - mx);
      const float sj = pj[(size_t)I + i];
      s0 += a * sj;
      q += a * (pj[2 * (size_t)I + i] + (mj - mx) * sj);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        sy[p] += a * pj[(size_t)(3 + p) * I + i];
        ssec[p] += a * pj[(size_t)(3 + P + p) * I + i];
      }
    }
    const float inv = 1.0f / s0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float pm = sy[p] * inv;
      pm_out[(size_t)p * I + i] = pm;
      pv_out[(size_t)p * I + i] = ssec[p] * inv - pm * pm;
    }
    if (ann[i] < A) kl += q * inv - logf(s0);
  }
  const float v = warp_sum(kl);
  if ((threadIdx.x & 31) == 0) warp_kl[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.f;
    for (int w = 0; w < kWarps; ++w) tot += warp_kl[w];
    part[blockIdx.x] = tot;
  }
}

// Merge of the sums' pass-1 partials: parts [M][2][I] of (m_j, s_j) ->
// norm [2][I] = (mx, 1 / sum_j s_j exp(m_j - mx)), the global normalizer
// pass 2 reads (kGiven), in fixed order over j.
__global__ void __launch_bounds__(kThreads)
    norm_merge_kernel(const float* __restrict__ parts,
                      float* __restrict__ norm, int I, int M) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < I;
       i += gridDim.x * kThreads) {
    float mx = -INFINITY;
    for (int j = 0; j < M; ++j) mx = fmaxf(mx, parts[2 * (size_t)j * I + i]);
    float s = 0.f;
    for (int j = 0; j < M; ++j)
      s += parts[(2 * (size_t)j + 1) * I + i] *
           expf(parts[2 * (size_t)j * I + i] - mx);
    norm[i] = mx;
    norm[(size_t)I + i] = 1.0f / s;
  }
}

// Launch the compact kernel of form FORM, then the fixed-order reduction
// of its partials: out is the KL scalar (prologue) or the [K, A] sums.
// norm: [2, I] floats of scratch for the sums when kg < K (else unused).
// SPLIT = kPartial writes the partial alone (pm: the prologue's
// accumulators; norm: the sums' (m, s)), with no reduction launched.
template <int P, bool SUMS, int FORM, int NL = -1, int SPLIT = kWhole>
cudaError_t launch(const Operands& op, const void* coeffs,
                   const void* scores_t, const void* ann, void* pm, void* pv,
                   void* part, void* norm, void* out, int I, int K, int A,
                   int kt, int kg, int nblocks, float eps,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) *
      ((size_t)kt * (ncol<P>() + A) +
       (size_t)extra_floats(SUMS && SPLIT != kPartial, kg, A) +
       (size_t)table_floats(FORM, P, op.nlive));
  auto kernel = compact_kernel<P, SUMS, FORM, NL, SPLIT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<nblocks, kThreads, smem, stream>>>(
      op, static_cast<const float*>(coeffs),
      static_cast<const float*>(scores_t), static_cast<const int*>(ann),
      static_cast<float*>(pm), static_cast<float*>(pv),
      static_cast<float*>(part), static_cast<float*>(norm), I, K, A, kt, kg,
      eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || SPLIT == kPartial) return err;
  if (SUMS) {
    const int m = K * A;
    reduce_rows<<<(m + 31) / 32, kThreads, 0, stream>>>(
        static_cast<const float*>(part), nblocks, m, static_cast<float*>(out));
  } else {
    reduce_scalar<<<1, kThreads, 0, stream>>>(
        static_cast<const float*>(part), nblocks, static_cast<float*>(out));
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace vilma
