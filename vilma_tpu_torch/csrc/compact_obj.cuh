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
// from (`derive_form`):
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
// when all of K fits). The eps clamp needs the softmax normalizer before
// any weighted sum, so the [P, I] and kdim prologues and all the sums make
// two passes over K per thread: pass 1 keeps an online max and sum, pass 2
// recomputes the closed form and accumulates the moments and KL terms (or
// the sums); no [K]-sized per-thread state.
//
// The epoch prologue (kOnePass in compact_kernel) makes one pass: online
// softmax accumulators (struct Online, weights by __expf) rescaled when the
// running max moves, then pm = sy/s0, pv = ssec/s0 - pm^2,
// kl_i = (sz + sg)/s0 - log s0. It drops the clamp, which changes no
// result the band can see: a component
// the clamp touches has vd_k < eps = 1e-30 (f32), and there the clamped
// form adds eps (resp. eps log eps) where the unclamped one adds vd_k
// (resp. vd_k log vd_k), so each sum moves by at most K eps max|f_k| (the
// term f_k: y_k, diag_k + y_k^2, or the KL term, with |x log x| <=
// eps |log eps| below eps). At K <= a few thousand that is ~1e-25 of
// quantities of order 1e-8 and up: far below half an ulp of any sum. The
// sums kernels cannot take one pass per SNP: they add vd_k(i) across SNPs,
// and each term needs its SNP's final normalizer.
//
// The TPU accumulates the KL and the sums across its sequential grid; here
// each CTA writes a partial in fixed order (warp shuffles, then warps in
// order) and a second kernel adds the partials in fixed order. No float
// atomics touch device memory, so every result repeats bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace vilma {

enum Form { kShared = 0, kKdim = 1, kEpochs = 2 };

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

// y = (prec + diag(dt))^-1 n for one (SNP, component); c is the
// component's coefficient row (precision upper triangle, then logdet)
template <int P>
__device__ __forceinline__ void solve(const float* c, const float* dt,
                                      const float* n, float* y);

template <>
__device__ __forceinline__ void solve<1>(const float* c, const float* dt,
                                         const float* n, float* y) {
  y[0] = n[0] * (1.0f / (c[0] + dt[0]));
}

template <>
__device__ __forceinline__ void solve<2>(const float* c, const float* dt,
                                         const float* n, float* y) {
  const float a = c[0] + dt[0];
  const float b = c[1];
  const float d = c[2] + dt[1];
  const float inv = 1.0f / (a * d - b * b);
  y[0] = (d * n[0] - b * n[1]) * inv;
  y[1] = (a * n[1] - b * n[0]) * inv;
}

template <>
__device__ __forceinline__ void solve<3>(const float* c, const float* dt,
                                         const float* n, float* y) {
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
  const float inv = 1.0f / (pa * A3 + pb * B3 + pc * C3);
  y[0] = (A3 * n[0] + B3 * n[1] + C3 * n[2]) * inv;
  y[1] = (B3 * n[0] + D3 * n[1] + E3 * n[2]) * inv;
  y[2] = (C3 * n[0] + E3 * n[1] + F3 * n[2]) * inv;
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

// current-scaling summaries of a component's mean o.y: the diagonal of
// sigma, its log-determinant, trace(prec sigma) and y' prec y
template <int P>
__device__ __forceinline__ void summaries(const float* c, const float* dt,
                                          Comp<P>& o);

template <>
__device__ __forceinline__ void summaries<1>(const float* c, const float* dt,
                                             Comp<1>& o) {
  const float a = c[0] + dt[0];
  o.ldp = c[1];
  const float inv = 1.0f / a;
  o.diag[0] = inv;
  o.logdet = logf(a);
  o.quadform = quadform_of<1>(c, o.y);
  o.matches = c[0] * inv;
}

template <>
__device__ __forceinline__ void summaries<2>(const float* c, const float* dt,
                                             Comp<2>& o) {
  const float a = c[0] + dt[0];
  const float b = c[1];
  const float d = c[2] + dt[1];
  o.ldp = c[3];
  const float det = a * d - b * b;
  const float inv = 1.0f / det;
  o.diag[0] = d * inv;
  o.diag[1] = a * inv;
  o.logdet = logf(det);
  o.quadform = quadform_of<2>(c, o.y);
  o.matches = (c[0] * d - 2.0f * c[1] * b + c[2] * a) * inv;
}

template <>
__device__ __forceinline__ void summaries<3>(const float* c, const float* dt,
                                             Comp<3>& o) {
  const float pa = c[0] + dt[0];
  const float pb = c[1], pc = c[2];
  const float pd = c[3] + dt[1];
  const float pe = c[4];
  const float pf = c[5] + dt[2];
  o.ldp = c[6];
  // symmetric-3x3 adjugate (models/sigma._adjugate3)
  const float A3 = pd * pf - pe * pe;
  const float B3 = pc * pe - pb * pf;
  const float C3 = pb * pe - pc * pd;
  const float D3 = pa * pf - pc * pc;
  const float E3 = pb * pc - pa * pe;
  const float F3 = pa * pd - pb * pb;
  const float det = pa * A3 + pb * B3 + pc * C3;
  const float inv = 1.0f / det;
  o.diag[0] = A3 * inv;
  o.diag[1] = D3 * inv;
  o.diag[2] = F3 * inv;
  o.logdet = logf(det);
  o.quadform = quadform_of<3>(c, o.y);
  o.matches = (c[0] * A3 + c[3] * D3 + c[5] * F3 +
               2.0f * (c[1] * B3 + c[2] * C3 + c[4] * E3)) *
              inv;
}

// solve<P> and summaries<P> at one dt sharing one determinant and one
// reciprocal: o.y = (prec + diag(dt))^-1 n and the summaries that do not
// depend on y (the caller forms o.quadform once y is final). For the
// one-pass epoch prologue only: the reciprocal and the log-determinant
// come from the SFU (__fdividef, __logf: a few ulp, far inside the
// prologue's bands on the card).
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

// closed-form component algebra from an input natural mean n
// (compact_obj._derive_tile): y = sigma n, quad = y . n
template <int P>
__device__ __forceinline__ void derive(const float* c, const float* dt,
                                       const float* n, Comp<P>& o) {
  solve<P>(c, dt, n, o.y);
  summaries<P>(c, dt, o);
  o.quad = o.y[0] * n[0];
#pragma unroll
  for (int p = 1; p < P; ++p) o.quad += o.y[p] * n[p];
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

// summaries of a given mean o.y (compact_obj._derive_tile_epochs)
template <int P>
__device__ __forceinline__ void stats_of_mean(const float* c, const float* dt,
                                              Comp<P>& o) {
  summaries<P>(c, dt, o);
  o.quad = quad_of_mean<P>(c, dt, o.y);
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

// component k of SNP s under form FORM; tab is the staged table
template <int P, int FORM>
__device__ __forceinline__ void derive_form(const Operands& op,
                                            const Snp<P>& s, const float* tab,
                                            const float* c, int k,
                                            Comp<P>& o) {
  if (FORM == kShared) {
    derive<P>(c, s.dt, s.n, o);
  } else if (FORM == kKdim) {
    // lane i reads nat[k, p, i]: a warp's loads are contiguous
    float n[P];
#pragma unroll
    for (int p = 0; p < P; ++p)
      n[p] = s.live ? op.nat[((size_t)k * P + p) * op.I + s.i] : 0.0f;
    derive<P>(c, s.dt, n, o);
  } else {
    const float* coef = tab + (op.nlive + 1) * P;
    float dt[P];
#pragma unroll
    for (int p = 0; p < P; ++p) dt[p] = s.dt[p] * tab[p];
    solve<P>(c, dt, s.n, o.y);
    for (int e = 0; e < op.nlive; ++e) {
      float dte[P], v[P], ye[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        dte[p] = s.dt[p] * tab[(e + 1) * P + p];
        v[p] = s.live ? op.hist[((size_t)e * P + p) * op.I + s.i] : 0.0f;
      }
      solve<P>(c, dte, v, ye);
      const float ce = coef[e];
#pragma unroll
      for (int p = 0; p < P; ++p) o.y[p] = o.y[p] + ce * ye[p];
    }
    stats_of_mean<P>(c, dt, o);
  }
}

// Registers of one SNP for the one-pass epoch prologue: the current
// scaled diagonal and, with NL >= 0 live epochs held in registers, each
// epoch's scaled diagonal, vector and coefficient. With NL < 0 the live
// count is read at run time and the epochs come through L1 per component,
// as in derive_form.
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

// component k of an epoch-state SNP (derive_form's kEpochs branch, with
// the per-SNP values hoisted into r and one determinant shared between
// the current-scaling solve and the summaries)
template <int P, int NL>
__device__ __forceinline__ void derive_epochs(const Operands& op,
                                              const Snp<P>& s,
                                              const EpochRegs<P, NL>& r,
                                              const float* tab,
                                              const float* c, Comp<P>& o) {
  solve_summaries<P>(c, r.dc, s.n, o);
  if constexpr (NL >= 0) {
#pragma unroll
    for (int e = 0; e < NL; ++e) {
      float ye[P];
      solve<P>(c, r.dte[e], r.v[e], ye);
#pragma unroll
      for (int p = 0; p < P; ++p) o.y[p] = o.y[p] + r.ce[e] * ye[p];
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
      solve<P>(c, dte, v, ye);
      const float ce = coef[e];
#pragma unroll
      for (int p = 0; p < P; ++p) o.y[p] = o.y[p] + ce * ye[p];
    }
  }
  o.quadform = quadform_of<P>(c, o.y);
  o.quad = quad_of_mean<P>(c, r.dc, o.y);
}

// a logit must pass the running reference m by this many nats to move it
constexpr float kRescale = 8.0f;

// Online softmax accumulators of one SNP over K (the one-pass prologue).
// With w_k = exp(z_k - m) under a running reference m:
//   s0 = sum w_k,  sy = sum w_k y_k,  ssec = sum w_k (diag_k + y_k^2),
//   sz = sum w_k (z_k - m),
//   sg = sum w_k (0.5 quadform_k + 0.5 ss_k - log_hd_k).
// m moves only when a logit passes it by more than kRescale nats (so
// w_k <= e^kRescale and rescales are rare); a move multiplies every sum by
// exp(m_old - m_new), and sz also takes the shift (m_old - m_new) s0.
template <int P>
struct Online {
  float m, s0, sz, sg, sy[P], ssec[P];

  __device__ __forceinline__ Online() : m(-INFINITY), s0(0.f), sz(0.f),
                                        sg(0.f) {
#pragma unroll
    for (int p = 0; p < P; ++p) sy[p] = ssec[p] = 0.f;
  }

  __device__ __forceinline__ void add(const Comp<P>& o, float z, float sel) {
    if (z > m + kRescale) {
      const float alpha = expf(m - z);  // 0 at the first component
      sz = s0 > 0.f ? (sz + (m - z) * s0) * alpha : 0.f;
      s0 *= alpha;
      sg *= alpha;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        sy[p] *= alpha;
        ssec[p] *= alpha;
      }
      m = z;
    }
    const float dz = z - m;
    const float w = __expf(dz);
    s0 += w;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      sy[p] += w * o.y[p];
      ssec[p] += w * (o.diag[p] + o.y[p] * o.y[p]);
    }
    sz += w * dz;
    const float log_hd = sel + 0.5f * o.ldp;
    const float ss = o.ldp + o.logdet + o.matches;
    sg += w * ((0.5f * o.quadform + 0.5f * ss) - log_hd);
  }
};

// SUMS = false: prologue (pm, pv, per-CTA KL partial in part[blockIdx]).
// SUMS = true: per-CTA annotation sums added into part[blockIdx][K][A]
// (zeroed by the caller). NL: the epoch prologue's live epochs held in
// registers (-1: read at run time; the other kernels ignore it).
template <int P, bool SUMS, int FORM, int NL = -1>
__global__ void __launch_bounds__(kThreads)
    compact_kernel(Operands op, const float* __restrict__ coeffs,
                   const float* __restrict__ scores_t,
                   const int* __restrict__ ann, float* __restrict__ pm_out,
                   float* __restrict__ pv_out, float* __restrict__ part, int I,
                   int K, int A, int kt, float eps, float log_eps) {
  constexpr int NCOL = ncol<P>();
  // One pass over K with online accumulators (the epoch prologue), or two:
  // pass 1 the max and normalizer, pass 2 the clamped weighted sums.
  constexpr bool kOnePass = !SUMS && FORM == kEpochs;
  extern __shared__ float smem[];
  float* coef_s = smem;                 // [kt][NCOL]
  float* score_s = coef_s + kt * NCOL;  // [kt][A]
  float* extra = score_s + kt * A;      // SUMS: [kWarps][kt][A]; else [kWarps]
  float* tab = extra + (SUMS ? kWarps * kt * A : kWarps);
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

  if (FORM == kEpochs) {
    for (int j = tid; j < (op.nlive + 1) * P; j += kThreads)
      tab[j] = op.inv_scales[j];
    for (int j = tid; j < op.nlive; j += kThreads)
      tab[(op.nlive + 1) * P + j] = op.hist_c[j];
  }
  if (ntiles == 1) load_tile(0);
  __syncthreads();

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

    if constexpr (kOnePass) {
      EpochRegs<P, NL> er;
      if constexpr (FORM == kEpochs) load_epochs<P, NL>(op, snp, tab, er);
      Online<P> acc;
      for (int t = 0; t < ntiles; ++t) {
        if (ntiles > 1) {
          __syncthreads();
          load_tile(t);
          __syncthreads();
        }
        const int cnt = min(kt, K - t * kt);
        for (int kl_ = 0; kl_ < cnt; ++kl_) {
          Comp<P> o;
          const float* c = coef_s + kl_ * NCOL;
          if constexpr (FORM == kEpochs)
            derive_epochs<P, NL>(op, snp, er, tab, c, o);
          else
            derive_form<P, FORM>(op, snp, tab, c, t * kt + kl_, o);
          const float sel = score_s[kl_ * A + asel];
          acc.add(o, 0.5f * (o.quad - o.logdet) + sel, sel);
        }
      }
      if (live) {
        const float inv = 1.0f / acc.s0;  // one reciprocal per SNP
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float pm = acc.sy[p] * inv;
          pm_out[(size_t)p * I + i] = pm;
          pv_out[(size_t)p * I + i] = acc.ssec[p] * inv - pm * pm;
        }
        if (a < A) kl += (acc.sz + acc.sg) * inv - logf(acc.s0);
      }
      continue;
    }

    // pass 1: online max and normalizer of z over K
    float m = -INFINITY, s = 0.f;
    for (int t = 0; t < ntiles; ++t) {
      if (ntiles > 1) {
        __syncthreads();
        load_tile(t);
        __syncthreads();
      }
      const int cnt = min(kt, K - t * kt);
      for (int kl_ = 0; kl_ < cnt; ++kl_) {
        Comp<P> o;
        derive_form<P, FORM>(op, snp, tab, coef_s + kl_ * NCOL, t * kt + kl_,
                             o);
        const float z = 0.5f * (o.quad - o.logdet) + score_s[kl_ * A + asel];
        if (z > m) {
          s = s * expf(m - z) + 1.0f;
          m = z;
        } else {
          s += expf(z - m);
        }
      }
    }
    const float log_s = logf(s);

    // pass 2: moments and KL terms (or the annotation sums)
    float pm[P], sec[P];
#pragma unroll
    for (int p = 0; p < P; ++p) pm[p] = sec[p] = 0.f;
    float kl_i = 0.f;
    for (int t = 0; t < ntiles; ++t) {
      if (ntiles > 1) {
        __syncthreads();
        load_tile(t);
        __syncthreads();
      }
      const int cnt = min(kt, K - t * kt);
      for (int kl_ = 0; kl_ < cnt; ++kl_) {
        Comp<P> o;
        derive_form<P, FORM>(op, snp, tab, coef_s + kl_ * NCOL, t * kt + kl_,
                             o);
        const float sel = score_s[kl_ * A + asel];
        const float z = 0.5f * (o.quad - o.logdet) + sel;
        const float vd = fmaxf(expf(z - m) / s, eps);
        if (!SUMS) {
          const float log_vd = fmaxf(z - m - log_s, log_eps);
#pragma unroll
          for (int p = 0; p < P; ++p) {
            pm[p] += vd * o.y[p];
            sec[p] += vd * (o.diag[p] + o.y[p] * o.y[p]);
          }
          const float log_hd = sel + 0.5f * o.ldp;
          const float ss = o.ldp + o.logdet + o.matches;
          kl_i += vd * ((log_vd - log_hd) + 0.5f * o.quadform + 0.5f * ss);
        } else {
          // per-warp sums by annotation; lanes of other ids add zero
          for (int aa = 0; aa < A; ++aa) {
            const bool mine = a == aa;
            float v = 0.f;
            if (__any_sync(kFull, mine)) v = warp_sum(mine ? vd : 0.f);
            if (lane == 0) extra[(warp * kt + kl_) * A + aa] = v;
          }
        }
      }
      if (SUMS) {
        __syncthreads();
        float* dst = part + (size_t)blockIdx.x * K * A + (size_t)t * kt * A;
        for (int j = tid; j < cnt * A; j += kThreads) {
          float v = 0.f;
          for (int w = 0; w < kWarps; ++w) v += extra[w * kt * A + j];
          dst[j] += v;
        }
        __syncthreads();
      }
    }
    if (!SUMS && live) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        pm_out[(size_t)p * I + i] = pm[p];
        pv_out[(size_t)p * I + i] = sec[p] - pm[p] * pm[p];
      }
      if (a < A) kl += kl_i;
    }
  }

  if (!SUMS) {
    const float v = warp_sum(kl);
    if (lane == 0) extra[warp] = v;
    __syncthreads();
    if (tid == 0) {
      float tot = 0.f;
      for (int w = 0; w < kWarps; ++w) tot += extra[w];
      part[blockIdx.x] = tot;
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

// out[j] = sum_b part[b][j] over nb partial rows of width m, in order
__global__ void __launch_bounds__(kThreads)
    reduce_rows(const float* __restrict__ part, int nb, int m,
                float* __restrict__ out) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= m) return;
  double v = 0.0;
  for (int b = 0; b < nb; ++b) v += part[(size_t)b * m + j];
  out[j] = (float)v;
}

// Launch the compact kernel of form FORM, then the fixed-order reduction
// of its partials: out is the KL scalar (prologue) or the [K, A] sums.
template <int P, bool SUMS, int FORM, int NL = -1>
cudaError_t launch(const Operands& op, const void* coeffs,
                   const void* scores_t,
                   const void* ann, void* pm, void* pv, void* part, void* out,
                   int I, int K, int A, int kt, int nblocks, float eps,
                   float log_eps, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kt * (ncol<P>() + A) +
                       (SUMS ? (size_t)kWarps * kt * A : (size_t)kWarps) +
                       (size_t)table_floats(FORM, P, op.nlive));
  auto kernel = compact_kernel<P, SUMS, FORM, NL>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<nblocks, kThreads, smem, stream>>>(
      op, static_cast<const float*>(coeffs),
      static_cast<const float*>(scores_t), static_cast<const int*>(ann),
      static_cast<float*>(pm), static_cast<float*>(pv),
      static_cast<float*>(part), I, K, A, kt, eps, log_eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (SUMS) {
    const int m = K * A;
    reduce_rows<<<(m + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        static_cast<const float*>(part), nblocks, m, static_cast<float*>(out));
  } else {
    reduce_scalar<<<1, kThreads, 0, stream>>>(
        static_cast<const float*>(part), nblocks, static_cast<float*>(out));
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace vilma
