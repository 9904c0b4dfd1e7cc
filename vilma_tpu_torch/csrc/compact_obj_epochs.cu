// Fused compact-objective prologue and annotation sums of the
// epoch-history state, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels vilma_tpu/ops/pallas/compact_obj.py
// `prologue_epochs` (kernel `_epochs_kernel` via `_derive_tile_epochs`,
// compact_obj.py:127-222, 562) and `delta_sums_epochs`
// (`_sums_epochs_kernel`, :603). The state of --learn-scaling fits above
// the epoch-state threshold is a current accumulator u [P, I], a history
// of B epoch vectors v [B, P, I] with coefficients c [B], and the inverse
// error scalings [B+1, P] (row 0 the current one). Per SNP and component:
//
//     y_k   = sigma_k^cur u + sum_e c_e sigma_k^(e) v_e
//     quad_k = y_k . (prec_k + diag(dterm^cur)) y_k
//
// with sigma_k^(e) = (prec_k + diag(sld / scaling_e))^-1 formed in
// registers from the raw scaled LD diagonal, then the moments, KL terms and
// annotation sums of compact_obj.cuh.
//
// What bounds it: arithmetic. Each (SNP, component) does one closed-form
// solve per live epoch plus the current one, with a reciprocal in each,
// and a logarithm and an exponential, against (E + 3) P + 1 floats read
// per SNP for E live epochs.
//
// Design (kEpochs in compact_obj.cuh). The kernels loop over the live
// epochs only: slots at or past the live count hold c == 0, zero vectors
// and scale 1, so the terms they add are exactly zero and skipping them
// changes no result; the wrapper passes the live count the host keeps. The
// [E+1, P] inverse scalings and the [E] coefficients are staged once per
// CTA into shared memory (a broadcast). Up to kMaxRegEpochs live epochs
// (dispatched on the live count) keep their vectors, scaled diagonals and
// coefficients in registers; more are read per component through L1.
//   prologue: one pass over K with online softmax accumulators, so each
//     (SNP, component) is derived once: K (E + 1) solves per SNP. The
//     current-scaling solve and the summaries share one determinant and
//     reciprocal (SFU intrinsics for it, the log-determinant and the
//     weights).
//   delta sums: two passes over K of the logit alone, 2 K (E + 1) solves
//     per SNP, every reciprocal, logarithm and exponential from the SFU;
//     the CTA adds the weights by annotation through a sorted staging
//     buffer in shared memory and writes its [K, A] partial once (by
//     component groups where K·A does not fit).
#include "compact_obj.cuh"

namespace {

using namespace vilma;

// K-split forms (fit --mesh comp=M): the prologue partial and the sums'
// two passes over a shard's slice of K, as in compact_obj.cu; the merges
// are compact_obj.cu's, whatever the form.

// live epochs the kernels hold in registers (more: read through L1);
// 1 and 2 are the counts a fit runs at and the ones timed
constexpr int kMaxRegEpochs = 2;

// the prologue (SUMS false) or the sums at P cohorts, with the live-epoch
// count as NL (or -1)
template <int P, bool SUMS, int SPLIT = kWhole>
cudaError_t launch_epochs(const Operands& op, const void* coeffs,
                          const void* scores_t, const void* ann, void* pm,
                          void* pv, void* part, void* norm, void* out, int I,
                          int K, int A, int kt, int kg, int nblocks,
                          float eps, cudaStream_t stream) {
#define VILMA_EPOCHS(NL)                                                    \
  launch<P, SUMS, kEpochs, NL, SPLIT>(op, coeffs, scores_t, ann, pm, pv,    \
                                      part, norm, out, I, K, A, kt, kg,     \
                                      nblocks, eps, stream)
  static_assert(kMaxRegEpochs == 2, "one case per register epoch count");
  switch (op.nlive) {
    case 0:
      return VILMA_EPOCHS(0);
    case 1:
      return VILMA_EPOCHS(1);
    case 2:
      return VILMA_EPOCHS(2);
    default:
      return VILMA_EPOCHS(-1);
  }
#undef VILMA_EPOCHS
}

template <bool SUMS, int SPLIT = kWhole>
cudaError_t dispatch(int P, const void* coeffs, const void* scores_t,
                     const void* ann, const void* sld, const void* u,
                     const void* hist, const void* inv_scales,
                     const void* hist_c, void* pm, void* pv, void* part,
                     void* norm, void* out, int I, int K, int A, int nlive,
                     int kt, int kg, int nblocks, float eps,
                     cudaStream_t stream) {
  const Operands op{static_cast<const float*>(sld),
                    static_cast<const float*>(u),
                    static_cast<const float*>(hist),
                    static_cast<const float*>(inv_scales),
                    static_cast<const float*>(hist_c), I, nlive};
  switch (P) {
    case 1:
      return launch_epochs<1, SUMS, SPLIT>(op, coeffs, scores_t, ann, pm,
                                            pv, part, norm, out, I, K, A, kt,
                                            kg, nblocks, eps, stream);
    case 2:
      return launch_epochs<2, SUMS, SPLIT>(op, coeffs, scores_t, ann, pm,
                                            pv, part, norm, out, I, K, A, kt,
                                            kg, nblocks, eps, stream);
    case 3:
      return launch_epochs<3, SUMS, SPLIT>(op, coeffs, scores_t, ann, pm,
                                            pv, part, norm, out, I, K, A, kt,
                                            kg, nblocks, eps, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// coeffs [K, ncol], scores_t [K, A], sld and u [P, I], hist [B, P, I],
// inv_scales [B+1, P], hist_c [B] f32; ann [I] int32; nlive <= B epochs
// are read. Writes pm, pv [P, I] and kl_out (a scalar); part holds nblocks
// floats of scratch. Returns the launches' cudaError_t.
extern "C" int vilma_compact_prologue_epochs(
    const void* coeffs, const void* scores_t, const void* ann,
    const void* sld, const void* u, const void* hist, const void* inv_scales,
    const void* hist_c, void* pm, void* pv, void* part, void* kl_out, int I,
    int K, int A, int P, int nlive, int kt, int nblocks, float eps,
    void* stream) {
  return (int)dispatch<false>(P, coeffs, scores_t, ann, sld, u, hist,
                              inv_scales, hist_c, pm, pv, part, nullptr,
                              kl_out, I, K, A, nlive, kt, K, nblocks, eps,
                              static_cast<cudaStream_t>(stream));
}

// As above, but writes out [K, A] = the per-annotation sums of vi_delta;
// part holds nblocks * K * A floats of scratch (every one written), norm
// 2 * I floats when the kernel takes K in groups of kg < K (else unused).
extern "C" int vilma_compact_delta_sums_epochs(
    const void* coeffs, const void* scores_t, const void* ann,
    const void* sld, const void* u, const void* hist, const void* inv_scales,
    const void* hist_c, void* part, void* norm, void* out, int I, int K,
    int A, int P, int nlive, int kt, int kg, int nblocks, float eps,
    void* stream) {
  return (int)dispatch<true>(P, coeffs, scores_t, ann, sld, u, hist,
                             inv_scales, hist_c, nullptr, nullptr, part, norm,
                             out, I, K, A, nlive, kt, kg, nblocks, eps,
                             static_cast<cudaStream_t>(stream));
}

// K-split prologue over a slice of K: acc [3 + 2P, I] as
// vilma_compact_prologue_partial.
extern "C" int vilma_compact_prologue_epochs_partial(
    const void* coeffs, const void* scores_t, const void* ann,
    const void* sld, const void* u, const void* hist, const void* inv_scales,
    const void* hist_c, void* acc, int I, int K, int A, int P, int nlive,
    int kt, int nblocks, float eps, void* stream) {
  return (int)dispatch<false, kPartial>(
      P, coeffs, scores_t, ann, sld, u, hist, inv_scales, hist_c, acc,
      nullptr, nullptr, nullptr, nullptr, I, K, A, nlive, kt, K, nblocks, eps,
      static_cast<cudaStream_t>(stream));
}

// The sums' pass 1 over a slice of K: norm [2, I] = (m, s).
extern "C" int vilma_compact_delta_norm_epochs(
    const void* coeffs, const void* scores_t, const void* ann,
    const void* sld, const void* u, const void* hist, const void* inv_scales,
    const void* hist_c, void* norm, int I, int K, int A, int P, int nlive,
    int kt, int nblocks, float eps, void* stream) {
  return (int)dispatch<true, kPartial>(
      P, coeffs, scores_t, ann, sld, u, hist, inv_scales, hist_c, nullptr,
      nullptr, nullptr, norm, nullptr, I, K, A, nlive, kt, K, nblocks, eps,
      static_cast<cudaStream_t>(stream));
}

// The sums' pass 2 with the global normalizer norm [2, I] = (m, 1/S).
extern "C" int vilma_compact_delta_sums_epochs_given(
    const void* coeffs, const void* scores_t, const void* ann,
    const void* sld, const void* u, const void* hist, const void* inv_scales,
    const void* hist_c, void* part, void* norm, void* out, int I, int K,
    int A, int P, int nlive, int kt, int kg, int nblocks, float eps,
    void* stream) {
  return (int)dispatch<true, kGiven>(
      P, coeffs, scores_t, ann, sld, u, hist, inv_scales, hist_c, nullptr,
      nullptr, part, norm, out, I, K, A, nlive, kt, kg, nblocks, eps,
      static_cast<cudaStream_t>(stream));
}
