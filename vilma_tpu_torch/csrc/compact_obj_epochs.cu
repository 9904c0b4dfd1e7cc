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
// solve per live epoch plus the current one, and the two passes over K
// repeat them: 2 K (E + 1) solves per SNP for E live epochs, against
// (E + 3) P + 1 floats read per SNP.
//
// Design (kEpochs in compact_obj.cuh): the kernel loops over the live
// epochs only. Slots at or past the live count hold c == 0, zero vectors
// and scale 1, so the terms they add are exactly zero and skipping them
// changes no result; the wrapper passes the live count it keeps on the
// host. The [E+1, P] inverse scalings and
// the [E] coefficients are staged once per CTA into shared memory (every
// thread reads the same entry: a broadcast). A thread's epoch vectors
// (E P floats) are re-read for each component through the L1 cache, which
// holds a CTA's 256 SNPs x E x P x 4 B; registers would cap E at compile
// time.
#include "compact_obj.cuh"

namespace {

using namespace vilma;

template <bool SUMS>
cudaError_t dispatch(int P, const void* coeffs, const void* scores_t,
                     const void* ann, const void* sld, const void* u,
                     const void* hist, const void* inv_scales,
                     const void* hist_c, void* pm, void* pv, void* part,
                     void* out, int I, int K, int A, int nlive, int kt,
                     int nblocks, float eps, float log_eps,
                     cudaStream_t stream) {
  const Operands op{static_cast<const float*>(sld),
                    static_cast<const float*>(u),
                    static_cast<const float*>(hist),
                    static_cast<const float*>(inv_scales),
                    static_cast<const float*>(hist_c), I, nlive};
  switch (P) {
    case 1:
      return launch<1, SUMS, kEpochs>(op, coeffs, scores_t, ann, pm, pv, part,
                                      out, I, K, A, kt, nblocks, eps, log_eps,
                                      stream);
    case 2:
      return launch<2, SUMS, kEpochs>(op, coeffs, scores_t, ann, pm, pv, part,
                                      out, I, K, A, kt, nblocks, eps, log_eps,
                                      stream);
    case 3:
      return launch<3, SUMS, kEpochs>(op, coeffs, scores_t, ann, pm, pv, part,
                                      out, I, K, A, kt, nblocks, eps, log_eps,
                                      stream);
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
    float log_eps, void* stream) {
  return (int)dispatch<false>(P, coeffs, scores_t, ann, sld, u, hist,
                              inv_scales, hist_c, pm, pv, part, kl_out, I, K,
                              A, nlive, kt, nblocks, eps, log_eps,
                              static_cast<cudaStream_t>(stream));
}

// As above, but writes out [K, A] = the per-annotation sums of vi_delta;
// part holds nblocks * K * A floats of scratch, zeroed by the caller.
extern "C" int vilma_compact_delta_sums_epochs(
    const void* coeffs, const void* scores_t, const void* ann,
    const void* sld, const void* u, const void* hist, const void* inv_scales,
    const void* hist_c, void* part, void* out, int I, int K, int A, int P,
    int nlive, int kt, int nblocks, float eps, float log_eps, void* stream) {
  return (int)dispatch<true>(P, coeffs, scores_t, ann, sld, u, hist,
                             inv_scales, hist_c, nullptr, nullptr, part, out,
                             I, K, A, nlive, kt, nblocks, eps, log_eps,
                             static_cast<cudaStream_t>(stream));
}
