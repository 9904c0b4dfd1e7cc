// Fused compact-objective prologue and annotation sums for Hopper (sm_90a):
// the shared [P, I] and the per-component [K, P, I] natural mean.
//
// Replaces the Pallas TPU kernels of vilma_tpu/ops/pallas/compact_obj.py
// `prologue` (kernel `_kernel` via `_derive_tile`) and `delta_sums`
// (`_sums_kernel`), in both their forms: the shared [P, I] natural mean of
// fits without --learn-scaling, and the kdim form (`_derive_tile`,
// compact_obj.py:257-263), whose [K, P, I] natural mean is the state of
// --learn-scaling fits below the epoch-state threshold. The algebra and
// the kernel body are in compact_obj.cuh.
//
// What bounds it:
//   shared form: issue slots, not bytes. Each SNP reads and writes a few
//     [P] values (~50 MB at 1M SNPs), but does a closed-form solve, an
//     exponential and a logarithm per component (two passes for the sums):
//     at K = 582 the instructions a (SNP, component) pair issues set the
//     time, so the prologue's body is written for the fewest of them (the
//     note in compact_obj.cuh). At K = 18 it is a memory-bound streaming
//     pass.
//   kdim form: bytes. The [K, P, I] state is K times larger (420 MB at
//     90,112 SNPs x 582 components, P = 2) and each (SNP, component) reads
//     P floats of it for a few dozen flops.
//
// Design (compact_obj.cuh): the prologues make one pass over K, so the
// kdim prologue reads its state once; thread i reads nat[k, p, i], so the
// 32 lanes of a warp read 128 contiguous bytes of each [K, P, I] row and
// every load coalesces. The sums make two passes of the logit alone (2 x
// 420 MB of kdim state at the per-chromosome size) and add the weights by
// annotation through the sorted per-CTA reduction of the epoch sums.
//
// K-split forms (fit --mesh comp=M; the JAX package gets them from XLA
// partitioning its [K, ...] arrays, vilma_tpu/parallel/mesh.py:53-101,
// with the algebra of its K-chunked route, vilma_tpu/inference/
// engine.py:873-1004): the prologue partial and the sums' two passes over
// a shard's slice of K, and the prologue's merge (merge_kernel in
// compact_obj.cuh) that joins the M slices of one SNP column. The partials
// are the whole-K kernels' own bodies, so they are bound as those are, by
// the per-(SNP, component) derivation, over K / M components. The merge
// reads (3 + 2P) M floats per SNP and is bound by bytes: one launch, 16-byte
// loads, the KL scalar added by its last CTA. The sums' normalizers are
// merged inside pass 2 (merged_norm), from the 2M floats per SNP of the
// M pass-1 partials.
#include "compact_obj.cuh"

namespace {

using namespace vilma;

template <int FORM, bool SUMS, int SPLIT = kWhole>
cudaError_t dispatch(int P, const void* coeffs, const void* scores_t,
                     const void* ann, const void* dterm, const void* nat,
                     void* pm, void* pv, void* part, void* norm, void* out,
                     int I, int K, int A, int kt, int kg, int nblocks,
                     float eps, cudaStream_t stream, int nparts = 0) {
  const Operands op{static_cast<const float*>(dterm),
                    static_cast<const float*>(nat), nullptr, nullptr, nullptr,
                    I, 0};
  switch (P) {
    case 1:
      return launch<1, SUMS, FORM, -1, SPLIT>(op, coeffs, scores_t, ann, pm,
                                               pv, part, norm, out, I, K, A,
                                               kt, kg, nblocks, eps, stream,
                                               nparts);
    case 2:
      return launch<2, SUMS, FORM, -1, SPLIT>(op, coeffs, scores_t, ann, pm,
                                               pv, part, norm, out, I, K, A,
                                               kt, kg, nblocks, eps, stream,
                                               nparts);
    case 3:
      return launch<3, SUMS, FORM, -1, SPLIT>(op, coeffs, scores_t, ann, pm,
                                               pv, part, norm, out, I, K, A,
                                               kt, kg, nblocks, eps, stream,
                                               nparts);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// coeffs [K, ncol], scores_t [K, A], dterm and nat [P, I] f32; ann [I]
// int32. Writes pm, pv [P, I] and kl_out (a scalar); part holds nblocks
// floats of scratch. Returns the launches' cudaError_t.
extern "C" int vilma_compact_prologue(const void* coeffs, const void* scores_t,
                                      const void* ann, const void* dterm,
                                      const void* nat, void* pm, void* pv,
                                      void* part, void* kl_out, int I, int K,
                                      int A, int P, int kt, int nblocks,
                                      float eps, void* stream) {
  return (int)dispatch<kShared, false>(
      P, coeffs, scores_t, ann, dterm, nat, pm, pv, part, nullptr, kl_out, I,
      K, A, kt, K, nblocks, eps, static_cast<cudaStream_t>(stream));
}

// As above, but writes out [K, A] = the per-annotation sums of vi_delta;
// part holds nblocks * K * A floats of scratch (every one written), norm
// 2 * I floats when the kernel takes K in groups of kg < K (else unused).
extern "C" int vilma_compact_delta_sums(const void* coeffs,
                                        const void* scores_t, const void* ann,
                                        const void* dterm, const void* nat,
                                        void* part, void* norm, void* out,
                                        int I, int K, int A, int P, int kt,
                                        int kg, int nblocks, float eps,
                                        void* stream) {
  return (int)dispatch<kShared, true>(
      P, coeffs, scores_t, ann, dterm, nat, nullptr, nullptr, part, norm, out,
      I, K, A, kt, kg, nblocks, eps, static_cast<cudaStream_t>(stream));
}

// The kdim forms: nat is the [K, P, I] per-component natural mean.
extern "C" int vilma_compact_prologue_kdim(
    const void* coeffs, const void* scores_t, const void* ann,
    const void* dterm, const void* nat, void* pm, void* pv, void* part,
    void* kl_out, int I, int K, int A, int P, int kt, int nblocks, float eps,
    void* stream) {
  return (int)dispatch<kKdim, false>(
      P, coeffs, scores_t, ann, dterm, nat, pm, pv, part, nullptr, kl_out, I,
      K, A, kt, K, nblocks, eps, static_cast<cudaStream_t>(stream));
}

extern "C" int vilma_compact_delta_sums_kdim(
    const void* coeffs, const void* scores_t, const void* ann,
    const void* dterm, const void* nat, void* part, void* norm, void* out,
    int I, int K, int A, int P, int kt, int kg, int nblocks, float eps,
    void* stream) {
  return (int)dispatch<kKdim, true>(
      P, coeffs, scores_t, ann, dterm, nat, nullptr, nullptr, part, norm, out,
      I, K, A, kt, kg, nblocks, eps, static_cast<cudaStream_t>(stream));
}

// K-split prologue over a slice of K (its coeffs and scores_t rows; nat
// [P, I], or [K, P, I] for the kdim entry point): writes acc
// [3 + 2P, I] = (m, s0, q, sy[P], ssec[P]) per SNP, unnormalized.
extern "C" int vilma_compact_prologue_partial(
    const void* coeffs, const void* scores_t, const void* ann,
    const void* dterm, const void* nat, void* acc, int I, int K, int A,
    int P, int kt, int nblocks, float eps, void* stream) {
  return (int)dispatch<kShared, false, kPartial>(
      P, coeffs, scores_t, ann, dterm, nat, acc, nullptr, nullptr, nullptr,
      nullptr, I, K, A, kt, K, nblocks, eps,
      static_cast<cudaStream_t>(stream));
}

extern "C" int vilma_compact_prologue_kdim_partial(
    const void* coeffs, const void* scores_t, const void* ann,
    const void* dterm, const void* nat, void* acc, int I, int K, int A,
    int P, int kt, int nblocks, float eps, void* stream) {
  return (int)dispatch<kKdim, false, kPartial>(
      P, coeffs, scores_t, ann, dterm, nat, acc, nullptr, nullptr, nullptr,
      nullptr, I, K, A, kt, K, nblocks, eps,
      static_cast<cudaStream_t>(stream));
}

// The sums' pass 1 over a slice of K: norm [2, I] = (m, s) per SNP.
extern "C" int vilma_compact_delta_norm(const void* coeffs,
                                        const void* scores_t, const void* ann,
                                        const void* dterm, const void* nat,
                                        void* norm, int I, int K, int A,
                                        int P, int kt, int nblocks, float eps,
                                        void* stream) {
  return (int)dispatch<kShared, true, kPartial>(
      P, coeffs, scores_t, ann, dterm, nat, nullptr, nullptr, nullptr, norm,
      nullptr, I, K, A, kt, K, nblocks, eps,
      static_cast<cudaStream_t>(stream));
}

extern "C" int vilma_compact_delta_norm_kdim(
    const void* coeffs, const void* scores_t, const void* ann,
    const void* dterm, const void* nat, void* norm, int I, int K, int A,
    int P, int kt, int nblocks, float eps, void* stream) {
  return (int)dispatch<kKdim, true, kPartial>(
      P, coeffs, scores_t, ann, dterm, nat, nullptr, nullptr, nullptr, norm,
      nullptr, I, K, A, kt, K, nblocks, eps,
      static_cast<cudaStream_t>(stream));
}

// The sums' pass 2 over a slice of K given the M pass-1 partials parts
// [M, 2, I] = (m_j, s_j) of the SNP column, in comp order (each thread
// merges its SNP's normalizer): out [K, A] as vilma_compact_delta_sums.
extern "C" int vilma_compact_delta_sums_given(
    const void* coeffs, const void* scores_t, const void* ann,
    const void* dterm, const void* nat, void* part, void* parts, void* out,
    int I, int K, int A, int P, int kt, int kg, int nblocks, int M,
    float eps, void* stream) {
  return (int)dispatch<kShared, true, kGiven>(
      P, coeffs, scores_t, ann, dterm, nat, nullptr, nullptr, part, parts,
      out, I, K, A, kt, kg, nblocks, eps, static_cast<cudaStream_t>(stream),
      M);
}

extern "C" int vilma_compact_delta_sums_kdim_given(
    const void* coeffs, const void* scores_t, const void* ann,
    const void* dterm, const void* nat, void* part, void* parts, void* out,
    int I, int K, int A, int P, int kt, int kg, int nblocks, int M,
    float eps, void* stream) {
  return (int)dispatch<kKdim, true, kGiven>(
      P, coeffs, scores_t, ann, dterm, nat, nullptr, nullptr, part, parts,
      out, I, K, A, kt, kg, nblocks, eps, static_cast<cudaStream_t>(stream),
      M);
}

namespace {

// merge_kernel at P cohorts: every row of a group in flight at once for
// M = 2 (MT = 2), a partial at a time for other M (MT = 0)
template <int P>
cudaError_t launch_merge(const float* parts, const int* ann, float* out,
                         unsigned* ticket, int I, int M, int A, int nvec,
                         int nblocks, cudaStream_t st) {
  float* pm = out;
  float* pv = pm + (size_t)P * I;
  float* kl = pv + (size_t)P * I;
  if (M == 2)
    merge_kernel<P, 2><<<nblocks, kThreads, 0, st>>>(
        parts, ann, pm, pv, kl, kl + 1, ticket, I, M, A, nvec);
  else
    merge_kernel<P, 0><<<nblocks, kThreads, 0, st>>>(
        parts, ann, pm, pv, kl, kl + 1, ticket, I, M, A, nvec);
  return cudaGetLastError();
}

}  // namespace

// The merge of M prologue partials [M, 3 + 2P, I] of one SNP column, in
// one launch: out holds pm [P, I], pv [P, I], the KL scalar, then nblocks
// floats of per-CTA partials; ticket is an unsigned count at 0, left at 0
// (one per stream). The first 4 nvec SNPs go four at a time (16-byte
// accesses: the wrapper passes nvec = I / 4 only where I is a multiple of
// 4 and parts and ann are 16-byte aligned, else 0).
extern "C" int vilma_compact_merge(const void* parts, const void* ann,
                                   void* out, void* ticket, int I, int M,
                                   int A, int P, int nvec, int nblocks,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(parts);
  const int* a = static_cast<const int*>(ann);
  float* o = static_cast<float*>(out);
  unsigned* t = static_cast<unsigned*>(ticket);
  switch (P) {
    case 1:
      return (int)launch_merge<1>(x, a, o, t, I, M, A, nvec, nblocks, st);
    case 2:
      return (int)launch_merge<2>(x, a, o, t, I, M, A, nvec, nblocks, st);
    case 3:
      return (int)launch_merge<3>(x, a, o, t, I, M, A, nvec, nblocks, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
