"""Algebra of the variational covariances vi_sigma.

Port of vilma_tpu/models/sigma.py. The per-SNP, per-component covariance

    vi_sigma[k,:,:,i] = inv(mixture_prec[k] + diag(diag_term[:, i]))

is never materialized in compute. For P = 1..3 cohorts every contraction
against it is a closed-form PxP inverse. For P >= 4 the precision
blocks, which are symmetric positive definite, are factored by Cholesky
in I-chunks whose [K, chunk, P, P] temporaries stay under
_GENERIC_CHUNK_BYTES; solves, inverses and log-determinants come from
the factor (the JAX package uses LU there: at f64 the two agree to
~1e-13). A block whose factorization fails raises LinAlgError.

The factor is written out entry by entry over [K, chunk] planes, each
step one elementwise pass: for millions of 4x4 blocks the library's
batched torch.linalg.cholesky_ex / cholesky_solve / cholesky_inverse
took 17-140x longer on an H100 (profile_torch_sigma.py, K = 1,953,
P = 4, 90,112 SNPs: apply_sigma 6.2-7.9 s a call against 53-58 ms).

Functions take `diag_term` = scaled_ld_diags / error_scaling[:, None]
([P, I]) and `mixture_prec` ([K, P, P]).
"""
from dataclasses import dataclass

import torch

# byte budget of one [K, chunk, P, P] temporary of the generic P >= 4
# path; tests shrink it to a ragged tail
_GENERIC_CHUNK_BYTES = 256 << 20


@dataclass(frozen=True)
class SigmaSummaries:
    """O(K*I) summaries of vi_sigma (reference _set_vi_sigma,
    variational_inference.py:712-733); all [K, I] except diag [K, P, I]."""
    log_det_sigma: torch.Tensor
    sigma_summary: torch.Tensor
    diag: torch.Tensor
    matches: torch.Tensor


def _precision_parts(mixture_prec, diag_term):
    """Split the per-(k,i) precision into reusable [K, I] components."""
    P = mixture_prec.shape[1]
    if P == 1:
        return (mixture_prec[:, 0, 0][:, None] + diag_term[0][None, :],)
    if P == 2:
        a = mixture_prec[:, 0, 0][:, None] + diag_term[0][None, :]
        b = mixture_prec[:, 0, 1][:, None] + torch.zeros_like(diag_term[0])
        d = mixture_prec[:, 1, 1][:, None] + diag_term[1][None, :]
        return (a, b, d)
    # M[k,i] = [[a, b, c], [b, d, e], [c, e, f]]: the diagonal varies
    # with i, the off-diagonals stay [K, 1] broadcastables
    a = mixture_prec[:, 0, 0][:, None] + diag_term[0][None, :]
    d = mixture_prec[:, 1, 1][:, None] + diag_term[1][None, :]
    f = mixture_prec[:, 2, 2][:, None] + diag_term[2][None, :]
    b = mixture_prec[:, 0, 1][:, None]
    c = mixture_prec[:, 0, 2][:, None]
    e = mixture_prec[:, 1, 2][:, None]
    return (a, b, c, d, e, f)


def _adjugate3(parts):
    """Adjugate entries + determinant of the symmetric 3x3 family."""
    a, b, c, d, e, f = parts
    A = d * f - e * e
    B = c * e - b * f
    C = b * e - c * d
    D = a * f - c * c
    E = b * c - a * e
    F = a * d - b * b
    det = a * A + b * B + c * C
    return A, B, C, D, E, F, det


# ---------------------------------------------------------------------------
# P >= 4: Cholesky factors of the precision blocks, entry by entry over
# [K, chunk] planes (each step one elementwise pass over the chunk)
# ---------------------------------------------------------------------------

def _use_closed_form(P):
    return P <= 3


def _chunk_len(mixture_prec, I):
    """SNPs per I-chunk: one [K, chunk, P, P] temporary within
    _GENERIC_CHUNK_BYTES."""
    K, P, _ = mixture_prec.shape
    per_snp = K * P * P * mixture_prec.element_size()
    return max(1, min(I, _GENERIC_CHUNK_BYTES // per_snp))


def _i_chunks(mixture_prec, diag_term, failures):
    """Yield (columns, lower Cholesky factor) over I-chunks of
    M[k, i] = mixture_prec[k] + diag(diag_term[:, i]). The factor is a
    nested list, L[i][j] ([K, chunk]) for j <= i. Appends to `failures`
    each chunk's count (0-dim, on the device) of the blocks whose pivots
    were not positive (or not a number)."""
    P, I = diag_term.shape
    chunk = _chunk_len(mixture_prec, I)
    for i0 in range(0, I, chunk):
        cols = slice(i0, i0 + chunk)
        dt = diag_term[:, cols]
        L = [[None] * P for _ in range(P)]
        ok = True
        for j in range(P):
            pivot = mixture_prec[:, j, j][:, None] + dt[j][None, :]
            for t in range(j):
                pivot = pivot - L[j][t] * L[j][t]
            ok = (pivot > 0) & ok
            L[j][j] = torch.sqrt(pivot)
            for i in range(j + 1, P):
                s = mixture_prec[:, i, j][:, None]
                for t in range(j):
                    s = s - L[i][t] * L[j][t]
                L[i][j] = s / L[j][j]
        failures.append(torch.count_nonzero(~ok))
        yield cols, L


def check_cholesky(bad):
    """Raise if `bad`, a count of failed factorizations (on the device or
    the host), is not zero."""
    if int(bad):
        raise torch.linalg.LinAlgError(
            f'{int(bad)} precision blocks mixture_prec[k] + diag(d_i) are '
            'not positive definite in this precision (Cholesky failed)')


def _cholesky_solve(L, x):
    """M^{-1} x for x a list of P [K, chunk] rows: L y = x, L^T z = y."""
    P = len(L)
    y = []
    for i in range(P):
        s = x[i]
        for t in range(i):
            s = s - L[i][t] * y[t]
        y.append(s / L[i][i])
    z = [None] * P
    for i in reversed(range(P)):
        s = y[i]
        for t in range(i + 1, P):
            s = s - L[t][i] * z[t]
        z[i] = s / L[i][i]
    return z


def _cholesky_inverse(L):
    """sigma = M^{-1} = W^T W with W = L^{-1}: the symmetric entries
    sigma[p][q] ([K, chunk]) as a nested list, and log det sigma."""
    P = len(L)
    W = [[None] * P for _ in range(P)]
    for i in range(P):
        W[i][i] = 1.0 / L[i][i]
        for j in range(i):
            s = L[i][j] * W[j][j]
            for t in range(j + 1, i):
                s = s + L[i][t] * W[t][j]
            W[i][j] = -s * W[i][i]
    sigma = [[None] * P for _ in range(P)]
    for p in range(P):
        for q in range(p, P):
            s = W[q][p] * W[q][q]
            for t in range(q + 1, P):
                s = s + W[t][p] * W[t][q]
            sigma[p][q] = sigma[q][p] = s
    log_det_sigma = 2 * sum(torch.log(W[j][j]) for j in range(P))
    return sigma, log_det_sigma


def apply_precision(mixture_prec, diag_term, x):
    """(mixture_prec[k] + diag(diag_term[:,i])) @ x[k,:,i] -> [K,P,I]."""
    return (torch.einsum('kpq,kqi->kpi', mixture_prec, x)
            + diag_term[None, :, :] * x)


def apply_sigma(mixture_prec, diag_term, x, failures=None):
    """vi_sigma[k,:,:,i] @ x[k,:,i] -> [K,P,I]: closed-form solves for
    P <= 3, chunked Cholesky solves beyond. Given a `failures` list, the
    factorizations' failure counts go there (for a caller that fetches
    them with a synchronization it makes anyway), else they are checked
    here."""
    P = mixture_prec.shape[1]
    if not _use_closed_form(P):
        out = x.new_empty((mixture_prec.shape[0], P, x.shape[-1]))
        fails = [] if failures is None else failures
        for cols, L in _i_chunks(mixture_prec, diag_term, fails):
            z = _cholesky_solve(L, [x[:, p, cols] for p in range(P)])
            for p in range(P):
                out[:, p, cols] = z[p]
        if failures is None:
            check_cholesky(sum(fails))
        return out
    parts = _precision_parts(mixture_prec, diag_term)
    if P == 1:
        (a,) = parts
        return (x[:, 0, :] / a)[:, None, :]
    if P == 2:
        a, b, d = parts
        det = a * d - b * b
        x0, x1 = x[:, 0, :], x[:, 1, :]
        return torch.stack([(d * x0 - b * x1) / det,
                            (a * x1 - b * x0) / det], dim=1)
    A, B, C, D, E, F, det = _adjugate3(parts)
    x0, x1, x2 = x[:, 0, :], x[:, 1, :], x[:, 2, :]
    return torch.stack([(A * x0 + B * x1 + C * x2) / det,
                        (B * x0 + D * x1 + E * x2) / det,
                        (C * x0 + E * x1 + F * x2) / det], dim=1)


def _matches3(mixture_prec, adj):
    """trace(prec @ sigma) over the symmetric entries, times det."""
    A, B, C, D, E, F = adj
    pr = mixture_prec[:, :, :, None]
    return (pr[:, 0, 0] * A + pr[:, 1, 1] * D + pr[:, 2, 2] * F
            + 2 * (pr[:, 0, 1] * B + pr[:, 0, 2] * C + pr[:, 1, 2] * E))


def make_summaries(mixture_prec, log_det_prior, diag_term):
    """Build the O(K*I) vi_sigma summaries. log_det_prior: [K]
    log-determinants of the prior covariances (-logdet(mixture_prec))."""
    P = mixture_prec.shape[1]
    if not _use_closed_form(P):
        K, I = mixture_prec.shape[0], diag_term.shape[1]
        log_det_sigma = diag_term.new_empty((K, I))
        diag = diag_term.new_empty((K, P, I))
        matches = diag_term.new_empty((K, I))
        fails = []
        for cols, L in _i_chunks(mixture_prec, diag_term, fails):
            sigma, log_det = _cholesky_inverse(L)
            log_det_sigma[:, cols] = log_det
            # trace(prec @ sigma)
            mt = 0.
            for p in range(P):
                diag[:, p, cols] = sigma[p][p]
                for q in range(P):
                    mt = mt + mixture_prec[:, q, p][:, None] * sigma[p][q]
            matches[:, cols] = mt
        check_cholesky(sum(fails))
        sigma_summary = log_det_prior[:, None] - log_det_sigma + matches
        return SigmaSummaries(log_det_sigma=log_det_sigma,
                              sigma_summary=sigma_summary, diag=diag,
                              matches=matches)
    parts = _precision_parts(mixture_prec, diag_term)
    if P == 1:
        (a,) = parts
        log_det_sigma = -torch.log(a)
        diag = (1.0 / a)[:, None, :]
        matches = mixture_prec[:, 0, 0][:, None] / a
    elif P == 2:
        a, b, d = parts
        det = a * d - b * b
        log_det_sigma = -torch.log(det)
        diag = torch.stack([d / det, a / det], dim=1)
        p00 = mixture_prec[:, 0, 0][:, None]
        p01 = mixture_prec[:, 0, 1][:, None]
        p11 = mixture_prec[:, 1, 1][:, None]
        matches = (p00 * d - 2 * p01 * b + p11 * a) / det
    else:
        A, B, C, D, E, F, det = _adjugate3(parts)
        log_det_sigma = -torch.log(det)
        diag = torch.stack([A, D, F], dim=1) / det[:, None, :]
        matches = _matches3(mixture_prec, (A, B, C, D, E, F)) / det
    sigma_summary = log_det_prior[:, None] - log_det_sigma + matches
    return SigmaSummaries(log_det_sigma=log_det_sigma,
                          sigma_summary=sigma_summary, diag=diag,
                          matches=matches)


@dataclass(frozen=True)
class CompactExprs:
    """Per-component closed forms of the compact [P, I] natural-mean
    state: mu[k] = vi_sigma[k] @ nat_mu; quad[k] = mu[k].nat_mu;
    quadform[k] = mu[k]' mixture_prec[k] mu[k]; the rest as in
    SigmaSummaries."""
    mu: torch.Tensor              # [K, P, I]
    diag: torch.Tensor            # [K, P, I]
    log_det_sigma: torch.Tensor   # [K, I]
    matches: torch.Tensor         # [K, I]
    quad: torch.Tensor            # [K, I]
    quadform: torch.Tensor        # [K, I]


def _nat_row(nat_mu, p):
    """Population-p rows of a natural mean, broadcastable over [K, I]:
    the shared [P, I] state gives a [1, I] row, the per-component
    [K, P, I] state of --learn-scaling fits (each error-scaling EM event
    re-bases the natural means k-dependently) a [K, I] one."""
    if nat_mu.dim() == 2:
        return nat_mu[p][None, :]
    return nat_mu[:, p, :]


def compact_exprs(mixture_prec, diag_term, nat_mu):
    """CompactExprs of a natural mean: the shared [P, I] state or the
    per-component [K, P, I] one (see `_nat_row`)."""
    P = mixture_prec.shape[1]
    if not _use_closed_form(P):
        raise NotImplementedError('compact expressions need the closed-'
                                  'form sigma algebra (P <= 3)')
    parts = _precision_parts(mixture_prec, diag_term)
    n = [_nat_row(nat_mu, p) for p in range(P)]
    if P == 1:
        (a,) = parts
        mu0 = n[0] / a
        p00 = mixture_prec[:, 0, 0][:, None]
        return CompactExprs(
            mu=mu0[:, None, :], diag=(1.0 / a)[:, None, :],
            log_det_sigma=-torch.log(a), matches=p00 / a,
            quad=n[0] * mu0, quadform=p00 * mu0 * mu0)
    if P == 2:
        a, b, d = parts
        det = a * d - b * b
        y0 = (d * n[0] - b * n[1]) / det
        y1 = (a * n[1] - b * n[0]) / det
        p00 = mixture_prec[:, 0, 0][:, None]
        p01 = mixture_prec[:, 0, 1][:, None]
        p11 = mixture_prec[:, 1, 1][:, None]
        return CompactExprs(
            mu=torch.stack([y0, y1], dim=1),
            diag=torch.stack([d / det, a / det], dim=1),
            log_det_sigma=-torch.log(det),
            matches=(p00 * d - 2 * p01 * b + p11 * a) / det,
            quad=y0 * n[0] + y1 * n[1],
            quadform=p00 * y0 * y0 + 2 * p01 * y0 * y1 + p11 * y1 * y1)
    A, B, C, D, E, F, det = _adjugate3(parts)
    y0 = (A * n[0] + B * n[1] + C * n[2]) / det
    y1 = (B * n[0] + D * n[1] + E * n[2]) / det
    y2 = (C * n[0] + E * n[1] + F * n[2]) / det
    pr = mixture_prec[:, :, :, None]
    quadform = (pr[:, 0, 0] * y0 * y0 + pr[:, 1, 1] * y1 * y1
                + pr[:, 2, 2] * y2 * y2
                + 2 * (pr[:, 0, 1] * y0 * y1 + pr[:, 0, 2] * y0 * y2
                       + pr[:, 1, 2] * y1 * y2))
    return CompactExprs(
        mu=torch.stack([y0, y1, y2], dim=1),
        diag=torch.stack([A, D, F], dim=1) / det[:, None, :],
        log_det_sigma=-torch.log(det),
        matches=_matches3(mixture_prec, (A, B, C, D, E, F)) / det,
        quad=y0 * n[0] + y1 * n[1] + y2 * n[2], quadform=quadform)


def compact_exprs_epochs(mixture_prec, diag_term, nat_u, hist_v,
                         hist_dterms, hist_c):
    """CompactExprs of the epoch-history state of --learn-scaling fits.

    The error-scaling EM re-basings telescope, so after E EM events the
    per-component natural means are implied by E + 1 shared [P, I]
    vectors, the scaling history and E coefficients:

        vi_mu_k = sum_e hist_c[e] * sigma_k^(e) @ hist_v[e]
                  + sigma_k^(cur) @ nat_u

    (see the JAX package's sigma.compact_exprs_epochs).

    Args:
        nat_u: [P, I] current-epoch accumulator.
        hist_v: [B, P, I] epoch vectors (slots past the live count carry
            hist_c == 0 and are inert).
        hist_dterms: [B, P, I] scaled_ld_diags / hist_scale per epoch.
        hist_c: [B] coefficients.
    """
    K = mixture_prec.shape[0]

    def bk(x):
        return x[None].expand((K,) + tuple(x.shape))

    mu = apply_sigma(mixture_prec, diag_term, bk(nat_u))
    for e in range(hist_v.shape[0]):
        mu = mu + hist_c[e] * apply_sigma(mixture_prec, hist_dterms[e],
                                          bk(hist_v[e]))
    nat = apply_precision(mixture_prec, diag_term, mu)
    s = make_summaries(mixture_prec, mu.new_zeros(K), diag_term)
    quad = torch.einsum('kpi,kpi->ki', mu, nat)
    quadform = torch.einsum('kpq,kpi,kqi->ki', mixture_prec, mu, mu)
    return CompactExprs(mu=mu, diag=s.diag, log_det_sigma=s.log_det_sigma,
                        matches=s.matches, quad=quad, quadform=quadform)


def sigma_weighted_sum(mixture_prec, diag_term, vi_delta):
    """sum_k vi_delta[k,i] * vi_sigma[k,:,:,i] -> [I,P,P] (used only at
    initialization, reference variational_inference.py:681-684)."""
    P = mixture_prec.shape[1]

    def w(x, delta=vi_delta):
        return torch.einsum('ki,ki->i', delta, x)

    if not _use_closed_form(P):
        out = diag_term.new_empty((diag_term.shape[1], P, P))
        fails = []
        for cols, L in _i_chunks(mixture_prec, diag_term, fails):
            sigma = _cholesky_inverse(L)[0]
            for p in range(P):
                for q in range(p, P):
                    out[cols, p, q] = out[cols, q, p] = w(
                        sigma[p][q], vi_delta[:, cols])
        check_cholesky(sum(fails))
        return out
    parts = _precision_parts(mixture_prec, diag_term)

    if P == 1:
        (a,) = parts
        return w(1.0 / a)[:, None, None]
    if P == 2:
        a, b, d = parts
        det = a * d - b * b
        s00, s01, s11 = w(d / det), w(-b / det), w(a / det)
        return torch.stack([torch.stack([s00, s01], dim=-1),
                            torch.stack([s01, s11], dim=-1)], dim=-2)
    A, B, C, D, E, F, det = _adjugate3(parts)
    s00, s01, s02 = w(A / det), w(B / det), w(C / det)
    s11, s12, s22 = w(D / det), w(E / det), w(F / det)
    return torch.stack([torch.stack([s00, s01, s02], dim=-1),
                        torch.stack([s01, s11, s12], dim=-1),
                        torch.stack([s02, s12, s22], dim=-1)], dim=-2)


def materialize_sigma(mixture_prec, diag_term):
    """Dense [K,P,P,I] vi_sigma, for output parity with the reference's
    saved `vi_sigma` array (vi_options.py:264) only: each precision
    block's inverse for P <= 3, as the JAX package takes it, the chunked
    Cholesky inverse beyond."""
    K, P, _ = mixture_prec.shape
    if _use_closed_form(P):
        eye = torch.eye(P, dtype=mixture_prec.dtype,
                        device=mixture_prec.device)
        prec = (mixture_prec[:, None, :, :]
                + eye * diag_term.T[None, :, :, None])       # [K, I, P, P]
        return torch.linalg.inv(prec).permute(0, 2, 3, 1)
    out = diag_term.new_empty((K, P, P, diag_term.shape[1]))
    fails = []
    for cols, L in _i_chunks(mixture_prec, diag_term, fails):
        sigma = _cholesky_inverse(L)[0]
        for p in range(P):
            for q in range(P):
                out[:, p, q, cols] = sigma[p][q]
    check_cholesky(sum(fails))
    return out
