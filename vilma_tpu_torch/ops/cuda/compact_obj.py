"""Fused compact-objective prologue and annotation sums: wrappers of the
CUDA kernels in csrc/compact_obj.cu and csrc/compact_obj_epochs.cu, with
their plain PyTorch versions.

Replace vilma_tpu/ops/pallas/compact_obj.py::prologue (Pallas kernel
`_kernel` via `_derive_tile`), ::delta_sums (`_sums_kernel`),
::prologue_epochs (`_epochs_kernel` via `_derive_tile_epochs`) and
::delta_sums_epochs (`_sums_epochs_kernel`). Per SNP and per mixture
component k: the closed-form (prec_k + diag(dterm))^-1 solve for P in
{1, 2, 3}, then the softmax over K of z_k = 0.5 (quad_k - logdet_k) +
scores[a, k] clamped at eps, then

* prologue: post_means [P, I], post_vars [P, I] and the beta-KL scalar;
* delta_sums: S[a, k] = sum_{i: ann_i = a} vi_delta[k, i], [A, K].

Three forms of the state feed them:

* the shared [P, I] natural mean (fits without --learn-scaling);
* kdim: the per-component [K, P, I] natural mean of --learn-scaling fits
  (`prologue`/`delta_sums` take it in place of the [P, I] one);
* epochs: the epoch-history state of large --learn-scaling fits
  (`prologue_epochs`/`delta_sums_epochs`).

Under component sharding (fit --mesh comp=M) each shard holds a slice of
the K components and the softmax over K is reduced across shards, as the
JAX package's K-chunked route reduces it over chunks
(vilma_tpu/inference/engine.py:873-1004, `_chunked_moments` and
`_delta_sums_chunked`). The K-split forms:

* `prologue_partial` / `prologue_epochs_partial`: each SNP's
  online-softmax accumulators over the slice, unnormalized, against the
  slice's own reference m: [3 + 2P, I] = (m, s0, q, sy[P], ssec[P]) with
  w_k = exp(z_k - m), s0 = sum w, q = sum w (z - m + g) (g the KL terms
  past the entropy), sy = sum w y, ssec = sum w (diag + y^2);
* `prologue_merge`: the M partials of one SNP column [M, 3 + 2P, I] ->
  (post_means, post_vars, beta_kl), each partial rescaled by
  exp(m_j - max m) and log S subtracted once per SNP;
* `delta_norm` / `delta_norm_epochs`: the sums' pass 1 over the slice,
  [2, I] = (m, s); `norm_merge`: [M, 2, I] -> the global (m, 1/S);
* `delta_sums_given` / `delta_sums_epochs_given`: the sums' pass 2 over
  the slice with that normalizer: [A, K_slice].

An unsharded fit (M = 1) launches the whole-K kernels alone.

Pad SNPs (annotation id == A) stay out of the KL and the sums. Their
selected scores read the last annotation column, as in the staged XLA
route (kernels.fast_vi_delta_grad); their moments are inert downstream.

On a CUDA tensor the wrappers launch the kernels or raise; on a CPU
tensor they run the plain versions. There is no fallback.
"""
import math

import torch

from vilma_tpu_torch.ops.cuda import build
from vilma_tpu_torch.utils.config import epsilon

#: launches of each CUDA kernel (plain-version calls do not count)
launches = {'prologue': 0, 'delta_sums': 0, 'prologue_kdim': 0,
            'delta_sums_kdim': 0, 'prologue_epochs': 0,
            'delta_sums_epochs': 0,
            # the K-split forms (component sharding)
            'prologue_partial': 0, 'prologue_kdim_partial': 0,
            'prologue_epochs_partial': 0, 'prologue_merge': 0,
            'delta_norm': 0, 'delta_norm_kdim': 0, 'delta_norm_epochs': 0,
            'norm_merge': 0, 'delta_sums_given': 0,
            'delta_sums_kdim_given': 0, 'delta_sums_epochs_given': 0}

_THREADS = 256
_WARPS = _THREADS // 32
_MAX_BLOCKS = 1024
# dynamic shared memory the prologues' component tiles may use; the sums
# may take up to the card's per-block limit to hold all of K in one tile
# beside their [K, A] partial
_SMEM_BYTES = 48 * 1024
_SMEM_MAX = 227 * 1024
# the sums stage the weights of this many components per SNP tile
# (csrc/compact_obj.cuh kChunk), rows of _THREADS + 1 floats
_CHUNK = 16
# plain version: SNP columns per chunk, bounding its [K, chunk]
# temporaries to ~2**26 elements each
_PLAIN_CHUNK_ELEMS = 1 << 26


def build_coeffs(mixture_prec, log_det):
    """[K, ncol] coefficient table: the upper triangle of each
    component's prior precision, then the prior log-determinant
    (ncol = 2, 4, 7 for P = 1, 2, 3)."""
    P = mixture_prec.shape[1]
    cols = [mixture_prec[:, p, q] for p in range(P) for q in range(p, P)]
    cols.append(log_det)
    return torch.stack(cols, dim=1)


def _coeff_cols(coeffs):
    return [coeffs[:, j:j + 1] for j in range(coeffs.shape[1])]


def _select_scores(scores_t, ann):
    """SEL[k, t] = scores_t[k, ann_t]; pad ids read column A-1."""
    A = scores_t.shape[1]
    return scores_t[:, torch.clamp(ann.long(), max=A - 1)]


def _sigma_apply(P, c, dt, n):
    """y = (prec_k + diag(dt))^-1 n, vectorized over [K, T]
    (compact_obj._sigma_apply)."""
    if P not in (1, 2, 3):
        raise NotImplementedError('the fused prologue covers P <= 3')
    if P == 1:
        return [n[0] * (1.0 / (c[0] + dt[0]))]
    if P == 2:
        a = c[0] + dt[0]
        b = c[1]
        d = c[2] + dt[1]
        inv = 1.0 / (a * d - b * b)
        return [(d * n[0] - b * n[1]) * inv, (a * n[1] - b * n[0]) * inv]
    pa = c[0] + dt[0]
    pb, pc = c[1], c[2]
    pd = c[3] + dt[1]
    pe = c[4]
    pf = c[5] + dt[2]
    A3 = pd * pf - pe * pe
    B3 = pc * pe - pb * pf
    C3 = pb * pe - pc * pd
    D3 = pa * pf - pc * pc
    E3 = pb * pc - pa * pe
    F3 = pa * pd - pb * pb
    inv = 1.0 / (pa * A3 + pb * B3 + pc * C3)
    return [(A3 * n[0] + B3 * n[1] + C3 * n[2]) * inv,
            (B3 * n[0] + D3 * n[1] + E3 * n[2]) * inv,
            (C3 * n[0] + E3 * n[1] + F3 * n[2]) * inv]


def _softmax(z, eps):
    m = torch.amax(z, dim=0, keepdim=True)
    ez = torch.exp(z - m)
    den = torch.sum(ez, dim=0, keepdim=True)
    vd = torch.clamp(ez / den, min=eps)
    log_vd = torch.clamp(z - m - torch.log(den), min=math.log(eps))
    return vd, log_vd


def _precision(P, c, dt):
    """Rows of the symmetric prec_k + diag(dt), [K, T] or [K, 1] each."""
    if P == 1:
        return [[c[0] + dt[0]]]
    if P == 2:
        return [[c[0] + dt[0], c[1]], [c[1], c[2] + dt[1]]]
    return [[c[0] + dt[0], c[1], c[2]], [c[1], c[3] + dt[1], c[4]],
            [c[2], c[4], c[5] + dt[2]]]


def _finish(P, c, dt, y, quad, sel, eps):
    """The current-scaling summaries of a component's mean y (diag,
    logdet, matches, quadform) and the clamped full-logit softmax of
    z = 0.5 (quad - logdet) + sel (compact_obj._derive_tile)."""
    if P == 1:
        a = c[0] + dt[0]
        ldp = c[1]
        inv = 1.0 / a
        diag = [inv]
        logdet = torch.log(a)
        quadform = c[0] * y[0] * y[0]
        matches = c[0] * inv
    elif P == 2:
        a = c[0] + dt[0]
        b = c[1]
        d = c[2] + dt[1]
        ldp = c[3]
        det = a * d - b * b
        inv = 1.0 / det
        diag = [d * inv, a * inv]
        logdet = torch.log(det)
        quadform = (c[0] * y[0] * y[0] + 2 * c[1] * y[0] * y[1]
                    + c[2] * y[1] * y[1])
        matches = (c[0] * d - 2 * c[1] * b + c[2] * a) * inv
    else:
        pa = c[0] + dt[0]
        pb, pc = c[1], c[2]
        pd = c[3] + dt[1]
        pe = c[4]
        pf = c[5] + dt[2]
        ldp = c[6]
        A3 = pd * pf - pe * pe
        B3 = pc * pe - pb * pf
        C3 = pb * pe - pc * pd
        D3 = pa * pf - pc * pc
        E3 = pb * pc - pa * pe
        F3 = pa * pd - pb * pb
        det = pa * A3 + pb * B3 + pc * C3
        inv = 1.0 / det
        diag = [A3 * inv, D3 * inv, F3 * inv]
        logdet = torch.log(det)
        quadform = (c[0] * y[0] * y[0] + c[3] * y[1] * y[1]
                    + c[5] * y[2] * y[2]
                    + 2 * (c[1] * y[0] * y[1] + c[2] * y[0] * y[2]
                           + c[4] * y[1] * y[2]))
        matches = (c[0] * A3 + c[3] * D3 + c[5] * F3
                   + 2 * (c[1] * B3 + c[2] * C3 + c[4] * E3)) * inv
    z = 0.5 * (quad - logdet) + sel
    vd, log_vd = _softmax(z, eps)
    return dict(sel=sel, y=y, diag=diag, logdet=logdet, ldp=ldp,
                quadform=quadform, matches=matches, z=z, vd=vd,
                log_vd=log_vd)


def _dot(u, v):
    out = u[0] * v[0]
    for p in range(1, len(u)):
        out = out + u[p] * v[p]
    return out


def _derive_plain(coeffs, scores_t, ann, dterm, nat, eps):
    """Vectorized over [K, T]: compact_obj._derive_tile. nat is the
    shared [P, T] natural mean or the per-component [K, P, T] one, whose
    [K, T] rows stand in for the broadcast [1, T] rows;
    y = sigma nat, quad = y . nat."""
    P = nat.shape[-2]
    c = _coeff_cols(coeffs)
    if nat.dim() == 3:
        n = [nat[:, p] for p in range(P)]
    else:
        n = [nat[p:p + 1] for p in range(P)]
    dt = [dterm[p:p + 1] for p in range(P)]
    y = _sigma_apply(P, c, dt, n)
    return _finish(P, c, dt, y, _dot(y, n), _select_scores(scores_t, ann),
                   eps)


def _derive_plain_epochs(coeffs, scores_t, ann, sld, u, hist, isc, hc, eps,
                         num_live):
    """Vectorized over [K, T]: compact_obj._derive_tile_epochs over the
    first `num_live` epochs (the slots past them are inert):
    y = sigma^cur u + sum_e c_e sigma^(e) v_e, quad = y . (prec + dt) y."""
    P = u.shape[0]
    c = _coeff_cols(coeffs)
    sl = [sld[p:p + 1] for p in range(P)]
    dt = [sl[p] * isc[0, p] for p in range(P)]
    y = _sigma_apply(P, c, dt, [u[p:p + 1] for p in range(P)])
    for e in range(num_live):
        dte = [sl[p] * isc[e + 1, p] for p in range(P)]
        ye = _sigma_apply(P, c, dte, [hist[e, p:p + 1] for p in range(P)])
        y = [y[p] + hc[e] * ye[p] for p in range(P)]
    nat = [_dot(row, y) for row in _precision(P, c, dt)]
    return _finish(P, c, dt, y, _dot(nat, y), _select_scores(scores_t, ann),
                   eps)


def _plain_chunks(K, I):
    step = max(1, _PLAIN_CHUNK_ELEMS // max(K, 1))
    return [(i0, min(I, i0 + step)) for i0 in range(0, I, step)]


def _moments_kl_plain(derive, P, I, K, annotations, num_annotations, like):
    """post_means, post_vars and the KL scalar from a per-chunk derive."""
    pm = like.new_empty((P, I))
    pv = like.new_empty((P, I))
    kl = like.new_zeros(())
    for i0, i1 in _plain_chunks(K, I):
        ann = annotations[i0:i1]
        d = derive(i0, i1)
        vd, y = d['vd'], d['y']
        for p in range(P):
            m1 = torch.sum(vd * y[p], dim=0)
            pm[p, i0:i1] = m1
            pv[p, i0:i1] = (torch.sum(vd * (d['diag'][p] + y[p] * y[p]),
                                      dim=0) - m1 * m1)
        log_hd = d['sel'] + 0.5 * d['ldp']
        ss = d['ldp'] + d['logdet'] + d['matches']
        per_k = vd * ((d['log_vd'] - log_hd) + 0.5 * d['quadform']
                      + 0.5 * ss)
        mask = (ann < num_annotations).to(per_k.dtype)[None, :]
        kl = kl + torch.sum(per_k * mask)
    return pm, pv, kl


def _sums_plain(derive, I, K, annotations, num_annotations, like):
    """[A, K] per-annotation sums of vi_delta from a per-chunk derive."""
    A = num_annotations
    sums = like.new_zeros((K, A))
    ids = torch.arange(A, device=annotations.device)
    for i0, i1 in _plain_chunks(K, I):
        vd = derive(i0, i1)['vd']
        onehot = (annotations[i0:i1, None] == ids[None, :]).to(vd.dtype)
        sums = sums + vd @ onehot
    return sums.T


def acc_rows(P):
    """Rows of a prologue partial per SNP: m, s0, q, sy[P], ssec[P]."""
    return 3 + 2 * P


def _partial_plain(derive, P, I, K, like):
    """The [3 + 2P, I] accumulators of a K slice from a per-chunk derive
    (against each SNP's max over the slice)."""
    acc = like.new_empty((acc_rows(P), I))
    for i0, i1 in _plain_chunks(K, I):
        d = derive(i0, i1)
        z = d['z']
        m = torch.amax(z, dim=0, keepdim=True)
        w = torch.exp(z - m)
        log_hd = d['sel'] + 0.5 * d['ldp']
        ss = d['ldp'] + d['logdet'] + d['matches']
        g = (z - m) + 0.5 * d['quadform'] + 0.5 * ss - log_hd
        acc[0, i0:i1] = m[0]
        acc[1, i0:i1] = torch.sum(w, dim=0)
        acc[2, i0:i1] = torch.sum(w * g, dim=0)
        for p in range(P):
            y = d['y'][p]
            acc[3 + p, i0:i1] = torch.sum(w * y, dim=0)
            acc[3 + P + p, i0:i1] = torch.sum(w * (d['diag'][p] + y * y),
                                              dim=0)
    return acc


def _norm_plain(derive, I, K, like):
    """[2, I] = (max, sum exp(z - max)) of a K slice's logits."""
    out = like.new_empty((2, I))
    for i0, i1 in _plain_chunks(K, I):
        z = derive(i0, i1)['z']
        m = torch.amax(z, dim=0, keepdim=True)
        out[0, i0:i1] = m[0]
        out[1, i0:i1] = torch.sum(torch.exp(z - m), dim=0)
    return out


def _sums_given_plain(derive, I, K, annotations, num_annotations, norm,
                      like):
    """[A, K] sums of the weights clamp(exp(z - m) / S, eps) with the
    global normalizer norm [2, I] = (m, 1/S)."""
    A = num_annotations
    eps = epsilon(like.dtype)
    sums = like.new_zeros((K, A))
    ids = torch.arange(A, device=annotations.device)
    for i0, i1 in _plain_chunks(K, I):
        z = derive(i0, i1)['z']
        vd = torch.clamp(torch.exp(z - norm[0:1, i0:i1]) * norm[1:2, i0:i1],
                         min=eps)
        onehot = (annotations[i0:i1, None] == ids[None, :]).to(vd.dtype)
        sums = sums + vd @ onehot
    return sums.T


def prologue_merge_plain(parts, annotations, *, num_annotations):
    """Plain PyTorch version of `prologue_merge`: [M, 3 + 2P, I]
    partials -> (post_means, post_vars, beta_kl)."""
    P = (parts.shape[1] - 3) // 2
    m = parts[:, 0]
    mx = torch.amax(m, dim=0)
    a = torch.exp(m - mx)                                   # [M, I]
    s0 = torch.sum(a * parts[:, 1], dim=0)
    q = torch.sum(a * (parts[:, 2] + (m - mx) * parts[:, 1]), dim=0)
    sy = torch.sum(a[:, None] * parts[:, 3:3 + P], dim=0)
    ssec = torch.sum(a[:, None] * parts[:, 3 + P:], dim=0)
    pm = sy / s0
    pv = ssec / s0 - pm * pm
    real = annotations < num_annotations
    kl = torch.sum(torch.where(real, q / s0 - torch.log(s0),
                               torch.zeros_like(s0)))
    return pm, pv, kl


def norm_merge_plain(parts):
    """Plain PyTorch version of `norm_merge`: [M, 2, I] -> [2, I] =
    (max m_j, 1 / sum_j s_j exp(m_j - max))."""
    mx = torch.amax(parts[:, 0], dim=0)
    s = torch.sum(parts[:, 1] * torch.exp(parts[:, 0] - mx), dim=0)
    return torch.stack([mx, 1.0 / s])


def prologue_plain(coeffs, scores_t, annotations, dterm, nat_mu, *,
                   num_annotations):
    """Plain PyTorch version of `prologue`, in SNP chunks."""
    P, I = nat_mu.shape[-2:]
    K = scores_t.shape[0]
    eps = epsilon(nat_mu.dtype)

    def derive(i0, i1):
        return _derive_plain(coeffs, scores_t, annotations[i0:i1],
                             dterm[:, i0:i1], nat_mu[..., i0:i1], eps)

    return _moments_kl_plain(derive, P, I, K, annotations, num_annotations,
                             nat_mu)


def delta_sums_plain(coeffs, scores_t, annotations, dterm, nat_mu, *,
                     num_annotations):
    """Plain PyTorch version of `delta_sums`, in SNP chunks: [A, K]."""
    I = nat_mu.shape[-1]
    K = scores_t.shape[0]
    eps = epsilon(nat_mu.dtype)

    def derive(i0, i1):
        return _derive_plain(coeffs, scores_t, annotations[i0:i1],
                             dterm[:, i0:i1], nat_mu[..., i0:i1], eps)

    return _sums_plain(derive, I, K, annotations, num_annotations, nat_mu)


def _deriver(coeffs, scores_t, annotations, dterm, nat_mu):
    eps = epsilon(nat_mu.dtype)

    def derive(i0, i1):
        return _derive_plain(coeffs, scores_t, annotations[i0:i1],
                             dterm[:, i0:i1], nat_mu[..., i0:i1], eps)

    return derive


def prologue_partial_plain(coeffs, scores_t, annotations, dterm, nat_mu, *,
                           num_annotations):
    """Plain PyTorch version of `prologue_partial`: [3 + 2P, I]."""
    P, I = nat_mu.shape[-2:]
    return _partial_plain(
        _deriver(coeffs, scores_t, annotations, dterm, nat_mu), P, I,
        scores_t.shape[0], nat_mu)


def delta_norm_plain(coeffs, scores_t, annotations, dterm, nat_mu, *,
                     num_annotations):
    """Plain PyTorch version of `delta_norm`: [2, I] = (m, s)."""
    return _norm_plain(
        _deriver(coeffs, scores_t, annotations, dterm, nat_mu),
        nat_mu.shape[-1], scores_t.shape[0], nat_mu)


def delta_sums_given_plain(coeffs, scores_t, annotations, dterm, nat_mu,
                           norm, *, num_annotations):
    """Plain PyTorch version of `delta_sums_given`: [A, K]."""
    return _sums_given_plain(
        _deriver(coeffs, scores_t, annotations, dterm, nat_mu),
        nat_mu.shape[-1], scores_t.shape[0], annotations, num_annotations,
        norm, nat_mu)


def _epoch_deriver(coeffs, scores_t, annotations, sld, nat_u, hist_v,
                   inv_scales, hist_c, num_live):
    eps = epsilon(nat_u.dtype)

    def derive(i0, i1):
        return _derive_plain_epochs(
            coeffs, scores_t, annotations[i0:i1], sld[:, i0:i1],
            nat_u[:, i0:i1], hist_v[..., i0:i1], inv_scales, hist_c, eps,
            num_live)

    return derive


def prologue_epochs_plain(coeffs, scores_t, annotations, sld, nat_u,
                          hist_v, inv_scales, hist_c, *, num_annotations,
                          num_live=None):
    """Plain PyTorch version of `prologue_epochs`, in SNP chunks."""
    P, I = nat_u.shape
    K = scores_t.shape[0]
    num_live = hist_v.shape[0] if num_live is None else num_live
    derive = _epoch_deriver(coeffs, scores_t, annotations, sld, nat_u,
                            hist_v, inv_scales, hist_c, num_live)
    return _moments_kl_plain(derive, P, I, K, annotations, num_annotations,
                             nat_u)


def delta_sums_epochs_plain(coeffs, scores_t, annotations, sld, nat_u,
                            hist_v, inv_scales, hist_c, *, num_annotations,
                            num_live=None):
    """Plain PyTorch version of `delta_sums_epochs`: [A, K]."""
    I = nat_u.shape[1]
    K = scores_t.shape[0]
    num_live = hist_v.shape[0] if num_live is None else num_live
    derive = _epoch_deriver(coeffs, scores_t, annotations, sld, nat_u,
                            hist_v, inv_scales, hist_c, num_live)
    return _sums_plain(derive, I, K, annotations, num_annotations, nat_u)


def prologue_epochs_partial_plain(coeffs, scores_t, annotations, sld, nat_u,
                                  hist_v, inv_scales, hist_c, *,
                                  num_annotations, num_live=None):
    """Plain PyTorch version of `prologue_epochs_partial`."""
    num_live = hist_v.shape[0] if num_live is None else num_live
    derive = _epoch_deriver(coeffs, scores_t, annotations, sld, nat_u,
                            hist_v, inv_scales, hist_c, num_live)
    return _partial_plain(derive, nat_u.shape[0], nat_u.shape[1],
                          scores_t.shape[0], nat_u)


def delta_norm_epochs_plain(coeffs, scores_t, annotations, sld, nat_u,
                            hist_v, inv_scales, hist_c, *, num_annotations,
                            num_live=None):
    """Plain PyTorch version of `delta_norm_epochs`: [2, I]."""
    num_live = hist_v.shape[0] if num_live is None else num_live
    derive = _epoch_deriver(coeffs, scores_t, annotations, sld, nat_u,
                            hist_v, inv_scales, hist_c, num_live)
    return _norm_plain(derive, nat_u.shape[1], scores_t.shape[0], nat_u)


def delta_sums_epochs_given_plain(coeffs, scores_t, annotations, sld, nat_u,
                                  hist_v, inv_scales, hist_c, norm, *,
                                  num_annotations, num_live=None):
    """Plain PyTorch version of `delta_sums_epochs_given`: [A, K]."""
    num_live = hist_v.shape[0] if num_live is None else num_live
    derive = _epoch_deriver(coeffs, scores_t, annotations, sld, nat_u,
                            hist_v, inv_scales, hist_c, num_live)
    return _sums_given_plain(derive, nat_u.shape[1], scores_t.shape[0],
                             annotations, num_annotations, norm, nat_u)


def _require(name, cond, msg):
    if not cond:
        raise ValueError(f'{name}: {msg}')


def _check_f32(name, operands, device):
    """Every operand float32 (int32 for annotations), dense row-major,
    on `device`, with the expected shape."""
    for arg, t, shape in operands:
        want = torch.int32 if arg == 'annotations' else torch.float32
        _require(name, t.dtype == want,
                 f'{arg} must be {want} on CUDA, got {t.dtype}')
        _require(name, tuple(t.shape) == shape,
                 f'{arg} has shape {tuple(t.shape)}, expected {shape}')
        _require(name, t.device == device, f'{arg} must be on {device}')
        _require(name, t.is_contiguous(), f'{arg} must be contiguous')


def _check_operands(name, coeffs, scores_t, annotations, dterm, nat_mu,
                    num_annotations):
    """(P, I, K, A, ncol) of a launch of `prologue`/`delta_sums`; raises
    on what the kernels do not take. nat_mu is [P, I] or, kdim, [K, P, I]."""
    _require(name, nat_mu.dim() in (2, 3),
             f'nat_mu must be [P, I] or [K, P, I], got {nat_mu.dim()} dims')
    P, I = nat_mu.shape[-2:]
    K, A = scores_t.shape
    _require(name, P in (1, 2, 3), f'P = {P} (the kernel covers 1..3)')
    _require(name, A == num_annotations,
             'scores_t must be [K, num_annotations]')
    ncol = P * (P + 1) // 2 + 1
    nat_shape = (P, I) if nat_mu.dim() == 2 else (K, P, I)
    _check_f32(name, (('coeffs', coeffs, (K, ncol)),
                      ('scores_t', scores_t, (K, A)),
                      ('annotations', annotations, (I,)),
                      ('dterm', dterm, (P, I)),
                      ('nat_mu', nat_mu, nat_shape)), nat_mu.device)
    return P, I, K, A, ncol


def _check_epoch_operands(name, coeffs, scores_t, annotations, sld, nat_u,
                          hist_v, inv_scales, hist_c, num_annotations,
                          num_live):
    """(P, I, K, A, ncol, B) of an epoch-kernel launch."""
    _require(name, hist_v.dim() == 3, 'hist_v must be [B, P, I]')
    B, P, I = hist_v.shape
    K, A = scores_t.shape
    _require(name, P in (1, 2, 3), f'P = {P} (the kernel covers 1..3)')
    _require(name, A == num_annotations,
             'scores_t must be [K, num_annotations]')
    _require(name, 0 <= num_live <= B,
             f'num_live = {num_live} outside 0..{B}')
    ncol = P * (P + 1) // 2 + 1
    _check_f32(name, (('coeffs', coeffs, (K, ncol)),
                      ('scores_t', scores_t, (K, A)),
                      ('annotations', annotations, (I,)),
                      ('sld', sld, (P, I)), ('nat_u', nat_u, (P, I)),
                      ('hist_v', hist_v, (B, P, I)),
                      ('inv_scales', inv_scales, (B + 1, P)),
                      ('hist_c', hist_c, (B,))), nat_u.device)
    return P, I, K, A, ncol, B


def _launch_shape(I, K, A, ncol, sums, table_floats=0):
    """(component tile width kt, component group kg, grid blocks) for the
    kernels; the shared memory past the [kt] tiles of coefficients and
    scores is counted as csrc/compact_obj.cuh extra_floats counts it. The
    prologues keep their tiles within 48 KB (kg = K, unused). The sums
    hold their CTA's [kg, A] partial beside the tile: all of K in one tile
    where it fits the card's per-block limit, else all of K in one group
    with narrower tiles, else groups of kg components (a multiple of kt)
    whose partial fits. Raises only if one component row does not fit."""
    per_comp = ncol + A
    nblocks = max(1, min(-(-I // _THREADS), _MAX_BLOCKS))
    if not sums:
        kt = min(K, (_SMEM_BYTES // 4 - _WARPS - table_floats) // per_comp)
        kg = K
    else:
        room = (_SMEM_MAX // 4 - _CHUNK * (_THREADS + 1) - (A + 1) * _WARPS
                - A - 2 - table_floats)
        if K * (per_comp + A) <= room:
            kt = kg = K
        elif K * A + per_comp <= room:
            kg = K
            kt = (room - K * A) // per_comp
        else:
            kt = min(K, max(1, room // (4 * per_comp)))
            while kt > 1 and (room - kt * per_comp) // A < kt:
                kt //= 2
            kg = min(K, (room - kt * per_comp) // A // kt * kt)
    if min(kt, kg) < 1:
        raise ValueError(f'{A} annotations exceed the kernel\'s shared-'
                         'memory tile')
    return kt, kg, nblocks


def _sums_scratch(nblocks, K, A, I, kg, dev):
    """The sums' per-CTA partials [nblocks, K, A] (every one written) and,
    when K is taken in groups, each SNP's pass-1 max and 1/normalizer
    [2, I] (else None)."""
    part = torch.empty((nblocks, K, A), dtype=torch.float32, device=dev)
    norm = (torch.empty((2, I), dtype=torch.float32, device=dev)
            if kg < K else None)
    return part, norm


@build.on_operands_device
def prologue(coeffs, scores_t, annotations, dterm, nat_mu, *,
             num_annotations):
    """Fused (post_means [P, I], post_vars [P, I], beta_kl scalar) of a
    compact parameter point.

    Args:
        coeffs: [K, ncol] (see `build_coeffs`).
        scores_t: [K, A] = (log hyper_delta - 0.5*log_det).T.
        annotations: [I] int32 ids (== num_annotations on pad slots).
        dterm: [P, I] = scaled_ld_diags / error_scaling.
        nat_mu: [P, I] shared natural mean, or the [K, P, I]
            per-component one (kdim, --learn-scaling).
    """
    if not nat_mu.is_cuda:
        return prologue_plain(coeffs, scores_t, annotations, dterm, nat_mu,
                              num_annotations=num_annotations)
    P, I, K, A, ncol = _check_operands('prologue', coeffs, scores_t,
                                       annotations, dterm, nat_mu,
                                       num_annotations)
    kdim = nat_mu.dim() == 3
    kt, _, nblocks = _launch_shape(I, K, A, ncol, sums=False)
    dev = nat_mu.device
    pm = torch.empty((P, I), dtype=torch.float32, device=dev)
    pv = torch.empty((P, I), dtype=torch.float32, device=dev)
    part = torch.empty(nblocks, dtype=torch.float32, device=dev)
    kl = torch.empty((), dtype=torch.float32, device=dev)
    eps = epsilon(torch.float32)
    entry = ('vilma_compact_prologue_kdim' if kdim
             else 'vilma_compact_prologue')
    status = getattr(build.library(), entry)(
        coeffs.data_ptr(), scores_t.data_ptr(), annotations.data_ptr(),
        dterm.data_ptr(), nat_mu.data_ptr(), pm.data_ptr(), pv.data_ptr(),
        part.data_ptr(), kl.data_ptr(), I, K, A, P, kt, nblocks, eps,
        build.stream_handle(dev))
    build.check(status, entry)
    launches['prologue_kdim' if kdim else 'prologue'] += 1
    return pm, pv, kl


@build.on_operands_device
def delta_sums(coeffs, scores_t, annotations, dterm, nat_mu, *,
               num_annotations):
    """Per-annotation sums of the derived vi_delta: [A, K]. nat_mu as in
    `prologue`."""
    if not nat_mu.is_cuda:
        return delta_sums_plain(coeffs, scores_t, annotations, dterm,
                                nat_mu, num_annotations=num_annotations)
    P, I, K, A, ncol = _check_operands('delta_sums', coeffs, scores_t,
                                       annotations, dterm, nat_mu,
                                       num_annotations)
    kdim = nat_mu.dim() == 3
    kt, kg, nblocks = _launch_shape(I, K, A, ncol, sums=True)
    dev = nat_mu.device
    part, norm = _sums_scratch(nblocks, K, A, I, kg, dev)
    out = torch.empty((K, A), dtype=torch.float32, device=dev)
    eps = epsilon(torch.float32)
    entry = ('vilma_compact_delta_sums_kdim' if kdim
             else 'vilma_compact_delta_sums')
    status = getattr(build.library(), entry)(
        coeffs.data_ptr(), scores_t.data_ptr(), annotations.data_ptr(),
        dterm.data_ptr(), nat_mu.data_ptr(), part.data_ptr(),
        None if norm is None else norm.data_ptr(), out.data_ptr(), I, K, A,
        P, kt, kg, nblocks, eps, build.stream_handle(dev))
    build.check(status, entry)
    launches['delta_sums_kdim' if kdim else 'delta_sums'] += 1
    return out.T


@build.on_operands_device
def prologue_epochs(coeffs, scores_t, annotations, sld, nat_u, hist_v,
                    inv_scales, hist_c, *, num_annotations, num_live=None):
    """Fused (post_means, post_vars, beta_kl) of an epoch-history
    parameter point (sigma.compact_exprs_epochs semantics).

    Args beyond `prologue`'s: sld [P, I] raw scaled_ld_diags; nat_u
    [P, I] current-epoch accumulator; hist_v [B, P, I]; inv_scales
    [B+1, P] (row 0 = 1/current error_scaling, row e+1 = 1/epoch-e
    scaling); hist_c [B] coefficients; num_live: the live epochs (the
    slots past them must be inert: zero vectors, c 0, scale 1), all B
    by default."""
    num_live = hist_v.shape[0] if num_live is None else int(num_live)
    if not nat_u.is_cuda:
        return prologue_epochs_plain(
            coeffs, scores_t, annotations, sld, nat_u, hist_v, inv_scales,
            hist_c, num_annotations=num_annotations, num_live=num_live)
    P, I, K, A, ncol, _ = _check_epoch_operands(
        'prologue_epochs', coeffs, scores_t, annotations, sld, nat_u,
        hist_v, inv_scales, hist_c, num_annotations, num_live)
    kt, _, nblocks = _launch_shape(I, K, A, ncol, sums=False,
                                   table_floats=(num_live + 1) * P + num_live)
    dev = nat_u.device
    pm = torch.empty((P, I), dtype=torch.float32, device=dev)
    pv = torch.empty((P, I), dtype=torch.float32, device=dev)
    part = torch.empty(nblocks, dtype=torch.float32, device=dev)
    kl = torch.empty((), dtype=torch.float32, device=dev)
    eps = epsilon(torch.float32)
    status = build.library().vilma_compact_prologue_epochs(
        coeffs.data_ptr(), scores_t.data_ptr(), annotations.data_ptr(),
        sld.data_ptr(), nat_u.data_ptr(), hist_v.data_ptr(),
        inv_scales.data_ptr(), hist_c.data_ptr(), pm.data_ptr(),
        pv.data_ptr(), part.data_ptr(), kl.data_ptr(), I, K, A, P,
        num_live, kt, nblocks, eps, build.stream_handle(dev))
    build.check(status, 'vilma_compact_prologue_epochs')
    launches['prologue_epochs'] += 1
    return pm, pv, kl


@build.on_operands_device
def delta_sums_epochs(coeffs, scores_t, annotations, sld, nat_u, hist_v,
                      inv_scales, hist_c, *, num_annotations, num_live=None):
    """Per-annotation sums of the derived vi_delta for the epoch state:
    [A, K] (operands as in `prologue_epochs`)."""
    num_live = hist_v.shape[0] if num_live is None else int(num_live)
    if not nat_u.is_cuda:
        return delta_sums_epochs_plain(
            coeffs, scores_t, annotations, sld, nat_u, hist_v, inv_scales,
            hist_c, num_annotations=num_annotations, num_live=num_live)
    P, I, K, A, ncol, _ = _check_epoch_operands(
        'delta_sums_epochs', coeffs, scores_t, annotations, sld, nat_u,
        hist_v, inv_scales, hist_c, num_annotations, num_live)
    kt, kg, nblocks = _launch_shape(
        I, K, A, ncol, sums=True, table_floats=(num_live + 1) * P + num_live)
    dev = nat_u.device
    part, norm = _sums_scratch(nblocks, K, A, I, kg, dev)
    out = torch.empty((K, A), dtype=torch.float32, device=dev)
    eps = epsilon(torch.float32)
    status = build.library().vilma_compact_delta_sums_epochs(
        coeffs.data_ptr(), scores_t.data_ptr(), annotations.data_ptr(),
        sld.data_ptr(), nat_u.data_ptr(), hist_v.data_ptr(),
        inv_scales.data_ptr(), hist_c.data_ptr(), part.data_ptr(),
        None if norm is None else norm.data_ptr(), out.data_ptr(), I, K, A,
        P, num_live, kt, kg, nblocks, eps, build.stream_handle(dev))
    build.check(status, 'vilma_compact_delta_sums_epochs')
    launches['delta_sums_epochs'] += 1
    return out.T


# ---------------------------------------------------------------------------
# K-split forms (component sharding): see the module docstring
# ---------------------------------------------------------------------------

def _nblocks(I):
    return max(1, min(-(-I // _THREADS), _MAX_BLOCKS))


@build.on_operands_device
def prologue_partial(coeffs, scores_t, annotations, dterm, nat_mu, *,
                     num_annotations):
    """The [3 + 2P, I] prologue accumulators of a slice of K (coeffs and
    scores_t hold the slice's rows; a kdim nat_mu its [K_slice, P, I]
    rows), for `prologue_merge`. Operands as in `prologue`."""
    if not nat_mu.is_cuda:
        return prologue_partial_plain(coeffs, scores_t, annotations, dterm,
                                      nat_mu, num_annotations=num_annotations)
    P, I, K, A, ncol = _check_operands('prologue_partial', coeffs, scores_t,
                                       annotations, dterm, nat_mu,
                                       num_annotations)
    kdim = nat_mu.dim() == 3
    kt, _, nblocks = _launch_shape(I, K, A, ncol, sums=False)
    dev = nat_mu.device
    acc = torch.empty((acc_rows(P), I), dtype=torch.float32, device=dev)
    entry = ('vilma_compact_prologue_kdim_partial' if kdim
             else 'vilma_compact_prologue_partial')
    status = getattr(build.library(), entry)(
        coeffs.data_ptr(), scores_t.data_ptr(), annotations.data_ptr(),
        dterm.data_ptr(), nat_mu.data_ptr(), acc.data_ptr(), I, K, A, P, kt,
        nblocks, epsilon(torch.float32), build.stream_handle(dev))
    build.check(status, entry)
    launches['prologue_kdim_partial' if kdim else 'prologue_partial'] += 1
    return acc


@build.on_operands_device
def prologue_epochs_partial(coeffs, scores_t, annotations, sld, nat_u,
                            hist_v, inv_scales, hist_c, *, num_annotations,
                            num_live=None):
    """The [3 + 2P, I] prologue accumulators of a slice of K on the epoch
    state (operands as in `prologue_epochs`)."""
    num_live = hist_v.shape[0] if num_live is None else int(num_live)
    if not nat_u.is_cuda:
        return prologue_epochs_partial_plain(
            coeffs, scores_t, annotations, sld, nat_u, hist_v, inv_scales,
            hist_c, num_annotations=num_annotations, num_live=num_live)
    P, I, K, A, ncol, _ = _check_epoch_operands(
        'prologue_epochs_partial', coeffs, scores_t, annotations, sld, nat_u,
        hist_v, inv_scales, hist_c, num_annotations, num_live)
    kt, _, nblocks = _launch_shape(I, K, A, ncol, sums=False,
                                   table_floats=(num_live + 1) * P + num_live)
    dev = nat_u.device
    acc = torch.empty((acc_rows(P), I), dtype=torch.float32, device=dev)
    status = build.library().vilma_compact_prologue_epochs_partial(
        coeffs.data_ptr(), scores_t.data_ptr(), annotations.data_ptr(),
        sld.data_ptr(), nat_u.data_ptr(), hist_v.data_ptr(),
        inv_scales.data_ptr(), hist_c.data_ptr(), acc.data_ptr(), I, K, A, P,
        num_live, kt, nblocks, epsilon(torch.float32),
        build.stream_handle(dev))
    build.check(status, 'vilma_compact_prologue_epochs_partial')
    launches['prologue_epochs_partial'] += 1
    return acc


@build.on_operands_device
def prologue_merge(parts, annotations, *, num_annotations):
    """(post_means [P, I], post_vars [P, I], beta_kl) from the M prologue
    partials [M, 3 + 2P, I] of one SNP column, in comp order."""
    if not parts.is_cuda:
        return prologue_merge_plain(parts, annotations,
                                    num_annotations=num_annotations)
    _require('prologue_merge', parts.dim() == 3,
             'parts must be [M, 3 + 2P, I]')
    M, rows, I = parts.shape
    P = (rows - 3) // 2
    _require('prologue_merge', P in (1, 2, 3) and rows == acc_rows(P),
             f'{rows} accumulator rows (3 + 2P for P in 1..3)')
    _check_f32('prologue_merge', (('parts', parts, (M, rows, I)),
                                  ('annotations', annotations, (I,))),
               parts.device)
    nblocks = _nblocks(I)
    dev = parts.device
    pm = torch.empty((P, I), dtype=torch.float32, device=dev)
    pv = torch.empty((P, I), dtype=torch.float32, device=dev)
    part = torch.empty(nblocks, dtype=torch.float32, device=dev)
    kl = torch.empty((), dtype=torch.float32, device=dev)
    status = build.library().vilma_compact_merge(
        parts.data_ptr(), annotations.data_ptr(), pm.data_ptr(),
        pv.data_ptr(), part.data_ptr(), kl.data_ptr(), I, M,
        num_annotations, P, nblocks, build.stream_handle(dev))
    build.check(status, 'vilma_compact_merge')
    launches['prologue_merge'] += 1
    return pm, pv, kl


@build.on_operands_device
def delta_norm(coeffs, scores_t, annotations, dterm, nat_mu, *,
               num_annotations):
    """The sums' pass 1 over a slice of K: [2, I] = (max, normalizer) of
    each SNP's logits over the slice (operands as in `prologue_partial`)."""
    if not nat_mu.is_cuda:
        return delta_norm_plain(coeffs, scores_t, annotations, dterm, nat_mu,
                                num_annotations=num_annotations)
    P, I, K, A, ncol = _check_operands('delta_norm', coeffs, scores_t,
                                       annotations, dterm, nat_mu,
                                       num_annotations)
    kdim = nat_mu.dim() == 3
    kt, _, nblocks = _launch_shape(I, K, A, ncol, sums=False)
    dev = nat_mu.device
    norm = torch.empty((2, I), dtype=torch.float32, device=dev)
    entry = ('vilma_compact_delta_norm_kdim' if kdim
             else 'vilma_compact_delta_norm')
    status = getattr(build.library(), entry)(
        coeffs.data_ptr(), scores_t.data_ptr(), annotations.data_ptr(),
        dterm.data_ptr(), nat_mu.data_ptr(), norm.data_ptr(), I, K, A, P, kt,
        nblocks, epsilon(torch.float32), build.stream_handle(dev))
    build.check(status, entry)
    launches['delta_norm_kdim' if kdim else 'delta_norm'] += 1
    return norm


@build.on_operands_device
def delta_norm_epochs(coeffs, scores_t, annotations, sld, nat_u, hist_v,
                      inv_scales, hist_c, *, num_annotations, num_live=None):
    """`delta_norm` on the epoch state: [2, I]."""
    num_live = hist_v.shape[0] if num_live is None else int(num_live)
    if not nat_u.is_cuda:
        return delta_norm_epochs_plain(
            coeffs, scores_t, annotations, sld, nat_u, hist_v, inv_scales,
            hist_c, num_annotations=num_annotations, num_live=num_live)
    P, I, K, A, ncol, _ = _check_epoch_operands(
        'delta_norm_epochs', coeffs, scores_t, annotations, sld, nat_u,
        hist_v, inv_scales, hist_c, num_annotations, num_live)
    kt, _, nblocks = _launch_shape(I, K, A, ncol, sums=False,
                                   table_floats=(num_live + 1) * P + num_live)
    dev = nat_u.device
    norm = torch.empty((2, I), dtype=torch.float32, device=dev)
    status = build.library().vilma_compact_delta_norm_epochs(
        coeffs.data_ptr(), scores_t.data_ptr(), annotations.data_ptr(),
        sld.data_ptr(), nat_u.data_ptr(), hist_v.data_ptr(),
        inv_scales.data_ptr(), hist_c.data_ptr(), norm.data_ptr(), I, K, A, P,
        num_live, kt, nblocks, epsilon(torch.float32),
        build.stream_handle(dev))
    build.check(status, 'vilma_compact_delta_norm_epochs')
    launches['delta_norm_epochs'] += 1
    return norm


@build.on_operands_device
def norm_merge(parts):
    """The global normalizer [2, I] = (m, 1/S) from the M pass-1 partials
    [M, 2, I] of one SNP column, in comp order."""
    if not parts.is_cuda:
        return norm_merge_plain(parts)
    _require('norm_merge', parts.dim() == 3 and parts.shape[1] == 2,
             'parts must be [M, 2, I]')
    M, _, I = parts.shape
    _check_f32('norm_merge', (('parts', parts, (M, 2, I)),), parts.device)
    dev = parts.device
    norm = torch.empty((2, I), dtype=torch.float32, device=dev)
    status = build.library().vilma_compact_norm_merge(
        parts.data_ptr(), norm.data_ptr(), I, M, _nblocks(I),
        build.stream_handle(dev))
    build.check(status, 'vilma_compact_norm_merge')
    launches['norm_merge'] += 1
    return norm


def _check_norm(name, norm, I, device):
    _check_f32(name, (('norm', norm, (2, I)),), device)


@build.on_operands_device
def delta_sums_given(coeffs, scores_t, annotations, dterm, nat_mu, norm, *,
                     num_annotations):
    """The sums' pass 2 over a slice of K with the global normalizer norm
    [2, I] = (m, 1/S) (`norm_merge`): [A, K_slice]."""
    if not nat_mu.is_cuda:
        return delta_sums_given_plain(coeffs, scores_t, annotations, dterm,
                                      nat_mu, norm,
                                      num_annotations=num_annotations)
    P, I, K, A, ncol = _check_operands('delta_sums_given', coeffs, scores_t,
                                       annotations, dterm, nat_mu,
                                       num_annotations)
    _check_norm('delta_sums_given', norm, I, nat_mu.device)
    kdim = nat_mu.dim() == 3
    kt, kg, nblocks = _launch_shape(I, K, A, ncol, sums=True)
    dev = nat_mu.device
    part, _ = _sums_scratch(nblocks, K, A, I, K, dev)
    out = torch.empty((K, A), dtype=torch.float32, device=dev)
    entry = ('vilma_compact_delta_sums_kdim_given' if kdim
             else 'vilma_compact_delta_sums_given')
    status = getattr(build.library(), entry)(
        coeffs.data_ptr(), scores_t.data_ptr(), annotations.data_ptr(),
        dterm.data_ptr(), nat_mu.data_ptr(), part.data_ptr(),
        norm.data_ptr(), out.data_ptr(), I, K, A, P, kt, kg, nblocks,
        epsilon(torch.float32), build.stream_handle(dev))
    build.check(status, entry)
    launches['delta_sums_kdim_given' if kdim else 'delta_sums_given'] += 1
    return out.T


@build.on_operands_device
def delta_sums_epochs_given(coeffs, scores_t, annotations, sld, nat_u,
                            hist_v, inv_scales, hist_c, norm, *,
                            num_annotations, num_live=None):
    """`delta_sums_given` on the epoch state: [A, K_slice]."""
    num_live = hist_v.shape[0] if num_live is None else int(num_live)
    if not nat_u.is_cuda:
        return delta_sums_epochs_given_plain(
            coeffs, scores_t, annotations, sld, nat_u, hist_v, inv_scales,
            hist_c, norm, num_annotations=num_annotations, num_live=num_live)
    P, I, K, A, ncol, _ = _check_epoch_operands(
        'delta_sums_epochs_given', coeffs, scores_t, annotations, sld, nat_u,
        hist_v, inv_scales, hist_c, num_annotations, num_live)
    _check_norm('delta_sums_epochs_given', norm, I, nat_u.device)
    kt, kg, nblocks = _launch_shape(
        I, K, A, ncol, sums=True, table_floats=(num_live + 1) * P + num_live)
    dev = nat_u.device
    part, _ = _sums_scratch(nblocks, K, A, I, K, dev)
    out = torch.empty((K, A), dtype=torch.float32, device=dev)
    status = build.library().vilma_compact_delta_sums_epochs_given(
        coeffs.data_ptr(), scores_t.data_ptr(), annotations.data_ptr(),
        sld.data_ptr(), nat_u.data_ptr(), hist_v.data_ptr(),
        inv_scales.data_ptr(), hist_c.data_ptr(), part.data_ptr(),
        norm.data_ptr(), out.data_ptr(), I, K, A, P, num_live, kt, kg,
        nblocks, epsilon(torch.float32), build.stream_handle(dev))
    build.check(status, 'vilma_compact_delta_sums_epochs_given')
    launches['delta_sums_epochs_given'] += 1
    return out.T
