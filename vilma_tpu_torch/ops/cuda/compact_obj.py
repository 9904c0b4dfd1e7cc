"""Fused compact-objective prologue and annotation sums: wrappers of the
CUDA kernels in csrc/compact_obj.cu, with their plain PyTorch versions.

Replace vilma_tpu/ops/pallas/compact_obj.py::prologue (Pallas kernel
`_kernel` via `_derive_tile`) and ::delta_sums (`_sums_kernel`) for the
shared [P, I] natural mean (slice A). Per SNP and per mixture component
k: the closed-form (prec_k + diag(dterm))^-1 solve for P in {1, 2, 3},
then the softmax over K of z_k = 0.5 (quad_k - logdet_k) + scores[a, k]
clamped at eps, then

* prologue: post_means [P, I], post_vars [P, I] and the beta-KL scalar;
* delta_sums: S[a, k] = sum_{i: ann_i = a} vi_delta[k, i], [A, K].

Pad SNPs (annotation id == A) stay out of the KL and the sums. Their
selected scores read the last annotation column, as in the staged XLA
route (kernels.fast_vi_delta_grad); their moments are inert downstream.

The per-component [K, P, I] natural mean (`kdim`, --learn-scaling) and
the epoch-history kernels are not ported yet (ROADMAP queue 2).

On a CUDA tensor the wrappers launch the kernels or raise; on a CPU
tensor they run the plain versions. There is no fallback.
"""
import math

import torch

from vilma_tpu_torch.ops.cuda import build
from vilma_tpu_torch.utils.config import epsilon

#: launches of each CUDA kernel (plain-version calls do not count)
launches = {'prologue': 0, 'delta_sums': 0}

_THREADS = 256
_MAX_BLOCKS = 1024
# dynamic shared memory the kernels' component tiles may use
_SMEM_BYTES = 48 * 1024
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


def _derive_plain(coeffs, scores_t, ann, dterm, nat, eps):
    """Vectorized over [K, T]: the closed-form component algebra and the
    clamped full-logit softmax of compact_obj._derive_tile."""
    P = nat.shape[0]
    A = scores_t.shape[1]
    sel = scores_t[:, torch.clamp(ann.long(), max=A - 1)]       # [K, T]
    c = [coeffs[:, j:j + 1] for j in range(coeffs.shape[1])]
    n = [nat[p:p + 1] for p in range(P)]
    dt = [dterm[p:p + 1] for p in range(P)]
    if P == 1:
        a = c[0] + dt[0]
        ldp = c[1]
        inv = 1.0 / a
        y = [n[0] * inv]
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
        y = [(d * n[0] - b * n[1]) * inv, (a * n[1] - b * n[0]) * inv]
        diag = [d * inv, a * inv]
        logdet = torch.log(det)
        quadform = (c[0] * y[0] * y[0] + 2 * c[1] * y[0] * y[1]
                    + c[2] * y[1] * y[1])
        matches = (c[0] * d - 2 * c[1] * b + c[2] * a) * inv
    elif P == 3:
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
        y = [(A3 * n[0] + B3 * n[1] + C3 * n[2]) * inv,
             (B3 * n[0] + D3 * n[1] + E3 * n[2]) * inv,
             (C3 * n[0] + E3 * n[1] + F3 * n[2]) * inv]
        diag = [A3 * inv, D3 * inv, F3 * inv]
        logdet = torch.log(det)
        quadform = (c[0] * y[0] * y[0] + c[3] * y[1] * y[1]
                    + c[5] * y[2] * y[2]
                    + 2 * (c[1] * y[0] * y[1] + c[2] * y[0] * y[2]
                           + c[4] * y[1] * y[2]))
        matches = (c[0] * A3 + c[3] * D3 + c[5] * F3
                   + 2 * (c[1] * B3 + c[2] * C3 + c[4] * E3)) * inv
    else:
        raise NotImplementedError('the fused prologue covers P <= 3')
    quad = y[0] * n[0]
    for p in range(1, P):
        quad = quad + y[p] * n[p]
    z = 0.5 * (quad - logdet) + sel
    m = torch.amax(z, dim=0, keepdim=True)
    ez = torch.exp(z - m)
    den = torch.sum(ez, dim=0, keepdim=True)
    vd = torch.clamp(ez / den, min=eps)
    log_vd = torch.clamp(z - m - torch.log(den), min=math.log(eps))
    return dict(sel=sel, y=y, diag=diag, logdet=logdet, ldp=ldp,
                quadform=quadform, matches=matches, vd=vd, log_vd=log_vd)


def _plain_chunks(K, I):
    step = max(1, _PLAIN_CHUNK_ELEMS // max(K, 1))
    return [(i0, min(I, i0 + step)) for i0 in range(0, I, step)]


def prologue_plain(coeffs, scores_t, annotations, dterm, nat_mu, *,
                   num_annotations):
    """Plain PyTorch version of `prologue`, in SNP chunks."""
    P, I = nat_mu.shape
    K, A = scores_t.shape
    eps = epsilon(nat_mu.dtype)
    pm = torch.empty_like(nat_mu)
    pv = torch.empty_like(nat_mu)
    kl = nat_mu.new_zeros(())
    for i0, i1 in _plain_chunks(K, I):
        ann = annotations[i0:i1]
        d = _derive_plain(coeffs, scores_t, ann, dterm[:, i0:i1],
                          nat_mu[:, i0:i1], eps)
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


def delta_sums_plain(coeffs, scores_t, annotations, dterm, nat_mu, *,
                     num_annotations):
    """Plain PyTorch version of `delta_sums`, in SNP chunks: [A, K]."""
    P, I = nat_mu.shape
    K, A = scores_t.shape
    eps = epsilon(nat_mu.dtype)
    sums = nat_mu.new_zeros((K, A))
    ids = torch.arange(A, device=annotations.device)
    for i0, i1 in _plain_chunks(K, I):
        ann = annotations[i0:i1]
        vd = _derive_plain(coeffs, scores_t, ann, dterm[:, i0:i1],
                           nat_mu[:, i0:i1], eps)['vd']
        onehot = (ann[:, None] == ids[None, :]).to(vd.dtype)    # [T, A]
        sums = sums + vd @ onehot
    return sums.T


def _check_operands(name, coeffs, scores_t, annotations, dterm, nat_mu,
                    num_annotations):
    def require(cond, msg):
        if not cond:
            raise ValueError(f'{name}: {msg}')

    if nat_mu.dim() != 2:
        raise NotImplementedError(
            f'{name}: the per-component [K, P, I] natural mean (kdim, '
            '--learn-scaling) is not ported yet (ROADMAP.md queue 2)')
    P, I = nat_mu.shape
    K, A = scores_t.shape
    require(P in (1, 2, 3), f'P = {P} (the kernel covers 1..3)')
    require(A == num_annotations, 'scores_t must be [K, num_annotations]')
    ncol = P * (P + 1) // 2 + 1
    for arg, t, shape in (('coeffs', coeffs, (K, ncol)),
                          ('scores_t', scores_t, (K, A)),
                          ('dterm', dterm, (P, I)),
                          ('nat_mu', nat_mu, (P, I))):
        require(t.dtype == torch.float32,
                f'{arg} must be float32 on CUDA, got {t.dtype}')
        require(tuple(t.shape) == shape,
                f'{arg} has shape {tuple(t.shape)}, expected {shape}')
    require(annotations.dtype == torch.int32
            and tuple(annotations.shape) == (I,),
            'annotations must be int32 [I]')
    for arg, t in (('coeffs', coeffs), ('scores_t', scores_t),
                   ('annotations', annotations), ('dterm', dterm),
                   ('nat_mu', nat_mu)):
        require(t.device == nat_mu.device, f'{arg} must be on '
                f'{nat_mu.device}')
        require(t.is_contiguous(), f'{arg} must be contiguous')
    return P, I, K, A, ncol


def _launch_shape(I, K, A, ncol, sums):
    """(component tile width, grid blocks) for the kernels."""
    per_comp = ncol + A + (8 * A if sums else 0)
    kt = min(K, (_SMEM_BYTES // 4 - 8) // per_comp)
    if kt < 1:
        raise ValueError(f'{A} annotations exceed the kernel\'s shared-'
                         'memory tile')
    nblocks = max(1, min(-(-I // _THREADS), _MAX_BLOCKS))
    return kt, nblocks


def prologue(coeffs, scores_t, annotations, dterm, nat_mu, *,
             num_annotations):
    """Fused (post_means [P, I], post_vars [P, I], beta_kl scalar) of a
    compact parameter point.

    Args:
        coeffs: [K, ncol] (see `build_coeffs`).
        scores_t: [K, A] = (log hyper_delta - 0.5*log_det).T.
        annotations: [I] int32 ids (== num_annotations on pad slots).
        dterm: [P, I] = scaled_ld_diags / error_scaling.
        nat_mu: [P, I] compact natural mean.
    """
    if not nat_mu.is_cuda:
        return prologue_plain(coeffs, scores_t, annotations, dterm, nat_mu,
                              num_annotations=num_annotations)
    P, I, K, A, ncol = _check_operands('prologue', coeffs, scores_t,
                                       annotations, dterm, nat_mu,
                                       num_annotations)
    kt, nblocks = _launch_shape(I, K, A, ncol, sums=False)
    pm = torch.empty_like(nat_mu)
    pv = torch.empty_like(nat_mu)
    part = torch.empty(nblocks, dtype=torch.float32, device=nat_mu.device)
    kl = torch.empty((), dtype=torch.float32, device=nat_mu.device)
    eps = epsilon(torch.float32)
    status = build.library().vilma_compact_prologue(
        coeffs.data_ptr(), scores_t.data_ptr(), annotations.data_ptr(),
        dterm.data_ptr(), nat_mu.data_ptr(), pm.data_ptr(), pv.data_ptr(),
        part.data_ptr(), kl.data_ptr(), I, K, A, P, kt, nblocks, eps,
        math.log(eps), build.stream_handle(nat_mu.device))
    build.check(status, 'vilma_compact_prologue')
    launches['prologue'] += 1
    return pm, pv, kl


def delta_sums(coeffs, scores_t, annotations, dterm, nat_mu, *,
               num_annotations):
    """Per-annotation sums of the derived vi_delta: [A, K]."""
    if not nat_mu.is_cuda:
        return delta_sums_plain(coeffs, scores_t, annotations, dterm,
                                nat_mu, num_annotations=num_annotations)
    P, I, K, A, ncol = _check_operands('delta_sums', coeffs, scores_t,
                                       annotations, dterm, nat_mu,
                                       num_annotations)
    kt, nblocks = _launch_shape(I, K, A, ncol, sums=True)
    part = torch.zeros((nblocks, K, A), dtype=torch.float32,
                       device=nat_mu.device)
    out = torch.empty((K, A), dtype=torch.float32, device=nat_mu.device)
    eps = epsilon(torch.float32)
    status = build.library().vilma_compact_delta_sums(
        coeffs.data_ptr(), scores_t.data_ptr(), annotations.data_ptr(),
        dterm.data_ptr(), nat_mu.data_ptr(), part.data_ptr(),
        out.data_ptr(), I, K, A, P, kt, nblocks, eps, math.log(eps),
        build.stream_handle(nat_mu.device))
    build.check(status, 'vilma_compact_delta_sums')
    launches['delta_sums'] += 1
    return out.T
