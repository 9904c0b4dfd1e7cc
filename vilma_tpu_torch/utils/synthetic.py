"""Synthetic problem generation for benchmarks and scale tests.

Port of vilma_tpu/utils/synthetic.py: the same three functions, names,
arguments and numpy draws in the same order, plus `device` (the card
unless the caller asks for the CPU; without a card asking for it
raises). Dtypes are torch dtypes.

The LD blocks are factored where the matrix is packed for:

* on the CPU, each block by numpy's LAPACK eigh (lowrank.factor_block),
  the JAX package's own route, so the factors equal its factors;
* on a CUDA device, in float64 by batched torch.linalg.eigh on the card
  (set-up, not a kernel: the host's eigh of the 977 blocks of a 1M-SNP
  problem takes minutes), with factor_block's thresholds.

Eigenvector signs and column order may differ between the two routes;
the matrices they pack agree to rounding.
"""
import dataclasses
import math

import numpy as np
import torch

from vilma_tpu_torch.inference import engine
from vilma_tpu_torch.models import sigma as sigma_mod
from vilma_tpu_torch.ops import blocks, kernels, lowrank

# blocks factored by one batched eigh on the card (64 float64 blocks of
# 1024 SNPs: 512 MB of matrices)
_EIGH_BATCH = 64


def _np_dtype(dtype):
    return torch.empty(0, dtype=dtype).numpy().dtype


def _ar1_specs(num_loci, block_size, seed):
    """(start, size, rho) of each AR(1) block, one rho drawn per block in
    order."""
    rng = np.random.default_rng(seed)
    specs, start = [], 0
    while start < num_loci:
        n = min(block_size, num_loci - start)
        specs.append((start, n, rng.uniform(0.3, 0.95)))
        start += n
    return specs


def _truncate(f, rank_frac):
    """The top `rank_frac` of a factor's eigenpairs, largest first."""
    if rank_frac >= 1.0:
        return f
    r = max(1, int(f.r * rank_frac))
    order = np.argsort(f.s)[::-1][:r]
    return lowrank.LowRankFactor(u=f.u[:, order], s=f.s[order], d=f.d,
                                 rank=int(r))


def _host_factors(specs, rank_frac):
    for _, n, rho in specs:
        idx = np.abs(np.subtract.outer(np.arange(n), np.arange(n)))
        f = lowrank.factor_block(X=rho ** idx, t=1.0, check_symmetric=False)
        yield _truncate(f, rank_frac)


def _eigh_factor(vals, vecs):
    """lowrank.factor_block(X, t=1.0) of one block from its ascending
    eigenpairs (float64 tensors): keep the eigenvalues >= 0, then those
    above 1e-12 of the largest; the rank-0 sentinel if none remain."""
    n = vecs.shape[0]
    keep = vals >= 0.0
    if not bool(keep.any()):
        u, s = torch.ones((n, 1), dtype=vecs.dtype), vals.new_zeros(1)
    else:
        u, s = vecs[:, keep], vals[keep]
        big = s > 1e-12 * s.max()
        if bool(big.any()):
            u, s = u[:, big], s[big]
        else:
            u, s = u[:, :1], s.new_zeros(1)
    u = u.cpu().numpy()
    s = s.cpu().numpy()
    d = np.zeros(n)
    return lowrank.LowRankFactor(u=u, s=s, d=d, rank=lowrank._rank(u, s, d))


def _device_factors(specs, rank_frac, device):
    """_host_factors' factors from batched float64 eigh on `device`:
    blocks of one size go through torch.linalg.eigh _EIGH_BATCH at a
    time."""
    i = 0
    while i < len(specs):
        n = specs[i][1]
        j = i
        while j < len(specs) and j - i < _EIGH_BATCH and specs[j][1] == n:
            j += 1
        idx = torch.arange(n, device=device, dtype=torch.float64)
        lag = (idx[:, None] - idx[None, :]).abs()
        rho = torch.tensor([sp[2] for sp in specs[i:j]],
                           dtype=torch.float64, device=device)
        vals, vecs = torch.linalg.eigh(rho[:, None, None] ** lag[None])
        for b in range(j - i):
            yield _truncate(_eigh_factor(vals[b], vecs[b]), rank_frac)
        del vals, vecs
        i = j


def synthetic_factors(num_loci, block_size, rank_frac=1.0, seed=0,
                      device=None):
    """Yield (variant indices, LowRankFactor) of synthetic_ld's blocks in
    order, one block at a time (at most one batch of _EIGH_BATCH blocks
    on a CUDA device), factored as synthetic_ld factors them for
    `device`."""
    device = engine.resolve_device(device)
    specs = _ar1_specs(num_loci, block_size, seed)
    factors = (_host_factors(specs, rank_frac) if device.type == 'cpu'
               else _device_factors(specs, rank_frac, device))
    for (start, n, _), f in zip(specs, factors):
        yield np.arange(start, start + n), f


def synthetic_ld(num_loci, block_size, rank_frac=1.0, seed=0,
                 dtype=torch.float64, u_dtype=None, device=None):
    """A block-diagonal LD matrix of AR(1)-like correlation blocks, packed
    on `device` with eigenvalues in `dtype` and eigenvectors in `u_dtype`
    (default `dtype`; torch.bfloat16 for the bf16 panel)."""
    device = engine.resolve_device(device)
    indices, factors = zip(*synthetic_factors(num_loci, block_size,
                                              rank_frac, seed, device))
    return blocks.pack(list(factors), list(indices), num_loci, dtype=dtype,
                       u_dtype=u_dtype, device=device)


def synthetic_problem(num_loci=1024, num_pops=2, num_components=8,
                      block_size=128, num_annotations=1, seed=0,
                      scale_se=False, dtype=torch.float64, rank_frac=1.0,
                      device=None):
    """The port's ModelData of the JAX package's synthetic fit inputs."""
    device = engine.resolve_device(device)
    np_dtype = _np_dtype(dtype)
    rng = np.random.default_rng(seed)
    ld = synthetic_ld(num_loci, block_size, rank_frac=rank_frac, seed=seed,
                      dtype=dtype, device=device)
    std_errs = rng.uniform(0.01, 0.05, (num_pops, num_loci))
    betas = rng.standard_normal((num_pops, num_loci)) * std_errs * 2
    # exactly num_components mixture covariances (unlike the CLI grid,
    # which crosses variances x correlations into O(3K^2) components)
    scales = np.exp(np.linspace(np.log(1e-6), np.log(1e-2),
                                num_components))
    covs = []
    for k in range(num_components):
        a = rng.standard_normal((num_pops, num_pops))
        corr = 0.3 * (a @ a.T) + num_pops * np.eye(num_pops)
        d = 1 / np.sqrt(np.diag(corr))
        covs.append(scales[k] * (corr * np.outer(d, d)))
    annotations = np.zeros((num_loci, num_annotations))
    annotations[np.arange(num_loci),
                rng.integers(0, num_annotations, num_loci)] = 1
    return engine.build_model_data(
        betas.astype(np_dtype), std_errs.astype(np_dtype),
        [ld] * num_pops, annotations, covs, scaled=False, scale_se=scale_se,
        gwas_N=np.full(num_pops, 1e5), init_hg=np.full(num_pops, 0.3),
        dtype=dtype, device=device)


def synthetic_state(data, seed=0, compact=False, epoch_b=None):
    """A fresh VIState for `data` (random but well-formed), on its device.

    compact=True builds the shared [P, I] natural mean, or the kdim
    [K, P, I] one for a scale_se `data`; with epoch_b as well (scale_se
    only) the epoch-history state with a B = epoch_b buffer and no live
    epoch. compact=False builds the materialized state. The ELBO is the
    port's objective at the state (engine.state_elbo)."""
    P, I = data.marginal_effects.shape
    K = data.mixture_prec.shape[0]
    A = data.num_annotations
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.as_tensor(np.asarray(x)).to(
            dtype=data.marginal_effects.dtype,
            device=data.marginal_effects.device)

    def hyper():
        h = rng.uniform(0.1, 1.0, (A, K))
        return t(h / h.sum(axis=1, keepdims=True))

    common = dict(error_scaling=t(np.ones(P)), L=(1., 1., 1.), elbo=0.,
                  running_elbo_delta=math.nan, num_err=0)
    if compact and epoch_b and data.scale_se:
        hd = hyper()
        st = engine.VIState(
            nat_mu=t(rng.standard_normal((P, I)) * 1e-2), hyper_delta=hd,
            nat_hist=t(np.zeros((epoch_b, P, I))),
            nat_hist_scale=t(np.ones((epoch_b, P))),
            nat_hist_c=t(np.zeros(epoch_b)), nat_hist_n=0, **common)
    elif compact:
        # scale_se fits carry per-component [K, P, I] natural means
        # (engine.VIState); others share one [P, I] mean
        nat_shape = (K, P, I) if data.scale_se else (P, I)
        hd = hyper()
        st = engine.VIState(nat_mu=t(rng.standard_normal(nat_shape) * 1e-2),
                            hyper_delta=hd, **common)
    else:
        sig = sigma_mod.make_summaries(
            data.mixture_prec, data.log_det,
            engine._diag_term(data, common['error_scaling']))
        delta = rng.uniform(0.1, 1.0, (K, I))
        delta /= delta.sum(axis=0, keepdims=True)
        hd = hyper()
        st = engine.VIState(
            nat_mu=None, hyper_delta=hd,
            vi_mu=t(rng.standard_normal((K, P, I)) * 1e-3),
            vi_delta=t(delta), sigma=sig,
            nat_grad_vi_delta=kernels.fast_vi_delta_grad(
                hd, data.log_det, data.annotations), **common)
    return dataclasses.replace(st, elbo=engine.state_elbo(data, st))
