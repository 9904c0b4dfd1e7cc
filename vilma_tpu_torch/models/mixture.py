"""Construction of the mixture-of-Gaussians prior covariance grid.

A copy of vilma_tpu/models/mixture.py (numpy only; `vilma_tpu.models`
imports jax on import). The global-RNG call order is unchanged, so a
seeded fit draws the same grid in both packages.

Host-side (numpy) so that seeded runs draw the identical RNG stream as the
reference (reference vi_options.py:284-337 uses the global numpy RNG after
np.random.seed(args.seed); stream order matters for golden parity).

The grid: a near-zero component, a log-spaced variance ladder between
data-driven minimum/maximum effect sizes, crossed with a correlation grid
and three random diagonal rescalings, plus population-specific-causal
components (see SURVEY.md section 2.5).
"""
import itertools

import numpy as np


def make_diag_vals(num_pops, num_components, mins, maxes):
    """Log-spaced per-population variance ladder (vi_options.py:284-298)."""
    diag_vals = [[m * 1e-6 for m in mins]]
    for k in range(num_components + 1):
        this_diag = []
        for population in range(num_pops):
            this_diag.append(
                mins[population]
                * np.exp(np.log(maxes[population] / mins[population])
                         / num_components * k)
            )
        diag_vals.append(this_diag)
    return diag_vals


def make_simple(num_pops, num_components, mins, maxes,
                drop_non_psd=False):
    """Full covariance grid (vi_options.py:301-337).

    Draws from the global numpy RNG (three diagonal rescalings per grid
    point) in the same order as the reference so seeded runs match.

    drop_non_psd: at 3+ cohorts the reference's grid is infeasible as
    specified — it products the pairwise correlations independently
    (vi_options.py:309-310), so combinations like (rho12, rho13, rho23)
    = (0.99, 0.99, -0.99) produce non-positive-definite matrices, which
    its own validation then rejects (variational_inference.py:610-613):
    the reference CLI cannot actually run a 3-cohort fit with its
    default grid. With drop_non_psd=True the full grid is drawn first
    (identical RNG stream — filtering consumes no draws) and the
    non-PSD members are then removed, making multi-cohort grids
    runnable. Default False preserves exact reference behavior.
    """
    cross_pop_covs = []
    diag_vals = make_diag_vals(num_pops, num_components, mins, maxes)
    if num_pops == 1:
        return list(np.array(diag_vals).reshape((num_components + 2,
                                                 num_pops, num_pops)))
    corr_vals = [-.99 + 1.98 * (k + 1) / num_components
                 for k in range(num_components)]
    for idx, diag in enumerate(diag_vals):
        for off_diags in itertools.product(
                *[corr_vals] * ((num_pops * (num_pops - 1)) // 2)):
            mat = np.eye(num_pops)
            mat[np.triu_indices_from(mat, k=1)] = off_diags
            mat.T[np.triu_indices_from(mat, k=1)] = off_diags
            mat = mat * np.sqrt(diag)
            mat = mat.T * np.sqrt(diag)
            for _ in range(3):
                scale = np.diag(
                    np.sqrt(np.exp(np.random.uniform(-1, 1, num_pops))))
                cross_pop_covs.append(scale.dot(mat.dot(scale)))
        if idx > 0:
            # population-specific causal components
            for population in range(num_pops):
                single_pop = np.copy(diag_vals[0])
                single_pop[population] = diag[population]
                mat = np.diag(single_pop)
                for _ in range(3):
                    scale = np.diag(
                        np.sqrt(np.exp(np.random.uniform(-1, 1, num_pops))))
                    cross_pop_covs.append(scale.dot(mat.dot(scale)))
    if drop_non_psd:
        # eigvalsh, not slogdet-sign: at 3+ cohorts an indefinite matrix
        # with an even number of negative eigenvalues has positive
        # determinant and would slip through the determinant-sign check
        # (the engine's validation mirrors the reference's slogdet test,
        # variational_inference.py:610-613, which has the same blind
        # spot; everything kept here passes it a fortiori)
        min_eig = np.linalg.eigvalsh(np.array(cross_pop_covs))[:, 0]
        kept = [c for c, e in zip(cross_pop_covs, min_eig) if e > 0]
        if len(kept) < len(cross_pop_covs):
            import logging
            logging.info(
                'Dropped %d of %d grid components with non-positive-'
                'definite covariances (infeasible pairwise-correlation '
                'combinations at %d cohorts).',
                len(cross_pop_covs) - len(kept), len(cross_pop_covs),
                num_pops)
        return kept
    return cross_pop_covs


def effect_size_ranges(betas, std_errs, scaled):
    """Empirical-Bayes-style plausible effect-size ranges
    (vi_options.py:196-227): per-population (mins, maxes) used to anchor
    the variance ladder."""
    if scaled:
        maxes = np.nanmax((betas / std_errs) ** 2, axis=1)
        mins = np.zeros_like(maxes)
        for population in range(len(mins)):
            this_keep = betas[population, :] ** 2 > 0
            mins[population] = np.nanpercentile(
                (betas[population, this_keep]
                 / std_errs[population, this_keep]) ** 2,
                2.5)
        return mins, maxes
    maxes = np.zeros(betas.shape[0])
    mins = np.zeros_like(maxes)
    for population in range(len(mins)):
        keep = ~np.isnan(betas[population])
        this_beta = np.abs(betas[population, keep])
        this_se = std_errs[population, keep]
        psi = 1. / len(this_beta)
        probs = 1. / (1.
                      + ((1. - psi) / psi
                         * np.sqrt(this_beta ** 2 / this_se ** 2)
                         * np.exp(-0.5 * this_beta ** 2 / this_se ** 2
                                  + 0.5)))
        ebayes = np.maximum(this_beta ** 2 - this_se ** 2, 1e-10)
        raw_means = this_beta / (1. + this_se ** 2 / ebayes ** 2)
        maxes[population] = np.max(probs * raw_means) ** 2
        mins[population] = np.nanpercentile(
            betas[population, betas[population, :] ** 2 > 0] ** 2, 2.5)
    return mins, maxes
