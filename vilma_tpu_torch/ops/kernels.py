"""Core numerical kernels of the VI engine as torch functions.

Port of vilma_tpu/ops/kernels.py: the same 14 functions with the same
signatures and shapes (K = mixture components, P = populations,
I = SNPs, A = annotations; [K, *] genome arrays are K-major). These are
plain tensor expressions, not hand-written kernels: the JAX package left
them to XLA fusion too.
"""
import torch

from vilma_tpu_torch.utils.config import epsilon


def sum_betas(old_beta, new_beta, step_size):
    """step*new + (1-step)*old (reference numerics.py:11-15)."""
    return step_size * new_beta + (1. - step_size) * old_beta


def fast_divide(x, y):
    """Elementwise x / y (reference numerics.py:18-21)."""
    return x / y


def fast_linked_ests(w, x, y, z):
    """Elementwise w/x - y*z (reference numerics.py:24-29)."""
    return w / x - y * z


def fast_likelihood(post_means, post_vars, scaled_mu, scaled_ld_diags,
                    linked_ests, adj_marginal, chi_stat, ld_ranks,
                    error_scaling):
    """Expected log likelihood of the RSS model (numerics.py:31-46)."""
    per_pop = torch.sum(
        -0.5 * (scaled_ld_diags * post_vars + linked_ests * scaled_mu)
        + post_means * adj_marginal,
        dim=1,
    )
    per_pop = per_pop - 0.5 * chi_stat
    return torch.sum(per_pop / error_scaling
                     - 0.5 * ld_ranks * torch.log(error_scaling))


# The [K, P, I] contractions below are products summed over an axis, not
# einsums: torch lowers einsum('kpi,ki->pi') and ('kpi,kpi->ki') to
# batched matrix products with one batch per SNP (or per SNP and
# component), which took 9 ms and 160 ms a call on an H100 at K = 1,953,
# P = 4 and 90,112 SNPs (chip_smoke.py phase 13a, PERF.md).

def fast_posterior_mean(vi_mu, vi_delta):
    """Mixture-weighted mean: einsum('kpi,ki->pi')."""
    return torch.sum(vi_mu * vi_delta[:, None, :], dim=0)


def fast_pmv(mean, vi_mu, vi_delta, vi_sigma_diag):
    """Posterior marginal variance E[beta^2] - E[beta]^2
    (numerics.py:60-65); vi_sigma_diag is [K, P, I]."""
    second = (vi_mu ** 2).add_(vi_sigma_diag).mul_(vi_delta[:, None, :])
    return torch.sum(second, dim=0) - mean ** 2


def fast_inner_product_comp(vi_mu, mixture_prec, vi_delta):
    """0.5 * einsum('kpi,kqi,kqp,ik->') (numerics.py:98-115), with
    prec_k @ mu_k formed first: a [K, P, I] product, where the three-way
    einsum, contracted left to right (torch without opt_einsum), forms a
    [K, P, P, I] one."""
    quad = torch.sum(vi_mu * torch.einsum('kqp,kpi->kqi', mixture_prec,
                                          vi_mu), dim=1)
    return 0.5 * torch.einsum('ki,ki->', quad, vi_delta)


def sum_annotations(deltas, annotations, num_annotations):
    """Segment-sum of vi_delta rows by annotation id: [K, I] -> [A, K].

    Padding SNPs (annotation id == num_annotations) fall into an extra
    segment that is dropped. A one-hot contraction, as in the JAX
    package: it is deterministic on the card, where index_add_ of
    floats is not."""
    ids = torch.arange(num_annotations + 1, device=annotations.device)
    one_hot = (annotations[:, None] == ids[None, :]).to(deltas.dtype)
    out = torch.einsum('ki,ia->ak', deltas, one_hot)
    return out[:num_annotations]


def _annotation_rows(table, annotations):
    """table[:, a_i] for every SNP i, with ids >= A (padding) reading the
    last column: [K, A] -> [K, I]."""
    A = table.shape[1]
    idx = torch.clamp(annotations.long(), max=A - 1)
    return table[:, idx]


def fast_delta_kl(vi_delta, hyper_delta, annotations):
    """sum_i vi_delta[i] . (log vi_delta[i] - log hyper_delta[a_i])
    (numerics.py:132-141). Padding SNPs (id == A) contribute zero."""
    A = hyper_delta.shape[0]
    entropy = torch.sum(vi_delta * torch.log(vi_delta), dim=0)   # [I]
    proj = torch.log(hyper_delta) @ vi_delta                     # [A, I]
    idx = torch.clamp(annotations.long(), max=A - 1)
    hyper_term = proj.gather(0, idx[None, :])[0]
    real = annotations < A
    return torch.sum(torch.where(real, entropy - hyper_term,
                                 torch.zeros_like(entropy)))


def fast_beta_kl(sigma_summary, vi_delta):
    """0.5 * sum(sigma_summary * vi_delta) (numerics.py:144-146)."""
    return 0.5 * torch.sum(sigma_summary * vi_delta)


def fast_vi_delta_grad(hyper_delta, log_det, annotations):
    """Natural parameter of the prior-only vi_delta (numerics.py:149-164):
    [K-1, I] of (log hyper[a_i, k] - 0.5 log_det[k]) minus the
    last-component baseline."""
    scores = torch.log(hyper_delta) - 0.5 * log_det          # [A, K]
    nat = scores[:, :-1] - scores[:, -1:]                    # [A, K-1]
    return _annotation_rows(nat.T, annotations)


def map_to_nat_cat_2D(probs):
    """log(probs[k] / probs[-1]) for k < K-1: [K, I] -> [K-1, I]."""
    logp = torch.log(probs)
    return logp[:-1] - logp[-1:]


def invert_nat_cat_2D(nat_probs):
    """Stabilized softmax-with-implicit-last-zero, clamped at epsilon
    (numerics.py:179-195): [K-1, I] -> [K, I]."""
    eps = epsilon(nat_probs.dtype)
    if nat_probs.shape[0]:
        # max(max(row), 0), the reference's stabilizer
        max_p = torch.clamp(nat_probs.amax(dim=0, keepdim=True), min=0.0)
    else:
        max_p = nat_probs.new_zeros((1, nat_probs.shape[1]))
    expd = torch.exp(nat_probs - max_p)                      # [K-1, I]
    last = torch.exp(-max_p)                                 # [1, I]
    denom = last + torch.sum(expd, dim=0, keepdim=True)
    probs = torch.cat([expd, last], dim=0) / denom
    return torch.clamp(probs, min=eps)


def fast_invert_nat_vi_delta(new_mu, nat_mu, const_part, nat_vi_delta):
    """Closed-form vi_delta from natural parameters (numerics.py:198-213)."""
    quad = torch.sum(new_mu * nat_mu, dim=1)                 # [K, I]
    addenda = const_part + quad
    to_invert = 0.5 * (addenda[:-1] - addenda[-1:]) + nat_vi_delta
    return invert_nat_cat_2D(to_invert)
