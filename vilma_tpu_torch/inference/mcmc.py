"""NUTS and annealed-SMC posterior sampling on small LD blocks.

Port of vilma_tpu/inference/mcmc.py, the validation tooling that draws
exact-model posterior samples of the true effects beta for one dense LD
block under the RSS likelihood and mixture-of-Gaussians prior the VI
engine optimizes, so the variational posterior can be checked against
asymptotically exact samples. The log densities are torch functions on
`device` (the card unless the caller asks for the CPU); gradients come
from autograd. The samplers' own logic runs on the host with numpy and
an explicit np.random.default_rng(seed), in the JAX package's order of
draws, so a chain can be held draw for draw against it at float64.

Model (per population p, reference variational_inference.py:79-84):
    beta_hat_p ~ N(S_p X S_p^{-1} beta_p, tau_p * S_p X S_p)
prior per SNP i (annotation a_i):
    beta_i ~ sum_k hyper_delta[a_i, k] N(0, mixture_covs[k])
The mixture assignment z_i is marginalized, leaving a differentiable
log-density for NUTS. A dense block of a few SNPs does not go through
the block matvec.
"""
import math

import numpy as np
import torch


def _tensor(x, device):
    return torch.tensor(np.asarray(x, dtype=np.float64), device=device)


def _mixture_log_prior(mixture_covs, weights, annotations, num_pops,
                       device):
    """log_prior(beta [..., P, n]) -> [...]: sum over SNPs of
    logsumexp_k(log w[a_i, k] + log N(beta_i; 0, S_k))."""
    covs = _tensor(mixture_covs, device)
    prec_k = torch.linalg.inv(covs)                          # [K, P, P]
    logdet_k = torch.linalg.slogdet(covs)[1]
    log_norm_k = -0.5 * (num_pops * math.log(2 * math.pi) + logdet_k)
    ann = torch.as_tensor(np.asarray(annotations), device=device).long()
    logw = torch.log(_tensor(weights, device))[ann].T        # [K, n]

    def log_prior(beta):
        quad = torch.einsum('...pi,kpq,...qi->...ki', beta, prec_k, beta)
        comp = log_norm_k[:, None] - 0.5 * quad              # [..., K, n]
        return torch.sum(torch.logsumexp(comp + logw, dim=-2), dim=-1)

    return log_prior


def make_block_log_posterior(ld_block, betas, std_errs, mixture_covs,
                             weights, annotations, error_scaling=None,
                             device='cuda'):
    """Return logpost(beta [..., P, n]) -> [...] for one dense LD block.

    Args:
        ld_block: [n, n] dense LD (may be rank-deficient; a pseudo-inverse
            Gaussian density on the LD row space is used, matching the
            reference's projected likelihood).
        betas: [P, n] observed marginal effects.
        std_errs: [P, n].
        mixture_covs: [K, P, P].
        weights: [A, K] mixture weights per annotation.
        annotations: [n] int annotation ids.
        error_scaling: [P] (defaults to ones).
        device: where the density is evaluated.
    """
    betas = _tensor(betas, device)
    std_errs = _tensor(std_errs, device)
    P, n = betas.shape
    error_scaling = (torch.ones(P, dtype=betas.dtype, device=device)
                     if error_scaling is None
                     else _tensor(error_scaling, device))

    # pseudo-inverse factorization of X for the (possibly singular)
    # Gaussian likelihood on the row space of X
    s_vals, vecs = torch.linalg.eigh(_tensor(ld_block, device))
    keep = s_vals > 1e-10
    s_safe = torch.where(keep, s_vals, torch.ones_like(s_vals))
    log_prior = _mixture_log_prior(mixture_covs, weights, annotations, P,
                                   device)

    def log_lik(beta):
        # beta_hat ~ N(S X S^{-1} beta, tau S X S); z-space:
        # z_obs = beta_hat / S ~ N(X (beta/S), tau X); project onto the
        # eigenbasis of X: u_j' z_obs ~ N(s_j u_j'(beta/S), tau s_j)
        total = 0.0
        for p in range(P):
            proj_obs = vecs.T @ (betas[p] / std_errs[p])          # [n]
            proj_mu = s_vals * ((beta[..., p, :] / std_errs[p]) @ vecs)
            var = error_scaling[p] * s_safe
            ll = torch.where(
                keep,
                -0.5 * ((proj_obs - proj_mu) ** 2 / var
                        + torch.log(2 * math.pi * var)),
                torch.zeros_like(proj_mu))
            total = total + torch.sum(ll, dim=-1)
        return total

    def log_post(beta):
        return log_lik(beta) + log_prior(beta)

    return log_post


# ---------------------------------------------------------------------------
# NUTS (Hoffman & Gelman 2014, multinomial variant): the recursive tree
# is built on the host; each leapfrog point costs one evaluation of the
# density and its gradient on the device. For small validation problems,
# not production sampling.
# ---------------------------------------------------------------------------

def _value_and_grad(log_post, shape, device):
    """(logp(q), grad(q)) of a flat numpy point, both from one autograd
    evaluation; the last point is remembered, since a leapfrog starts
    where the previous one ended and the tree reads logp there."""
    last = {}

    def evaluate(q):
        key = q.tobytes()
        if last.get('key') != key:
            qt = torch.tensor(q, dtype=torch.float64, device=device,
                              requires_grad=True)
            lp = log_post(qt.reshape(shape))
            grad, = torch.autograd.grad(lp, qt)
            last.update(key=key, value=float(lp.detach()),
                        grad=grad.cpu().numpy())
        return last['value'], last['grad']

    return evaluate


def nuts_sample(log_post, init, num_samples=1000, num_warmup=500, seed=0,
                max_depth=8, target_accept=0.8, device='cuda'):
    """Run NUTS; returns samples [num_samples, *init.shape]."""
    rng = np.random.default_rng(seed)
    shape = np.shape(init)
    dim = int(np.prod(shape))
    evaluate = _value_and_grad(log_post, shape, device)

    def logp(q):
        return evaluate(q)[0]

    def grad(q):
        return evaluate(q)[1]

    def leapfrog(q, p, eps):
        p = p + 0.5 * eps * grad(q)
        q = q + eps * p
        p = p + 0.5 * eps * grad(q)
        return q, p

    def find_reasonable_eps(q):
        eps = 1.0
        p = rng.standard_normal(dim)
        h0 = logp(q) - 0.5 * p @ p
        q1, p1 = leapfrog(q, p, eps)
        h1 = logp(q1) - 0.5 * p1 @ p1
        a = 1.0 if h1 - h0 > np.log(0.5) else -1.0
        for _ in range(50):
            eps *= 2.0 ** a
            q1, p1 = leapfrog(q, p, eps)
            h1 = logp(q1) - 0.5 * p1 @ p1
            if not np.isfinite(h1):
                h1 = -np.inf
            if a * (h1 - h0) <= -a * np.log(2):
                break
        return eps

    q = np.asarray(init, dtype=np.float64).reshape(-1).copy()
    eps = find_reasonable_eps(q)
    # dual averaging (Hoffman & Gelman alg. 6)
    mu = np.log(10 * eps)
    log_eps_bar, h_bar = 0.0, 0.0
    gamma, t0, kappa = 0.05, 10, 0.75

    samples = np.empty((num_samples, dim))
    DELTA_MAX = 1000.0

    def build_tree(q, p, u_slice, v, depth, h0):
        """Returns (q-, p-, q+, p+, q_prop, n_good, stop, alpha, n_alpha)."""
        if depth == 0:
            q1, p1 = leapfrog(q, p, v * eps)
            h1 = logp(q1) - 0.5 * p1 @ p1
            n_good = int(u_slice <= h1)
            stop = u_slice - DELTA_MAX > h1
            alpha = min(1.0, np.exp(min(0.0, h1 - h0)))
            return q1, p1, q1, p1, q1, n_good, stop, alpha, 1
        (qm, pm, qp, pp, qprop, n1, s1, a1, na1) = build_tree(
            q, p, u_slice, v, depth - 1, h0)
        if not s1:
            if v == -1:
                (qm, pm, _, _, qprop2, n2, s2, a2, na2) = build_tree(
                    qm, pm, u_slice, v, depth - 1, h0)
            else:
                (_, _, qp, pp, qprop2, n2, s2, a2, na2) = build_tree(
                    qp, pp, u_slice, v, depth - 1, h0)
            if n2 > 0 and rng.random() < n2 / max(n1 + n2, 1):
                qprop = qprop2
            span = qp - qm
            s1 = s2 or (span @ pm < 0) or (span @ pp < 0)
            n1 += n2
            a1 += a2
            na1 += na2
        return qm, pm, qp, pp, qprop, n1, s1, a1, na1

    total_iters = num_warmup + num_samples
    for it in range(total_iters):
        p0 = rng.standard_normal(dim)
        h0 = logp(q) - 0.5 * p0 @ p0
        u_slice = h0 + np.log(rng.random())
        qm, pm, qp, pp = q.copy(), p0.copy(), q.copy(), p0.copy()
        q_new = q.copy()
        n, stop, depth = 1, False, 0
        alpha_sum, n_alpha = 0.0, 0
        while not stop and depth < max_depth:
            v = 1 if rng.random() < 0.5 else -1
            if v == -1:
                (qm, pm, _, _, qprop, n2, s2, a2, na2) = build_tree(
                    qm, pm, u_slice, v, depth, h0)
            else:
                (_, _, qp, pp, qprop, n2, s2, a2, na2) = build_tree(
                    qp, pp, u_slice, v, depth, h0)
            if not s2 and rng.random() < n2 / max(n, 1):
                q_new = qprop
            n += n2
            span = qp - qm
            stop = s2 or (span @ pm < 0) or (span @ pp < 0)
            depth += 1
            alpha_sum += a2
            n_alpha += na2
        q = q_new
        # step-size adaptation during warmup
        if it < num_warmup:
            accept_stat = alpha_sum / max(n_alpha, 1)
            m = it + 1
            h_bar = ((1 - 1 / (m + t0)) * h_bar
                     + (target_accept - accept_stat) / (m + t0))
            log_eps = mu - np.sqrt(m) / gamma * h_bar
            w = m ** -kappa
            log_eps_bar = w * log_eps + (1 - w) * log_eps_bar
            eps = float(np.exp(log_eps))
        elif it == num_warmup:
            eps = float(np.exp(log_eps_bar))
        if it >= num_warmup:
            samples[it - num_warmup] = q
    return samples.reshape((num_samples,) + shape)


# ---------------------------------------------------------------------------
# Annealed SMC: prior -> posterior tempering with stratified resampling and
# random-walk Metropolis moves; every particle's density in one batched
# evaluation on the device.
# ---------------------------------------------------------------------------

def smc_sample(log_post, log_prior_sample, num_particles=2000,
               num_steps=30, num_mcmc=5, seed=0, device='cuda'):
    """Annealed SMC from the prior to log_post.

    Args:
        log_post: target log density fn(beta [..., P, n]) -> [...].
        log_prior_sample: fn(rng, num) -> (samples [num, ...], log_prior
            fn of the same batched form).
    Returns weighted-resampled particles [num_particles, ...].
    """
    rng = np.random.default_rng(seed)
    particles, log_prior = log_prior_sample(rng, num_particles)
    particles = np.asarray(particles, dtype=np.float64)
    shape = particles.shape[1:]
    flat = particles.reshape(num_particles, -1)

    def batched(fn):
        def run(q):
            with torch.no_grad():
                qt = torch.as_tensor(q, device=device)
                return fn(qt.reshape((-1,) + shape)).cpu().numpy()
        return run

    lp_post, lp_prior = batched(log_post), batched(log_prior)

    def log_target(lam, q):
        return (1 - lam) * lp_prior(q) + lam * lp_post(q)

    lambdas = np.linspace(0, 1, num_steps + 1)
    for li in range(1, len(lambdas)):
        lam_prev, lam = lambdas[li - 1], lambdas[li]
        inc = (lam - lam_prev) * (lp_post(flat) - lp_prior(flat))
        w = np.exp(inc - inc.max())
        w /= w.sum()
        # stratified resampling
        positions = (rng.random() + np.arange(num_particles)) / num_particles
        idx = np.searchsorted(np.cumsum(w), positions)
        flat = flat[np.minimum(idx, num_particles - 1)]
        # random-walk MH at tempered target
        step = 0.1 * flat.std(axis=0, keepdims=True) + 1e-8
        cur_lp = log_target(lam, flat)
        for _ in range(num_mcmc):
            prop = flat + step * rng.standard_normal(flat.shape)
            prop_lp = log_target(lam, prop)
            accept = np.log(rng.random(num_particles)) < prop_lp - cur_lp
            flat[accept] = prop[accept]
            cur_lp[accept] = prop_lp[accept]
    return flat.reshape((num_particles,) + shape)


def mixture_prior_sampler(mixture_covs, weights, annotations, num_pops,
                          device='cuda'):
    """Prior sampler + log density for `smc_sample`."""
    mixture_covs = np.asarray(mixture_covs)
    weights = np.asarray(weights)
    annotations = np.asarray(annotations)
    n = annotations.shape[0]
    chols = np.linalg.cholesky(mixture_covs)
    log_prior = _mixture_log_prior(mixture_covs, weights, annotations,
                                   num_pops, device)

    def sample(rng, num):
        out = np.zeros((num, num_pops, n))
        for j in range(num):
            ks = np.array([rng.choice(weights.shape[1],
                                      p=weights[annotations[i]])
                           for i in range(n)])
            eps = rng.standard_normal((n, num_pops))
            out[j] = np.einsum('iqp,iq->pi', chols[ks], eps)
        return out, log_prior

    return sample
