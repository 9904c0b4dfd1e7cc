"""Coordinate-ascent variational inference engine.

Port of vilma_tpu/inference/engine.py. Fits of P <= 3 cohorts carry a
compact state: the shared [P, I] natural mean of fits without
--learn-scaling, and, with --learn-scaling (scale_se), the per-component
[K, P, I] natural mean (kdim) or, above _EPOCH_STATE_BYTES, the
epoch-history state. Fits of P >= 4 cohorts (or traits) carry the
materialized state: vi_mu [K, P, I], vi_delta [K, I], its natural
parameter and the sigma summaries. One outer step runs up to
MAX_NUM_ITERS natural-gradient updates, each a backtracking line search
whose trials are objective evaluations (compact: fused prologue -> block
LD matvec -> likelihood reduction; materialized: the P x P solves of the
new means, the [K, P, I] moments, the matvec, the reduction), then the
closed-form hyper-delta update and, for scale_se fits, the
error-scaling EM.

The JAX engine runs a whole step on the device inside lax.while_loop.
Here the loops run on the host: every loop predicate (`new_obj <
threshold` of a line-search trial, the beta loop's convergence test)
needs the trial's objective, one device->host synchronization each. The
module counts them in `host_syncs`.

The JAX package's K-chunked route needs no counterpart: the kernels and
their plain versions take any K (the plain versions chunk SNPs to bound
their [K, chunk] temporaries) and the initialization forms its
[K, I] terms in SNP chunks. Checkpoint resume (`optimize(checkpoint)`)
restores all three states, genome-scale ones in bounded K-chunks.

Not ported (it raises, naming its ROADMAP item): mesh execution.
"""
import dataclasses
import logging
import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from vilma_tpu_torch.models import sigma as sigma_mod
from vilma_tpu_torch.ops import blocks as blocks_mod
from vilma_tpu_torch.ops import kernels
from vilma_tpu_torch.ops.cuda import compact_obj
from vilma_tpu_torch.utils.config import epsilon

# Optimization constants (reference variational_inference.py:18-24)
L_MAX = 1e12
REL_TOL = 1e-6
ABS_TOL = 1e-6
ELBO_TOL = 0.1
EM_TOL = 10
ELBO_MOMENTUM = 0.5
MAX_NUM_ITERS = 20

# EM re-basings whose relative error-scaling change is below this are
# treated as converged (no epoch appended, scaling frozen): 1e-6 is the
# f32 noise floor; the f64 parity tests pin exactness with 0.0
_EPOCH_SKIP_TOL = 1e-6
# epoch-buffer growth buckets and the hard cap; at the cap further EM
# updates freeze with a warning
_EPOCH_BUCKETS = (4, 8, 16, 32, 48)
_EPOCH_CAP = _EPOCH_BUCKETS[-1]
# scale_se fits whose kdim [K, P, I] state would exceed this use the
# epoch-history representation instead; VILMA_EPOCH_STATE_BYTES
# overrides (0 forces the epoch state everywhere)
_EPOCH_STATE_BYTES = int(os.environ.get('VILMA_EPOCH_STATE_BYTES', 1 << 30))

# host-side chunk budget of the streamed checkpoint recovery
# (_nat_from_checkpoint_streamed); tests shrink it to prove boundedness
_RESUME_CHUNK_BYTES = 256 << 20

# device budget of each [K, chunk] temporary of the initialization
# (initialize_from_fake_mu), which would otherwise form [K, I] ones
_INIT_CHUNK_BYTES = 256 << 20

#: device->host synchronizations made by the host loops of the optimizer
#: (one per objective fetched to decide a loop predicate, one per
#: convergence-statistics fetch)
host_syncs = 0


def _sync_float(x):
    """Fetch a device scalar to the host: one counted synchronization."""
    global host_syncs
    host_syncs += 1
    return float(x)


@dataclass(frozen=True)
class ModelData:
    """Immutable sufficient statistics of the RSS model (reference
    VIScheme.__init__ precomputation, variational_inference.py:96-259)."""
    marginal_effects: torch.Tensor      # [P, I]
    std_errs: torch.Tensor              # [P, I]
    scalings: torch.Tensor              # [P, I] undo --scaled at output
    ld_diags: torch.Tensor              # [P, I]
    scaled_ld_diags: torch.Tensor       # [P, I] = std_errs**-2 * ld_diags
    adj_marginal_effects: torch.Tensor  # [P, I]
    chi_stat: torch.Tensor              # [P]
    ld_ranks: torch.Tensor              # [P]
    inverse_betas: torch.Tensor         # [P, I] LDpred-inf init
    annotations: torch.Tensor           # [I] int32 (== A on pad slots)
    annotation_counts: torch.Tensor     # [A]
    mixture_prec: torch.Tensor          # [K, P, P]
    log_det: torch.Tensor               # [K] prior covariance log-dets
    ld: tuple                           # tuple[PackedLD], unique matrices
    num_annotations: int
    scale_se: bool
    # population p uses ld[ld_index[p]]; cohorts sharing one panel share
    # one matvec pass (blocks.dot_multi)
    ld_index: tuple = ()


@dataclass(frozen=True)
class VIState:
    """Optimization state (see the JAX VIState docstring). In the compact
    representations (P <= 3) the beta family is carried as its natural
    mean(s), and vi_delta and every vi_sigma summary are closed forms of
    (natural mean, hyper_delta, error_scaling):

    * shared: nat_mu [P, I], vi_mu[k] = vi_sigma[k] @ nat_mu for every k
      (fits without --learn-scaling);
    * kdim: nat_mu [K, P, I], one natural mean per component (each
      error-scaling EM event re-bases them k-dependently);
    * epoch history (nat_hist set): nat_mu is the [P, I] current-epoch
      accumulator and the per-component means are implied by the
      history (sigma.compact_exprs_epochs). Slots >= nat_hist_n are
      inert (nat_hist_c == 0, zero vectors, scale 1).

    There vi_mu/vi_delta/sigma/nat_grad_vi_delta are filled only by
    `materialize_state`, for outputs and tests. In the MATERIALIZED
    representation (nat_mu None; P >= 4) those four fields are the
    state. Scalars the host loop reads (nat_hist_n among them) live on
    the host."""
    nat_mu: torch.Tensor          # [P, I], [K, P, I] or None
    hyper_delta: torch.Tensor     # [A, K]
    error_scaling: torch.Tensor   # [P]
    L: tuple                      # 3 per-paramset Lipschitz estimates
    elbo: float
    running_elbo_delta: float     # nan = not yet initialized
    num_err: int                  # count of line-search failures
    vi_mu: torch.Tensor = None            # [K, P, I]
    vi_delta: torch.Tensor = None         # [K, I]
    sigma: sigma_mod.SigmaSummaries = None
    nat_grad_vi_delta: torch.Tensor = None  # [K-1, I]
    nat_hist: torch.Tensor = None         # [B, P, I] epoch vectors
    nat_hist_scale: torch.Tensor = None   # [B, P] error_scaling per epoch
    nat_hist_c: torch.Tensor = None       # [B] coefficients
    nat_hist_n: int = None                # live epoch count


def _isclose(a, b, rtol=1e-5, atol=1e-8):
    return abs(a - b) <= atol + rtol * abs(b)


def _err_rtol(dtype):
    """Tolerance of the line-search "inconsistent objectives" guard: the
    reference's np.isclose default at f64, a 1e-3 band at f32, where two
    evaluations of a 1e5..1e7-term reduction legitimately differ by
    rounding (see the JAX engine's _err_rtol)."""
    return 1e-5 if dtype == torch.float64 else 1e-3


def _diag_term(data, error_scaling):
    return data.scaled_ld_diags / error_scaling[:, None]


def _ld_scaled_dot(data, post_means):
    """linked = LD . (post_means / SE) for each population — the hot block
    matvec (variational_inference.py:459,812). Populations sharing an LD
    matrix go through ONE multi-RHS pass."""
    scaled_mu = post_means / data.std_errs
    P = scaled_mu.shape[0]
    outs = [None] * P
    for m, ld in enumerate(data.ld):
        pops = [p for p in range(P) if data.ld_index[p] == m]
        if pops:
            ys = blocks_mod.dot_multi(ld, scaled_mu[pops])
            for j, p in enumerate(pops):
                outs[p] = ys[j]
    return scaled_mu, torch.stack(outs)


# ---------------------------------------------------------------------------
# The objective of each compact state
# ---------------------------------------------------------------------------

def _fused_operands(data, error_scaling, nat_mu, hyper_delta):
    """Operands of the fused compact kernels (ops/cuda/compact_obj):
    coefficient table, transposed prior scores, per-SNP [*, I] arrays.
    nat_mu is the shared [P, I] or the kdim [K, P, I] natural mean."""
    dterm = _diag_term(data, error_scaling)
    coeffs = compact_obj.build_coeffs(data.mixture_prec, data.log_det)
    scores_t = (torch.log(hyper_delta) - 0.5 * data.log_det).T.contiguous()
    # the kernels take dense row-major operands; the initial natural mean
    # comes out of an einsum with permuted strides
    return coeffs, scores_t, data.annotations, dterm, nat_mu.contiguous()


def _epoch_operands(data, st, nat_u, hist_c, hyper_delta):
    """Operands of the fused epoch kernels (compact_obj.prologue_epochs):
    the raw scaled_ld_diags, the accumulator, the history and the
    [B+1, P] inverse-scaling table (row 0 = the current scaling)."""
    coeffs = compact_obj.build_coeffs(data.mixture_prec, data.log_det)
    scores_t = (torch.log(hyper_delta) - 0.5 * data.log_det).T.contiguous()
    inv_scales = torch.cat([1.0 / st.error_scaling[None],
                            1.0 / st.nat_hist_scale], dim=0)
    return (coeffs, scores_t, data.annotations, data.scaled_ld_diags,
            nat_u.contiguous(), st.nat_hist, inv_scales, hist_c)


# The beta parameters of a state: (nat_mu,) for the shared and kdim
# states, (nat_u, hist_c) for the epoch state, (vi_mu, vi_delta) for the
# materialized one. A natural-gradient step nat <- (1-s) nat + s grad
# becomes u <- (1-s) u + s grad, c <- (1-s) c on the epoch state (the
# gradient is K-constant); the materialized state steps its natural mean
# and solves for the new vi_mu and vi_delta.

def _params(st):
    if st.nat_mu is None:
        return (st.vi_mu, st.vi_delta)
    if st.nat_hist is None:
        return (st.nat_mu,)
    return (st.nat_mu, st.nat_hist_c)


def _with_params(st, params):
    if st.nat_mu is None:
        return dataclasses.replace(st, vi_mu=params[0], vi_delta=params[1])
    if st.nat_hist is None:
        return dataclasses.replace(st, nat_mu=params[0])
    return dataclasses.replace(st, nat_mu=params[0], nat_hist_c=params[1])


def _fused(data, st, params, hyper_delta, sums=False):
    """The fused prologue (post_means, post_vars, beta_kl) of the state's
    form at the beta parameters `params`, or with sums=True the [A, K]
    annotation sums of the derived vi_delta (st supplies error_scaling
    and the epoch buffers)."""
    A = data.num_annotations
    if st.nat_hist is None:
        fn = compact_obj.delta_sums if sums else compact_obj.prologue
        return fn(*_fused_operands(data, st.error_scaling, params[0],
                                   hyper_delta), num_annotations=A)
    fn = (compact_obj.delta_sums_epochs if sums
          else compact_obj.prologue_epochs)
    return fn(*_epoch_operands(data, st, *params, hyper_delta),
              num_annotations=A, num_live=st.nat_hist_n)


def _objective(data, st, params, hyper_delta):
    """(objective tensor, post_means, linked) of a parameter point: the
    fused prologue, the LD matvec and the likelihood reduction (reference
    variational_inference.py:452-490, 632-641, 868-885); on the
    materialized state its unfused twin, _beta_objective_terms."""
    if st.nat_mu is None:
        return _beta_objective_terms(data, st.sigma, st.error_scaling,
                                     *params, hyper_delta)
    post_means, post_vars, beta_kl = _fused(data, st, params, hyper_delta)
    scaled_mu, linked_ests = _ld_scaled_dot(data, post_means)
    ll = kernels.fast_likelihood(
        post_means, post_vars, scaled_mu, data.scaled_ld_diags,
        linked_ests, data.adj_marginal_effects, data.chi_stat,
        data.ld_ranks, st.error_scaling)
    return ll - beta_kl, post_means, linked_ests


# ---------------------------------------------------------------------------
# The objective of the materialized state (P >= 4): the same terms from
# the stored [K, P, I] and [K, I] arrays (JAX package engine.py:195-366)
# ---------------------------------------------------------------------------

def log_likelihood_terms(data, sigma, error_scaling, vi_mu, vi_delta):
    """(expected log likelihood, post_means, linked) with linked =
    LD.(post_means / SE) (variational_inference.py:452-470)."""
    post_means = kernels.fast_posterior_mean(vi_mu, vi_delta)
    post_vars = kernels.fast_pmv(post_means, vi_mu, vi_delta, sigma.diag)
    scaled_mu, linked = _ld_scaled_dot(data, post_means)
    ll = kernels.fast_likelihood(
        post_means, post_vars, scaled_mu, data.scaled_ld_diags, linked,
        data.adj_marginal_effects, data.chi_stat, data.ld_ranks,
        error_scaling)
    return ll, post_means, linked


def beta_KL(data, sigma, vi_mu, vi_delta, hyper_delta):
    """KL of the effect-size family (variational_inference.py:873-885);
    SNPs of the pad annotation id add no covariance term."""
    delta_comp = kernels.fast_delta_kl(vi_delta, hyper_delta,
                                       data.annotations)
    inner = kernels.fast_inner_product_comp(vi_mu, data.mixture_prec,
                                            vi_delta)
    real = (data.annotations < data.num_annotations)[None, :]
    fast_comp = 0.5 * torch.sum(torch.where(
        real, sigma.sigma_summary * vi_delta, torch.zeros_like(vi_delta)))
    return delta_comp + inner + fast_comp


def _beta_objective_terms(data, sigma, error_scaling, vi_mu, vi_delta,
                          hyper_delta):
    """(beta objective, post_means, linked); the beta objective is the
    ELBO of MultiPopVI (its annotation KL is 0)."""
    ll, post_means, linked = log_likelihood_terms(
        data, sigma, error_scaling, vi_mu, vi_delta)
    obj = ll - beta_KL(data, sigma, vi_mu, vi_delta, hyper_delta)
    return obj, post_means, linked


def nat_to_not_vi_delta(data, sigma, error_scaling, vi_mu,
                        nat_grad_vi_delta):
    """Closed-form vi_delta from the natural parameters
    (variational_inference.py:632-641)."""
    nat = sigma_mod.apply_precision(data.mixture_prec,
                                    _diag_term(data, error_scaling), vi_mu)
    return kernels.fast_invert_nat_vi_delta(vi_mu, nat, sigma.log_det_sigma,
                                            nat_grad_vi_delta)


def _objective_compact(data, st, nat_mu, hyper_delta):
    """`_objective` of a shared or kdim natural mean."""
    return _objective(data, st, (nat_mu,), hyper_delta)


def _nat_grad_resid(data, error_scaling, post_mean, linked_raw):
    """The [P, I] natural-gradient residual (constant across mixture
    components — the structural fact the compact state exploits)."""
    linked = kernels.fast_linked_ests(linked_raw, data.std_errs, post_mean,
                                      data.scaled_ld_diags)
    return (data.adj_marginal_effects - linked) / error_scaling[:, None]


def _stepper(data, st, params, grad):
    """s -> (the beta parameters a natural-gradient step of size s takes
    from `params`, the trial's Cholesky failure counts). The [P, I]
    gradient is constant in K and broadcasts; the materialized state
    steps its natural mean (prec_k + diag) @ vi_mu_k and solves back for
    vi_mu and vi_delta (variational_inference.py:762-802)."""
    if st.nat_mu is not None:
        def step(s):
            return (kernels.sum_betas(params[0], grad, s),) + tuple(
                (1. - s) * c for c in params[1:]), []
        return step
    dterm = _diag_term(data, st.error_scaling)
    old_nat = sigma_mod.apply_precision(data.mixture_prec, dterm, params[0])

    def step(s):
        failures = []
        nat = kernels.sum_betas(old_nat, grad, s)
        new_mu = sigma_mod.apply_sigma(data.mixture_prec, dterm, nat,
                                       failures)
        new_vd = kernels.fast_invert_nat_vi_delta(
            new_mu, nat, st.sigma.log_det_sigma, st.nat_grad_vi_delta)
        return (new_mu, new_vd), failures
    return step


def _sync_trial(obj, failures):
    """A trial's objective on the host, fetched in one synchronization
    with its Cholesky failure count (raising if there were any)."""
    if not failures:
        return _sync_float(obj)
    global host_syncs
    host_syncs += 1
    value, bad = torch.stack([obj, sum(failures).to(obj.dtype)]).tolist()
    sigma_mod.check_cholesky(bad)
    return value


def _update_beta(data, st, orig_obj, cur_post_mean, cur_linked,
                 line_search_rate):
    """One natural-gradient step with backtracking line search
    (variational_inference.py:762-802) on the state's beta parameters.
    orig_obj is a host float. Returns (params, L0, new_obj, post_mean,
    linked, err) for the accepted (or kept) parameters."""
    grad = _nat_grad_resid(data, st.error_scaling, cur_post_mean,
                           cur_linked)
    threshold = orig_obj - REL_TOL * abs(orig_obj) - ABS_TOL
    params = _params(st)
    step = _stepper(data, st, params, grad)

    def trial(L0):
        new, failures = step(1. / L0)
        obj, pm, lk = _objective(data, st, new, st.hyper_delta)
        return new, _sync_trial(obj, failures), pm, lk

    L0 = st.L[0]
    new, new_obj, pm, lk = trial(L0)
    while new_obj < threshold and L0 <= L_MAX:
        L0 = L0 * line_search_rate
        new = pm = lk = None    # free the rejected trial before the next
        new, new_obj, pm, lk = trial(L0)

    err = int(L0 > L_MAX and not _isclose(
        orig_obj, new_obj, rtol=_err_rtol(st.hyper_delta.dtype)))
    if new_obj >= threshold:
        return new, L0, new_obj, pm, lk, err
    return params, L0, orig_obj, cur_post_mean, cur_linked, err


def _beta_loop(data, st, conv_tol, line_search_rate):
    """Up to MAX_NUM_ITERS beta updates (variational_inference.py:427-439),
    stopping once the objective gain is below conv_tol or L hits its
    bounds. Returns (state, objective delta, final objective, post_mean,
    linked)."""
    obj, pm, lk = _objective(data, st, _params(st), st.hyper_delta)
    orig_obj = _sync_float(obj)
    L0, num_err = st.L[0], st.num_err
    delta = 0.0
    for _ in range(MAX_NUM_ITERS):
        L0 = max(1., L0 / 1.25)
        st = dataclasses.replace(st, L=(L0,) + st.L[1:])
        params, L0, new_obj, pm, lk, err = _update_beta(
            data, st, orig_obj, pm, lk, line_search_rate)
        st = _with_params(st, params)
        delta = delta + new_obj - orig_obj
        done = (abs(new_obj - orig_obj) <= conv_tol
                or L0 == 1. or L0 > L_MAX)
        num_err += err
        orig_obj = new_obj
        if done:
            break
    st = dataclasses.replace(st, L=(L0,) + st.L[1:], num_err=num_err)
    return st, delta, orig_obj, pm, lk


def _update_hyper_delta(data, st, orig_obj):
    """Closed-form per-annotation mixture-weight update
    (variational_inference.py:825-860), from the annotation sums of
    vi_delta (fused on a compact state, where vi_delta is derived). On
    the materialized state the new weights also move vi_delta and its
    natural parameter."""
    eps = epsilon(st.hyper_delta.dtype)
    if st.nat_mu is None:
        new_hd = kernels.sum_annotations(st.vi_delta, data.annotations,
                                         data.num_annotations)
    else:
        new_hd = _fused(data, st, _params(st), st.hyper_delta, sums=True)
    new_hd = torch.clamp(new_hd / (data.annotation_counts[:, None] + eps),
                         min=eps)
    new_hd = new_hd / new_hd.sum(dim=1, keepdim=True)
    if st.nat_mu is None:
        nat_vd = kernels.fast_vi_delta_grad(new_hd, data.log_det,
                                            data.annotations)
        st = dataclasses.replace(
            st, nat_grad_vi_delta=nat_vd, vi_delta=nat_to_not_vi_delta(
                data, st.sigma, st.error_scaling, st.vi_mu, nat_vd))
    obj, pm, lk = _objective(data, st, _params(st), new_hd)
    new_obj = _sync_float(obj)
    st = dataclasses.replace(st, hyper_delta=new_hd)
    return st, new_obj - orig_obj, new_obj, pm, lk


def _update_error_scaling(data, st, orig_obj, post_means, linked):
    """The error-scaling EM of --learn-scaling fits
    (variational_inference.py:472-486, 735-738), from the posterior
    moments and the LD matvec of the current parameters.

    The reference keeps vi_mu fixed while the scaling moves: the
    materialized state refreshes its sigma summaries and vi_delta under
    the new scaling. On a compact state the natural means re-base
    k-dependently: nat'_k = (prec_k + d_new) @ sigma_old_k @ nat_k. The
    kdim state applies that map; the epoch state appends an epoch
    instead (the maps telescope, see sigma.compact_exprs_epochs): the
    accumulator goes into the history with coefficient 1 under the old
    scaling, and a zero accumulator starts under the new one. An epoch
    state freezes (no change) when the relative scaling change is below
    _EPOCH_SKIP_TOL or its buffer is full. Returns (state, objective
    delta, post_mean)."""
    if st.nat_mu is None:
        post_vars = kernels.fast_pmv(post_means, st.vi_mu, st.vi_delta,
                                     st.sigma.diag)
    else:
        post_vars = _fused(data, st, _params(st), st.hyper_delta)[1]
    scaled_mu = post_means / data.std_errs
    quad = torch.einsum('pi,pi->p', scaled_mu, linked)
    new_scaling = (
        data.chi_stat
        - 2 * torch.einsum('pi,pi->p', post_means,
                           data.adj_marginal_effects)
        + quad
        + torch.sum(data.ld_diags * post_vars * data.std_errs ** -2, dim=1)
    ) / data.ld_ranks
    if st.nat_mu is None:
        sigma = sigma_mod.make_summaries(data.mixture_prec, data.log_det,
                                         _diag_term(data, new_scaling))
        st = dataclasses.replace(
            st, error_scaling=new_scaling, sigma=sigma,
            vi_delta=nat_to_not_vi_delta(data, sigma, new_scaling,
                                         st.vi_mu, st.nat_grad_vi_delta))
    elif st.nat_hist is None:
        vi_mu = sigma_mod.apply_sigma(
            data.mixture_prec, _diag_term(data, st.error_scaling),
            st.nat_mu)
        nat_new = sigma_mod.apply_precision(
            data.mixture_prec, _diag_term(data, new_scaling), vi_mu)
        st = dataclasses.replace(st, error_scaling=new_scaling,
                                 nat_mu=nat_new)
    else:
        n = st.nat_hist_n
        change = _sync_float(torch.max(torch.abs(
            new_scaling / st.error_scaling - 1.0)))
        if not (change > _EPOCH_SKIP_TOL and n < st.nat_hist.shape[0]):
            return st, 0.0, post_means
        hist = st.nat_hist.clone()
        hist[n] = st.nat_mu
        scale = st.nat_hist_scale.clone()
        scale[n] = st.error_scaling
        coef = st.nat_hist_c.clone()
        coef[n] = 1.0
        st = dataclasses.replace(
            st, error_scaling=new_scaling,
            nat_mu=torch.zeros_like(st.nat_mu), nat_hist=hist,
            nat_hist_scale=scale, nat_hist_c=coef, nat_hist_n=n + 1)
    obj, pm, _ = _objective(data, st, _params(st), st.hyper_delta)
    return st, _sync_float(obj) - orig_obj, pm


def outer_step(data, st, line_search_rate=2.0):
    """One full coordinate-ascent iteration
    (reference _optimize_step/_nat_grad_step,
    variational_inference.py:396-450). Returns (state, posterior mean in
    output scale)."""
    if st.nat_mu is not None:
        if data.scale_se and st.nat_hist is None and st.nat_mu.dim() != 3:
            raise ValueError('compact scale_se fits carry a per-component '
                             '[K, P, I] natural mean (the error-scaling EM '
                             'makes natural means K-dependent); got a '
                             'shared [P, I] state')
        # a compact state's derived fields would go stale the moment the
        # parameters move
        st = dataclasses.replace(st, vi_mu=None, vi_delta=None, sigma=None,
                                 nat_grad_vi_delta=None)
    red = st.running_elbo_delta
    conv_tol = math.inf if math.isnan(red) else 0.1 * red
    st, delta_beta, obj, pm, lk = _beta_loop(data, st, conv_tol,
                                             line_search_rate)
    st, delta_hyper, obj, pm, lk = _update_hyper_delta(data, st, obj)
    new_elbo_delta = delta_beta + delta_hyper
    if (data.scale_se or st.nat_hist is not None) \
            and new_elbo_delta < EM_TOL:
        st, em_delta, pm = _update_error_scaling(data, st, obj, pm, lk)
        new_elbo_delta = new_elbo_delta + em_delta
    red = new_elbo_delta if math.isnan(red) else red
    red = red * ELBO_MOMENTUM + (1 - ELBO_MOMENTUM) * max(new_elbo_delta,
                                                          0.0)
    st = dataclasses.replace(st, elbo=st.elbo + new_elbo_delta,
                             running_elbo_delta=red)
    # pm belongs to the final parameters (the hyper-delta evaluation, or
    # the post-EM one)
    return st, pm * data.scalings


# ---------------------------------------------------------------------------
# Derived state (outputs, tests)
# ---------------------------------------------------------------------------

def _nat_k(data, nat_mu):
    """A compact natural mean as [K, P, I]: the shared [P, I] state
    broadcasts (a view), the kdim state passes through."""
    if nat_mu.dim() == 2:
        K = data.mixture_prec.shape[0]
        return nat_mu[None].expand((K,) + tuple(nat_mu.shape))
    return nat_mu


def _live_hist(st):
    """(vectors, scalings, coefficients) of the live epochs; the slots
    past them add exact zeros."""
    n = st.nat_hist_n
    return st.nat_hist[:n], st.nat_hist_scale[:n], st.nat_hist_c[:n]


def _epoch_exprs(mixture_prec, sld, error_scaling, st, cols=slice(None)):
    """sigma.compact_exprs_epochs of an epoch state's live epochs at SNP
    columns `cols`."""
    hist, scale, coef = _live_hist(st)
    sld = sld[:, cols]
    return sigma_mod.compact_exprs_epochs(
        mixture_prec, sld / error_scaling[:, None], st.nat_mu[:, cols],
        hist[..., cols], sld[None] / scale[:, :, None], coef)


def _derive_params(data, st):
    """(sigma, vi_mu [K,P,I], vi_delta [K,I]) derived from a compact or
    epoch state, staged as tensor expressions."""
    dterm = _diag_term(data, st.error_scaling)
    sigma = sigma_mod.make_summaries(data.mixture_prec, data.log_det,
                                     dterm)
    nat_vd = kernels.fast_vi_delta_grad(st.hyper_delta, data.log_det,
                                        data.annotations)
    if st.nat_hist is not None:
        ex = _epoch_exprs(data.mixture_prec, data.scaled_ld_diags,
                          st.error_scaling, st)
        addenda = ex.log_det_sigma + ex.quad
        li = 0.5 * (addenda[:-1] - addenda[-1:]) + nat_vd
        return sigma, ex.mu, kernels.invert_nat_cat_2D(li)
    nat_b = _nat_k(data, st.nat_mu)
    vi_mu = sigma_mod.apply_sigma(data.mixture_prec, dterm, nat_b)
    vi_delta = kernels.fast_invert_nat_vi_delta(
        vi_mu, nat_b, sigma.log_det_sigma, nat_vd)
    return sigma, vi_mu, vi_delta


def materialize_state(data, st):
    """Fill a compact VIState's derived fields (vi_mu, vi_delta, sigma,
    nat_grad_vi_delta) for outputs and tests; the identity on a
    materialized state."""
    if st.nat_mu is None:
        return st
    sigma, vi_mu, vi_delta = _derive_params(data, st)
    nat_vd = kernels.fast_vi_delta_grad(st.hyper_delta, data.log_det,
                                        data.annotations)
    return dataclasses.replace(st, vi_mu=vi_mu, vi_delta=vi_delta,
                               sigma=sigma, nat_grad_vi_delta=nat_vd)


def compact_nat_mu(data, error_scaling, vi_mu):
    """Recover the shared [P, I] natural mean from a materialized vi_mu:
    nat = (prec_0 + diag) @ vi_mu[0] (exact for any non-scale_se state)."""
    dterm = _diag_term(data, error_scaling)
    return (torch.einsum('pq,qi->pi', data.mixture_prec[0], vi_mu[0])
            + dterm * vi_mu[0])


def compact_nat_mu_k(data, error_scaling, vi_mu):
    """Per-component [K, P, I] natural means from a materialized vi_mu
    (scale_se): nat_k = (prec_k + diag) @ vi_mu[k], exact given the
    error_scaling."""
    return sigma_mod.apply_precision(data.mixture_prec,
                                     _diag_term(data, error_scaling), vi_mu)


def _conv_stats(new_pm, old_pm, ckp_pm, st):
    """Per-iteration convergence/telemetry scalars, reduced on the device
    and fetched in ONE synchronization: [num_err, elbo, running delta,
    allclose, max|pm|, max rel diff, max abs diff, checkpoint RMSE,
    error_scaling...]."""
    global host_syncs
    eps = epsilon(new_pm.dtype)
    diff = torch.abs(new_pm - old_pm)
    # np.allclose(new, old, atol=ABS_TOL, rtol=REL_TOL) semantics
    allclose = torch.all(diff <= ABS_TOL + REL_TOL * torch.abs(old_pm))
    dev = torch.cat([torch.stack([
        allclose.to(new_pm.dtype),
        torch.max(torch.abs(new_pm)),
        torch.max(torch.abs(diff / (old_pm + eps))),
        torch.max(diff),
        torch.sqrt(torch.mean((new_pm - ckp_pm) ** 2)),
    ]), st.error_scaling.to(new_pm.dtype)])
    host_syncs += 1
    dev = dev.cpu().numpy().astype(np.float64)
    return np.concatenate([[st.num_err, st.elbo, st.running_elbo_delta],
                           dev])


# ---------------------------------------------------------------------------
# Initialization (reference MultiPopVI._initialize,
# variational_inference.py:643-700). RNG draws happen on the host with the
# global numpy stream, in the reference's order.
# ---------------------------------------------------------------------------

def make_fake_mu(inverse_betas, std_errs, ld_diags):
    """Host-side jittered initial means (variational_inference.py:646-657),
    from the *global* numpy RNG in the reference's order."""
    real_mu = np.asarray(inverse_betas)
    std_errs = np.asarray(std_errs)
    missing = np.isclose(np.asarray(ld_diags), 0)
    fake_mu = np.random.normal(loc=np.copy(real_mu), scale=1e-3 * std_errs,
                               size=real_mu.shape)
    fake_mu[missing] = np.nan
    with np.errstate(invalid='ignore'):
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            mu_fill = np.tile(np.nanmean(fake_mu, axis=0),
                              [fake_mu.shape[0], 1])
    fake_mu[missing] = mu_fill[missing]
    fake_mu[np.isnan(fake_mu)] = 0.
    return fake_mu


def initialize_from_fake_mu(data, error_scaling, fake_mu, sigma=None):
    """Device-side remainder of _initialize
    (variational_inference.py:658-700): returns (hyper_delta [A, K], the
    shared natural mean [P, I]). Every step is per SNP but the annotation
    sums, so the [K, I] temporaries are formed in SNP chunks of
    _INIT_CHUNK_BYTES per [K, chunk] array and the sums added over
    chunks. Given the sigma summaries of the materialized state, also
    returns its vi_mu [K, P, I] (sigma_k @ the shared natural mean),
    vi_delta [K, I] and the natural parameter [K-1, I] of hyper_delta."""
    eps = epsilon(fake_mu.dtype)
    K, I = data.log_det.shape[0], fake_mu.shape[1]
    chunk_i = max(1, _INIT_CHUNK_BYTES // (K * fake_mu.element_size()))
    dterm = _diag_term(data, error_scaling)
    sums, nats = 0., []
    for i0 in range(0, I, chunk_i):
        cols = slice(i0, i0 + chunk_i)
        dt, mu = dterm[:, cols], fake_mu[:, cols]
        matches = sigma_mod.make_summaries(data.mixture_prec, data.log_det,
                                           dt).matches
        probs = torch.einsum('pi,oi,kpo->ki', 1.6 * mu, 1.6 * mu,
                             data.mixture_prec)
        probs = probs + matches - data.log_det[:, None]
        probs = torch.exp(-0.5 * (probs - probs.amin(dim=0, keepdim=True)))
        vi_delta = torch.clamp(probs / probs.sum(dim=0, keepdim=True),
                               min=eps)
        sums = sums + kernels.sum_annotations(
            vi_delta, data.annotations[cols], data.num_annotations)
        avg_mats = sigma_mod.sigma_weighted_sum(data.mixture_prec, dt,
                                                vi_delta)        # [i,P,P]
        nats.append(torch.einsum('pi,iqp->qi', mu,
                                 torch.linalg.inv(avg_mats)))    # [P,i]
    hyper = sums + 1.
    hyper = hyper / torch.sum(hyper, dim=1, keepdim=True)
    hyper = torch.clamp(hyper, min=eps)
    temp_nat = torch.cat(nats, dim=1)
    if sigma is None:
        return hyper, temp_nat
    nat_vd = kernels.fast_vi_delta_grad(hyper, data.log_det,
                                        data.annotations)
    vi_mu = sigma_mod.apply_sigma(data.mixture_prec, dterm,
                                  _nat_k(data, temp_nat))
    vi_delta = nat_to_not_vi_delta(data, sigma, error_scaling, vi_mu,
                                   nat_vd)
    return hyper, temp_nat, vi_mu, vi_delta, nat_vd


# ---------------------------------------------------------------------------
# Model setup (reference VIScheme.__init__ precomputation,
# variational_inference.py:96-259)
# ---------------------------------------------------------------------------

def _precompute_stats(ld, ld_index, marginal_effects, std_errs, gwas_N,
                      init_hg, real_mask):
    P = marginal_effects.shape[0]
    lds = [ld[ld_index[p]] for p in range(P)]
    ld_diags = torch.stack([blocks_mod.diag(lds[p]).to(std_errs.dtype)
                            for p in range(P)])
    z_scores = marginal_effects / std_errs
    mle = torch.stack([blocks_mod.inverse_dot(lds[p], z_scores[p])
                       for p in range(P)])
    chi_stat = torch.einsum('pi,pi->p', z_scores, mle)
    adj = torch.stack([blocks_mod.dot(lds[p], mle[p]) for p in range(P)])
    adj = adj / std_errs
    # layout-pad slots must not inflate the LDpred-style prior's SE^-2 sum
    prior = (2 * gwas_N * init_hg) / torch.sum(
        std_errs ** -2 * real_mask[None, :], dim=1)
    inv_z = torch.stack([
        blocks_mod.ridge_inverse_dot(lds[p], adj[p] * std_errs[p],
                                     std_errs[p] ** 2 / prior[p])
        for p in range(P)])
    return ld_diags, chi_stat, adj, inv_z * std_errs


def _floor_mixture_covs(mixture_covs, rel_floor=1e-10):
    """Floor mixture-covariance eigenvalues for sub-f64 precisions (see
    the JAX engine's _floor_mixture_covs: the grid's near-zero spike
    component can land below float32's smallest normal)."""
    w, v = np.linalg.eigh(mixture_covs)                  # [K,P], [K,P,P]
    floor = float(w.max()) * rel_floor
    if w.min() >= floor:
        return mixture_covs
    if w.min() < -floor:
        raise ValueError('Every mixture-component covariance matrix '
                         'must be positive definite.')
    logging.info('f32 path: flooring %d mixture-covariance eigenvalues '
                 'below %.3e (near-zero spike components outside f32 '
                 'range)', int((w < floor).sum()), floor)
    w = np.maximum(w, floor)
    return np.einsum('kpq,kq,krq->kpr', v, w, v)


def resolve_device(device=None):
    """The torch device of a fit: the card unless the caller asks for the
    CPU. Without a CUDA device, asking for (or defaulting to) cuda
    raises; nothing falls back to the host."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: pass "
                           "device='cpu' to run the plain PyTorch "
                           "versions of the kernels on the host")
    return device


def build_model_data(marginal_effects, std_errs, ld_mats, annotations,
                     mixture_covs, scaled, scale_se, gwas_N, init_hg,
                     dtype=torch.float64, device=None):
    """Assemble ModelData with the same validations as VIScheme.__init__;
    every tensor lives on `device` (the card by default, see
    `resolve_device`)."""
    device = resolve_device(device)
    marginal_effects = np.asarray(marginal_effects)
    std_errs = np.asarray(std_errs)
    eps = epsilon(dtype)
    if not np.all(np.isfinite(marginal_effects)):
        raise ValueError('The GWAS effect-size estimates contain a '
                         'non-finite (NaN or infinite) value.')
    if not np.all(np.isfinite(std_errs)):
        raise ValueError('The GWAS standard errors contain a '
                         'non-finite (NaN or infinite) value.')
    num_pops, num_loci = marginal_effects.shape
    if len(ld_mats) != num_pops:
        raise ValueError('One LD matrix is required per population.')
    for ld in ld_mats:
        if not isinstance(ld, blocks_mod.PackedLD):
            raise ValueError('LD Matrices must be of type PackedLD.')
        if ld.shape != (num_loci, num_loci):
            raise ValueError('An LD matrix has a different variant '
                             'count than the GWAS effect sizes.')
    annotations = np.asarray(annotations)
    row_sums = annotations.sum(axis=1)
    # all-zero rows are pad sentinels; anything else must be one-hot
    if not np.all(np.isclose(row_sums, 1) | (row_sums == 0)):
        raise ValueError('Every SNP needs exactly one annotation; '
                         'found rows with zero or several.')
    if annotations.shape[0] != num_loci:
        raise ValueError('The annotation matrix has a different '
                         'variant count than the GWAS effect sizes.')

    mixture_covs = np.asarray(mixture_covs)
    if mixture_covs.shape[1:] != (num_pops, num_pops):
        raise ValueError('Mixture-component covariance matrices must '
                         'be [num_pops x num_pops].')
    signs, log_det = np.linalg.slogdet(mixture_covs)
    if not np.all(signs == 1):
        raise ValueError('Every mixture-component covariance matrix '
                         'must be positive definite.')
    if dtype != torch.float64:
        mixture_covs = _floor_mixture_covs(mixture_covs)
        log_det = np.linalg.slogdet(mixture_covs)[1]
    mixture_prec = np.linalg.inv(mixture_covs)

    if scaled:
        marginal = marginal_effects / (std_errs + eps)
        use_std_errs = np.ones_like(std_errs)
        scalings = std_errs + eps
    else:
        marginal = np.copy(marginal_effects)
        use_std_errs = np.copy(std_errs)
        scalings = np.ones_like(std_errs)

    def dev(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), device=device).to(dt)

    # deduplicate by identity: cohorts sharing one LD matrix share its
    # tensors and one matvec pass
    uniq, ld_index = [], []
    for m in ld_mats:
        hit = [j for j, u in enumerate(uniq) if u is m]
        if hit:
            ld_index.append(hit[0])
        else:
            ld_index.append(len(uniq))
            uniq.append(m)
    ld_tuple, ld_index = tuple(uniq), tuple(ld_index)

    marginal_t = dev(marginal)
    std_errs_t = dev(use_std_errs)
    ld_diags, chi_stat, adj, inverse_betas = _precompute_stats(
        ld_tuple, ld_index, marginal_t, std_errs_t, dev(gwas_N),
        dev(init_hg), dev((row_sums > 0).astype(np.float64)))

    ld_diags_np = ld_diags.cpu().numpy()
    if not np.allclose(adj.cpu().numpy()[np.isclose(ld_diags_np, 0)], 0):
        raise ValueError('SNPs absent from the LD matrix have nonzero '
                         'adjusted marginal effects; they should have '
                         'been marked missing upstream.')

    num_annotations = annotations.shape[1]
    annot_idx = np.where(row_sums > 0, np.argmax(annotations, axis=1),
                         num_annotations).astype(np.int32)
    return ModelData(
        marginal_effects=marginal_t,
        std_errs=std_errs_t,
        scalings=dev(scalings),
        ld_diags=ld_diags,
        scaled_ld_diags=std_errs_t ** -2 * ld_diags,
        adj_marginal_effects=adj,
        chi_stat=chi_stat,
        ld_ranks=dev([ld.get_rank() for ld in ld_mats]),
        inverse_betas=inverse_betas,
        annotations=dev(annot_idx, torch.int32),
        annotation_counts=dev(annotations.sum(axis=0)),
        mixture_prec=dev(mixture_prec),
        log_det=dev(log_det),
        ld=ld_tuple,
        num_annotations=int(num_annotations),
        scale_se=bool(scale_se),
        ld_index=ld_index,
    )


# ---------------------------------------------------------------------------
# User-facing engine
# ---------------------------------------------------------------------------

# outputs whose derived [K, *, I] members exceed this stream to disk in
# chunks instead of materializing (MultiPopVI.dump_spec)
_STREAM_OUTPUT_BYTES = 1 << 28


def _np(x):
    return x.detach().cpu().numpy()


class MultiPopVI:
    """Equivalent of the reference MultiPopVI
    (variational_inference.py:567-889): same constructor surface plus
    `dtype` and `device` (the card unless device='cpu'), same optimize()
    and output arrays. Fits of P <= 3 cohorts carry a compact state,
    P >= 4 the materialized one (VIState)."""

    def __init__(self, marginal_effects=None, std_errs=None, ld_mats=None,
                 annotations=None, mixture_covs=None, checkpoint=True,
                 checkpoint_freq=5, scaled=False, scale_se=False,
                 output='vilma_output', gwas_N=None, init_hg=None,
                 num_its=None, dtype=torch.float64, device=None):
        for name, val in [('marginal_effects', marginal_effects),
                          ('std_errs', std_errs), ('ld_mats', ld_mats),
                          ('annotations', annotations),
                          ('mixture_covs', mixture_covs),
                          ('gwas_N', gwas_N), ('init_hg', init_hg),
                          ('num_its', num_its)]:
            if val is None:
                raise ValueError(f'{name} must be specified when calling '
                                 'MultiPopVI()')
        self.data = build_model_data(
            marginal_effects, std_errs, ld_mats, annotations, mixture_covs,
            scaled, scale_se, gwas_N, init_hg, dtype=dtype, device=device)
        self.scaled = scaled
        self.scale_se = scale_se
        self.checkpoint = checkpoint
        self.checkpoint_freq = checkpoint_freq
        self.checkpoint_path = '%s-checkpoint' % output
        self.num_its = num_its
        self.num_pops, self.num_loci = self.data.marginal_effects.shape
        self.num_mix = self.data.mixture_prec.shape[0]
        self.num_annotations = self.data.num_annotations
        # the compact states need the closed-form sigma algebra (P <= 3);
        # beyond it the fit carries the materialized state
        self._compact = self.num_pops <= 3
        # compact scale_se fits carry a per-component [K, P, I] natural
        # mean; when that state would be too large (the production mixture
        # grid at genome scale: 582 x 2 x 1M f32 is 4.66 GB) they switch
        # to the epoch-history representation, exact and bounded
        kdim_bytes = (self.num_mix * self.num_pops * self.num_loci
                      * self._np_dtype.itemsize)
        self._epoch = bool(self._compact and scale_se
                           and kdim_bytes > _EPOCH_STATE_BYTES)
        self._hist_cap_warned = False
        if self._epoch:
            logging.info(
                'scale_se state uses the epoch-history representation '
                '(the per-component [K, P, I] state would be %.1f GiB)',
                kdim_bytes / 2 ** 30)
        self.state = None

    @property
    def _dtype(self):
        return self.data.marginal_effects.dtype

    @property
    def _np_dtype(self):
        return np.dtype(str(self._dtype).replace('torch.', ''))

    @property
    def error_scaling(self):
        return _np(self.state.error_scaling)

    @property
    def scalings(self):
        return _np(self.data.scalings)

    def vi_sigma_chunks(self, chunk_k=None):
        """Yield vi_sigma in [<=chunk_k, P, P, I] component chunks
        (~256 MB each by default), for utils/npz_stream."""
        K, P = self.num_mix, self.num_pops
        if chunk_k is None:
            per_k = max(self.num_loci * P * P * self._np_dtype.itemsize, 1)
            chunk_k = max(1, min(K, (256 << 20) // per_k))
        dterm = _diag_term(self.data, self.state.error_scaling)
        for k0 in range(0, K, chunk_k):
            yield _np(sigma_mod.materialize_sigma(
                self.data.mixture_prec[k0:k0 + chunk_k], dterm))

    # -- genome-scale output streaming (see dump_spec) ---------------------
    def _stream_big(self):
        """Whether derived [K, *, I] outputs exceed the in-memory budget."""
        return (self.num_mix * self.num_pops * self.num_loci
                * self._np_dtype.itemsize > _STREAM_OUTPUT_BYTES)

    def vi_mu_chunks(self, st=None, chunk_k=None):
        """Yield vi_mu in [<=chunk_k, P, I] component chunks derived from
        the state (vi_mu_k = sigma_k @ nat_k; epoch states sum their
        history, sigma.compact_exprs_epochs)."""
        st = st or self.state
        K, P = self.num_mix, self.num_pops
        if chunk_k is None:
            per_k = max(self.num_loci * P * self._np_dtype.itemsize, 1)
            chunk_k = max(1, min(K, (256 << 20) // per_k))
        data = self.data
        dterm = _diag_term(data, st.error_scaling)
        for k0 in range(0, K, chunk_k):
            prec = data.mixture_prec[k0:k0 + chunk_k]
            if st.nat_hist is not None:
                yield _np(_epoch_exprs(prec, data.scaled_ld_diags,
                                       st.error_scaling, st).mu)
                continue
            nat = (st.nat_mu[k0:k0 + chunk_k] if st.nat_mu.dim() == 3
                   else st.nat_mu[None].expand((prec.shape[0],)
                                               + tuple(st.nat_mu.shape)))
            yield _np(sigma_mod.apply_sigma(prec, dterm, nat))

    def _derived_col_chunks(self, st, chunk_i=None):
        """Yield (vi_delta [c, K], pm [P, c], pv [P, c]) over variant
        chunks (bounded device memory)."""
        st = st or self.state
        K, P, n = self.num_mix, self.num_pops, self.num_loci
        if chunk_i is None:
            chunk_i = max(1024, (64 << 20) // max(K * P * 4, 1))
        data = self.data
        for i0 in range(0, n, chunk_i):
            sl = slice(i0, i0 + chunk_i)
            natvd = kernels.fast_vi_delta_grad(
                st.hyper_delta, data.log_det, data.annotations[sl])
            if st.nat_hist is not None:
                ex = _epoch_exprs(data.mixture_prec, data.scaled_ld_diags,
                                  st.error_scaling, st, sl)
            else:
                dt_c = data.scaled_ld_diags[:, sl] / st.error_scaling[:, None]
                ex = sigma_mod.compact_exprs(data.mixture_prec, dt_c,
                                             st.nat_mu[..., sl])
            addenda = ex.log_det_sigma + ex.quad
            li = 0.5 * (addenda[:-1] - addenda[-1:]) + natvd
            vi_delta = kernels.invert_nat_cat_2D(li)             # [K, c]
            pm = torch.einsum('kpc,kc->pc', ex.mu, vi_delta)
            second = torch.einsum('kpc,kc->pc', ex.diag + ex.mu ** 2,
                                  vi_delta)
            yield _np(vi_delta.T), _np(pm), _np(second - pm ** 2)

    def vi_delta_chunks(self, st=None, chunk_i=None):
        """Yield the [I, K] (reference-layout) vi_delta in row chunks."""
        for vd, _, _ in self._derived_col_chunks(st, chunk_i):
            yield vd

    def dump_spec(self, st=None):
        """(arrays, streams) covering the reference checkpoint/.npz key set
        (vi_mu, vi_delta, hyper_delta, error_scaling, scalings), plus the
        epoch keys of an epoch-history state.

        Small problems return everything materialized in `arrays`;
        problems whose derived [K, *, I] members exceed the budget stream
        vi_mu (component chunks) and vi_delta (variant chunks) for
        utils/npz_stream.save_npz_stream."""
        st = st or self.state
        if st.nat_mu is None or not self._stream_big():
            return self.create_dump_dict(st), []
        arrays = {
            'hyper_delta': _np(st.hyper_delta),
            'error_scaling': _np(st.error_scaling),
            'scalings': _np(self.data.scalings),
        }
        arrays.update(self._epoch_dump_arrays(st))
        K, P, n = self.num_mix, self.num_pops, self.num_loci
        dtype = self._np_dtype
        streams = [
            ('vi_mu', (K, P, n), dtype, self.vi_mu_chunks(st)),
            ('vi_delta', (n, K), dtype, self.vi_delta_chunks(st)),
        ]
        return arrays, streams

    def create_dump_dict(self, st=None):
        st = st or self.state
        if st.vi_mu is None and self._stream_big():
            raise MemoryError(
                'materializing the derived vi_mu/vi_delta of this '
                'problem needs tens of GB; use dump_spec() + '
                'utils/npz_stream.save_npz_stream (fit does this '
                'automatically)')
        mat = st if st.vi_mu is not None else materialize_state(self.data,
                                                                 st)
        out = {
            'vi_mu': _np(mat.vi_mu),
            'vi_delta': _np(mat.vi_delta).T,
            'hyper_delta': _np(mat.hyper_delta),
            'error_scaling': _np(mat.error_scaling),
            'scalings': _np(self.data.scalings),
        }
        out.update(self._epoch_dump_arrays(st))
        return out

    def _epoch_dump_arrays(self, st):
        """Extra checkpoint keys of an epoch-history state: the state
        itself, which a genome-scale resume restores directly."""
        if st.nat_hist is None:
            return {}
        return {
            'nat_u': _np(st.nat_mu),
            'nat_hist': _np(st.nat_hist),
            'nat_hist_scale': _np(st.nat_hist_scale),
            'nat_hist_c': _np(st.nat_hist_c),
            'nat_hist_n': np.asarray(st.nat_hist_n, dtype=np.int32),
        }

    def _streamed_moments(self, st):
        """(posterior mean, variance) assembled from bounded chunks."""
        P, n = self.num_pops, self.num_loci
        pm = np.empty((P, n), dtype=self._np_dtype)
        pv = np.empty((P, n), dtype=self._np_dtype)
        pos = 0
        for _, pm_c, pv_c in self._derived_col_chunks(st):
            c = pm_c.shape[1]
            pm[:, pos:pos + c] = pm_c
            pv[:, pos:pos + c] = pv_c
            pos += c
        scalings = self.scalings
        return pm * scalings, pv * scalings ** 2

    def real_posterior_mean(self, st=None):
        st = st or self.state
        if st.vi_mu is None and self._stream_big():
            return self._streamed_moments(st)[0]
        mat = st if st.vi_mu is not None else materialize_state(self.data,
                                                                 st)
        return _np(kernels.fast_posterior_mean(mat.vi_mu, mat.vi_delta)
                   * self.data.scalings)

    def real_posterior_variance(self, st=None):
        st = st or self.state
        if st.vi_mu is None and self._stream_big():
            return self._streamed_moments(st)[1]
        mat = st if st.vi_mu is not None else materialize_state(self.data,
                                                                 st)
        mean = kernels.fast_posterior_mean(mat.vi_mu, mat.vi_delta)
        return _np(kernels.fast_pmv(mean, mat.vi_mu, mat.vi_delta,
                                    mat.sigma.diag)
                   * self.data.scalings ** 2)

    def elbo_value(self, st=None):
        """The ELBO of a state (the beta objective equals the ELBO in
        MultiPopVI: the annotation KL is 0)."""
        st = st or self.state
        obj, _, _ = _objective(self.data, st, _params(st), st.hyper_delta)
        return _sync_float(obj)

    def _tensor(self, x, dtype=None):
        """A host array (a read-only memmap slice, say) copied into a
        tensor on the fit's device, in its dtype."""
        return torch.as_tensor(
            np.array(x, dtype=dtype or self._np_dtype),
            device=self.data.marginal_effects.device)

    def _fresh_state(self, error_scaling=None):
        """The state before initialization or resume. The materialized
        one holds its sigma summaries; its caller sets vi_mu, vi_delta
        and nat_grad_vi_delta."""
        zeros = dict(dtype=self._dtype,
                     device=self.data.marginal_effects.device)
        P, I, K = self.num_pops, self.num_loci, self.num_mix
        st = VIState(
            nat_mu=torch.zeros(P, I, **zeros) if self._compact else None,
            hyper_delta=torch.zeros(self.num_annotations, K, **zeros),
            error_scaling=(torch.ones(P, **zeros) if error_scaling is None
                           else self._tensor(error_scaling)),
            L=(1., 1., 1.), elbo=0., running_elbo_delta=math.nan,
            num_err=0)
        if not self._compact:
            st = dataclasses.replace(st, sigma=sigma_mod.make_summaries(
                self.data.mixture_prec, self.data.log_det,
                _diag_term(self.data, st.error_scaling)))
        if self._epoch:
            B0 = _EPOCH_BUCKETS[0]
            st = dataclasses.replace(
                st, nat_hist=torch.zeros(B0, P, I, **zeros),
                nat_hist_scale=torch.ones(B0, P, **zeros),
                nat_hist_c=torch.zeros(B0, **zeros), nat_hist_n=0)
        return st

    def _initialize(self):
        st = self._fresh_state()
        data = self.data
        fake = make_fake_mu(_np(data.inverse_betas), _np(data.std_errs),
                            _np(data.ld_diags))
        fake_mu = torch.as_tensor(
            fake.astype(self._np_dtype),
            device=data.marginal_effects.device)
        logging.info('Max |inverse_beta| at initialization: %f',
                     float(torch.max(torch.abs(data.inverse_betas))))
        if not self._compact:
            hyper, _, vi_mu, vi_delta, nat_vd = initialize_from_fake_mu(
                data, st.error_scaling, fake_mu, sigma=st.sigma)
            return dataclasses.replace(st, vi_mu=vi_mu, vi_delta=vi_delta,
                                       hyper_delta=hyper,
                                       nat_grad_vi_delta=nat_vd)
        hyper, temp_nat = initialize_from_fake_mu(data, st.error_scaling,
                                                  fake_mu)
        if self.scale_se and not self._epoch:
            # initialization is K-constant (error_scaling all ones): the
            # per-component state starts as a broadcast, copied so that
            # every component owns its row (the epoch state instead starts
            # with temp_nat as its accumulator and an empty history)
            temp_nat = temp_nat[None].expand(
                (self.num_mix,) + tuple(temp_nat.shape)).contiguous()
        return dataclasses.replace(st, nat_mu=temp_nat, hyper_delta=hyper)

    def _state_from_checkpoint(self, loaded_checkpoint):
        """The state a checkpoint (np.load of a checkpoint or output .npz
        of either package, or a mapping of its arrays) resumes (reference
        MultiPopVI._state_from_checkpoint). The shared and kdim natural
        means are recovered from vi_mu (exact given the checkpoint's
        error_scaling); the epoch state is restored from its own keys and
        the materialized one from vi_mu and vi_delta. The port does not
        pad loci, so the checkpoint's variant order is the fit's."""
        files = getattr(loaded_checkpoint, 'files', loaded_checkpoint)
        error_scaling = None
        if 'error_scaling' in files:
            error_scaling = loaded_checkpoint['error_scaling']
        else:
            logging.warning('The checkpoint carries no "error_scaling" '
                            'entry; defaulting all error scalings to 1.')
        st = self._fresh_state(error_scaling)
        hyper = self._tensor(loaded_checkpoint['hyper_delta'])
        if self._epoch:
            if 'nat_u' not in files:
                raise ValueError(
                    'this fit uses the epoch-history scale_se state '
                    '(the per-component [K, P, I] state would not fit '
                    'in device memory), but the checkpoint lacks the '
                    'epoch keys (nat_u/nat_hist/...). Resume from a '
                    'checkpoint written by this engine, or shrink the '
                    'problem below the epoch threshold.')
            # the history keeps the checkpoint's length B, one of
            # _EPOCH_BUCKETS; _maybe_grow_hist grows it from there
            return dataclasses.replace(
                st, nat_mu=self._tensor(loaded_checkpoint['nat_u']),
                nat_hist=self._tensor(loaded_checkpoint['nat_hist']),
                nat_hist_scale=self._tensor(
                    loaded_checkpoint['nat_hist_scale']),
                nat_hist_c=self._tensor(loaded_checkpoint['nat_hist_c']),
                nat_hist_n=int(loaded_checkpoint['nat_hist_n']),
                hyper_delta=hyper)
        if not self._compact:
            return dataclasses.replace(
                st, vi_mu=self._tensor(loaded_checkpoint['vi_mu']),
                vi_delta=self._tensor(
                    np.asarray(loaded_checkpoint['vi_delta']).T),
                hyper_delta=hyper,
                nat_grad_vi_delta=kernels.fast_vi_delta_grad(
                    hyper, self.data.log_det, self.data.annotations))
        if self._stream_big():
            # genome-scale resume: the vi_mu member can be tens of GB;
            # recover the natural mean(s) in bounded chunks straight off
            # the uncompressed zip member
            nat = self._nat_from_checkpoint_streamed(loaded_checkpoint,
                                                     st)
            return dataclasses.replace(st, nat_mu=nat, hyper_delta=hyper)
        vi_mu = self._tensor(loaded_checkpoint['vi_mu'])
        recover = compact_nat_mu_k if self.scale_se else compact_nat_mu
        nat = recover(self.data, st.error_scaling, vi_mu).contiguous()
        return dataclasses.replace(st, nat_mu=nat, hyper_delta=hyper)

    def _nat_from_checkpoint_streamed(self, loaded_checkpoint, st):
        """Bounded-memory natural-mean recovery (see
        _state_from_checkpoint): the shared state needs only vi_mu[0];
        the kdim state is recovered in K-chunks of at most
        _RESUME_CHUNK_BYTES, each written straight into the [K, P, I]
        tensor on the device, so the host holds one chunk at a time."""
        from vilma_tpu_torch.utils.npz_stream import npz_member_memmap
        mm = npz_member_memmap(loaded_checkpoint, 'vi_mu')
        if mm is None:
            logging.warning('checkpoint vi_mu member is not mappable '
                            '(compressed?); falling back to a '
                            'materialized read')
            mm = loaded_checkpoint['vi_mu']
        if not self.scale_se:
            return compact_nat_mu(self.data, st.error_scaling,
                                  self._tensor(mm[0])[None]).contiguous()
        K, P, I = self.num_mix, self.num_pops, self.num_loci
        chunk = max(1, _RESUME_CHUNK_BYTES
                    // max(P * I * self._np_dtype.itemsize, 1))
        dterm = _diag_term(self.data, st.error_scaling)
        nat = torch.empty((K, P, I), dtype=self._dtype,
                          device=self.data.marginal_effects.device)
        for k0 in range(0, K, chunk):
            part = self._tensor(mm[k0:k0 + chunk])
            nat[k0:k0 + part.shape[0]] = sigma_mod.apply_precision(
                self.data.mixture_prec[k0:k0 + chunk], dterm, part)
        return nat

    def _posterior_mean(self, st):
        if st.nat_mu is None:
            pm = kernels.fast_posterior_mean(st.vi_mu, st.vi_delta)
        else:
            _, pm, _ = _objective(self.data, st, _params(st),
                                  st.hyper_delta)
        return pm * self.data.scalings

    def optimize(self, loaded_checkpoint=None):
        """Coordinate ascent until convergence (reference optimize(),
        variational_inference.py:340-394), from the initialization or,
        given `loaded_checkpoint` (np.load of a checkpoint .npz), from
        the state it holds; a resumed fit may converge before step 10."""
        from vilma_tpu_torch.utils.npz_stream import save_npz_stream
        data = self.data
        if loaded_checkpoint is None:
            st = self._initialize()
        else:
            st = self._state_from_checkpoint(loaded_checkpoint)
        st = dataclasses.replace(st, elbo=self.elbo_value(st))
        converged = False
        num_its = 0
        post_mean = self._posterior_mean(st)
        ckp_post_mean = post_mean
        prev_err = 0
        while num_its < self.num_its and not converged:
            if num_its % self.checkpoint_freq == 0 and self.checkpoint:
                arrays, streams = self.dump_spec(st)
                save_npz_stream('{}.{}'.format(self.checkpoint_path,
                                               num_its), arrays, streams)
                ckp_post_mean = self._posterior_mean(st)
            st, new_post_mean = outer_step(data, st, line_search_rate=2.0)
            if self._epoch:
                # keep a free epoch slot ahead of the next EM event, so
                # the append never freezes before the hard cap
                st = self._maybe_grow_hist(st)
            stats = _conv_stats(new_post_mean, post_mean, ckp_post_mean, st)
            num_err = int(stats[0])
            if num_err > prev_err:
                raise RuntimeError('Encountered a numerical error.')
            prev_err = num_err
            # the f32 line-search guard is loose (_err_rtol), so a fit
            # that degenerates to NaN is caught here
            if np.isnan(stats[1]) or np.isnan(stats[4]):
                raise RuntimeError('Encountered a numerical error '
                                   '(non-finite ELBO or posterior mean).')
            red = float(stats[2])
            converged = bool(stats[3]) or bool(
                np.isclose(red, 0, atol=ELBO_TOL, rtol=0))
            if num_its < 10 and loaded_checkpoint is None:
                converged = False
            self._dump_info(num_its, stats)
            post_mean = new_post_mean
            num_its += 1

        if num_its == self.num_its:
            logging.warning('Failed to converge')
        logging.info('Optimization ran for %d iterations', num_its)
        # production grids at genome scale keep the compact state; their
        # outputs go through the chunked paths (dump_spec,
        # _streamed_moments, vi_sigma_chunks)
        self.state = (st if self._stream_big()
                      else materialize_state(data, st))
        return self.state

    def _maybe_grow_hist(self, st):
        """Grow the epoch buffer to the next bucket once nearly full; at
        the hard cap, warn once that further EM updates are frozen."""
        B = st.nat_hist.shape[0]
        n = st.nat_hist_n
        if n < B - 1:
            return st
        if B >= _EPOCH_CAP:
            if n >= B and not self._hist_cap_warned:
                logging.warning(
                    'error-scaling epoch history reached its cap (%d); '
                    'further EM updates are frozen (the scaling has '
                    'seen %d re-basings and is effectively converged)',
                    _EPOCH_CAP, n)
                self._hist_cap_warned = True
            return st
        nb = next(b for b in _EPOCH_BUCKETS if b > B)
        pad = nb - B
        logging.info('epoch history grown %d -> %d slots', B, nb)
        return dataclasses.replace(
            st,
            nat_hist=torch.cat([st.nat_hist, st.nat_hist.new_zeros(
                (pad,) + tuple(st.nat_hist.shape[1:]))]),
            nat_hist_scale=torch.cat([st.nat_hist_scale,
                                      st.nat_hist_scale.new_ones(
                                          (pad, self.num_pops))]),
            nat_hist_c=torch.cat([st.nat_hist_c,
                                  st.nat_hist_c.new_zeros(pad)]))

    def _dump_info(self, num_its, stats):
        """Per-iteration telemetry (reference _dump_info,
        variational_inference.py:292-331)."""
        logging.info('Completed iteration %d', num_its + 1)
        logging.info('ELBO = %f, running delta = %f', float(stats[1]),
                     float(stats[2]))
        logging.info('Maximum posterior mean beta: %e', float(stats[4]))
        logging.info('SE scaling is: %r', np.asarray(stats[8:]))
        logging.info('Max relative difference is: %e', float(stats[5]))
        logging.info('Max absolute difference is: %e', float(stats[6]))
        logging.info('RMSE difference (checkpoint iterations) is: %e',
                     float(stats[7]))
