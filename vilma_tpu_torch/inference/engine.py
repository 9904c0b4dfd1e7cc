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

A sharded fit (parallel/mesh.py) runs the same host loop over the
shards of its process: ShardedData and ShardedState hold one ModelData
and one VIState per shard, every per-SNP step (the kernels among them)
runs on each shard's own operands, and the sums the JAX package gets
from psum or from XLA (the objective's likelihood sums and beta-KL, the
[A, K] annotation sums, the EM's statistics, the convergence statistics,
the initialization's and the precompute's sums) are added across shards
by the mesh before the one host fetch each evaluation already makes. An
unsharded fit is the one-shard case with no mesh.

Under component sharding (mesh.n_comp = M > 1) each shard holds a slice
of the K components of its [K, ...] tables and state. An evaluation then
runs the K-split prologue on every shard, gathers the M partials of each
snp column, merges them (replicated over comp), and runs the matvec and
the likelihood on every comp replica; the values the comp shards of a
column hold alike (the likelihood, the compact KL, the EM and
convergence statistics, the precompute's sums) are added by the comp-0
shard alone (`Mesh.counts_once`). The materialized state reduces its
posterior moments and the softmax over K (vi_delta) over comp; its KL
terms are the slice's own and add on every shard. The annotation sums
add over the snp shards of each comp row, their normalization over the
comp shards. At M = 1 none of this runs: the whole-K kernels do.
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


@dataclass(frozen=True)
class ShardedData:
    """The ModelData of a sharded fit: one ModelData per shard of this
    process (its span of every [*, I] array, its shard of each LD matrix,
    copies of the small tables and of the global chi_stat, ld_ranks and
    annotation_counts), and the mesh that reduces across shards."""
    shards: tuple
    mesh: object


# VIState fields that are the same on every shard: host scalars and
# small replicated tensors (each shard holds a copy on its device);
# hyper_delta only without comp, which splits its columns
_SHARED_FIELDS = ('L', 'elbo', 'running_elbo_delta', 'num_err',
                  'nat_hist_n', 'hyper_delta', 'error_scaling',
                  'nat_hist_scale', 'nat_hist_c')


@dataclass(frozen=True)
class ShardedState:
    """The VIState of a sharded fit: one per shard of this process. The
    fields every shard shares read through (the first shard's copy)."""
    shards: tuple
    n_comp: int = 1

    def __getattr__(self, name):
        if name == 'hyper_delta' and self.n_comp > 1:
            raise AttributeError('hyper_delta is split over the comp '
                                 'shards: gather it (MultiPopVI outputs)')
        if name in _SHARED_FIELDS:
            return getattr(self.shards[0], name)
        raise AttributeError(name)


def _unpack(data, st):
    """(per-shard ModelData list, VIState list, mesh) of a fit: one shard
    and no mesh when unsharded."""
    if isinstance(data, ShardedData):
        return list(data.shards), list(st.shards), data.mesh
    return [data], [st], None


def _repack(data, states):
    """The per-shard states in the form of `data`'s fit."""
    if isinstance(data, ShardedData):
        return ShardedState(tuple(states), n_comp=data.mesh.n_comp)
    return states[0]


def _comp(mesh):
    """Whether the fit's K components are split over comp shards."""
    return mesh is not None and mesh.n_comp > 1


def _once(mesh, j, x):
    """x where local shard j adds values its column's comp shards hold
    alike, else zeros (the comp-0 shard adds them, once)."""
    if mesh is None or mesh.counts_once(j):
        return x
    return torch.zeros_like(x)


def _reduce(mesh, parts):
    """The sum over every shard of one partial per local shard."""
    return parts[0] if mesh is None else mesh.sum(parts)


def _replicas(mesh, x):
    """x (a value every shard shares) on each local shard's device."""
    return [x] if mesh is None else list(mesh.replicate(x))


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


def _fused_split(data, st, params, hyper_delta, norm=None, sums=False):
    """The K-split kernels of the state's form over the shard's slice of
    K: the prologue's [3 + 2P, I] partial; with sums=True the sums' pass
    1 [2, I] partial, or, given the merged normalizer `norm`, pass 2's
    [A, K_slice] sums."""
    A = data.num_annotations
    if st.nat_hist is None:
        ops = _fused_operands(data, st.error_scaling, params[0],
                              hyper_delta)
        kw = dict(num_annotations=A)
        fns = (compact_obj.prologue_partial, compact_obj.delta_norm,
               compact_obj.delta_sums_given)
    else:
        ops = _epoch_operands(data, st, *params, hyper_delta)
        kw = dict(num_annotations=A, num_live=st.nat_hist_n)
        fns = (compact_obj.prologue_epochs_partial,
               compact_obj.delta_norm_epochs,
               compact_obj.delta_sums_epochs_given)
    if not sums:
        return fns[0](*ops, **kw)
    if norm is None:
        return fns[1](*ops, **kw)
    return fns[2](*ops, norm, **kw)


def _moments(data, st, params, hyper_delta):
    """(post_means, post_vars, beta_kl) of a parameter point on one
    shard holding all K: the fused prologue, or on the materialized state
    its unfused twins."""
    if st.nat_mu is None:
        post_means = posterior_mean(*params)
        post_vars = posterior_marginal_variance(post_means, *params,
                                                st.sigma)
        return (post_means, post_vars,
                beta_KL(data, st.sigma, *params, hyper_delta))
    return _fused(data, st, params, hyper_delta)


def _moments_all(ds, ss, mesh, params, hyper_deltas):
    """`_moments` on every shard. Under comp: a compact state runs the
    K-split prologue per shard, gathers each column's partials and merges
    them (replicated over comp: the KL too); the materialized state adds
    its [P] moments over comp and keeps its slice's own KL terms."""
    if not _comp(mesh):
        return [_moments(d, s, p, h)
                for d, s, p, h in zip(ds, ss, params, hyper_deltas)]
    if ss[0].nat_mu is not None:
        stacks = mesh.comp_gather([_fused_split(d, s, p, h) for d, s, p, h
                                   in zip(ds, ss, params, hyper_deltas)])
        return [compact_obj.prologue_merge(
            st, d.annotations, num_annotations=d.num_annotations)
            for d, st in zip(ds, stacks)]
    parts = [torch.cat([kernels.fast_posterior_mean(mu, vd),
                        torch.sum((mu ** 2 + s.sigma.diag) * vd[:, None, :],
                                  dim=0)])
             for s, (mu, vd) in zip(ss, params)]
    out = []
    for d, s, p, h, tot in zip(ds, ss, params, hyper_deltas,
                               mesh.comp_sum(parts)):
        P = tot.shape[0] // 2
        pm = tot[:P]
        out.append((pm, tot[P:] - pm ** 2,
                    beta_KL(d, s.sigma, *p, h)))
    return out


def _objective_terms(data, st, params, hyper_delta, moments=None):
    """(the [P] likelihood sums over this shard's SNPs, its beta-KL,
    post_means, linked) of a parameter point: the fused prologue, the LD
    matvec and the likelihood's per-SNP part (reference
    variational_inference.py:452-490, 632-641, 868-885); on the
    materialized state their unfused twins. `moments` (post_means,
    post_vars, beta_kl) may be given (a comp-sharded fit's)."""
    if moments is None:
        moments = _moments(data, st, params, hyper_delta)
    post_means, post_vars, beta_kl = moments
    scaled_mu, linked_ests = _ld_scaled_dot(data, post_means)
    ll = kernels.likelihood_partial(
        post_means, post_vars, scaled_mu, data.scaled_ld_diags,
        linked_ests, data.adj_marginal_effects)
    return ll, beta_kl, post_means, linked_ests


def _finish(data, st, ll, beta_kl):
    """The objective from the sums over every shard."""
    return kernels.likelihood_finish(ll, data.chi_stat, data.ld_ranks,
                                     st.error_scaling) - beta_kl


def _objective(data, st, params, hyper_delta):
    """(objective tensor, post_means, linked) of a parameter point of an
    unsharded fit."""
    ll, beta_kl, post_means, linked = _objective_terms(data, st, params,
                                                       hyper_delta)
    return _finish(data, st, ll, beta_kl), post_means, linked


def _evaluate(ds, ss, mesh, params, hyper_deltas, failures=None):
    """The objective of a parameter point (one entry of `params` and
    `hyper_deltas` per shard) on the host, with its post_means and linked
    per shard. The shards' [P + 2] partials (likelihood sums, beta-KL,
    Cholesky failures of the trial) are added across shards and fetched
    in one synchronization; a failure raises (sigma.check_cholesky)."""
    global host_syncs
    failures = failures or [[] for _ in ds]
    moments = (_moments_all(ds, ss, mesh, params, hyper_deltas)
               if _comp(mesh) else [None] * len(ds))
    # the materialized KL terms are each comp slice's own
    kl_once = ss[0].nat_mu is not None
    parts, pms, lks = [], [], []
    for j, (d, s, p, h, f, mo) in enumerate(zip(ds, ss, params,
                                                hyper_deltas, failures,
                                                moments)):
        ll, kl, pm, lk = _objective_terms(d, s, p, h, mo)
        if _comp(mesh):
            ll = _once(mesh, j, ll)
            kl = _once(mesh, j, kl) if kl_once else kl
        bad = (sum(f).to(ll.dtype) if f else ll.new_zeros(()))
        parts.append(torch.cat([ll, kl.reshape(1).to(ll.dtype),
                                bad.reshape(1)]))
        pms.append(pm)
        lks.append(lk)
    vec = _reduce(mesh, parts)
    P = vec.shape[0] - 2
    obj = _finish(ds[0], ss[0], vec[:P], vec[P])
    if not any(failures):
        return _sync_float(obj), pms, lks
    host_syncs += 1
    value, bad = torch.stack([obj, vec[P + 1]]).tolist()
    sigma_mod.check_cholesky(bad)
    return value, pms, lks


# ---------------------------------------------------------------------------
# The objective of the materialized state (P >= 4): the same terms from
# the stored [K, P, I] and [K, I] arrays (JAX package engine.py:195-366)
# ---------------------------------------------------------------------------

def posterior_mean(vi_mu, vi_delta):
    return kernels.fast_posterior_mean(vi_mu, vi_delta)


def posterior_marginal_variance(mean, vi_mu, vi_delta, sigma):
    return kernels.fast_pmv(mean, vi_mu, vi_delta, sigma.diag)


def log_likelihood_terms(data, sigma, error_scaling, vi_mu, vi_delta):
    """(expected log likelihood, post_means, linked) with linked =
    LD.(post_means / SE) (variational_inference.py:452-470)."""
    post_means = posterior_mean(vi_mu, vi_delta)
    post_vars = posterior_marginal_variance(post_means, vi_mu, vi_delta,
                                            sigma)
    scaled_mu, linked = _ld_scaled_dot(data, post_means)
    ll = kernels.fast_likelihood(
        post_means, post_vars, scaled_mu, data.scaled_ld_diags, linked,
        data.adj_marginal_effects, data.chi_stat, data.ld_ranks,
        error_scaling)
    return ll, post_means, linked


def log_likelihood(data, sigma, error_scaling, vi_mu, vi_delta):
    """Expected log likelihood (variational_inference.py:452-470)."""
    return log_likelihood_terms(data, sigma, error_scaling, vi_mu,
                                vi_delta)[0]


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


def elbo(data, sigma, error_scaling, vi_mu, vi_delta, hyper_delta):
    """Evidence lower bound of materialized parameters
    (variational_inference.py:412-417): differentiable in vi_mu,
    vi_delta and hyper_delta (inference/gradient.py)."""
    return _beta_objective_terms(data, sigma, error_scaling, vi_mu,
                                 vi_delta, hyper_delta)[0]


def nat_to_not_vi_delta(data, sigma, error_scaling, vi_mu,
                        nat_grad_vi_delta):
    """Closed-form vi_delta from the natural parameters
    (variational_inference.py:632-641)."""
    nat = sigma_mod.apply_precision(data.mixture_prec,
                                    _diag_term(data, error_scaling), vi_mu)
    return kernels.fast_invert_nat_vi_delta(vi_mu, nat, sigma.log_det_sigma,
                                            nat_grad_vi_delta)


def _comp_vi_delta(ds, mesh, vi_mus, nats, log_det_sigmas, hyper_deltas):
    """vi_delta [K_slice, I] of the materialized state of a comp-sharded
    fit, one per shard: the softmax over all K of z_k = 0.5
    (log_det_sigma_k + vi_mu_k . nat_k) + log hyper[a_i, k] - 0.5
    log_det_k (`nat_to_not_vi_delta`'s, its last-component baseline
    cancelling), its max and normalizer reduced over comp, clamped at
    eps."""
    zs = []
    for d, mu, nat, lds, h in zip(ds, vi_mus, nats, log_det_sigmas,
                                  hyper_deltas):
        sel = kernels._annotation_rows(
            (torch.log(h) - 0.5 * d.log_det).T, d.annotations)
        zs.append(0.5 * (lds + torch.sum(mu * nat, dim=1)) + sel)
    tops = mesh.comp_max([z.amax(dim=0) for z in zs])
    ws = [torch.exp(z - t) for z, t in zip(zs, tops)]
    tots = mesh.comp_sum([w.sum(dim=0) for w in ws])
    eps = epsilon(zs[0].dtype)
    return [torch.clamp(w / t, min=eps) for w, t in zip(ws, tots)]


def _comp_nat_vi_delta(ds, mesh, ss):
    """`nat_to_not_vi_delta` of each state's vi_mu under comp: its
    vi_delta at the state's error_scaling, sigma summaries and
    hyper_delta (`_comp_vi_delta`)."""
    return _comp_vi_delta(
        ds, mesh, [st.vi_mu for st in ss],
        [sigma_mod.apply_precision(d.mixture_prec,
                                   _diag_term(d, st.error_scaling),
                                   st.vi_mu) for d, st in zip(ds, ss)],
        [st.sigma.log_det_sigma for st in ss], [st.hyper_delta for st in ss])


def _objective_compact(data, st, nat_mu, hyper_delta):
    """`_objective` of a shared or kdim natural mean."""
    return _objective(data, st, (nat_mu,), hyper_delta)


def _nat_grad_resid(data, error_scaling, post_mean, linked_raw):
    """The [P, I] natural-gradient residual (constant across mixture
    components — the structural fact the compact state exploits)."""
    linked = kernels.fast_linked_ests(linked_raw, data.std_errs, post_mean,
                                      data.scaled_ld_diags)
    return (data.adj_marginal_effects - linked) / error_scaling[:, None]


def _stepper(data, st, params, grad, comp=False):
    """s -> (the beta parameters a natural-gradient step of size s takes
    from `params`, the trial's Cholesky failure counts). The [P, I]
    gradient is constant in K and broadcasts; the materialized state
    steps its natural mean (prec_k + diag) @ vi_mu_k and solves back for
    vi_mu and vi_delta (variational_inference.py:762-802); under comp
    (`comp`) it returns (vi_mu, the natural mean) for `_comp_vi_delta`."""
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
        if comp:
            return (new_mu, nat), failures
        new_vd = kernels.fast_invert_nat_vi_delta(
            new_mu, nat, st.sigma.log_det_sigma, st.nat_grad_vi_delta)
        return (new_mu, new_vd), failures
    return step


def _update_beta(ds, ss, mesh, orig_obj, cur_post_means, cur_linked,
                 line_search_rate):
    """One natural-gradient step with backtracking line search
    (variational_inference.py:762-802) on the state's beta parameters,
    on every shard. orig_obj is a host float. Returns (params, L0,
    new_obj, post_means, linked, err) for the accepted (or kept)
    parameters, the tensors one per shard."""
    threshold = orig_obj - REL_TOL * abs(orig_obj) - ABS_TOL
    params = [_params(st) for st in ss]
    split_vd = _comp(mesh) and ss[0].nat_mu is None
    steps = [_stepper(d, st, p, _nat_grad_resid(d, st.error_scaling, pm,
                                                lk), split_vd)
             for d, st, p, pm, lk in zip(ds, ss, params, cur_post_means,
                                         cur_linked)]
    hds = [st.hyper_delta for st in ss]

    def trial(L0):
        out = [step(1. / L0) for step in steps]
        new = [o[0] for o in out]
        if split_vd:
            vds = _comp_vi_delta(ds, mesh, [n[0] for n in new],
                                 [n[1] for n in new],
                                 [st.sigma.log_det_sigma for st in ss], hds)
            new = [(n[0], vd) for n, vd in zip(new, vds)]
        obj, pm, lk = _evaluate(ds, ss, mesh, new, hds,
                                [o[1] for o in out])
        return new, obj, pm, lk

    L0 = ss[0].L[0]
    new, new_obj, pm, lk = trial(L0)
    while new_obj < threshold and L0 <= L_MAX:
        L0 = L0 * line_search_rate
        new = pm = lk = None    # free the rejected trial before the next
        new, new_obj, pm, lk = trial(L0)

    err = int(L0 > L_MAX and not _isclose(
        orig_obj, new_obj, rtol=_err_rtol(ss[0].hyper_delta.dtype)))
    if new_obj >= threshold:
        return new, L0, new_obj, pm, lk, err
    return params, L0, orig_obj, cur_post_means, cur_linked, err


def _set(ss, **fields):
    """Every shard's state with the shared `fields` replaced."""
    return [dataclasses.replace(st, **fields) for st in ss]


def _beta_loop(ds, ss, mesh, conv_tol, line_search_rate):
    """Up to MAX_NUM_ITERS beta updates (variational_inference.py:427-439),
    stopping once the objective gain is below conv_tol or L hits its
    bounds. Returns (states, objective delta, final objective,
    post_means, linked)."""
    orig_obj, pm, lk = _evaluate(ds, ss, mesh, [_params(st) for st in ss],
                                 [st.hyper_delta for st in ss])
    L0, num_err = ss[0].L[0], ss[0].num_err
    delta = 0.0
    for _ in range(MAX_NUM_ITERS):
        L0 = max(1., L0 / 1.25)
        ss = _set(ss, L=(L0,) + ss[0].L[1:])
        params, L0, new_obj, pm, lk, err = _update_beta(
            ds, ss, mesh, orig_obj, pm, lk, line_search_rate)
        ss = [_with_params(st, p) for st, p in zip(ss, params)]
        delta = delta + new_obj - orig_obj
        done = (abs(new_obj - orig_obj) <= conv_tol
                or L0 == 1. or L0 > L_MAX)
        num_err += err
        orig_obj = new_obj
        if done:
            break
    ss = _set(ss, L=(L0,) + ss[0].L[1:], num_err=num_err)
    return ss, delta, orig_obj, pm, lk


def _update_hyper_delta(ds, ss, mesh, orig_obj):
    """Closed-form per-annotation mixture-weight update
    (variational_inference.py:825-860), from the annotation sums of
    vi_delta over every shard (fused on a compact state, where vi_delta
    is derived). On the materialized state the new weights also move
    vi_delta and its natural parameter."""
    st0 = ss[0]
    eps = epsilon(st0.hyper_delta.dtype)
    if st0.nat_mu is None:
        sums = [kernels.sum_annotations(st.vi_delta, d.annotations,
                                        d.num_annotations)
                for d, st in zip(ds, ss)]
    elif _comp(mesh):
        # pass 1 over each slice, the merged normalizer, pass 2
        norms = mesh.comp_gather([
            _fused_split(d, st, _params(st), st.hyper_delta, sums=True)
            for d, st in zip(ds, ss)])
        sums = [_fused_split(d, st, _params(st), st.hyper_delta,
                             compact_obj.norm_merge(n), sums=True)
                for d, st, n in zip(ds, ss, norms)]
    else:
        sums = [_fused(d, st, _params(st), st.hyper_delta, sums=True)
                for d, st in zip(ds, ss)]
    if _comp(mesh):
        # each comp row adds its [A, K_slice] sums over its snp shards;
        # the normalization over K adds the rows' [A] sums over comp
        hds = [torch.clamp(h / (d.annotation_counts[:, None] + eps),
                           min=eps)
               for h, d in zip(mesh.snp_sum(sums), ds)]
        hds = [h / t for h, t in zip(hds, mesh.comp_sum(
            [h.sum(dim=1, keepdim=True) for h in hds]))]
    else:
        new_hd = _reduce(mesh, sums)
        new_hd = torch.clamp(
            new_hd / (ds[0].annotation_counts[:, None] + eps), min=eps)
        new_hd = new_hd / new_hd.sum(dim=1, keepdim=True)
        hds = _replicas(mesh, new_hd)
    if st0.nat_mu is None and _comp(mesh):
        vds = _comp_nat_vi_delta(ds, mesh, [
            dataclasses.replace(st, hyper_delta=h) for st, h in zip(ss, hds)])
        ss = [dataclasses.replace(st, vi_delta=vd)
              for st, vd in zip(ss, vds)]
    elif st0.nat_mu is None:
        ss = [dataclasses.replace(
            st, nat_grad_vi_delta=nat_vd, vi_delta=nat_to_not_vi_delta(
                d, st.sigma, st.error_scaling, st.vi_mu, nat_vd))
            for d, st, nat_vd in zip(ds, ss, [
                kernels.fast_vi_delta_grad(h, d.log_det, d.annotations)
                for d, h in zip(ds, hds)])]
    new_obj, pm, lk = _evaluate(ds, ss, mesh, [_params(st) for st in ss],
                                hds)
    ss = [dataclasses.replace(st, hyper_delta=h) for st, h in zip(ss, hds)]
    return ss, new_obj - orig_obj, new_obj, pm, lk


def _update_error_scaling(data, st, orig_obj, post_means, linked):
    """The error-scaling EM of --learn-scaling fits
    (variational_inference.py:472-486, 735-738), from the posterior
    moments and the LD matvec of the current parameters (of a sharded
    fit: one post_means and linked per shard). Returns (state, objective
    delta, post_means)."""
    ds, ss, mesh = _unpack(data, st)
    if mesh is None:
        post_means, linked = [post_means], [linked]
    ss, delta, pms = _error_scaling(ds, ss, mesh, orig_obj, post_means,
                                    linked)
    return (_repack(data, ss), delta,
            tuple(pms) if mesh is not None else pms[0])


def _error_scaling(ds, ss, mesh, orig_obj, post_means, linked):
    """`_update_error_scaling` on per-shard lists. The [P] statistics are
    summed over every shard, then:

    The reference keeps vi_mu fixed while the scaling moves: the
    materialized state refreshes its sigma summaries and vi_delta under
    the new scaling. On a compact state the natural means re-base
    k-dependently: nat'_k = (prec_k + d_new) @ sigma_old_k @ nat_k. The
    kdim state applies that map; the epoch state appends an epoch
    instead (the maps telescope, see sigma.compact_exprs_epochs): the
    accumulator goes into the history with coefficient 1 under the old
    scaling, and a zero accumulator starts under the new one. An epoch
    state freezes (no change) when the relative scaling change is below
    _EPOCH_SKIP_TOL or its buffer is full; the change is one value over
    every shard, so all take the same decision."""
    stats = []
    merged = (_moments_all(ds, ss, mesh, [_params(st) for st in ss],
                           [st.hyper_delta for st in ss])
              if _comp(mesh) else None)
    for j, (d, st, pm, lk) in enumerate(zip(ds, ss, post_means, linked)):
        if merged is not None:
            post_vars = merged[j][1]
        elif st.nat_mu is None:
            post_vars = kernels.fast_pmv(pm, st.vi_mu, st.vi_delta,
                                         st.sigma.diag)
        else:
            post_vars = _fused(d, st, _params(st), st.hyper_delta)[1]
        stats.append(_once(mesh, j, torch.stack([
            torch.einsum('pi,pi->p', pm, d.adj_marginal_effects),
            torch.einsum('pi,pi->p', pm / d.std_errs, lk),
            torch.sum(d.ld_diags * post_vars * d.std_errs ** -2,
                      dim=1)])))
    cross, quad, var = _reduce(mesh, stats)
    d0, st0 = ds[0], ss[0]
    new_scaling = (d0.chi_stat - 2 * cross + quad + var) / d0.ld_ranks
    scalings = _replicas(mesh, new_scaling)
    if st0.nat_mu is None:
        out = []
        for d, st, sc in zip(ds, ss, scalings):
            sigma = sigma_mod.make_summaries(d.mixture_prec, d.log_det,
                                             _diag_term(d, sc))
            out.append(dataclasses.replace(
                st, error_scaling=sc, sigma=sigma,
                vi_delta=None if _comp(mesh) else nat_to_not_vi_delta(
                    d, sigma, sc, st.vi_mu, st.nat_grad_vi_delta)))
        if _comp(mesh):
            out = [dataclasses.replace(st, vi_delta=vd) for st, vd in zip(
                out, _comp_nat_vi_delta(ds, mesh, out))]
        ss = out
    elif st0.nat_hist is None:
        ss = [dataclasses.replace(
            st, error_scaling=sc, nat_mu=sigma_mod.apply_precision(
                d.mixture_prec, _diag_term(d, sc), sigma_mod.apply_sigma(
                    d.mixture_prec, _diag_term(d, st.error_scaling),
                    st.nat_mu)))
            for d, st, sc in zip(ds, ss, scalings)]
    else:
        n = st0.nat_hist_n
        change = _sync_float(torch.max(torch.abs(
            new_scaling / st0.error_scaling - 1.0)))
        if not (change > _EPOCH_SKIP_TOL and n < st0.nat_hist.shape[0]):
            return ss, 0.0, post_means
        out = []
        for st, sc in zip(ss, scalings):
            hist = st.nat_hist.clone()
            hist[n] = st.nat_mu
            scale = st.nat_hist_scale.clone()
            scale[n] = st.error_scaling
            coef = st.nat_hist_c.clone()
            coef[n] = 1.0
            out.append(dataclasses.replace(
                st, error_scaling=sc, nat_mu=torch.zeros_like(st.nat_mu),
                nat_hist=hist, nat_hist_scale=scale, nat_hist_c=coef,
                nat_hist_n=n + 1))
        ss = out
    obj, pm, _ = _evaluate(ds, ss, mesh, [_params(st) for st in ss],
                           [st.hyper_delta for st in ss])
    return ss, obj - orig_obj, pm


def outer_step(data, st, line_search_rate=2.0):
    """One full coordinate-ascent iteration
    (reference _optimize_step/_nat_grad_step,
    variational_inference.py:396-450). Returns (state, posterior mean in
    output scale); of a sharded fit (ShardedData, ShardedState), the
    ShardedState and one posterior mean per shard."""
    ds, ss, mesh = _unpack(data, st)
    ss, pms = _outer_step(ds, ss, mesh, line_search_rate)
    return (_repack(data, ss),
            tuple(pms) if mesh is not None else pms[0])


def _outer_step(ds, ss, mesh, line_search_rate):
    """`outer_step` on per-shard lists."""
    st0 = ss[0]
    if st0.nat_mu is not None:
        if ds[0].scale_se and st0.nat_hist is None \
                and st0.nat_mu.dim() != 3:
            raise ValueError('compact scale_se fits carry a per-component '
                             '[K, P, I] natural mean (the error-scaling EM '
                             'makes natural means K-dependent); got a '
                             'shared [P, I] state')
        # a compact state's derived fields would go stale the moment the
        # parameters move
        ss = _set(ss, vi_mu=None, vi_delta=None, sigma=None,
                  nat_grad_vi_delta=None)
    red = st0.running_elbo_delta
    conv_tol = math.inf if math.isnan(red) else 0.1 * red
    ss, delta_beta, obj, pm, lk = _beta_loop(ds, ss, mesh, conv_tol,
                                             line_search_rate)
    ss, delta_hyper, obj, pm, lk = _update_hyper_delta(ds, ss, mesh, obj)
    new_elbo_delta = delta_beta + delta_hyper
    if (ds[0].scale_se or ss[0].nat_hist is not None) \
            and new_elbo_delta < EM_TOL:
        ss, em_delta, pm = _error_scaling(ds, ss, mesh, obj, pm, lk)
        new_elbo_delta = new_elbo_delta + em_delta
    red = new_elbo_delta if math.isnan(red) else red
    red = red * ELBO_MOMENTUM + (1 - ELBO_MOMENTUM) * max(new_elbo_delta,
                                                          0.0)
    ss = _set(ss, elbo=ss[0].elbo + new_elbo_delta, running_elbo_delta=red)
    # pm belongs to the final parameters (the hyper-delta evaluation, or
    # the post-EM one)
    return ss, [p * d.scalings for p, d in zip(pm, ds)]


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


def _conv_stats(new_pms, old_pms, ckp_pms, st, mesh=None):
    """Per-iteration convergence/telemetry scalars, reduced on the device
    (over every shard: one posterior mean per shard in each list) and
    fetched in ONE synchronization: [num_err, elbo, running delta,
    allclose, max|pm|, max rel diff, max abs diff, checkpoint RMSE,
    error_scaling...]."""
    global host_syncs
    maxima, squares = [], []
    count = 0
    for j, (new_pm, old_pm, ckp_pm) in enumerate(zip(new_pms, old_pms,
                                                      ckp_pms)):
        eps = epsilon(new_pm.dtype)
        diff = torch.abs(new_pm - old_pm)
        # np.allclose(new, old, atol=ABS_TOL, rtol=REL_TOL) semantics
        apart = torch.any(~(diff <= ABS_TOL + REL_TOL * torch.abs(old_pm)))
        maxima.append(torch.stack([
            apart.to(new_pm.dtype),
            torch.max(torch.abs(new_pm)),
            torch.max(torch.abs(diff / (old_pm + eps))),
            torch.max(diff)]))
        # the comp shards of a column hold one posterior mean
        squares.append(_once(mesh, j, torch.sum(
            (new_pm - ckp_pm) ** 2).reshape(1)))
        count += new_pm.numel()
    top = maxima[0] if mesh is None else mesh.max(maxima)
    if mesh is not None:
        count = new_pms[0].numel() * mesh.n_snp
    dev = torch.cat([
        1 - top[:1], top[1:],
        torch.sqrt(_reduce(mesh, squares) / count),
        st.error_scaling.to(top.dtype)])
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
    sums, temps = _init_shards([data], None, [error_scaling], [fake_mu],
                               data.log_det.shape[0])
    hyper, temp_nat = _init_hyper(sums[0]), temps[0]
    if sigma is None:
        return hyper, temp_nat
    return (hyper, temp_nat) + _init_materialized(
        data, sigma, error_scaling, temp_nat, hyper)


def _init_hyper(sums):
    """hyper_delta from the annotation sums of the initial vi_delta over
    every SNP."""
    eps = epsilon(sums.dtype)
    hyper = sums + 1.
    hyper = hyper / torch.sum(hyper, dim=1, keepdim=True)
    return torch.clamp(hyper, min=eps)


def _init_materialized(data, sigma, error_scaling, temp_nat, hyper):
    """(vi_mu, vi_delta, nat_grad_vi_delta) of the materialized state at
    the initialization (one shard's)."""
    nat_vd = kernels.fast_vi_delta_grad(hyper, data.log_det,
                                        data.annotations)
    vi_mu = sigma_mod.apply_sigma(data.mixture_prec,
                                  _diag_term(data, error_scaling),
                                  _nat_k(data, temp_nat))
    vi_delta = nat_to_not_vi_delta(data, sigma, error_scaling, vi_mu,
                                   nat_vd)
    return vi_mu, vi_delta, nat_vd


def _init_shards(ds, mesh, scalings, fake_mus, K):
    """(per shard: the [A, K_slice] annotation sums of the initial
    vi_delta over its SNPs, its shared natural mean [P, I]). Every step is
    per SNP but the annotation sums and, under comp, the
    responsibilities' min and normalizer over K and the sigma-weighted
    sum, which reduce over the comp shards of a column. The [K, I]
    temporaries are formed in lockstep SNP chunks, each [K_slice, chunk]
    array within _INIT_CHUNK_BYTES at the largest slice, the same chunks
    on every shard."""
    mu0 = fake_mus[0]
    eps = epsilon(mu0.dtype)
    comp = _comp(mesh)
    top = -(-K // mesh.n_comp) if comp else K
    chunk_i = max(1, _INIT_CHUNK_BYTES // (top * mu0.element_size()))
    sums = [0.] * len(ds)
    nats = [[] for _ in ds]
    dterms = [_diag_term(d, sc) for d, sc in zip(ds, scalings)]
    for i0 in range(0, mu0.shape[1], chunk_i):
        cols = slice(i0, i0 + chunk_i)
        dts = [dt[:, cols] for dt in dterms]
        probs = []
        for d, dt, mu in zip(ds, dts, fake_mus):
            mu = mu[:, cols]
            matches = sigma_mod.make_summaries(d.mixture_prec, d.log_det,
                                               dt).matches
            pr = torch.einsum('pi,oi,kpo->ki', 1.6 * mu, 1.6 * mu,
                              d.mixture_prec)
            probs.append(pr + matches - d.log_det[:, None])
        lows = [-pr.amin(dim=0) for pr in probs]
        lows = mesh.comp_max(lows) if comp else lows
        probs = [torch.exp(-0.5 * (pr + low)) for pr, low in zip(probs,
                                                                 lows)]
        tots = [pr.sum(dim=0) for pr in probs]
        tots = mesh.comp_sum(tots) if comp else tots
        vds = [torch.clamp(pr / t, min=eps) for pr, t in zip(probs, tots)]
        avg = [sigma_mod.sigma_weighted_sum(d.mixture_prec, dt, vd)
               for d, dt, vd in zip(ds, dts, vds)]
        avg = mesh.comp_sum(avg) if comp else avg
        for j, (d, vd, mu, a) in enumerate(zip(ds, vds, fake_mus, avg)):
            sums[j] = sums[j] + kernels.sum_annotations(
                vd, d.annotations[cols], d.num_annotations)
            nats[j].append(torch.einsum('pi,iqp->qi', mu[:, cols],
                                        torch.linalg.inv(a)))
    return sums, [torch.cat(n, dim=1) for n in nats]


def _init_hyper_comp(mesh, sums):
    """`_init_hyper` of a comp-sharded fit: each row's sums over its snp
    shards, normalized by their [A] sums over comp; [A, K_slice] a
    shard."""
    eps = epsilon(sums[0].dtype)
    hyper = [h + 1. for h in mesh.snp_sum(sums)]
    tots = mesh.comp_sum([h.sum(dim=1, keepdim=True) for h in hyper])
    return [torch.clamp(h / t, min=eps) for h, t in zip(hyper, tots)]


# ---------------------------------------------------------------------------
# Model setup (reference VIScheme.__init__ precomputation,
# variational_inference.py:96-259)
# ---------------------------------------------------------------------------

def _precompute_sums(ld, ld_index, marginal_effects, std_errs,
                     real_mask):
    """The precompute's per-SNP part on one shard: (ld_diags, adj, the
    [2, P] sums over its SNPs of chi_stat's terms and of the prior's
    SE^-2). ld holds the shard's LD matrices."""
    P = marginal_effects.shape[0]
    lds = [ld[ld_index[p]] for p in range(P)]
    ld_diags = torch.stack([blocks_mod.diag(lds[p]).to(std_errs.dtype)
                            for p in range(P)])
    z_scores = marginal_effects / std_errs
    mle = torch.stack([blocks_mod.inverse_dot(lds[p], z_scores[p])
                       for p in range(P)])
    adj = torch.stack([blocks_mod.dot(lds[p], mle[p]) for p in range(P)])
    adj = adj / std_errs
    # layout-pad slots must not inflate the LDpred-style prior's SE^-2 sum
    sums = torch.stack([torch.einsum('pi,pi->p', z_scores, mle),
                        torch.sum(std_errs ** -2 * real_mask[None, :],
                                  dim=1)])
    return ld_diags, adj, sums


def _precompute_inverse_betas(ld, ld_index, adj, std_errs, gwas_N, init_hg,
                              se_sum):
    """The LDpred-inf initialization on one shard, given the prior's
    SE^-2 sum over every SNP."""
    P = adj.shape[0]
    lds = [ld[ld_index[p]] for p in range(P)]
    prior = (2 * gwas_N * init_hg) / se_sum
    inv_z = torch.stack([
        blocks_mod.ridge_inverse_dot(lds[p], adj[p] * std_errs[p],
                                     std_errs[p] ** 2 / prior[p])
        for p in range(P)])
    return inv_z * std_errs


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
                     dtype=torch.float64, device=None, mesh=None):
    """Assemble ModelData with the same validations as VIScheme.__init__;
    every tensor lives on `device` (the card by default, see
    `resolve_device`). With a mesh (parallel/mesh.py) the LD matrices are
    sharded PackedLDs of mesh.n_snp spans over the whole layout axis of
    the (host, every process alike) inputs, and a ShardedData comes back:
    each local shard builds its part on its own device, and the global
    sums are added across shards."""
    if mesh is None:
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
        if ld.shard_count != (1 if mesh is None else mesh.n_snp):
            raise ValueError(f'An LD matrix of {ld.shard_count} shards in '
                             f'a fit of {1 if mesh is None else mesh.n_snp}')
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
    ld_index = tuple(ld_index)
    num_annotations = annotations.shape[1]
    annot_idx = np.where(row_sums > 0, np.argmax(annotations, axis=1),
                         num_annotations).astype(np.int32)
    real = (row_sums > 0).astype(np.float64)

    K = mixture_prec.shape[0]
    if mesh is None:
        devices, spans, lds = [device], [slice(None)], [tuple(uniq)]
        k_spans = [slice(None)]
    else:
        rows = num_loci // mesh.n_snp
        devices = list(mesh.devices)
        spans = [slice(s * rows, (s + 1) * rows) for s in mesh.snp_shards]
        lds = [tuple(m.shards[j] for m in uniq)
               for j in range(len(devices))]
        k_spans = [mesh.k_slice(j, K) for j in range(len(devices))]

    # per shard: its span of the per-SNP inputs and the sums over it
    parts = []
    for dv, sl, ld in zip(devices, spans, lds):
        def dev(x, dt=dtype, dv=dv):
            return torch.as_tensor(np.asarray(x), device=dv).to(dt)
        marginal_t = dev(marginal[:, sl])
        std_errs_t = dev(use_std_errs[:, sl])
        ld_diags, adj, sums = _precompute_sums(ld, ld_index, marginal_t,
                                               std_errs_t, dev(real[sl]))
        # np.allclose(adj[isclose(ld_diags, 0)], 0) fails where this
        # count is positive (NaN included)
        bad = torch.sum((ld_diags.abs() <= 1e-8)
                        & ~(adj.abs() <= 1e-8)).to(dtype).reshape(1)
        parts.append(dict(dev=dev, sl=sl, ld=ld, marginal=marginal_t,
                          std_errs=std_errs_t, ld_diags=ld_diags, adj=adj,
                          sums=_once(mesh, len(parts),
                                     torch.cat([sums.reshape(-1), bad]))))
    sums = _reduce(mesh, [p['sums'] for p in parts])
    P = num_pops
    chi_stat, se_sum = sums[:P], sums[P:2 * P]
    if float(sums[2 * P]) > 0:
        raise ValueError('SNPs absent from the LD matrix have nonzero '
                         'adjusted marginal effects; they should have '
                         'been marked missing upstream.')

    shards = []
    for p, chi, se, ks in zip(parts, _replicas(mesh, chi_stat),
                              _replicas(mesh, se_sum), k_spans):
        dev, sl = p['dev'], p['sl']
        shards.append(ModelData(
            marginal_effects=p['marginal'],
            std_errs=p['std_errs'],
            scalings=dev(scalings[:, sl]),
            ld_diags=p['ld_diags'],
            scaled_ld_diags=p['std_errs'] ** -2 * p['ld_diags'],
            adj_marginal_effects=p['adj'],
            chi_stat=chi,
            ld_ranks=dev([ld.get_rank() for ld in ld_mats]),
            inverse_betas=_precompute_inverse_betas(
                p['ld'], ld_index, p['adj'], p['std_errs'], dev(gwas_N),
                dev(init_hg), se),
            annotations=dev(annot_idx[sl], torch.int32),
            annotation_counts=dev(annotations.sum(axis=0)),
            mixture_prec=dev(mixture_prec[ks]),
            log_det=dev(log_det[ks]),
            ld=p['ld'],
            num_annotations=int(num_annotations),
            scale_se=bool(scale_se),
            ld_index=ld_index,
        ))
    if mesh is None:
        return shards[0]
    return ShardedData(shards=tuple(shards), mesh=mesh)


# ---------------------------------------------------------------------------
# User-facing engine
# ---------------------------------------------------------------------------

# outputs whose derived [K, *, I] members exceed this stream to disk in
# chunks instead of materializing (MultiPopVI.dump_spec)
_STREAM_OUTPUT_BYTES = 1 << 28


def _np(x):
    return x.detach().cpu().numpy()


def write_npz_all_ranks(path, arrays, streams, rank=0):
    """Write an .npz whose streamed members are computed chunk by chunk.
    In a multi-process fit every process consumes the streams (each chunk
    gathers across processes) and process 0 alone writes the file (the
    JAX package's _write_npz_all_ranks)."""
    if rank == 0:
        from vilma_tpu_torch.utils.npz_stream import save_npz_stream
        save_npz_stream(path, arrays, streams)
        return
    for _, _, _, chunks in streams:
        for _ in chunks:
            pass


def _derived_cols(data, st, cols):
    """(vi_delta [K, c], post_mean [P, c], post_var [P, c]) of a compact
    state at SNP columns `cols` (a slice or an index tensor)."""
    natvd = kernels.fast_vi_delta_grad(st.hyper_delta, data.log_det,
                                       data.annotations[cols])
    if st.nat_hist is not None:
        ex = _epoch_exprs(data.mixture_prec, data.scaled_ld_diags,
                          st.error_scaling, st, cols)
    else:
        dt_c = data.scaled_ld_diags[:, cols] / st.error_scaling[:, None]
        ex = sigma_mod.compact_exprs(data.mixture_prec, dt_c,
                                     st.nat_mu[..., cols])
    addenda = ex.log_det_sigma + ex.quad
    li = 0.5 * (addenda[:-1] - addenda[-1:]) + natvd
    vi_delta = kernels.invert_nat_cat_2D(li)                     # [K, c]
    pm = torch.einsum('kpc,kc->pc', ex.mu, vi_delta)
    second = torch.einsum('kpc,kc->pc', ex.diag + ex.mu ** 2, vi_delta)
    return vi_delta, pm, second - pm ** 2


class MultiPopVI:
    """Equivalent of the reference MultiPopVI
    (variational_inference.py:567-889): same constructor surface plus
    `dtype` and `device` (the card unless device='cpu'), same optimize()
    and output arrays. Fits of P <= 3 cohorts carry a compact state,
    P >= 4 the materialized one (VIState).

    With `mesh` (parallel/mesh.py) the fit is sharded: the inputs come in
    the shard-local layout (parallel/alignment.py) with sharded LD
    matrices, `out_index` maps each original variant to its layout slot,
    and every output, checkpoint and resume is in the original variant
    order. In a multi-process fit every process runs the same calls
    (the outputs gather across processes) and process 0 writes the
    checkpoints."""

    def __init__(self, marginal_effects=None, std_errs=None, ld_mats=None,
                 annotations=None, mixture_covs=None, checkpoint=True,
                 checkpoint_freq=5, scaled=False, scale_se=False,
                 output='vilma_output', gwas_N=None, init_hg=None,
                 num_its=None, dtype=torch.float64, device=None, mesh=None,
                 out_index=None):
        for name, val in [('marginal_effects', marginal_effects),
                          ('std_errs', std_errs), ('ld_mats', ld_mats),
                          ('annotations', annotations),
                          ('mixture_covs', mixture_covs),
                          ('gwas_N', gwas_N), ('init_hg', init_hg),
                          ('num_its', num_its)]:
            if val is None:
                raise ValueError(f'{name} must be specified when calling '
                                 'MultiPopVI()')
        self.mesh = mesh
        self.data = build_model_data(
            marginal_effects, std_errs, ld_mats, annotations, mixture_covs,
            scaled, scale_se, gwas_N, init_hg, dtype=dtype, device=device,
            mesh=mesh)
        self._ds = (list(self.data.shards) if mesh is not None
                    else [self.data])
        self.rank = mesh.rank if mesh is not None else 0
        self.scaled = scaled
        self.scale_se = scale_se
        self.checkpoint = checkpoint
        self.checkpoint_freq = checkpoint_freq
        self.checkpoint_path = '%s-checkpoint' % output
        self.num_its = num_its
        d0 = self._ds[0]
        self.num_pops = d0.marginal_effects.shape[0]
        # layout slots, and the original variants they hold
        self._padded_loci = int(np.asarray(marginal_effects).shape[1])
        self._out_index = (None if out_index is None
                           else np.asarray(out_index, dtype=np.int64))
        self.num_loci = (self._padded_loci if out_index is None
                         else int(self._out_index.shape[0]))
        # a comp shard holds a slice of the components
        self.num_mix = int(np.asarray(mixture_covs).shape[0])
        self.num_annotations = d0.num_annotations
        # the compact states need the closed-form sigma algebra (P <= 3);
        # beyond it the fit carries the materialized state
        self._compact = self.num_pops <= 3
        # compact scale_se fits carry a per-component [K, P, I] natural
        # mean; when that state would be too large (the production mixture
        # grid at genome scale: 582 x 2 x 1M f32 is 4.66 GB) they switch
        # to the epoch-history representation, exact and bounded
        kdim_bytes = (self.num_mix * self.num_pops * self._padded_loci
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
        # outputs: one full-K ModelData per snp column this process holds
        # (the shards' own without comp), gathered through _omesh
        self._omesh = mesh.columns() if mesh is not None else None
        self._ods = self._ds
        self._col = list(range(len(self._ds)))
        if _comp(mesh):
            K = self.num_mix
            precs = mesh.comp_cat([d.mixture_prec for d in self._ds], 0, K)
            lds = mesh.comp_cat([d.log_det for d in self._ds], 0, K)
            self._ods = [dataclasses.replace(self._ds[js[0]],
                                             mixture_prec=precs[js[0]],
                                             log_det=lds[js[0]])
                         for js in self._omesh.lines]
            for ci, js in enumerate(self._omesh.lines):
                for j in js:
                    self._col[j] = ci

    @property
    def _dtype(self):
        return self._ds[0].marginal_effects.dtype

    @property
    def _np_dtype(self):
        return np.dtype(str(self._dtype).replace('torch.', ''))

    # -- the state of each shard, and arrays in the original order --------
    def _states(self, st):
        """The per-shard VIStates of a state of this fit."""
        return list(st.shards) if isinstance(st, ShardedState) else [st]

    def _state(self, ss):
        """Per-shard VIStates as a state of this fit."""
        return (ShardedState(tuple(ss), n_comp=self.mesh.n_comp)
                if self.mesh is not None else ss[0])

    def _out_states(self, st):
        """One VIState per snp column of `_ods`: the shards' own without
        comp; under comp each column's state gathered over its comp
        shards (the [K, ...] fields and hyper_delta's columns whole, the
        materialized state's nat_grad_vi_delta derived)."""
        ss = self._states(st)
        if not _comp(self.mesh):
            return ss
        K, mesh, s0 = self.num_mix, self.mesh, ss[0]

        def cat(get, dim=0):
            return mesh.comp_cat([get(s) for s in ss], dim, K)

        upd = {'hyper_delta': cat(lambda s: s.hyper_delta, 1)}
        if s0.nat_mu is not None and s0.nat_mu.dim() == 3:
            upd['nat_mu'] = cat(lambda s: s.nat_mu)
        sig = {}
        if s0.vi_mu is not None:
            upd['vi_mu'] = cat(lambda s: s.vi_mu)
            upd['vi_delta'] = cat(lambda s: s.vi_delta)
            sig = {f.name: cat(lambda s, n=f.name: getattr(s.sigma, n))
                   for f in dataclasses.fields(sigma_mod.SigmaSummaries)}
        out = []
        for od, js in zip(self._ods, self._omesh.lines):
            u = {k: v[js[0]] for k, v in upd.items()}
            if sig:
                u['sigma'] = sigma_mod.SigmaSummaries(
                    **{k: v[js[0]] for k, v in sig.items()})
                u['nat_grad_vi_delta'] = kernels.fast_vi_delta_grad(
                    u['hyper_delta'], od.log_det, od.annotations)
            out.append(dataclasses.replace(ss[js[0]], **u))
        return out

    def _full(self, parts):
        """One tensor per output column (`_ods`) as a host array over
        every variant, in the original order (the last axis gathered over
        the columns)."""
        x = _np(parts[0] if self.mesh is None
                else self._omesh.gather(parts))
        return x if self._out_index is None else x[..., self._out_index]

    def _place(self, x, fill=0.0):
        """A host array [..., n] in the original variant order as one
        tensor per shard in the fit's dtype (the layout's pad slots
        `fill`)."""
        x = np.array(x, dtype=self._np_dtype)
        if self._out_index is not None:
            full = np.full(x.shape[:-1] + (self._padded_loci,), fill,
                           dtype=x.dtype)
            full[..., self._out_index] = x
            x = full
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.mesh is None:
            return [t.to(self._ds[0].marginal_effects.device)]
        return list(self.mesh.split(t))

    def _shared(self, x):
        """A small host array (the same on every shard) as one tensor per
        shard in the fit's dtype."""
        t = torch.as_tensor(np.array(x, dtype=self._np_dtype))
        return [t.to(d.marginal_effects.device) for d in self._ds]

    @property
    def error_scaling(self):
        return _np(self._states(self.state)[0].error_scaling)

    @property
    def scalings(self):
        return self._full([d.scalings for d in self._ods])

    def vi_sigma_chunks(self, chunk_k=None):
        """Yield vi_sigma in [<=chunk_k, P, P, I] component chunks
        (~256 MB each by default), for utils/npz_stream."""
        K, P = self.num_mix, self.num_pops
        if chunk_k is None:
            per_k = max(self.num_loci * P * P * self._np_dtype.itemsize, 1)
            chunk_k = max(1, min(K, (256 << 20) // per_k))
        ss = self._out_states(self.state)
        for k0 in range(0, K, chunk_k):
            yield self._full([sigma_mod.materialize_sigma(
                d.mixture_prec[k0:k0 + chunk_k],
                _diag_term(d, st.error_scaling))
                for d, st in zip(self._ods, ss)])

    # -- genome-scale output streaming (see dump_spec) ---------------------
    def _stream_big(self):
        """Whether derived [K, *, I] outputs exceed the in-memory budget."""
        return (self.num_mix * self.num_pops * self._padded_loci
                * self._np_dtype.itemsize > _STREAM_OUTPUT_BYTES)

    def vi_mu_chunks(self, st=None, chunk_k=None):
        """Yield vi_mu in [<=chunk_k, P, I] component chunks derived from
        the state (vi_mu_k = sigma_k @ nat_k; epoch states sum their
        history, sigma.compact_exprs_epochs)."""
        ss = self._out_states(st or self.state)
        K, P = self.num_mix, self.num_pops
        if chunk_k is None:
            per_k = max(self._padded_loci * P * self._np_dtype.itemsize, 1)
            chunk_k = max(1, min(K, (256 << 20) // per_k))
        for k0 in range(0, K, chunk_k):
            parts = []
            for d, st in zip(self._ods, ss):
                prec = d.mixture_prec[k0:k0 + chunk_k]
                if st.nat_hist is not None:
                    parts.append(_epoch_exprs(prec, d.scaled_ld_diags,
                                              st.error_scaling, st).mu)
                    continue
                nat = (st.nat_mu[k0:k0 + chunk_k] if st.nat_mu.dim() == 3
                       else st.nat_mu[None].expand(
                           (prec.shape[0],) + tuple(st.nat_mu.shape)))
                parts.append(sigma_mod.apply_sigma(
                    prec, _diag_term(d, st.error_scaling), nat))
            yield self._full(parts)

    def _derived_col_chunks(self, st, chunk_i=None):
        """Yield (vi_delta [c, K], pm [P, c], pv [P, c]) over chunks of
        the original variant order (bounded device memory). Each shard
        derives the columns it holds; a sharded fit joins them on its
        first device and across processes."""
        ss = self._out_states(st or self.state)
        K, P, n = self.num_mix, self.num_pops, self.num_loci
        if chunk_i is None:
            chunk_i = max(1024, (64 << 20) // max(K * P * 4, 1))
        if self._out_index is None:
            d, st = self._ods[0], ss[0]
            for i0 in range(0, n, chunk_i):
                vd, pm, pv = _derived_cols(d, st, slice(i0, i0 + chunk_i))
                yield _np(vd.T), _np(pm), _np(pv)
            return
        om = self._omesh
        n_shards = om.n_snp if om is not None else 1
        first = om.first_shard if om is not None else 0
        rows = self._padded_loci // n_shards
        dev0 = self._ods[0].marginal_effects.device
        for i0 in range(0, n, chunk_i):
            idx = self._out_index[i0:i0 + chunk_i]
            out = torch.zeros((K + 2 * P, idx.shape[0]), dtype=self._dtype,
                              device=dev0)
            for j, (d, st) in enumerate(zip(self._ods, ss)):
                pos = np.flatnonzero(idx // rows == first + j)
                if pos.size == 0 or (om is not None and not om.writes(j)):
                    continue
                cols = torch.as_tensor(idx[pos] - (first + j) * rows,
                                       device=d.marginal_effects.device)
                out[:, torch.as_tensor(pos, device=dev0)] = torch.cat(
                    _derived_cols(d, st, cols)).to(dev0)
            if om is not None:
                out = om.join(out)
            out = _np(out)
            yield out[:K].T, out[K:K + P], out[K + P:]

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
        if self._states(st)[0].nat_mu is None or not self._stream_big():
            return self.create_dump_dict(st), []
        st0 = self._out_states(st)[0]
        arrays = {
            'hyper_delta': _np(st0.hyper_delta),
            'error_scaling': _np(st0.error_scaling),
            'scalings': self.scalings,
        }
        arrays.update(self._epoch_dump_arrays(st))
        K, P, n = self.num_mix, self.num_pops, self.num_loci
        dtype = self._np_dtype
        streams = [
            ('vi_mu', (K, P, n), dtype, self.vi_mu_chunks(st)),
            ('vi_delta', (n, K), dtype, self.vi_delta_chunks(st)),
        ]
        return arrays, streams

    def _materialized(self, st):
        """The states of the output columns with their derived fields."""
        ss = self._out_states(st)
        return [s if s.vi_mu is not None else materialize_state(d, s)
                for d, s in zip(self._ods, ss)]

    def create_dump_dict(self, st=None):
        st = st or self.state
        if self._states(st)[0].vi_mu is None and self._stream_big():
            raise MemoryError(
                'materializing the derived vi_mu/vi_delta of this '
                'problem needs tens of GB; use dump_spec() + '
                'utils/npz_stream.save_npz_stream (fit does this '
                'automatically)')
        mats = self._materialized(st)
        out = {
            'vi_mu': self._full([m.vi_mu for m in mats]),
            'vi_delta': self._full([m.vi_delta for m in mats]).T,
            'hyper_delta': _np(mats[0].hyper_delta),
            'error_scaling': _np(mats[0].error_scaling),
            'scalings': self.scalings,
        }
        out.update(self._epoch_dump_arrays(st))
        return out

    def _epoch_dump_arrays(self, st):
        """Extra checkpoint keys of an epoch-history state: the state
        itself, which a genome-scale resume restores directly."""
        ss = self._out_states(st)
        if ss[0].nat_hist is None:
            return {}
        return {
            'nat_u': self._full([s.nat_mu for s in ss]),
            'nat_hist': self._full([s.nat_hist for s in ss]),
            'nat_hist_scale': _np(ss[0].nat_hist_scale),
            'nat_hist_c': _np(ss[0].nat_hist_c),
            'nat_hist_n': np.asarray(ss[0].nat_hist_n, dtype=np.int32),
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
        if self._states(st)[0].vi_mu is None and self._stream_big():
            return self._streamed_moments(st)[0]
        return self._full([
            kernels.fast_posterior_mean(m.vi_mu, m.vi_delta) * d.scalings
            for d, m in zip(self._ods, self._materialized(st))])

    def real_posterior_variance(self, st=None):
        st = st or self.state
        if self._states(st)[0].vi_mu is None and self._stream_big():
            return self._streamed_moments(st)[1]
        parts = []
        for d, m in zip(self._ods, self._materialized(st)):
            mean = kernels.fast_posterior_mean(m.vi_mu, m.vi_delta)
            parts.append(kernels.fast_pmv(mean, m.vi_mu, m.vi_delta,
                                          m.sigma.diag)
                         * d.scalings ** 2)
        return self._full(parts)

    def elbo_value(self, st=None):
        """The ELBO of a state (the beta objective equals the ELBO in
        MultiPopVI: the annotation KL is 0)."""
        ss = self._states(st or self.state)
        return _evaluate(self._ds, ss, self.mesh, [_params(s) for s in ss],
                         [s.hyper_delta for s in ss])[0]

    def _fresh_state(self, error_scaling=None):
        """The state before initialization or resume. The materialized
        one holds its sigma summaries; its caller sets vi_mu, vi_delta
        and nat_grad_vi_delta."""
        P, K = self.num_pops, self.num_mix
        scalings = (self._shared(np.ones(P)) if error_scaling is None
                    else self._shared(error_scaling))
        ss = []
        for d, sc in zip(self._ds, scalings):
            zeros = dict(dtype=self._dtype, device=sc.device)
            I = d.marginal_effects.shape[1]
            st = VIState(
                nat_mu=torch.zeros(P, I, **zeros) if self._compact else None,
                hyper_delta=torch.zeros(self.num_annotations,
                                        d.log_det.shape[0], **zeros),
                error_scaling=sc, L=(1., 1., 1.), elbo=0.,
                running_elbo_delta=math.nan, num_err=0)
            if not self._compact:
                st = dataclasses.replace(st, sigma=sigma_mod.make_summaries(
                    d.mixture_prec, d.log_det, _diag_term(d, sc)))
            if self._epoch:
                B0 = _EPOCH_BUCKETS[0]
                st = dataclasses.replace(
                    st, nat_hist=torch.zeros(B0, P, I, **zeros),
                    nat_hist_scale=torch.ones(B0, P, **zeros),
                    nat_hist_c=torch.zeros(B0, **zeros), nat_hist_n=0)
            ss.append(st)
        return self._state(ss)

    def _initialize(self):
        ss = self._states(self._fresh_state())
        ds, ods = self._ds, self._ods
        inverse_betas = self._full([d.inverse_betas for d in ods])
        fake = make_fake_mu(inverse_betas,
                            self._full([d.std_errs for d in ods]),
                            self._full([d.ld_diags for d in ods]))
        fake_mu = self._place(fake)
        logging.info('Max |inverse_beta| at initialization: %f',
                     float(np.max(np.abs(inverse_betas))))
        comp = _comp(self.mesh)
        sums, temps = _init_shards(ds, self.mesh,
                                   [st.error_scaling for st in ss], fake_mu,
                                   self.num_mix)
        hypers = (_init_hyper_comp(self.mesh, sums) if comp else _replicas(
            self.mesh, _init_hyper(_reduce(self.mesh, sums))))
        if comp and not self._compact:
            ss = [dataclasses.replace(
                st, hyper_delta=h, vi_mu=sigma_mod.apply_sigma(
                    d.mixture_prec, _diag_term(d, st.error_scaling),
                    _nat_k(d, t)))
                for d, st, t, h in zip(ds, ss, temps, hypers)]
            return self._state([dataclasses.replace(st, vi_delta=vd)
                                for st, vd in zip(ss, _comp_nat_vi_delta(
                                    ds, self.mesh, ss))])
        out = []
        for d, st, temp_nat, hyper in zip(ds, ss, temps, hypers):
            if not self._compact:
                vi_mu, vi_delta, nat_vd = _init_materialized(
                    d, st.sigma, st.error_scaling, temp_nat, hyper)
                out.append(dataclasses.replace(
                    st, vi_mu=vi_mu, vi_delta=vi_delta, hyper_delta=hyper,
                    nat_grad_vi_delta=nat_vd))
                continue
            if self.scale_se and not self._epoch:
                # initialization is K-constant (error_scaling all ones):
                # the per-component state starts as a broadcast, copied so
                # that every component owns its row (the epoch state
                # instead starts with temp_nat as its accumulator and an
                # empty history)
                temp_nat = temp_nat[None].expand(
                    (d.log_det.shape[0],) + tuple(temp_nat.shape)
                ).contiguous()
            out.append(dataclasses.replace(st, nat_mu=temp_nat,
                                           hyper_delta=hyper))
        return self._state(out)

    def _state_from_checkpoint(self, loaded_checkpoint):
        """The state a checkpoint (np.load of a checkpoint or output .npz
        of either package, sharded or not, or a mapping of its arrays)
        resumes (reference MultiPopVI._state_from_checkpoint). Checkpoints
        are in the original variant order; a sharded fit places them in
        its layout. The shared and kdim natural means are recovered from
        vi_mu (exact given the checkpoint's error_scaling); the epoch
        state is restored from its own keys and the materialized one from
        vi_mu and vi_delta. A comp shard takes its slice of the [K, ...]
        arrays and of hyper_delta's columns."""
        files = getattr(loaded_checkpoint, 'files', loaded_checkpoint)
        error_scaling = None
        if 'error_scaling' in files:
            error_scaling = loaded_checkpoint['error_scaling']
        else:
            logging.warning('The checkpoint carries no "error_scaling" '
                            'entry; defaulting all error scalings to 1.')
        ss = self._states(self._fresh_state(error_scaling))
        kss = self._k_slices()
        hypers = [h[:, ks].contiguous() for h, ks in zip(
            self._shared(loaded_checkpoint['hyper_delta']), kss)]
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
            scales = self._shared(loaded_checkpoint['nat_hist_scale'])
            coefs = self._shared(loaded_checkpoint['nat_hist_c'])
            return self._state([dataclasses.replace(
                st, nat_mu=u, nat_hist=hist, nat_hist_scale=scale,
                nat_hist_c=coef,
                nat_hist_n=int(loaded_checkpoint['nat_hist_n']),
                hyper_delta=h)
                for st, u, hist, scale, coef, h in zip(
                    ss, self._place(loaded_checkpoint['nat_u']),
                    self._place(loaded_checkpoint['nat_hist']), scales,
                    coefs, hypers)])
        if not self._compact:
            # uniform pad columns keep log(vi_delta) finite; pads add
            # nothing to any sum and the first update rewrites them
            vi_delta = self._place(
                np.asarray(loaded_checkpoint['vi_delta']).T,
                fill=1.0 / self.num_mix)
            return self._state([dataclasses.replace(
                st, vi_mu=vm[ks].contiguous(), vi_delta=vd[ks].contiguous(),
                hyper_delta=h,
                nat_grad_vi_delta=None if _comp(self.mesh) else
                kernels.fast_vi_delta_grad(h, d.log_det, d.annotations))
                for d, st, vm, vd, h, ks in zip(
                    self._ds, ss, self._place(loaded_checkpoint['vi_mu']),
                    vi_delta, hypers, kss)])
        if self._stream_big():
            # genome-scale resume: the vi_mu member can be tens of GB;
            # recover the natural mean(s) in bounded chunks straight off
            # the uncompressed zip member
            nats = self._nat_from_checkpoint_streamed(loaded_checkpoint,
                                                      self._state(ss))
        elif self.scale_se:
            nats = [compact_nat_mu_k(d, st.error_scaling,
                                     vm[ks]).contiguous()
                    for d, st, vm, ks in zip(
                        self._ds, ss,
                        self._place(loaded_checkpoint['vi_mu']), kss)]
        else:
            nats = [compact_nat_mu(d, st.error_scaling, vm).contiguous()
                    for d, st, vm in zip(
                        self._full_k_data(), ss,
                        self._place(loaded_checkpoint['vi_mu']))]
        return self._state([dataclasses.replace(st, nat_mu=nat,
                                                hyper_delta=h)
                            for st, nat, h in zip(ss, nats, hypers)])

    def _nat_from_checkpoint_streamed(self, loaded_checkpoint, st):
        """Bounded-memory natural-mean recovery (see
        _state_from_checkpoint), one natural mean per shard: the shared
        state needs only vi_mu[0]; the kdim state is recovered in K-chunks
        of at most _RESUME_CHUNK_BYTES, each written straight into the
        [K, P, I] tensors on the devices, so the host holds one chunk at
        a time."""
        from vilma_tpu_torch.utils.npz_stream import npz_member_memmap
        ss = self._states(st)
        mm = npz_member_memmap(loaded_checkpoint, 'vi_mu')
        if mm is None:
            logging.warning('checkpoint vi_mu member is not mappable '
                            '(compressed?); falling back to a '
                            'materialized read')
            mm = loaded_checkpoint['vi_mu']
        if not self.scale_se:
            return [compact_nat_mu(d, s.error_scaling, v[None]).contiguous()
                    for d, s, v in zip(self._full_k_data(), ss,
                                       self._place(mm[0]))]
        K, P = self.num_mix, self.num_pops
        chunk = max(1, _RESUME_CHUNK_BYTES
                    // max(P * self._padded_loci
                           * self._np_dtype.itemsize, 1))
        kss = self._k_slices()
        nats = [torch.empty((d.log_det.shape[0], P,
                             d.marginal_effects.shape[1]),
                            dtype=self._dtype,
                            device=d.marginal_effects.device)
                for d in self._ds]
        for k0 in range(0, K, chunk):
            for d, s, nat, part, ks in zip(self._ds, ss, nats,
                                           self._place(mm[k0:k0 + chunk]),
                                           kss):
                # the chunk's components within this shard's slice
                a, b = ks.start or 0, K if ks.stop is None else ks.stop
                lo, hi = max(a, k0), min(b, k0 + part.shape[0])
                if lo < hi:
                    nat[lo - a:hi - a] = sigma_mod.apply_precision(
                        d.mixture_prec[lo - a:hi - a],
                        _diag_term(d, s.error_scaling),
                        part[lo - k0:hi - k0])
        return nats

    def _k_slices(self):
        """The slice of the K components each shard holds."""
        if not _comp(self.mesh):
            return [slice(None)] * len(self._ds)
        return [self.mesh.k_slice(j, self.num_mix)
                for j in range(len(self._ds))]

    def _full_k_data(self):
        """Each shard's ModelData with the whole K of its column's
        tables (the shared natural mean's recovery reads component 0)."""
        if not _comp(self.mesh):
            return self._ds
        return [dataclasses.replace(d, mixture_prec=self._ods[c].mixture_prec
                                    .to(d.mixture_prec.device))
                for d, c in zip(self._ds, self._col)]

    def _posterior_mean(self, st):
        """The posterior mean in output scale, one tensor per shard."""
        if _comp(self.mesh):
            # through _objective_terms, as the unsharded fit, so that its
            # evaluations and launches per shard are the same
            ss = self._states(st)
            params = [_params(s) for s in ss]
            hds = [s.hyper_delta for s in ss]
            return [_objective_terms(d, s, p, h, mo)[2] * d.scalings
                    for d, s, p, h, mo in zip(
                        self._ds, ss, params, hds,
                        _moments_all(self._ds, ss, self.mesh, params, hds))]
        out = []
        for d, s in zip(self._ds, self._states(st)):
            if s.nat_mu is None:
                pm = kernels.fast_posterior_mean(s.vi_mu, s.vi_delta)
            else:
                pm = _objective_terms(d, s, _params(s), s.hyper_delta)[2]
            out.append(pm * d.scalings)
        return out

    def optimize(self, loaded_checkpoint=None):
        """Coordinate ascent until convergence (reference optimize(),
        variational_inference.py:340-394), from the initialization or,
        given `loaded_checkpoint` (np.load of a checkpoint .npz), from
        the state it holds; a resumed fit may converge before step 10."""
        if loaded_checkpoint is None:
            st = self._initialize()
        else:
            st = self._state_from_checkpoint(loaded_checkpoint)
        st = self._state(_set(self._states(st), elbo=self.elbo_value(st)))
        converged = False
        num_its = 0
        post_mean = self._posterior_mean(st)
        ckp_post_mean = post_mean
        prev_err = 0
        while num_its < self.num_its and not converged:
            if num_its % self.checkpoint_freq == 0 and self.checkpoint:
                arrays, streams = self.dump_spec(st)
                write_npz_all_ranks('{}.{}'.format(self.checkpoint_path,
                                                   num_its),
                                    arrays, streams, self.rank)
                ckp_post_mean = self._posterior_mean(st)
            st, new_post_mean = outer_step(self.data, st,
                                           line_search_rate=2.0)
            if self._epoch:
                # keep a free epoch slot ahead of the next EM event, so
                # the append never freezes before the hard cap
                st = self._maybe_grow_hist(st)
            if self.mesh is None:
                new_post_mean = [new_post_mean]
            stats = _conv_stats(new_post_mean, post_mean, ckp_post_mean,
                                self._states(st)[0], self.mesh)
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
        # a comp-sharded fit keeps its sharded state and derives the
        # outputs from it per column (_out_states)
        self.state = (st if self._stream_big() or _comp(self.mesh)
                      else self._state(self._materialized(st)))
        return self.state

    def _maybe_grow_hist(self, st):
        """Grow the epoch buffer to the next bucket once nearly full; at
        the hard cap, warn once that further EM updates are frozen. The
        live count is a host value every shard shares, so all shards
        take the same decision."""
        ss = self._states(st)
        B = ss[0].nat_hist.shape[0]
        n = ss[0].nat_hist_n
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
        return self._state([dataclasses.replace(
            s,
            nat_hist=torch.cat([s.nat_hist, s.nat_hist.new_zeros(
                (pad,) + tuple(s.nat_hist.shape[1:]))]),
            nat_hist_scale=torch.cat([s.nat_hist_scale,
                                      s.nat_hist_scale.new_ones(
                                          (pad, self.num_pops))]),
            nat_hist_c=torch.cat([s.nat_hist_c,
                                  s.nat_hist_c.new_zeros(pad)]))
            for s in ss])

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
