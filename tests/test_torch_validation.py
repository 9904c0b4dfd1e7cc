"""The validation tools of vilma_tpu_torch against vilma_tpu, on the CPU
at float64: the gradient-based ELBO fit (inference/gradient.py) and the
NUTS/SMC samplers (inference/mcmc.py), with the autograd path through
the block matvec they rest on.

Tolerances: products and their gradients to 1e-12 of their scale; the
ELBO to 1e-12 relative; the first 20 values of the Adam trace to 1e-9
relative (torch.optim.Adam and optax.adam round the same update
differently); the log posterior and its gradient to 1e-12; NUTS draws
to 1e-8 (the same numpy generator drives both chains); SMC means within
the JAX package's own band against the VI answer (tests/test_validation
.py: 0.1 of the largest |beta_hat|), since its accept decisions may
round apart.
"""
import jax
import numpy as np
import pytest
import torch

from vilma_tpu.inference import engine as jengine
from vilma_tpu.inference import gradient as jgradient
from vilma_tpu.inference import mcmc as jmcmc
from vilma_tpu.ops import blocks as jblocks
from vilma_tpu_torch.inference import engine as tengine
from vilma_tpu_torch.inference import gradient as tgradient
from vilma_tpu_torch.inference import mcmc as tmcmc
from vilma_tpu_torch.ops import blocks as tblocks

from tests.torch_parity import data_to_torch, state_to_torch, t2n


def _ar1(n, rho):
    return rho ** np.abs(np.subtract.outer(np.arange(n), np.arange(n)))


def _problem(P=1, n=16, seed=0):
    """The small problem of tests/test_validation.py (P = 1), or two
    cohorts on one panel, as a JAX MultiPopVI and its initialized state."""
    rng = np.random.default_rng(seed)
    ld = _ar1(n, 0.4)
    packed = jblocks.from_dense_blocks([ld], [np.arange(n)], n)
    se = np.full((P, n), 0.05)
    true_beta = np.where(rng.random(n) < 0.3,
                         rng.standard_normal(n) * 0.1, 0.0)
    betas = np.stack([ld @ true_beta + rng.standard_normal(n) * 0.05
                      for _ in range(P)])
    if P == 1:
        covs = [np.eye(1) * 1e-6, np.eye(1) * 0.01, np.eye(1) * 0.05]
    else:
        covs = [np.eye(2) * 1e-6, np.array([[0.01, 0.008], [0.008, 0.01]]),
                np.eye(2) * 0.05]
    scheme = jengine.MultiPopVI(
        marginal_effects=betas, std_errs=se, ld_mats=[packed] * P,
        mixture_covs=covs, annotations=np.ones((n, 1)), checkpoint=False,
        checkpoint_freq=-1, output='unused', scaled=False, scale_se=False,
        gwas_N=np.full(P, 1e4), init_hg=np.full(P, 0.3), num_its=60)
    np.random.seed(0)
    return scheme, scheme._initialize(), ld, betas, se, np.asarray(covs)


def _blocks_with_gaps():
    """Two AR(1) blocks over 30 of 34 genome slots, rows shuffled."""
    rng = np.random.default_rng(5)
    slots = rng.permutation(34)
    dense = [_ar1(18, 0.6), _ar1(12, 0.3)]
    return tblocks.from_dense_blocks(dense, [slots[:18], slots[18:30]], 34)


@pytest.mark.parametrize('C', [1, 3, 9])
def test_matvec_gradient_is_the_matrix_on_the_gradient(C):
    """The autograd gradient of dot / dot_multi with respect to the
    vectors is A g (A symmetric), for 1, 3 and 9 cohorts (9 runs as
    groups of 8 and 1)."""
    ld = _blocks_with_gaps()
    dense = tblocks.to_dense(ld)
    rng = np.random.default_rng(C)
    x = torch.tensor(rng.standard_normal((C, ld.n)), requires_grad=True)
    g = rng.standard_normal((C, ld.n))
    y = (tblocks.dot(ld, x[0])[None] if C == 1
         else tblocks.dot_multi(ld, x))
    grad, = torch.autograd.grad(y, x, torch.as_tensor(g))
    want = g @ dense.T
    np.testing.assert_allclose(t2n(grad), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize('P', [1, 2])
def test_elbo_matches_jax(P):
    scheme, st0, *_ = _problem(P)
    jst = jengine.materialize_state(scheme.data, st0)
    want = float(jengine.elbo(scheme.data, jst.sigma, jst.error_scaling,
                              jst.vi_mu, jst.vi_delta, jst.hyper_delta))
    data = data_to_torch(scheme.data)
    tst = tengine.materialize_state(data, state_to_torch(st0))
    got = float(tengine.elbo(data, tst.sigma, tst.error_scaling, tst.vi_mu,
                             tst.vi_delta, tst.hyper_delta))
    assert got == pytest.approx(want, rel=1e-12)
    ll = float(tengine.log_likelihood(data, tst.sigma, tst.error_scaling,
                                      tst.vi_mu, tst.vi_delta))
    jll = float(jengine.log_likelihood(scheme.data, jst.sigma,
                                       jst.error_scaling, jst.vi_mu,
                                       jst.vi_delta))
    assert ll == pytest.approx(jll, rel=1e-12)
    pm = tengine.posterior_mean(tst.vi_mu, tst.vi_delta)
    np.testing.assert_allclose(
        t2n(tengine.posterior_marginal_variance(pm, tst.vi_mu, tst.vi_delta,
                                                tst.sigma)),
        np.asarray(jengine.posterior_marginal_variance(
            jengine.posterior_mean(jst.vi_mu, jst.vi_delta), jst.vi_mu,
            jst.vi_delta, jst.sigma)), rtol=1e-12)


@pytest.mark.parametrize('P', [1, 2])
def test_gradient_trace_matches_optax(P):
    """The first 20 ELBO values of the Adam fit equal the JAX package's
    optax trace from the same state, and so do the parameters after."""
    scheme, st0, *_ = _problem(P)
    (jmu, jdelta, jhyper), jtrace = jgradient.fit_elbo_gradient(
        scheme.data, st0, num_steps=20, learning_rate=5e-2)
    (tmu, tdelta, thyper), ttrace = tgradient.fit_elbo_gradient(
        data_to_torch(scheme.data), state_to_torch(st0), num_steps=20,
        learning_rate=5e-2)
    assert len(ttrace) == 20 and all(isinstance(v, float) for v in ttrace)
    np.testing.assert_allclose(ttrace, jtrace, rtol=1e-9)
    for got, want in ((tmu, jmu), (tdelta, jdelta), (thyper, jhyper)):
        want = np.asarray(want)
        np.testing.assert_allclose(t2n(got), want, rtol=0,
                                   atol=1e-9 * np.abs(want).max())


def test_gradient_mode_matches_coordinate_ascent():
    """As tests/test_validation.py: Adam from the initialization lands
    near the coordinate-ascent optimum of the port's own fit."""
    scheme, _, ld, betas, se, covs = _problem()
    n = betas.shape[1]
    packed = tblocks.from_dense_blocks([ld], [np.arange(n)], n)
    vi = tengine.MultiPopVI(
        marginal_effects=betas, std_errs=se, ld_mats=[packed],
        mixture_covs=list(covs), annotations=np.ones((n, 1)),
        checkpoint=False, checkpoint_freq=-1, output='unused',
        scaled=False, scale_se=False, gwas_N=np.array([1e4]),
        init_hg=np.array([0.3]), num_its=60, device='cpu')
    np.random.seed(0)
    ca_elbo = vi.elbo_value(vi.optimize())
    np.random.seed(0)
    _, trace = tgradient.fit_elbo_gradient(vi.data, vi._initialize(),
                                           num_steps=800,
                                           learning_rate=5e-2)
    assert trace[-1] > trace[0]
    assert trace[-1] > ca_elbo - 0.05 * abs(ca_elbo) - 5.0


def _unimodal_block(n=8):
    """tests/test_validation.py's spike-free NUTS problem."""
    rng = np.random.default_rng(3)
    ld = _ar1(n, 0.4)
    se = np.full((1, n), 0.05)
    true_beta = rng.standard_normal(n) * 0.1
    betas = (ld @ true_beta + rng.standard_normal(n) * 0.05)[None]
    covs = np.array([np.eye(1) * 0.01, np.eye(1) * 0.05])
    return ld, betas, se, covs, np.array([[0.35, 0.65]])


@pytest.mark.parametrize('P', [1, 2])
def test_log_posterior_matches_jax(P):
    """make_block_log_posterior and its gradient equal the JAX package's
    (a rank-deficient block, several annotations, a learned scaling), and
    a batch of points equals the points one by one."""
    rng = np.random.default_rng(11 + P)
    n, K, A = 10, 3, 2
    x = rng.standard_normal((n, 6))
    ld = np.corrcoef(x)                       # rank 6 of 10
    betas = rng.standard_normal((P, n)) * 0.1
    se = rng.uniform(0.03, 0.08, (P, n))
    a = rng.standard_normal((K, P, P)) * 0.1
    covs = a @ np.swapaxes(a, 1, 2) + 0.01 * np.eye(P)
    weights = rng.dirichlet(np.ones(K), A)
    ann = rng.integers(0, A, n)
    scaling = rng.uniform(0.8, 1.2, P)
    jlp = jmcmc.make_block_log_posterior(ld, betas, se, covs, weights, ann,
                                         scaling)
    tlp = tmcmc.make_block_log_posterior(ld, betas, se, covs, weights, ann,
                                         scaling, device='cpu')
    points = rng.standard_normal((4, P, n)) * 0.1
    batch = t2n(tlp(torch.as_tensor(points)))
    for j, beta in enumerate(points):
        want = float(jlp(beta))
        q = torch.tensor(beta, requires_grad=True)
        value = tlp(q)
        grad, = torch.autograd.grad(value, q)
        assert float(value.detach()) == pytest.approx(want, rel=1e-12)
        assert batch[j] == pytest.approx(want, rel=1e-12)
        jgrad = np.asarray(jax.grad(jlp)(beta))
        np.testing.assert_allclose(t2n(grad), jgrad, rtol=0,
                                   atol=1e-12 * np.abs(jgrad).max())


def test_nuts_draws_match_jax():
    """The same seed gives the JAX package's chain: warm-up, step-size
    adaptation and the first draws."""
    ld, betas, se, covs, weights = _unimodal_block()
    ann = np.zeros(8, dtype=int)
    jlp = jmcmc.make_block_log_posterior(ld, betas, se, covs, weights, ann)
    tlp = tmcmc.make_block_log_posterior(ld, betas, se, covs, weights, ann,
                                         device='cpu')
    kw = dict(num_samples=20, num_warmup=15, seed=1)
    want = jmcmc.nuts_sample(jlp, np.zeros((1, 8)), **kw)
    got = tmcmc.nuts_sample(tlp, np.zeros((1, 8)), device='cpu', **kw)
    assert got.shape == (20, 1, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)


def test_smc_agrees_with_jax_and_vi():
    """tests/test_validation.py's SMC check, run by both packages from
    the same VI fit: the means of the two particle sets agree, and the
    port's with the VI posterior means, within that test's band."""
    scheme, _, ld, betas, se, covs = _problem(n=8)
    np.random.seed(0)
    st = scheme.optimize()
    vi_mean = np.asarray(scheme.real_posterior_mean(st))
    weights = np.asarray(st.hyper_delta)
    ann = np.zeros(8, dtype=int)
    kw = dict(num_particles=1500, num_steps=25, num_mcmc=5, seed=2)
    jmean = jmcmc.smc_sample(
        jmcmc.make_block_log_posterior(ld, betas, se, covs, weights, ann),
        jmcmc.mixture_prior_sampler(covs, weights, ann, 1), **kw).mean(0)
    tsamples = tmcmc.smc_sample(
        tmcmc.make_block_log_posterior(ld, betas, se, covs, weights, ann,
                                       device='cpu'),
        tmcmc.mixture_prior_sampler(covs, weights, ann, 1, device='cpu'),
        device='cpu', **kw)
    assert tsamples.shape == (1500, 1, 8)
    band = 0.1 * np.abs(betas).max()
    np.testing.assert_allclose(tsamples.mean(0), jmean, rtol=0, atol=band)
    np.testing.assert_allclose(tsamples.mean(0), vi_mean, rtol=0, atol=band)
