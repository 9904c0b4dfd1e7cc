"""vilma_tpu_torch.ops.kernels and .models.sigma against the JAX package,
at float64 on the CPU (rtol 1e-12: the same expressions, reassociated at
most by the backends' reductions)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vilma_tpu.models import sigma as jsigma
from vilma_tpu.ops import kernels as jk
from vilma_tpu_torch.models import sigma as tsigma
from vilma_tpu_torch.ops import kernels as tk

from tests.torch_parity import t2n

RTOL = 1e-12
K, P, I, A = 5, 2, 40, 3


def _inputs(seed=0, P=P):
    rng = np.random.default_rng(seed)
    delta = rng.uniform(0.1, 1.0, (K, I))
    delta /= delta.sum(axis=0, keepdims=True)
    hyper = rng.uniform(0.1, 1.0, (A, K))
    hyper /= hyper.sum(axis=1, keepdims=True)
    ann = rng.integers(0, A, I)
    ann[::7] = A                                  # pad slots
    a = rng.standard_normal((K, P, P))
    prec = a @ np.swapaxes(a, 1, 2) + P * np.eye(P)
    return dict(
        vi_mu=rng.standard_normal((K, P, I)) * 1e-2,
        nat_mu=rng.standard_normal((K, P, I)),
        delta=delta, hyper=hyper, ann=ann.astype(np.int32),
        prec=prec, log_det=rng.standard_normal(K),
        sigma_diag=rng.uniform(0.1, 1.0, (K, P, I)),
        pi=[rng.standard_normal((P, I)) for _ in range(8)],
        p=[rng.uniform(0.5, 2.0, P) for _ in range(3)],
        ki=rng.standard_normal((K, I)),
        nat_k1=rng.standard_normal((K - 1, I)) * 3,
    )


def _cases():
    """(name, fn(module, to_array, inputs) -> result)."""
    return [
        ('sum_betas', lambda m, a, x: m.sum_betas(a(x['pi'][0]),
                                                  a(x['pi'][1]), 0.3)),
        ('fast_divide', lambda m, a, x: m.fast_divide(
            a(x['pi'][0]), a(x['pi'][1]))),
        ('fast_linked_ests', lambda m, a, x: m.fast_linked_ests(
            a(x['pi'][0]), a(x['pi'][1]), a(x['pi'][2]), a(x['pi'][3]))),
        ('fast_likelihood', lambda m, a, x: m.fast_likelihood(
            *[a(v) for v in x['pi'][:6]], a(x['p'][0]), a(x['p'][1]),
            a(x['p'][2]))),
        ('fast_posterior_mean', lambda m, a, x: m.fast_posterior_mean(
            a(x['vi_mu']), a(x['delta']))),
        ('fast_pmv', lambda m, a, x: m.fast_pmv(
            a(x['pi'][0]), a(x['vi_mu']), a(x['delta']),
            a(x['sigma_diag']))),
        ('fast_inner_product_comp', lambda m, a, x:
            m.fast_inner_product_comp(a(x['vi_mu']), a(x['prec']),
                                      a(x['delta']))),
        ('sum_annotations', lambda m, a, x: m.sum_annotations(
            a(x['delta']), a(x['ann']), A)),
        ('fast_delta_kl', lambda m, a, x: m.fast_delta_kl(
            a(x['delta']), a(x['hyper']), a(x['ann']))),
        ('fast_beta_kl', lambda m, a, x: m.fast_beta_kl(
            a(x['ki']), a(x['delta']))),
        ('fast_vi_delta_grad', lambda m, a, x: m.fast_vi_delta_grad(
            a(x['hyper']), a(x['log_det']), a(x['ann']))),
        ('map_to_nat_cat_2D', lambda m, a, x: m.map_to_nat_cat_2D(
            a(x['delta']))),
        ('invert_nat_cat_2D', lambda m, a, x: m.invert_nat_cat_2D(
            a(x['nat_k1']))),
        ('fast_invert_nat_vi_delta', lambda m, a, x:
            m.fast_invert_nat_vi_delta(a(x['vi_mu']), a(x['nat_mu']),
                                       a(x['ki']), a(x['nat_k1']))),
    ]


def _jax_array(v):
    return jnp.asarray(v)


def _torch_tensor(v):
    return torch.as_tensor(np.asarray(v))


@pytest.mark.parametrize('name,fn', _cases(), ids=[c[0] for c in _cases()])
def test_kernels_match_jax(name, fn):
    x = _inputs()
    want = np.asarray(fn(jk, _jax_array, x))
    got = t2n(fn(tk, _torch_tensor, x))
    assert got.shape == want.shape
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def test_all_fourteen_kernels_covered():
    names = {c[0] for c in _cases()}
    public = {n for n in dir(jk) if not n.startswith('_')
              and callable(getattr(jk, n)) and n not in ('epsilon',)
              and getattr(jk, n).__module__ == jk.__name__}
    assert names == public and len(names) == 14


def test_invert_nat_cat_single_component():
    """K = 1: no natural parameters, every weight is 1."""
    got = t2n(tk.invert_nat_cat_2D(torch.zeros(0, 6, dtype=torch.float64)))
    want = np.asarray(jk.invert_nat_cat_2D(jnp.zeros((0, 6))))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# models/sigma: the closed forms for P = 1, 2, 3
# ---------------------------------------------------------------------------

def _sigma_inputs(P, seed=3):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((K, P, P))
    prec = a @ np.swapaxes(a, 1, 2) + P * np.eye(P)
    return dict(prec=prec, log_det=-np.linalg.slogdet(prec)[1],
                dterm=rng.uniform(100.0, 3000.0, (P, I)),
                nat=rng.standard_normal((P, I)),
                x=rng.standard_normal((K, P, I)),
                delta=rng.dirichlet(np.ones(K), I).T)


def _close(got, want):
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=RTOL,
                               atol=0)


@pytest.mark.parametrize('P', [1, 2, 3])
def test_sigma_closed_forms_match_jax(P):
    x = _sigma_inputs(P)
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    tx = {k: torch.as_tensor(v) for k, v in x.items()}
    for jp, tp in zip(jsigma._precision_parts(jx['prec'], jx['dterm']),
                      tsigma._precision_parts(tx['prec'], tx['dterm'])):
        _close(torch.broadcast_to(tp, (K, I)), jnp.broadcast_to(jp, (K, I)))
    _close(tsigma.apply_precision(tx['prec'], tx['dterm'], tx['x']),
           jsigma.apply_precision(jx['prec'], jx['dterm'], jx['x']))
    _close(tsigma.apply_sigma(tx['prec'], tx['dterm'], tx['x']),
           jsigma.apply_sigma(jx['prec'], jx['dterm'], jx['x']))
    ts = tsigma.make_summaries(tx['prec'], tx['log_det'], tx['dterm'])
    js = jsigma.make_summaries(jx['prec'], jx['log_det'], jx['dterm'])
    for field in ('log_det_sigma', 'sigma_summary', 'diag', 'matches'):
        _close(getattr(ts, field), getattr(js, field))
    te = tsigma.compact_exprs(tx['prec'], tx['dterm'], tx['nat'])
    je = jsigma.compact_exprs(jx['prec'], jx['dterm'], jx['nat'])
    for field in ('mu', 'diag', 'log_det_sigma', 'matches', 'quad',
                  'quadform'):
        _close(getattr(te, field), getattr(je, field))
    _close(tsigma.sigma_weighted_sum(tx['prec'], tx['dterm'], tx['delta']),
           jsigma.sigma_weighted_sum(jx['prec'], jx['dterm'], jx['delta']))
    np.testing.assert_allclose(
        t2n(tsigma.materialize_sigma(tx['prec'], tx['dterm'])),
        np.asarray(jsigma.materialize_sigma(jx['prec'], jx['dterm'])),
        rtol=1e-10, atol=0)


def test_sigma_p4_raises():
    """At P = 4 the compact expressions raise, as the JAX package's do
    (the compact states need the closed forms); apply_sigma and
    materialize_sigma, which raised before the materialized path was
    ported, take the generic Cholesky route and equal the JAX
    package's."""
    x = _sigma_inputs(4)
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    tx = {k: torch.as_tensor(v) for k, v in x.items()}
    with pytest.raises(NotImplementedError, match='P <= 3'):
        tsigma.compact_exprs(tx['prec'], tx['dterm'], tx['nat'])
    with pytest.raises(NotImplementedError):
        jsigma.compact_exprs(jx['prec'], jx['dterm'], jx['nat'])
    _close(tsigma.apply_sigma(tx['prec'], tx['dterm'], tx['x']),
           jsigma.apply_sigma(jx['prec'], jx['dterm'], jx['x']))
    _close(tsigma.materialize_sigma(tx['prec'], tx['dterm']),
           jsigma.materialize_sigma(jx['prec'], jx['dterm']))
