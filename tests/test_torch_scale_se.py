"""The port's per-component [K, P, I] (kdim) state of --learn-scaling fits
against vilma_tpu at float64 on the CPU: the plain versions of the kdim
prologue and annotation sums against the JAX Pallas kernels in interpret
mode, the closed forms, 20 outer steps through real error-scaling EM
events, and MultiPopVI(scale_se=True), from the same numpy inputs."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vilma_tpu.inference import engine as jengine
from vilma_tpu.models import sigma as jsigma
from vilma_tpu.ops.pallas import compact_obj as jco
from vilma_tpu.utils import synthetic
from vilma_tpu_torch.convert import tensor_from_numpy
from vilma_tpu_torch.inference import engine as tengine
from vilma_tpu_torch.models import sigma as tsigma
from vilma_tpu_torch.ops.cuda import compact_obj as tco

from tests.torch_parity import data_to_torch, ld_to_torch, state_to_torch
from tests.torch_parity import t2n


def _kdim_point(num_pops, num_annotations, seed, num_loci=160):
    """A scale_se problem and a kdim state with a non-unit scaling."""
    data = synthetic.synthetic_problem(num_loci=num_loci, num_pops=num_pops,
                                       num_components=5, block_size=32,
                                       num_annotations=num_annotations,
                                       scale_se=True, seed=seed)
    st = synthetic.synthetic_state(data, seed=seed + 1, compact=True)
    assert st.nat_mu.ndim == 3
    rng = np.random.default_rng(seed)
    es = jnp.asarray(rng.uniform(0.8, 1.3, num_pops))
    return data, jengine.dataclasses.replace(st, error_scaling=es)


def _kdim_operands(num_pops, num_annotations, seed):
    """The fused kernels' operands of a kdim point (f64), with every 11th
    SNP turned into a pad slot (annotation id == A)."""
    data, st = _kdim_point(num_pops, num_annotations, seed)
    args, _ = jengine._fused_operands(data, st.error_scaling, st.nat_mu,
                                      st.hyper_delta)
    args = [np.asarray(a) for a in args]
    args[2] = args[2].copy()
    args[2][::11] = num_annotations
    return ([jnp.asarray(a) for a in args],
            [tensor_from_numpy(a) for a in args])


@pytest.mark.parametrize('num_pops', [1, 2, 3])
@pytest.mark.parametrize('num_annotations', [1, 3, 10])
def test_kdim_prologue_plain_matches_pallas(num_pops, num_annotations):
    """10 annotations take the Pallas kernel's one-hot branch, whose pad
    slots read zero scores: real SNPs are compared there (see
    test_torch_fused_kernels)."""
    j, t = _kdim_operands(num_pops, num_annotations,
                          seed=num_pops * 13 + num_annotations)
    assert t[4].dim() == 3
    jpm, jpv, jkl = jco.prologue(*j, num_annotations=num_annotations,
                                 interpret=True)
    tpm, tpv, tkl = tco.prologue(*t, num_annotations=num_annotations)
    real = np.asarray(j[2]) < num_annotations
    for got, want in ((tpm, jpm), (tpv, jpv)):
        cols = real if num_annotations > 8 else slice(None)
        want = np.asarray(want)[:, cols]
        np.testing.assert_allclose(t2n(got)[:, cols], want, rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max())
    assert np.isclose(float(tkl), float(jkl), rtol=1e-10)


@pytest.mark.parametrize('num_pops', [1, 2, 3])
@pytest.mark.parametrize('num_annotations', [1, 3, 10])
def test_kdim_delta_sums_plain_matches_pallas(num_pops, num_annotations):
    j, t = _kdim_operands(num_pops, num_annotations,
                          seed=num_pops * 17 + num_annotations)
    want = np.asarray(jco.delta_sums(*j, num_annotations=num_annotations,
                                     interpret=True))
    got = t2n(tco.delta_sums(*t, num_annotations=num_annotations))
    assert got.shape == want.shape == (num_annotations, 5)
    np.testing.assert_allclose(got, want, rtol=1e-9,
                               atol=1e-9 * want.max())


@pytest.mark.parametrize('num_pops', [1, 2, 3])
def test_compact_exprs_kdim_matches_jax(num_pops):
    data, st = _kdim_point(num_pops, 2, seed=num_pops)
    tdata, tst = data_to_torch(data), state_to_torch(st)
    want = jsigma.compact_exprs(data.mixture_prec,
                                jengine._diag_term(data, st.error_scaling),
                                st.nat_mu)
    got = tsigma.compact_exprs(tdata.mixture_prec,
                               tengine._diag_term(tdata, tst.error_scaling),
                               tst.nat_mu)
    for field in ('mu', 'diag', 'log_det_sigma', 'matches', 'quad',
                  'quadform'):
        w = np.asarray(getattr(want, field))
        np.testing.assert_allclose(t2n(getattr(got, field)), w, rtol=1e-9,
                                   atol=1e-12 * np.abs(w).max(),
                                   err_msg=field)


def test_kdim_objective_and_state_recovery_match_jax():
    """The kdim objective, the materialized state, and compact_nat_mu_k,
    which maps the materialized vi_mu back to the [K, P, I] state."""
    data, st = _kdim_point(2, 3, seed=5)
    tdata, tst = data_to_torch(data), state_to_torch(st)
    o1, pm1, _ = jengine._objective_compact(data, st, st.nat_mu,
                                            st.hyper_delta)
    o2, pm2, _ = tengine._objective_compact(tdata, tst, tst.nat_mu,
                                            tst.hyper_delta)
    assert np.isclose(float(o2), float(o1), rtol=1e-10)
    np.testing.assert_allclose(t2n(pm2), np.asarray(pm1), rtol=1e-9,
                               atol=1e-12)
    jm = jengine.materialize_state(data, st)
    tm = tengine.materialize_state(tdata, tst)
    for field in ('vi_mu', 'vi_delta', 'nat_grad_vi_delta'):
        w = np.asarray(getattr(jm, field))
        np.testing.assert_allclose(t2n(getattr(tm, field)), w, rtol=1e-9,
                                   atol=1e-12 * np.abs(w).max())
    nat = tengine.compact_nat_mu_k(tdata, tst.error_scaling, tm.vi_mu)
    want = np.asarray(jengine.compact_nat_mu_k(data, st.error_scaling,
                                               jm.vi_mu))
    np.testing.assert_allclose(t2n(nat), want, rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(t2n(nat), np.asarray(st.nat_mu), rtol=1e-8,
                               atol=1e-12)


@pytest.mark.parametrize('num_pops', [1, 2])
def test_kdim_trajectory_matches_jax(num_pops):
    """20 outer steps from the same kdim point, carried over by
    convert.py, through real error-scaling EM events: the ELBO within
    1e-9 relative, the posterior mean within rtol 1e-7 at every step."""
    data = synthetic.synthetic_problem(num_loci=128, num_pops=num_pops,
                                       num_components=4, block_size=32,
                                       num_annotations=2, scale_se=True)
    st = synthetic.synthetic_state(data, seed=11, compact=True)
    tdata, tst = data_to_torch(data), state_to_torch(st)
    assert tst.nat_mu.dim() == 3
    for it in range(20):
        st, pm_j = jengine.outer_step(data, st, line_search_rate=2.0)
        tst, pm_t = tengine.outer_step(tdata, tst)
        assert np.isclose(tst.elbo, float(st.elbo), rtol=1e-9), it
        np.testing.assert_allclose(t2n(pm_t), np.asarray(pm_j), rtol=1e-7,
                                   atol=1e-12, err_msg=str(it))
    es = t2n(tst.error_scaling)
    assert not np.allclose(es, 1.0)          # EM events happened
    np.testing.assert_allclose(es, np.asarray(st.error_scaling), rtol=1e-9)
    np.testing.assert_allclose(t2n(tst.hyper_delta),
                               np.asarray(st.hyper_delta), rtol=1e-8)
    assert tst.num_err == int(st.num_err) == 0


def _multipop_kw(data, num_its=25):
    covs = np.linalg.inv(np.asarray(data.mixture_prec))
    n = data.marginal_effects.shape[1]
    return dict(
        marginal_effects=np.asarray(data.marginal_effects),
        std_errs=np.asarray(data.std_errs),
        mixture_covs=covs, annotations=np.ones((n, 1)),
        checkpoint=False, checkpoint_freq=-1, scaled=False,
        scale_se=True, gwas_N=np.full(2, 1e5), init_hg=np.full(2, 0.3),
        num_its=num_its)


def test_multipopvi_kdim_matches_jax(tmp_path):
    """MultiPopVI(scale_se=True) below the epoch threshold: both packages
    keep the kdim state and fit to the same outputs."""
    data = synthetic.synthetic_problem(num_loci=128, num_pops=2,
                                       num_components=3, block_size=32,
                                       scale_se=True)
    kw = _multipop_kw(data)
    np.random.seed(17)
    jvi = jengine.MultiPopVI(ld_mats=[data.ld[0]] * 2,
                             output=str(tmp_path / 'j'), **kw)
    jst = jvi.optimize()
    tld = ld_to_torch(data.ld[0])
    np.random.seed(17)
    tvi = tengine.MultiPopVI(ld_mats=[tld, tld], output=str(tmp_path / 't'),
                             device='cpu', **kw)
    assert not tvi._epoch and not jvi._epoch
    tst = tvi.optimize()
    assert tst.nat_mu.shape == (3, 2, 128) and tst.nat_hist is None
    np.testing.assert_allclose(tvi.real_posterior_mean(tst),
                               np.asarray(jvi.real_posterior_mean(jst)),
                               rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(tvi.real_posterior_variance(tst),
                               np.asarray(jvi.real_posterior_variance(jst)),
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(tvi.error_scaling, np.asarray(jvi.error_scaling),
                               rtol=1e-8)
    assert not np.allclose(tvi.error_scaling, 1.0)
    assert np.isclose(tvi.elbo_value(tst), jvi.elbo_value(jst), rtol=1e-8)
    jd, td = jvi.create_dump_dict(jst), tvi.create_dump_dict(tst)
    assert sorted(td) == sorted(jd)
    for key in jd:
        np.testing.assert_allclose(td[key], np.asarray(jd[key]), rtol=1e-6,
                                   atol=1e-10 * np.abs(jd[key]).max(),
                                   err_msg=key)


@pytest.mark.parametrize('route', ['kdim', 'epoch'])
def test_initial_scale_se_states_meet_kernel_contract(route, monkeypatch):
    """At float32 the operands a freshly initialized --learn-scaling fit
    hands the CUDA wrappers (a [K, P, I] state copied out of a broadcast,
    or the epoch buffers) pass their dtype, shape and contiguity checks."""
    if route == 'epoch':
        monkeypatch.setattr(tengine, '_EPOCH_STATE_BYTES', 0)
    data = synthetic.synthetic_problem(num_loci=96, num_pops=2,
                                       num_components=4, block_size=32,
                                       num_annotations=2, scale_se=True,
                                       dtype=np.float32)
    tld = ld_to_torch(data.ld[0])
    np.random.seed(0)
    vi = tengine.MultiPopVI(
        marginal_effects=np.asarray(data.marginal_effects),
        std_errs=np.asarray(data.std_errs), ld_mats=[tld, tld],
        mixture_covs=np.linalg.inv(np.asarray(data.mixture_prec,
                                              dtype=np.float64)),
        annotations=np.eye(2)[np.arange(96) % 2], scale_se=True,
        gwas_N=np.full(2, 1e5), init_hg=np.full(2, 0.3), num_its=1,
        dtype=torch.float32, device='cpu')
    st = vi._initialize()
    A = vi.data.num_annotations
    if route == 'kdim':
        assert st.nat_mu.shape == (4, 2, 96) and st.nat_mu.is_contiguous()
        tco._check_operands('prologue', *tengine._fused_operands(
            vi.data, st.error_scaling, st.nat_mu, st.hyper_delta), A)
    else:
        assert st.nat_hist.shape == (4, 2, 96) and st.nat_hist_n == 0
        tco._check_epoch_operands(
            'prologue_epochs', *tengine._epoch_operands(
                vi.data, st, st.nat_mu, st.nat_hist_c, st.hyper_delta),
            A, st.nat_hist_n)
