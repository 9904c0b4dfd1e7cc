"""The port's epoch-history state of --learn-scaling fits against
vilma_tpu at float64 on the CPU: the plain versions of the epoch
prologue and annotation sums against the JAX Pallas kernels in interpret
mode, compact_exprs_epochs, 20 outer steps through real EM appends (also
against the port's own kdim trajectory), MultiPopVI's epoch route, and
the history's bucketed growth up to its cap."""
import dataclasses
import logging

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


def _epoch_state(data, u, hyper, B=4, live=0, seed=0):
    """A JAX epoch-history state with accumulator `u`, `live` filled
    history slots of B (the rest inert) and a non-unit scaling."""
    P, I = u.shape
    rng = np.random.default_rng(seed)
    hist = np.zeros((B, P, I))
    scale = np.ones((B, P))
    c = np.zeros(B)
    hist[:live] = rng.standard_normal((live, P, I)) * 1e-2
    scale[:live] = rng.uniform(0.7, 1.4, (live, P))
    c[:live] = rng.uniform(0.1, 1.0, live)
    return jengine.VIState(
        vi_mu=None, vi_delta=None, nat_grad_vi_delta=None, sigma=None,
        nat_mu=jnp.asarray(u), nat_hist=jnp.asarray(hist),
        nat_hist_scale=jnp.asarray(scale), nat_hist_c=jnp.asarray(c),
        nat_hist_n=jnp.asarray(live, dtype=jnp.int32),
        hyper_delta=jnp.asarray(hyper),
        error_scaling=jnp.asarray(rng.uniform(0.8, 1.2, P)),
        L=jnp.ones(3), elbo=jnp.asarray(0.),
        running_elbo_delta=jnp.asarray(np.nan),
        num_err=jnp.asarray(0, dtype=jnp.int32))


def _epoch_point(num_pops, num_annotations, seed, num_loci=300, live=3,
                 B=4, K=5):
    data = synthetic.synthetic_problem(num_loci=num_loci, num_pops=num_pops,
                                       num_components=K, block_size=32,
                                       num_annotations=num_annotations,
                                       scale_se=True, seed=seed)
    rng = np.random.default_rng(seed + 23)
    hyper = rng.uniform(0.1, 1.0, (num_annotations, K))
    hyper /= hyper.sum(axis=1, keepdims=True)
    u = rng.standard_normal((num_pops, num_loci)) * 1e-2
    return data, _epoch_state(data, u, hyper, B=B, live=live, seed=seed)


def _epoch_operands(num_pops, num_annotations, seed):
    """The epoch kernels' operands (f64) of a point with 3 live epochs
    and one inert slot, every 11th SNP a pad slot."""
    data, st = _epoch_point(num_pops, num_annotations, seed)
    args, _ = jengine._epoch_fused_operands(data, st, st.nat_mu,
                                            st.nat_hist_c, st.hyper_delta)
    args = [np.asarray(a) for a in args]
    args[2] = args[2].copy()
    args[2][::11] = num_annotations
    return ([jnp.asarray(a) for a in args],
            [tensor_from_numpy(a) for a in args])


@pytest.mark.parametrize('num_pops', [1, 2, 3])
@pytest.mark.parametrize('num_annotations', [1, 12])
def test_epoch_prologue_plain_matches_pallas(num_pops, num_annotations):
    j, t = _epoch_operands(num_pops, num_annotations,
                           seed=num_pops * 7 + num_annotations)
    jpm, jpv, jkl = jco.prologue_epochs(
        *j, num_annotations=num_annotations, interpret=True)
    tpm, tpv, tkl = tco.prologue_epochs(*t, num_annotations=num_annotations)
    # 12 annotations: the Pallas one-hot branch reads zero scores on pad
    # slots, the port column A-1 (see test_torch_fused_kernels)
    cols = (np.asarray(j[2]) < num_annotations if num_annotations > 8
            else slice(None))
    for got, want in ((tpm, jpm), (tpv, jpv)):
        want = np.asarray(want)[:, cols]
        np.testing.assert_allclose(t2n(got)[:, cols], want, rtol=1e-9,
                                   atol=1e-9 * np.abs(want).max())
    assert np.isclose(float(tkl), float(jkl), rtol=1e-9)


@pytest.mark.parametrize('num_pops', [1, 2, 3])
@pytest.mark.parametrize('num_annotations', [1, 12])
def test_epoch_delta_sums_plain_matches_pallas(num_pops, num_annotations):
    j, t = _epoch_operands(num_pops, num_annotations,
                           seed=num_pops * 5 + num_annotations)
    want = np.asarray(jco.delta_sums_epochs(
        *j, num_annotations=num_annotations, interpret=True))
    got = t2n(tco.delta_sums_epochs(*t, num_annotations=num_annotations))
    assert got.shape == want.shape == (num_annotations, 5)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def test_live_epochs_bound_the_loop():
    """Looping over the 3 live epochs only (the kernels' num_live) gives
    what the loop over all 4 slots gives: the inert slot adds zeros."""
    _, t = _epoch_operands(2, 3, seed=4)
    full = tco.prologue_epochs(*t, num_annotations=3)
    live = tco.prologue_epochs(*t, num_annotations=3, num_live=3)
    for a, b in zip(full, live):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(
        tco.delta_sums_epochs(*t, num_annotations=3, num_live=3),
        tco.delta_sums_epochs(*t, num_annotations=3), rtol=0, atol=0)
    # fewer epochs than are live is a different state
    fewer = tco.prologue_epochs(*t, num_annotations=3, num_live=2)
    assert not torch.equal(fewer[0], full[0])
    with pytest.raises(ValueError, match='num_live'):
        tco._check_epoch_operands('prologue_epochs', *t, 3, 5)


@pytest.mark.parametrize('num_pops', [1, 2, 3])
def test_compact_exprs_epochs_matches_jax(num_pops):
    data, st = _epoch_point(num_pops, 2, seed=num_pops, num_loci=64)
    tdata, tst = data_to_torch(data), state_to_torch(st)
    hist_dt = data.scaled_ld_diags[None] / st.nat_hist_scale[:, :, None]
    want = jsigma.compact_exprs_epochs(
        data.mixture_prec, jengine._diag_term(data, st.error_scaling),
        st.nat_mu, st.nat_hist, hist_dt, st.nat_hist_c)
    got = tengine._epoch_exprs(tdata.mixture_prec, tdata.scaled_ld_diags,
                               tst.error_scaling, tst)
    for field in ('mu', 'diag', 'log_det_sigma', 'matches', 'quad',
                  'quadform'):
        w = np.asarray(getattr(want, field))
        np.testing.assert_allclose(t2n(getattr(got, field)), w, rtol=1e-9,
                                   atol=1e-12 * np.abs(w).max(),
                                   err_msg=field)
    # and the module function over every slot, inert ones included
    every = tsigma.compact_exprs_epochs(
        tdata.mixture_prec, tengine._diag_term(tdata, tst.error_scaling),
        tst.nat_mu, tst.nat_hist,
        tdata.scaled_ld_diags[None] / tst.nat_hist_scale[:, :, None],
        tst.nat_hist_c)
    torch.testing.assert_close(every.mu, got.mu, rtol=1e-12, atol=0)


def _trajectory(num_pops, B=8):
    """A JAX epoch state with an empty history and the same point as a
    kdim state (K-constant broadcast), for stepping both ways."""
    data = synthetic.synthetic_problem(num_loci=128, num_pops=num_pops,
                                       num_components=4, block_size=32,
                                       num_annotations=2, scale_se=True)
    rng = np.random.default_rng(11)
    K = data.mixture_prec.shape[0]
    hyper = rng.uniform(0.1, 1.0, (2, K))
    hyper /= hyper.sum(axis=1, keepdims=True)
    u = rng.standard_normal((num_pops, 128)) * 1e-2
    st = _epoch_state(data, u, hyper, B=B)
    st = dataclasses.replace(st, error_scaling=jnp.ones(num_pops))
    return data, st


@pytest.mark.parametrize('num_pops', [1, 2])
def test_epoch_trajectory_matches_jax(num_pops, monkeypatch):
    """20 outer steps of the epoch state, carried over by convert.py,
    through real EM appends (_EPOCH_SKIP_TOL = 0 in both packages): the
    ELBO within 1e-9 relative, the posterior mean within rtol 1e-7."""
    monkeypatch.setattr(jengine, '_EPOCH_SKIP_TOL', 0.0)
    monkeypatch.setattr(tengine, '_EPOCH_SKIP_TOL', 0.0)
    data, st = _trajectory(num_pops)
    tdata, tst = data_to_torch(data), state_to_torch(st)
    assert tst.nat_hist_n == 0 and tst.nat_hist.shape[0] == 8
    for it in range(20):
        st, pm_j = jengine.outer_step(data, st, line_search_rate=2.0)
        tst, pm_t = tengine.outer_step(tdata, tst)
        assert np.isclose(tst.elbo, float(st.elbo), rtol=1e-9), it
        np.testing.assert_allclose(t2n(pm_t), np.asarray(pm_j), rtol=1e-7,
                                   atol=1e-12, err_msg=str(it))
    assert tst.nat_hist_n == int(st.nat_hist_n) >= 1
    es = t2n(tst.error_scaling)
    assert not np.allclose(es, 1.0)
    np.testing.assert_allclose(es, np.asarray(st.error_scaling), rtol=1e-9)
    np.testing.assert_allclose(t2n(tst.nat_hist_c),
                               np.asarray(st.nat_hist_c), rtol=1e-9,
                               atol=1e-15)
    np.testing.assert_allclose(t2n(tst.hyper_delta),
                               np.asarray(st.hyper_delta), rtol=1e-8)


def test_epoch_trajectory_matches_port_kdim(monkeypatch):
    """Within the port, the epoch state IS the kdim fit: 20 steps of each
    from the same point agree on the ELBO, the posterior mean, the
    learned scaling and the materialized vi_mu / vi_delta."""
    monkeypatch.setattr(tengine, '_EPOCH_SKIP_TOL', 0.0)
    # a buffer that never fills: a full one freezes the EM (see
    # test_history_grows_by_buckets_then_freezes)
    data, st = _trajectory(2, B=24)
    tdata = data_to_torch(data)
    st_e = state_to_torch(st)
    K = tdata.mixture_prec.shape[0]
    st_k = dataclasses.replace(
        st_e, nat_hist=None, nat_hist_scale=None, nat_hist_c=None,
        nat_hist_n=None,
        nat_mu=st_e.nat_mu[None].expand((K,) + tuple(st_e.nat_mu.shape))
        .contiguous())
    for it in range(20):
        st_e, pm_e = tengine.outer_step(tdata, st_e)
        st_k, pm_k = tengine.outer_step(tdata, st_k)
        assert np.isclose(st_e.elbo, st_k.elbo, rtol=1e-9), it
        np.testing.assert_allclose(t2n(pm_e), t2n(pm_k), rtol=1e-7,
                                   atol=1e-12)
    assert st_e.nat_hist_n >= 1
    np.testing.assert_allclose(t2n(st_e.error_scaling),
                               t2n(st_k.error_scaling), rtol=1e-9)
    m_e = tengine.materialize_state(tdata, st_e)
    m_k = tengine.materialize_state(tdata, st_k)
    np.testing.assert_allclose(t2n(m_e.vi_mu), t2n(m_k.vi_mu), rtol=1e-7,
                               atol=1e-12)
    np.testing.assert_allclose(t2n(m_e.vi_delta), t2n(m_k.vi_delta),
                               rtol=1e-7, atol=1e-12)


def test_multipopvi_epoch_matches_jax(tmp_path, monkeypatch):
    """With the size threshold at 0 both packages select the epoch state;
    the fits, the learned scaling and the dump's epoch keys agree."""
    for mod in (jengine, tengine):
        monkeypatch.setattr(mod, '_EPOCH_SKIP_TOL', 0.0)
        monkeypatch.setattr(mod, '_EPOCH_STATE_BYTES', 0)
    data = synthetic.synthetic_problem(num_loci=128, num_pops=2,
                                       num_components=3, block_size=32,
                                       scale_se=True)
    covs = np.linalg.inv(np.asarray(data.mixture_prec))
    kw = dict(marginal_effects=np.asarray(data.marginal_effects),
              std_errs=np.asarray(data.std_errs), mixture_covs=covs,
              annotations=np.ones((128, 1)), checkpoint=False,
              checkpoint_freq=-1, scaled=False, scale_se=True,
              gwas_N=np.full(2, 1e5), init_hg=np.full(2, 0.3), num_its=12)
    np.random.seed(17)
    jvi = jengine.MultiPopVI(ld_mats=[data.ld[0]] * 2,
                             output=str(tmp_path / 'j'), **kw)
    jst = jvi.optimize()
    tld = ld_to_torch(data.ld[0])
    np.random.seed(17)
    tvi = tengine.MultiPopVI(ld_mats=[tld, tld], output=str(tmp_path / 't'),
                             device='cpu', **kw)
    assert tvi._epoch and jvi._epoch
    tst = tvi.optimize()
    assert tst.nat_hist_n == int(jst.nat_hist_n) >= 1
    np.testing.assert_allclose(tvi.real_posterior_mean(tst),
                               np.asarray(jvi.real_posterior_mean(jst)),
                               rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(tvi.error_scaling,
                               np.asarray(jvi.error_scaling), rtol=1e-8)
    assert np.isclose(tvi.elbo_value(tst), jvi.elbo_value(jst), rtol=1e-8)
    jd, td = jvi.create_dump_dict(jst), tvi.create_dump_dict(tst)
    assert sorted(td) == sorted(jd)
    for key in ('nat_u', 'nat_hist', 'nat_hist_scale', 'nat_hist_c',
                'nat_hist_n'):
        assert key in td, key
        assert td[key].dtype == np.asarray(jd[key]).dtype, key
    for key in jd:
        np.testing.assert_allclose(td[key], np.asarray(jd[key]), rtol=1e-6,
                                   atol=1e-10 * np.abs(jd[key]).max(),
                                   err_msg=key)


def test_history_grows_by_buckets_then_freezes(caplog, monkeypatch):
    """_maybe_grow_hist keeps a free slot ahead of the next EM event:
    4 -> 8 -> 16 -> 32 -> 48 slots, then at the cap it warns once and
    the EM append freezes."""
    data = synthetic.synthetic_problem(num_loci=64, num_pops=1,
                                       num_components=3, block_size=32,
                                       scale_se=True)
    monkeypatch.setattr(tengine, '_EPOCH_STATE_BYTES', 0)
    tld = ld_to_torch(data.ld[0])
    vi = tengine.MultiPopVI(
        marginal_effects=np.asarray(data.marginal_effects),
        std_errs=np.asarray(data.std_errs), ld_mats=[tld],
        mixture_covs=np.linalg.inv(np.asarray(data.mixture_prec)),
        annotations=np.ones((64, 1)), checkpoint=False, scale_se=True,
        gwas_N=np.ones(1) * 1e5, init_hg=np.full(1, 0.3), num_its=1,
        device='cpu')
    st = vi._fresh_state()
    sizes = [st.nat_hist.shape[0]]
    with caplog.at_level(logging.WARNING):
        for n in range(1, 49):
            # one EM append: slot n-1 goes live
            st = dataclasses.replace(st, nat_hist_n=n)
            st = vi._maybe_grow_hist(st)
            if st.nat_hist.shape[0] != sizes[-1]:
                sizes.append(st.nat_hist.shape[0])
        assert st.nat_hist.shape == (48, 1, 64)
        assert st.nat_hist_scale.shape == (48, 1)
        assert float(st.nat_hist_scale[-1, 0]) == 1.0
        assert float(st.nat_hist_c.abs().sum()) == 0.0
        st = vi._maybe_grow_hist(st)
    assert sizes == [4, 8, 16, 32, 48]
    warnings = [r for r in caplog.records if 'reached its cap' in r.message]
    assert len(warnings) == 1
    # a full buffer freezes the EM: the state is unchanged
    st = dataclasses.replace(st, nat_mu=torch.ones_like(st.nat_mu),
                             error_scaling=st.error_scaling * 2)
    obj, pm, lk = tengine._objective(vi.data, st, tengine._params(st),
                                     torch.full_like(st.hyper_delta, 1 / 3))
    st = dataclasses.replace(st, hyper_delta=torch.full_like(
        st.hyper_delta, 1 / 3))
    new, delta, _ = tengine._update_error_scaling(vi.data, st, float(obj),
                                                  pm, lk)
    assert new is st and delta == 0.0
