"""vilma_tpu_torch.utils.synthetic against vilma_tpu.utils.synthetic at
float64 on the CPU: the same AR(1) panels (the host route and the card
route's batched eigh, run here on CPU tensors), the same problem from the
same seeds, the same state of all four forms, and one outer step of each
package from its own synthetic point."""
import dataclasses

import numpy as np
import pytest
import torch

from vilma_tpu.inference import engine as jengine
from vilma_tpu.ops import blocks as jblocks
from vilma_tpu.utils import synthetic as jsyn
from vilma_tpu_torch.inference import engine as tengine
from vilma_tpu_torch.ops import blocks as tblocks
from vilma_tpu_torch.utils import synthetic as tsyn

from tests.torch_parity import data_to_torch, t2n

# the dense panels agree to rounding (1e-12 absolute, entries <= 1); the
# problem's derived fields and the states' derived summaries to 1e-12 of
# their scale; the ELBO and the outer step at tests/test_torch_engine.py's
# tolerances (1e-11 relative objective; 1e-8 relative ELBO and 1e-8 of
# scale for posterior means after a step)
DENSE_ATOL = 1e-12
DERIVED_RTOL = 1e-12
ELBO_RTOL = 1e-11
STEP_RTOL = 1e-8

DRAWN = ('marginal_effects', 'std_errs', 'annotations', 'annotation_counts')
DERIVED = ('scalings', 'ld_diags', 'scaled_ld_diags', 'adj_marginal_effects',
           'chi_stat', 'ld_ranks', 'inverse_betas', 'mixture_prec',
           'log_det')
FORMS = {'shared': (False, True, None), 'kdim': (True, True, None),
         'epoch': (True, True, 4), 'materialized': (False, False, None)}


def _close(got, want, rtol=DERIVED_RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(
        t2n(got) if torch.is_tensor(got) else np.asarray(got), want,
        rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize('num_loci,block_size,rank_frac', [
    (200, 48, 1.0), (200, 48, 0.5), (96, 32, 0.5), (130, 64, 0.25)])
def test_synthetic_ld_matches_jax(num_loci, block_size, rank_frac):
    """The host route packs the JAX package's matrix (ragged last blocks
    included), with its rank and missing set."""
    want = jsyn.synthetic_ld(num_loci, block_size, rank_frac, seed=3)
    got = tsyn.synthetic_ld(num_loci, block_size, rank_frac, seed=3,
                            device='cpu')
    np.testing.assert_allclose(tblocks.to_dense(got),
                               np.asarray(jblocks.to_dense(want)),
                               rtol=0, atol=DENSE_ATOL)
    assert got.rank == want.rank
    assert got.missing == tuple(want.missing) == ()


@pytest.mark.parametrize('rank_frac', [1.0, 0.5])
def test_card_route_factors_match_host_route(rank_frac):
    """The card route's batched float64 eigh and thresholds (run on CPU
    tensors here, the batch shrunk so that a size spans two batches)
    give the host route's blocks: the same ranks and dense blocks."""
    specs = tsyn._ar1_specs(200, 32, seed=7)
    old = tsyn._EIGH_BATCH
    tsyn._EIGH_BATCH = 4
    try:
        card = list(tsyn._device_factors(specs, rank_frac, 'cpu'))
    finally:
        tsyn._EIGH_BATCH = old
    host = list(tsyn._host_factors(specs, rank_frac))
    assert len(card) == len(host) == 7
    for c, h in zip(card, host):
        assert (c.r, c.rank) == (h.r, h.rank)
        np.testing.assert_allclose(c.s, h.s, rtol=1e-13)
        np.testing.assert_allclose(c.dense(), h.dense(), rtol=0,
                                   atol=DENSE_ATOL)


def test_eigh_factor_thresholds():
    """factor_block's thresholds on ascending eigenpairs: negative and
    tiny eigenvalues dropped; none left gives the rank-0 sentinel."""
    vecs = torch.eye(3, dtype=torch.float64)
    f = tsyn._eigh_factor(torch.tensor([-1.0, 1e-15, 2.0],
                                       dtype=torch.float64), vecs)
    assert (f.r, f.rank) == (1, 1) and f.s.tolist() == [2.0]
    f = tsyn._eigh_factor(torch.tensor([-2.0, -1.0, -0.5],
                                       dtype=torch.float64), vecs)
    assert (f.r, f.rank) == (1, 0) and f.s.tolist() == [0.0]
    assert np.all(f.u == 1.0)


@pytest.mark.parametrize('scale_se', [False, True])
@pytest.mark.parametrize('num_pops', [1, 2, 3])
def test_synthetic_problem_matches_jax(num_pops, scale_se):
    """Every ModelData field: the draws bit for bit, the derived fields
    within 1e-12 of their scale; the LD matrices alike."""
    kw = dict(num_loci=160, num_pops=num_pops, num_components=5,
              block_size=48, num_annotations=3, seed=num_pops,
              scale_se=scale_se, rank_frac=0.5)
    want = jsyn.synthetic_problem(**kw)
    got = tsyn.synthetic_problem(**kw, device='cpu')
    assert got.scale_se == want.scale_se == scale_se
    assert got.num_annotations == want.num_annotations
    assert got.ld_index == tuple(want.ld_index) == (0,) * num_pops
    for name in DRAWN:
        np.testing.assert_array_equal(t2n(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in DERIVED:
        _close(getattr(got, name), getattr(want, name))
    np.testing.assert_allclose(tblocks.to_dense(got.ld[0]),
                               np.asarray(jblocks.to_dense(want.ld[0])),
                               rtol=0, atol=DENSE_ATOL)


def _pair(form, seed=5):
    """(JAX data, JAX state, port data, port state) of one form, each
    package from its own synthetic problem and point."""
    scale_se, compact, epoch_b = FORMS[form]
    kw = dict(num_loci=192, num_pops=2, num_components=4, block_size=48,
              num_annotations=2, seed=2, scale_se=scale_se)
    jdata = jsyn.synthetic_problem(**kw)
    tdata = tsyn.synthetic_problem(**kw, device='cpu')
    jst = jsyn.synthetic_state(jdata, seed=seed, compact=compact,
                               epoch_b=epoch_b)
    tst = tsyn.synthetic_state(tdata, seed=seed, compact=compact,
                               epoch_b=epoch_b)
    return jdata, jst, tdata, tst


@pytest.mark.parametrize('form', list(FORMS))
def test_synthetic_state_matches_jax(form):
    """The drawn fields bit for bit, the derived ones (sigma summaries,
    nat_grad_vi_delta) within 1e-12 of their scale, the host scalars
    alike, and the ELBO within 1e-11 relative."""
    _, jst, tdata, tst = _pair(form)
    drawn = {'shared': ('nat_mu', 'hyper_delta'),
             'kdim': ('nat_mu', 'hyper_delta'),
             'epoch': ('nat_mu', 'hyper_delta', 'nat_hist',
                       'nat_hist_scale', 'nat_hist_c'),
             'materialized': ('vi_mu', 'vi_delta', 'hyper_delta')}[form]
    for name in drawn + ('error_scaling',):
        np.testing.assert_array_equal(t2n(getattr(tst, name)),
                                      np.asarray(getattr(jst, name)),
                                      err_msg=name)
    if form == 'epoch':
        assert tst.nat_hist.shape == (4, 2, 192)
        assert tst.nat_hist_n == int(jst.nat_hist_n) == 0
        assert isinstance(tst.nat_hist_n, int)
    if form == 'kdim':
        assert tst.nat_mu.shape == (4, 2, 192)
    if form == 'materialized':
        assert tst.nat_mu is None
        _close(tst.nat_grad_vi_delta, jst.nat_grad_vi_delta)
        for f in dataclasses.fields(tst.sigma):
            _close(getattr(tst.sigma, f.name), getattr(jst.sigma, f.name))
    else:
        assert tst.vi_mu is None and tst.sigma is None
    assert tst.L == (1.0, 1.0, 1.0) and tst.num_err == 0
    assert np.isnan(tst.running_elbo_delta)
    assert np.isclose(tst.elbo, float(jst.elbo), rtol=ELBO_RTOL, atol=0)
    # the ELBO is the port's objective at the point (MultiPopVI's)
    assert tst.elbo == tengine.state_elbo(tdata, tst)


@pytest.mark.parametrize('form', list(FORMS))
def test_outer_step_from_synthetic_points_matches_jax(form):
    """One outer step of each package from its own synthetic point: the
    ELBO within 1e-8 relative, the posterior means within 1e-8 of their
    scale."""
    jdata, jst, tdata, tst = _pair(form, seed=8)
    jst, jpm = jengine.outer_step(jdata, jst, line_search_rate=2.0)
    tst, tpm = tengine.outer_step(tdata, tst)
    assert np.isclose(tst.elbo, float(jst.elbo), rtol=STEP_RTOL, atol=0)
    jpm = np.asarray(jpm)
    np.testing.assert_allclose(t2n(tpm), jpm, rtol=0,
                               atol=STEP_RTOL * np.abs(jpm).max())


def test_port_ld_carries_over_to_jax_data():
    """The JAX problem's data through tests/torch_parity.py equals the
    port's own problem: the two paths of the parity tests meet."""
    kw = dict(num_loci=96, num_pops=2, num_components=3, block_size=32)
    via = data_to_torch(jsyn.synthetic_problem(**kw))
    own = tsyn.synthetic_problem(**kw, device='cpu')
    for name in DRAWN + DERIVED:
        _close(getattr(own, name), getattr(via, name))


def test_device_defaults_to_the_card(monkeypatch):
    """Without a card the generators raise unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsyn.synthetic_ld(64, 32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsyn.synthetic_problem(num_loci=64, block_size=32)
