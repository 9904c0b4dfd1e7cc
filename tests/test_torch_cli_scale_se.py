"""`vilma-tpu-torch fit --learn-scaling --device cpu --precision f64`
against `vilma-tpu fit --learn-scaling --precision f64` on the tiny
on-disk case of test_torch_cli, on both scale_se routes: the kdim state
(this size) and the epoch-history state (size threshold forced to 0), and
through the streamed-output route. Tolerances are test_torch_cli's."""
import os
import pickle

import numpy as np
import pytest

from vilma_tpu import frontend as jfrontend
from vilma_tpu.inference import engine as jengine
from vilma_tpu_torch import frontend as tfrontend
from vilma_tpu_torch.inference import engine as tengine

from tests.test_torch_cli import _argv, _read_tsv, _write_case

EPOCH_KEYS = ('nat_u', 'nat_hist', 'nat_hist_scale', 'nat_hist_c',
              'nat_hist_n')


def _run_both(tmp, tag, monkeypatch=None, epoch=False, stream_bytes=None):
    case = _write_case(tmp)
    if epoch:
        for mod in (jengine, tengine):
            monkeypatch.setattr(mod, '_EPOCH_STATE_BYTES', 0)
    if stream_bytes is not None:
        for mod in (jengine, tengine):
            monkeypatch.setattr(mod, '_STREAM_OUTPUT_BYTES', stream_bytes)
    outs = {}
    for pkg, main, extra in (('jax', jfrontend.main, []),
                             ('torch', tfrontend.main, ['--device', 'cpu'])):
        outs[pkg] = os.path.join(tmp, f'{pkg}_{tag}')
        main(_argv(case, outs[pkg]) + ['--learn-scaling'] + extra)
    return outs


def _assert_estimates_match(jpath, tpath):
    jh, jcols = _read_tsv(jpath + '.estimates.tsv')
    th, tcols = _read_tsv(tpath + '.estimates.tsv')
    assert th == jh
    for col in th:
        if col.startswith('posterior'):
            j = np.array(jcols[col], dtype=float)
            np.testing.assert_allclose(np.array(tcols[col], dtype=float), j,
                                       rtol=0, atol=1e-8 * np.abs(j).max(),
                                       err_msg=col)
        else:
            assert tcols[col] == jcols[col], col


def _assert_npz_match(jpath, tpath):
    j = np.load(jpath + '.npz')
    t = np.load(tpath + '.npz')
    assert sorted(t.files) == sorted(j.files)
    for key in j.files:
        assert t[key].shape == j[key].shape, key
        assert t[key].dtype == j[key].dtype, key
        np.testing.assert_allclose(t[key], j[key], rtol=1e-8,
                                   atol=1e-8 * np.abs(j[key]).max(),
                                   err_msg=key)
    # the comparison means something only if the scaling was learned
    assert not np.allclose(t['error_scaling'], 1.0)
    return t


@pytest.fixture(scope='module')
def kdim_fits(tmp_path_factory):
    return _run_both(str(tmp_path_factory.mktemp('fit_se')), 'kdim')


def test_learn_scaling_estimates_match_jax(kdim_fits):
    _assert_estimates_match(kdim_fits['jax'], kdim_fits['torch'])


def test_learn_scaling_npz_matches_jax(kdim_fits):
    t = _assert_npz_match(kdim_fits['jax'], kdim_fits['torch'])
    assert not set(EPOCH_KEYS) & set(t.files)


def test_learn_scaling_covariance_pickle_matches_jax(kdim_fits):
    with open(kdim_fits['jax'] + '.covariance.pkl', 'rb') as fh:
        jcov = pickle.load(fh)
    with open(kdim_fits['torch'] + '.covariance.pkl', 'rb') as fh:
        tcov = pickle.load(fh)
    np.testing.assert_allclose(np.asarray(tcov[0]), np.asarray(jcov[0]),
                               rtol=1e-12, atol=0)


def test_learn_scaling_epoch_route_matches_jax(tmp_path, monkeypatch):
    """The epoch-history route writes what the JAX package's writes,
    epoch keys included, and fits what the kdim route fits."""
    outs = _run_both(str(tmp_path), 'epoch', monkeypatch, epoch=True)
    _assert_estimates_match(outs['jax'], outs['torch'])
    t = _assert_npz_match(outs['jax'], outs['torch'])
    assert set(EPOCH_KEYS) <= set(t.files)
    assert int(t['nat_hist_n']) >= 1


def test_learn_scaling_streamed_outputs_match_jax(kdim_fits, tmp_path,
                                                  monkeypatch):
    """With the output budget forced to one byte, both packages stream
    vi_mu / vi_delta / vi_sigma of the kdim state in chunks; the files
    equal the materialized fit's."""
    outs = _run_both(str(tmp_path), 'stream', monkeypatch, stream_bytes=1)
    mat = np.load(kdim_fits['torch'] + '.npz')
    for pkg in ('torch', 'jax'):
        got = np.load(outs[pkg] + '.npz')
        assert sorted(got.files) == sorted(mat.files)
        for key in mat.files:
            np.testing.assert_allclose(got[key], mat[key], rtol=1e-8,
                                       atol=1e-8 * np.abs(mat[key]).max(),
                                       err_msg=f'{pkg} {key}')
    _assert_estimates_match(kdim_fits['torch'], outs['torch'])
