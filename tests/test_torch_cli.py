"""`vilma-tpu-torch fit --device cpu --precision f64` against `vilma-tpu
fit --precision f64` on a tiny on-disk LD schema written with numpy:
the .estimates.tsv, .npz and .covariance.pkl outputs agree, and the
streamed-output route writes what the materialized one writes."""
import os
import pickle

import numpy as np
import pytest

from vilma_tpu import frontend as jfrontend
from vilma_tpu.inference import engine as jengine
from vilma_tpu_torch import frontend as tfrontend
from vilma_tpu_torch.inference import engine as tengine

import tests.torch_parity  # noqa: F401  (one torch thread per worker)

SIZES = (40, 56, 32)
NUM_ITS = '5'          # < 10 iterations never converge: both take 5 steps


def _write_case(root, seed=0):
    """Three stacked-eigendecomposition LD blocks (.npy + .var) under a
    .schema manifest, two cohorts' sumstats (BETA and OR columns, with
    allele flips and a missing row), an extract list with one variant
    absent from the panel, and an annotation file with one variant
    unannotated (numeric categories: the JAX package's pandas loader
    rejects string categories once a missing one is filled with 0)."""
    rng = np.random.default_rng(seed)
    n = sum(SIZES)
    ids = [f'rs{i}' for i in range(n)]
    ref = rng.choice(['A', 'C'], n)
    alt = np.where(ref == 'A', 'G', 'T')
    manifest, start = [], 0
    for b, size in enumerate(SIZES):
        rho = rng.uniform(0.3, 0.9)
        lag = np.abs(np.subtract.outer(np.arange(size), np.arange(size)))
        w, v = np.linalg.eigh(rho ** lag)
        keep = slice(size // 4, None)                 # drop the smallest
        np.save(os.path.join(root, f'block{b}.npy'),
                np.vstack([v[:, keep], w[None, keep]]))
        with open(os.path.join(root, f'block{b}.var'), 'w') as fh:
            for i in range(start, start + size):
                # the panel lists a few variants with alleles swapped
                x, y = (alt[i], ref[i]) if i % 9 == 4 else (ref[i], alt[i])
                fh.write(f'{ids[i]}\t1\t{i + 1}\t0.0\t{x}\t{y}\n')
        manifest.append(f'block{b}.var\tblock{b}.npy')
        start += size
    schema = os.path.join(root, 'panel.schema')
    with open(schema, 'w') as fh:
        fh.write('\n'.join(manifest) + '\n')

    se = rng.uniform(0.01, 0.05, (2, n))
    beta = rng.standard_normal((2, n)) * se * 2
    paths = []
    for p, col in enumerate(('BETA', 'OR')):
        path = os.path.join(root, f'pop{p + 1}.tsv')
        with open(path, 'w') as fh:
            fh.write(f'ID\tA1\tA2\t{col}\tSE\n')
            for i in range(n):
                if i == 17 + p:
                    continue                          # missing row
                flip = i % 7 == 3
                b = -beta[p, i] if flip else beta[p, i]
                val = np.exp(b) if col == 'OR' else b
                x, y = (alt[i], ref[i]) if flip else (ref[i], alt[i])
                fh.write(f'{ids[i]}\t{x}\t{y}\t{float(val)!r}\t'
                         f'{float(se[p, i])!r}\n')
        paths.append(path)
    extract = os.path.join(root, 'extract.tsv')
    with open(extract, 'w') as fh:
        fh.write('ID\tA1\tA2\n')
        for i in range(n):
            fh.write(f'{ids[i]}\t{ref[i]}\t{alt[i]}\n')
        fh.write('rs_offpanel\tA\tG\n')
    annot = os.path.join(root, 'annot.tsv')
    with open(annot, 'w') as fh:
        fh.write('ID\tANNOTATION\n')
        for i in range(n):
            if i != 30:
                fh.write(f'{ids[i]}\t{1 + i % 3}\n')
    return schema, paths, extract, annot


def _argv(case, out):
    schema, (s1, s2), extract, annot = case
    return ['fit', '--ld-schema', f'{schema},{schema}',
            '--sumstats', f'{s1},{s2}', '--extract', extract,
            '--annotations', annot, '--names', 'eur,afr',
            '--samplesizes', '1e5,5e4', '--init-hg', '0.3,0.2',
            '--seed', '7', '--num-its', NUM_ITS, '-K', '3',
            '--precision', 'f64', '--output', out]


def _run_both(tmp, tag, stream_bytes=None, monkeypatch=None):
    case = _write_case(tmp)
    outs = {}
    if stream_bytes is not None:
        monkeypatch.setattr(jengine, '_STREAM_OUTPUT_BYTES', stream_bytes)
        monkeypatch.setattr(tengine, '_STREAM_OUTPUT_BYTES', stream_bytes)
    outs['jax'] = os.path.join(tmp, f'jax_{tag}')
    jfrontend.main(_argv(case, outs['jax']))
    outs['torch'] = os.path.join(tmp, f'torch_{tag}')
    tfrontend.main(_argv(case, outs['torch']) + ['--device', 'cpu'])
    return outs


def _read_tsv(path):
    with open(path) as fh:
        header = fh.readline().rstrip('\n').split('\t')
        rows = [line.rstrip('\n').split('\t') for line in fh]
    return header, {h: [r[j] for r in rows] for j, h in enumerate(header)}


@pytest.fixture(scope='module')
def fits(tmp_path_factory):
    return _run_both(str(tmp_path_factory.mktemp('fit')), 'mat')


def test_estimates_tsv_matches_jax(fits):
    jh, jcols = _read_tsv(fits['jax'] + '.estimates.tsv')
    th, tcols = _read_tsv(fits['torch'] + '.estimates.tsv')
    assert th == jh
    assert 'missing_annotation' in th and 'posterior_afr' in th
    for col in th:
        if col.startswith('posterior'):
            j = np.array(jcols[col], dtype=float)
            t = np.array(tcols[col], dtype=float)
            np.testing.assert_allclose(t, j, rtol=0,
                                       atol=1e-8 * np.abs(j).max())
        else:
            assert tcols[col] == jcols[col], col
    # the loaders' missing-data rules fired on this case
    assert 'True' in tcols['missing_sumstats_eur']
    assert 'True' in tcols['missing_LD_afr']
    # rs30 and the off-panel variant have no annotation
    assert tcols['missing_annotation'].count('True') == 2


def test_npz_matches_jax(fits):
    j = np.load(fits['jax'] + '.npz')
    t = np.load(fits['torch'] + '.npz')
    assert sorted(t.files) == sorted(j.files)
    assert {'vi_mu', 'vi_delta', 'hyper_delta', 'error_scaling',
            'scalings', 'vi_sigma'} <= set(t.files)
    for key in j.files:
        assert t[key].shape == j[key].shape, key
        assert t[key].dtype == j[key].dtype, key
        np.testing.assert_allclose(t[key], j[key], rtol=1e-8,
                                   atol=1e-8 * np.abs(j[key]).max(),
                                   err_msg=key)


def test_covariance_pickle_matches_jax(fits):
    with open(fits['jax'] + '.covariance.pkl', 'rb') as fh:
        jcov = pickle.load(fh)
    with open(fits['torch'] + '.covariance.pkl', 'rb') as fh:
        tcov = pickle.load(fh)
    assert len(tcov) == len(jcov) == 1
    # the same grid draws; the grid's ends follow the parsed sumstats,
    # which pandas' fast float parser may round one ulp off float()
    np.testing.assert_allclose(np.asarray(tcov[0]), np.asarray(jcov[0]),
                               rtol=1e-12, atol=0)


def test_streamed_outputs_match_materialized(fits, tmp_path, monkeypatch):
    """With the output budget forced to one byte both packages write
    vi_mu / vi_delta / vi_sigma in chunks and assemble the posterior
    moments from variant chunks; the files equal the materialized run's."""
    streamed = _run_both(str(tmp_path), 'stream', stream_bytes=1,
                         monkeypatch=monkeypatch)
    mat = np.load(fits['torch'] + '.npz')
    for pkg in ('torch', 'jax'):
        got = np.load(streamed[pkg] + '.npz')
        assert sorted(got.files) == sorted(mat.files)
        for key in mat.files:
            np.testing.assert_allclose(got[key], mat[key], rtol=1e-8,
                                       atol=1e-8 * np.abs(mat[key]).max(),
                                       err_msg=f'{pkg} {key}')
    _, mcols = _read_tsv(fits['torch'] + '.estimates.tsv')
    _, scols = _read_tsv(streamed['torch'] + '.estimates.tsv')
    for col in mcols:
        if col.startswith('posterior'):
            m = np.array(mcols[col], dtype=float)
            np.testing.assert_allclose(np.array(scols[col], dtype=float), m,
                                       rtol=0, atol=1e-12 * np.abs(m).max())
        else:
            assert scols[col] == mcols[col]
