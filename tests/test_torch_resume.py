"""Checkpoint resume of vilma_tpu_torch against vilma_tpu at float64 on
the CPU, on all three compact states (shared [P, I], kdim [K, P, I] and
epoch history): a checkpoint written by either package is resumed by
both, and the resumed trajectories agree. Also the epoch state's
ValueError when the epoch keys are missing, the streamed recovery with a
shrunk chunk budget against the materialized one, and `fit
--load-checkpoint` through both CLIs.

Tolerances are the route-equality ones of the JAX package's own tests
(tests/test_chunked_k.py, tests/test_compact_state.py): ELBOs to 1e-10
relative, recovered natural means to 1e-10 relative, posterior means to
1e-8 of their scale."""
import os
import pickle

import numpy as np
import pytest
import torch

from vilma_tpu import frontend as jfrontend
from vilma_tpu.inference import engine as jengine
from vilma_tpu.utils import synthetic
from vilma_tpu_torch import frontend as tfrontend
from vilma_tpu_torch.inference import engine as tengine

from tests.test_torch_cli import _argv, _read_tsv, _write_case
from tests.torch_parity import ld_to_torch, t2n

NUM_LOCI = 128
CKPT_AT = 8        # checkpoint written at this iteration
RESUMED_ITS = 4    # steps taken after resuming

STATES = ('shared', 'kdim', 'epoch')


def _inputs(state):
    """Constructor arguments shared by both packages' MultiPopVI, and
    the port's copy of the LD."""
    scale_se = state != 'shared'
    data = synthetic.synthetic_problem(
        num_loci=NUM_LOCI, num_pops=2, num_components=5, block_size=32,
        num_annotations=2, scale_se=scale_se, seed=3)
    annot = np.eye(2)[np.asarray(data.annotations)]
    kw = dict(marginal_effects=np.asarray(data.marginal_effects),
              std_errs=np.asarray(data.std_errs),
              mixture_covs=np.linalg.inv(np.asarray(data.mixture_prec)),
              annotations=annot, scaled=False, scale_se=scale_se,
              gwas_N=np.full(2, 1e5), init_hg=np.full(2, 0.3))
    return kw, data.ld[0], ld_to_torch(data.ld[0])


def _schemes(state, tmp, tag, num_its, checkpoint):
    kw, jld, tld = _inputs(state)
    common = dict(checkpoint=checkpoint, checkpoint_freq=CKPT_AT,
                  num_its=num_its, **kw)
    j = jengine.MultiPopVI(ld_mats=[jld, jld],
                           output=os.path.join(tmp, f'jax_{tag}'), **common)
    t = tengine.MultiPopVI(ld_mats=[tld, tld],
                           output=os.path.join(tmp, f'torch_{tag}'),
                           dtype=torch.float64, device='cpu', **common)
    return j, t


def _force_epoch(state, monkeypatch):
    """The epoch state is selected by size: force it for 'epoch' cases
    in both packages, as VILMA_EPOCH_STATE_BYTES=0 does."""
    if state == 'epoch':
        for mod in (jengine, tengine):
            monkeypatch.setattr(mod, '_EPOCH_STATE_BYTES', 0)


def _write_checkpoints(state, tmp):
    """Run both packages from their initializations to CKPT_AT with
    checkpointing on; return {package: checkpoint path}."""
    np.random.seed(5)
    j, _ = _schemes(state, tmp, 'a', CKPT_AT + 1, True)
    j.optimize()
    np.random.seed(5)
    _, t = _schemes(state, tmp, 'a', CKPT_AT + 1, True)
    t.optimize()
    return {pkg: os.path.join(tmp, f'{pkg}_a-checkpoint.{CKPT_AT}.npz')
            for pkg in ('jax', 'torch')}


def _resume_both(state, tmp, ckpt):
    """Resume both packages from one checkpoint for RESUMED_ITS steps,
    recording each step's ELBO; returns {package: (scheme, restored
    state, final state, ELBOs)}."""
    out = {}
    for pkg in ('jax', 'torch'):
        j, t = _schemes(state, tmp, 'b', RESUMED_ITS, False)
        scheme, eng = (j, jengine) if pkg == 'jax' else (t, tengine)
        restored = scheme._state_from_checkpoint(np.load(ckpt))
        elbos = []
        real = eng.MultiPopVI._dump_info

        def record(self, num_its, stats, _elbos=elbos):
            _elbos.append(float(stats[1]))
        eng.MultiPopVI._dump_info = record
        try:
            final = scheme.optimize(np.load(ckpt))
        finally:
            eng.MultiPopVI._dump_info = real
        out[pkg] = (scheme, restored, final, elbos)
    return out


def _nat(pkg, st):
    return np.asarray(st.nat_mu) if pkg == 'jax' else t2n(st.nat_mu)


@pytest.mark.parametrize('source', ['jax', 'torch'])
@pytest.mark.parametrize('state', STATES)
def test_resume_follows_reference(state, source, tmp_path, monkeypatch):
    _force_epoch(state, monkeypatch)
    tmp = str(tmp_path)
    ckpts = _write_checkpoints(state, tmp)
    z = np.load(ckpts[source])
    if state == 'epoch':
        assert int(z['nat_hist_n']) >= 1, 'no EM epoch before the checkpoint'
    if state != 'shared':
        assert not np.allclose(z['error_scaling'], 1.0)
    runs = _resume_both(state, tmp, ckpts[source])
    (js, jr, jf, je), (ts, tr, tf, te) = runs['jax'], runs['torch']
    # the restored parameter point
    want = _nat('jax', jr)
    np.testing.assert_allclose(_nat('torch', tr), want, rtol=1e-10,
                               atol=1e-10 * np.abs(want).max())
    if state == 'epoch':
        assert tr.nat_hist_n == int(jr.nat_hist_n)
        assert tr.nat_hist.shape == jr.nat_hist.shape
        np.testing.assert_allclose(t2n(tr.nat_hist), np.asarray(jr.nat_hist),
                                   rtol=0, atol=0)
    np.testing.assert_allclose(ts.elbo_value(tr), js.elbo_value(jr),
                               rtol=1e-10)
    # the resumed trajectory, step by step, and where it ends
    assert len(te) == len(je) == RESUMED_ITS
    np.testing.assert_allclose(te, je, rtol=1e-10)
    jpm = js.real_posterior_mean(jf)
    np.testing.assert_allclose(ts.real_posterior_mean(tf), jpm, rtol=0,
                               atol=1e-8 * np.abs(jpm).max())
    np.testing.assert_allclose(ts.error_scaling, np.asarray(jf.error_scaling),
                               rtol=1e-10)


@pytest.mark.parametrize('state', ['epoch'])
def test_epoch_resume_needs_epoch_keys(state, tmp_path, monkeypatch):
    """A checkpoint without the epoch keys (a kdim-state checkpoint)
    cannot resume an epoch-state fit: both packages raise ValueError."""
    _force_epoch(state, monkeypatch)
    tmp = str(tmp_path)
    ckpts = _write_checkpoints(state, tmp)
    z = np.load(ckpts['torch'])
    bare = os.path.join(tmp, 'bare.npz')
    np.savez(bare, **{k: z[k] for k in z.files if not k.startswith('nat_')})
    j, t = _schemes(state, tmp, 'c', 1, False)
    for scheme in (j, t):
        assert scheme._epoch
        with pytest.raises(ValueError, match='epoch keys'):
            scheme._state_from_checkpoint(np.load(bare))


def test_resume_without_error_scaling_warns(tmp_path, caplog):
    """A checkpoint without error_scaling resumes with unit scalings and
    a warning, as the reference does."""
    tmp = str(tmp_path)
    ckpts = _write_checkpoints('shared', tmp)
    z = np.load(ckpts['torch'])
    bare = os.path.join(tmp, 'bare.npz')
    np.savez(bare, **{k: z[k] for k in z.files if k != 'error_scaling'})
    j, t = _schemes('shared', tmp, 'c', 1, False)
    jr = j._state_from_checkpoint(np.load(bare))
    with caplog.at_level('WARNING'):
        tr = t._state_from_checkpoint(np.load(bare))
    assert 'error_scaling' in caplog.text
    assert np.all(t2n(tr.error_scaling) == 1.0)
    np.testing.assert_allclose(t2n(tr.nat_mu), np.asarray(jr.nat_mu),
                               rtol=1e-10, atol=0)


@pytest.mark.parametrize('state', ['shared', 'kdim'])
def test_streamed_resume_equals_materialized(state, tmp_path, monkeypatch):
    """With the output budget forced to one byte, resume takes the
    streamed route (a memmap of the vi_mu member; the kdim state in
    K-chunks of two components, the chunk budget shrunk) and recovers
    exactly the materialized route's natural means; a compressed
    checkpoint falls back to a full read with a warning."""
    tmp = str(tmp_path)
    ckpt = _write_checkpoints(state, tmp)['jax']
    _, t = _schemes(state, tmp, 'c', 1, False)
    want = t2n(t._state_from_checkpoint(np.load(ckpt)).nat_mu)
    monkeypatch.setattr(tengine, '_STREAM_OUTPUT_BYTES', 1)
    monkeypatch.setattr(tengine, '_RESUME_CHUNK_BYTES', 2 * 2 * NUM_LOCI * 8)
    _, t = _schemes(state, tmp, 'd', 1, False)
    assert t._stream_big()
    chunks = []
    real = tengine.sigma_mod.apply_precision

    def counted(prec, dterm, x):
        chunks.append(x.shape[0])
        return real(prec, dterm, x)
    monkeypatch.setattr(tengine.sigma_mod, 'apply_precision', counted)
    got = t2n(t._state_from_checkpoint(np.load(ckpt)).nat_mu)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    if state == 'kdim':
        assert chunks == [2, 2, 1]
    z = np.load(ckpt)
    packed = os.path.join(tmp, 'compressed.npz')
    np.savez_compressed(packed, **{k: z[k] for k in z.files})
    got = t2n(t._state_from_checkpoint(np.load(packed)).nat_mu)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize('learn_scaling', [False, True])
def test_cli_load_checkpoint_matches_jax(learn_scaling, tmp_path):
    """`fit --load-checkpoint CKPT.npz COV.pkl` through both CLIs: the
    port resumes the JAX package's checkpoint with the JAX package's
    grid, writes no .covariance.pkl, and its outputs equal the JAX
    package's resumed outputs."""
    tmp = str(tmp_path)
    case = _write_case(tmp)
    extra = ['--learn-scaling'] if learn_scaling else []
    first = os.path.join(tmp, 'first')
    jfrontend.main(_argv(case, first) + extra + ['--checkpoint-freq', '3'])
    ckpt = first + '-checkpoint.3.npz'
    assert os.path.exists(ckpt)
    outs = {}
    for pkg, main, dev in (('jax', jfrontend.main, []),
                           ('torch', tfrontend.main, ['--device', 'cpu'])):
        outs[pkg] = os.path.join(tmp, f'{pkg}_resumed')
        main(_argv(case, outs[pkg]) + extra + dev
             + ['--load-checkpoint', ckpt, first + '.covariance.pkl'])
    assert not os.path.exists(outs['torch'] + '.covariance.pkl')
    jh, jcols = _read_tsv(outs['jax'] + '.estimates.tsv')
    th, tcols = _read_tsv(outs['torch'] + '.estimates.tsv')
    assert th == jh
    for col in th:
        if col.startswith('posterior'):
            j = np.array(jcols[col], dtype=float)
            np.testing.assert_allclose(np.array(tcols[col], dtype=float), j,
                                       rtol=0, atol=1e-8 * np.abs(j).max(),
                                       err_msg=col)
        else:
            assert tcols[col] == jcols[col], col
    j = np.load(outs['jax'] + '.npz')
    t = np.load(outs['torch'] + '.npz')
    assert sorted(t.files) == sorted(j.files)
    for key in j.files:
        np.testing.assert_allclose(t[key], j[key], rtol=1e-8,
                                   atol=1e-8 * np.abs(j[key]).max(),
                                   err_msg=key)
    with open(first + '.covariance.pkl', 'rb') as fh:
        assert len(pickle.load(fh)[0]) == j['vi_mu'].shape[0]
