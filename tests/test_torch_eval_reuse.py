"""The record of a state's last evaluation (engine._LastEval) on small
CPU fits at float64: a step starts from the record of the previous
step's last evaluation, and the EM takes its posterior variances from
it, only while the evaluation's inputs are the state's own tensors,
unmodified; the steps are bitwise those of steps that evaluate afresh,
on every state form and mesh; the record is in no output."""
import dataclasses
import glob

import numpy as np
import pytest
import torch

from vilma_tpu_torch.inference import engine as tengine
from vilma_tpu_torch.ops import blocks as tblocks
from vilma_tpu_torch.parallel import mesh as tmesh
from vilma_tpu_torch.utils import synthetic

NUM_LOCI = 128
STEPS = 20
BASE_KEYS = {'vi_mu', 'vi_delta', 'hyper_delta', 'error_scaling',
             'scalings'}
EPOCH_KEYS = {'nat_u', 'nat_hist', 'nat_hist_scale', 'nat_hist_c',
              'nat_hist_n'}

# (state form, mesh (snp, comp) or None); 'grow' is the epoch state
# through _maybe_grow_hist up to a cap of 8 slots, then frozen EMs
CASES = [('shared', None), ('kdim', None), ('epoch', None),
         ('materialized', None), ('grow', None),
         ('kdim', (1, 2)), ('materialized', (1, 2)),
         ('kdim', (2, 1)), ('materialized', (2, 1))]


def _vi(form, monkeypatch, mesh=None, **kw):
    """A fit of 128 SNPs a snp shard in blocks of 32: 2 cohorts (the
    shared state, or with --learn-scaling the kdim or epoch state), or 4 (the
    materialized state, with --learn-scaling), on `mesh` (snp, comp) of
    CPU shards."""
    if form in ('epoch', 'grow'):
        monkeypatch.setattr(tengine, '_EPOCH_STATE_BYTES', 0)
    if form == 'grow':
        monkeypatch.setattr(tengine, '_EPOCH_BUCKETS', (4, 8))
        monkeypatch.setattr(tengine, '_EPOCH_CAP', 8)
    P = 4 if form == 'materialized' else 2
    # a shard-local span is a multiple of 128 SNPs
    n = NUM_LOCI * (1 if mesh is None else mesh[0])
    rng = np.random.default_rng(2)
    ld = synthetic.synthetic_ld(n, 32, seed=2, device='cpu')
    if mesh is not None:
        mesh = tmesh.make_mesh(mesh[0], n_comp=mesh[1], device='cpu')
        ld = tblocks.shard(ld, mesh.n_snp, mesh.devices, mesh.snp_shards)
    std_errs = rng.uniform(0.01, 0.05, (P, n))
    betas = rng.standard_normal((P, n)) * std_errs * 2
    annotations = np.zeros((n, 2))
    annotations[np.arange(n), rng.integers(0, 2, n)] = 1
    args = dict(
        marginal_effects=betas, std_errs=std_errs, ld_mats=[ld] * P,
        annotations=annotations,
        mixture_covs=[np.eye(P) * s + 0.3 * s
                      for s in (1e-6, 1e-5, 1e-4, 1e-2)],
        checkpoint=False, checkpoint_freq=-1, scaled=False,
        scale_se=form != 'shared', gwas_N=np.full(P, 1e5),
        init_hg=np.full(P, 0.3), num_its=4, device='cpu', mesh=mesh)
    args.update(kw)
    vi = tengine.MultiPopVI(**args)
    assert vi._compact == (form != 'materialized')
    assert vi._epoch == (form in ('epoch', 'grow'))
    return vi


def _start(vi):
    np.random.seed(5)
    return vi._initialize()


def _shards(st):
    return list(st.shards) if isinstance(st, tengine.ShardedState) else [st]


def _dropped(st):
    """The state without its record."""
    ss = [dataclasses.replace(s, last_eval=None) for s in _shards(st)]
    if isinstance(st, tengine.ShardedState):
        return dataclasses.replace(st, shards=tuple(ss))
    return ss[0]


def _steps(vi, st, steps, drop, grow):
    """`steps` outer steps from `st` ((state, posterior means) of each),
    the record dropped before each with `drop`, the epoch history grown
    between steps as optimize() grows it with `grow`."""
    out = []
    for _ in range(steps):
        if drop:
            st = _dropped(st)
        st, pm = tengine.outer_step(vi.data, st)
        if grow:
            st = vi._maybe_grow_hist(st)
        out.append((st, pm if isinstance(pm, tuple) else (pm,)))
    return out


def _assert_same(a, b):
    """Two states bitwise alike, their records aside."""
    for x, y in zip(_shards(a), _shards(b)):
        for f in dataclasses.fields(x):
            if f.name == 'last_eval':
                continue
            u, v = getattr(x, f.name), getattr(y, f.name)
            if torch.is_tensor(u):
                assert torch.equal(u, v), f.name
            elif f.name == 'sigma' and u is not None:
                for g in dataclasses.fields(u):
                    assert torch.equal(getattr(u, g.name),
                                       getattr(v, g.name)), g.name
            elif f.name == 'running_elbo_delta' and np.isnan(u):
                assert np.isnan(v)
            else:
                assert u == v, f.name


@pytest.mark.parametrize('form,mesh', CASES)
def test_steps_with_the_record_are_the_steps_without(form, mesh,
                                                     monkeypatch):
    """20 outer steps with the record and the same steps with it dropped
    before each: the states (ELBO, L, num_err and every tensor) and the
    posterior means bitwise alike. With it, the beta loop of every step
    but the first (and but those after the history grew) reuses an
    evaluation, and every EM its posterior variances; without, the EM
    computes them afresh too. The 'grow' fit grows its history and then
    freezes its EM."""
    grow = form == 'grow'
    frozen = []
    em = tengine._error_scaling
    drop = False

    def spy(ds, ss, *args):
        if drop:
            ss = [dataclasses.replace(s, last_eval=None) for s in ss]
        out = em(ds, ss, *args)
        frozen.append(out[0] is ss)
        return out

    monkeypatch.setattr(tengine, '_error_scaling', spy)
    vi = _vi(form, monkeypatch, mesh)
    runs, reused = [], []
    for drop in (False, True):
        before = tengine.evals_reused
        runs.append(_steps(vi, _start(vi), STEPS, drop, grow))
        reused.append(tengine.evals_reused - before)
    for (a, pa), (b, pb) in zip(*runs):
        _assert_same(a, b)
        assert all(torch.equal(x, y) for x, y in zip(pa, pb))
    # the history grown between two steps (the last step's growth aside)
    sizes = [tengine._EPOCH_BUCKETS[0]] + [
        _shards(a)[0].nat_hist.shape[0] if vi._epoch else 0
        for a, _ in runs[0]]
    grown = sum(b > a for a, b in zip(sizes[:-2], sizes[1:-1]))
    assert bool(frozen) == (form != 'shared')
    assert reused == [STEPS - 1 - grown + len(frozen) // 2, 0]
    if grow:
        assert grown == 1 and sizes[-1] == 8
        assert any(frozen) and not all(frozen)


def test_a_stale_record_evaluates_afresh(monkeypatch):
    """A state whose parameter tensor is replaced, edited in place, or
    whose hyper_delta is replaced, has no usable record: its step
    evaluates its point again, as the same state without a record
    does."""
    vi = _vi('shared', monkeypatch)
    data = vi.data
    for edit in ('replace', 'in_place', 'hyper'):
        st = _steps(vi, _start(vi), 2, False, False)[-1][0]
        assert tengine._recall([data], [st]) is not None
        if edit == 'replace':
            new = dataclasses.replace(st, nat_mu=st.nat_mu.clone())
        elif edit == 'hyper':
            new = dataclasses.replace(st, hyper_delta=st.hyper_delta * 1.0)
        else:
            new = st
            new.nat_mu.mul_(1.001)
        assert tengine._recall([data], [new]) is None, edit
        before = tengine.evals_reused
        a, pa = tengine.outer_step(data, new)
        assert tengine.evals_reused == before, edit
        b, pb = tengine.outer_step(data, _dropped(new))
        _assert_same(a, b)
        assert torch.equal(pa, pb)


def test_each_step_after_the_first_reuses_one_evaluation(monkeypatch):
    """From a state without a record, the first step evaluates its start
    and every later step reuses one evaluation (no EM runs); each step
    synchronizes once per trial and once for its hyper-delta
    evaluation, and the first once more."""
    vi = _vi('shared', monkeypatch)
    st = _start(vi)
    for i in range(6):
        reused, syncs, trials = (tengine.evals_reused, tengine.host_syncs,
                                 tengine.trials)
        st, _ = tengine.outer_step(vi.data, st)
        assert tengine.evals_reused - reused == (i > 0)
        assert tengine.host_syncs - syncs == (tengine.trials - trials + 1
                                              + (i == 0))


class _Started(Exception):
    pass


@pytest.mark.parametrize('form,mesh', [('shared', None), ('epoch', None),
                                       ('materialized', None),
                                       ('kdim', (2, 2))])
def test_a_fit_start_evaluates_once(form, mesh, monkeypatch):
    """optimize()'s start makes one evaluation (one host sync, one
    `_objective_terms` a shard): the ELBO, the posterior mean and the
    first step's record, whose value is the ELBO."""
    calls = []
    terms = tengine._objective_terms
    step = tengine.outer_step

    def counted(*args, **kwargs):
        calls.append(1)
        return terms(*args, **kwargs)

    def first(data, st, line_search_rate=2.0):
        raise _Started(tengine.host_syncs, len(calls), st)

    vi = _vi(form, monkeypatch, mesh)
    monkeypatch.setattr(tengine, '_objective_terms', counted)
    monkeypatch.setattr(tengine, 'outer_step', first)
    syncs = tengine.host_syncs
    with pytest.raises(_Started) as got:
        vi.optimize()
    monkeypatch.setattr(tengine, 'outer_step', step)
    at, n_terms, st = got.value.args
    shards = _shards(st)
    assert at - syncs == 1 and n_terms == len(shards)
    assert all(s.last_eval is not None and s.last_eval.value == st.elbo
               for s in shards)
    reused = tengine.evals_reused
    tengine.outer_step(vi.data, st)
    assert tengine.evals_reused > reused


@pytest.mark.parametrize('form,mesh', [('shared', None), ('epoch', None),
                                       ('materialized', None),
                                       ('kdim', (2, 1))])
def test_no_output_holds_the_record(form, mesh, monkeypatch, tmp_path):
    """The checkpoints and the outputs have the members they had, and
    the fit's final state holds no record."""
    out = str(tmp_path / form)
    vi = _vi(form, monkeypatch, mesh, checkpoint=True, checkpoint_freq=1,
             output=out, num_its=3)
    np.random.seed(5)
    st = vi.optimize()
    assert all(s.last_eval is None for s in _shards(st))
    want = BASE_KEYS | (EPOCH_KEYS if vi._epoch else set())
    ckpts = sorted(glob.glob(out + '-checkpoint.*.npz'))
    assert len(ckpts) == 3
    for path in ckpts:
        assert set(np.load(path).files) == want, path
    assert set(vi.create_dump_dict()) == want
    arrays, streams = vi.dump_spec()
    assert set(arrays) | {s[0] for s in streams} == want
