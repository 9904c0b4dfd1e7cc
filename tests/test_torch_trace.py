"""The port's span recorder (vilma_tpu_torch/utils/trace.py) and the
spans and counters of its fit, on small CPU fits: off it costs no clock
and no torch call and changes no bit; on, the spans nest as the phases
do, agree with the host_syncs and trials counters, close when an
exception passes, and appear in a torch.profiler trace as nested
user_annotation events."""
import json
import types

import numpy as np
import pytest
import torch

from vilma_tpu_torch.inference import engine as tengine
from vilma_tpu_torch.utils import synthetic
from vilma_tpu_torch.utils import trace

NUM_LOCI = 128
FORMS = ('shared', 'kdim', 'epoch')

# each span's parent (a set where the span nests in any of several)
PARENT = {
    'vilma.pack': None, 'vilma.pack.copy': 'vilma.pack',
    'vilma.build': None, 'vilma.precompute': 'vilma.build',
    'vilma.ridge': 'vilma.build',
    'vilma.fit': None, 'vilma.init': 'vilma.fit', 'vilma.step': 'vilma.fit',
    'vilma.converge': 'vilma.fit', 'vilma.beta_loop': 'vilma.step',
    'vilma.trial': 'vilma.beta_loop', 'vilma.hyper_delta': 'vilma.step',
    'vilma.em': 'vilma.step', 'vilma.grow_hist': 'vilma.converge',
    'vilma.evaluate': {'vilma.init', 'vilma.beta_loop', 'vilma.trial',
                       'vilma.hyper_delta', 'vilma.em'},
    'vilma.fetch': {'vilma.evaluate', 'vilma.em', 'vilma.converge'},
}


@pytest.fixture(autouse=True)
def recorder():
    """Every test starts and ends with the recorder off and empty."""
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace._open.clear()
    trace.clear()


def _vi(form, monkeypatch, num_its=4, seed=0):
    """A 2-cohort fit of 128 SNPs in blocks of 32 on the CPU at f64: the
    shared [P, I] state, or with --learn-scaling the kdim or (size rule
    at 0) the epoch-history state, every EM re-basing kept."""
    if form == 'epoch':
        monkeypatch.setattr(tengine, '_EPOCH_STATE_BYTES', 0)
        monkeypatch.setattr(tengine, '_EPOCH_SKIP_TOL', 0.0)
    rng = np.random.default_rng(seed)
    P = 2
    ld = synthetic.synthetic_ld(NUM_LOCI, 32, seed=seed, device='cpu')
    std_errs = rng.uniform(0.01, 0.05, (P, NUM_LOCI))
    betas = rng.standard_normal((P, NUM_LOCI)) * std_errs * 2
    annotations = np.zeros((NUM_LOCI, 2))
    annotations[np.arange(NUM_LOCI), rng.integers(0, 2, NUM_LOCI)] = 1
    vi = tengine.MultiPopVI(
        marginal_effects=betas, std_errs=std_errs, ld_mats=[ld] * P,
        annotations=annotations,
        mixture_covs=[np.eye(P) * s + 0.3 * s for s in (1e-6, 1e-4, 1e-2)],
        checkpoint=False, checkpoint_freq=-1, scaled=False,
        scale_se=form != 'shared', gwas_N=np.full(P, 1e5),
        init_hg=np.full(P, 0.3), num_its=num_its, device='cpu')
    assert vi._epoch == (form == 'epoch')
    return vi


def _fit(vi, seed=5):
    np.random.seed(seed)
    return vi.optimize()


def _named(recs):
    """[(name, parent name, start, end)] of records()."""
    return [(n, None if p is None else recs[p][0], t0, t1)
            for n, p, t0, t1 in recs]


def _children(recs, i):
    return [r[0] for r in recs if r[1] == i]


def test_off_span_is_the_shared_noop_and_records_nothing():
    assert trace.span('vilma.x') is trace.NOOP
    with trace.span('vilma.x'):
        pass
    assert trace.records() == []
    trace.enable()
    assert trace.span('vilma.x') is not trace.NOOP
    trace.disable()
    assert trace.span('vilma.x') is trace.NOOP


@pytest.mark.parametrize('form', FORMS)
def test_off_reads_no_clock_and_the_states_match_on(form, monkeypatch):
    """With the recorder off a fit's spans touch neither the clock nor
    torch (both replaced by objects that have neither), and the fit's
    states are bitwise those of the same fit recorded."""
    vi = _vi(form, monkeypatch)

    def boom():
        raise AssertionError('an off span read the clock')

    with monkeypatch.context() as m:
        m.setattr(trace, 'time', types.SimpleNamespace(perf_counter_ns=boom))
        m.setattr(trace, 'torch', types.SimpleNamespace())
        off = _fit(vi)
    assert trace.records() == []
    trace.enable()
    on = _fit(vi)
    trace.disable()
    assert any(r[0] == 'vilma.step' for r in trace.records())
    for name in ('nat_mu', 'hyper_delta', 'error_scaling', 'nat_hist',
                 'vi_mu', 'vi_delta'):
        a, b = getattr(off, name), getattr(on, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), name
    assert off.elbo == on.elbo and off.L == on.L


@pytest.mark.parametrize('form', FORMS)
def test_span_tree_and_counters(form, monkeypatch):
    """The spans of a fit's set-up and of 12 steps nest as the table of
    phases says; each evaluation fetches once, each trial evaluates once;
    the vilma.fetch spans are the host_syncs, the vilma.trial spans the
    trials, and no more line searches accept than ran. A beta loop opens
    with an evaluation only after the epoch history grew (elsewhere the
    state's record of its point stands in for it), and evals_reused
    counts the others and each EM's posterior variances. A
    --learn-scaling fit runs its EM, and the epoch state grows its
    history."""
    searches = []
    update_beta = tengine._update_beta

    def counted(*args, **kwargs):
        searches.append(1)
        return update_beta(*args, **kwargs)

    monkeypatch.setattr(tengine, '_update_beta', counted)
    trace.enable()
    vi = _vi(form, monkeypatch, num_its=12)
    syncs, trials, accepted, reused = (tengine.host_syncs, tengine.trials,
                                       tengine.accepted,
                                       tengine.evals_reused)
    _fit(vi)
    trace.disable()
    recs = trace.records()
    named = _named(recs)
    for i, (name, parent, t0, t1) in enumerate(named):
        assert name in PARENT, name
        want = PARENT[name]
        assert parent in want if isinstance(want, set) else parent == want, \
            (name, parent)
        assert t1 is not None and t0 <= t1, name
        if recs[i][1] is not None:
            p0, p1 = recs[recs[i][1]][2:]
            assert p0 <= t0 and t1 <= p1, name
    names = [r[0] for r in recs]
    roots = [n for n, p, _, _ in named if p is None]
    assert roots == ['vilma.pack', 'vilma.build', 'vilma.fit']
    assert _children(recs, names.index('vilma.pack')) == [
        'vilma.pack.copy'] * len(vi.data.ld[0].buckets)
    assert _children(recs, names.index('vilma.build')) == [
        'vilma.precompute', 'vilma.ridge']
    fit = _children(recs, names.index('vilma.fit'))
    assert fit == ['vilma.init'] + ['vilma.step', 'vilma.converge'] * 12
    for i, name in enumerate(names):
        kids = _children(recs, i)
        if name == 'vilma.step':
            assert kids[:2] == ['vilma.beta_loop', 'vilma.hyper_delta']
            assert set(kids[2:]) <= {'vilma.em'}
        elif name == 'vilma.evaluate':
            assert kids == ['vilma.fetch']
        elif name == 'vilma.trial':
            assert kids == ['vilma.evaluate']
        elif name == 'vilma.beta_loop':
            opens = kids[0] == 'vilma.evaluate'
            assert len(kids) > opens and set(kids[opens:]) == {'vilma.trial'}
        elif name == 'vilma.converge':
            assert kids[-1] == 'vilma.fetch'
            assert set(kids[:-1]) <= {'vilma.grow_hist'}
    fit_ids = [i for i, r in enumerate(recs)
               if r[1] == names.index('vilma.fit')]
    grown = sum('vilma.grow_hist' in _children(recs, i)
                for i in fit_ids[:-1])
    loops = [i for i, name in enumerate(names) if name == 'vilma.beta_loop']
    fresh = sum(_children(recs, i)[0] == 'vilma.evaluate' for i in loops)
    assert fresh == grown
    assert tengine.evals_reused - reused == (len(loops) - fresh
                                             + names.count('vilma.em'))
    assert names.count('vilma.fetch') == tengine.host_syncs - syncs > 0
    assert names.count('vilma.trial') == tengine.trials - trials > 0
    assert 0 < tengine.accepted - accepted <= len(searches)
    assert len(searches) <= names.count('vilma.trial')
    assert ('vilma.em' in names) == (form != 'shared')
    assert ('vilma.grow_hist' in names) == (form == 'epoch')


class _Stop(Exception):
    pass


def test_an_exception_closes_every_span(monkeypatch):
    """optimize() ended by an exception from a wrapped outer_step (as the
    benchmark ends its window) leaves no span open; the next fit records
    a whole tree."""
    vi = _vi('shared', monkeypatch, num_its=6)
    inner = tengine.outer_step
    calls = []

    def stop_at_3(data, st, line_search_rate=2.0):
        with trace.span('vilma.wrapped'):
            out = inner(data, st, line_search_rate=line_search_rate)
        calls.append(1)
        if len(calls) == 3:
            raise _Stop()
        return out

    monkeypatch.setattr(tengine, 'outer_step', stop_at_3)
    trace.enable()
    with pytest.raises(_Stop):
        _fit(vi)
    recs = trace.records()
    assert trace._open == []
    assert all(r[3] is not None for r in recs)
    assert [r[0] for r in recs].count('vilma.step') == 3
    trace.clear()
    monkeypatch.setattr(tengine, 'outer_step', inner)
    _fit(vi)
    trace.disable()
    recs = trace.records()
    assert recs[0][0] == 'vilma.fit' and recs[0][1] is None
    assert _children(recs, 0) == (['vilma.init']
                                  + ['vilma.step', 'vilma.converge'] * 6)
    assert all(r[3] is not None for r in recs)


def test_clear_refuses_while_a_span_is_open():
    trace.enable()
    with trace.span('vilma.x'):
        with pytest.raises(RuntimeError):
            trace.clear()
    trace.clear()
    assert trace.records() == []


def test_profiler_trace_holds_the_spans_nested(tmp_path, monkeypatch):
    """Under a CPU torch.profiler the recorded spans are user_annotation
    events of the chrome trace, one a span, each inside its parent's."""
    from torch.profiler import ProfilerActivity, profile
    vi = _vi('kdim', monkeypatch, num_its=2)
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _fit(vi)
    trace.disable()
    path = tmp_path / 'trace.json'
    prof.export_chrome_trace(str(path))
    evts = sorted((e for e in json.loads(path.read_text())['traceEvents']
                   if e.get('cat') == 'user_annotation'
                   and e.get('name', '').startswith('vilma.')),
                  key=lambda e: (e['ts'], -e['dur']))
    recs = trace.records()
    assert [e['name'] for e in evts] == [r[0] for r in recs]
    assert {'vilma.trial', 'vilma.fetch'} <= {r[0] for r in recs}
    for e, r in zip(evts, recs):
        if r[1] is not None:
            p = evts[r[1]]
            assert p['ts'] <= e['ts'] + 1e-3, r[0]
            assert e['ts'] + e['dur'] <= p['ts'] + p['dur'] + 1e-3, r[0]


def test_fit_profile_writes_the_phases(tmp_path):
    """`fit --profile DIR` turns the spans on for the profiled fit alone,
    its LD pack and set-up included: DIR/fit_trace.json holds the phases
    as annotations, DIR/fit_spans.json the same spans as recorded and the
    fit's syncs, trials, accepted line searches (one vilma.fetch span
    a sync, one vilma.trial span a trial) and reused evaluations (one a
    step, the first step's from the fit's start; the CLI's fit runs no
    EM) and the bytes of U its LD holds and their pad, and the
    recorder is off and empty afterwards."""
    from vilma_tpu_torch import frontend
    from tests.test_torch_cli import _argv, _write_case
    case = _write_case(str(tmp_path))
    prof = tmp_path / 'prof'
    syncs, trials, reused = (tengine.host_syncs, tengine.trials,
                             tengine.evals_reused)
    frontend.main(_argv(case, str(tmp_path / 'run'))
                  + ['--device', 'cpu', '--profile', str(prof)])
    evts = json.loads((prof / 'fit_trace.json').read_text())['traceEvents']
    names = [e['name'] for e in evts if e.get('cat') == 'user_annotation'
             and e['name'].startswith('vilma.')]
    assert {'vilma.pack', 'vilma.pack.copy', 'vilma.build',
            'vilma.precompute', 'vilma.ridge', 'vilma.fit', 'vilma.init',
            'vilma.step', 'vilma.beta_loop', 'vilma.trial',
            'vilma.hyper_delta', 'vilma.evaluate', 'vilma.fetch',
            'vilma.converge'} <= set(names)
    assert names.count('vilma.fit') == 1 and names.count('vilma.step') == 5
    spans = json.loads((prof / 'fit_spans.json').read_text())
    assert spans['fields'] == ['name', 'parent', 'start_ns', 'end_ns']
    recorded = [r[0] for r in spans['spans']]
    assert sorted(recorded) == sorted(names)
    assert all(r[2] <= r[3] for r in spans['spans'])
    counters = spans['counters']
    assert counters['host_syncs'] == recorded.count('vilma.fetch') \
        == tengine.host_syncs - syncs > 0
    assert counters['trials'] == recorded.count('vilma.trial') \
        == tengine.trials - trials > 0
    assert 0 < counters['accepted'] <= counters['trials']
    assert counters['evals_reused'] == tengine.evals_reused - reused \
        == names.count('vilma.step')
    assert 0 <= counters['u_pad_bytes'] < counters['u_bytes']
    assert trace.span('vilma.x') is trace.NOOP
    assert trace.records() == []
