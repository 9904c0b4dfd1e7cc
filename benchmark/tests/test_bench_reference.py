"""The frozen reference against the port's plain path on the CPU at a
tiny size, and the check's power to fail: its controls and the faults
a fit's timed path can have make `correct` come out false.

At float64 the program (the kernels' plain versions) and the reference
agree to rounding (under 1e-7); at float32 every compared number stays under the
cell's own limits; the controls (the program's bfloat16-U path, the
reference at float8 U in float32 in the program's place) and each fault
read above them, and a number the cell's limits name that a run lacks
fails it."""
import json
import os

import pytest

from conftest import BENCH, run_cpu, tiny_cell


def _limits(workload):
    with open(os.path.join(BENCH, 'limits', workload + '.json')) as fh:
        return json.load(fh)


def _values(res):
    return {k: v['value'] for k, v in res['compared'].items()}


def test_float64_program_matches_the_reference(epoch_state):
    cell = tiny_cell('hm3_1m.learn_scaling',
                     config=dict(state_dtype='float64', u_storage='float64'))
    # float64 rounding, amplified where a component's 2 x 2 precision is
    # near singular (correlation 0.99): 3e-8 in init_nat, 2e-9 elsewhere;
    # the float32 program reads 1e-7 to 5e-6 on the same problem
    cell['limits'] = {k: 1e-7 for k in cell['limits']}
    res = run_cpu(cell, seconds=6.0)
    assert res['correct'], res['compared']
    assert 'scaling' in res['compared'], 'no EM event in the window'


@pytest.mark.parametrize('workload', ['hm3_1m.default', 'hm3_1m.one_cohort',
                                      'ukbb_6m.learn_scaling'])
def test_float32_program_is_correct(workload, epoch_state):
    res = run_cpu(tiny_cell(workload))
    assert res['correct'], res['compared']


@pytest.mark.parametrize('workload', ['hm3_1m.default',
                                      'ukbb_6m.learn_scaling'])
def test_control_is_not_correct(workload, epoch_state):
    res = run_cpu(tiny_cell(workload), control=True)
    assert not res['correct'], res['compared']


def _unchanged_state(inner):
    """A step that returns its state unchanged (with the means it
    returns)."""
    def step(data, st, line_search_rate=2.0):
        _, pm = inner(data, st, line_search_rate=line_search_rate)
        return st, pm
    return step


def _half_the_snps(likelihood_partial):
    """The likelihood's per-SNP sums over half the SNPs, doubled (the
    mean over the rest)."""
    def partial(post_means, post_vars, scaled_mu, sld, linked, adj):
        keep = slice(0, None, 2)
        return 2.0 * likelihood_partial(
            post_means[:, keep], post_vars[:, keep], scaled_mu[:, keep],
            sld[:, keep], linked[:, keep], adj[:, keep])
    return partial


def _half_update(sum_betas):
    """The beta update's step on every other SNP only (the rest keep
    their old natural means)."""
    def step(old, new, s):
        out = sum_betas(old, new, s)
        out[..., 1::2] = old[..., 1::2]
        return out
    return step


def _never_accepted(update_beta):
    """A beta update whose line search always falls back to the old
    parameters."""
    from vilma_tpu_torch.inference import engine

    def update(ds, ss, mesh, orig_obj, pms, lks, rate):
        _, L0, _, _, _, err = update_beta(ds, ss, mesh, orig_obj, pms, lks,
                                          rate)
        return ([engine._params(st) for st in ss], L0, orig_obj, pms, lks,
                err)
    return update


def _altered_mean(prologue):
    """The prologue's posterior mean of one SNP altered where it is
    produced."""
    def altered(*args, **kw):
        pm, pv, kl = prologue(*args, **kw)
        pm = pm.clone()
        pm[0, 7] = pm[0, 7] * 1.01 + 1e-3 * pm.abs().max()
        return pm, pv, kl
    return altered


@pytest.mark.parametrize('fault', ['unchanged_state', 'half_the_snps',
                                   'half_update', 'never_accepted',
                                   'altered_mean'])
@pytest.mark.parametrize('workload', ['hm3_1m.default',
                                      'ukbb_6m.learn_scaling'])
def test_faults_are_not_correct(fault, workload, epoch_state, monkeypatch):
    """A run with the timed path broken underneath: the harness's look
    for a chip is skipped (run.execute on the CPU); the cell's own
    limits. (The exchange between chips has no place: every cell takes
    one chip.)"""
    from vilma_tpu_torch.inference import engine
    from vilma_tpu_torch.ops import kernels
    from vilma_tpu_torch.ops.cuda import compact_obj
    if fault == 'unchanged_state':
        monkeypatch.setattr(engine, 'outer_step',
                            _unchanged_state(engine.outer_step))
    elif fault == 'half_the_snps':
        monkeypatch.setattr(kernels, 'likelihood_partial',
                            _half_the_snps(kernels.likelihood_partial))
    elif fault == 'half_update':
        monkeypatch.setattr(kernels, 'sum_betas',
                            _half_update(kernels.sum_betas))
    elif fault == 'never_accepted':
        monkeypatch.setattr(engine, '_update_beta',
                            _never_accepted(engine._update_beta))
    else:
        name = ('prologue_epochs' if 'learn_scaling' in workload
                else 'prologue')
        monkeypatch.setattr(compact_obj, name,
                            _altered_mean(getattr(compact_obj, name)))
    res = run_cpu(tiny_cell(workload))
    assert not res['correct'], res['compared']
    assert res['compared'].keys() == set(_limits(workload))
    if fault in ('half_update', 'never_accepted'):
        # the numbers read off the program's own states stay in their
        # limits: only the update's check sees these faults
        assert _failed(res) == ['update'], res['compared']


def _failed(res):
    return sorted(k for k, v in res['compared'].items()
                  if v['value'] is None or v['value'] > v['limit'])


def test_a_number_the_run_lacks_fails(epoch_state, monkeypatch):
    """An EM that never runs (its gate never opens) leaves the
    learn_scaling cell without its `scaling` reading: not correct."""
    from vilma_tpu_torch.inference import engine
    monkeypatch.setattr(engine, 'EM_TOL', float('-inf'))
    res = run_cpu(tiny_cell('hm3_1m.learn_scaling'), seconds=6.0)
    assert not res['correct'], res['compared']
    assert res['compared']['scaling']['value'] is None
    assert _failed(res) == ['scaling'], res['compared']
