"""Driven by data: a made-up configuration, traffic mix, limits and
metric dropped into a copy of benchmark/ are found by their names, and a
run of the new cell reports the new metric, with no code edited."""
import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, REPO

from harness import registry


def test_every_registered_cell_and_metric_is_found():
    names = set(registry.metrics('end_to_end'))
    assert names == {'vi_steps_per_s', 'device_peak_gib', 'setup_s'}
    layer = set(registry.metrics('per_layer'))
    assert {'matvec_roofline', 'prologue_roofline', 'sums_roofline',
            'step_mfu', 'device_idle_pct'} <= layer
    for w in ('hm3_1m.default', 'ukbb_6m.learn_scaling',
              'hm3_1m.one_cohort', 'hm3_1m.learn_scaling'):
        cell = registry.cell(w)
        assert cell['config']['name'] == w.split('.')[0]
        assert cell['traffic']['name'] == w.split('.')[1]


def test_a_bad_name_is_refused():
    with pytest.raises(ValueError):
        registry.cell('hm3_1m')


def test_new_files_make_a_new_cell(tmp_path):
    copy = tmp_path / 'benchmark'
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns(
        '__pycache__'))
    shutil.copy(copy / 'configs' / 'hm3_1m.json', copy / 'configs' /
                'toy_panel.json')
    (copy / 'traffic' / 'toy_mix.json').write_text(
        '{"name": "toy_mix", "cohorts": 1, "components": 3, '
        '"learn_scaling": false, "samplesizes": 50000, "init_hg": 0.2, '
        '"num_its": 1000, "fit_seed": 42}')
    (copy / 'limits' / 'toy_panel.toy_mix.json').write_text(
        '{"init_nat": 1e-3, "init_hyper": 1e-3, "elbo": 1e-4, '
        '"post_mean": 1e-3, "hyper": 1e-3}')
    (copy / 'metrics' / 'toy_fits.py').write_text(
        'KIND = "end_to_end"\nUNIT = "fits"\n\n\n'
        'def read(run):\n    return float(run.records[-1]["fit"] + 1)\n')
    code = f"""
import sys
sys.path[:0] = [{str(copy)!r}, {os.path.join(BENCH, 'tests')!r}, {REPO!r}]
import run
from harness import registry
assert registry.ROOT == {str(copy)!r}, registry.ROOT
import conftest
cell = conftest.tiny_cell('toy_panel.toy_mix')
res = run.execute(cell, 77, 0.5, 0, 'cpu')
assert res['correct'], res['compared']
assert res['metrics']['toy_fits']['unit'] == 'fits', res['metrics']
print('ok')
"""
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]


def test_seeds_order_one_problem():
    """The same seed gives the same inputs; another seed the same
    problem with the full blocks in another order."""
    from harness import inputs
    from conftest import tiny_cell
    cell = tiny_cell()
    a = inputs.make(cell['config'], cell['traffic'], 11, 'cpu')
    b = inputs.make(cell['config'], cell['traffic'], 11, 'cpu')
    c = inputs.make(cell['config'], cell['traffic'], 3_000_000_012, 'cpu')
    assert (a.betas == b.betas).all() and (a.panel.assign ==
                                           b.panel.assign).all()
    assert not (a.betas == c.betas).all()
    n = a.panel.block_size
    for x in (a, c):
        # each full block keeps its SNPs' statistics and its bank entry
        blocks = x.betas[:, :x.panel.num_full * n].reshape(2, -1, n)
        key = {tuple(blocks[:, b, 0].tolist()): x.panel.assign[b].item()
               for b in range(x.panel.num_full)}
        if x is a:
            ref = key
    assert key == ref
    assert (a.betas[:, x.panel.num_full * n:]
            == c.betas[:, x.panel.num_full * n:]).all()
