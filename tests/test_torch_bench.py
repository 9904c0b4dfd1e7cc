"""bench_torch.py, bench.py's twin on vilma_tpu_torch, on the CPU: the
same metric names and refusal for the same knobs, the same problem as
bench.py's _build at float64 (every state form, the epoch route with the
size threshold patched small), its host runs (the baseline line, the
card leg and the mesh curve on BENCH_DEVICE=cpu), and no JSON line when
the card is absent or its leg fails."""
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import bench
import bench_torch
from vilma_tpu.inference import engine as jengine
from vilma_tpu.ops import blocks as jblocks
from vilma_tpu_torch.inference import engine as tengine
from vilma_tpu_torch.ops import blocks as tblocks

from tests.torch_parity import t2n

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = 2048            # two 1024-SNP blocks: the subprocess runs
FIELDS = ('marginal_effects', 'std_errs', 'scalings', 'ld_diags',
          'scaled_ld_diags', 'adj_marginal_effects', 'chi_stat', 'ld_ranks',
          'inverse_betas', 'annotations', 'annotation_counts',
          'mixture_prec', 'log_det')
# the problem's derived fields and the states' ELBOs at float64: 1e-12 of
# scale and 1e-11 relative (tests/test_torch_synthetic.py's bands)
RTOL = 1e-12
ELBO_RTOL = 1e-11


def _env(**knobs):
    """The test process's environment without any BENCH_ knob, plus
    `knobs`, one intra-op thread, and the repo importable."""
    env = {k: v for k, v in os.environ.items() if not k.startswith('BENCH_')}
    env.update(knobs, OMP_NUM_THREADS='1', MKL_NUM_THREADS='1',
               PYTHONPATH=REPO + os.pathsep + env.get('PYTHONPATH', ''))
    return env


METRIC_KNOBS = [
    {}, {'BENCH_SIZE': '1m'}, {'BENCH_SIZE': '6m', 'BENCH_POPS': '3'},
    {'BENCH_POPS': '1', 'BENCH_SCALE_SE': '1'},
    {'BENCH_GRID': 'cli', 'BENCH_SCALE_SE': '1'},
    {'BENCH_GRID': 'cli', 'BENCH_GRID_K': '8', 'BENCH_SIZE': '1m'},
    {'BENCH_LOCI': '300000', 'BENCH_GRID': 'cli', 'BENCH_SCALE_SE': '1'},
    {'BENCH_LOCI': '2.5e5', 'BENCH_SIZE': '1m', 'BENCH_EPOCH_B': '4'},
    {'BENCH_SIZE': 'bogus', 'BENCH_LD_DTYPE': 'f32'},
]


@pytest.mark.parametrize('knobs', METRIC_KNOBS,
                         ids=['-'.join(f'{k[6:]}={v}' for k, v in kn.items())
                              or 'default' for kn in METRIC_KNOBS])
def test_metric_matches_bench(knobs):
    """Both scripts, imported in one subprocess under the same knobs,
    name the same metric and size."""
    code = ('import bench, bench_torch, json; print(json.dumps(['
            'bench.METRIC, bench_torch.METRIC, bench.NUM_LOCI, '
            'bench_torch.NUM_LOCI, bench._accel_steps(), '
            'bench_torch._accel_steps()]))')
    out = subprocess.run([sys.executable, '-c', code], env=_env(**knobs),
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    jm, tm, jn, tn, js, ts = json.loads(out.stdout.splitlines()[-1])
    assert tm == jm and tn == jn and ts == js


@pytest.mark.parametrize('pops', ['0', '4'])
def test_population_refusal_matches_bench(pops):
    """BENCH_POPS outside 1-3 is refused at import by both, alike."""
    outs = [subprocess.run([sys.executable, '-c', f'import {mod}'],
                           env=_env(BENCH_POPS=pops), cwd=REPO,
                           capture_output=True, text=True, timeout=120)
            for mod in ('bench', 'bench_torch')]
    assert outs[0].returncode == outs[1].returncode == 1
    assert outs[1].stderr.strip().splitlines()[-1] == \
        outs[0].stderr.strip().splitlines()[-1]
    assert f'BENCH_POPS={pops}' in outs[1].stderr


PROBLEMS = {'shared': ('', False, 2), 'kdim-cli': ('cli', True, 2),
            'one-pop-kdim': ('', True, 1), 'epoch': ('', True, 2)}


@pytest.fixture(scope='module')
def caches(tmp_path_factory):
    """Both scripts' caches, shared by the cases (each package factors
    the 4,096-SNP panel once)."""
    root = tmp_path_factory.mktemp('bench_caches')
    return str(root / 'jax'), str(root / 'torch')


@pytest.mark.parametrize('case', list(PROBLEMS))
def test_problem_matches_bench_build(case, caches, monkeypatch):
    """At 4,096 SNPs bench_torch._build on the CPU at float64 builds
    bench.py's _build problem: every ModelData field within 1e-12 of its
    scale (the draws bit for bit), the packed LD's dense matrix, the
    state's drawn fields bit for bit and its ELBO within 1e-11. 'epoch'
    patches both engines' _EPOCH_STATE_BYTES small, so both scripts take
    the epoch-history state (B = BENCH_EPOCH_B). Nothing is written in
    the repo."""
    grid, scale_se, pops = PROBLEMS[case]
    for mod, cache in ((bench, caches[0]), (bench_torch, caches[1])):
        for name, value in (('NUM_LOCI', 4096), ('CACHE_DIR', cache),
                            ('GRID', grid), ('SCALE_SE', scale_se),
                            ('NUM_POPS', pops), ('EPOCH_B', 4)):
            monkeypatch.setattr(mod, name, value)
    if case == 'epoch':
        monkeypatch.setattr(jengine, '_EPOCH_STATE_BYTES', 1 << 10)
        monkeypatch.setattr(tengine, '_EPOCH_STATE_BYTES', 1 << 10)
    monkeypatch.delenv('BENCH_LD_DTYPE', raising=False)
    before = os.path.exists(os.path.join(REPO, '.bench_cache'))
    jdata, jst = bench._build(np.float64, jax.devices('cpu')[0])
    tdata, tst = bench_torch._build(torch.float64, torch.device('cpu'))
    assert os.path.exists(os.path.join(REPO, '.bench_cache')) == before
    assert os.path.exists(os.path.join(
        caches[1], 'torch_4096_1024_0.5_float64_float64', 'ld.pt'))
    for name in FIELDS:
        want = np.asarray(getattr(jdata, name))
        np.testing.assert_allclose(
            t2n(getattr(tdata, name)), want, rtol=RTOL,
            atol=RTOL * max(np.abs(want).max(), 1e-300), err_msg=name)
    for name in ('marginal_effects', 'std_errs', 'annotations'):
        np.testing.assert_array_equal(t2n(getattr(tdata, name)),
                                      np.asarray(getattr(jdata, name)))
    assert tdata.scale_se == bool(jdata.scale_se) == scale_se
    np.testing.assert_allclose(tblocks.to_dense(tdata.ld[0]),
                               np.asarray(jblocks.to_dense(jdata.ld[0])),
                               rtol=0, atol=1e-12)
    epoch = case == 'epoch'
    assert (tst.nat_hist is not None) == (jst.nat_hist is not None) == epoch
    drawn = ('nat_mu', 'hyper_delta', 'error_scaling') + (
        ('nat_hist', 'nat_hist_scale', 'nat_hist_c') if epoch else ())
    for name in drawn:
        np.testing.assert_array_equal(t2n(getattr(tst, name)),
                                      np.asarray(getattr(jst, name)),
                                      err_msg=name)
    if epoch:
        assert tst.nat_hist.shape[0] == 4 and tst.nat_hist_n == 0
    elif scale_se:
        assert tst.nat_mu.dim() == 3
    assert np.isclose(tst.elbo, float(jst.elbo), rtol=ELBO_RTOL, atol=0)


def test_float32_pack_is_cast_from_the_float64_one(tmp_path, monkeypatch):
    """With a float64 pack cached, the float32 leg's bf16 panel is its
    cast, bit for bit what blocks.pack gives at those types, and is then
    read back from its own cache entry."""
    monkeypatch.setattr(bench_torch, 'NUM_LOCI', 1500)
    monkeypatch.setattr(bench_torch, 'CACHE_DIR', str(tmp_path))
    monkeypatch.delenv('BENCH_LD_DTYPE', raising=False)
    base =bench_torch._cached_ld(torch.float64, torch.device('cpu'))
    monkeypatch.setenv('BENCH_LD_DTYPE', 'bf16')
    got = bench_torch._cached_ld(torch.float32, torch.device('cpu'))
    again = bench_torch._cached_ld(torch.float32, torch.device('cpu'))
    from vilma_tpu_torch.utils import synthetic
    want = synthetic.synthetic_ld(1500, 1024, 0.5, seed=0,
                                  dtype=torch.float32,
                                  u_dtype=torch.bfloat16, device='cpu')
    assert len(got.buckets) == len(want.buckets) == len(base.buckets) == 2
    for g, a, w in zip(got.buckets, again.buckets, want.buckets):
        for f in dataclasses.fields(w):
            x, y, z = (getattr(b, f.name) for b in (g, a, w))
            assert x.dtype == y.dtype == z.dtype, f.name
            assert torch.equal(x, z) and torch.equal(y, z), f.name
    assert (got.n, got.rank, got.missing) == (want.n, want.rank,
                                              want.missing)


def _run_copy(tmp_path, args=(), **knobs):
    """bench_torch.py copied into tmp_path (its cache lands there, not in
    the repo) and run with `knobs`."""
    script = tmp_path / 'bench_torch.py'
    shutil.copy(os.path.join(REPO, 'bench_torch.py'), script)
    return subprocess.run([sys.executable, str(script), *args],
                          env=_env(**knobs), cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=600)


def _json_lines(stdout):
    out = []
    for line in stdout.splitlines():
        if line.startswith('{'):
            out.append(json.loads(line))
    return out


def test_cpu_run_prints_one_well_formed_line(tmp_path):
    """BENCH_DEVICE=cpu runs the baseline leg alone: one JSON line, the
    last, with bench.py's keys and metric, a finite positive value and
    vs_baseline 1.0; the earlier lines say that no card was measured."""
    out = _run_copy(tmp_path, BENCH_DEVICE='cpu', BENCH_LOCI=str(SMALL))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = _json_lines(out.stdout)
    assert len(lines) == 1
    assert out.stdout.strip().splitlines()[-1].startswith('{')
    line = lines[0]
    assert list(line) == ['metric', 'value', 'unit', 'vs_baseline']
    assert line['metric'] == f'vi_iterations_per_s_{SMALL}loci_snp_2pop_K18'
    assert math.isfinite(line['value']) and line['value'] > 0
    assert line['unit'] == 'iters/s' and line['vs_baseline'] == 1.0
    assert 'no card was measured' in out.stdout
    assert os.path.exists(tmp_path / '.bench_cache' /
                          f'torch_{SMALL}_1024_0.5_float64_float64' / 'ld.pt')


def test_card_leg_on_the_host_counts_no_launch(tmp_path):
    """--accel with BENCH_DEVICE=cpu runs the card leg's code on the host
    (float32, bf16 U, the plain versions): ACCEL_IPS and its launches
    line, every kernel launched 0 times, host syncs counted."""
    out = _run_copy(tmp_path, ['--accel'], BENCH_DEVICE='cpu',
                    BENCH_LOCI=str(SMALL), BENCH_ACCEL_STEPS='2',
                    BENCH_SCALE_SE='1')
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    ips = [float(ln.split()[1]) for ln in lines
           if ln.startswith('ACCEL_IPS')]
    assert len(ips) == 1 and ips[0] > 0
    info = json.loads(next(ln for ln in lines
                           if ln.startswith('ACCEL_LAUNCHES'))
                      .split(' ', 1)[1])
    assert info['metric'] == (f'vi_iterations_per_s_{SMALL}loci_snp_2pop'
                              '_K18_scale_se')
    assert info['device'] == 'cpu' and info['host_syncs_per_step'] >= 2
    assert info['setup_s'] > 0
    assert info['setup_peak_gib'] is info['steps_peak_gib'] is None
    assert info['launches']['prologue_kdim'] == 0
    assert set(info['launches']) >= {'bucket_matvec_multi', 'prologue',
                                      'delta_sums', 'prologue_epochs'}
    assert os.path.exists(tmp_path / '.bench_cache' /
                          f'torch_{SMALL}_1024_0.5_float32_bfloat16')


def test_mesh_curve_on_the_host(tmp_path):
    """--mesh on the host: each point a subprocess on the shard-local
    layout (2 shards of one 1024-SNP block each), one JSON line of
    bench.py's form."""
    out = _run_copy(tmp_path, ['--mesh'], BENCH_DEVICE='cpu',
                    BENCH_LOCI=str(SMALL), BENCH_MESH_POINTS='1,2',
                    BENCH_MESH_STEPS='1')
    assert out.returncode == 0, out.stderr[-3000:]
    (line,) = _json_lines(out.stdout)
    assert line['metric'] == f'mesh_scaling_iters_per_s_{SMALL}loci_snp'
    assert sorted(line['curve']) == ['1', '2']
    assert all(v > 0 for v in line['curve'].values())
    assert line['value'] == line['curve']['2']
    assert line['relative']['1'] == 1.0
    assert out.stdout.count('MESH_LAUNCHES') == 2


@pytest.mark.parametrize('args', [[], ['--accel'], ['--mesh']])
def test_no_card_no_line(tmp_path, args):
    """Without a CUDA device and without BENCH_DEVICE=cpu every mode
    exits nonzero at once and prints no JSON line."""
    assert not torch.cuda.is_available()
    out = _run_copy(tmp_path, args, BENCH_LOCI=str(SMALL))
    assert out.returncode != 0
    assert _json_lines(out.stdout) == []
    assert 'no CUDA device' in out.stderr
    assert not os.path.exists(tmp_path / '.bench_cache')


@pytest.mark.parametrize('failure', ['exit', 'timeout'])
def test_failed_card_leg_exits_nonzero(failure, monkeypatch, capsys):
    """A card leg that fails or times out in its subprocess makes main()
    exit nonzero with no JSON line (no fallback to the baseline's
    value)."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setenv('BENCH_CPU_IPS', '3.5')
    monkeypatch.delenv('BENCH_DEVICE', raising=False)

    def run(cmd, **kw):
        assert cmd[-1] == '--accel'
        if failure == 'timeout':
            raise subprocess.TimeoutExpired(cmd, kw['timeout'])
        return subprocess.CompletedProcess(cmd, 1, 'ACCEL_IPS 9.0\n',
                                           'Traceback: boom')
    monkeypatch.setattr(bench_torch.subprocess, 'run', run)
    with pytest.raises(SystemExit) as exc:
        bench_torch.main()
    assert exc.value.code == 1
    out = capsys.readouterr()
    assert _json_lines(out.out) == []
    assert ('TIMED OUT' if failure == 'timeout' else 'FAILED') in out.err
