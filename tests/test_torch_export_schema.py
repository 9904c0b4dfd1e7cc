"""tools/export_synthetic_schema_torch.py against the JAX tool, the port's
fit CLI against vilma_tpu's on what it writes, and chip_smoke.py's phase
21 on the host.

- At 8,192 SNPs (8 blocks) the twin writes the JAX tool's files byte for
  byte, from bench.py's factor archive (written here from
  vilma_tpu.utils.synthetic's factors as bench.py writes it) and, without
  the archive, from its own host factoring (--device cpu).
- `vilma-tpu-torch fit --device cpu --precision f64` equals `vilma-tpu fit
  --precision f64` on that schema, 3 steps, at -K 2 and at -K 12
  --learn-scaling on the epoch-history state (its size threshold forced
  to 0 on both sides), within tests/test_torch_cli.py's tolerances.
- chip_smoke.py's phase 21 (the export, check_ld_schema's read back,
  the fit through tools/e2e_fit_torch.py) runs its host logic at 8,192
  SNPs.
"""
import os
import runpy
import shutil
import sys

import numpy as np
import pytest

from vilma_tpu import frontend as jfrontend
from vilma_tpu.inference import engine as jengine
from vilma_tpu_torch import frontend as tfrontend
from vilma_tpu_torch.inference import engine as tengine

import tests.torch_parity  # noqa: F401  (one torch thread per worker)
from tests.test_torch_cli_scale_se import EPOCH_KEYS, _assert_estimates_match

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_LOCI = 8192


def _write_archive(root):
    """bench.py's factor archive (bench.py:224-235) of the 8,192-SNP
    problem, from vilma_tpu.utils.synthetic's factors (its pack call
    captured before it packs)."""
    from vilma_tpu.utils import synthetic as jsynthetic
    captured = {}

    def capture(factors, indices, n, dtype=None):
        captured.update(factors=factors, indices=indices)

    real = jsynthetic.blocks.pack
    jsynthetic.blocks.pack = capture
    try:
        jsynthetic.synthetic_ld(NUM_LOCI, 1024, rank_frac=0.5, seed=0)
    finally:
        jsynthetic.blocks.pack = real
    payload = {'num_blocks': len(captured['factors'])}
    for i, (f, ix) in enumerate(zip(captured['factors'],
                                    captured['indices'])):
        payload.update({f'u{i}': np.ascontiguousarray(f.u), f's{i}': f.s,
                        f'd{i}': f.d, f'r{i}': f.rank, f'ix{i}': ix})
    cache = root / '.bench_cache'
    cache.mkdir()
    np.savez(cache / f'ld_{NUM_LOCI}_1024_0.5.npz', **payload)


def _run_tool(path, argv):
    saved = sys.argv
    sys.argv = [str(path)] + [str(a) for a in argv]
    try:
        runpy.run_path(str(path), run_name='__main__')
    finally:
        sys.argv = saved


def _files(d):
    return {name: (d / name).read_bytes() for name in sorted(os.listdir(d))}


@pytest.fixture(scope='module')
def exports(tmp_path_factory):
    """The JAX tool's export and the twin's, both from the archive, and
    the twin's host-factored export without one."""
    root = tmp_path_factory.mktemp('export')
    (root / 'tools').mkdir()
    for name in ('export_synthetic_schema.py',
                 'export_synthetic_schema_torch.py'):
        shutil.copy(os.path.join(REPO, 'tools', name), root / 'tools')
    _write_archive(root)
    out = {}
    _run_tool(root / 'tools' / 'export_synthetic_schema.py',
              [root / 'jax', NUM_LOCI])
    _run_tool(root / 'tools' / 'export_synthetic_schema_torch.py',
              [root / 'torch', NUM_LOCI])
    shutil.rmtree(root / '.bench_cache')
    _run_tool(root / 'tools' / 'export_synthetic_schema_torch.py',
              [root / 'host', NUM_LOCI, '--device', 'cpu'])
    for tag in ('jax', 'torch', 'host'):
        out[tag] = root / tag
    return out


@pytest.mark.parametrize('tag', ['torch', 'host'])
def test_twin_writes_the_jax_tools_files(exports, tag):
    """The twin's files equal the JAX tool's byte for byte: from the
    archive, and factored on the host without it."""
    want = _files(exports['jax'])
    got = _files(exports[tag])
    assert sorted(got) == sorted(want)
    assert len([n for n in want if n.endswith('.npy')]) == NUM_LOCI // 1024
    for name in want:
        assert got[name] == want[name], name


def _argv(d, prefix, flags):
    return ['fit', '--ld-schema', f'{d}/schema.schema,{d}/schema.schema',
            '--sumstats', f'{d}/pop1.sumstats.tsv,{d}/pop2.sumstats.tsv',
            '--extract', f'{d}/extract.tsv', '--names', 'pop1,pop2',
            '--samplesizes', '1e5,1e5', '--init-hg', '0.3,0.3',
            '--seed', '42', '--num-its', '3', '--precision', 'f64',
            '--output', str(prefix)] + flags


@pytest.mark.parametrize('flags', [['-K', '2'],
                                   ['-K', '12', '--learn-scaling']],
                         ids=['K2', 'K12-learn-scaling-epoch'])
def test_cli_matches_jax_on_the_export(exports, flags, tmp_path,
                                       monkeypatch):
    """The port's fit equals vilma_tpu's on the exported schema at f64:
    the estimates and every .npz member (the epoch state's own members
    with --learn-scaling)."""
    epoch = '--learn-scaling' in flags
    if epoch:
        for mod in (jengine, tengine):
            monkeypatch.setattr(mod, '_EPOCH_STATE_BYTES', 0)
    d = exports['torch']
    outs = {}
    for pkg, main, extra in (('jax', jfrontend.main, []),
                             ('torch', tfrontend.main, ['--device', 'cpu'])):
        outs[pkg] = tmp_path / pkg
        main(_argv(d, outs[pkg], flags) + extra)
    _assert_estimates_match(str(outs['jax']), str(outs['torch']))
    j = np.load(str(outs['jax']) + '.npz')
    t = np.load(str(outs['torch']) + '.npz')
    assert sorted(t.files) == sorted(j.files)
    for key in j.files:
        assert t[key].shape == j[key].shape, key
        assert t[key].dtype == j[key].dtype, key
        np.testing.assert_allclose(t[key], j[key], rtol=1e-8,
                                   atol=1e-8 * np.abs(j[key]).max(),
                                   err_msg=key)
    assert all(k in t.files for k in EPOCH_KEYS) == epoch
    assert t['vi_mu'].shape == ((582 if epoch else 42), 2, NUM_LOCI)


def test_chip_smoke_phase21_on_the_host(monkeypatch):
    """chip_smoke.py's phase 21 runs its host logic end to end on the CPU
    at 8,192 SNPs and 2 steps: the export, check_ld_schema's read back
    within the f32 rounding bound, the fit through tools/e2e_fit_torch.py
    and the output checks. (Its launch requirement needs the card: the
    host runs the kernels' plain versions, which count no launch.)"""
    sys.path.insert(0, REPO)
    import chip_smoke
    monkeypatch.setattr(chip_smoke, 'E2E_LOCI', NUM_LOCI)
    monkeypatch.setattr(chip_smoke, 'E2E_ITS', '2')
    monkeypatch.setattr(chip_smoke, 'require_launched', lambda *a: None)
    out = chip_smoke.run_phase21('cpu', 'host')
    assert out['export_err'] <= 1.0
    line = out['line']
    assert line['state'] == 'kdim' and line['iterations'] == 2
    assert line['seconds']['ld_eigh'] == 0.0      # the trace's factors
    assert set(line['written']['npz']) >= {'vi_mu', 'vi_delta', 'vi_sigma'}
