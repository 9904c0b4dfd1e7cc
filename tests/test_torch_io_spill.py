"""Bounded-memory LD loading of vilma_tpu_torch against vilma_tpu, on the
CPU at float64: the disk spill (`--mmap`, blocks.FactorSpill) and the
per-block factor cache (`--factor-cache`, load.load_entry_factor).

Tolerances: the spilled and unspilled loads are tensor for tensor equal
(the same bits); products through them agree with the JAX package's to
1e-12 of their scale; a cache entry either package wrote gives the other
the same factors bit for bit (both eigendecompose with numpy's LAPACK);
fits and sim through the spill and the cache equal the JAX package's at
the tolerances of tests/test_torch_cli.py and test_torch_commands.py.
"""
import logging
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from vilma_tpu import frontend as jfrontend
from vilma_tpu.io import load as jload
from vilma_tpu.ops import blocks as jblocks
from vilma_tpu_torch import frontend as tfrontend
from vilma_tpu_torch.io import load as tload
from vilma_tpu_torch.ops import blocks as tblocks

from tests.test_torch_cli import _argv, _read_tsv, _write_case
from tests.test_torch_commands import _sim_inputs
from tests.torch_parity import t2n

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FIELDS = ('u', 's', 'inv_s', 'd', 'perm', 'seq')


def _dense_schema(root, num_blocks, block):
    """`num_blocks` dense AR(1) blocks of `block` SNPs (.npy + .var), a
    .schema manifest and its extract list (the JAX package's spill-test
    schema, tests/test_mmap_spill.py)."""
    rows, ids = [], []
    lag = np.abs(np.subtract.outer(np.arange(block), np.arange(block)))
    for b in range(num_blocks):
        base = os.path.join(root, f'blk{b}')
        np.save(base + '.npy', (0.5 + 0.4 * b / num_blocks) ** lag)
        with open(base + '.var', 'w') as fh:
            for i in range(block):
                ids.append(f'snp{b}_{i}')
                fh.write(f'{ids[-1]}\t1\t{b * block + i + 1}\t0\tA\tT\n')
        rows.append(f'blk{b}.var\tblk{b}.npy')
    schema = os.path.join(root, 'spill.schema')
    with open(schema, 'w') as fh:
        fh.write('\n'.join(rows) + '\n')
    with open(schema + '.extract', 'w') as fh:
        fh.write('ID\tA1\tA2\n')
        fh.write(''.join(f'{name}\tA\tT\n' for name in ids))
    return schema


def _both_variants(extract):
    return (pd.read_csv(extract, sep='\t'), tload.load_variant_list(extract))


def _assert_same_ld(a, b):
    assert (a.n, a.has_diag, a.rank, a.missing) == (
        b.n, b.has_diag, b.rank, b.missing)
    assert len(a.buckets) == len(b.buckets)
    for x, y in zip(a.buckets, b.buckets):
        for f in FIELDS:
            tx, ty = getattr(x, f), getattr(y, f)
            assert tx.dtype == ty.dtype and torch.equal(tx, ty), f


def _cache_counts(reset=True):
    counts = (tload.factor_cache_hits, tload.factor_cache_misses)
    if reset:
        tload.factor_cache_hits = tload.factor_cache_misses = 0
    return counts


@pytest.mark.parametrize('dtype,u_dtype', [
    (torch.float64, None), (torch.float32, torch.bfloat16),
    (torch.float64, torch.float32)], ids=['f64', 'f32-bf16', 'f64-f32'])
def test_spill_matches_unspilled(dtype, u_dtype, tmp_path):
    """The spilled load is the unspilled one, tensor for tensor, whatever
    U's storage type, and takes the JAX package's two RNG draws per
    block; at f64 its products equal JAX's."""
    schema = _dense_schema(str(tmp_path), num_blocks=3, block=64)
    jvars, tvars = _both_variants(schema + '.extract')
    kw = dict(denylist=[], ldthresh=1.0, dtype=dtype, u_dtype=u_dtype)
    plain, miss1 = tload.load_ld_from_schema(schema, tvars, **kw)
    np.random.seed(0)
    spilled, miss2 = tload.load_ld_from_schema(
        schema, tvars, mmap=True, spill_dir=str(tmp_path), **kw)
    port_draw = np.random.random()
    assert miss1 == miss2 == []
    _assert_same_ld(plain, spilled)
    np.random.seed(0)
    jspilled, _ = jload.load_ld_from_schema(schema, jvars, denylist=[],
                                            ldthresh=1.0, mmap=True)
    assert np.random.random() == port_draw
    if dtype == torch.float64 and u_dtype is None:
        x = np.random.default_rng(1).standard_normal(plain.n)
        want = np.asarray(jblocks.dot(jspilled, x))
        got = t2n(tblocks.dot(spilled, torch.as_tensor(x)))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize('blocks,block_bytes,want', [
    (5, 8192, [(0, 2), (2, 4), (4, 5)]), (1, 8192, [(0, 1)]),
    (3, 1 << 30, [(0, 1), (1, 2), (2, 3)]), (4, 1, [(0, 4)])])
def test_staging_slices(blocks, block_bytes, want, monkeypatch):
    """A spilled bucket reaches the card in slices of whole blocks of at
    most STAGING_BYTES, one block at the least (the card test
    test_spilled_load_on_the_card_equals_the_unspilled_one moves them)."""
    monkeypatch.setattr(tblocks, 'STAGING_BYTES', 2 * 8192)
    assert [(sl.start, sl.stop) for sl in tblocks._staging_slices(
        blocks, block_bytes)] == want


def test_factor_cache_shared_between_packages(tmp_path, monkeypatch):
    """A cache written by vilma_tpu serves the port with hits only and the
    same factors, and the reverse: the port's entries leave vilma_tpu no
    block to factor."""
    case = _write_case(str(tmp_path))
    schema, extract = case[0], case[2]
    jvars, tvars = _both_variants(extract)
    j_dir, t_dir = str(tmp_path / 'jcache'), str(tmp_path / 'tcache')
    # the allele flips and mismatches enter the key
    entries = list(tload.matched_schema_entries(schema, tvars, [3]))
    assert any((e['signs'] < 0).any() for e in entries)

    fresh, _ = tload.load_ld_from_schema(schema, tvars, [3], 1.0)
    jload.load_ld_from_schema(schema, jvars, [3], 1.0, cache_dir=j_dir)
    _cache_counts()
    served, _ = tload.load_ld_from_schema(schema, tvars, [3], 1.0,
                                          cache_dir=j_dir)
    assert _cache_counts() == (len(entries), 0)
    _assert_same_ld(fresh, served)

    tload.load_ld_from_schema(schema, tvars, [3], 1.0, cache_dir=t_dir)
    assert _cache_counts() == (0, len(entries))
    assert sorted(os.listdir(t_dir)) == sorted(os.listdir(j_dir))
    calls = []
    real = jload.lowrank.factor_block
    monkeypatch.setattr(jload.lowrank, 'factor_block',
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jserved, _ = jload.load_ld_from_schema(schema, jvars, [3], 1.0,
                                           cache_dir=t_dir)
    jplain, _ = jload.load_ld_from_schema(schema, jvars, [3], 1.0)
    assert len(calls) == len(entries)        # the uncached load only
    x = np.random.default_rng(2).standard_normal(jplain.n)
    assert np.array_equal(np.asarray(jblocks.dot(jserved, x)),
                          np.asarray(jblocks.dot(jplain, x)))


def test_factor_cache_misses_only_changed_blocks(tmp_path):
    """Touching one block's .npy misses that block alone; another
    threshold misses every block; a denylist that changes one block's
    match misses that block alone."""
    case = _write_case(str(tmp_path))
    schema, extract = case[0], case[2]
    _, tvars = _both_variants(extract)
    cache = str(tmp_path / 'cache')
    n_blocks = len(list(tload.matched_schema_entries(schema, tvars, [])))
    assert n_blocks == 3
    _cache_counts()
    cold, _ = tload.load_ld_from_schema(schema, tvars, [], 1.0,
                                        cache_dir=cache)
    assert _cache_counts() == (0, 3)
    warm, _ = tload.load_ld_from_schema(schema, tvars, [], 1.0,
                                        cache_dir=cache)
    assert _cache_counts() == (3, 0)
    _assert_same_ld(cold, warm)

    npy = os.path.join(str(tmp_path), 'block1.npy')
    st = os.stat(npy)
    os.utime(npy, ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
    tload.load_ld_from_schema(schema, tvars, [], 1.0, cache_dir=cache)
    assert _cache_counts() == (2, 1)
    tload.load_ld_from_schema(schema, tvars, [], 0.5, cache_dir=cache)
    assert _cache_counts() == (0, 3)
    # variant 100 lies in the last block (rows 96-127)
    tload.load_ld_from_schema(schema, tvars, [100], 1.0, cache_dir=cache)
    assert _cache_counts() == (2, 1)


@pytest.mark.parametrize('damage', ['truncated', 'not an npz',
                                    'member missing'])
def test_unreadable_cache_entry_warns_and_refactorizes(damage, tmp_path,
                                                       caplog):
    """A torn, foreign or incomplete entry is ignored with a warning, its
    block factored again and the entry published anew."""
    case = _write_case(str(tmp_path))
    schema, extract = case[0], case[2]
    _, tvars = _both_variants(extract)
    cache = tmp_path / 'cache'
    plain, _ = tload.load_ld_from_schema(schema, tvars, [], 1.0,
                                         cache_dir=str(cache))
    entry = sorted(cache.glob('*.npz'))[0]
    data = entry.read_bytes()
    if damage == 'truncated':
        entry.write_bytes(data[:len(data) // 2])
    elif damage == 'not an npz':
        entry.write_bytes(b'not an npz')
    else:
        with np.load(entry) as z:
            kept = {k: z[k] for k in z.files if k != 'rank'}
        with open(entry, 'wb') as fh:
            np.savez(fh, **kept)
    _cache_counts()
    with caplog.at_level(logging.WARNING):
        again, _ = tload.load_ld_from_schema(schema, tvars, [], 1.0,
                                             cache_dir=str(cache))
    assert 'unreadable factor-cache entry' in caplog.text
    assert _cache_counts() == (2, 1)
    _assert_same_ld(plain, again)
    # the refactorized entry was published again, whole
    tload.load_ld_from_schema(schema, tvars, [], 1.0, cache_dir=str(cache))
    assert _cache_counts() == (3, 0)


def test_fit_mmap_factor_cache_matches_jax(tmp_path):
    """fit --mmap --factor-cache through both CLIs on one cache: the JAX
    package fills it, the port reads it with hits only, and the outputs
    agree at tests/test_torch_cli.py's tolerances (both take the mmap
    RNG draws, so the grids agree)."""
    case = _write_case(str(tmp_path))
    cache = str(tmp_path / 'cache')
    flags = ['--mmap', '--factor-cache', cache]
    outs = {pkg: str(tmp_path / pkg) for pkg in ('jax', 'torch')}
    jfrontend.main(_argv(case, outs['jax']) + flags)
    _cache_counts()
    tfrontend.main(_argv(case, outs['torch']) + flags + ['--device', 'cpu'])
    hits, misses = _cache_counts()
    assert hits > 0 and misses == 0
    jh, jcols = _read_tsv(outs['jax'] + '.estimates.tsv')
    th, tcols = _read_tsv(outs['torch'] + '.estimates.tsv')
    assert th == jh
    for col in th:
        if col.startswith('posterior'):
            j = np.array(jcols[col], dtype=float)
            np.testing.assert_allclose(np.array(tcols[col], dtype=float),
                                       j, rtol=0,
                                       atol=1e-8 * np.abs(j).max())
        else:
            assert tcols[col] == jcols[col], col
    j, t = np.load(outs['jax'] + '.npz'), np.load(outs['torch'] + '.npz')
    assert sorted(t.files) == sorted(j.files)
    for key in j.files:
        np.testing.assert_allclose(t[key], j[key], rtol=1e-8,
                                   atol=1e-8 * np.abs(j[key]).max(),
                                   err_msg=key)


def test_sim_stages_through_the_spill(tmp_path, monkeypatch):
    """sim loads its LD through the spill (mmap mode, as vilma_tpu's) and
    its seeded outputs equal the JAX package's: true_beta bit for bit,
    BETA and SE at tests/test_torch_commands.py's tolerances."""
    root = str(tmp_path)
    schema, paths, annot, cov_path, wpath = _sim_inputs(root, 'npy')
    spills = []
    real = tblocks.FactorSpill

    def counted(*a, **k):
        spills.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tblocks, 'FactorSpill', counted)
    outs = {}
    for pkg, main, dev in (('jax', jfrontend.main, []),
                           ('torch', tfrontend.main, ['--device', 'cpu'])):
        outs[pkg] = os.path.join(root, pkg)
        main(['sim', '--sumstats', ','.join(paths), '--covariance',
              cov_path, '--weights', wpath, '--annotations', annot,
              '--output', outs[pkg], '--names', 'eur,afr', '--ld-schema',
              f'{schema},{schema}', '--seed', '5'] + dev)
    assert spills == [1, 1]  # one load per cohort (their missing sets differ)
    for name in ('eur', 'afr'):
        _, jcols = _read_tsv(f'{outs["jax"]}.{name}.simgwas.tsv')
        _, tcols = _read_tsv(f'{outs["torch"]}.{name}.simgwas.tsv')
        for col in ('ID', 'A1', 'A2', 'true_beta'):
            assert tcols[col] == jcols[col], col
        for col, atol in (('SE', 1e-12), ('BETA', 1e-10)):
            j = np.array(jcols[col], dtype=float)
            np.testing.assert_allclose(np.array(tcols[col], dtype=float),
                                       j, rtol=0,
                                       atol=atol * np.abs(j).max())


_WORKER = r'''
import resource, sys
sys.modules['jax'] = sys.modules['pandas'] = None
import numpy as np
import torch
torch.set_num_threads(1)
from vilma_tpu_torch.io import load

headroom_mb, schema, use_mmap = int(sys.argv[1]), sys.argv[2], sys.argv[3]
variants = load.load_variant_list(schema + ".extract")


# RLIMIT_DATA bounds VmData (brk and anonymous maps, Linux >= 4.7) but
# not file-backed maps: calibrate on the interpreter's own baseline so
# only the load's anonymous allocations count
def vmdata_kb():
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmData"):
                return int(line.split()[1])


soft = (vmdata_kb() + headroom_mb * 1024) * 1024
resource.setrlimit(resource.RLIMIT_DATA, (soft, soft))
try:
    packed, _ = load.load_ld_from_schema(
        schema, variants, denylist=[], ldthresh=1.0,
        mmap=use_mmap == "mmap", spill_dir=sys.argv[4])
except (MemoryError, RuntimeError) as exc:
    print("OOM", type(exc).__name__)
    sys.exit(0)
print("OK", packed.n, int(packed.rank), len(packed.buckets))
'''


def _run_capped(schema, cap_mb, mode, spill_dir):
    env = dict(os.environ, OMP_NUM_THREADS='1', MKL_NUM_THREADS='1',
               OPENBLAS_NUM_THREADS='1')
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    return subprocess.run([sys.executable, '-c', _WORKER, str(cap_mb),
                           schema, mode, spill_dir], capture_output=True,
                          text=True, timeout=300, env=env, cwd=REPO)


def test_spill_loads_under_ram_cap(tmp_path):
    """A process that imports only torch and numpy loads a schema with
    RLIMIT_DATA capped at its factor payload (24 full-rank 512-SNP
    blocks, 48 MiB) through the spill; without the spill the same cap
    fails the load (factors and packed tensors, >= 2x the payload), so
    the cap is not vacuous."""
    schema = _dense_schema(str(tmp_path), num_blocks=24, block=512)
    cap_mb = 24 * 512 * 512 * 8 >> 20
    out = _run_capped(schema, cap_mb, 'mmap', str(tmp_path))
    assert out.stdout.startswith('OK 12288'), (
        out.stdout, out.stderr[-2000:])
    out = _run_capped(schema, cap_mb, 'plain', str(tmp_path))
    assert out.stdout.startswith('OOM'), (
        'the cap did not constrain the unspilled load; the test is '
        'vacuous', out.stdout, out.stderr[-2000:])
