"""Multi-process fits of vilma_tpu_torch over torch.distributed on the
CPU (gloo): the metadata plan and the per-process sharded load against
vilma_tpu's and against the port's plain loader, `fit --distributed` in
2 (and, marked slow as in tests/test_distributed.py, 4 and
shuffled-extract) processes against the single-process fit, with
component sharding (--mesh comp=2,snp=1 and comp=2,snp=2 in 2 processes;
marked slow, comp=2,snp=2 in 4, on the column and row subgroups), on
schemas that disagree on the order of shared variants (the global-gather
layout, at snp=2 and comp=2,snp=2), how the process group is joined, and
that every rank leaves it."""
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from vilma_tpu.parallel import distributed as jdist
from vilma_tpu_torch import frontend as tfrontend
from vilma_tpu_torch.io import load
from vilma_tpu_torch.ops import blocks
from vilma_tpu_torch.parallel import alignment
from vilma_tpu_torch.parallel import distributed
from vilma_tpu_torch.parallel import mesh as mesh_mod

from tests.test_distributed import _build_schema
from tests.test_torch_cli import _argv, _read_tsv, _write_case
from tests.test_torch_parallel import conflicting_argv

import tests.torch_parity  # noqa: F401  (one torch thread per worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# each process of a multi-process fit runs under this many seconds
PROCESS_TIMEOUT = 180


@pytest.mark.parametrize('shuffled', [False, True])
def test_plan_and_sharded_load_match_jax(tmp_path, shuffled):
    """plan_sharded_load plans vilma_tpu's layout from metadata (through
    the virtual order for a shuffled extract), and load_ld_sharded on an
    8-shard mesh defines the plain loader's operator through the layout
    map, with its rank and missing variants."""
    import pandas as pd
    schema = _build_schema(tmp_path, sizes=[48, 96, 130, 64, 48, 77, 200,
                                            64],
                           shuffle_extract=shuffled)
    variants = load.load_variant_list(schema + '.extract')
    plan = distributed.plan_sharded_load([(schema, [])], variants, 8)
    jplan = jdist.plan_sharded_load(
        [(schema, [])], pd.read_csv(schema + '.extract', sep='\t'), 8)
    assert plan.L == jplan.L and plan.L % (8 * 128) == 0
    np.testing.assert_array_equal(plan.layout_map, jplan.layout_map)

    plain, miss1 = load.load_ld_from_schema(schema, variants, [], 1.0)
    mesh = mesh_mod.make_mesh(8, device='cpu')
    sharded, miss2 = distributed.load_ld_sharded(
        schema, variants, [], 1.0, mesh, plan)
    assert miss1 == miss2
    assert sharded.shard_count == 8 and sharded.rank == plain.rank
    n = len(variants)
    x = np.random.default_rng(1).standard_normal(n)
    xl = torch.as_tensor(alignment.relayout_rows(x, plan.layout_map,
                                                 plan.L))
    parts = blocks.split(sharded, xl)
    lmap = plan.layout_map
    for op in (blocks.dot, blocks.inverse_dot):
        got = torch.cat(op(sharded, parts)).numpy()
        want = op(plain, torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(got[lmap], want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())
        pads = np.ones(plan.L, dtype=bool)
        pads[lmap] = False
        assert np.all(got[pads] == 0)
    np.testing.assert_allclose(torch.cat(blocks.diag(sharded)).numpy()[lmap],
                               blocks.diag(plain).numpy(), rtol=1e-12,
                               atol=1e-14)


def _free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    env['OMP_NUM_THREADS'] = env['MKL_NUM_THREADS'] = '1'
    return env


def _run_ranks(argv, nproc, mesh):
    """`fit --distributed --mesh <mesh>` in nproc processes on localhost
    (gloo), each under its own timeout. Returns their (return code,
    stderr)."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'vilma_tpu_torch.frontend'] + argv
        + ['--device', 'cpu', '--distributed', '--coordinator',
           f'localhost:{port}', '--num-processes', str(nproc),
           '--process-id', str(rank), '--mesh', mesh,
           '--logfile', '-', '--verbose'],
        env=_env(), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(nproc)]
    outs = []
    for proc in procs:
        try:
            out, _ = proc.communicate(timeout=PROCESS_TIMEOUT)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            out, _ = proc.communicate()
        outs.append((proc.returncode, out))
    return outs


def _check_cluster_fit(tmp_path, nproc, mesh, extra=(), shuffled=False,
                       comp=1, conflicting=False):
    """nproc processes on a mesh ('snp=N' or 'comp=M,snp=N') against the
    single-process fit: rank 0 writes the unsharded fit's outputs; each
    process factorized only its own blocks of every LD matrix it loaded:
    with `comp` rows, the processes of each row (a contiguous run of
    nproc / comp) load every block between them, as every other row's
    do. `conflicting` fits two schemas that disagree on the order of
    shared variants (the global-gather layout)."""
    if conflicting:
        argv = conflicting_argv(str(tmp_path))
    else:
        case = _write_case(str(tmp_path))

        def argv(prefix):
            return _argv(case, prefix)
    if shuffled:
        schema, sumstats, extract, annot = case
        with open(extract) as fh:
            header, *rows = fh.read().splitlines()
        order = np.random.default_rng(3).permutation(len(rows))
        with open(extract, 'w') as fh:
            fh.write('\n'.join([header] + [rows[i] for i in order]) + '\n')
    single = str(tmp_path / 'single')
    tfrontend.main(argv(single) + list(extra) + ['--device', 'cpu'])
    multi = str(tmp_path / 'multi')
    outs = _run_ranks(argv(multi) + list(extra), nproc, mesh)
    for rc, out in outs:
        assert rc == 0, out[-3000:]
    loads = [re.findall(r'(\d+) of (\d+) LD blocks factorized here '
                        r'\(\d+ slots in \d+ shards, layout (\w+)\)', out)
             for _, out in outs]
    assert all(loads) and len({len(ld) for ld in loads}) == 1, \
        [out[-2000:] for _, out in outs]
    for k in range(len(loads[0])):
        owned = [int(ld[k][0]) for ld in loads]
        total = int(loads[0][k][1])
        assert {ld[k][2] for ld in loads} == {
            'gather' if conflicting else 'local'}
        per_row = nproc // comp
        rows = [owned[r * per_row:(r + 1) * per_row] for r in range(comp)]
        assert all(row == rows[0] for row in rows) and sum(rows[0]) == total
        if per_row > 1 and total > 1:
            assert max(owned) < total
    sh, scols = _read_tsv(single + '.estimates.tsv')
    mh, mcols = _read_tsv(multi + '.estimates.tsv')
    assert sh == mh
    for col in sh:
        if col.startswith('posterior'):
            np.testing.assert_allclose(np.array(mcols[col], dtype=float),
                                       np.array(scols[col], dtype=float),
                                       rtol=1e-7, atol=1e-10, err_msg=col)
        else:
            assert mcols[col] == scols[col], col
    s, m = np.load(single + '.npz'), np.load(multi + '.npz')
    assert sorted(s.files) == sorted(m.files)
    for key in s.files:
        np.testing.assert_allclose(m[key], s[key], rtol=1e-7, atol=1e-10,
                                   err_msg=key)


@pytest.mark.parametrize('extra', [[], ['--learn-scaling'], ['--mmap']],
                         ids=['plain', 'learn_scaling', 'mmap'])
def test_two_process_fit_matches_single_process(tmp_path, extra):
    """fit --distributed in 2 processes of one shard each (gloo) writes
    the single-process fit's .estimates.tsv and .npz; each process
    eigendecomposed only its own shard's blocks (with --mmap through the
    spill, every process taking the reference's RNG draws)."""
    _check_cluster_fit(tmp_path, nproc=2, mesh='snp=2', extra=extra)


@pytest.mark.parametrize('mesh', ['comp=2,snp=1', 'comp=2,snp=2'])
def test_two_process_comp_fit_matches_single_process(tmp_path, mesh):
    """fit --distributed --mesh comp=2[,snp=...] in 2 processes (gloo):
    each process holds one comp row, so both load every span's blocks;
    rank 0 writes the single-process fit's files (--learn-scaling: the
    kdim state split over comp)."""
    _check_cluster_fit(tmp_path, nproc=2, mesh=mesh,
                       extra=['--learn-scaling'], comp=2)


@pytest.mark.parametrize('mesh', ['snp=2', 'comp=2,snp=2'])
def test_two_process_gathered_fit_matches_single_process(tmp_path, mesh):
    """fit --distributed on schemas that disagree on the order of shared
    variants (the layout=gather leg of tests/distributed_worker.py): 2
    processes take the global-gather layout, each factorizing only the
    blocks dealt to its shards (at comp=2,snp=2 each process holds a comp
    row and loads all), and rank 0 writes the single-process fit's
    files."""
    _check_cluster_fit(tmp_path, nproc=2, mesh=mesh, conflicting=True,
                       comp=2 if mesh.startswith('comp') else 1)


@pytest.mark.slow
def test_four_process_comp_fit_on_subgroups(tmp_path):
    """comp=2,snp=2 in 4 processes of one shard each: the comp columns
    and rows reduce on torch.distributed subgroups of 2 processes."""
    _check_cluster_fit(tmp_path, nproc=4, mesh='comp=2,snp=2', comp=2)


@pytest.mark.slow
def test_four_process_fit_matches_single_process(tmp_path):
    """4 processes of two shards each (an 8-shard mesh)."""
    _check_cluster_fit(tmp_path, nproc=4, mesh='snp=8',
                       extra=['--learn-scaling'])


@pytest.mark.slow
def test_two_process_fit_shuffled_extract(tmp_path):
    """An extract not in genome order plans through the virtual order in
    every process and still equals the single-process fit."""
    _check_cluster_fit(tmp_path, nproc=2, mesh='snp=4', shuffled=True)


class _Group:
    """torch.distributed stand-ins recording init_process_group (in
    `calls`) and, in `events`, each barrier and destroy_process_group.
    With `joins` the group is initialized once init runs, and its
    collectives act as if the other process held what this one does (a
    fit runs through them alone, as process `rank` of 2)."""

    def __init__(self, monkeypatch, initialized=False, error=None,
                 joins=False, rank=0):
        import torch.distributed as dist
        self.calls, self.events = [], []
        self.initialized = initialized
        monkeypatch.setattr(dist, 'is_initialized',
                            lambda: self.initialized)
        monkeypatch.setattr(dist, 'get_backend', lambda: 'gloo')
        monkeypatch.setattr(dist, 'get_rank', lambda: rank)
        monkeypatch.setattr(dist, 'get_world_size', lambda: 2)

        def init(**kw):
            if error is not None:
                raise error
            self.calls.append(kw)
            self.initialized = joins

        def destroy():
            self.events.append('destroy')
            self.initialized = False

        def all_gather(outs, x, group=None):
            for out in outs:
                out.copy_(x)

        def all_gather_object(outs, obj):
            outs[:] = [obj] * len(outs)
        monkeypatch.setattr(dist, 'init_process_group', init)
        monkeypatch.setattr(dist, 'barrier',
                            lambda: self.events.append('barrier'))
        monkeypatch.setattr(dist, 'destroy_process_group', destroy)
        monkeypatch.setattr(dist, 'all_reduce', lambda x, **kw: None)
        monkeypatch.setattr(dist, 'all_gather', all_gather)
        monkeypatch.setattr(dist, 'all_gather_object', all_gather_object)


@pytest.mark.parametrize('device,backend', [('cpu', 'gloo'),
                                            ('cuda', 'nccl')])
def test_initialize_backend_follows_the_device(monkeypatch, device,
                                               backend):
    """The backend is NCCL for a fit on cuda and gloo on cpu; the group
    meets at tcp://<coordinator> with the given size and rank, or reads
    torchrun's environment without a coordinator."""
    group = _Group(monkeypatch)
    distributed.initialize('localhost:1234', 2, 1, device=device)
    distributed.initialize(None, device=device)
    assert group.calls == [
        dict(backend=backend, init_method='tcp://localhost:1234',
             world_size=2, rank=1),
        dict(backend=backend, init_method='env://')]


def test_initialize_errors_propagate(monkeypatch):
    """A failing rendezvous raises; an initialized group is kept."""
    _Group(monkeypatch, error=RuntimeError('connection refused'))
    with pytest.raises(RuntimeError, match='connection refused'):
        distributed.initialize('localhost:1', 2, 0, device='cpu')
    group = _Group(monkeypatch, initialized=True)
    distributed.initialize('localhost:1', 2, 0, device='cpu')
    assert group.calls == []


@pytest.mark.parametrize('case', ['rank0', 'rank1', 'raises'])
def test_fit_leaves_the_group_on_every_rank(monkeypatch, tmp_path, case):
    """fit --distributed leaves its process group on every rank: process
    0 after writing the files, process 1 from its early return (before
    process 0 has written them: without the barrier and
    destroy_process_group the interpreter tore down live gloo threads at
    exit, an abort), each once, with a barrier first; a fit that raises
    destroys the group without the barrier (a peer may never reach it)
    and the error propagates. The group is the stand-ins', the fit the
    port's own at --mesh snp=2."""
    from vilma_tpu_torch.inference import engine
    group = _Group(monkeypatch, joins=True, rank=int(case == 'rank1'))
    if case == 'raises':
        def fail(*a, **k):
            raise RuntimeError('the fit failed')
        monkeypatch.setattr(engine.MultiPopVI, 'optimize', fail)
    prefix = str(tmp_path / 'fit')
    argv = _argv(_write_case(str(tmp_path)), prefix) + [
        '--device', 'cpu', '--distributed', '--coordinator',
        'localhost:1', '--num-processes', '2', '--process-id',
        str(int(case == 'rank1')), '--mesh', 'snp=2']
    if case == 'raises':
        with pytest.raises(RuntimeError, match='the fit failed'):
            tfrontend.main(argv)
    else:
        tfrontend.main(argv)
    assert len(group.calls) == 1
    assert group.events == (['destroy'] if case == 'raises'
                            else ['barrier', 'destroy'])
    assert os.path.exists(prefix + '.estimates.tsv') == (case == 'rank0')
