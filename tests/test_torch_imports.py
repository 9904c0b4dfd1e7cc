"""The port (with bench_torch.py, bench_hbm_torch.py,
tools/drift_genome_torch.py, tools/eval_scaling_torch.py,
tools/export_synthetic_schema_torch.py and tools/e2e_fit_torch.py) imports
neither jax, optax, pandas nor ml_dtypes, its flags parse (component
sharding among them) or raise before any file is read, and its entry
points run on the card unless the caller asks for the CPU."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from vilma_tpu_torch import frontend
from vilma_tpu_torch.commands import fit as fit_cmd
from vilma_tpu_torch.inference import engine
from vilma_tpu_torch.models import sigma
from vilma_tpu_torch.ops.cuda import block_matvec, compact_obj
from vilma_tpu_torch.parallel import mesh as mesh_mod

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GUARD = """
import sys
sys.modules['jax'] = sys.modules['pandas'] = sys.modules['ml_dtypes'] = None
sys.modules['optax'] = None
import vilma_tpu_torch
import vilma_tpu_torch.frontend
import vilma_tpu_torch.commands.fit
import vilma_tpu_torch.commands.make_ld_schema
import vilma_tpu_torch.commands.check_ld_schema
import vilma_tpu_torch.commands.sim
import vilma_tpu_torch.io.plink
import vilma_tpu_torch.ops.blocks
import vilma_tpu_torch.inference.engine
import vilma_tpu_torch.inference.gradient
import vilma_tpu_torch.inference.mcmc
import vilma_tpu_torch.models.sigma
import vilma_tpu_torch.ops.cuda.block_matvec
import vilma_tpu_torch.ops.cuda.build
import vilma_tpu_torch.ops.cuda.compact_obj
import vilma_tpu_torch.convert
import vilma_tpu_torch.parallel
import vilma_tpu_torch.parallel.alignment
import vilma_tpu_torch.parallel.mesh
import vilma_tpu_torch.parallel.distributed
import chip_smoke
import profile_torch_step
import vilma_tpu_torch.io.load
import vilma_tpu_torch.utils.npz_stream
import vilma_tpu_torch.utils.synthetic
import bench_torch
import bench_hbm_torch
sys.path.insert(0, 'tools')
import eval_scaling_torch
import export_synthetic_schema_torch
import e2e_fit_torch
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None
                and m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'pandas',
                                       'ml_dtypes', 'vilma_tpu'))
print('LOADED', loaded)
"""


def test_import_guard():
    """Every module of the port (the validation tools and the synthetic
    problem generator among them), chip_smoke.py, profile_torch_step.py,
    bench_torch.py, bench_hbm_torch.py, tools/eval_scaling_torch.py,
    tools/export_synthetic_schema_torch.py and tools/e2e_fit_torch.py
    import with jax, optax, pandas and ml_dtypes blocked, and none of
    them (nor the JAX package) gets loaded."""
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    out = subprocess.run([sys.executable, '-c', GUARD], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert 'LOADED []' in out.stdout, out.stdout


# a whole f64cpu leg of tools/drift_genome_torch.py and its --compare,
# run with jax, pandas and the JAX package blocked
DRIFT_GUARD = """
import runpy, sys
sys.modules['jax'] = sys.modules['pandas'] = sys.modules['vilma_tpu'] = None
tool, out = sys.argv[1:]
for argv in (['--leg', 'f64cpu', '--out', out, '--iters', '1'],
             ['--compare', out, out]):
    sys.argv = [tool] + argv
    try:
        runpy.run_path(tool, run_name='__main__')
    except SystemExit as exc:
        assert not exc.code, exc.code
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None
                and m.split('.')[0] in ('jax', 'jaxlib', 'pandas',
                                       'vilma_tpu'))
print('LOADED', loaded)
"""


def test_drift_tool_imports_no_jax(tmp_path):
    """tools/drift_genome_torch.py runs a leg (bench_torch's problem at
    1,100 SNPs, one outer step, its LD cache in tmp_path) and compares
    with jax, pandas and vilma_tpu blocked, and loads none of them."""
    tools = tmp_path / 'tools'
    tools.mkdir()
    shutil.copy(os.path.join(REPO, 'bench_torch.py'), tmp_path)
    shutil.copy(os.path.join(REPO, 'tools', 'drift_genome_torch.py'), tools)
    env = {k: v for k, v in os.environ.items() if not k.startswith('BENCH_')}
    env.update(BENCH_LOCI='1100', OMP_NUM_THREADS='1',
               PYTHONPATH=REPO + os.pathsep + env.get('PYTHONPATH', ''))
    out = subprocess.run(
        [sys.executable, '-c', DRIFT_GUARD,
         str(tools / 'drift_genome_torch.py'), str(tmp_path / 'd.npz')],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert 'LOADED []' in out.stdout, out.stdout
    assert '"base": "f64cpu"' in out.stdout


# a child of tools/eval_scaling_torch.py and bench_hbm_torch.py's probe,
# run with jax, pandas and the JAX package blocked
TWINS_GUARD = """
import os, runpy, sys
sys.modules['jax'] = sys.modules['pandas'] = sys.modules['vilma_tpu'] = None
tool, hbm = sys.argv[1:]
os.environ['EVAL_CHILD'] = '1'
sys.argv = [tool, '2']
runpy.run_path(tool, run_name='__main__')
sys.argv = [hbm]
runpy.run_path(hbm, run_name='__main__')
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None
                and m.split('.')[0] in ('jax', 'jaxlib', 'pandas',
                                       'vilma_tpu'))
print('LOADED', loaded)
"""


def test_measurement_twins_import_no_jax(tmp_path):
    """tools/eval_scaling_torch.py's child (bench_torch's problem at 1,100
    SNPs on BENCH_DEVICE=cpu, chains of 2, its LD cache in tmp_path) and
    bench_hbm_torch.py at 1 MiB run with jax, pandas and vilma_tpu
    blocked, and load none of them."""
    tools = tmp_path / 'tools'
    tools.mkdir()
    shutil.copy(os.path.join(REPO, 'bench_torch.py'), tmp_path)
    shutil.copy(os.path.join(REPO, 'tools', 'eval_scaling_torch.py'), tools)
    env = {k: v for k, v in os.environ.items() if not k.startswith('BENCH_')}
    env.update(BENCH_LOCI='1100', BENCH_DEVICE='cpu', HBM_SIZES='1',
               HBM_CHAIN='2', OMP_NUM_THREADS='1',
               PYTHONPATH=REPO + os.pathsep + env.get('PYTHONPATH', ''))
    out = subprocess.run(
        [sys.executable, '-c', TWINS_GUARD,
         str(tools / 'eval_scaling_torch.py'),
         os.path.join(REPO, 'bench_hbm_torch.py')],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert 'LOADED []' in out.stdout, out.stdout
    assert 'EVAL_MS' in out.stdout and '"ok": true' in out.stdout
    assert '1 MiB footprint' in out.stdout


# tools/export_synthetic_schema_torch.py's host route, then
# tools/e2e_fit_torch.py's text stage and a one-step fit on what it wrote,
# run with jax, pandas and the JAX package blocked
EXPORT_GUARD = """
import runpy, sys
sys.modules['jax'] = sys.modules['pandas'] = sys.modules['vilma_tpu'] = None
export, e2e, d = sys.argv[1:]
fit = ['fit', '--sumstats', f'{d}/pop1.sumstats.tsv,{d}/pop2.sumstats.tsv',
       '--ld-schema', f'{d}/schema.schema,{d}/schema.schema',
       '--extract', f'{d}/extract.tsv', '-K', '2', '--num-its', '1',
       '--output', f'{d}/run', '--device', 'cpu']
for tool, argv in ((export, [d, '2048', '--device', 'cpu']),
                   (e2e, ['--text-only'] + fit), (e2e, fit)):
    sys.argv = [tool] + argv
    try:
        runpy.run_path(tool, run_name='__main__')
    except SystemExit as exc:
        assert not exc.code, exc.code
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None
                and m.split('.')[0] in ('jax', 'jaxlib', 'pandas',
                                       'vilma_tpu'))
print('LOADED', loaded)
"""


def test_export_and_e2e_tools_import_no_jax(tmp_path):
    """tools/export_synthetic_schema_torch.py writes 2,048 SNPs factored
    on the host, and tools/e2e_fit_torch.py times the text stage and a
    one-step fit on them, with jax, pandas and vilma_tpu blocked; none of
    them gets loaded, and both E2E lines are printed."""
    env = dict(os.environ, OMP_NUM_THREADS='1',
               PYTHONPATH=REPO + os.pathsep + os.environ.get('PYTHONPATH',
                                                             ''))
    out = subprocess.run(
        [sys.executable, '-c', EXPORT_GUARD,
         os.path.join(REPO, 'tools', 'export_synthetic_schema_torch.py'),
         os.path.join(REPO, 'tools', 'e2e_fit_torch.py'),
         str(tmp_path / 'in')],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert 'LOADED []' in out.stdout, out.stdout
    assert 'wrote 2 blocks + 2 sumstats for 2048 SNPs' in out.stdout
    assert 'E2E_TEXT {' in out.stdout and '\nE2E {' in out.stdout


@pytest.mark.parametrize('flags', [
    ['--mesh', 'comp=2'], ['--mesh', 'snp=2,comp=2'],
    ['--mesh', 'comp=2', '--mmap'],
    ['--mesh', 'comp=4', '--distributed', '--factor-cache', '/nonexistent'],
    ['--mesh', 'snp=2,comp=2', '--sumstats', 'a,b,c,d']])
def test_unported_fit_flags_raise(flags, tmp_path):
    """The once-unported fit option, component sharding (--mesh comp=M),
    now parses and plans a (comp, snp) mesh on the host, beside the snp
    axis, --distributed, --mmap and --factor-cache and at any cohort count
    (the last case has four): the fit goes on to read its inputs, and
    raises only on the absent extract. (--distributed would join a
    process group first: its case stops at the plan.)"""
    cohorts = (flags[flags.index('--sumstats') + 1].count(',') + 1
               if '--sumstats' in flags else 1)
    argv = ['fit', '--ld-schema', ','.join(['x.schema'] * cohorts),
            '--sumstats', 'a.tsv', '--extract', str(tmp_path / 'e.tsv'),
            '--output', str(tmp_path / 'o'), '--device', 'cpu'] + flags
    args = frontend.build_parser()[0].parse_args(argv)
    axes = fit_cmd._check_supported(args)
    assert axes['comp'] == int(args.mesh.split('comp=')[1].split(',')[0])
    mesh = mesh_mod.make_mesh(axes['snp'], n_comp=axes['comp'],
                              device='cpu')
    assert (mesh.n_comp, mesh.n_snp) == (axes['comp'], axes['snp'])
    assert len(mesh.devices) == axes['comp'] * axes['snp']
    assert [mesh.coords(j) for j in range(len(mesh.devices))] == [
        (c, s) for c in range(axes['comp']) for s in range(axes['snp'])]
    if '--distributed' not in flags:
        with pytest.raises(FileNotFoundError, match='e.tsv'):
            frontend.main(argv)


@pytest.mark.parametrize('mesh', ['comp=0', 'comp=0,snp=2', 'comp=-1',
                                  'comp=x', 'comp=', 'comp=2,rows=2',
                                  'snp=2;comp=2'])
def test_bad_mesh_axes_raise(mesh, tmp_path):
    """comp=0 and malformed --mesh axes raise ValueError before any file
    is read."""
    argv = ['fit', '--ld-schema', 'x.schema', '--sumstats', 'a.tsv',
            '--extract', str(tmp_path / 'e.tsv'), '--output',
            str(tmp_path / 'o'), '--device', 'cpu', '--mesh', mesh]
    with pytest.raises(ValueError, match='--mesh'):
        frontend.main(argv)


@pytest.mark.parametrize('argv', [
    ['make_ld_schema', '-o', 'o', '-b', 'b.bed', '-p', 'list.txt'],
    ['check_ld_schema', '--ld-schema', 'x.schema', '--listvars', 'v'],
    ['sim', '--sumstats', 'a', '--covariance', 'c', '--weights', 'w',
     '--output', 'o', '--ld-schema', 'x']])
def test_subcommands_need_a_card_by_default(argv, monkeypatch):
    """Every subcommand runs on --device cuda unless told otherwise, and
    without a card raises instead of falling back to the host."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='--device cpu'):
        frontend.main(argv)


@pytest.mark.parametrize('flags', [
    ['--mmap'], ['--factor-cache', 'cache'],
    ['--mmap', '--factor-cache', 'cache']])
def test_bounded_memory_flags_are_accepted(flags, tmp_path):
    """--mmap and --factor-cache pass the flag checks: the fit goes on to
    read its inputs (absent here). No --mesh axis is refused any more
    (the fit module keeps no table of unported axes)."""
    assert not hasattr(fit_cmd, '_NOT_PORTED')
    argv = ['fit', '--ld-schema', 'x.schema', '--sumstats', 'a.tsv',
            '--extract', str(tmp_path / 'e.tsv'), '--output',
            str(tmp_path / 'o'), '--device', 'cpu'] + flags
    fit_cmd._check_supported(frontend.build_parser()[0].parse_args(argv))
    with pytest.raises(FileNotFoundError, match='e.tsv'):
        frontend.main(argv)


@pytest.mark.parametrize('constant', ['u', 's', 'd'])
def test_matvec_autograd_refuses_grad_of_the_factors(constant):
    """The matvec's autograd Function differentiates x alone: a u, s or d
    that requires grad raises before any launch (the LD factors are
    constants; nothing in the JAX package differentiates them)."""
    ops = dict(u=torch.zeros(1, 16, 8), s=torch.ones(1, 8),
               d=torch.zeros(1, 16), x=torch.ones(1, 2, 16))
    ops[constant].requires_grad_(True)
    before = (block_matvec.launches, block_matvec.launches_backward)
    with pytest.raises(ValueError, match='must not require grad'):
        block_matvec.BucketMatvec.apply(ops['u'], ops['s'], ops['d'],
                                        ops['x'])
    assert (block_matvec.launches,
            block_matvec.launches_backward) == before
    # the CPU path stays the plain version under ordinary autograd
    y = block_matvec.bucket_matvec_multi(ops['u'], ops['s'], ops['d'],
                                         ops['x'])
    assert y.requires_grad and block_matvec.launches == before[0]


def test_learn_scaling_is_accepted(tmp_path):
    """--learn-scaling passes the flag checks on --device cpu: the fit
    goes on to read its inputs (absent here)."""
    argv = ['fit', '--ld-schema', 'x.schema', '--sumstats', 'a.tsv',
            '--extract', str(tmp_path / 'e.tsv'), '--output',
            str(tmp_path / 'o'), '--device', 'cpu', '--learn-scaling']
    args = frontend.build_parser()[0].parse_args(argv)
    assert args.scale_se
    fit_cmd._check_supported(args)
    with pytest.raises(FileNotFoundError, match='e.tsv'):
        frontend.main(argv)


def test_entry_points_default_to_the_card(monkeypatch):
    """MultiPopVI and build_model_data target cuda unless told otherwise;
    without a CUDA device they raise, naming device='cpu'."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.resolve_device()
    kw = dict(marginal_effects=np.zeros((1, 4)),
              std_errs=np.ones((1, 4)), ld_mats=[None],
              annotations=np.ones((4, 1)), mixture_covs=np.eye(1)[None],
              gwas_N=np.ones(1), init_hg=np.ones(1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.MultiPopVI(num_its=1, **kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.build_model_data(scaled=False, scale_se=True, **kw)
    assert engine.resolve_device('cpu').type == 'cpu'


def test_cuda_device_never_falls_back(tmp_path, monkeypatch):
    """--device cuda without a card raises instead of running the plain
    versions; --pallas off is refused on cuda."""
    parser, _ = frontend.build_parser()
    argv = ['fit', '--ld-schema', 'x', '--sumstats', 'a', '--extract',
            'e', '--output', str(tmp_path / 'o')]
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='needs a CUDA device'):
        fit_cmd._resolve_device(parser.parse_args(argv))
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    with pytest.raises(ValueError, match='refused'):
        fit_cmd._resolve_device(parser.parse_args(argv + ['--pallas',
                                                          'off']))
    args = parser.parse_args(argv)
    assert fit_cmd._resolve_device(args).type == 'cuda'
    assert args.precision == 'f32'
    # f64 is the host parity path: the kernels compute in f32
    with pytest.raises(ValueError, match='--device cpu'):
        fit_cmd._resolve_device(parser.parse_args(argv + ['--precision',
                                                          'f64']))


def test_p4_and_kdim_raise():
    """make_summaries at P = 4 (the generic route, which used to raise)
    equals the JAX package's; the kdim wrapper's operand checks raise."""
    from vilma_tpu.models import sigma as jsigma
    rng = np.random.default_rng(4)
    a = rng.standard_normal((2, 4, 4))
    prec = a @ np.swapaxes(a, 1, 2) + 4 * np.eye(4)
    log_det, dterm = rng.standard_normal(2), rng.uniform(0, 2, (4, 5))
    got = sigma.make_summaries(torch.as_tensor(prec),
                               torch.as_tensor(log_det),
                               torch.as_tensor(dterm))
    want = jsigma.make_summaries(prec, log_det, dterm)
    for field in ('log_det_sigma', 'sigma_summary', 'diag', 'matches'):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=1e-12, atol=1e-14)
    # the kdim wrapper takes [K, P, I] and checks its K against the tables
    coeffs = torch.zeros(3, 4)
    args = (coeffs, torch.zeros(3, 1), torch.zeros(5, dtype=torch.int32),
            torch.ones(2, 5))
    assert compact_obj._check_operands('prologue', *args,
                                       torch.zeros(3, 2, 5), 1) == (
        2, 5, 3, 1, 4)
    with pytest.raises(ValueError, match='shape'):
        compact_obj._check_operands('prologue', *args,
                                    torch.zeros(4, 2, 5), 1)
    with pytest.raises(ValueError, match='dims'):
        compact_obj._check_operands('prologue', *args,
                                    torch.zeros(1, 3, 2, 5), 1)


def test_kernel_wrappers_refuse_bad_operands():
    """The wrappers' operand checks (the part of a CUDA launch that runs
    before the kernel) reject wrong shapes and types."""
    with pytest.raises(ValueError, match='float32'):
        compact_obj._check_operands(
            'prologue', torch.zeros(3, 4, dtype=torch.float64),
            torch.zeros(3, 1), torch.zeros(5, dtype=torch.int32),
            torch.ones(2, 5), torch.zeros(2, 5), 1)
    with pytest.raises(ValueError, match='shape'):
        compact_obj._check_operands(
            'prologue', torch.zeros(3, 5), torch.zeros(3, 1),
            torch.zeros(5, dtype=torch.int32), torch.ones(2, 5),
            torch.zeros(2, 5), 1)
    kt, kg, nblocks = compact_obj._launch_shape(1_000_000, 582, 4, 4,
                                                sums=True)
    assert 1 <= kt <= kg == 582 and nblocks == 1024
    # the plain versions run for CPU tensors; launches stay 0
    before = block_matvec.launches
    block_matvec.bucket_matvec_multi(torch.zeros(1, 8, 8), torch.zeros(1, 8),
                                     torch.zeros(1, 8), torch.zeros(1, 2, 8))
    assert block_matvec.launches == before


def test_engine_constants_match_reference():
    from vilma_tpu.inference import engine as jengine
    for name in ('L_MAX', 'REL_TOL', 'ABS_TOL', 'ELBO_TOL', 'EM_TOL',
                 'ELBO_MOMENTUM', 'MAX_NUM_ITERS', '_STREAM_OUTPUT_BYTES',
                 '_EPOCH_SKIP_TOL', '_EPOCH_BUCKETS', '_EPOCH_CAP',
                 '_EPOCH_STATE_BYTES'):
        assert getattr(engine, name) == getattr(jengine, name), name
    assert np.isclose(engine._err_rtol(torch.float32),
                      jengine._err_rtol(np.float32))
