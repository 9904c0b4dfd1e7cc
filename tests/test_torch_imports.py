"""The port imports neither jax, pandas nor ml_dtypes, its unported
surface raises with the ROADMAP item it waits for, and its entry points
run on the card unless the caller asks for the CPU."""
import os
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

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GUARD = """
import sys
sys.modules['jax'] = sys.modules['pandas'] = sys.modules['ml_dtypes'] = None
import vilma_tpu_torch
import vilma_tpu_torch.frontend
import vilma_tpu_torch.commands.fit
import vilma_tpu_torch.commands.make_ld_schema
import vilma_tpu_torch.commands.check_ld_schema
import vilma_tpu_torch.commands.sim
import vilma_tpu_torch.io.plink
import vilma_tpu_torch.ops.blocks
import vilma_tpu_torch.inference.engine
import vilma_tpu_torch.models.sigma
import vilma_tpu_torch.ops.cuda.block_matvec
import vilma_tpu_torch.ops.cuda.build
import vilma_tpu_torch.ops.cuda.compact_obj
import vilma_tpu_torch.convert
import chip_smoke
import profile_torch_step
import vilma_tpu_torch.io.load
import vilma_tpu_torch.utils.npz_stream
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None
                and m.split('.')[0] in ('jax', 'jaxlib', 'pandas',
                                       'ml_dtypes', 'vilma_tpu'))
print('LOADED', loaded)
"""


def test_import_guard():
    """Every module of the port, chip_smoke.py and profile_torch_step.py
    import with jax, pandas and ml_dtypes blocked, and none of them (nor
    the JAX package) gets loaded."""
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    out = subprocess.run([sys.executable, '-c', GUARD], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert 'LOADED []' in out.stdout, out.stdout


@pytest.mark.parametrize('flags', [
    ['--mesh', 'snp=4'], ['--distributed'], ['--mmap'],
    ['--factor-cache', '/nonexistent'],
    ['--mmap', '--sumstats', 'a,b,c,d']])
def test_unported_fit_flags_raise(flags, tmp_path):
    """Each unported fit option raises before any file is read, naming
    its ROADMAP item, at any cohort count (the last case has four: P >= 4
    itself runs, tests/test_torch_materialized.py)."""
    argv = ['fit', '--ld-schema', 'x.schema', '--sumstats', 'a.tsv',
            '--extract', 'e.tsv', '--output', str(tmp_path / 'o'),
            '--device', 'cpu'] + flags
    with pytest.raises(NotImplementedError, match='ROADMAP.md'):
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
