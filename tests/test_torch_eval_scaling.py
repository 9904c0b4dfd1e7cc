"""tools/eval_scaling_torch.py (tools/eval_scaling.py's twin) and
bench_hbm_torch.py (bench_hbm.py's) on the CPU: the twin's evaluation
chain against the JAX tool's at float64 on every compact state, no host
sync inside it, the same table for the same per-size times, no number
without a card, a top-offset check that can fail, the probe's line
format; bench_torch's state choice at BENCH_SIZE=6m; and blocks.diag
in block chunks (the 6M set-up's peak) bit for bit."""
import importlib.util
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import bench
import bench_hbm_torch
import bench_torch
from vilma_tpu.inference import engine as jengine
from vilma_tpu_torch.inference import engine as tengine
from vilma_tpu_torch.ops.cuda import block_matvec, compact_obj

# tier-1 runs the suite under xdist workers; one intra-op thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = 2048            # two 1024-SNP blocks (tests/test_torch_bench.py)
# the chain's summed objective at float64 against the JAX chain's: the
# states' ELBO band of tests/test_torch_bench.py
CHAIN_RTOL = 1e-11


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, 'tools', f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ev = _tool('eval_scaling_torch')
jev = _tool('eval_scaling')

# state -> (BENCH_SCALE_SE, the epoch threshold patched small)
STATES = {'shared': (False, False), 'kdim': (True, False),
          'epoch': (True, True)}


@pytest.fixture(scope='module')
def caches(tmp_path_factory):
    """Both scripts' LD caches, shared by the cases."""
    root = tmp_path_factory.mktemp('eval_caches')
    return str(root / 'jax'), str(root / 'torch')


def _problems(state, caches, monkeypatch):
    """bench.py's and bench_torch.py's problem at SMALL SNPs, float64, on
    the CPU, in `state`'s form (U at float64)."""
    scale_se, epoch = STATES[state]
    for mod, cache in ((bench, caches[0]), (bench_torch, caches[1])):
        for name, value in (('NUM_LOCI', SMALL), ('CACHE_DIR', cache),
                            ('GRID', ''), ('SCALE_SE', scale_se),
                            ('NUM_POPS', 2), ('EPOCH_B', 4)):
            monkeypatch.setattr(mod, name, value)
    if epoch:
        monkeypatch.setattr(jengine, '_EPOCH_STATE_BYTES', 1 << 10)
        monkeypatch.setattr(tengine, '_EPOCH_STATE_BYTES', 1 << 10)
    monkeypatch.delenv('BENCH_LD_DTYPE', raising=False)
    jdata, jst = bench._build(np.float64, jax.devices('cpu')[0])
    tdata, tst = bench_torch._build(torch.float64, torch.device('cpu'))
    assert ev.state_form(tst) == state
    return (jdata, jst), (tdata, tst)


def _jax_chain(data, st, n=3):
    """tools/eval_scaling.py's chain: `n` evaluations in a fori_loop,
    the natural mean carried (the epoch state's accumulator through
    _objective_epoch)."""
    epoch = st.nat_hist is not None

    def body(i, carry):
        nat, acc = carry
        if epoch:
            obj, _, _ = jengine._objective_epoch(data, st, nat, st.nat_hist_c,
                                                 st.hyper_delta)
        else:
            obj, _, _ = jengine._objective_compact(data, st, nat,
                                                   st.hyper_delta)
        return nat + 1e-30 * obj, acc + obj

    return float(jax.jit(lambda: lax.fori_loop(
        0, n, body, (st.nat_mu, jnp.zeros((), st.nat_mu.dtype))))()[1])


@pytest.mark.parametrize('state', list(STATES))
def test_chain_matches_the_jax_chain(state, caches, monkeypatch):
    """The twin's chain of 3 evaluations at float64 sums what the JAX
    tool's chain sums, within 1e-11 relative, on the shared, kdim and
    epoch states, with no host sync (engine.host_syncs unchanged, no
    objective fetched)."""
    (jdata, jst), (tdata, tst) = _problems(state, caches, monkeypatch)
    want = _jax_chain(jdata, jst)

    def fetch(x):
        raise AssertionError('the chain fetched an objective')

    monkeypatch.setattr(tengine, '_fetch', fetch)
    syncs = tengine.host_syncs
    got = ev.chain(tdata, tst, 3)
    assert tengine.host_syncs == syncs
    assert got.dtype == torch.float64 and got.dim() == 0
    assert np.isclose(float(got), want, rtol=CHAIN_RTOL, atol=0)
    # one evaluation, three times: the perturbation leaves it unchanged
    one = float(tengine._objective(tdata, tst, tengine._params(tst),
                                   tst.hyper_delta)[0])
    assert np.isclose(float(got), 3 * one, rtol=1e-14, atol=0)


def test_measure_syncs_nothing_and_counts_evaluations(caches, monkeypatch):
    """measure() on the host: the timed chains make no host sync, sum
    finite objectives, and (plain versions) launch no kernel."""
    _, (tdata, tst) = _problems('shared', caches, monkeypatch)
    m = ev.measure(tdata, tst, 2, reps=2)
    assert m['host_syncs'] == 0 and m['evals'] == 4
    assert m['launches'] == {} and np.isfinite(m['total'])
    assert m['host_ms'] > 0


@pytest.mark.parametrize('corrupt', [None, 'post_means', 'post_vars',
                                     'matvec'])
def test_top_offset_check_can_fail(corrupt, caches, monkeypatch):
    """The top-offset check passes on good outputs and fails when one
    element at the highest offset (the last SNP, the last block's last
    row) of the kernel's output is off."""
    _, (tdata, tst) = _problems('shared', caches, monkeypatch)
    prologue, matvec = compact_obj.prologue, block_matvec.bucket_matvec_multi

    def bad_prologue(*a, **k):
        pm, pv, kl = prologue(*a, **k)
        pm, pv = pm.clone(), pv.clone()
        out = pm if corrupt == 'post_means' else pv
        out[:, -1] += 1e-3 * out.abs().max()
        return pm, pv, kl

    def bad_matvec(*a):
        y = matvec(*a).clone()
        y[-1, :, -1] += 1e-2 * y.abs().max()
        return y

    if corrupt in ('post_means', 'post_vars'):
        monkeypatch.setattr(compact_obj, 'prologue', bad_prologue)
    if corrupt == 'matvec':
        monkeypatch.setattr(block_matvec, 'bucket_matvec_multi', bad_matvec)
    top = ev.top_offset_check(tdata, tst)
    assert top['snps'] == SMALL and top['blocks'] == 2
    assert top['ok'] == (corrupt is None)
    for key in ('post_means', 'post_vars', 'matvec'):
        band = top['band_matvec' if key == 'matvec' else 'band_prologue']
        assert (top[key] > band) == (key == corrupt), (key, top[key])


def test_table_matches_the_jax_tool(monkeypatch, capsys):
    """With time_size stubbed on both sides, main() prints the JAX tool's
    table for the same per-size times."""
    times = {250_000: 0.4123, 500_000: 0.7001, 1_000_000: 1.3456,
             6_000_000: 7.9}
    monkeypatch.setenv('BENCH_DEVICE', 'cpu')
    outs = []
    for mod in (jev, ev):
        monkeypatch.setattr(mod, 'time_size', lambda n: times[n])
        monkeypatch.setattr(sys, 'argv', ['tool', '250000', '5e5', '1000000',
                                          '6000000'])
        mod.main()
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0]
    assert len(outs[0].splitlines()) == 5


def _env(**knobs):
    env = {k: v for k, v in os.environ.items() if not k.startswith('BENCH_')}
    env.update(knobs, OMP_NUM_THREADS='1',
               PYTHONPATH=REPO + os.pathsep + env.get('PYTHONPATH', ''))
    return env


@pytest.mark.parametrize('child', [False, True])
def test_no_card_no_number(child, tmp_path):
    """Without a card and without BENCH_DEVICE=cpu the twin (and its
    child) exits nonzero, prints no number and writes no cache."""
    assert not torch.cuda.is_available()
    knobs = dict(BENCH_LOCI=str(SMALL))
    if child:
        knobs['EVAL_CHILD'] = '1'
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, 'tools', 'eval_scaling_torch.py'),
         *(['3'] if child else [str(SMALL)])],
        env=_env(**knobs), cwd=str(tmp_path), capture_output=True,
        text=True, timeout=120)
    assert out.returncode != 0
    assert not re.search(r'\d', out.stdout)
    assert 'no CUDA device' in out.stderr


HBM_LINE = re.compile(r'^ *1 MiB footprint: +\d+\.\d GiB/s \(\d+\.\d\d '
                      r'ms/pass\)$')


def test_hbm_probe_line_format(monkeypatch, capsys):
    """bench_hbm_torch.py at 1 MiB on an explicit CPU device prints
    bench_hbm.py's device line and footprint line; without a card and
    without BENCH_DEVICE=cpu it exits before printing."""
    monkeypatch.setenv('HBM_SIZES', '1')
    monkeypatch.setenv('HBM_CHAIN', '3')
    monkeypatch.setenv('BENCH_DEVICE', 'cpu')
    bench_hbm_torch.main()
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == 'device: cpu'
    assert len(lines) == 2 and HBM_LINE.match(lines[1]), lines
    monkeypatch.delenv('BENCH_DEVICE')
    with pytest.raises(SystemExit) as exc:
        bench_hbm_torch.main()
    assert 'no CUDA device' in str(exc.value)
    assert capsys.readouterr().out == ''


def test_hbm_note_marks_footprints_near_the_l2():
    """On the card a footprint of at most twice the 50 MB L2 carries a
    note; larger ones and host lines are bench_hbm.py's alone."""
    cuda, cpu = torch.device('cuda'), torch.device('cpu')
    assert 'L2' in bench_hbm_torch.line(64, 2000.0, 0.03, cuda)
    assert bench_hbm_torch.line(256, 2500.0, 0.1, cuda) == \
        '  256 MiB footprint:  2500.0 GiB/s (0.10 ms/pass)'
    assert 'L2' not in bench_hbm_torch.line(64, 20.0, 3.0, cpu)


@pytest.mark.parametrize('K, grid', [(18, ''), (582, 'cli')])
def test_6m_state_choice_matches_bench(K, grid, monkeypatch, capsys):
    """At BENCH_SIZE=6m (6,000,000 SNPs, 2 cohorts) with BENCH_SCALE_SE=1
    bench_torch._epoch_b chooses what bench.py's rule chooses: the kdim
    state at K = 18 (0.80 GiB, under the 1 GiB rule) and the epoch state
    with B = 8 for the -K 12 grid's 582 components. Built from the sizes
    alone."""
    for mod in (bench, bench_torch):
        monkeypatch.setattr(mod, 'NUM_LOCI', 6_000_000)
        monkeypatch.setattr(mod, 'SCALE_SE', True)
        monkeypatch.setattr(mod, 'NUM_POPS', 2)
        monkeypatch.setattr(mod, 'EPOCH_B', 8)
        monkeypatch.setattr(mod, 'GRID', grid)
    want = bench._epoch_b(np.float32, K)
    got = bench_torch._epoch_b(torch.float32, K)
    assert got == want == (None if K == 18 else 8)
    out = capsys.readouterr().out
    assert (out.count('epoch-history representation, B=8') ==
            (0 if K == 18 else 2))


@pytest.mark.parametrize('dtype, u_dtype', [
    (torch.float64, torch.float64), (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize('blocks_a_chunk', [1, 2])
def test_diag_in_block_chunks_is_bit_for_bit(dtype, u_dtype, blocks_a_chunk,
                                             monkeypatch):
    """blocks.diag forms its [B, P, R] temporaries a chunk of blocks at a
    time (the 6M-SNP set-up's peak): any chunk size gives the bits of the
    whole bucket at once, on the three-block bucket of a 2,500-SNP panel
    and on a bucket of no block."""
    from vilma_tpu_torch.ops import blocks
    from vilma_tpu_torch.utils import synthetic
    ld = synthetic.synthetic_ld(2500, 1024, 0.5, seed=3, dtype=dtype,
                                u_dtype=u_dtype, device='cpu')
    whole = blocks.diag(ld)
    P, R = ld.buckets[0].u.shape[1:]
    monkeypatch.setattr(blocks, '_DIAG_CHUNK_ELEMS', blocks_a_chunk * P * R)
    assert torch.equal(blocks.diag(ld), whole)
    bk = ld.buckets[0]
    empty = type(bk)(**{f: getattr(bk, f)[:0] for f in (
        'u', 's', 'inv_s', 'd', 'perm', 'seq')})
    assert blocks._block_diags(empty).shape == (0, P)
