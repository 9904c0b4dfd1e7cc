"""tools/drift_genome_torch.py, tools/drift_genome.py's twin on
vilma_tpu_torch, on the CPU.

(a) Its --compare report equals the JAX tool's on the same two .npz
    files, key for key and exactly.
(b) Its loop at f64 on the host (the f64cpu leg's) matches the JAX
    tool's loop on vilma_tpu's engine at f64 on bench.py's problem at
    4,096 SNPs over 8 outer steps: posterior mean, marginal variance and
    both ELBOs within 1e-10 of scale, the same convergence flags.
(c) Its f32cpu leg against its f64cpu leg at 16,384 SNPs over 20 steps,
    each leg a process, within tests/test_f32_genome_scale.py's bands
    (the tool's out_of_band, the ELBO accumulator gated). Measured on
    the host with torch 2.13, one thread: posterior means 4.0e-5
    posterior SDs apart at the 99.9% quantile (band 2), none beyond 3
    SDs (band 2e-3), the median absolute difference 9.9e-9 of the
    posterior scale (band 1e-3), the recomputed ELBOs 1.3e-6 apart (band
    5e-3), the f32 accumulator within 1.4e-7 of its recomputed ELBO
    (band 1e-5) and the f64 one within 2.6e-16 (band 1e-9); neither
    converges in 20 steps.
(d) --block-size 2048 packs 2048-SNP blocks at rank 1024, which the
    matvec planner puts on the group route; bench_torch's default stays
    1024-SNP blocks on the cluster route.
(e) slow: the 100K twin of tests/test_f32_genome_scale.py on the port
    (f32 against f64 on the host, 50 outer steps, its bounds).

A card leg without a CUDA device exits nonzero and writes nothing.
"""
import functools
import importlib.util
import json
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
from vilma_tpu_torch.ops.cuda import block_matvec

# tier-1 runs the suite under xdist workers; one intra-op thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, 'tools', 'drift_genome_torch.py')


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, 'tools', f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


drift = _tool('drift_genome_torch')
jdrift = _tool('drift_genome')


def _env(**knobs):
    """The test process's environment without any BENCH_ knob, plus
    `knobs`, one intra-op thread, and the repo importable."""
    env = {k: v for k, v in os.environ.items() if not k.startswith('BENCH_')}
    env.update(knobs, OMP_NUM_THREADS='1', MKL_NUM_THREADS='1',
               PYTHONPATH=REPO + os.pathsep + env.get('PYTHONPATH', ''))
    return env


def _copy_tool(root):
    """bench_torch.py and the tool copied under `root` (the LD cache lands
    in root/.bench_cache, not in the repo); returns the tool's path."""
    os.makedirs(os.path.join(root, 'tools'), exist_ok=True)
    shutil.copy(os.path.join(REPO, 'bench_torch.py'), root)
    shutil.copy(TOOL, os.path.join(root, 'tools'))
    return os.path.join(root, 'tools', 'drift_genome_torch.py')


def _write(path, leg, rng, n, conv_at, base=None):
    """A leg's .npz of the tools' keys: `base`'s posterior plus noise, or
    a fresh draw; convergence flags from iteration `conv_at` on."""
    post = rng.standard_normal((2, n)) * 1e-3
    if base is not None:
        post = base + rng.standard_normal((2, n)) * 1e-5
    pmv = rng.uniform(-1e-9, 1e-6, (2, n))
    pmv[0, :5] = 0.0
    conv = np.zeros(40, bool)
    if conv_at is not None:
        conv[conv_at:] = True
        conv[conv_at + 2] = False
    true = -3.6e5 + rng.standard_normal()
    np.savez(path, leg=leg, post=post, pmv=pmv, acc=true * (1 + 1e-7),
             true=true, conv=conv, launches='{}', device='cpu',
             seconds=1.0)
    return post


@pytest.mark.parametrize('conv', [(None, None), (7, 9), (None, 12),
                                  (30, None)],
                         ids=['neither', 'both', 'test-only', 'base-only'])
def test_compare_equals_the_jax_tool(conv, tmp_path, capsys):
    """(a) On the same two files both tools' reports are equal, every key
    and value exactly, and print the same JSON."""
    rng = np.random.default_rng(5)
    b, t = str(tmp_path / 'b.npz'), str(tmp_path / 't.npz')
    post = _write(b, 'f64cpu', rng, 3000, conv[0])
    _write(t, 'f32cuda', rng, 3000, conv[1], base=post)
    want = jdrift.compare(b, t)
    want_out = capsys.readouterr().out
    got = drift.compare(b, t)
    assert capsys.readouterr().out == want_out
    assert list(got) == list(want)
    for key in want:
        assert got[key] == want[key], key
        assert type(got[key]) is type(want[key]), key


def _jax_fit(data, st, iters):
    """tools/drift_genome.py:74-107 on vilma_tpu's engine."""
    step = jax.jit(functools.partial(jengine.outer_step_impl,
                                     line_search_rate=2.0))
    conv = []
    post_prev = None
    for _ in range(iters):
        st, _ = step(data, st)
        m = jengine.materialize_state(data, st)
        pm = np.asarray(jengine.posterior_mean(m.vi_mu, m.vi_delta))
        red = float(st.running_elbo_delta)
        c = (post_prev is not None
             and np.allclose(pm, post_prev, atol=jengine.ABS_TOL,
                             rtol=jengine.REL_TOL)
             or np.isclose(red, 0, atol=jengine.ELBO_TOL, rtol=0))
        conv.append(bool(c))
        post_prev = pm
    m = jengine.materialize_state(data, st)
    post = np.asarray(jengine.posterior_mean(m.vi_mu, m.vi_delta))
    pmv = np.asarray(jengine.posterior_marginal_variance(
        jengine.posterior_mean(m.vi_mu, m.vi_delta), m.vi_mu, m.vi_delta,
        m.sigma))
    true = float(jengine.elbo_jit(data, m.sigma, m.error_scaling, m.vi_mu,
                                  m.vi_delta, m.hyper_delta))
    return dict(post=post, pmv=pmv, acc=float(st.elbo), true=true,
                conv=np.asarray(conv))


def test_f64_leg_matches_vilma_tpu(tmp_path, monkeypatch):
    """(b) The f64cpu leg's loop (drift_genome_torch.fit) on
    bench_torch._build's problem against the JAX tool's loop on
    bench._build's, at 4,096 SNPs and 8 outer steps, float64 on the host:
    outputs within 1e-10 of their scale, the flags equal."""
    for mod, sub in ((bench, 'jax'), (bench_torch, 'torch')):
        monkeypatch.setattr(mod, 'NUM_LOCI', 4096)
        monkeypatch.setattr(mod, 'CACHE_DIR', str(tmp_path / sub))
    monkeypatch.delenv('BENCH_LD_DTYPE', raising=False)
    jdata, jst = bench._build(np.float64, jax.devices('cpu')[0])
    want = _jax_fit(jdata, jst, 8)
    tdata, tst = bench_torch._build(torch.float64, torch.device('cpu'))
    got = drift.fit(tdata, tst, 8, report_every=0)
    for key in ('post', 'pmv'):
        scale = np.abs(want[key]).max()
        assert np.abs(got[key] - want[key]).max() <= 1e-10 * scale, key
    for key in ('acc', 'true'):
        assert abs(got[key] - want[key]) <= 1e-10 * abs(want[key]), key
    np.testing.assert_array_equal(got['conv'], want['conv'])
    assert got['conv'].shape == (8,)


def test_f32_leg_within_the_bands_of_the_f64_leg(tmp_path):
    """(c) The f32cpu and f64cpu legs, each a process of the tool at
    16,384 SNPs and 20 steps: the f32 leg within the bands (accumulator
    gated); the JAX tool's compare reads the same on these files, but
    for 'iters', which it fixes at 40; the files carry the tool's extra
    keys, every launch 0 on the host."""
    tool = _copy_tool(str(tmp_path))
    env = _env(BENCH_LOCI='16384')
    procs = {leg: subprocess.Popen(
        [sys.executable, tool, '--leg', leg, '--out',
         str(tmp_path / f'{leg}.npz'), '--iters', '20'], env=env,
        cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for leg in ('f64cpu', 'f32cpu')}
    for leg, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
        assert f'leg={leg} device=cpu' in out
    b, t = (str(tmp_path / f'{leg}.npz') for leg in ('f64cpu', 'f32cpu'))
    rep = drift.compare(b, t)
    assert rep['iters'] == 20 and rep['test'] == 'f32cpu'
    assert drift.out_of_band(rep) == [], rep
    want = jdrift.compare(b, t)
    assert want['iters'] == jdrift.ITERS
    assert {k: v for k, v in rep.items() if k != 'iters'} == \
        {k: v for k, v in want.items() if k != 'iters'}
    for path in (b, t):
        f = np.load(path)
        assert str(f['device']) == 'cpu' and float(f['seconds']) > 0
        launches = json.loads(str(f['launches']))
        assert 'prologue' in launches and not any(launches.values())
        assert f['post'].shape == f['pmv'].shape == (2, 16384)


def test_block_size_2048_takes_the_group_route(tmp_path, monkeypatch):
    """(d) --block-size 2048 (drift_genome_torch passes it to
    bench_torch._build): a 2048-SNP block at rank 1024 beside the 100-SNP
    tail's bucket, cached under its own key; the planner puts the
    2048-SNP bucket on the group route at f32 and at bf16 U. Without the
    option, bench_torch keeps bench.py's 1024-SNP blocks on the cluster
    route."""
    monkeypatch.setattr(bench_torch, 'NUM_LOCI', 2148)
    monkeypatch.setattr(bench_torch, 'CACHE_DIR', str(tmp_path))
    monkeypatch.delenv('BENCH_LD_DTYPE', raising=False)
    assert bench_torch._ld_dir(torch.float64, torch.float64).endswith(
        'torch_2148_1024_0.5_float64_float64')
    cpu = torch.device('cpu')
    data, _ = bench_torch._build(torch.float32, cpu, block_size=2048)
    assert os.path.exists(tmp_path / 'torch_2148_2048_0.5_float32_float32'
                          / 'ld.pt')
    tail, big = sorted(tuple(bk.u.shape) for bk in data.ld[0].buckets)
    assert big == (1, 2048, 1024) and tail[0] == 1 and tail[1] < 1024
    assert block_matvec.plan(2048, 1024, 4, 2).route == 'group'
    assert drift.matvec_keys(data) == ['bucket_matvec_multi',
                                       'bucket_matvec_multi_group']
    monkeypatch.setenv('BENCH_LD_DTYPE', 'bf16')
    data, _ = bench_torch._build(torch.float32, cpu, block_size=2048)
    assert {bk.u.dtype for bk in data.ld[0].buckets} == {torch.bfloat16}
    assert drift.matvec_keys(data) == [
        'bucket_matvec_multi', 'bucket_matvec_multi_group',
        'bucket_matvec_multi_group_bf16']
    monkeypatch.delenv('BENCH_LD_DTYPE')
    data, st = bench_torch._build(torch.float32, cpu)
    assert max(tuple(bk.u.shape) for bk in data.ld[0].buckets) == (
        2, 1024, 512)
    assert drift.matvec_keys(data) == ['bucket_matvec_multi']
    assert drift.state_kernels(st) == ('prologue', 'delta_sums')


def test_f32_inner_product_holds_at_genome_scale():
    """The beta-KL's quadratic term (kernels.fast_inner_product_comp, in
    engine.beta_KL and so in every recomputed ELBO) at K = 18 and 1M
    SNPs in f32 on the host, within 1e-6 of its f64 value. As an
    einsum('ki,ki->') it was one f32 dot of 18M terms on the CPU, 1.7e-5
    off: the host f32 legs' accumulated ELBO parted from the recomputed
    one by 4.4e-5 at 1M SNPs, where the card's stayed within 1.5e-7."""
    from vilma_tpu_torch.ops import kernels
    rng = np.random.default_rng(7)
    K, P, n = 18, 1, 1_000_000
    vi_mu = rng.standard_normal((K, P, n)) * 1e-2
    prec = 10.0 ** rng.uniform(2, 6, (K, P, P))
    vi_delta = rng.dirichlet(np.ones(K), n).T
    want = kernels.fast_inner_product_comp(
        *(torch.from_numpy(x) for x in (vi_mu, prec, vi_delta))).item()
    got = kernels.fast_inner_product_comp(
        *(torch.from_numpy(x.astype(np.float32))
          for x in (vi_mu, prec, vi_delta))).item()
    assert abs(got - want) <= 1e-6 * abs(want), (got, want)


@pytest.mark.parametrize('leg', ['f32cuda', 'bf16cuda'])
def test_card_leg_without_a_card_raises(leg, tmp_path):
    """A card leg on a machine without CUDA exits nonzero, says so and
    writes no file: it never runs on the host instead."""
    assert not torch.cuda.is_available()
    tool = _copy_tool(str(tmp_path))
    out = subprocess.run(
        [sys.executable, tool, '--leg', leg, '--out',
         str(tmp_path / 'x.npz')], env=_env(BENCH_LOCI='2048'),
        cwd=str(tmp_path), capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert 'needs a CUDA device' in out.stderr
    assert not os.path.exists(tmp_path / 'x.npz')
    assert not os.path.exists(tmp_path / '.bench_cache')


@pytest.mark.slow
def test_f32_drift_bounded_at_genome_scale_on_the_port(tmp_path,
                                                       monkeypatch):
    """(e) tests/test_f32_genome_scale.py on the port: bench.py's problem
    at 100K SNPs (2 cohorts, K = 18, 1024-SNP blocks at half rank), 50
    outer steps at f64 and at f32 on the host, held to that test's
    bounds: the accumulated ELBO within 1e-9 (f64) and 1e-5 (f32) of the
    recomputed one, 99.9% of SNPs within 2 posterior SDs, at most 0.2%
    beyond 3, the median absolute difference below 1e-3 of the scale,
    the recomputed ELBOs within 5e-3, first convergence within 2."""
    monkeypatch.setattr(bench_torch, 'NUM_LOCI', 100_000)
    monkeypatch.setattr(bench_torch, 'CACHE_DIR', str(tmp_path))
    monkeypatch.delenv('BENCH_LD_DTYPE', raising=False)
    paths = []
    for leg, dtype in (('f64cpu', torch.float64), ('f32cpu', torch.float32)):
        data, st = bench_torch._build(dtype, torch.device('cpu'))
        out = drift.fit(data, st, 50, report_every=0)
        path = str(tmp_path / f'{leg}.npz')
        np.savez(path, leg=leg, **{k: out[k] for k in (
            'post', 'pmv', 'acc', 'true', 'conv')})
        paths.append(path)
    rep = drift.compare(*paths)
    assert drift.out_of_band(rep) == [], rep
