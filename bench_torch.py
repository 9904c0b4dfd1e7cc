"""Benchmark of the PyTorch port: VI coordinate-ascent iterations/s on
the card. bench.py's twin on vilma_tpu_torch.

    python3 bench_torch.py                   # both legs; the card's value
    BENCH_SIZE=1m python3 bench_torch.py     # genome scale
    python3 bench_torch.py --accel           # the card leg alone: ACCEL_IPS
    python3 bench_torch.py --mesh            # iters/s at 1/2/4/8 snp shards
    BENCH_DEVICE=cpu python3 bench_torch.py  # the host baseline leg alone

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline"} as its
last line, under bench.py's metric name for the same knobs. The knobs
are bench.py's: BENCH_SIZE (100k, 1m, 6m), BENCH_LOCI, BENCH_POPS (1-3),
BENCH_SCALE_SE, BENCH_EPOCH_B, BENCH_GRID=cli, BENCH_GRID_K,
BENCH_LD_DTYPE (the card leg stores U in bf16 unless f32),
BENCH_ACCEL_STEPS, BENCH_CPU_IPS, and for --mesh BENCH_MESH_POINTS and
BENCH_MESH_STEPS. BENCH_DEVICE (cuda by default) is the device of the
card leg; BENCH_DEVICE=cpu asks for the host: the baseline leg alone
(its value, vs_baseline 1.0), and --accel and --mesh on the host with
the kernels' plain versions.

The problem is bench.py's: the LD of synthetic_ld(NUM_LOCI, 1024, 0.5,
seed=0), the effect sizes, covariances (K = 18 ladder, or the CLI grid
with np.random.seed(42) before mixture.make_simple) and 4 annotation
categories from default_rng(1), and synthetic_state(compact=True) at
the state form the engine's size rule (_EPOCH_STATE_BYTES) selects.

What differs from bench.py:

* Timing. The port's outer step is a host loop (each line-search trial
  fetches its objective), so no chain of steps runs on the device as
  lax.fori_loop does there. A leg runs a warm-up chain of n steps, then
  times the best of 3 chains of n calls to engine.outer_step, each
  between two torch.cuda.synchronize() calls. An earlier line gives the
  host syncs a step and the kernel launches by name over the 3 chains.
* Baseline. The baseline leg is the port itself on device='cpu' at
  float64, through the kernels' plain versions. So vs_baseline is not
  bench.py's, whose baseline is XLA on the CPU.
* Cache. .bench_cache/torch_<tag>/ holds this twin's packed LD as torch
  tensors; bench.py's packed_* directories (uint16 views, JAX-only
  fields) are never read. A float32 leg casts a float64 pack of the same
  size where one exists (the bits blocks.pack would give).
* No fallback. Without a CUDA device, and without BENCH_DEVICE=cpu, the
  run exits nonzero and prints no JSON line; so does a card leg (or a
  --mesh point) that fails or times out in its subprocess.
* BENCH_PALLAS is not ported: on the card the CUDA kernels always run.
* --selftest is not ported: its counterpart is tests/test_torch_cuda.py
  and chip_smoke.py's phase 3.
* --mesh runs each point on the shard-local layout (parallel/alignment's
  relayout: fit --mesh snp=N's semantics), one card a shard where there
  are N cards, else the N shards co-located on cuda:0.

Imports nothing of JAX.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CACHE_DIR = os.path.join(REPO, '.bench_cache')

_SIZE = os.environ.get('BENCH_SIZE', '100k')
NUM_POPS = int(os.environ.get('BENCH_POPS', '2'))
if not 1 <= NUM_POPS <= 3:
    # the bench measures the compact-state fast path, which requires
    # the closed-form sigma algebra (models/sigma.py, P <= 3) — the
    # same gate as MultiPopVI._compact
    raise SystemExit(f'BENCH_POPS={NUM_POPS}: the benchmark supports '
                     '1-3 populations (compact state needs the '
                     'closed-form P<=3 sigma algebra)')
if os.environ.get('BENCH_LOCI'):
    NUM_LOCI = int(float(os.environ['BENCH_LOCI']))
    _SIZE = f'{NUM_LOCI}loci'
elif _SIZE == '6m':
    NUM_LOCI = 6_000_000
elif _SIZE == '1m':
    NUM_LOCI = 1_000_000
else:
    NUM_LOCI = 100_000
SCALE_SE = os.environ.get('BENCH_SCALE_SE', '0') == '1'
EPOCH_B = int(os.environ.get('BENCH_EPOCH_B', '8'))
GRID = os.environ.get('BENCH_GRID', '')
GRID_K = int(os.environ.get('BENCH_GRID_K', '12'))
NUM_COMPONENTS = 18
_KTAG = 'K18' if GRID != 'cli' else f'cligrid{GRID_K}'
_SIZETAG = (_SIZE if _SIZE in ('1m', '6m') or _SIZE.endswith('loci')
            else '100k')
METRIC = (f'vi_iterations_per_s_{_SIZETAG}'
          f'_snp_{NUM_POPS}pop_{_KTAG}'
          + ('_scale_se' if SCALE_SE else ''))
BLOCK_SIZE = 1024
RANK_FRAC = 0.5
N_STEPS = 5


def _accel_steps():
    """Steps per timed chain on the card leg (bench.py's lengths; each
    chain is one synchronized host-clock interval)."""
    if os.environ.get('BENCH_ACCEL_STEPS'):
        return int(os.environ['BENCH_ACCEL_STEPS'])
    if NUM_LOCI >= 6_000_000:
        return 5
    if NUM_LOCI >= 1_000_000:
        return 15
    return 100


def _leg_device():
    """The card leg's device: BENCH_DEVICE, cuda by default; a CUDA
    device that is absent raises (no fallback to the host)."""
    import torch
    device = torch.device(os.environ.get('BENCH_DEVICE', 'cuda'))
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise SystemExit('bench_torch.py: no CUDA device is available '
                         '(BENCH_DEVICE=cpu runs the host legs)')
    return device


def _ld_u_dtype():
    # BENCH_LD_DTYPE=bf16 stores the LD eigenvector tensors in bfloat16
    import torch
    if os.environ.get('BENCH_LD_DTYPE') == 'bf16':
        return torch.bfloat16
    return None


def _name(dtype):
    return str(dtype).replace('torch.', '')


def _ld_dir(dtype, u_dtype):
    return os.path.join(CACHE_DIR, f'torch_{NUM_LOCI}_{BLOCK_SIZE}_'
                        f'{RANK_FRAC}_{_name(dtype)}_{_name(u_dtype)}')


def _save_ld(ld, dirpath):
    """The PackedLD as one torch file (tensors moved to the host)."""
    import torch
    os.makedirs(dirpath, exist_ok=True)
    payload = dict(
        n=ld.n, has_diag=ld.has_diag, rank=ld.rank, missing=list(ld.missing),
        buckets=[{f.name: getattr(bk, f.name).cpu()
                  for f in dataclasses.fields(bk)} for bk in ld.buckets])
    tmp = os.path.join(dirpath, 'ld.pt.tmp')
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(dirpath, 'ld.pt'))


def _load_ld(dirpath, device):
    import torch
    from vilma_tpu_torch.ops.blocks import BlockBucket, PackedLD
    payload = torch.load(os.path.join(dirpath, 'ld.pt'), map_location='cpu',
                         mmap=True, weights_only=True)
    return PackedLD(
        buckets=tuple(BlockBucket(**{k: v.to(device) for k, v in bk.items()})
                      for bk in payload['buckets']),
        n=payload['n'], has_diag=payload['has_diag'], rank=payload['rank'],
        missing=tuple(payload['missing']))


def _cast_ld(ld, dtype, u_dtype):
    """A float64 PackedLD at `dtype` with U in `u_dtype`: the bits
    blocks.pack gives at those types (U staged in float32 below
    float64, then rounded once)."""
    import torch
    stage = torch.float64 if dtype == torch.float64 else torch.float32
    return dataclasses.replace(ld, buckets=tuple(dataclasses.replace(
        bk, u=bk.u.to(stage).to(u_dtype), s=bk.s.to(dtype),
        inv_s=bk.inv_s.to(dtype), d=bk.d.to(dtype)) for bk in ld.buckets))


def _cached_ld(dtype, device):
    """The packed synthetic LD at `dtype` (U in BENCH_LD_DTYPE) on
    `device`: from this twin's cache, cast from its float64 pack, or
    factored (synthetic_ld: on the card where `device` is one) and
    cached."""
    import torch
    from vilma_tpu_torch.utils import synthetic
    u_dtype = _ld_u_dtype() or dtype
    path = _ld_dir(dtype, u_dtype)
    if os.path.exists(os.path.join(path, 'ld.pt')):
        return _load_ld(path, device)
    base = _ld_dir(torch.float64, torch.float64)
    t0 = time.perf_counter()
    if dtype != torch.float64 and os.path.exists(os.path.join(base,
                                                              'ld.pt')):
        ld = _cast_ld(_load_ld(base, device), dtype, u_dtype)
        how = 'cast from the float64 pack'
    else:
        ld = synthetic.synthetic_ld(NUM_LOCI, BLOCK_SIZE, RANK_FRAC, seed=0,
                                    dtype=dtype, u_dtype=u_dtype,
                                    device=device)
        how = f'factored on {device}'
    print(f'LD {NUM_LOCI} SNPs, U {_name(u_dtype)}: {how} in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    _save_ld(ld, path)
    return ld


def _make_covs(rng, P, betas, std_errs):
    """Mixture components: the K=18 synthetic ladder, or — BENCH_GRID=cli
    — the production covariance grid the `fit` CLI builds."""
    if GRID == 'cli':
        from vilma_tpu_torch.models import mixture
        np.random.seed(42)       # make_simple draws from the global RNG
        mins, maxes = mixture.effect_size_ranges(betas, std_errs, False)
        # 3-cohort grids need `fit --drop-non-psd` (mixture.make_simple)
        covs = mixture.make_simple(P, GRID_K, mins, maxes,
                                   drop_non_psd=(P >= 3))
        print(f'BENCH_GRID=cli: {len(covs)} mixture components '
              f'(-K {GRID_K}, {P} cohorts)', flush=True)
        return covs
    scales = np.exp(np.linspace(np.log(1e-6), np.log(1e-2),
                                NUM_COMPONENTS))
    covs = []
    for k in range(NUM_COMPONENTS):
        a = rng.standard_normal((P, P))
        corr = 0.3 * (a @ a.T) + P * np.eye(P)
        d = 1 / np.sqrt(np.diag(corr))
        covs.append(scales[k] * (corr * np.outer(d, d)))
    return covs


def _inputs():
    """bench.py's effect sizes, standard errors, covariances and one-hot
    annotations (4 categories), drawn from default_rng(1)."""
    rng = np.random.default_rng(1)
    P = NUM_POPS
    std_errs = rng.uniform(0.01, 0.05, (P, NUM_LOCI))
    betas = rng.standard_normal((P, NUM_LOCI)) * std_errs * 2
    covs = _make_covs(rng, P, betas, std_errs)
    annotations = np.zeros((NUM_LOCI, 4))
    annotations[np.arange(NUM_LOCI), rng.integers(0, 4, NUM_LOCI)] = 1
    return betas, std_errs, covs, annotations


def _model(betas, std_errs, ld, annotations, covs, dtype, device):
    import torch
    from vilma_tpu_torch.inference import engine
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    P = NUM_POPS
    return engine.build_model_data(
        betas.astype(np_dtype), std_errs.astype(np_dtype), [ld] * P,
        annotations, covs, scaled=False, scale_se=SCALE_SE,
        gwas_N=np.full(P, 1e5), init_hg=np.full(P, 0.3), dtype=dtype,
        device=device)


def _build(dtype, device):
    """(ModelData, VIState) of bench.py's problem on `device`."""
    from vilma_tpu_torch.utils import synthetic
    ld = _cached_ld(dtype, device)
    betas, std_errs, covs, annotations = _inputs()
    data = _model(betas, std_errs, ld, annotations, covs, dtype, device)
    state = synthetic.synthetic_state(
        data, compact=True, epoch_b=_epoch_b(dtype, len(covs)))
    return data, state


def _epoch_b(dtype, num_covs):
    """Epoch-buffer size when the production selection (MultiPopVI)
    would pick the epoch-history state for this config; None = the kdim
    state (exactly the engine's own rule)."""
    if not SCALE_SE:
        return None
    import torch
    from vilma_tpu_torch.inference import engine
    kdim_bytes = (num_covs * NUM_POPS * NUM_LOCI
                  * torch.empty(0, dtype=dtype).element_size())
    if kdim_bytes <= engine._EPOCH_STATE_BYTES:
        return None
    print(f'scale_se state: epoch-history representation, B={EPOCH_B} '
          f'(kdim state would be {kdim_bytes / 2**30:.1f} GiB)',
          flush=True)
    return EPOCH_B


def _devices(data):
    from vilma_tpu_torch.inference import engine
    shards = (data.shards if isinstance(data, engine.ShardedData)
              else (data,))
    return sorted({d.marginal_effects.device for d in shards}, key=str)


def _sync(devices):
    import torch
    for device in devices:
        if device.type == 'cuda':
            torch.cuda.synchronize(device)


def _bench_steps(data, state, n_steps):
    """(iterations/s, host syncs a step, launches by kernel): a warm-up
    chain of `n_steps` outer steps, then the best of 3 timed chains, each
    between two synchronizations of the card(s). The launches are
    counted over the 3 timed chains as chip_smoke.py counts them."""
    from chip_smoke import read_counts, zero_counts
    from vilma_tpu_torch.inference import engine
    devices = _devices(data)

    def chain(st):
        for _ in range(n_steps):
            st, _ = engine.outer_step(data, st, line_search_rate=2.0)
        return st

    state = chain(state)
    _sync(devices)
    zero_counts()
    syncs0 = engine.host_syncs
    best = float('inf')
    for _ in range(3):
        _sync(devices)
        t0 = time.perf_counter()
        state = chain(state)
        _sync(devices)
        best = min(best, time.perf_counter() - t0)
    if not math.isfinite(state.elbo):
        raise RuntimeError(f'non-finite ELBO after the timed chains: '
                           f'{state.elbo}')
    return (n_steps / best, (engine.host_syncs - syncs0) / (3 * n_steps),
            read_counts())


def _device_name(device):
    import torch
    return (torch.cuda.get_device_name(device) if device.type == 'cuda'
            else 'cpu')


def accel_main():
    """The card leg: float32, U in bf16 unless BENCH_LD_DTYPE=f32.
    Prints ACCEL_LAUNCHES (the metric, the device, host syncs a step,
    launches by kernel) and ACCEL_IPS."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ.setdefault('BENCH_LD_DTYPE', 'bf16')
    device = _leg_device()
    data, state = _build(torch.float32, device)
    ips, syncs, counts = _bench_steps(data, state, _accel_steps())
    print('ACCEL_LAUNCHES', json.dumps(dict(
        metric=METRIC, device=_device_name(device),
        host_syncs_per_step=syncs, launches=counts)), flush=True)
    print('ACCEL_IPS', ips, flush=True)


def _run_accel_subprocess(timeout_s=None):
    """The card leg in a subprocess; its output is relayed. Returns its
    iterations/s, or None when it failed or timed out."""
    if timeout_s is None:
        timeout_s = 1500
        if NUM_LOCI >= 1_000_000:
            timeout_s = 2900
        if NUM_LOCI >= 6_000_000:
            timeout_s = 5400
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    try:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), '--accel'],
            capture_output=True, text=True, timeout=timeout_s, env=env)
    except subprocess.TimeoutExpired:
        print(f'CARD LEG TIMED OUT after {timeout_s}s', file=sys.stderr)
        return None
    print(out.stdout, end='', flush=True)
    for line in out.stdout.splitlines():
        if line.startswith('ACCEL_IPS') and out.returncode == 0:
            return float(line.split()[1])
    print(f'CARD LEG FAILED (exit {out.returncode}, no ACCEL_IPS); stderr '
          'tail:', file=sys.stderr)
    print(out.stderr[-2000:], file=sys.stderr)
    return None


def main():
    import torch
    device = _leg_device()
    if os.environ.get('BENCH_CPU_IPS'):
        cpu_ips = float(os.environ['BENCH_CPU_IPS'])
    else:
        data64, state64 = _build(torch.float64, torch.device('cpu'))
        cpu_ips, syncs, _ = _bench_steps(data64, state64, N_STEPS)
        print(f'baseline leg (cpu, float64, plain versions): {cpu_ips!r} '
              f'iters/s, {syncs} host syncs a step', flush=True)
    value = cpu_ips
    if device.type == 'cpu':
        print('BENCH_DEVICE=cpu: the value is the host baseline leg; no '
              'card was measured', flush=True)
    else:
        value = _run_accel_subprocess()
        if value is None:
            sys.exit(1)
    print(json.dumps({
        'metric': METRIC,
        'value': round(value, 3),
        'unit': 'iters/s',
        'vs_baseline': round(value / cpu_ips, 3),
    }))


def _mesh_devices(n, device):
    """One card a shard where there are n cards, else n shards co-located
    on `device`."""
    import torch
    if device.type == 'cuda' and torch.cuda.device_count() >= n:
        return [torch.device('cuda', j) for j in range(n)]
    return [device] * n


def _build_mesh(dtype, n_shards, device):
    """Shard-local problem for the mesh scaling leg: _build's fit
    relayouted into n_shards shard-local spans (parallel/alignment), its
    synthetic state drawn at the layout's length, both placed on a snp
    mesh."""
    from vilma_tpu_torch.parallel import alignment, mesh as mesh_mod
    from vilma_tpu_torch.utils import synthetic
    ld = _cached_ld(dtype, device)
    betas, std_errs, covs, annotations = _inputs()
    mesh = mesh_mod.make_mesh(n_shards, devices=_mesh_devices(n_shards,
                                                              device))
    lmap, L, ok = alignment.compute_layout([ld], NUM_LOCI,
                                           n_shards=n_shards)
    if not ok:
        raise RuntimeError('bench LD blocks must be contiguous ranges')
    lds = alignment.relayout_ld(ld, lmap, L, dtype=dtype,
                                u_dtype=_ld_u_dtype(), device=device)
    data = _model(alignment.relayout_rows(betas, lmap, L, fill=0.0),
                  alignment.relayout_rows(std_errs, lmap, L, fill=1.0), lds,
                  alignment.relayout_annotations(annotations, lmap, L),
                  covs, dtype, device)
    state = synthetic.synthetic_state(
        data, compact=True, epoch_b=_epoch_b(dtype, len(covs)))
    return (mesh, mesh_mod.shard_data(data, mesh),
            mesh_mod.shard_state(state, mesh))


def mesh_worker_main():
    """One point of the scaling curve (a subprocess of mesh_main)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    n = int(os.environ['BENCH_MESH_N'])
    device = _leg_device()
    _, data, state = _build_mesh(torch.float32, n, device)
    ips, syncs, counts = _bench_steps(data, state, int(os.environ.get(
        'BENCH_MESH_STEPS', '5')))
    print('MESH_LAUNCHES', n, json.dumps(dict(
        device=_device_name(device), host_syncs_per_step=syncs,
        launches=counts)), flush=True)
    print('MESH_IPS', n, ips, flush=True)


def mesh_main():
    """Scaling curve: iters/s at 1/2/4/8 snp shards (BENCH_MESH_POINTS),
    each point a subprocess; a point that fails makes the run exit
    nonzero with no JSON line."""
    _leg_device()
    points = [int(x) for x in os.environ.get(
        'BENCH_MESH_POINTS', '1,2,4,8').split(',')]
    curve = {}
    for n in points:
        env = dict(os.environ)
        env['BENCH_MESH_N'] = str(n)
        env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), '--mesh-worker'],
            capture_output=True, text=True, timeout=3600, env=env)
        print(out.stdout, end='', flush=True)
        for line in out.stdout.splitlines():
            if line.startswith('MESH_IPS') and out.returncode == 0:
                curve[n] = float(line.split()[2])
        if n not in curve:
            print(f'mesh point N={n} failed:\n{out.stderr[-1500:]}',
                  file=sys.stderr)
            sys.exit(1)
    base = curve[points[0]]
    print(json.dumps({
        'metric': f'mesh_scaling_iters_per_s_{_SIZE}_snp',
        'value': curve[max(curve)],
        'unit': 'iters/s',
        'curve': curve,
        'relative': {n: round(v / base, 3) for n, v in curve.items()},
    }))


if __name__ == '__main__':
    if '--mesh-worker' in sys.argv:
        mesh_worker_main()
    elif '--mesh' in sys.argv:
        mesh_main()
    elif '--accel' in sys.argv:
        accel_main()
    else:
        main()
