"""Smoke run of the PyTorch + CUDA port (vilma_tpu_torch) on one GPU.

    python3 chip_smoke.py     # every phase, one CUDA device

Phases:
  1. device: the card's name and power limit; refuses without CUDA.
  2. build: nvcc builds the kernels from vilma_tpu_torch/csrc.
  3. kernels: each CUDA kernel against its plain PyTorch version on the
     card at main-path shapes, within a stated band, bit-for-bit
     repeatable, with CUDA-event times of both.
  4. fit: `vilma-tpu-torch fit` in-process on a synthetic on-disk schema
     the size of a per-chromosome HapMap3 fit (~90K variants in
     1024-SNP AR(1) blocks at half rank, 2 cohorts sharing the panel) at
     the default -K 12 grid (582 components), f32 with bf16 LD, which
     takes the streamed output route. The kernel launch counters are
     zeroed just before and read just after: every kernel must launch.
     Then a 2-block fit on the card (f32) is held against the same fit
     on the host at f64.
  5. engine: 1M SNPs (977 blocks of 1024), 2 cohorts, K = 18, bf16 U;
     3 timed outer steps after one warm-up step.

The next-to-last line is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Any failed phase exits
nonzero before those lines are printed. Imports nothing of JAX.
"""
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# kernel-vs-plain bands, relative to max|plain|:
#  * f32 results: the kernel and the plain version sum in different
#    orders (f32 accumulators, ~1e-7 per rounding, growing with the
#    number of terms);
#  * bf16 U: t = s * U^T x is rounded to bf16 after an f32 sum whose
#    order differs, so an element on a rounding boundary can land on the
#    neighbouring bf16 value: one bf16 ulp, 2**-8, of the scale. That
#    band alone would also pass a kernel that skips rounding x or t, so
#    check_matvec also holds the kernel closer to the plain version than
#    either half-rounded product is.
BAND_F32 = 1e-5
BAND_BF16 = 2.0 ** -8
# the beta-KL scalar sums ~1e6 * K signed terms: relative band
BAND_KL = 1e-4
# a 5-step f32 fit (f32 LD) against the f64 fit of the same input, per
# posterior column relative to its scale: the host's own f32 fit of that
# input lands within 2.5e-5 and the card's within 2.83e-5; the band
# leaves the kernels' accumulation-order noise ~7x room
BAND_FIT = 2e-4

KERNELS = {
    'bucket_matvec_multi': dict(
        source='vilma_tpu_torch/csrc/block_matvec.cu',
        replaces='vilma_tpu/ops/pallas/block_matvec.py:88'),
    'prologue': dict(
        source='vilma_tpu_torch/csrc/compact_obj.cu',
        replaces='vilma_tpu/ops/pallas/compact_obj.py:414'),
    'delta_sums': dict(
        source='vilma_tpu_torch/csrc/compact_obj.cu',
        replaces='vilma_tpu/ops/pallas/compact_obj.py:653'),
}


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps=20, warmup=3):
    """Mean milliseconds per call from CUDA events around `reps` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def paired_ms(kernel_fn, plain_fn, reps=20):
    """(kernel ms, plain ms), measured in turns plain, kernel, kernel,
    plain and averaged per version."""
    p1 = cuda_ms(plain_fn, reps)
    k1 = cuda_ms(kernel_fn, reps)
    k2 = cuda_ms(kernel_fn, reps)
    p2 = cuda_ms(plain_fn, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def max_err(got, want):
    """(max abs error, max abs error / max |want|)."""
    import torch
    got = got.double()
    want = want.double()
    err = float(torch.max(torch.abs(got - want)))
    scale = float(torch.max(torch.abs(want)))
    return err, err / scale if scale > 0 else err


# ---------------------------------------------------------------------------
# phase 3: kernel checks
# ---------------------------------------------------------------------------

def synthetic_covs(P, K, seed):
    """K mixture covariances with log-spaced scales and random
    correlations (vilma_tpu's synthetic_problem construction)."""
    rng = np.random.default_rng(seed)
    scales = np.exp(np.linspace(np.log(1e-6), np.log(1e-2), K))
    covs = []
    for k in range(K):
        a = rng.standard_normal((P, P))
        corr = 0.3 * (a @ a.T) + P * np.eye(P)
        dd = 1 / np.sqrt(np.diag(corr))
        covs.append(scales[k] * (corr * np.outer(dd, dd)))
    return np.array(covs)


def half_rounded_matvec(u, s, d, x, round_x):
    """The bf16-U product with only x (round_x) or only t rounded to
    bf16: what a kernel that skipped the other rounding would give."""
    import torch
    uf = u.float()
    xr = x.to(torch.bfloat16).float() if round_x else x
    t = torch.einsum('bpr,bcp->bcr', uf, xr) * s[:, None, :]
    if not round_x:
        t = t.to(torch.bfloat16).float()
    return torch.einsum('bpr,bcr->bcp', uf, t) + d[:, None, :] * x


def check_matvec(device, results, B=977, P=1024, R=512, C=2):
    import torch
    from vilma_tpu_torch.ops.cuda import block_matvec as bm
    gen = torch.Generator(device=device).manual_seed(3)
    x = torch.randn(B, C, P, generator=gen, device=device)
    s = torch.rand(B, R, generator=gen, device=device) * 1.9 + 0.1
    d = torch.rand(B, P, generator=gen, device=device)
    for u_dtype, band in ((torch.bfloat16, BAND_BF16),
                          (torch.float32, BAND_F32)):
        u = (torch.randn(B, P, R, generator=gen, device=device)
             / math.sqrt(P)).to(u_dtype)
        y = bm.bucket_matvec_multi(u, s, d, x)
        y2 = bm.bucket_matvec_multi(u, s, d, x)
        ref = bm.bucket_matvec_multi_plain(u, s, d, x)
        torch.cuda.synchronize()
        err, rel = max_err(y, ref)
        repeat = bool(torch.equal(y, y2))
        ms, plain_ms = paired_ms(
            lambda: bm.bucket_matvec_multi(u, s, d, x),
            lambda: bm.bucket_matvec_multi_plain(u, s, d, x))
        ubytes = u.numel() * u.element_size()
        name = f'bucket_matvec_multi u={str(u_dtype)[6:]} B={B} P={P} R={R} C={C}'
        log(f'  {name}: max_abs_err {err:.3e} scaled {rel:.3e} (band '
            f'{band:.1e}) repeatable {repeat}; kernel {ms:.4f} ms '
            f'({ubytes / ms / 1e6:.1f} GB/s of U), plain {plain_ms:.4f} ms')
        require(rel <= band, f'{name} outside its band')
        require(repeat, f'{name} not bit-for-bit repeatable')
        if u_dtype == torch.bfloat16:
            # the rounding of x and of t both matter: the kernel must sit
            # closer to the plain version than a product missing either
            half = [max_err(half_rounded_matvec(u, s, d, x, rx), ref)[1]
                    for rx in (True, False)]
            log(f'    scaled error of the product rounding only x '
                f'{half[0]:.3e}, only t {half[1]:.3e}')
            require(rel < min(half), f'{name} is no closer to the plain '
                    'version than a product that skips a bf16 rounding')
            results['bucket_matvec_multi'] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms)


def compact_inputs(device, P, K, I, A, seed):
    import torch
    from vilma_tpu_torch.ops.cuda import compact_obj as co
    rng = np.random.default_rng(seed)
    covs = synthetic_covs(P, K, seed)
    prec = np.linalg.inv(covs)
    log_det = np.linalg.slogdet(covs)[1]
    hd = rng.uniform(0.1, 1.0, (A, K))
    hd /= hd.sum(axis=1, keepdims=True)
    ann = rng.integers(0, A, I).astype(np.int32)
    ann[rng.random(I) < 0.01] = A                      # ~1% pad SNPs
    dterm = 1.0 / rng.uniform(0.01, 0.05, (P, I)) ** 2
    nat = rng.standard_normal((P, I)) * 0.5

    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a),
                               dtype=torch.float32, device=device)

    coeffs = co.build_coeffs(f32(prec), f32(log_det)).contiguous()
    scores_t = f32((np.log(hd) - 0.5 * log_det).T)
    return (coeffs, scores_t, torch.as_tensor(ann, device=device),
            f32(dterm), f32(nat))


def check_compact(device, results, I=1_000_000, A=4):
    import torch
    from vilma_tpu_torch.ops.cuda import compact_obj as co
    for P in (1, 2, 3):
        for K in (18, 582):
            args = compact_inputs(device, P, K, I, A, seed=10 * P + K)
            kw = dict(num_annotations=A)
            pm, pv, kl = co.prologue(*args, **kw)
            pm2, pv2, kl2 = co.prologue(*args, **kw)
            rpm, rpv, rkl = co.prologue_plain(*args, **kw)
            torch.cuda.synchronize()
            e_pm, r_pm = max_err(pm, rpm)
            e_pv, r_pv = max_err(pv, rpv)
            e_kl, r_kl = max_err(kl, rkl)
            rep = bool(torch.equal(pm, pm2) and torch.equal(pv, pv2)
                       and torch.equal(kl, kl2))
            ms, plain_ms = paired_ms(lambda: co.prologue(*args, **kw),
                                     lambda: co.prologue_plain(*args, **kw),
                                     reps=10)
            name = f'prologue P={P} K={K} I={I} A={A}'
            log(f'  {name}: pm {e_pm:.3e} ({r_pm:.3e}) pv {e_pv:.3e} '
                f'({r_pv:.3e}) kl {e_kl:.3e} ({r_kl:.3e}); bands '
                f'{BAND_F32:.0e}/{BAND_KL:.0e}; repeatable {rep}; kernel '
                f'{ms:.4f} ms, plain {plain_ms:.4f} ms')
            require(max(r_pm, r_pv) <= BAND_F32 and r_kl <= BAND_KL,
                    f'{name} outside its band')
            require(rep, f'{name} not bit-for-bit repeatable')
            if (P, K) == (2, 582):
                results['prologue'] = dict(
                    max_abs_err=max(e_pm, e_pv), ms=ms, plain_ms=plain_ms)

            s = co.delta_sums(*args, **kw)
            s2 = co.delta_sums(*args, **kw)
            rs = co.delta_sums_plain(*args, **kw)
            torch.cuda.synchronize()
            e_s, r_s = max_err(s, rs)
            rep = bool(torch.equal(s, s2))
            ms, plain_ms = paired_ms(
                lambda: co.delta_sums(*args, **kw),
                lambda: co.delta_sums_plain(*args, **kw), reps=10)
            name = f'delta_sums P={P} K={K} I={I} A={A}'
            log(f'  {name}: max_abs_err {e_s:.3e} scaled {r_s:.3e} (band '
                f'{BAND_F32:.0e}); repeatable {rep}; kernel {ms:.4f} ms, '
                f'plain {plain_ms:.4f} ms')
            require(r_s <= BAND_F32, f'{name} outside its band')
            require(rep, f'{name} not bit-for-bit repeatable')
            if (P, K) == (2, 582):
                results['delta_sums'] = dict(max_abs_err=e_s, ms=ms,
                                             plain_ms=plain_ms)


# ---------------------------------------------------------------------------
# phase 4: CLI fit on an on-disk schema
# ---------------------------------------------------------------------------

def ar1_factor(n, rho, rank):
    """Top-`rank` eigenpairs of an n x n AR(1) correlation block."""
    idx = np.abs(np.subtract.outer(np.arange(n), np.arange(n)))
    vals, vecs = np.linalg.eigh(rho ** idx)
    return vecs[:, -rank:], vals[-rank:]


def write_schema(out_dir, num_blocks, block_size=1024, rank_frac=0.5,
                 num_pops=2, seed=1):
    """Stacked-eigendecomposition .npy + .var blocks, a .schema manifest,
    one sumstats TSV per cohort and an extract list (the layout
    tools/export_synthetic_schema.py writes). Returns the paths."""
    rng = np.random.default_rng(seed)
    n = num_blocks * block_size
    ids = [f'snp{i}' for i in range(n)]
    manifest = []
    for b in range(num_blocks):
        u, s = ar1_factor(block_size, rng.uniform(0.3, 0.95),
                          int(block_size * rank_frac))
        base = f'block{b}'
        np.save(os.path.join(out_dir, base + '.npy'),
                np.vstack([u, s[None, :]]).astype(np.float32))
        with open(os.path.join(out_dir, base + '.var'), 'w') as fh:
            for i in range(b * block_size, (b + 1) * block_size):
                fh.write(f'{ids[i]}\t1\t{i + 1}\t0.0\tA\tG\n')
        manifest.append(f'{base}.var\t{base}.npy')
    schema = os.path.join(out_dir, 'panel.schema')
    with open(schema, 'w') as fh:
        fh.write('\n'.join(manifest) + '\n')
    std_errs = rng.uniform(0.01, 0.05, (num_pops, n))
    betas = rng.standard_normal((num_pops, n)) * std_errs * 2
    sumstats = []
    for p in range(num_pops):
        path = os.path.join(out_dir, f'pop{p + 1}.sumstats.tsv')
        with open(path, 'w') as fh:
            fh.write('ID\tA1\tA2\tBETA\tSE\n')
            fh.writelines(f'{ids[i]}\tA\tG\t{betas[p, i]:.8e}\t'
                          f'{std_errs[p, i]:.8e}\n' for i in range(n))
        sumstats.append(path)
    extract = os.path.join(out_dir, 'extract.tsv')
    with open(extract, 'w') as fh:
        fh.write('ID\tA1\tA2\n')
        fh.writelines(f'{i}\tA\tG\n' for i in ids)
    return schema, sumstats, extract, n


def fit_argv(schema, sumstats, extract, prefix, device):
    return ['fit', '--ld-schema', f'{schema},{schema}',
            '--sumstats', ','.join(sumstats), '--extract', extract,
            '--names', 'pop1,pop2', '--samplesizes', '1e5,1e5',
            '--init-hg', '0.3,0.3', '--seed', '42', '--num-its', '5',
            '--output', prefix, '--device', device]


def read_posteriors(prefix):
    """[n, 4] posterior means and variances of a 2-cohort fit."""
    return np.loadtxt(prefix + '.estimates.tsv', skiprows=1,
                      usecols=(3, 4, 5, 6))


def check_small_fit(out_dir):
    """The card's f32 fit against the host's f64 fit (the plain
    versions) on one 2-block schema, -K 3: posterior means and variances
    within BAND_FIT of their scale. Returns the scaled errors."""
    from vilma_tpu_torch import frontend
    schema, sumstats, extract, _ = write_schema(out_dir, num_blocks=2)
    runs = {}
    for device, precision in (('cuda', 'f32'), ('cpu', 'f64')):
        prefix = os.path.join(out_dir, f'small_{device}')
        frontend.main(fit_argv(schema, sumstats, extract, prefix, device)
                      + ['-K', '3', '--precision', precision,
                         '--ld-precision', 'f32' if device == 'cuda'
                         else 'auto'])
        runs[device] = read_posteriors(prefix)
    err = (np.abs(runs['cuda'] - runs['cpu']).max(axis=0)
           / np.abs(runs['cpu']).max(axis=0))
    require(np.all(np.isfinite(runs['cuda'])), 'non-finite card fit')
    require(np.all(err <= BAND_FIT),
            f'card f32 fit vs host f64 fit: scaled errors {err} exceed '
            f'{BAND_FIT:.0e}')
    return err


def run_fit(out_dir, num_blocks, device, extra=()):
    """Write the schema, zero the launch counters, run the CLI fit, read
    the counters. Returns (counts, seconds per outer step, host syncs,
    output prefix, number of variants)."""
    from vilma_tpu_torch import frontend
    from vilma_tpu_torch.inference import engine
    from vilma_tpu_torch.ops.cuda import block_matvec, compact_obj

    t0 = time.perf_counter()
    schema, sumstats, extract, n = write_schema(out_dir, num_blocks)
    log(f'  schema: {n} variants in {num_blocks} blocks written in '
        f'{time.perf_counter() - t0:.1f} s')
    prefix = os.path.join(out_dir, 'fit')
    argv = fit_argv(schema, sumstats, extract, prefix, device) + list(extra)

    step_s = []
    real_step = engine.outer_step

    def timed_step(*a, **k):
        _sync(device)
        t = time.perf_counter()
        out = real_step(*a, **k)
        _sync(device)
        step_s.append(time.perf_counter() - t)
        return out

    block_matvec.launches = 0
    for key in compact_obj.launches:
        compact_obj.launches[key] = 0
    engine.host_syncs = 0
    engine.outer_step = timed_step
    t0 = time.perf_counter()
    try:
        frontend.main(argv)
    finally:
        engine.outer_step = real_step
    counts = {'bucket_matvec_multi': block_matvec.launches,
              'prologue': compact_obj.launches['prologue'],
              'delta_sums': compact_obj.launches['delta_sums']}
    log(f'  fit: {time.perf_counter() - t0:.1f} s in all, '
        f'{len(step_s)} outer steps')
    return counts, step_s, engine.host_syncs, prefix, n


def _sync(device):
    import torch
    if device == 'cuda':
        torch.cuda.synchronize()


def check_fit_outputs(prefix, n, K, P=2):
    z = np.load(prefix + '.npz')
    require(z['vi_mu'].shape == (K, P, n), f'vi_mu shape {z["vi_mu"].shape}')
    require(z['vi_delta'].shape == (n, K), 'vi_delta shape')
    require(z['vi_sigma'].shape == (K, P, P, n), 'vi_sigma shape')
    for key in z.files:
        require(np.all(np.isfinite(z[key])), f'non-finite {key}')
    require(np.allclose(z['vi_delta'].sum(axis=1), 1.0, atol=1e-3),
            'vi_delta rows do not sum to 1')
    with open(prefix + '.estimates.tsv') as fh:
        header = fh.readline().rstrip('\n').split('\t')
        rows = [line.rstrip('\n').split('\t') for line in fh]
    require(len(rows) == n, f'{len(rows)} estimate rows for {n} variants')
    want = ['ID', 'A1', 'A2', 'posterior_pop1', 'posterior_pop2',
            'posterior_variance_pop1', 'posterior_variance_pop2',
            'missing_sumstats_pop1', 'missing_LD_pop1',
            'missing_sumstats_pop2', 'missing_LD_pop2']
    require(header == want, f'estimates columns {header}')
    post = np.array([[float(v) for v in r[3:7]] for r in rows])
    require(np.all(np.isfinite(post)), 'non-finite posterior estimates')
    require(np.all(post[:, 2:] >= 0), 'negative posterior variance')
    return float(np.max(np.abs(post[:, :2])))


# ---------------------------------------------------------------------------
# phase 5: engine at whole-genome HapMap3 scale
# ---------------------------------------------------------------------------

def device_ld(num_blocks, block_size, rank, device, seed=5):
    """A PackedLD of AR(1) blocks factored on the card (batched eigh,
    set-up rather than a kernel), bf16 eigenvectors."""
    import torch
    from vilma_tpu_torch.ops.blocks import BlockBucket, PackedLD
    rng = np.random.default_rng(seed)
    rho = torch.as_tensor(rng.uniform(0.3, 0.95, num_blocks),
                          dtype=torch.float32, device=device)
    idx = torch.arange(block_size, device=device)
    lag = (idx[:, None] - idx[None, :]).abs().float()
    us, ss = [], []
    for b0 in range(0, num_blocks, 64):
        r = rho[b0:b0 + 64]
        blocks = r[:, None, None] ** lag[None]
        vals, vecs = torch.linalg.eigh(blocks)
        us.append(vecs[:, :, -rank:].to(torch.bfloat16))
        ss.append(vals[:, -rank:].contiguous())
        del blocks, vals, vecs
    u = torch.cat(us).contiguous()
    s = torch.cat(ss)
    n = num_blocks * block_size
    bucket = BlockBucket(
        u=u, s=s, inv_s=torch.where(s > 0, 1.0 / s, torch.zeros_like(s)),
        d=torch.zeros(num_blocks, block_size, device=device),
        perm=torch.arange(n, device=device).reshape(num_blocks,
                                                    block_size))
    return PackedLD(buckets=(bucket,), n=n, has_diag=False,
                    rank=float(num_blocks * rank), missing=())


def build_engine(device, num_blocks=977, block_size=1024, K=18):
    """ModelData and the initial compact state of a 2-cohort fit on
    `num_blocks` AR(1) blocks sharing one bf16 panel, K components."""
    import torch
    from vilma_tpu_torch.inference import engine
    t0 = time.perf_counter()
    ld = device_ld(num_blocks, block_size, block_size // 2, device)
    _sync(device)
    n = ld.n
    rng = np.random.default_rng(7)
    std_errs = rng.uniform(0.01, 0.05, (2, n)).astype(np.float32)
    betas = (rng.standard_normal((2, n)) * std_errs * 2).astype(np.float32)
    np.random.seed(42)
    vi = engine.MultiPopVI(
        marginal_effects=betas, std_errs=std_errs, ld_mats=[ld, ld],
        annotations=np.ones((n, 1)), mixture_covs=synthetic_covs(2, K, 1),
        checkpoint=False, gwas_N=np.full(2, 1e5), init_hg=np.full(2, 0.3),
        num_its=1, dtype=torch.float32, device=device)
    st = vi._initialize()
    e0, _, _ = engine._objective_compact(vi.data, st, st.nat_mu,
                                         st.hyper_delta)
    st = engine.dataclasses.replace(st, elbo=float(e0))
    _sync(device)
    log(f'  set-up: {n} SNPs, {num_blocks} blocks, U '
        f'{ld.buckets[0].u.numel() * 2 / 1e9:.2f} GB bf16, '
        f'{time.perf_counter() - t0:.1f} s')
    return vi.data, st


def run_engine(device, steps=3):
    import torch
    from vilma_tpu_torch.inference import engine
    data, st = build_engine(device)
    st, pm = engine.outer_step(data, st)             # warm-up
    _sync(device)
    syncs0 = engine.host_syncs
    t0 = time.perf_counter()
    for _ in range(steps):
        st, pm = engine.outer_step(data, st)
    _sync(device)
    dt = time.perf_counter() - t0
    require(math.isfinite(st.elbo), 'non-finite ELBO')
    require(bool(torch.isfinite(pm).all()), 'non-finite posterior mean')
    return steps / dt, (engine.host_syncs - syncs0) / steps, st.elbo


# ---------------------------------------------------------------------------

def main():
    import torch
    log('phase 1: device')
    if not torch.cuda.is_available():
        raise SmokeFailure('torch.cuda.is_available() is false: '
                           'chip_smoke.py needs a CUDA device')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    log(f'  {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, REPO)
    device = 'cuda'

    log('phase 2: build')
    from vilma_tpu_torch.ops.cuda import build
    t0 = time.perf_counter()
    build.library()
    log(f'  built {build.library_path().name} in '
        f'{time.perf_counter() - t0:.1f} s (nvcc '
        f'{build.build_seconds if build.build_seconds is not None else 0:.1f} s)')

    results = {}
    log('phase 3: kernels against their plain versions')
    check_matvec(device, results)
    check_compact(device, results)

    log('phase 4: CLI fit, ~90K variants, -K 12 (582 components)')
    with tempfile.TemporaryDirectory() as tmp:
        counts, step_s, syncs, prefix, n = run_fit(
            tmp, num_blocks=88, device=device,
            extra=['--precision', 'f32', '--ld-precision', 'bf16'])
        top = check_fit_outputs(prefix, n, K=582)
    log(f'  launches {counts}; host syncs {syncs} '
        f'({syncs / max(len(step_s), 1):.1f} per step); seconds per '
        f'outer step {[round(x, 4) for x in step_s]}; max |posterior| '
        f'{top:.3e}')
    for name, c in counts.items():
        require(c > 0, f'the fit never launched the {name} kernel')
    with tempfile.TemporaryDirectory() as tmp:
        err = check_small_fit(tmp)
    log(f'  reference: 2-block fit, card f32 vs host f64, scaled '
        f'errors (pm1, pm2, pv1, pv2) {err} (band {BAND_FIT:.0e})')

    log('phase 5: engine, 1M SNPs, 2 cohorts, K=18, bf16 U')
    ips, syncs, elbo = run_engine(device)
    log(f'  {ips:.3f} outer iterations/s ({syncs:.1f} host syncs per '
        f'step), ELBO {elbo:.6e}; {smi}')

    log(smi)
    table = [dict(name=name, route='cuda', source=meta['source'],
                  replaces=meta['replaces'], launches=counts[name],
                  **results.get(name, {}))
             for name, meta in KERNELS.items()]
    print(json.dumps({'kernels': table}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    try:
        main()
    except SmokeFailure as exc:
        print(f'chip_smoke FAILED: {exc}', file=sys.stderr)
        sys.exit(1)
