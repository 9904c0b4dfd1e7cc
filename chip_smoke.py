"""Smoke run of the PyTorch + CUDA port (vilma_tpu_torch) on one GPU.

    python3 chip_smoke.py     # every phase, one CUDA device

Phases:
  1. device: the card's name and power limit; refuses without CUDA.
  2. build: nvcc builds the kernels from vilma_tpu_torch/csrc (one nvcc
     per source, in parallel).
  3. kernels: each CUDA kernel against its plain PyTorch version on the
     card at main-path shapes, within a stated band, bit-for-bit
     repeatable, with CUDA-event times of both (the matvec also beside
     its cuBLAS route) and the least time the card could take (bound).
  4. fit: `vilma-tpu-torch fit` in-process on a synthetic on-disk schema
     the size of a per-chromosome HapMap3 fit (~90K variants in
     1024-SNP AR(1) blocks at half rank, 2 cohorts sharing the panel) at
     the default -K 12 grid (582 components), f32 with bf16 LD, which
     takes the streamed output route. The kernel launch counters are
     zeroed just before and read just after: every kernel of the path
     must launch. Then small-input references: a 2-block fit on the
     card (f32) held against the same fit on the host at f64, without
     and with --learn-scaling (kdim and epoch-history routes).
  5. engine: 1M SNPs (977 blocks of 1024), 2 cohorts, K = 18, bf16 U;
     3 timed outer steps after one warm-up step.
  6. fit --learn-scaling: phase 4's schema and flags; the kdim
     [K, P, I] state (420 MB). Steps until an error-scaling EM event
     fires (step cap STEP_CAP_SE); the kdim kernels must launch.
  7. engine --learn-scaling: phase 5's LD, the 582-component grid of
     the CLI; the epoch-history state, selected by size. One warm-up
     step, one EM append, 3 timed outer steps.

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
# input (measured beside the card's) lands within 2.24e-5 and the card's
# within 2.83e-5; the band leaves the kernels' accumulation-order noise
# ~7x room
BAND_FIT = 2e-4
# the same with --learn-scaling, 20 steps through one EM event: the
# host's own f32 fits land within 6.4e-05 (kdim and epoch) and the card's
# within 4.5e-05, their learned scalings within 1.6e-5 relative; the
# bands leave ~10x room
BAND_FIT_SE = 7e-4
BAND_SCALING = 2e-4
SMALL_ITS_SE = '20'        # the first EM event fires at step 17 there
# phase 6: the per-chromosome fit steps until an EM event fires
STEP_CAP_SE = 150

# the card's published peaks (NVIDIA H100 SXM data sheet, dense): HBM
# bytes/s, FP32 and bf16 tensor operations/s
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
BF16_OPS_S = 989e12

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
    'prologue_kdim': dict(
        source='vilma_tpu_torch/csrc/compact_obj.cu',
        replaces='vilma_tpu/ops/pallas/compact_obj.py:257'),
    'delta_sums_kdim': dict(
        source='vilma_tpu_torch/csrc/compact_obj.cu',
        replaces='vilma_tpu/ops/pallas/compact_obj.py:257'),
    'prologue_epochs': dict(
        source='vilma_tpu_torch/csrc/compact_obj_epochs.cu',
        replaces='vilma_tpu/ops/pallas/compact_obj.py:562'),
    'delta_sums_epochs': dict(
        source='vilma_tpu_torch/csrc/compact_obj_epochs.cu',
        replaces='vilma_tpu/ops/pallas/compact_obj.py:603'),
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


def paired_ms(kernel_fn, plain_fn, reps=20, plain_reps=None):
    """(kernel ms, plain ms), measured in turns plain, kernel, kernel,
    plain and averaged per version."""
    plain_reps = reps if plain_reps is None else plain_reps
    p1 = cuda_ms(plain_fn, plain_reps, warmup=1)
    k1 = cuda_ms(kernel_fn, reps)
    k2 = cuda_ms(kernel_fn, reps)
    p2 = cuda_ms(plain_fn, plain_reps, warmup=1)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(nbytes, ops, ops_per_s=FP32_OPS_S):
    """(ms, what bounds it): the larger of the bytes the function must
    move over the memory rate and its operations over the peak rate."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return ((t_bytes, 'bytes') if t_bytes >= t_ops
            else (t_ops, 'operations'))


def entry(err, ms, plain_ms, bound_ms_by, library_ms=None):
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms_by[0], bound_by=bound_ms_by[1],
                library_ms=library_ms)


def compact_cost(P, K, I, A, sums, live=None):
    """(bytes, operations) of one compact kernel call: each input read
    once, each output written once; the operations are the TPU kernels'
    own cost estimates (compact_obj.py pl.CostEstimate: flops, plus 3
    transcendentals per component and SNP, each counted as one FP32
    operation). live: None for the shared [P, I] natural mean, 'kdim'
    for [K, P, I], an int for the epoch state's live epochs."""
    ncol = P * (P + 1) // 2 + 1
    tables = 4 * K * (ncol + A)
    per_snp = 4 * (1 + 2 * P)                         # ann, dterm, nat
    if live == 'kdim':
        per_snp += 4 * (K - 1) * P
    elif live is not None:
        per_snp += 4 * live * P                       # live epochs
        tables += 4 * ((live + 1) * P + live)
    out = 4 * K * A if sums else 4 * 2 * P * I + 4
    if live is None or live == 'kdim':
        flops = (50 + 2 * A if sums else 60) * K * I
    else:
        flops = (20 * (live + 1) + (30 + 2 * A if sums else 40)) * K * I
    return tables + per_snp * I + out, flops + 3 * K * I


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


def cublas_matvec(u, s, d, x):
    """y = U (s * (U^T x)) + d x by two torch.bmm calls on U's type."""
    import torch
    t = torch.bmm(x.to(u.dtype), u) * s[:, None, :]
    return (torch.bmm(t.to(u.dtype), u.transpose(1, 2)).float()
            + d[:, None, :] * x)


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
            # the library yardstick: cuBLAS, two batched products (bf16
            # operands, f32 accumulation) plus the diagonal term
            lib_ms = cuda_ms(lambda: cublas_matvec(u, s, d, x), 10)
            nbytes = (ubytes + 4 * B * R + 4 * B * P + 2 * 4 * B * C * P)
            b = bound(nbytes, 4 * B * P * R * C, BF16_OPS_S)
            log(f'    cuBLAS route (2 torch.bmm + diagonal) {lib_ms:.4f} ms;'
                f' bound {b[0]:.4f} ms ({b[1]})')
            results['bucket_matvec_multi'] = entry(err, ms, plain_ms, b,
                                                   lib_ms)


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
    """The shared [P, I] natural mean at P = 1..3, K = 18 and 582; the
    reported shape is P = 2, K = 582."""
    from vilma_tpu_torch.ops.cuda import compact_obj as co
    for P in (1, 2, 3):
        for K in (18, 582):
            kw = dict(zip(('coeffs', 'scores_t', 'annotations', 'dterm',
                           'nat_mu'),
                          compact_inputs(device, P, K, I, A,
                                         seed=10 * P + K)),
                      num_annotations=A)
            check_pair(f'[P, I] P={P} K={K} I={I} A={A}',
                       ('prologue', 'delta_sums') if (P, K) == (2, 582)
                       else None, results, (co.prologue, co.delta_sums),
                       (co.prologue_plain, co.delta_sums_plain), kw,
                       lambda sums: compact_cost(P, K, I, A, sums))


def check_pair(name, key, results, run, plain, kw, cost, reps=10,
               plain_reps=None):
    """One prologue/sums pair of a state form against its plain
    versions: bands, repeatability, times, bound. `run` and `plain` are
    (prologue, delta_sums) callables taking **kw."""
    import torch
    pm, pv, kl = run[0](**kw)
    pm2, pv2, kl2 = run[0](**kw)
    rpm, rpv, rkl = plain[0](**kw)
    s, s2, rs = run[1](**kw), run[1](**kw), plain[1](**kw)
    torch.cuda.synchronize()
    e_pm, r_pm = max_err(pm, rpm)
    e_pv, r_pv = max_err(pv, rpv)
    e_kl, r_kl = max_err(kl, rkl)
    e_s, r_s = max_err(s, rs)
    rep = bool(torch.equal(pm, pm2) and torch.equal(pv, pv2)
               and torch.equal(kl, kl2) and torch.equal(s, s2))
    times = [paired_ms(lambda: run[j](**kw), lambda: plain[j](**kw), reps,
                       plain_reps) for j in (0, 1)]
    log(f'  {name}: pm {e_pm:.3e} ({r_pm:.3e}) pv {e_pv:.3e} ({r_pv:.3e}) '
        f'kl {e_kl:.3e} ({r_kl:.3e}) sums {e_s:.3e} ({r_s:.3e}); bands '
        f'{BAND_F32:.0e}/{BAND_KL:.0e}; repeatable {rep}; prologue '
        f'{times[0][0]:.4f} ms (plain {times[0][1]:.4f}), sums '
        f'{times[1][0]:.4f} ms (plain {times[1][1]:.4f})')
    require(max(r_pm, r_pv, r_s) <= BAND_F32 and r_kl <= BAND_KL,
            f'{name} outside its band')
    require(rep, f'{name} not bit-for-bit repeatable')
    if key is not None:
        for j, (kname, sums) in enumerate(((key[0], False),
                                           (key[1], True))):
            b = bound(*cost(sums))
            results[kname] = entry(e_s if sums else max(e_pm, e_pv),
                                   times[j][0], times[j][1], b)
            log(f'    {kname}: bound {b[0]:.4f} ms ({b[1]})')


KDIM_SHAPES = ((2, 582, 90_112), (2, 18, 1_000_000), (1, 582, 90_112),
               (3, 582, 90_112))
EPOCH_SHAPES = ((2, 582, 1_000_000), (1, 582, 90_112), (3, 582, 90_112))


def check_kdim(device, results, A=4, shapes=KDIM_SHAPES):
    """The per-component [K, P, I] natural mean at (P, K, I) shapes: the
    first is the per-chromosome shape of phase 6, the one reported."""
    import torch
    from vilma_tpu_torch.ops.cuda import compact_obj as co
    for P, K, I in shapes:
        coeffs, scores_t, ann, dterm, _ = compact_inputs(device, P, K, I, A,
                                                         seed=7 * P + K)
        gen = torch.Generator(device=device).manual_seed(P * K)
        kw = dict(coeffs=coeffs, scores_t=scores_t, annotations=ann,
                  dterm=dterm, num_annotations=A,
                  nat_mu=torch.randn(K, P, I, generator=gen,
                                     device=device) * 0.5)
        main = (P, K, I) == shapes[0]
        check_pair(f'kdim P={P} K={K} I={I} A={A}',
                   ('prologue_kdim', 'delta_sums_kdim') if main else None,
                   results, (co.prologue, co.delta_sums),
                   (co.prologue_plain, co.delta_sums_plain), kw,
                   lambda sums: compact_cost(P, K, I, A, sums, 'kdim'))
        del kw


def check_epochs(device, results, A=4, B=4, live=2, shapes=EPOCH_SHAPES):
    """The epoch-history state with `live` of B slots live, at (P, K, I)
    shapes: the first is the shape of phase 7, the one reported."""
    import torch
    from vilma_tpu_torch.ops.cuda import compact_obj as co
    for P, K, I in shapes:
        coeffs, scores_t, ann, sld, u = compact_inputs(device, P, K, I, A,
                                                       seed=11 * P + K)
        rng = np.random.default_rng(P)
        gen = torch.Generator(device=device).manual_seed(P + K)
        hist = torch.zeros(B, P, I, device=device)
        hist[:live] = torch.randn(live, P, I, generator=gen,
                                  device=device) * 0.5
        isc = np.ones((B + 1, P))
        isc[:live + 1] = 1 / rng.uniform(0.7, 1.4, (live + 1, P))
        hc = np.zeros(B)
        hc[:live] = rng.uniform(0.1, 1.0, live)
        kw = dict(coeffs=coeffs, scores_t=scores_t, annotations=ann,
                  sld=sld, nat_u=u, hist_v=hist,
                  inv_scales=torch.as_tensor(isc, dtype=torch.float32,
                                             device=device),
                  hist_c=torch.as_tensor(hc, dtype=torch.float32,
                                         device=device),
                  num_annotations=A, num_live=live)
        main = (P, K, I) == shapes[0]
        # the plain version loops over every slot: the inert ones add
        # exact zeros, so the kernel's live-only loop must agree with it
        plain = (lambda **k: co.prologue_epochs_plain(
                     **dict(k, num_live=None)),
                 lambda **k: co.delta_sums_epochs_plain(
                     **dict(k, num_live=None)))
        check_pair(f'epochs P={P} K={K} I={I} A={A} B={B} live={live}',
                   ('prologue_epochs', 'delta_sums_epochs') if main
                   else None, results,
                   (co.prologue_epochs, co.delta_sums_epochs), plain, kw,
                   lambda sums: compact_cost(P, K, I, A, sums, live),
                   plain_reps=2 if main else None)
        del hist, kw


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


class count_em:
    """Context manager recording each error-scaling EM update the engine
    makes while active: (the value of `step()`, the scaling it leaves)."""

    def __init__(self, step=lambda: None):
        self.step = step

    def __enter__(self):
        from vilma_tpu_torch.inference import engine
        self.engine, self.real, self.events = (
            engine, engine._update_error_scaling, [])

        def counted(*a, **k):
            out = self.real(*a, **k)
            self.events.append((self.step(),
                                out[0].error_scaling.tolist()))
            return out

        engine._update_error_scaling = counted
        return self

    def __exit__(self, *exc):
        self.engine._update_error_scaling = self.real


def check_small_fit(out_dir):
    """The card's f32 fit against the host's f64 fit (the plain
    versions) on one 2-block schema, -K 3: posterior means and variances
    within their band of their scale, without --learn-scaling (5 steps)
    and with it on both of its routes (20 steps through an EM event; the
    epoch route forced by the size threshold 0, as VILMA_EPOCH_STATE_BYTES
    does). The host's own f32 fit, which sets the bands, is measured
    beside it. Returns {route: (card errors, scaling error, card scaling,
    host f32 errors)}."""
    from vilma_tpu_torch import frontend
    from vilma_tpu_torch.inference import engine
    schema, sumstats, extract, _ = write_schema(out_dir, num_blocks=2)
    errs = {}
    threshold = engine._EPOCH_STATE_BYTES
    for route, flags, band in (
            ('plain', [], BAND_FIT),
            ('kdim', ['--learn-scaling', '--num-its', SMALL_ITS_SE],
             BAND_FIT_SE),
            ('epoch', ['--learn-scaling', '--num-its', SMALL_ITS_SE],
             BAND_FIT_SE)):
        runs, scal = {}, {}
        for device, precision in (('cuda', 'f32'), ('cpu', 'f64'),
                                  ('cpu', 'f32')):
            tag = f'{device}_{precision}'
            prefix = os.path.join(out_dir, f'small_{route}_{tag}')
            engine._EPOCH_STATE_BYTES = 0 if route == 'epoch' else threshold
            try:
                with count_em() as em:
                    frontend.main(
                        fit_argv(schema, sumstats, extract, prefix, device)
                        + ['-K', '3', '--precision', precision,
                           '--ld-precision', 'f32' if precision == 'f32'
                           else 'auto'] + flags)
            finally:
                engine._EPOCH_STATE_BYTES = threshold
            runs[tag] = read_posteriors(prefix)
            z = np.load(prefix + '.npz')
            scal[tag] = z['error_scaling']
            if route != 'plain':
                require(len(em.events) >= 1,
                        f'{route} small fit on {tag}: no EM event')
                require(('nat_hist_n' in z.files) == (route == 'epoch'),
                        f'{route} small fit on {tag}: wrong state')

        def scaled(tag):
            return (np.abs(runs[tag] - runs['cpu_f64']).max(axis=0)
                    / np.abs(runs['cpu_f64']).max(axis=0))

        err = scaled('cuda_f32')
        require(np.all(np.isfinite(runs['cuda_f32'])), 'non-finite card fit')
        require(np.all(err <= band),
                f'{route}: card f32 fit vs host f64 fit: scaled errors '
                f'{err} exceed {band:.0e}')
        s_err = float(np.max(np.abs(scal['cuda_f32'] / scal['cpu_f64'] - 1)))
        require(s_err <= BAND_SCALING,
                f'{route}: learned scalings {scal} differ by {s_err:.2e}')
        errs[route] = (err, s_err, scal['cuda_f32'], scaled('cpu_f32'))
    return errs


def run_fit(paths, prefix, device, extra=()):
    """Zero the launch counters, run the CLI fit on a written schema,
    read the counters. Returns (counts, seconds per outer step, host
    syncs, EM scalings)."""
    from vilma_tpu_torch import frontend
    from vilma_tpu_torch.inference import engine
    from vilma_tpu_torch.ops.cuda import block_matvec, compact_obj

    schema, sumstats, extract, _ = paths
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

    zero_counts()
    engine.host_syncs = 0
    engine.outer_step = timed_step
    t0 = time.perf_counter()
    try:
        with count_em(step=lambda: len(step_s) + 1) as em:
            frontend.main(argv)
    finally:
        engine.outer_step = real_step
    counts = read_counts()
    log(f'  fit: {time.perf_counter() - t0:.1f} s in all, '
        f'{len(step_s)} outer steps')
    return counts, step_s, engine.host_syncs, em.events


def zero_counts():
    from vilma_tpu_torch.ops.cuda import block_matvec, compact_obj
    block_matvec.launches = 0
    for key in compact_obj.launches:
        compact_obj.launches[key] = 0


def read_counts():
    from vilma_tpu_torch.ops.cuda import block_matvec, compact_obj
    return dict(bucket_matvec_multi=block_matvec.launches,
                **compact_obj.launches)


def require_launched(counts, names, phase):
    for name in names:
        require(counts[name] > 0,
                f'{phase} never launched the {name} kernel')


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
    return float(np.max(np.abs(post[:, :2]))), z['error_scaling']


def remove_outputs(prefix):
    for ext in ('.npz', '.estimates.tsv', '.covariance.pkl'):
        if os.path.exists(prefix + ext):
            os.remove(prefix + ext)


# ---------------------------------------------------------------------------
# phases 5 and 7: engine at whole-genome HapMap3 scale
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


def build_engine(device, ld=None, num_blocks=977, block_size=1024, K=18,
                 scale_se=False):
    """MultiPopVI and its initial state for a 2-cohort fit on AR(1)
    blocks sharing one bf16 panel (`ld`, or `num_blocks` of them factored
    here): K synthetic components, or with scale_se the CLI's -K 12 grid
    drawn for these effect sizes (582 components)."""
    import torch
    from vilma_tpu_torch.inference import engine
    from vilma_tpu_torch.models import mixture
    t0 = time.perf_counter()
    if ld is None:
        ld = device_ld(num_blocks, block_size, block_size // 2, device)
    _sync(device)
    n = ld.n
    rng = np.random.default_rng(7)
    std_errs = rng.uniform(0.01, 0.05, (2, n)).astype(np.float32)
    betas = (rng.standard_normal((2, n)) * std_errs * 2).astype(np.float32)
    np.random.seed(42)
    if scale_se:
        covs = mixture.make_simple(
            2, 12, *mixture.effect_size_ranges(betas, std_errs, False))
    else:
        covs = synthetic_covs(2, K, 1)
    vi = engine.MultiPopVI(
        marginal_effects=betas, std_errs=std_errs, ld_mats=[ld, ld],
        annotations=np.ones((n, 1)), mixture_covs=covs, checkpoint=False,
        gwas_N=np.full(2, 1e5), init_hg=np.full(2, 0.3), num_its=1,
        scale_se=scale_se, dtype=torch.float32, device=device)
    st = vi._initialize()
    st = engine.dataclasses.replace(st, elbo=vi.elbo_value(st))
    _sync(device)
    log(f'  set-up: {n} SNPs, K = {vi.num_mix}, U '
        f'{ld.buckets[0].u.numel() * 2 / 1e9:.2f} GB bf16, '
        f'{time.perf_counter() - t0:.1f} s')
    return vi, st, ld


def timed_steps(data, st, steps):
    """(state, outer iterations/s, host syncs per step) of `steps` outer
    steps on the host clock."""
    import torch
    from vilma_tpu_torch.inference import engine
    _sync('cuda')
    syncs0 = engine.host_syncs
    t0 = time.perf_counter()
    for _ in range(steps):
        st, pm = engine.outer_step(data, st)
    _sync('cuda')
    dt = time.perf_counter() - t0
    require(math.isfinite(st.elbo), 'non-finite ELBO')
    require(bool(torch.isfinite(pm).all()), 'non-finite posterior mean')
    return st, steps / dt, (engine.host_syncs - syncs0) / steps


def run_engine(device, steps=3):
    from vilma_tpu_torch.inference import engine
    vi, st, ld = build_engine(device)
    st, _ = engine.outer_step(vi.data, st)             # warm-up
    st, ips, syncs = timed_steps(vi.data, st, steps)
    return ips, syncs, st.elbo, ld


def run_engine_se(device, ld, steps=3):
    """Phase 7: the epoch-history route at 1M SNPs, selected by size. A
    warm-up step, one EM append (the update a step makes once its ELBO
    gain falls below EM_TOL), then `steps` timed steps."""
    from vilma_tpu_torch.inference import engine
    vi, st, _ = build_engine(device, ld=ld, scale_se=True)
    require(vi._epoch, 'the size rule did not select the epoch state '
            f'(K = {vi.num_mix}, I = {vi.num_loci})')
    data = vi.data
    zero_counts()
    st, _ = engine.outer_step(data, st)                 # warm-up
    obj, pm, lk = engine._objective(data, st, engine._params(st),
                                    st.hyper_delta)
    with count_em() as em:
        st, _, _ = engine._update_error_scaling(
            data, st, engine._sync_float(obj), pm, lk)
    require(st.nat_hist_n >= 1, 'the EM update appended no epoch')
    st, ips, syncs = timed_steps(data, st, steps)
    counts = read_counts()
    return counts, ips, syncs, st, em.events, vi.num_mix


# ---------------------------------------------------------------------------

F32_BF16 = ['--precision', 'f32', '--ld-precision', 'bf16']


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
    t_start = time.perf_counter()

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
    check_kdim(device, results)
    check_epochs(device, results)
    torch.cuda.empty_cache()

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        log('phase 4: CLI fit, ~90K variants, -K 12 (582 components)')
        t0 = time.perf_counter()
        paths = write_schema(tmp, num_blocks=88)
        n = paths[3]
        log(f'  schema: {n} variants in 88 blocks written in '
            f'{time.perf_counter() - t0:.1f} s')
        prefix = os.path.join(tmp, 'fit')
        counts, step_s, syncs, _ = run_fit(paths, prefix, device, F32_BF16)
        top, _ = check_fit_outputs(prefix, n, K=582)
        remove_outputs(prefix)
        log(f'  launches {counts}; host syncs {syncs} '
            f'({syncs / max(len(step_s), 1):.1f} per step); seconds per '
            f'outer step {[round(x, 4) for x in step_s]}; max |posterior| '
            f'{top:.3e}')
        path_a = ('bucket_matvec_multi', 'prologue', 'delta_sums')
        require_launched(counts, path_a, 'phase 4')
        launches.update({k: counts[k] for k in path_a})
        with tempfile.TemporaryDirectory() as small:
            errs = check_small_fit(small)
        for route, (err, s_err, scal, host_err) in errs.items():
            log(f'  reference ({route}): 2-block fit, card f32 vs host '
                f'f64, scaled errors (pm1, pm2, pv1, pv2) {err} (band '
                f'{BAND_FIT if route == "plain" else BAND_FIT_SE:.0e}; '
                f'host f32 vs host f64 {host_err}); learned scaling {scal} '
                f'within {s_err:.2e} of the host')

        log('phase 5: engine, 1M SNPs, 2 cohorts, K=18, bf16 U')
        ips, syncs, elbo, ld = run_engine(device)
        log(f'  {ips:.3f} outer iterations/s ({syncs:.1f} host syncs per '
            f'step), ELBO {elbo:.6e}; {smi}')
        torch.cuda.empty_cache()

        log('phase 6: CLI fit --learn-scaling, phase 4\'s schema, -K 12, '
            'kdim state')
        prefix = os.path.join(tmp, 'fit_se')
        counts, step_s, syncs, em = run_fit(
            paths, prefix, device,
            F32_BF16 + ['--learn-scaling', '--num-its', str(STEP_CAP_SE)])
        top, scaling = check_fit_outputs(prefix, n, K=582)
        remove_outputs(prefix)
        log(f'  launches {counts}; {len(step_s)} outer steps, host syncs '
            f'{syncs / max(len(step_s), 1):.1f} per step, median '
            f'{float(np.median(step_s)):.4f} s a step; EM events '
            f'{len(em)} (at steps {[e[0] for e in em]}); learned '
            f'error_scaling {scaling.tolist()}; max |posterior| '
            f'{top:.3e}')
        require(len(em) >= 1, f'no error-scaling EM event in '
                f'{len(step_s)} steps (cap {STEP_CAP_SE})')
        require(np.all(np.isfinite(scaling)) and not np.allclose(scaling, 1),
                f'error_scaling {scaling} was not learned')
        path_b = ('prologue_kdim', 'delta_sums_kdim')
        require_launched(counts, ('bucket_matvec_multi',) + path_b,
                         'phase 6')
        require(counts['prologue'] == counts['delta_sums'] == 0,
                'phase 6 ran a shared-state kernel on the kdim state')
        launches.update({k: counts[k] for k in path_b})

    log('phase 7: engine --learn-scaling, 1M SNPs, 2 cohorts, -K 12 grid, '
        'epoch-history state')
    counts, ips, syncs, st, em, K = run_engine_se(device, ld)
    log(f'  K = {K}; launches {counts}; {ips:.3f} outer iterations/s '
        f'({syncs:.1f} host syncs per step); nat_hist_n {st.nat_hist_n}; '
        f'error_scaling {st.error_scaling.tolist()}; ELBO {st.elbo:.6e}')
    path_c = ('prologue_epochs', 'delta_sums_epochs')
    require_launched(counts, ('bucket_matvec_multi',) + path_c, 'phase 7')
    launches.update({k: counts[k] for k in path_c})
    log(f'  all phases: {time.perf_counter() - t_start:.1f} s')

    log(smi)
    table = [dict(name=name, route='cuda', source=meta['source'],
                  replaces=meta['replaces'], launches=launches[name],
                  **results[name])
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
