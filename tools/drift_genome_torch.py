"""Genome-scale (1M-SNP) f32 / bf16-LD drift check of vilma_tpu_torch
against its own f64 fit on the host: tools/drift_genome.py's twin on the
port, as bench_torch.py is bench.py's.

Each leg runs in its own process; the f64 leg first, since the others
cast its cached LD pack:

    python tools/drift_genome_torch.py --leg f64cpu --out d64.npz
    python tools/drift_genome_torch.py --leg f32cpu --out d32h.npz
    python tools/drift_genome_torch.py --leg f32cuda --out d32.npz
    python tools/drift_genome_torch.py --leg bf16cuda --out dbf.npz
    python tools/drift_genome_torch.py --compare d64.npz d32.npz

Legs: f64cpu, f32cpu and bf16cpu fit on the host (device='cpu', the
kernels' plain versions); f32cuda and bf16cuda on the card through the
hand-written kernels. The f32 legs keep U in f32 (the CLI's default),
the bf16 legs store it in bf16 (BENCH_LD_DTYPE=bf16). So a card leg
against its host twin (f32cuda against f32cpu, bf16cuda against
bf16cpu, both against f64cpu) shows what drift the kernels add. A card
leg without a CUDA device raises.

The problem is bench_torch._build's (bench.py's generator; BENCH_SIZE=1m
unless set, and bench_torch's BENCH_LOCI, BENCH_SCALE_SE and BENCH_GRID),
its LD in --block-size-SNP blocks at half rank: 1024 by default, 2048
puts the matvec on its group route. The LD pack is cached where
bench_torch caches it (.bench_cache/ beside bench_torch.py).

Every leg takes --iters outer steps (ITERS by default) of
engine.outer_step at line-search rate 2, evaluating the reference's two
convergence tests after each, and saves drift_genome.py's keys (final
posterior mean and marginal variance, accumulated and recomputed ELBO,
convergence flags) and three more: launches (the kernel launch counts
over the steps, as chip_smoke.py reads them, JSON), device (the card's
name and power limit as nvidia-smi prints them; 'cpu' on the host) and
seconds (of the steps). A card leg fails if its matvec route or the two
compact kernels of its state form launched no time.

--compare BASE TEST prints drift_genome.py's report (the same keys and
arithmetic), then the bands of tests/test_f32_genome_scale.py that TEST
misses against BASE (out_of_band). Imports nothing of JAX.
"""
import argparse
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

# bench_torch.py and chip_smoke.py live one level up from tools/
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

print = functools.partial(print, flush=True)  # noqa: A001

ITERS = 40
BLOCK_SIZE = 1024
# leg -> (dtype, device, U stored in bf16)
LEGS = {'f64cpu': ('float64', 'cpu', False),
        'f32cpu': ('float32', 'cpu', False),
        'bf16cpu': ('float32', 'cpu', True),
        'f32cuda': ('float32', 'cuda', False),
        'bf16cuda': ('float32', 'cuda', True)}

# tests/test_f32_genome_scale.py's bands, a TEST leg against an f64 BASE:
# 99.9% of SNPs within 2 posterior SDs, at most 0.2% beyond 3, the median
# absolute difference below 1e-3 of the posterior scale, the recomputed
# ELBOs within 5e-3 relative, first convergence within 2 iterations
BANDS = {'post_sd_units_q999': 2.0, 'post_sd_units_frac_gt3': 2e-3,
         'post_median_absdiff_rel_scale': 1e-3,
         'recomputed_elbo_rel_diff': 5e-3}
BAND_CONV_ITERS = 2
# the ELBO accumulator against the recomputed ELBO: gated at 100K SNPs
# (the f64 base within 1e-9, the test leg within 1e-5), reported at 1M
BAND_ACC_BASE = 1e-9
BAND_ACC_TEST = 1e-5


def state_kernels(st):
    """The compact kernels of a state's form (chip_smoke.read_counts
    keys)."""
    if st.nat_hist is not None:
        return ('prologue_epochs', 'delta_sums_epochs')
    if st.nat_mu.dim() == 3:
        return ('prologue_kdim', 'delta_sums_kdim')
    return ('prologue', 'delta_sums')


def matvec_keys(data):
    """The launch counters of the matvec routes the planner
    (ops/cuda/block_matvec.plan) picks for `data`'s LD buckets."""
    from vilma_tpu_torch.ops.cuda import block_matvec
    keys = set()
    for m, ld in enumerate(data.ld):
        C = sum(1 for p in data.ld_index if p == m)
        if not C:
            continue
        for bk in ld.buckets:
            _, P, R = bk.u.shape
            pl = block_matvec.plan(P, R, bk.u.element_size(),
                                   block_matvec.width(C))
            if pl.route == 'cluster':
                keys.add('bucket_matvec_multi')
            else:
                keys.add('bucket_matvec_multi_group')
                if bk.u.dtype.itemsize == 2:
                    keys.add('bucket_matvec_multi_group_bf16')
    return sorted(keys)


def fit(data, st, iters=ITERS, report_every=10):
    """drift_genome.py's loop on the port: `iters` outer steps, the
    reference's convergence tests after each (the posterior mean of the
    materialized state against the last one's, or the running ELBO
    delta near 0), then the final posterior mean and marginal variance,
    the accumulated and the recomputed ELBO. Returns a dict of those
    (numpy arrays and floats) and the steps' seconds."""
    from vilma_tpu_torch.inference import engine

    def host(x):
        return x.detach().cpu().numpy()

    conv = []
    post_prev = None
    t0 = time.perf_counter()
    for it in range(iters):
        st, _ = engine.outer_step(data, st, line_search_rate=2.0)
        m = engine.materialize_state(data, st)
        pm = host(engine.posterior_mean(m.vi_mu, m.vi_delta))
        red = float(st.running_elbo_delta)
        c = (post_prev is not None
             and np.allclose(pm, post_prev, atol=engine.ABS_TOL,
                             rtol=engine.REL_TOL)
             or np.isclose(red, 0, atol=engine.ELBO_TOL, rtol=0))
        conv.append(bool(c))
        post_prev = pm
        if report_every and it % report_every == 0:
            print(f'  it {it}: elbo={float(st.elbo):.3f} '
                  f'({time.perf_counter() - t0:.0f}s)')
    seconds = time.perf_counter() - t0

    m = engine.materialize_state(data, st)
    mean = engine.posterior_mean(m.vi_mu, m.vi_delta)
    pmv = engine.posterior_marginal_variance(mean, m.vi_mu, m.vi_delta,
                                             m.sigma)
    true = float(engine.elbo(data, m.sigma, m.error_scaling, m.vi_mu,
                             m.vi_delta, m.hyper_delta))
    return dict(post=host(mean), pmv=host(pmv), acc=float(st.elbo),
                true=true, conv=np.asarray(conv), seconds=seconds)


def run_leg(leg, out_path, block_size=BLOCK_SIZE, iters=ITERS):
    dtype_name, device_type, bf16 = LEGS[leg]
    if bf16:
        os.environ['BENCH_LD_DTYPE'] = 'bf16'
    else:
        os.environ.pop('BENCH_LD_DTYPE', None)
    os.environ.setdefault('BENCH_SIZE', '1m')

    import torch
    import bench_torch
    from chip_smoke import read_counts, zero_counts

    if device_type == 'cuda' and not torch.cuda.is_available():
        raise SystemExit(f'drift_genome_torch.py: leg {leg} needs a CUDA '
                         'device (the legs ending in cpu run on the host)')
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(device_type)
    dtype = getattr(torch, dtype_name)
    print(f'leg={leg} device={device} dtype={dtype_name} '
          f'loci={bench_torch.NUM_LOCI} block_size={block_size}')
    data, st = bench_torch._build(dtype, device, block_size=block_size)

    zero_counts()
    out = fit(data, st, iters)
    launches = read_counts()
    if device_type == 'cuda':
        need = matvec_keys(data) + list(state_kernels(st))
        idle = [k for k in need if not launches[k]]
        if idle:
            raise SystemExit(f'leg {leg}: {idle} never launched; launches '
                             f'{launches}')
        where = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            check=True).stdout.strip()
    else:
        where = 'cpu'
    print(f'launches {json.dumps({k: n for k, n in launches.items() if n})}'
          f'; {where}')
    np.savez(out_path, leg=leg, post=out['post'], pmv=out['pmv'],
             acc=out['acc'], true=out['true'], conv=out['conv'],
             launches=json.dumps(launches), device=where,
             seconds=out['seconds'])
    print(f'saved {out_path}: acc={out["acc"]:.4f} true={out["true"]:.4f} '
          f'({out["seconds"]:.0f}s of steps)')


def compare(base_path, test_path):
    """drift_genome.py's report of TEST against BASE, printed and
    returned; 'iters' counts the test leg's steps (drift_genome.py prints
    its fixed ITERS, which its legs all take)."""
    b = np.load(base_path, allow_pickle=True)
    t = np.load(test_path, allow_pickle=True)
    sd = np.sqrt(np.maximum(b['pmv'], 0))
    rel = np.abs(t['post'] - b['post']) / np.maximum(sd, 1e-12)
    scale = np.abs(b['post']).max()
    med = float(np.median(np.abs(t['post'] - b['post']))) / scale
    conv_b = np.asarray(b['conv'])
    conv_t = np.asarray(t['conv'])
    fb = int(np.argmax(conv_b)) if conv_b.any() else -1
    ft = int(np.argmax(conv_t)) if conv_t.any() else -1
    rep = {
        'base': str(b['leg']), 'test': str(t['leg']), 'iters': len(conv_t),
        'elbo_accumulator_drift_base':
            abs(float(b['acc']) - float(b['true'])) / abs(float(b['true'])),
        'elbo_accumulator_drift_test':
            abs(float(t['acc']) - float(t['true'])) / abs(float(t['true'])),
        'recomputed_elbo_rel_diff':
            abs(float(t['true']) - float(b['true'])) / abs(float(b['true'])),
        'post_sd_units_q999': float(np.quantile(rel, 0.999)),
        'post_sd_units_frac_gt3': float(np.mean(rel > 3.0)),
        'post_median_absdiff_rel_scale': med,
        'first_convergence_iter': [fb, ft],
    }
    print(json.dumps(rep, indent=2))
    return rep


def out_of_band(rep, accumulator=True):
    """The keys of a compare() report outside their bands; with
    accumulator, the ELBO accumulator's bounds are gated too."""
    out = [k for k, bound in BANDS.items() if not rep[k] <= bound]
    fb, ft = rep['first_convergence_iter']
    if (fb != ft if min(fb, ft) < 0 else abs(fb - ft) > BAND_CONV_ITERS):
        out.append('first_convergence_iter')
    if accumulator:
        for key, bound in (('elbo_accumulator_drift_base', BAND_ACC_BASE),
                           ('elbo_accumulator_drift_test', BAND_ACC_TEST)):
            if not rep[key] <= bound:
                out.append(key)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--leg', choices=list(LEGS))
    ap.add_argument('--out')
    ap.add_argument('--block-size', type=int, default=BLOCK_SIZE)
    ap.add_argument('--iters', type=int, default=ITERS)
    ap.add_argument('--compare', nargs=2)
    args = ap.parse_args()
    if args.compare:
        rep = compare(*args.compare)
        print(f'out of band: {out_of_band(rep)} with the accumulator '
              f'gated (100K), {out_of_band(rep, False)} without (1M)')
    elif args.leg:
        if not args.out:
            ap.error('--leg needs --out')
        run_leg(args.leg, args.out, args.block_size, args.iters)
    else:
        ap.error('need --leg/--out or --compare')


if __name__ == '__main__':
    sys.exit(main())
