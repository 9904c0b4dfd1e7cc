"""Per-evaluation cost across problem sizes: tools/eval_scaling.py's twin
on vilma_tpu_torch.

An outer step's time depends on its trajectory: the line search takes
another number of trials at another start point. This tool times ONE
compact objective evaluation, the unit the line search repeats (the
prologue kernel, the block matvec over every bucket, the likelihood),
chained, at each size: a per-evaluation cost that does not depend on
the trajectory.

    python3 tools/eval_scaling_torch.py [loci ...]
    # defaults: 250000 500000 1000000; one child process per size
    BENCH_GRID=cli BENCH_SCALE_SE=1 python3 tools/eval_scaling_torch.py 1000000

Each child (EVAL_CHILD=1, BENCH_LOCI=<size>; its argument is the chain
length, 200 by default) builds bench_torch._build's problem, U in bf16
unless BENCH_LD_DTYPE says otherwise, on the state form bench_torch
picks from BENCH_SCALE_SE and BENCH_GRID: shared [P, I], kdim [K, P, I]
or epoch history. It chains engine._objective(data, st,
engine._params(st), hyper_delta) and prints

* EVAL_MS: host milliseconds an evaluation, the best of 3 chains, each
  between two torch.cuda.synchronize() calls: what the eager line
  search pays;
* EVAL_DETAIL (JSON): the device's busy ms an evaluation (the union of
  the device intervals over a traced chain, as profile_torch_step.py
  computes busy; at small sizes the host's enqueue sets the pace, and
  the JAX tool's number has no host in it), the launches an evaluation
  of each kernel (the wrappers' counters), the host syncs over the
  timed chains (0), set-up seconds, and the peak device memory of the
  set-up and of the chains, each after reset_peak_memory_stats();
* TOP_OFFSET (JSON): the kernels against their plain versions, run on
  the same slices' operands, at the highest offsets, where a 32-bit
  offset would show: the prologue's post_means and post_vars over the
  last 65,536 SNPs, the matvec's output over the last 64 blocks of the
  largest bucket, within chip_smoke.py's phase-3 bands. A miss exits
  nonzero before EVAL_MS.

The main process prints the JAX tool's table: SNPs, ms/evaluation,
ns/SNP, eff vs largest.

The chain. Eager PyTorch neither batches nor deduplicates launches, and
the stream orders them; still, each evaluation's hyper_delta ([A, K], a
few KB) takes a vanishing multiple of the previous objective, so the
evaluations depend on each other through the data. The JAX tool's
`nat + 1e-30 * obj` would add, and time, a full pass over the natural
mean: [K, P, I] on the kdim state. The objectives are summed on the
device in float64 (50 equal float32 values sum exactly), and no host
sync happens inside a chain.

Device. BENCH_DEVICE (cuda by default); without a card the run exits
nonzero and prints no number. BENCH_DEVICE=cpu asks for the host: the
kernels' plain versions at float64, no busy time or device memory.

Imports nothing of JAX.
"""
import functools
import json
import math
import os
import subprocess
import sys
import time

# bench_torch.py and chip_smoke.py live one level up from tools/
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

print = functools.partial(print, flush=True)  # noqa: A001

N_EVALS = 200
REPS = 3
TOP_SNPS = 65_536
TOP_BLOCKS = 64


def state_form(st):
    """'shared', 'kdim' or 'epoch'."""
    if st.nat_hist is not None:
        return 'epoch'
    return 'kdim' if st.nat_mu.dim() == 3 else 'shared'


def chain(data, st, n):
    """The float64 sum, on the device, of `n` chained evaluations of the
    objective at st's parameters: each evaluation's hyper_delta is the
    previous one's plus 1e-30 times its objective."""
    import torch
    from vilma_tpu_torch.inference import engine
    params = engine._params(st)
    hyper_delta = st.hyper_delta
    acc = torch.zeros((), dtype=torch.float64, device=hyper_delta.device)
    for _ in range(n):
        obj, _, _ = engine._objective(data, st, params, hyper_delta)
        hyper_delta = hyper_delta + 1e-30 * obj
        acc = acc + obj
    return acc


def _sync(data):
    import bench_torch
    bench_torch._sync(bench_torch._devices(data))


def measure(data, st, n_evals, reps=REPS):
    """Host ms an evaluation (the best of `reps` chains of `n_evals`,
    after a warm-up chain of 3), the last chain's sum, the launches of
    each kernel and the host syncs over the timed chains."""
    from chip_smoke import read_counts, zero_counts
    from vilma_tpu_torch.inference import engine
    chain(data, st, 3)
    _sync(data)
    zero_counts()
    syncs0 = engine.host_syncs
    best = math.inf
    for _ in range(reps):
        _sync(data)
        t0 = time.perf_counter()
        acc = chain(data, st, n_evals)
        _sync(data)
        best = min(best, time.perf_counter() - t0)
    counts = {k: v for k, v in read_counts().items() if v}
    return dict(host_ms=best / n_evals * 1e3, total=float(acc),
                evals=reps * n_evals, launches=counts,
                host_syncs=engine.host_syncs - syncs0)


def busy_ms(data, st, n_evals):
    """(device busy ms, traced wall ms) an evaluation over one traced
    chain: chip_smoke.timeline's union of the device intervals."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from chip_smoke import timeline, trace_events
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function('eval_chain'):
            chain(data, st, n_evals)
        torch.cuda.synchronize()
    wall, busy, _ = timeline(trace_events(prof), span='eval_chain')
    return busy / n_evals, wall / n_evals


def top_offset_check(data, st):
    """The prologue over the last TOP_SNPS SNPs and the matvec over the
    last TOP_BLOCKS blocks of the largest bucket against their plain
    versions on the same slices' operands: scaled errors, bands, ok."""
    import torch
    from chip_smoke import BAND_BF16, BAND_F32, max_err
    from vilma_tpu_torch.inference import engine
    from vilma_tpu_torch.ops import blocks
    from vilma_tpu_torch.ops.cuda import block_matvec, compact_obj
    A = data.num_annotations
    params = engine._params(st)
    if st.nat_hist is None:
        ops = engine._fused_operands(data, st.error_scaling, params[0],
                                     st.hyper_delta)
        kernel, plain, kw = (compact_obj.prologue,
                             compact_obj.prologue_plain, {})
        per_snp = (2, 3, 4)          # annotations, dterm, nat_mu
    else:
        ops = engine._epoch_operands(data, st, *params, st.hyper_delta)
        kernel, plain = (compact_obj.prologue_epochs,
                         compact_obj.prologue_epochs_plain)
        kw = dict(num_live=st.nat_hist_n)
        per_snp = (2, 3, 4, 5)       # annotations, sld, nat_u, hist_v
    pm, pv, _ = kernel(*ops, num_annotations=A, **kw)
    P, I = pm.shape
    i0 = max(0, I - TOP_SNPS)
    top = [op[..., i0:] if j in per_snp else op for j, op in enumerate(ops)]
    ppm, ppv, _ = plain(*top, num_annotations=A, **kw)
    out = dict(snps=I - i0, first_snp=i0,
               post_means=max_err(pm[:, i0:], ppm)[1],
               post_vars=max_err(pv[:, i0:], ppv)[1], band_prologue=BAND_F32)

    m = data.ld_index[0]
    pops = [p for p in range(P) if data.ld_index[p] == m]
    scaled = pm[pops] / data.std_errs[pops]
    bk = max(data.ld[m].buckets, key=lambda b: b.u.numel())
    x = blocks._extend(scaled)[:, bk.perm].permute(1, 0, 2).contiguous()
    y = block_matvec.bucket_matvec_multi(bk.u, bk.s, bk.d, x)
    B, Pb, R = bk.u.shape
    b0 = max(0, B - TOP_BLOCKS)
    want = block_matvec.bucket_matvec_multi_plain(
        bk.u[b0:], bk.s[b0:], bk.d[b0:], x[b0:])
    band = BAND_BF16 if bk.u.dtype == torch.bfloat16 else BAND_F32
    out.update(blocks=B - b0, bucket=[B, Pb, R],
               u_dtype=str(bk.u.dtype).replace('torch.', ''),
               first_u_element=b0 * Pb * R, u_elements=B * Pb * R,
               matvec=max_err(y[b0:], want)[1], band_matvec=band)
    out['ok'] = bool(out['post_means'] <= BAND_F32
                     and out['post_vars'] <= BAND_F32
                     and out['matvec'] <= band)
    return out


def child():
    import torch
    import bench_torch
    n_evals = int(sys.argv[1]) if len(sys.argv) > 1 else N_EVALS
    os.environ.setdefault('BENCH_LD_DTYPE', 'bf16')
    torch.backends.cuda.matmul.allow_tf32 = False
    device = bench_torch._leg_device()
    dtype = torch.float32 if device.type == 'cuda' else torch.float64
    bench_torch._peak_gib(device)            # resets the peak
    t0 = time.perf_counter()
    data, st = bench_torch._build(dtype, device)
    _sync(data)
    setup_s = time.perf_counter() - t0
    setup_peak = bench_torch._peak_gib(device)
    m = measure(data, st, n_evals)
    chain_peak = bench_torch._peak_gib(device)
    busy = wall = None
    if device.type == 'cuda':
        busy, wall = busy_ms(data, st, n_evals)
    top = top_offset_check(data, st)
    print('EVAL_DETAIL', json.dumps(dict(
        snps=bench_torch.NUM_LOCI, state=state_form(st),
        K=st.hyper_delta.shape[1], device=bench_torch._device_name(device),
        host_ms=m['host_ms'], busy_ms=busy, traced_wall_ms=wall,
        launches_per_eval={k: v / m['evals']
                           for k, v in m['launches'].items()},
        host_syncs=m['host_syncs'], setup_s=setup_s,
        setup_peak_gib=setup_peak, chain_peak_gib=chain_peak,
        objective_sum=m['total'])))
    print('TOP_OFFSET', json.dumps(top))
    if m['host_syncs']:
        sys.exit(f'{m["host_syncs"]} host syncs inside the timed chains')
    if not math.isfinite(m['total']):
        sys.exit(f'non-finite objective sum {m["total"]}')
    if not top['ok']:
        sys.exit('the top-offset check missed its bands')
    print(f'EVAL_MS {m["host_ms"]:.4f}')


def time_size(num_loci, n_evals=N_EVALS):
    """ms an evaluation at `num_loci` SNPs, from a child process whose
    output is relayed; raises if the child fails."""
    env = dict(os.environ, BENCH_LOCI=str(num_loci), EVAL_CHILD='1')
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          str(n_evals)], capture_output=True, text=True,
                         timeout=3000, env=env)
    print(out.stdout, end='')
    if out.returncode == 0:
        for line in out.stdout.splitlines():
            if line.startswith('EVAL_MS'):
                return float(line.split()[1])
    raise RuntimeError(f'the child at {num_loci} SNPs exited '
                       f'{out.returncode}: {out.stderr[-2000:]}')


def main():
    import bench_torch
    bench_torch._leg_device()        # no card, no BENCH_DEVICE=cpu: exit
    sizes = ([int(float(s)) for s in sys.argv[1:]]
             or [250_000, 500_000, 1_000_000])
    rows = [(n, time_size(n)) for n in sizes]
    print(f'{"SNPs":>10} {"ms/evaluation":>14} {"ns/SNP":>8} '
          f'{"eff vs largest":>15}')
    big_n, big_ms = rows[-1]
    for n, ms in rows:
        eff = big_ms / (ms * (big_n / n))
        print(f'{n:>10,} {ms:>14.3f} {ms * 1e6 / n:>8.1f} '
              f'{eff:>14.1%}')


if __name__ == '__main__':
    if os.environ.get('EVAL_CHILD'):
        child()
    else:
        main()
