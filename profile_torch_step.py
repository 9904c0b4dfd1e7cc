"""Where an outer step of the PyTorch port's engine spends its time on
one CUDA device.

    python3 profile_torch_step.py                      # 1M SNPs, K = 18
    python3 profile_torch_step.py --blocks 88 -K 582   # ~90K SNPs, K = 582
    python3 profile_torch_step.py -K 582               # 1M SNPs, K = 582
    python3 profile_torch_step.py --learn-scaling      # 1M SNPs, epoch state
    python3 profile_torch_step.py --blocks 489 --block-size 2048 \
        --ld-precision f32                             # 1M SNPs, f32 U in
                                                       # 2048-SNP blocks

Builds the engine as chip_smoke.py's phase 5 does (AR(1) blocks of
--block-size SNPs, 1024 by default, at half rank factored on the card, U
in --ld-precision, bf16 by default, 2 cohorts sharing the panel, f32),
runs 2 outer steps to warm up, times 10 more with the host clock
(outer iterations/s, host syncs per step), then traces 3 further steps
with torch.profiler. With --learn-scaling the fit learns the error
scaling on the CLI's -K 12 grid (582 components), as chip_smoke.py's
phase 7 does: at 1M SNPs the size rule selects the epoch-history state,
and one EM append after the warm-up gives the epoch kernels a live
epoch (at --blocks 88 the kdim state runs instead). From the trace's
timeline (chip_smoke.timeline) it prints the traced wall time, the
device's busy share (the union of kernel, memcpy and memset intervals
over that wall time; the rest is idle) and the device time of each
kernel, largest first. Imports nothing of JAX.
"""
import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WARMUP, STEPS, TRACED, TOP = 2, 10, 3, 12


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--blocks', type=int, default=977,
                        help='LD blocks of --block-size SNPs')
    parser.add_argument('--block-size', type=int, default=1024,
                        help='SNPs per LD block (rank: half of it)')
    parser.add_argument('--ld-precision', choices=('bf16', 'f32'),
                        default='bf16', help="U's storage type")
    parser.add_argument('-K', type=int, default=18,
                        help='mixture components (without --learn-scaling)')
    parser.add_argument('--learn-scaling', action='store_true',
                        help='learn the error scaling on the -K 12 grid')
    args = parser.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    if not torch.cuda.is_available():
        raise SystemExit('profile_torch_step.py needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, REPO)
    import chip_smoke
    from vilma_tpu_torch.inference import engine

    vi, st, _ = chip_smoke.build_engine(
        'cuda', num_blocks=args.blocks, block_size=args.block_size, K=args.K,
        scale_se=args.learn_scaling,
        u_dtype=torch.float32 if args.ld_precision == 'f32'
        else torch.bfloat16)
    data = vi.data
    for _ in range(WARMUP):
        st, _ = engine.outer_step(data, st)
    if args.learn_scaling:
        obj, pm, lk = engine._objective(data, st, engine._params(st),
                                        st.hyper_delta)
        st, _, _ = engine._update_error_scaling(
            data, st, engine._fetch(obj), pm, lk)
        print(f'state: {"epoch history" if vi._epoch else "kdim"}, '
              f'live epochs {st.nat_hist_n}, error_scaling '
              f'{st.error_scaling.tolist()}')
    torch.cuda.synchronize()
    syncs0 = engine.host_syncs
    t0 = time.perf_counter()
    for _ in range(STEPS):
        st, _ = engine.outer_step(data, st)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f'I={data.marginal_effects.shape[1]} K={vi.num_mix}: '
          f'{STEPS / dt:.3f} outer iterations/s over '
          f'{STEPS} steps, '
          f'{(engine.host_syncs - syncs0) / STEPS:.2f} host syncs '
          f'per step', flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function('outer_steps'):
            for _ in range(TRACED):
                st, _ = engine.outer_step(data, st)
            torch.cuda.synchronize()
    wall, busy, per_kernel = chip_smoke.timeline(
        chip_smoke.trace_events(prof))
    kernel_ms = sum(v[0] for v in per_kernel.values())
    print(f'  traced {TRACED} steps: wall {wall:.3f} ms, device busy '
          f'{busy:.3f} ms (share {busy / wall:.3f}), kernels '
          f'{kernel_ms:.3f} ms')
    for name, (ms, n) in sorted(per_kernel.items(),
                                key=lambda kv: -kv[1][0])[:TOP]:
        print(f'  {ms:10.3f} ms {n:5d}x  {ms / wall:6.1%}  {name[:90]}')


if __name__ == '__main__':
    main()
