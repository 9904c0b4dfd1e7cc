"""Time the P x P algebra of the port's materialized path (P >= 4) on one
CUDA device: models/sigma.py's apply_sigma, make_summaries and
sigma_weighted_sum on the checkout this script sits in.

    python3 profile_torch_sigma.py                    # K = 1,953, P = 4,
                                                      # 90,112 SNPs
    python3 profile_torch_sigma.py -K 216 --snps 1000448

The default shape is chip_smoke.py phase 13a's (`fit --trait` of 4 traits,
-K 3 --drop-non-psd); -K 216 --snps 1000448 is phase 13b's. Seeded
positive definite mixture precisions, diagonal terms and operands at
f32; one warm-up call of each function, then the CUDA-event mean of
--reps calls and the peak device memory above the operands. Prints one
JSON line. To compare two versions, run it from both checkouts in one
call. Imports nothing of JAX.
"""
import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))


def cuda_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('-K', type=int, default=1953)
    ap.add_argument('-P', type=int, default=4)
    ap.add_argument('--snps', type=int, default=90_112)
    ap.add_argument('--reps', type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('profile_torch_sigma.py needs a CUDA device')
    from vilma_tpu_torch.models import sigma
    K, P, I = args.K, args.P, args.snps
    gen = torch.Generator(device='cuda').manual_seed(0)
    a = torch.randn(K, P, P, generator=gen, device='cuda')
    prec = (a @ a.transpose(1, 2) + P * torch.eye(P, device='cuda')) * 1e3
    dterm = torch.rand(P, I, generator=gen, device='cuda') * 1e5
    x = torch.randn(K, P, I, generator=gen, device='cuda')
    delta = torch.softmax(torch.randn(K, I, generator=gen, device='cuda'), 0)
    log_det = torch.zeros(K, device='cuda')
    calls = dict(
        apply_sigma=lambda: sigma.apply_sigma(prec, dterm, x),
        make_summaries=lambda: sigma.make_summaries(prec, log_det, dterm),
        sigma_weighted_sum=lambda: sigma.sigma_weighted_sum(prec, dterm,
                                                            delta))
    out = dict(repo=REPO, K=K, P=P, snps=I,
               chunk=sigma._chunk_len(prec, I),
               card=subprocess.run(
                   ['nvidia-smi', '--query-gpu=name,power.limit',
                    '--format=csv,noheader'], capture_output=True,
                   text=True).stdout.strip())
    base = torch.cuda.memory_allocated()
    for name, fn in calls.items():
        torch.cuda.reset_peak_memory_stats()
        out[name + '_ms'] = cuda_ms(fn, args.reps)
        out[name + '_peak_gib'] = (torch.cuda.max_memory_allocated()
                                   - base) / 2**30
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
