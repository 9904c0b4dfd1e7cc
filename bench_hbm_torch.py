"""Raw device-memory read-bandwidth probe of the card: bench_hbm.py's twin
on PyTorch.

Measures the card's streaming ceiling for large footprints, beside the
published 3.35 TB/s that PERF.md's bounds keep. A pass is a plain full
read reduction: torch.sum of a float32 tensor, added to a device
accumulator (bench_hbm.py reduces outside Pallas too, so this is its
counterpart, not a kernel port). Each footprint prints the best of 3
chains of HBM_CHAIN passes, each chain between two
torch.cuda.synchronize() calls on the host clock, in bench_hbm.py's line
format: GiB read per second and ms a pass.

    python3 bench_hbm_torch.py
    HBM_CHAIN=30 HBM_SIZES=64,256,1024,4096 python3 bench_hbm_torch.py

Unlike bench_hbm.py's body, a pass does not scale the tensor by the
accumulator first: in eager PyTorch that writes a temporary the size of
the footprint and reads it back, and the probe would report about a
third of the read rate. The stream orders the passes and eager PyTorch
elides none. The tensor is drawn on the device (torch.randn from a
seeded generator); its values do not matter to a read.

Footprints up to twice the card's 50 MB L2 cache are partly served from
it: their lines say so. BENCH_DEVICE (cuda by default) names the device;
without a card the run exits nonzero and prints no number, and
BENCH_DEVICE=cpu asks for the host. Imports nothing of JAX.
"""
import functools
import math
import os
import time

print = functools.partial(print, flush=True)  # noqa: A001

L2_BYTES = 50 * 10**6
REPS = 3


def device():
    """BENCH_DEVICE, cuda by default; an absent card exits nonzero."""
    import torch
    dev = torch.device(os.environ.get('BENCH_DEVICE', 'cuda'))
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise SystemExit('bench_hbm_torch.py: no CUDA device is available '
                         '(BENCH_DEVICE=cpu runs the probe on the host)')
    return dev


def _sync(dev):
    import torch
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def probe(mb, chain, dev):
    """(GiB/s, ms a pass) of the best of REPS chains of `chain` full read
    reductions of an `mb`-MiB float32 tensor on `dev`."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(mb * 2**20 // 4, generator=gen, device=dev)
    acc = torch.zeros((), device=dev)

    def run(acc):
        for _ in range(chain):
            acc = acc + torch.sum(x)
        return acc

    acc = run(acc)                       # warm-up
    best = math.inf
    for _ in range(REPS):
        _sync(dev)
        t0 = time.perf_counter()
        acc = run(acc)
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    if not math.isfinite(float(acc)):
        raise RuntimeError(f'non-finite sum at {mb} MiB')
    return mb / 1024 * chain / best, best / chain * 1e3


def line(mb, gib_s, ms, dev):
    """bench_hbm.py's line, and on the card a note where the footprint
    is at most twice its L2 cache."""
    text = f'{mb:5d} MiB footprint: {gib_s:7.1f} GiB/s ({ms:.2f} ms/pass)'
    if dev.type == 'cuda' and mb * 2**20 <= 2 * L2_BYTES:
        text += (f'  [at most 2x the card\'s {L2_BYTES // 10**6} MB L2: '
                 'partly served from it]')
    return text


def main():
    import torch
    dev = device()
    name = torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'
    print('device:', name)
    chain = int(os.environ.get('HBM_CHAIN', '30'))
    sizes = tuple(int(s) for s in os.environ.get(
        'HBM_SIZES', '64,256,1024,4096').split(','))
    for mb in sizes:
        print(line(mb, *probe(mb, chain, dev), dev))
        if dev.type == 'cuda':
            torch.cuda.empty_cache()


if __name__ == '__main__':
    main()
