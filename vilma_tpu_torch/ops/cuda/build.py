"""Build and load the port's CUDA kernels (vilma_tpu_torch/csrc/*.cu).

The sources have a plain C interface (no PyTorch headers), so nvcc
builds them in seconds into one shared library for sm_90a (Hopper),
loaded with ctypes: one nvcc per source, all started together, then one
link. The build runs at first use, from the checkout's sources alone,
into vilma_tpu_torch/build/ (ignored by git); the library name carries a
hash of the sources and headers, so an edited file is rebuilt.

A second library, the measurement build (`library('stamps')`), holds
block_matvec.cu alone compiled with -DVILMA_MATVEC_STAMPS: its group
route records per-block %globaltimer stamps of one CTA. chip_smoke.py
phase 3 loads it beside the main library; the fit never does.

Nothing here runs on import: the CPU tests import every module, and
there is no nvcc where they run.
"""
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG / 'build'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC']

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: every pointer and the stream are void*, counts int
SIGNATURES = {
    'vilma_block_matvec_group': [_P] * 7 + [_I] * 11 + [_P],
    'vilma_block_matvec_group_fit': [_I] * 8 + [_P],
    'vilma_block_matvec_cluster': [_P] * 5 + [_I] * 9 + [_P],
    'vilma_block_matvec_cluster_fit': [_I] * 7 + [_P],
    'vilma_compact_prologue': [_P] * 9 + [_I] * 6 + [_F, _P],
    'vilma_compact_delta_sums': [_P] * 8 + [_I] * 7 + [_F, _P],
    'vilma_compact_prologue_epochs': [_P] * 12 + [_I] * 7 + [_F, _P],
    'vilma_compact_delta_sums_epochs': [_P] * 11 + [_I] * 8 + [_F, _P],
}
# the K-split forms (component sharding) and the prologue's merge
SIGNATURES.update({
    'vilma_compact_prologue_partial': [_P] * 6 + [_I] * 6 + [_F, _P],
    'vilma_compact_delta_norm': [_P] * 6 + [_I] * 6 + [_F, _P],
    'vilma_compact_delta_sums_given': [_P] * 8 + [_I] * 8 + [_F, _P],
    'vilma_compact_prologue_epochs_partial': [_P] * 9 + [_I] * 7 + [_F, _P],
    'vilma_compact_delta_norm_epochs': [_P] * 9 + [_I] * 7 + [_F, _P],
    'vilma_compact_delta_sums_epochs_given': [_P] * 11 + [_I] * 9
    + [_F, _P],
    'vilma_compact_merge': [_P] * 4 + [_I] * 6 + [_P],
})
# the kdim forms take the same arguments as the shared-state entry points
for _kdim, _shared in (
        ('prologue_kdim', 'prologue'), ('delta_sums_kdim', 'delta_sums'),
        ('prologue_kdim_partial', 'prologue_partial'),
        ('delta_norm_kdim', 'delta_norm'),
        ('delta_sums_kdim_given', 'delta_sums_given')):
    SIGNATURES['vilma_compact_' + _kdim] = SIGNATURES[
        'vilma_compact_' + _shared]

# the measurement build: its sources, extra nvcc flags, extra entry
# points (the stamp buffer's setter) and the entry point that returns the
# stamp points' names (a C string)
VARIANTS = {
    'stamps': dict(sources=('block_matvec.cu',),
                   flags=['-DVILMA_MATVEC_STAMPS'],
                   signatures={'vilma_block_matvec_stamps': [_P, _I]},
                   names='vilma_block_matvec_stamp_points'),
}

_libs = {}
#: wall seconds the last build took (None until a build ran here)
build_seconds = None
#: what ptxas (-Xptxas -v) reported for every kernel of the last build
#: here: registers, shared memory, spills (None until a build ran here)
ptxas_report = None


def _nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    path = os.path.join(cuda_home, 'bin', 'nvcc')
    if os.path.exists(path):
        return path
    raise RuntimeError('nvcc not found (looked on PATH and in $CUDA_HOME/'
                       'bin); the CUDA kernels are built from source at '
                       'first use on a CUDA device')


def _sources(variant=None):
    if variant is None:
        return sorted(CSRC.glob('*.cu'))
    return [CSRC / name for name in VARIANTS[variant]['sources']]


def _flags(variant=None):
    return NVCC_FLAGS + (VARIANTS[variant]['flags'] if variant else [])


def library_path(variant=None):
    digest = hashlib.sha256()
    for src in sorted(CSRC.glob('*.cu*')):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(' '.join(_flags(variant)).encode())
    stem = 'libvilma_kernels' if variant is None else f'libvilma_{variant}'
    return BUILD_DIR / f'{stem}_{digest.hexdigest()[:16]}.so'


def build(verbose=False, variant=None):
    """Compile every csrc/*.cu (or a variant's sources, with its flags)
    into one shared library (if not built yet) and return its path."""
    global build_seconds, ptxas_report
    out = library_path(variant)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f'{out.stem}.{os.getpid()}'
    flags = _flags(variant) + ['-Xptxas', '-v']
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in _sources(variant):
        obj = BUILD_DIR / f'{src.stem}.{tag}.o'
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc] + flags + ['-c', '-o', str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors, notes = [], []
    for src, proc in procs:
        _, err = proc.communicate()
        (errors if proc.returncode else notes).append(f'{src.name}:\n{err}')
    if not errors:
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        link = subprocess.run([nvcc] + _flags(variant)
                              + ['-shared', '-o', str(tmp)]
                              + [str(o) for o in objs],
                              capture_output=True, text=True)
        if link.returncode:
            errors.append('link:\n' + link.stderr)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if variant is None:
        build_seconds = time.perf_counter() - t0
        ptxas_report = '\n'.join(notes)
    if errors:
        raise RuntimeError('nvcc failed:\n' + '\n'.join(errors)[-8000:])
    if verbose:
        print('\n'.join(notes))
    os.replace(tmp, out)
    return out


def kernel_resources(report):
    """{kernel: dict(registers, smem, stack, spill_stores, spill_loads)}
    from a ptxas report, kernels by their demangled names where cu++filt
    is found beside nvcc."""
    found, name = {}, None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            found.setdefault(name, {})
            continue
        m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
                      r'(\d+) bytes spill loads', line)
        if m and name:
            found[name].update(stack=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r'Used (\d+) registers', line)
        if m and name:
            smem = re.search(r'(\d+) bytes smem', line)
            found[name].update(registers=int(m.group(1)),
                               smem=int(smem.group(1)) if smem else 0)
    names = list(found)
    try:
        filt = Path(_nvcc()).with_name('cu++filt')
        out = subprocess.run([str(filt)] + names, capture_output=True,
                             text=True, check=True).stdout.splitlines()
        if len(out) == len(names):
            return dict(zip(out, found.values()))
    except (OSError, RuntimeError, subprocess.CalledProcessError):
        pass
    return found


def library(variant=None):
    """The loaded kernel library (or a variant of it: VARIANTS), built on
    first use."""
    if variant not in _libs:
        lib = ctypes.CDLL(str(build(variant=variant)))
        signatures = SIGNATURES
        if variant is not None:
            signatures = {k: v for k, v in SIGNATURES.items()
                          if k.startswith('vilma_block_matvec')}
            signatures.update(VARIANTS[variant]['signatures'])
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        if variant is not None:
            getattr(lib, VARIANTS[variant]['names']).restype = ctypes.c_char_p
        _libs[variant] = lib
    return _libs[variant]


def check(status, name):
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f'{name}: CUDA error {status} at launch')


def stream_handle(device):
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def on_operands_device(launcher):
    """Run a kernel launcher on the card of its first CUDA tensor
    operand: the C entry points and the occupancy and shared-memory
    queries act on the runtime's current device, which need not be the
    operands' (a shard on cuda:1 while cuda:0 is current)."""
    import functools
    import torch

    @functools.wraps(launcher)
    def launch(*args, **kwargs):
        dev = next((a.device for a in args
                    if isinstance(a, torch.Tensor) and a.is_cuda), None)
        if dev is None:
            return launcher(*args, **kwargs)
        with torch.cuda.device(dev):
            return launcher(*args, **kwargs)
    return launch
