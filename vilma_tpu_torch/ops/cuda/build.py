"""Build and load the port's CUDA kernels (vilma_tpu_torch/csrc/*.cu).

The sources have a plain C interface (no PyTorch headers), so nvcc
builds them in seconds into one shared library for sm_90a (Hopper),
loaded with ctypes: one nvcc per source, all started together, then one
link. The build runs at first use, from the checkout's sources alone,
into vilma_tpu_torch/build/ (ignored by git); the library name carries a
hash of the sources and headers, so an edited file is rebuilt.

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
    'vilma_block_matvec_group': [_P] * 6 + [_I] * 10 + [_P],
    'vilma_block_matvec_group_fit': [_I] * 7 + [_P],
    'vilma_block_matvec_cluster': [_P] * 5 + [_I] * 9 + [_P],
    'vilma_block_matvec_cluster_fit': [_I] * 7 + [_P],
    'vilma_compact_prologue': [_P] * 9 + [_I] * 6 + [_F, _P],
    'vilma_compact_delta_sums': [_P] * 8 + [_I] * 7 + [_F, _P],
    'vilma_compact_prologue_epochs': [_P] * 12 + [_I] * 7 + [_F, _P],
    'vilma_compact_delta_sums_epochs': [_P] * 11 + [_I] * 8 + [_F, _P],
}
# the K-split forms (component sharding) and their merges
SIGNATURES.update({
    'vilma_compact_prologue_partial': [_P] * 6 + [_I] * 6 + [_F, _P],
    'vilma_compact_delta_norm': [_P] * 6 + [_I] * 6 + [_F, _P],
    'vilma_compact_delta_sums_given': [_P] * 8 + [_I] * 7 + [_F, _P],
    'vilma_compact_prologue_epochs_partial': [_P] * 9 + [_I] * 7 + [_F, _P],
    'vilma_compact_delta_norm_epochs': [_P] * 9 + [_I] * 7 + [_F, _P],
    'vilma_compact_delta_sums_epochs_given': [_P] * 11 + [_I] * 8
    + [_F, _P],
    'vilma_compact_merge': [_P] * 6 + [_I] * 5 + [_P],
    'vilma_compact_norm_merge': [_P] * 2 + [_I] * 3 + [_P],
})
# the kdim forms take the same arguments as the shared-state entry points
for _kdim, _shared in (
        ('prologue_kdim', 'prologue'), ('delta_sums_kdim', 'delta_sums'),
        ('prologue_kdim_partial', 'prologue_partial'),
        ('delta_norm_kdim', 'delta_norm'),
        ('delta_sums_kdim_given', 'delta_sums_given')):
    SIGNATURES['vilma_compact_' + _kdim] = SIGNATURES[
        'vilma_compact_' + _shared]

_lib = None
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


def _sources():
    return sorted(CSRC.glob('*.cu'))


def library_path():
    digest = hashlib.sha256()
    for src in sorted(CSRC.glob('*.cu*')):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'libvilma_kernels_{digest.hexdigest()[:16]}.so'


def build(verbose=False):
    """Compile every csrc/*.cu into one shared library (if not built
    yet) and return its path."""
    global build_seconds, ptxas_report
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f'{out.stem}.{os.getpid()}'
    flags = NVCC_FLAGS + ['-Xptxas', '-v']
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in _sources():
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
        link = subprocess.run([nvcc] + NVCC_FLAGS + ['-shared', '-o', str(tmp)]
                              + [str(o) for o in objs],
                              capture_output=True, text=True)
        if link.returncode:
            errors.append('link:\n' + link.stderr)
    for obj in objs:
        obj.unlink(missing_ok=True)
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


def library():
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


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
