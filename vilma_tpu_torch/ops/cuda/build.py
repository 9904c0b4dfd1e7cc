"""Build and load the port's CUDA kernels (vilma_tpu_torch/csrc/*.cu).

The sources have a plain C interface (no PyTorch headers), so nvcc
builds them in seconds into one shared library for sm_90a (Hopper),
loaded with ctypes. The build runs at first use, from the checkout's
sources alone, into vilma_tpu_torch/build/ (ignored by git); the library
name carries a hash of the sources, so an edited source is rebuilt.

Nothing here runs on import: the CPU tests import every module, and
there is no nvcc where they run.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG / 'build'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC']

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: every pointer and the stream are void*, counts int
SIGNATURES = {
    'vilma_block_matvec': [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    'vilma_compact_prologue': [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _F, _F, _P],
    'vilma_compact_delta_sums': [_P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _F, _F, _P],
}

_lib = None
#: wall seconds the last build took (None until a build ran here)
build_seconds = None


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
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'libvilma_kernels_{digest.hexdigest()[:16]}.so'


def build(verbose=False):
    """Compile every csrc/*.cu into one shared library (if not built
    yet) and return its path."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    cmd = [_nvcc()] + NVCC_FLAGS + (['-Xptxas', '-v'] if verbose else [])
    cmd += ['-o', str(tmp)] + [str(s) for s in _sources()]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError('nvcc failed:\n' + proc.stderr[-8000:])
    if verbose:
        print(proc.stderr)
    os.replace(tmp, out)
    return out


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
