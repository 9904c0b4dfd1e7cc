"""Streaming .npz writer: np.savez semantics with bounded host memory.

A copy of vilma_tpu/utils/npz_stream.py (numpy only; `vilma_tpu.utils`
is importable without jax, but the port imports nothing of the JAX
package).

The reference saves the final model with a full in-memory
`np.savez(output, ..., vi_sigma=...)` where vi_sigma is the materialized
[K, P, P, I] variational-covariance array (reference vi_options.py:
263-265). At genome scale with a production mixture grid that single
array is enormous (582 components x 2 cohorts x 1M SNPs in f64 is
~19 GB; 6M SNPs is ~112 GB) — a converged fit would die writing its
outputs. Here the large member streams to the zip in chunks produced on
demand, so peak host memory stays at one chunk; everything np.load-visible
is identical to np.savez output (same member names, npy format,
ZIP_STORED entries).
"""
import zipfile

import numpy as np


def npz_member_memmap(path_or_npz, name):
    """A read-only np.memmap view of one member of an UNCOMPRESSED .npz.

    np.load materializes each accessed member in host RAM — a 582-
    component 6M-SNP checkpoint's vi_mu member alone is ~28 GB. Both
    np.savez and `save_npz_stream` write ZIP_STORED (uncompressed)
    members, whose payload bytes are contiguous in the file, so the
    array can be mapped instead: resolve the member's data offset via
    its local header, parse the .npy header, and mmap the rest.

    Accepts a path or an open np.lib.npyio.NpzFile (its backing file
    name is reused). Returns None when mapping is impossible (member
    compressed, Fortran order, or no backing file) — callers fall back
    to materialized reads.
    """
    if hasattr(path_or_npz, 'fid') and hasattr(path_or_npz.fid, 'name'):
        path = path_or_npz.fid.name
    elif isinstance(path_or_npz, (str, bytes)):
        path = path_or_npz
    else:
        return None
    member = name if name.endswith('.npy') else name + '.npy'
    try:
        with zipfile.ZipFile(path) as zf:
            info = zf.getinfo(member)
            if info.compress_type != zipfile.ZIP_STORED:
                return None
            with open(path, 'rb') as fh:
                fh.seek(info.header_offset)
                local = fh.read(30)
                if local[:4] != b'PK\x03\x04':
                    return None
                name_len = int.from_bytes(local[26:28], 'little')
                extra_len = int.from_bytes(local[28:30], 'little')
                data_off = (info.header_offset + 30 + name_len
                            + extra_len)
                fh.seek(data_off)
                version = np.lib.format.read_magic(fh)
                if version == (1, 0):
                    shape, fortran, dtype = \
                        np.lib.format.read_array_header_1_0(fh)
                elif version == (2, 0):
                    shape, fortran, dtype = \
                        np.lib.format.read_array_header_2_0(fh)
                else:
                    return None
                if fortran:
                    return None
                return np.memmap(path, mode='r', dtype=dtype,
                                 shape=shape, offset=fh.tell())
    except (KeyError, OSError, ValueError):
        return None


def save_npz_stream(path, arrays, streamed=()):
    """Write an .npz readable by np.load.

    Args:
        path: output path ('.npz' appended if absent, like np.savez).
        arrays: dict name -> ndarray, written whole (np.savez behavior).
        streamed: iterable of (name, shape, dtype, chunk_iter) where
            chunk_iter yields C-contiguous ndarray chunks along axis 0
            that concatenate to the full [shape] array. Each chunk is
            written straight into the zip member and freed.
    """
    if not str(path).endswith('.npz'):
        path = str(path) + '.npz'
    with zipfile.ZipFile(path, 'w', zipfile.ZIP_STORED) as zf:
        for name, arr in arrays.items():
            arr = np.asarray(arr)
            with zf.open(name + '.npy', 'w', force_zip64=True) as member:
                np.lib.format.write_array(member, arr)
        for name, shape, dtype, chunk_iter in streamed:
            shape = tuple(int(s) for s in shape)
            dtype = np.dtype(dtype)
            with zf.open(name + '.npy', 'w', force_zip64=True) as member:
                np.lib.format.write_array_header_1_0(
                    member, {'descr': np.lib.format.dtype_to_descr(dtype),
                             'fortran_order': False, 'shape': shape})
                written = 0
                for chunk in chunk_iter:
                    chunk = np.ascontiguousarray(chunk, dtype=dtype)
                    if chunk.shape[1:] != shape[1:]:
                        raise ValueError(
                            f'chunk trailing shape {chunk.shape[1:]} != '
                            f'member trailing shape {shape[1:]}')
                    member.write(chunk.tobytes())
                    written += chunk.shape[0]
                if written != shape[0]:
                    raise ValueError(
                        f'streamed member {name!r}: chunks cover '
                        f'{written} of {shape[0]} leading rows')
