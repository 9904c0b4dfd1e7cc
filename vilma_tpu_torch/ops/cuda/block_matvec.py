"""Fused low-rank block matvec: wrapper of the CUDA kernel
csrc/block_matvec.cu, with its plain PyTorch version.

Replaces vilma_tpu/ops/pallas/block_matvec.py::bucket_matvec_multi
(the Pallas TPU kernel `_kernel`):

    y[b, c] = U_b (s_b * (U_b^T x[b, c])) + d_b * x[b, c]

for B padded [Pmax, Rmax] LD blocks and C cohorts sharing the panel.
x and t are rounded to U's dtype before each contraction and the sums
accumulate in f32 (the semantics of block_matvec.py:52-61 and
blocks.py:480-490).

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs `bucket_matvec_multi_plain`. There is no fallback.
"""
import torch

from vilma_tpu_torch.ops.cuda import build

#: launches of the CUDA kernel (plain-version calls do not count)
launches = 0


def bucket_matvec_multi_plain(u, s, d, x):
    """Plain PyTorch version: u [B, P, R]; s [B, R]; d [B, P];
    x [B, C, P] -> [B, C, P].

    With bf16 u the contractions run on bf16-ROUNDED operands upcast to
    f32: a CPU bf16 matmul would return bf16 and round every sum."""
    if u.dtype == torch.bfloat16:
        uf = u.float()
        xr = x.to(torch.bfloat16).float()
        t = torch.einsum('bpr,bcp->bcr', uf, xr) * s[:, None, :]
        tr = t.to(torch.bfloat16).float()
        y = torch.einsum('bpr,bcr->bcp', uf, tr)
        return y.to(x.dtype) + d[:, None, :] * x
    u = u.to(x.dtype)       # JAX promotes an f32 u against f64 vectors
    t = torch.einsum('bpr,bcp->bcr', u, x) * s[:, None, :]
    return torch.einsum('bpr,bcr->bcp', u, t) + d[:, None, :] * x


def _require(cond, msg):
    if not cond:
        raise ValueError('bucket_matvec_multi: ' + msg)


def bucket_matvec_multi(u, s, d, x):
    """y[b, c] = u[b] @ (s[b] * (u[b].T @ x[b, c])) + d[b] * x[b, c]."""
    if not x.is_cuda:
        return bucket_matvec_multi_plain(u, s, d, x)
    global launches
    B, P, R = u.shape
    C = x.shape[1] if x.dim() == 3 else -1
    _require(u.dtype in (torch.float32, torch.bfloat16),
             f'u must be float32 or bfloat16 on CUDA, got {u.dtype}')
    for name, t, shape in (('s', s, (B, R)), ('d', d, (B, P)),
                           ('x', x, (B, C, P))):
        _require(t.dtype == torch.float32,
                 f'{name} must be float32, got {t.dtype}')
        _require(tuple(t.shape) == shape,
                 f'{name} has shape {tuple(t.shape)}, expected {shape}')
    for name, t in (('u', u), ('s', s), ('d', d), ('x', x)):
        _require(t.is_cuda and t.device == x.device,
                 f'{name} must be on {x.device}')
        _require(t.is_contiguous(), f'{name} must be contiguous')
    _require(1 <= C <= 3, f'C = {C} cohorts per panel (kernel takes 1..3)')
    vec = 16 // u.element_size()
    _require(R % vec == 0 and u.data_ptr() % 16 == 0,
             f'rank axis {R} must be a multiple of {vec} and u 16-byte '
             'aligned (16-byte row loads)')
    _require(C * R * 4 <= 227 * 1024,
             f'C * R = {C * R} floats exceed the shared-memory budget')
    y = torch.empty_like(x)
    if B == 0:
        return y
    lib = build.library()
    status = lib.vilma_block_matvec(
        u.data_ptr(), s.data_ptr(), d.data_ptr(), x.data_ptr(),
        y.data_ptr(), B, P, R, C, int(u.dtype == torch.bfloat16),
        build.stream_handle(x.device))
    build.check(status, 'vilma_block_matvec')
    launches += 1
    return y
