"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at small shapes (chip_smoke.py checks them at the main path's
shapes). Skipped where torch has no CUDA device. Imports nothing of
JAX, so it runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""
import math

import numpy as np
import pytest
import torch

from vilma_tpu_torch.ops.cuda import block_matvec as bm
from vilma_tpu_torch.ops.cuda import compact_obj as co

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
    return torch.device('cuda')


def _scaled_err(got, want):
    want = want.double()
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize('u_dtype,band', [(torch.float32, 1e-5),
                                          (torch.bfloat16, 2.0 ** -8)])
@pytest.mark.parametrize('C', [1, 2, 3])
def test_matvec_kernel_matches_plain(cuda, u_dtype, band, C):
    """f32: accumulation order only; bf16: one bf16 ulp, where an f32
    sum on a rounding boundary rounds t the other way."""
    gen = torch.Generator(device=cuda).manual_seed(C)
    B, P, R = 5, 256, 136
    u = (torch.randn(B, P, R, generator=gen, device=cuda)
         / math.sqrt(P)).to(u_dtype)
    s = torch.rand(B, R, generator=gen, device=cuda) + 0.1
    d = torch.rand(B, P, generator=gen, device=cuda)
    x = torch.randn(B, C, P, generator=gen, device=cuda)
    before = bm.launches
    y = bm.bucket_matvec_multi(u, s, d, x)
    y2 = bm.bucket_matvec_multi(u, s, d, x)
    torch.cuda.synchronize()
    assert bm.launches == before + 2
    assert torch.equal(y, y2)
    ref = bm.bucket_matvec_multi_plain(u, s, d, x)
    err = _scaled_err(y, ref)
    assert err <= band
    if u_dtype == torch.bfloat16:
        # the band alone would pass a kernel that skips rounding x or t:
        # it must sit closer to the plain version than either such product
        for round_x in (True, False):
            assert err < _scaled_err(
                _half_rounded_matvec(u, s, d, x, round_x), ref)


def _half_rounded_matvec(u, s, d, x, round_x):
    """The bf16-U product with only x (round_x) or only t rounded."""
    uf = u.float()
    xr = x.to(torch.bfloat16).float() if round_x else x
    t = torch.einsum('bpr,bcp->bcr', uf, xr) * s[:, None, :]
    if not round_x:
        t = t.to(torch.bfloat16).float()
    return torch.einsum('bpr,bcr->bcp', uf, t) + d[:, None, :] * x


def _compact_args(device, P, K, I, A, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((K, P, P))
    covs = (a @ np.swapaxes(a, 1, 2) + P * np.eye(P)) * np.exp(
        np.linspace(np.log(1e-6), np.log(1e-2), K))[:, None, None]
    prec = np.linalg.inv(covs)
    log_det = np.linalg.slogdet(covs)[1]
    hd = rng.dirichlet(np.ones(K), A)
    ann = rng.integers(0, A + 1, I).astype(np.int32)   # some pads (== A)

    def f32(v):
        return torch.as_tensor(np.ascontiguousarray(v), dtype=torch.float32,
                               device=device)

    return (co.build_coeffs(f32(prec), f32(log_det)).contiguous(),
            f32((np.log(hd) - 0.5 * log_det).T),
            torch.as_tensor(ann, device=device),
            f32(1.0 / rng.uniform(0.01, 0.05, (P, I)) ** 2),
            f32(rng.standard_normal((P, I)) * 0.5))


@pytest.mark.parametrize('P', [1, 2, 3])
@pytest.mark.parametrize('K', [7, 600])
def test_compact_kernels_match_plain(cuda, P, K):
    """600 components take the kernels' multi-tile path for the sums."""
    A = 3
    args = _compact_args(cuda, P, K, 20_000, A, seed=P * 1000 + K)
    before = dict(co.launches)
    pm, pv, kl = co.prologue(*args, num_annotations=A)
    sums = co.delta_sums(*args, num_annotations=A)
    again = co.delta_sums(*args, num_annotations=A)
    rpm, rpv, rkl = co.prologue_plain(*args, num_annotations=A)
    rsums = co.delta_sums_plain(*args, num_annotations=A)
    torch.cuda.synchronize()
    assert co.launches['prologue'] == before['prologue'] + 1
    assert co.launches['delta_sums'] == before['delta_sums'] + 2
    assert torch.equal(sums, again)
    assert _scaled_err(pm, rpm) <= 1e-5
    assert _scaled_err(pv, rpv) <= 1e-5
    assert abs(float(kl) - float(rkl)) <= 1e-4 * abs(float(rkl))
    assert _scaled_err(sums, rsums) <= 1e-5


def _epoch_args(device, P, K, I, A, B, live, seed):
    """Epoch-kernel operands: `live` filled history slots of B, the rest
    inert (zero vectors, coefficient 0, scale 1)."""
    coeffs, scores_t, ann, dterm, nat = _compact_args(device, P, K, I, A,
                                                      seed)
    rng = np.random.default_rng(seed + 1)
    hist = np.zeros((B, P, I))
    hist[:live] = rng.standard_normal((live, P, I)) * 0.5
    inv_scales = np.ones((B + 1, P))
    inv_scales[:live + 1] = rng.uniform(0.7, 1.4, (live + 1, P))
    hist_c = np.zeros(B)
    hist_c[:live] = rng.uniform(0.1, 1.0, live)

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=device)

    return (coeffs, scores_t, ann, dterm, nat, f32(hist), f32(inv_scales),
            f32(hist_c))


@pytest.mark.parametrize('P', [1, 2, 3])
@pytest.mark.parametrize('K', [7, 600])
def test_kdim_kernels_match_plain(cuda, P, K):
    """The per-component [K, P, I] natural mean of --learn-scaling fits."""
    A = 3
    args = list(_compact_args(cuda, P, K, 20_000, A, seed=P * 100 + K))
    gen = torch.Generator(device=cuda).manual_seed(P + K)
    args[4] = torch.randn(K, P, 20_000, generator=gen, device=cuda) * 0.5
    before = dict(co.launches)
    pm, pv, kl = co.prologue(*args, num_annotations=A)
    pm2, _, kl2 = co.prologue(*args, num_annotations=A)
    sums = co.delta_sums(*args, num_annotations=A)
    again = co.delta_sums(*args, num_annotations=A)
    rpm, rpv, rkl = co.prologue_plain(*args, num_annotations=A)
    rsums = co.delta_sums_plain(*args, num_annotations=A)
    torch.cuda.synchronize()
    assert co.launches['prologue_kdim'] == before['prologue_kdim'] + 2
    assert co.launches['delta_sums_kdim'] == before['delta_sums_kdim'] + 2
    assert co.launches['prologue'] == before['prologue']
    assert torch.equal(pm, pm2) and torch.equal(kl, kl2)
    assert torch.equal(sums, again)
    assert _scaled_err(pm, rpm) <= 1e-5
    assert _scaled_err(pv, rpv) <= 1e-5
    assert abs(float(kl) - float(rkl)) <= 1e-4 * abs(float(rkl))
    assert _scaled_err(sums, rsums) <= 1e-5


@pytest.mark.parametrize('P', [1, 2, 3])
@pytest.mark.parametrize('K', [7, 600])
def test_epoch_kernels_match_plain(cuda, P, K):
    """The epoch-history state: 2 live epochs of 4 slots; the kernels
    loop over the live ones only."""
    A, B, live = 3, 4, 2
    args = _epoch_args(cuda, P, K, 20_000, A, B, live, seed=P * 10 + K)
    kw = dict(num_annotations=A, num_live=live)
    before = dict(co.launches)
    pm, pv, kl = co.prologue_epochs(*args, **kw)
    pm2, _, kl2 = co.prologue_epochs(*args, **kw)
    sums = co.delta_sums_epochs(*args, **kw)
    again = co.delta_sums_epochs(*args, **kw)
    rpm, rpv, rkl = co.prologue_epochs_plain(*args, num_annotations=A)
    rsums = co.delta_sums_epochs_plain(*args, num_annotations=A)
    torch.cuda.synchronize()
    assert co.launches['prologue_epochs'] == before['prologue_epochs'] + 2
    assert (co.launches['delta_sums_epochs']
            == before['delta_sums_epochs'] + 2)
    assert torch.equal(pm, pm2) and torch.equal(kl, kl2)
    assert torch.equal(sums, again)
    assert _scaled_err(pm, rpm) <= 1e-5
    assert _scaled_err(pv, rpv) <= 1e-5
    assert abs(float(kl) - float(rkl)) <= 1e-4 * abs(float(rkl))
    assert _scaled_err(sums, rsums) <= 1e-5
