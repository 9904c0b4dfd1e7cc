"""vilma_tpu_torch.ops.blocks against vilma_tpu.ops.blocks at float64 on
the CPU (rtol 1e-10), on a layout with missing genome indices and
blocks whose rows are scattered over the genome."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vilma_tpu.ops import blocks as jblocks
from vilma_tpu.ops import lowrank as jlowrank
from vilma_tpu_torch.ops import blocks as tblocks
from vilma_tpu_torch.ops import lowrank as tlowrank

from tests.torch_parity import ld_to_torch, t2n

RTOL = 1e-10
N = 200


def _layout(with_diag, seed=0):
    """Factors and genome indices of four blocks (sizes 37, 50, 64, 30)
    over a random permutation of N indices; 19 indices stay missing.
    with_diag gives two blocks a nonzero diagonal part (one of them
    mixed zero/nonzero), which routes inverse_dot to the host branch."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(N)
    factors, indices, start = [], [], 0
    for b, size in enumerate((37, 50, 64, 30)):
        a = rng.standard_normal((size, size))
        x = a @ a.T / size + 0.05 * np.eye(size)
        d = None
        if with_diag and b == 1:
            d = rng.uniform(0.1, 0.5, size)
        if with_diag and b == 2:
            d = np.where(np.arange(size) % 2 == 0, 0.3, 0.0)
        if d is None:
            f = jlowrank.factor_block(X=x, t=0.999, check_symmetric=False)
        else:
            w, v = np.linalg.eigh(x)
            keep = w > w.max() * 0.05
            f = jlowrank.factor_block(u=v[:, keep], s=w[keep], d=d,
                                      check_symmetric=False)
        factors.append(f)
        indices.append(order[start:start + size])
        start += size
    return factors, indices


@pytest.fixture(params=[False, True], ids=['lowrank', 'with_diag'])
def lds(request):
    factors, indices = _layout(request.param)
    jld = jblocks.pack(factors, indices, N)
    return jld, ld_to_torch(jld), request.param


def test_pack_matches_jax():
    """The port's own pack (from its copy of lowrank) builds the JAX
    package's bucket leaves."""
    factors, indices = _layout(True)
    jld = jblocks.pack(factors, indices, N)
    tfactors = [tlowrank.LowRankFactor(u=f.u, s=f.s, d=f.d, rank=f.rank)
                for f in factors]
    tld = tblocks.pack(tfactors, indices, N)
    assert tld.n == jld.n and tld.has_diag == jld.has_diag
    assert tld.rank == float(jld.rank)
    assert tld.missing == tuple(jld.missing)
    assert len(tld.buckets) == len(jld.buckets)
    for tb, jb in zip(tld.buckets, jld.buckets):
        for leaf in ('u', 's', 'inv_s', 'd', 'perm'):
            np.testing.assert_array_equal(t2n(getattr(tb, leaf)),
                                          np.asarray(getattr(jb, leaf)))


def test_dot_and_dot_multi_match_jax(lds):
    jld, tld, _ = lds
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, N))
    want = np.asarray(jblocks.dot_multi(jld, jnp.asarray(x)))
    got = t2n(tblocks.dot_multi(tld, torch.as_tensor(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-13)
    np.testing.assert_allclose(
        t2n(tblocks.dot(tld, torch.as_tensor(x[0]))),
        np.asarray(jblocks.dot(jld, jnp.asarray(x[0]))),
        rtol=RTOL, atol=1e-13)
    # missing indices are implicit zero rows
    assert np.all(got[:, list(tld.missing)] == 0)


def test_diag_matches_jax(lds):
    jld, tld, _ = lds
    np.testing.assert_allclose(t2n(tblocks.diag(tld)),
                               np.asarray(jblocks.diag(jld)), rtol=RTOL)


def test_inverse_dot_matches_jax(lds):
    jld, tld, with_diag = lds
    assert tld.has_diag == with_diag
    x = np.random.default_rng(2).standard_normal(N)
    want = np.asarray(jblocks.inverse_dot(jld, jnp.asarray(x)))
    got = t2n(tblocks.inverse_dot(tld, torch.as_tensor(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=1e-10 * np.abs(want).max())


def test_ridge_inverse_dot_matches_jax(lds):
    jld, tld, _ = lds
    rng = np.random.default_rng(3)
    x = rng.standard_normal(N)
    reg = rng.uniform(0.05, 0.5, N)
    want = np.asarray(jblocks.ridge_inverse_dot(jld, jnp.asarray(x),
                                                jnp.asarray(reg)))
    got = t2n(tblocks.ridge_inverse_dot(tld, torch.as_tensor(x),
                                        torch.as_tensor(reg)))
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=1e-10 * np.abs(want).max())


def test_ridge_inverse_dot_is_an_inverse():
    """(M + diag(reg)) @ ridge_inverse_dot(M, x, reg) == x on the covered
    indices, with the Woodbury chunking forced to several chunks."""
    factors, indices = _layout(False, seed=4)
    tld = ld_to_torch(jblocks.pack(factors, indices, N))
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal(N))
    reg = torch.as_tensor(rng.uniform(0.05, 0.5, N))
    old = tblocks._WOODBURY_CHUNK_ELEMS
    try:
        tblocks._WOODBURY_CHUNK_ELEMS = 64 * 64
        y = tblocks.ridge_inverse_dot(tld, x, reg)
    finally:
        tblocks._WOODBURY_CHUNK_ELEMS = old
    back = tblocks.dot(tld, y) + reg * y
    covered = np.setdiff1d(np.arange(N), tld.missing)
    np.testing.assert_allclose(t2n(back)[covered], t2n(x)[covered],
                               rtol=1e-9, atol=1e-9)
