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


# ---------------------------------------------------------------------------
# the reference class's API (PackedLD methods, vilma_tpu/ops/blocks.py:
# 126-160) against vilma_tpu's, on tests/test_blocks.py's inputs
# ---------------------------------------------------------------------------

def _api_pair(seed, sizes):
    from tests.test_blocks import _make_packed
    jld, dense, _ = _make_packed(np.random.default_rng(seed), sizes)
    return jld, ld_to_torch(jld), dense


def test_api_inverse_round_trip_matches_jax():
    """`.inverse.dot` is the pseudo-inverse (rank-deficient blocks
    included), `.inverse.inverse.dot` is `.dot`, `.diag()` the diagonal,
    as vilma_tpu's (tests/test_blocks.py:130-137, 268-271)."""
    jld, tld, dense = _api_pair(8, [5, 4])
    v = np.random.default_rng(1).standard_normal(dense.shape[0])
    assert not tld.inverted and tld.inverse.inverted
    got = t2n(tld.inverse.dot(torch.as_tensor(v)))
    np.testing.assert_allclose(
        got, np.asarray(jld.inverse.dot(jnp.asarray(v))), rtol=RTOL,
        atol=1e-12 * np.abs(got).max())
    np.testing.assert_allclose(got, np.linalg.pinv(dense, hermitian=True) @ v,
                               atol=1e-8)
    np.testing.assert_allclose(t2n(tld.inverse.inverse.dot(
        torch.as_tensor(v))), t2n(tld.dot(torch.as_tensor(v))), rtol=0,
        atol=0)
    np.testing.assert_allclose(t2n(tld.dot(torch.as_tensor(v))), dense @ v,
                               atol=1e-12)
    np.testing.assert_allclose(t2n(tld.diag()), np.diag(dense), atol=1e-12)
    assert tld.get_rank() == float(jld.get_rank())


def test_api_inverse_of_a_singular_block_matches_jax():
    """The pseudo-inverse of one singular block (rank 2 of 5), as
    vilma_tpu's (tests/test_blocks.py:140-146)."""
    from tests.test_blocks import random_symmetric
    rng = np.random.default_rng(9)
    x = random_symmetric(5, rng, rank=2)
    jld = jblocks.from_dense_blocks([x], [np.arange(5)], 5)
    tld = tblocks.from_dense_blocks([x], [np.arange(5)], 5)
    v = rng.standard_normal(5)
    got = t2n(tld.inverse.dot(torch.as_tensor(v)))
    np.testing.assert_allclose(got, np.asarray(jld.inverse.dot(
        jnp.asarray(v))), rtol=RTOL, atol=1e-12 * np.abs(got).max())
    np.testing.assert_allclose(got, np.linalg.pinv(x, hermitian=True) @ v,
                               atol=1e-8)


@pytest.mark.parametrize('method', ['dot_i', 'ridge_inverse_dot', 'diag'])
def test_api_inverted_contracts_match_jax(method):
    """dot_i, ridge_inverse_dot and diag of an inverted matrix raise
    vilma_tpu's NotImplementedError, message for message
    (tests/test_blocks.py:259-267); on the matrix itself they answer."""
    jld, tld, dense = _api_pair(15, [4])
    n = dense.shape[0]
    args = {'dot_i': (np.ones(n), 0), 'ridge_inverse_dot': (np.ones(n), 1.0),
            'diag': ()}[method]
    with pytest.raises(NotImplementedError) as jerr:
        getattr(jld.inverse, method)(*args)
    with pytest.raises(NotImplementedError) as terr:
        getattr(tld.inverse, method)(
            *[torch.as_tensor(a) if isinstance(a, np.ndarray) else a
              for a in args])
    assert str(terr.value) == str(jerr.value)
    got = getattr(tld, method)(*[torch.as_tensor(a) if isinstance(
        a, np.ndarray) else a for a in args])
    want = getattr(jld, method)(*[jnp.asarray(a) if isinstance(
        a, np.ndarray) else a for a in args])
    np.testing.assert_allclose(t2n(got) if torch.is_tensor(got) else got,
                               np.asarray(want), rtol=RTOL)


def test_api_matrix_power_matches_jax():
    """`.matrix_power` as vilma_tpu's, applied through `.dot`."""
    jld, tld, dense = _api_pair(4, [5, 3])
    v = np.random.default_rng(2).standard_normal(dense.shape[0])
    np.testing.assert_allclose(
        t2n(tld.matrix_power(0.5).dot(torch.as_tensor(v))),
        np.asarray(jld.matrix_power(0.5).dot(jnp.asarray(v))), rtol=RTOL,
        atol=1e-13)
