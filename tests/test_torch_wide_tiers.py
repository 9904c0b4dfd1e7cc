"""Blocks wider than 1,024 SNPs pad to the next multiple of 256 in the
port's pack (the JAX package pads them to a power of two): the tiers, the
bytes of U they hold, the matvec's plan at the widest tier of the ~6M
well-imputed panel at an assumed uniform width (2,708-SNP blocks at
half rank), and the LD ops and two outer steps against vilma_tpu's
power-of-two pack of the same factors at float64 on the CPU."""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vilma_tpu.inference import engine as jengine
from vilma_tpu.ops import blocks as jblocks
from vilma_tpu.ops import lowrank as jlowrank
from vilma_tpu.utils import synthetic
from vilma_tpu_torch.inference import engine as tengine
from vilma_tpu_torch.ops import blocks as tblocks
from vilma_tpu_torch.ops import lowrank as tlowrank
from vilma_tpu_torch.ops.cuda import block_matvec

from tests.torch_parity import state_to_torch, t2n

RTOL = 1e-10
# a wide block of each new tier beside one that keeps its power of two:
# 6,000 SNPs over a permuted genome, 50 of them in no block
SIZES = (1100, 2708, 500, 1300, 342)
N = sum(SIZES) + 50


@pytest.mark.parametrize('n,tier', [
    (1, 8), (8, 8), (9, 16), (100, 128), (500, 512), (1000, 1024),
    (1024, 1024), (1025, 1280), (1100, 1280), (1280, 1280), (1300, 1536),
    (1780, 1792), (2048, 2048), (2708, 2816), (4097, 4352),
    (16384, 16384)])
def test_tiers(n, tier):
    """Up to 1,024 SNPs the JAX package's powers of two; past it the next
    multiple of 256, up to 16,384; a wider block raises."""
    assert tblocks._pad_to_tier(n) == tier
    if n <= 1024:
        assert tier == jblocks._pad_to_tier(n)


def test_a_block_past_the_widest_tier_raises():
    with pytest.raises(ValueError, match='maximum supported block size'):
        tblocks._pad_to_tier(16385)


@functools.lru_cache(maxsize=None)
def _panel():
    """The JAX package's factors of SIZES' blocks at half rank (random
    orthonormal u, eigenvalues spread over two decades) and their genome
    indices over a permutation of N."""
    rng = np.random.default_rng(22)
    order = rng.permutation(N)
    factors, indices, start = [], [], 0
    for size in SIZES:
        r = size // 2
        u = np.linalg.qr(rng.standard_normal((size, r)))[0]
        s = np.sort(np.exp(rng.uniform(np.log(0.05), np.log(5.0), r)))[::-1]
        factors.append(jlowrank.factor_block(u=u, s=s.copy(),
                                             check_symmetric=False))
        indices.append(order[start:start + size])
        start += size
    return factors, indices


def _port_factors(factors):
    return [tlowrank.LowRankFactor(u=f.u, s=f.s, d=f.d, rank=f.rank)
            for f in factors]


@functools.lru_cache(maxsize=None)
def _packs():
    factors, indices = _panel()
    return (jblocks.pack(factors, indices, N),
            tblocks.pack(_port_factors(factors), indices, N))


def test_wide_blocks_pack_to_their_tiers():
    """The port's buckets (a bucket a padded size and rank): 342 and 500
    keep 512 rows, 1,100 -> 1,280, 1,300 -> 1,536, 2,708 -> 2,816; the
    JAX package's put 1,100 and 1,300 in 2,048 rows and 2,708 in 4,096."""
    jld, tld = _packs()
    assert [tuple(bk.u.shape) for bk in tld.buckets] == [
        (1, 512, 176), (1, 512, 256), (1, 1280, 552), (1, 1536, 656),
        (1, 2816, 1360)]
    assert [tuple(np.shape(bk.u)) for bk in jld.buckets] == [
        (1, 512, 176), (1, 512, 256), (1, 2048, 552), (1, 2048, 656),
        (1, 4096, 1360)]
    assert tld.missing == tuple(jld.missing) and len(tld.missing) == 50


def _ops(mod, ld, x, reg):
    return dict(
        dot=mod.dot(ld, x[0]), dot_multi=mod.dot_multi(ld, x),
        diag=mod.diag(ld), inverse_dot=mod.inverse_dot(ld, x[1]),
        ridge_inverse_dot=mod.ridge_inverse_dot(ld, x[2], reg))


@functools.lru_cache(maxsize=None)
def _both_ops():
    jld, tld = _packs()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, N))
    reg = rng.uniform(0.1, 1.0, N)
    want = _ops(jblocks, jld, jnp.asarray(x), jnp.asarray(reg))
    got = _ops(tblocks, tld, torch.as_tensor(x), torch.as_tensor(reg))
    return got, want


@pytest.mark.parametrize('op', ['dot', 'dot_multi', 'diag', 'inverse_dot',
                                'ridge_inverse_dot'])
def test_ops_match_the_power_of_two_pack(op):
    """Each LD op of the port's pack equals vilma_tpu's on its
    power-of-two buckets at float64: the pad moves the layout, not the
    matrix."""
    got, want = _both_ops()
    w = np.asarray(want[op])
    np.testing.assert_allclose(t2n(got[op]), w, rtol=RTOL,
                               atol=1e-13 * np.abs(w).max())


def test_two_outer_steps_match_jax():
    """Two outer steps of a 2-cohort fit on the 6,000-SNP panel, the
    port's pack against vilma_tpu's at float64: posterior means,
    ELBO and hyper-delta to the suite's f64 tolerance."""
    jld, tld = _packs()
    rng = np.random.default_rng(7)
    P = 2
    std_errs = rng.uniform(0.01, 0.05, (P, N))
    betas = rng.standard_normal((P, N)) * std_errs * 2
    annotations = np.zeros((N, 2))
    annotations[np.arange(N), rng.integers(0, 2, N)] = 1
    covs = [np.eye(P) * s + 0.3 * s for s in (1e-6, 1e-4, 1e-2)]
    raw = dict(marginal_effects=betas, std_errs=std_errs,
               annotations=annotations, mixture_covs=covs, scaled=False,
               scale_se=False, gwas_N=np.full(P, 1e5),
               init_hg=np.full(P, 0.3))
    jdata = jengine.build_model_data(ld_mats=[jld] * P, **raw)
    tdata = tengine.build_model_data(ld_mats=[tld] * P, device='cpu', **raw)
    st = synthetic.synthetic_state(jdata, seed=2, compact=True)
    tst = state_to_torch(st)
    for _ in range(2):
        st, pm_j = jengine.outer_step(jdata, st, line_search_rate=2.0)
        tst, pm_t = tengine.outer_step(tdata, tst)
    pm_j = np.asarray(pm_j)
    np.testing.assert_allclose(t2n(pm_t), pm_j, rtol=RTOL,
                               atol=1e-12 * np.abs(pm_j).max())
    assert abs(tst.elbo - float(st.elbo)) <= RTOL * abs(float(st.elbo))
    np.testing.assert_allclose(t2n(tst.hyper_delta),
                               np.asarray(st.hyper_delta), rtol=RTOL,
                               atol=1e-13)
    np.testing.assert_allclose(t2n(tst.nat_mu), np.asarray(st.nat_mu),
                               rtol=RTOL, atol=1e-12 * np.abs(
                                   np.asarray(st.nat_mu)).max())


def test_matrix_power_matches_jax():
    """matrix_power's seq map on the wide tiers: `.matrix_power(0.5)`
    applied through `.dot` as vilma_tpu's."""
    jld, tld = _packs()
    v = np.random.default_rng(3).standard_normal(N)
    want = np.asarray(jld.matrix_power(0.5).dot(jnp.asarray(v)))
    np.testing.assert_allclose(
        t2n(tld.matrix_power(0.5).dot(torch.as_tensor(v))), want,
        rtol=RTOL, atol=1e-13 * np.abs(want).max())


def test_spilled_pack_equals_the_unspilled_one():
    """The --mmap spill stages the wide tiers' buckets on disk: the same
    tensors as the unspilled pack."""
    factors, indices = _panel()
    spill = tblocks.FactorSpill()
    spilled = tblocks.pack([spill.store(f) for f in _port_factors(factors)],
                           indices, N, spill=spill)
    _, tld = _packs()
    assert len(spilled.buckets) == len(tld.buckets)
    for a, b in zip(spilled.buckets, tld.buckets):
        for leaf in ('u', 's', 'inv_s', 'd', 'perm', 'seq'):
            assert torch.equal(getattr(a, leaf), getattr(b, leaf)), leaf


def test_deal_blocks_by_the_wide_tiers():
    """The global-gather layout deals each of pack's tiers in runs of
    ceil(B / N): 1,100, 1,200 and 1,250 share tier 1,280 (positions 0, 2,
    5: runs of 2), 1,300 has 1,536 alone, 2,708 and 2,700 share 2,816
    (runs of 1). vilma_tpu's powers of two would deal 2,048 (positions 0,
    2, 3, 5) and 4,096: [0, 0, 0, 1, 1, 1]."""
    owners = tblocks.deal_blocks([1100, 2708, 1200, 1300, 2700, 1250], 2)
    assert owners.tolist() == [0, 0, 0, 0, 1, 1]


@pytest.mark.parametrize('C', [1, 2])
def test_matvec_plans_of_the_published_width(C):
    """The ~6M panel's buckets at bf16: its 2,708-SNP blocks ([2,816,
    1,360]) on the group route, 16-CTA clusters of 176 rows, within the
    CTA's shared memory; its last block of 1,780 ([1,792, 896]) on the
    cluster route."""
    pl = block_matvec.plan(2816, 1360, 2, C)
    assert pl.route == 'group' and pl.cluster == 16
    assert pl.smem <= block_matvec._SMEM_MAX and pl.slots >= 2
    assert pl.smem == block_matvec.group_smem(2816, C, 2, 16, pl.panel,
                                              pl.slots)
    tail = block_matvec.plan(1792, 896, 2, C)
    assert tail.route == 'cluster' and tail.smem <= block_matvec._SMEM_MAX


@pytest.mark.parametrize('u_dtype,itemsize', [(torch.bfloat16, 2),
                                              (torch.float32, 4)])
def test_u_bytes_and_pad(u_dtype, itemsize):
    """blocks.u_footprint: the bytes of U a pack's buckets hold and their
    zero pad, worked by hand: blocks of 100 SNPs (rank 50: [128, 56]),
    1,100 (550: [1,280, 552]) and 2,708 (1,354: [2,816, 1,360]); a
    matrix listed twice (two cohorts on one panel) counts once, and its
    sharded form holds the same bytes."""
    rng = np.random.default_rng(1)
    factors, indices, start = [], [], 0
    for size in (100, 1100, 2708):
        r = size // 2
        factors.append(tlowrank.LowRankFactor(
            u=rng.standard_normal((size, r)), s=np.ones(r),
            d=np.zeros(size), rank=r))
        indices.append(np.arange(start, start + size))
        start += size
    # 3,908 SNPs in 4,096 slots, the span shard-local packing needs
    ld = tblocks.pack(factors, indices, 4096, dtype=torch.float32,
                      u_dtype=u_dtype)
    cells = 128 * 56 + 1280 * 552 + 2816 * 1360            # 4,543,488
    real = 100 * 50 + 1100 * 550 + 2708 * 1354              # 4,276,632
    assert cells - real == 266_856
    want = (cells * itemsize, (cells - real) * itemsize)
    assert tblocks.u_footprint([ld]) == tblocks.u_footprint([ld, ld]) \
        == want
    assert tblocks.u_footprint([tblocks.shard(ld, 1)]) == want
