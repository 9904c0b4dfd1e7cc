"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at small shapes (chip_smoke.py checks them at the main path's
shapes). Skipped where torch has no CUDA device. Imports nothing of
JAX, so it runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""
import functools
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
@pytest.mark.parametrize('C', [1, 2, 3, 4, 5, 6, 7, 8])
def test_matvec_kernel_matches_plain(cuda, u_dtype, band, C):
    """f32: accumulation order only; bf16: one bf16 ulp, where an f32
    sum on a rounding boundary rounds t the other way. Every cohort count
    a launch takes (5-7 run the 8-cohort kernel), counted by C."""
    gen = torch.Generator(device=cuda).manual_seed(C)
    B, P, R = 5, 256, 136
    u = (torch.randn(B, P, R, generator=gen, device=cuda)
         / math.sqrt(P)).to(u_dtype)
    s = torch.rand(B, R, generator=gen, device=cuda) + 0.1
    d = torch.rand(B, P, generator=gen, device=cuda)
    x = torch.randn(B, C, P, generator=gen, device=cuda)
    before = bm.launches + bm.launches_group
    by_c = bm.launches_by_cohorts.get(C, 0)
    y = bm.bucket_matvec_multi(u, s, d, x)
    y2 = bm.bucket_matvec_multi(u, s, d, x)
    torch.cuda.synchronize()
    assert bm.launches + bm.launches_group == before + 2
    assert bm.launches_by_cohorts[C] == by_c + 2
    assert y.shape == x.shape and torch.equal(y, y2)
    ref = bm.bucket_matvec_multi_plain(u, s, d, x)
    err = _scaled_err(y, ref)
    assert err <= band
    if u_dtype == torch.bfloat16:
        # the band alone would pass a kernel that skips rounding x or t:
        # it must sit closer to the plain version than either such product
        for round_x in (True, False):
            assert err < _scaled_err(
                _half_rounded_matvec(u, s, d, x, round_x), ref)


def _matvec_operands(device, B, P, R, C, u_dtype, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    u = (torch.randn(B, P, R, generator=gen, device=device)
         / math.sqrt(P)).to(u_dtype)
    s = torch.rand(B, R, generator=gen, device=device) + 0.1
    d = torch.rand(B, P, generator=gen, device=device)
    x = torch.randn(B, C, P, generator=gen, device=device)
    return u, s, d, x


def _check_route(u, s, d, x, route):
    """The planned route and CTAs per block, its launch counter, bit-for-
    bit repeatability and its band of the plain version (bf16 U: also
    closer to it than a product that skips rounding x or t)."""
    B, P, R = u.shape
    pl = bm.plan(P, R, u.element_size(), bm.width(x.shape[1]))
    assert (pl.route, pl.cluster) == route
    before = (bm.launches, bm.launches_group)
    y = bm.bucket_matvec_multi(u, s, d, x)
    y2 = bm.bucket_matvec_multi(u, s, d, x)
    torch.cuda.synchronize()
    group = route[0] == 'group'
    assert (bm.launches, bm.launches_group) == (
        before[0] + 2 * (not group), before[1] + 2 * group)
    assert torch.equal(y, y2)
    ref = bm.bucket_matvec_multi_plain(u, s, d, x)
    err = _scaled_err(y, ref)
    assert err <= (2.0 ** -8 if u.dtype == torch.bfloat16 else 1e-5)
    if u.dtype == torch.bfloat16:
        for round_x in (True, False):
            assert err < _scaled_err(
                _half_rounded_matvec(u, s, d, x, round_x), ref)


@pytest.mark.parametrize('P,R,u_dtype,route', [
    (128, 64, torch.bfloat16, ('cluster', 1)),
    (256, 136, torch.bfloat16, ('cluster', 1)),
    (512, 256, torch.bfloat16, ('cluster', 2)),
    (1024, 288, torch.bfloat16, ('cluster', 4)),
    (1024, 512, torch.bfloat16, ('cluster', 8)),
    (2048, 512, torch.bfloat16, ('cluster', 16)),
    (1024, 512, torch.float32, ('cluster', 16)),
    (2048, 1024, torch.float32, ('group', 8)),
])
@pytest.mark.parametrize('C', [1, 2, 3])
def test_matvec_routes_match_plain(cuda, P, R, u_dtype, route, C):
    """Each route and cluster size the planner takes (1, 2, 4, 8, 16 CTAs
    per block, a rank with a partial column block, and the group route of
    an oversize block) within its band of the plain version,
    bit-for-bit repeatable, counted on its own launch counter. 40 blocks
    on the cluster route: more than the card holds clusters at once, so
    the clusters walk several."""
    B = 40 if route[0] == 'cluster' else 4
    _check_route(*_matvec_operands(cuda, B, P, R, C, u_dtype, P + C), route)


@pytest.mark.parametrize('P,R,u_dtype,route', [
    (1280, 552, torch.bfloat16, ('cluster', 8)),      # 160 rows a CTA
    (1536, 656, torch.bfloat16, ('cluster', 16)),     # 96
    (1792, 896, torch.bfloat16, ('cluster', 16)),     # 112: the 6M tail
    (2816, 1360, torch.bfloat16, ('group', 16)),      # 2,708-SNP blocks
    (1536, 656, torch.float32, ('group', 8)),
    (2816, 1360, torch.float32, ('group', 16)),
])
@pytest.mark.parametrize('C', [1, 2])
def test_wide_tiers_match_plain(cuda, P, R, u_dtype, route, C):
    """blocks.pack's tiers past 1,024 SNPs (multiples of 256: rows a CTA
    that are no power of two) on the route the planner gives them."""
    B = 40 if route[0] == 'cluster' else 4
    _check_route(*_matvec_operands(cuda, B, P, R, C, u_dtype, P + C), route)


@pytest.mark.parametrize('P,R,u_dtype,C,route', [
    # the main bucket: the ring keeps 12 slots at 4 cohorts, 10 at 8
    (1024, 512, torch.bfloat16, 4, ('cluster', 8)),
    (1024, 512, torch.bfloat16, 8, ('cluster', 8)),
    (1024, 512, torch.bfloat16, 6, ('cluster', 8)),
    (1024, 512, torch.float32, 4, ('cluster', 16)),
    # 8 cohorts: f32 [1024, 512] no longer fits 16 CTAs (group route);
    # [1024, 288] takes a larger cluster
    (1024, 512, torch.float32, 8, ('group', 4)),
    (1024, 288, torch.float32, 8, ('cluster', 16)),
    (256, 136, torch.bfloat16, 8, ('cluster', 1)),
    (256, 128, torch.float32, 8, ('cluster', 1)),
    # two ring stages at 4 and 8 cohorts; bf16 panels of 64 at 8
    (2048, 1024, torch.float32, 4, ('group', 8)),
    (2048, 1024, torch.float32, 8, ('group', 8)),
    (2048, 1024, torch.bfloat16, 8, ('group', 8)),
    (8, 8, torch.bfloat16, 5, ('group', 1)),
])
def test_matvec_routes_match_plain_wide_cohorts(cuda, P, R, u_dtype, C,
                                                route):
    """4 to 8 cohorts per launch on both routes, at the plans the wider
    x, t and partial-y buffers give (blocks.dot_multi takes the traits
    of a --trait fit in groups of 8)."""
    B = 40 if route[0] == 'cluster' else 4
    _check_route(*_matvec_operands(cuda, B, P, R, C, u_dtype, P + C), route)


@pytest.mark.parametrize('P,R,u_dtype,G', [
    (2048, 1024, torch.float32, 8),        # 16 panels of 64
    (2048, 1024, torch.bfloat16, 8),       # 8 panels of 128
    (4096, 512, torch.float32, 16),        # 16-CTA clusters
    (8, 8, torch.bfloat16, 1),             # under 16 rows: one panel
    (8, 8, torch.float32, 1),
    (1024, 4096, torch.float32, 4),        # 64 panels
    (4096, 4096, torch.bfloat16, 16),      # 32 panels
    # the new boundaries: rows not a multiple of the cluster (the last
    # CTA's share short, its box reading the next block's rows), a last
    # panel cut by R (TMA's zero fill past R, s zero there), and two TMA
    # boxes a slice (more than 256 rows a CTA)
    (2000, 1000, torch.bfloat16, 8),
    (1000, 1000, torch.float32, 4),
    (8192, 512, torch.bfloat16, 16),
    (8192, 256, torch.float32, 16),
])
@pytest.mark.parametrize('B', [1, 4, 33])
@pytest.mark.parametrize('C', [1, 3])
def test_group_route_matches_plain(cuda, P, R, u_dtype, G, B, C):
    """The group route at every bucket size (a bucket of 1 or 4 blocks,
    33 blocks, whose items are no multiple of the clusters in flight)
    within its band of the plain version and bit-for-bit repeatable;
    bucket sizes that take turns on one stream share its workspace and
    leave its tickets zero."""
    _check_route(*_matvec_operands(cuda, B, P, R, C, u_dtype, B * P + C),
                 ('group', G))


@pytest.mark.parametrize('P,R,u_dtype,C,route', [
    (1024, 512, torch.bfloat16, 2, ('cluster', 8)),
    (1024, 512, torch.float32, 1, ('cluster', 16)),
    (1024, 512, torch.bfloat16, 5, ('cluster', 8)),
    (2048, 1024, torch.float32, 3, ('group', 8)),
    (2048, 1024, torch.bfloat16, 2, ('group', 8)),
])
def test_matvec_backward_is_the_kernel_on_the_gradient(cuda, P, R, u_dtype,
                                                       C, route):
    """Under autograd the gradient with respect to x is the forward's
    kernel on the incoming gradient (the same bits as a forward launch on
    it), counted in launches_backward alone, within the forward's band
    of the plain version on the gradient; a u that requires grad raises."""
    B = 40 if route[0] == 'cluster' else 4
    u, s, d, x = _matvec_operands(cuda, B, P, R, C, u_dtype, P * C)
    g = torch.randn_like(x)
    x.requires_grad_(True)
    before = (bm.launches, bm.launches_group, bm.launches_backward)
    y = bm.bucket_matvec_multi(u, s, d, x)
    y.backward(g)
    torch.cuda.synchronize()
    group = route[0] == 'group'
    assert (bm.launches, bm.launches_group, bm.launches_backward) == (
        before[0] + (not group), before[1] + group, before[2] + 1)
    with torch.no_grad():
        assert torch.equal(y, bm.bucket_matvec_multi(u, s, d, x))
        assert torch.equal(x.grad, bm.bucket_matvec_multi(u, s, d, g))
        err = _scaled_err(x.grad, bm.bucket_matvec_multi_plain(u, s, d, g))
    assert err <= (2.0 ** -8 if u_dtype == torch.bfloat16 else 1e-5)
    with pytest.raises(ValueError, match='must not require grad'):
        bm.bucket_matvec_multi(u.float().requires_grad_(True), s, d, x)


@pytest.mark.parametrize('u_dtype', [torch.bfloat16, torch.float32])
def test_spilled_load_on_the_card_equals_the_unspilled_one(
        cuda, u_dtype, tmp_path, monkeypatch):
    """A --mmap load fills the card's buckets in slices through the
    pinned staging buffer (several slices here) with the unspilled
    load's bits."""
    from vilma_tpu_torch.io import load
    from vilma_tpu_torch.ops import blocks
    rng = np.random.default_rng(0)
    lag = np.abs(np.subtract.outer(np.arange(64), np.arange(64)))
    names, rows = [], []
    for b in range(5):
        np.save(tmp_path / f'b{b}.npy', rng.uniform(0.3, 0.9) ** lag)
        with open(tmp_path / f'b{b}.var', 'w') as fh:
            for i in range(64):
                names.append(f's{b}_{i}')
                fh.write(f'{names[-1]}\t1\t{64 * b + i + 1}\t0\tA\tT\n')
        rows.append(f'b{b}.var\tb{b}.npy')
    (tmp_path / 'p.schema').write_text('\n'.join(rows) + '\n')
    (tmp_path / 'x.tsv').write_text(
        'ID\tA1\tA2\n' + ''.join(f'{v}\tA\tT\n' for v in names))
    variants = load.load_variant_list(str(tmp_path / 'x.tsv'))
    kw = dict(denylist=[], ldthresh=1.0, dtype=torch.float32,
              u_dtype=u_dtype, device=cuda)
    plain, _ = load.load_ld_from_schema(str(tmp_path / 'p.schema'),
                                        variants, **kw)
    block_bytes = 64 * 64 * torch.empty(0, dtype=u_dtype).element_size()
    monkeypatch.setattr(blocks, 'STAGING_BYTES', 2 * block_bytes)
    made = []
    real = blocks._staging_slices
    monkeypatch.setattr(blocks, '_staging_slices',
                        lambda *a: made.append(real(*a)) or made[-1])
    spilled, _ = load.load_ld_from_schema(str(tmp_path / 'p.schema'),
                                          variants, mmap=True, **kw)
    assert [len(m) for m in made] == [3]
    for x, y in zip(plain.buckets, spilled.buckets):
        for f in ('u', 's', 'inv_s', 'd', 'perm', 'seq'):
            assert torch.equal(getattr(x, f), getattr(y, f)), f


@pytest.mark.parametrize('u_dtype', [torch.float32, torch.bfloat16])
def test_group_route_workspace_per_stream(cuda, u_dtype):
    """Each stream has its own group-route workspace (the panels' partials
    and the tickets), so launches on two streams never share tickets:
    launches taking turns on the two streams equal the one-stream result
    bit for bit, and every launch leaves its tickets zero."""
    u, s, d, x = _matvec_operands(cuda, 4, 2048, 1024, 2, u_dtype, 7)
    ref = bm.bucket_matvec_multi(u, s, d, x)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    for i in range(5):
        st = streams[i % 2]
        with torch.cuda.stream(st):
            y = bm.bucket_matvec_multi(u, s, d, x)
        st.synchronize()
        assert torch.equal(y, ref)
    assert {st.cuda_stream for st in streams} <= {k[1] for k in bm._workspace}
    for (dev, _, P, C, G, panels), (ws, room) in bm._workspace.items():
        assert not ws[:room * G].view(torch.int32).any()


def test_group_plans_agree_with_kernel_layout(cuda):
    """Every group plan the Python planner makes over a sweep of oversize
    bucket shapes and cohort counts that fits a CTA's shared memory is
    one the kernel library takes (its shape rules hold and its
    shared-memory layout comes to the planner's byte count,
    block_matvec.cu::group_shape_ok), and the card places one cluster of
    it; one that does not fit (8192-row bf16 blocks at 8 cohorts) is
    refused by the wrapper before any launch."""
    from vilma_tpu_torch.ops.cuda import build
    lib = build.library()
    planned = over = 0
    for itemsize in (2, 4):
        for P in (8, 1000, 2048, 4096, 8192):
            for R in (8, 1000, 1024, 4096):
                for C in bm.WIDTHS:
                    pl = bm.plan(P, R, itemsize, C)
                    if pl.route != 'group':
                        continue
                    if pl.smem > bm._SMEM_MAX:
                        over += 1
                        continue
                    assert bm._capacity(lib, cuda, P, R, C,
                                        int(itemsize == 2), pl) >= 1
                    planned += 1
    assert planned > 0 and over > 0
    u, s, d, x = _matvec_operands(cuda, 1, 8192, 8, 8, torch.bfloat16, 0)
    with pytest.raises(ValueError, match='shared-memory budget'):
        bm.bucket_matvec_multi(u, s, d, x)


@pytest.mark.parametrize('u_dtype', [torch.bfloat16, torch.float32])
def test_cluster_plans_agree_with_kernel_layout(cuda, u_dtype):
    """Every cluster plan the Python planner makes over a sweep of bucket
    shapes is one the kernel library takes: its shape rules hold and its
    shared-memory layout comes to the planner's byte count
    (block_matvec.cu::cluster_shape_ok), and the card places the cluster."""
    from vilma_tpu_torch.ops.cuda import build
    lib = build.library()
    itemsize = torch.tensor([], dtype=u_dtype).element_size()
    planned = 0
    for P in (128, 256, 512, 1024, 2048):
        for R in (64, 136, 256, 288, 512, 1024):
            for C in (1, 2, 3):
                pl = bm.plan(P, R, itemsize, C)
                if pl.route == 'cluster':
                    assert bm._capacity(lib, cuda, P, R, C,
                                        int(itemsize == 2), pl) >= 1
                    planned += 1
    assert planned > 0


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
@pytest.mark.parametrize('K', [7, 600, 2500])
def test_compact_kernels_match_plain(cuda, P, K):
    """600 components take the kernels' multi-tile path for the sums,
    2500 for the one-pass prologue too."""
    A = 3
    args = _compact_args(cuda, P, K, 20_000, A, seed=P * 1000 + K)
    before = dict(co.launches)
    pm, pv, kl = co.prologue(*args, num_annotations=A)
    pm2, pv2, kl2 = co.prologue(*args, num_annotations=A)
    sums = co.delta_sums(*args, num_annotations=A)
    again = co.delta_sums(*args, num_annotations=A)
    rpm, rpv, rkl = co.prologue_plain(*args, num_annotations=A)
    rsums = co.delta_sums_plain(*args, num_annotations=A)
    torch.cuda.synchronize()
    assert co.launches['prologue'] == before['prologue'] + 2
    assert co.launches['delta_sums'] == before['delta_sums'] + 2
    assert (torch.equal(pm, pm2) and torch.equal(pv, pv2)
            and torch.equal(kl, kl2))
    assert torch.equal(sums, again)
    assert _scaled_err(pm, rpm) <= 1e-5
    assert _scaled_err(pv, rpv) <= 1e-5
    assert abs(float(kl) - float(rkl)) <= 1e-4 * abs(float(rkl))
    assert _scaled_err(sums, rsums) <= 1e-5


def _clamp_heavy_args(device, P, K, I, A, seed):
    """Compact operands where most components of most SNPs sit beyond
    the f32 clamp (69 nats below the largest logit): variances 1e-8..1,
    natural means at z-scores up to 1.5 (~100x the ordinary input's), and
    hyper-deltas of e^-600..e^-80 on ~80% of the components (as a
    converged fit leaves the components it does not use). Larger means
    make post_vars = E[y^2] - pm^2 cancel in f32, in the kernel and the
    plain version alike."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((K, P, P))
    covs = (a @ np.swapaxes(a, 1, 2) + P * np.eye(P)) * np.exp(
        np.linspace(np.log(1e-8), 0.0, K))[:, None, None]
    log_det = np.linalg.slogdet(covs)[1]
    log_hd = np.log(rng.dirichlet(np.ones(K), A))
    unused = rng.random((A, K)) < 0.8
    log_hd[unused] = rng.uniform(-600, -80, unused.sum())
    dterm = 1.0 / rng.uniform(0.01, 0.05, (P, I)) ** 2
    zs = rng.uniform(-1.5, 1.5, (P, I))

    def f32(v):
        return torch.as_tensor(np.ascontiguousarray(v), dtype=torch.float32,
                               device=device)

    return (co.build_coeffs(f32(np.linalg.inv(covs)), f32(log_det))
            .contiguous(), f32((log_hd - 0.5 * log_det).T),
            torch.as_tensor(rng.integers(0, A + 1, I).astype(np.int32),
                            device=device),
            f32(dterm), f32(zs * np.sqrt(dterm)))


def _epoch_args(device, P, K, I, A, B, live, seed, clamp_heavy=False):
    """Epoch-kernel operands: `live` filled history slots of B, the rest
    inert (zero vectors, coefficient 0, scale 1)."""
    make = _clamp_heavy_args if clamp_heavy else _compact_args
    coeffs, scores_t, ann, dterm, nat = make(device, P, K, I, A, seed)
    rng = np.random.default_rng(seed + 1)
    hist = np.zeros((B, P, I))
    hist_scale = 0.5 * np.sqrt(dterm.cpu().numpy()) if clamp_heavy else 0.5
    hist[:live] = rng.standard_normal((live, P, I)) * hist_scale
    inv_scales = np.ones((B + 1, P))
    inv_scales[:live + 1] = rng.uniform(0.7, 1.4, (live + 1, P))
    hist_c = np.zeros(B)
    hist_c[:live] = rng.uniform(0.1, 1.0, live)

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=device)

    return (coeffs, scores_t, ann, dterm, nat, f32(hist), f32(inv_scales),
            f32(hist_c))


@pytest.mark.parametrize('P', [1, 2, 3])
@pytest.mark.parametrize('K', [7, 600, 2500])
def test_kdim_kernels_match_plain(cuda, P, K):
    """The per-component [K, P, I] natural mean of --learn-scaling fits;
    2500 components take the one-pass prologue's multi-tile path."""
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


@pytest.mark.parametrize('form', ['shared', 'kdim', 'epochs'])
@pytest.mark.parametrize('P', [1, 2, 3])
def test_prologue_two_snps_a_thread_at_odd_i(cuda, form, P):
    """At 400,001 SNPs every CTA the card holds gets a tile of 512, so the
    prologue takes two SNPs a thread (the epoch state at no live epoch
    too), and the last tile's second lanes are dead: within the bands of
    the plain version, the partial's merge too, bit-for-bit repeatable."""
    A, K, I = 3, 64, 400_001
    if form == 'epochs':
        args = _epoch_args(cuda, P, K, I, A, 2, 0, seed=P + 7)
        run = functools.partial(co.prologue_epochs, num_live=0)
        partial = functools.partial(co.prologue_epochs_partial, num_live=0)
        plain = co.prologue_epochs_plain
    else:
        args = list(_compact_args(cuda, P, K, I, A, seed=P + 5))
        if form == 'kdim':
            gen = torch.Generator(device=cuda).manual_seed(P)
            args[4] = torch.randn(K, P, I, generator=gen, device=cuda) * 0.5
        run, partial, plain = co.prologue, co.prologue_partial, \
            co.prologue_plain
    pm, pv, kl = run(*args, num_annotations=A)
    pm2, pv2, kl2 = run(*args, num_annotations=A)
    merged = co.prologue_merge(partial(*args, num_annotations=A)[None],
                               args[2], num_annotations=A)
    rpm, rpv, rkl = plain(*args, num_annotations=A)
    torch.cuda.synchronize()
    assert (torch.equal(pm, pm2) and torch.equal(pv, pv2)
            and torch.equal(kl, kl2))
    for got in ((pm, pv, kl), merged):
        assert _scaled_err(got[0], rpm) <= 1e-5
        assert _scaled_err(got[1], rpv) <= 1e-5
        assert abs(float(got[2]) - float(rkl)) <= 1e-4 * abs(float(rkl))


@pytest.mark.parametrize('P', [1, 2, 3])
@pytest.mark.parametrize('live', [0, 1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize('clamp_heavy', [False, True])
def test_epoch_prologue_live_counts(cuda, P, live, clamp_heavy):
    """The one-pass epoch prologue at every live count up to 6 of 8 slots
    (2 and below hold the epochs in registers, 3 to 6 read them at run
    time), on an ordinary and on a clamp-heavy input: within its bands of
    the two-pass plain version and bit-for-bit repeatable."""
    A, B, K = 3, 8, 600
    args = _epoch_args(cuda, P, K, 20_000, A, B, live, seed=P * 10 + live,
                       clamp_heavy=clamp_heavy)
    kw = dict(num_annotations=A, num_live=live)
    before = co.launches['prologue_epochs']
    pm, pv, kl = co.prologue_epochs(*args, **kw)
    pm2, pv2, kl2 = co.prologue_epochs(*args, **kw)
    rpm, rpv, rkl = co.prologue_epochs_plain(*args, num_annotations=A)
    torch.cuda.synchronize()
    assert co.launches['prologue_epochs'] == before + 2
    assert (torch.equal(pm, pm2) and torch.equal(pv, pv2)
            and torch.equal(kl, kl2))
    assert _scaled_err(pm, rpm) <= 1e-5
    assert _scaled_err(pv, rpv) <= 1e-5
    assert abs(float(kl) - float(rkl)) <= 1e-4 * abs(float(rkl))


@pytest.mark.parametrize('P,K,A,live,I', [
    (2, 600, 1, 1, 20_000),       # one annotation
    (2, 600, 12, 3, 20_000),      # A > 8, the run-time epoch loop
    (1, 7, 4, 0, 20_000),
    (3, 600, 4, 1, 20_000),
    (2, 3000, 12, 2, 20_000),     # K over three tiles beside the partial
    (2, 600, 4, 1, 300_000),      # more SNP tiles than CTAs: the partial
                                  # accumulates across the grid stride
])
@pytest.mark.parametrize('clamp_heavy', [False, True])
def test_epoch_sums_shapes(cuda, P, K, A, live, I, clamp_heavy):
    """The z-only epoch sums (sorted per-CTA reduction) within their band
    of the plain version, with pad SNPs, bit-for-bit repeatable."""
    B = 4
    args = _epoch_args(cuda, P, K, I, A, B, live, seed=P * 7 + K + A,
                       clamp_heavy=clamp_heavy)
    assert bool((args[2] == A).any())            # pad SNPs present
    kw = dict(num_annotations=A, num_live=live)
    before = co.launches['delta_sums_epochs']
    sums = co.delta_sums_epochs(*args, **kw)
    again = co.delta_sums_epochs(*args, **kw)
    rsums = co.delta_sums_epochs_plain(*args, num_annotations=A)
    torch.cuda.synchronize()
    assert co.launches['delta_sums_epochs'] == before + 2
    assert sums.shape == (A, K)
    assert torch.equal(sums, again)
    assert _scaled_err(sums, rsums) <= 1e-5


@pytest.mark.parametrize('P,K,A,kdim,I', [
    (2, 600, 1, False, 20_000),        # one annotation
    (2, 600, 12, True, 20_000),        # A > 8
    (3, 600, 4, False, 300_000),       # more SNP tiles than CTAs
    (2, 14_000, 4, False, 3_000),      # K·A past one group's partial
    (2, 14_000, 4, True, 3_000),
    (1, 20_000, 8, False, 3_000),
])
def test_compact_sums_shapes(cuda, P, K, A, kdim, I):
    """The z-only [P, I] and kdim sums (sorted per-CTA reduction, K in
    groups where K·A does not fit one) within their band of the plain
    version, with pad SNPs, bit-for-bit repeatable."""
    args = list(_compact_args(cuda, P, K, I, A, seed=P * 13 + K + A))
    if kdim:
        gen = torch.Generator(device=cuda).manual_seed(K + A)
        args[4] = torch.randn(K, P, I, generator=gen, device=cuda) * 0.5
    assert bool((args[2] == A).any())             # pad SNPs present
    ncol = P * (P + 1) // 2 + 1
    kt, kg, _ = co._launch_shape(I, K, A, ncol, sums=True)
    assert (kg < K) == (K >= 14_000)
    key = 'delta_sums_kdim' if kdim else 'delta_sums'
    before = co.launches[key]
    sums = co.delta_sums(*args, num_annotations=A)
    again = co.delta_sums(*args, num_annotations=A)
    rsums = co.delta_sums_plain(*args, num_annotations=A)
    torch.cuda.synchronize()
    assert co.launches[key] == before + 2
    assert sums.shape == (A, K)
    assert torch.equal(sums, again)
    assert _scaled_err(sums, rsums) <= 1e-5


@pytest.mark.parametrize('K,A', [(14_000, 4), (20_000, 8)])
def test_epoch_sums_any_k_times_a(cuda, K, A):
    """The epoch sums past one group's partial: K in groups, within their
    band of the plain version, bit-for-bit repeatable."""
    P, B, live, I = 2, 4, 1, 3_000
    args = _epoch_args(cuda, P, K, I, A, B, live, seed=K + A)
    kw = dict(num_annotations=A, num_live=live)
    kt, kg, _ = co._launch_shape(I, K, A, 4, sums=True,
                                 table_floats=(live + 1) * P + live)
    assert kg < K
    sums = co.delta_sums_epochs(*args, **kw)
    again = co.delta_sums_epochs(*args, **kw)
    rsums = co.delta_sums_epochs_plain(*args, num_annotations=A)
    torch.cuda.synchronize()
    assert torch.equal(sums, again)
    assert _scaled_err(sums, rsums) <= 1e-5


@pytest.mark.parametrize('power', [0.5, 1.0])
def test_powered_matrix_dot_matches_plain(cuda, power):
    """sim's LD products: blocks.dot on matrix_power(LD, power) (C = 1,
    f32 U, the powered buckets gathering and scattering by their
    sequential positions) launches the matvec kernel and lands within
    its f32 band of the same product through the plain version."""
    from vilma_tpu_torch.ops import blocks, lowrank
    rng = np.random.default_rng(5)
    n = 700
    order = rng.permutation(n)
    factors, indices, start = [], [], 0
    for size in (40, 300, 17, 250):                 # 93 slots missing
        lag = np.abs(np.subtract.outer(np.arange(size), np.arange(size)))
        factors.append(lowrank.factor_block(X=rng.uniform(0.3, 0.9) ** lag,
                                            t=0.999999))
        indices.append(order[start:start + size])
        start += size
    ld = blocks.pack(factors, indices, n, dtype=torch.float32, device=cuda)
    host = blocks.pack(factors, indices, n, dtype=torch.float32)
    x = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32)
    before = bm.launches + bm.launches_group
    y = blocks.dot(blocks.matrix_power(ld, power), x.to(cuda))
    torch.cuda.synchronize()
    assert bm.launches + bm.launches_group > before
    ref = blocks.dot(blocks.matrix_power(host, power), x)
    assert _scaled_err(y.cpu(), ref) <= 1e-5


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_ld_diagonal_same_bits_on_card_and_host(cuda, dtype):
    """blocks.diag (check_ld_schema --trace, the engine's LD diagonal)
    sums over the rank in a fixed pairwise order of elementwise adds, so
    the card gives the host's bits (block ranks 1, 64, 300 and 500:
    powers of two and not)."""
    from vilma_tpu_torch.ops import blocks, lowrank
    rng = np.random.default_rng(8)
    n = 900
    order = rng.permutation(n)
    factors, indices, start = [], [], 0
    for size, t in ((1, 0.9), (64, 0.999999), (300, 0.999999),
                    (500, 0.9)):
        lag = np.abs(np.subtract.outer(np.arange(size), np.arange(size)))
        factors.append(lowrank.factor_block(X=rng.uniform(0.3, 0.9) ** lag,
                                            t=t))
        indices.append(order[start:start + size])
        start += size
    host = blocks.diag(blocks.pack(factors, indices, n, dtype=dtype))
    card = blocks.diag(blocks.pack(factors, indices, n, dtype=dtype,
                                   device=cuda))
    assert torch.equal(card.cpu(), host)


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip('needs two CUDA devices (operands on the second while '
                    'the first is current)')
    return torch.device('cuda', 1)


@pytest.mark.parametrize('kernel', ['matvec_cluster', 'matvec_group',
                                    'compact', 'kdim', 'epochs'])
def test_kernels_launch_on_their_operands_card(two_cards, kernel):
    """With cuda:0 current, each launcher runs its kernel on the card of
    its operands (cuda:1): results there, equal to the plain versions'
    (the shared-memory grants and occupancy queries act on cuda:1)."""
    torch.cuda.set_device(0)
    dev = two_cards
    if kernel.startswith('matvec'):
        P, R = (2048, 1024) if kernel == 'matvec_group' else (1024, 512)
        gen = torch.Generator(device=dev).manual_seed(3)
        u = torch.randn(3, P, R, generator=gen, device=dev) / math.sqrt(P)
        s = torch.rand(3, R, generator=gen, device=dev) + 0.1
        d = torch.rand(3, P, generator=gen, device=dev)
        x = torch.randn(3, 2, P, generator=gen, device=dev)
        got = bm.bucket_matvec_multi(u, s, d, x)
        pairs = [(got, bm.bucket_matvec_multi_plain(u, s, d, x))]
    else:
        A = 3
        if kernel == 'epochs':
            args = _epoch_args(dev, 2, 600, 20_000, A, 4, 2, seed=5)
            kw = dict(num_annotations=A, num_live=2)
            run = (co.prologue_epochs, co.delta_sums_epochs)
            plain = (co.prologue_epochs_plain, co.delta_sums_epochs_plain)
        else:
            args = list(_compact_args(dev, 2, 600, 20_000, A, seed=5))
            if kernel == 'kdim':
                args[4] = torch.randn(600, 2, 20_000, device=dev) * 0.5
            kw = dict(num_annotations=A)
            run = (co.prologue, co.delta_sums)
            plain = (co.prologue_plain, co.delta_sums_plain)
        pairs = [(run[0](*args, **kw)[0], plain[0](*args, **kw)[0]),
                 (run[1](*args, **kw), plain[1](*args, **kw))]
    torch.cuda.synchronize(dev)
    assert torch.cuda.current_device() == 0
    for got, want in pairs:
        assert got.device == dev
        assert _scaled_err(got, want) <= 1e-5


def test_sharded_step_on_one_card(cuda):
    """An outer step on 4 shards co-located on the card equals the
    unsharded step on the card (f32): the kernels run per shard and the
    sums reduce across shards."""
    from vilma_tpu_torch.inference import engine
    from vilma_tpu_torch.ops import blocks, lowrank
    from vilma_tpu_torch.parallel import alignment, mesh as mesh_mod
    rng = np.random.default_rng(0)
    n, P = 2048, 2
    factors, idx = [], []
    for a in range(0, n, 256):
        lag = np.abs(np.subtract.outer(np.arange(256), np.arange(256)))
        factors.append(lowrank.factor_block(X=0.6 ** lag, t=1.0))
        idx.append(np.arange(a, a + 256))
    se = rng.uniform(0.01, 0.05, (P, n))
    betas = rng.standard_normal((P, n)) * se * 2
    kw = dict(annotations=np.ones((n, 1)),
              mixture_covs=[np.eye(P) * s for s in (1e-6, 1e-4, 1e-2)],
              scaled=False, scale_se=False, gwas_N=np.full(P, 1e5),
              init_hg=np.full(P, 0.3), dtype=torch.float32)
    ld = blocks.pack(factors, idx, n, dtype=torch.float32, device=cuda)
    plain = engine.build_model_data(betas, se, [ld, ld], device=cuda, **kw)
    mesh = mesh_mod.make_mesh(4, devices=['cuda:0'] * 4)
    lds = blocks.pack(factors, idx, n, dtype=torch.float32,
                      device=list(mesh.devices), n_shards=4)
    sharded = engine.build_model_data(betas, se, [lds, lds], mesh=mesh, **kw)
    nat = torch.as_tensor(rng.standard_normal((P, n)) * 1e-2,
                          dtype=torch.float32, device=cuda)
    hyper = torch.full((1, 3), 1 / 3, device=cuda)
    st = engine.VIState(nat_mu=nat, hyper_delta=hyper,
                        error_scaling=torch.ones(P, device=cuda),
                        L=(1., 1., 1.), elbo=0., running_elbo_delta=math.nan,
                        num_err=0)
    engine.host_syncs = 0
    a, pm = engine.outer_step(plain, st)
    syncs = engine.host_syncs
    before = dict(co.launches)
    b, pms = engine.outer_step(sharded, mesh_mod.shard_state(st, mesh))
    assert engine.host_syncs == 2 * syncs
    assert co.launches['prologue'] - before['prologue'] == 4 * syncs
    assert _scaled_err(torch.cat(pms, dim=-1), pm) <= 1e-5
    assert abs(b.elbo / a.elbo - 1) <= 1e-5
    assert alignment.compute_layout([ld], n, n_shards=4)[1] == n


def _split_ops(args, form, ks):
    """The operands of the components `ks`: coefficient and score rows,
    and a kdim natural mean's rows."""
    out = list(args)
    out[0], out[1] = args[0][ks].contiguous(), args[1][ks].contiguous()
    if form == 'kdim':
        out[4] = args[4][ks].contiguous()
    return out


@pytest.mark.parametrize('M', [2, 3])
@pytest.mark.parametrize('K', [7, 600, 2500])
@pytest.mark.parametrize('form', ['shared', 'kdim', 'epochs'])
def test_split_kernels_match_plain(cuda, form, K, M):
    """The K-split kernels (component sharding) against their plain
    versions on the same inputs: each partial finished alone by the plain
    merge, pass 1, pass 2 given the kernels' stacked pass-1 partials (it
    merges the normalizer itself), and the prologue's merge on the
    kernels' partials, within the f32 bands (1e-4 for the KL); the whole
    split path against the whole-K kernels; every launch counted under its
    own key (the merge once a call), none under a normalizer merge, and
    repeatable bit for bit."""
    from vilma_tpu_torch.parallel.mesh import k_slices
    P, A, I = 2, 3, 20_000
    if form == 'epochs':
        args = _epoch_args(cuda, P, K, I, A, B=4, live=2, seed=K + M)
        kw = dict(num_annotations=A, num_live=2)
        fns = (co.prologue_epochs_partial, co.delta_norm_epochs,
               co.delta_sums_epochs_given, co.prologue_epochs,
               co.delta_sums_epochs)
    else:
        args = list(_compact_args(cuda, P, K, I, A, seed=K + M))
        if form == 'kdim':
            gen = torch.Generator(device=cuda).manual_seed(K)
            args[4] = torch.randn(K, P, I, generator=gen, device=cuda) * 0.5
        kw = dict(num_annotations=A)
        fns = (co.prologue_partial, co.delta_norm, co.delta_sums_given,
               co.prologue, co.delta_sums)
    plain = [getattr(co, f.__name__ + '_plain') for f in fns]
    kss = [slice(a, b) for a, b in k_slices(K, M)]
    ann = args[2]

    def split():
        accs = torch.stack([fns[0](*_split_ops(args, form, ks), **kw)
                            for ks in kss])
        parts = torch.stack([fns[1](*_split_ops(args, form, ks), **kw)
                             for ks in kss])
        sums = torch.cat([fns[2](*_split_ops(args, form, ks), parts, **kw)
                          for ks in kss], dim=1)
        return (co.prologue_merge(accs, ann, num_annotations=A)
                + (sums, accs, parts))

    before = dict(co.launches)
    got = split()
    again = split()
    torch.cuda.synchronize()
    suffix = {'shared': '', 'kdim': '_kdim', 'epochs': '_epochs'}[form]
    counted = ((f'prologue{suffix}_partial', M), (f'delta_norm{suffix}', M),
               ('prologue_merge', 1), (f'delta_sums{suffix}_given', M))
    for key, n in counted:
        assert co.launches[key] == before[key] + 2 * n, key
    assert 'norm_merge' not in co.launches
    assert sum(co.launches.values()) == sum(before.values()) + 2 * sum(
        n for _, n in counted)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    pm, pv, kl, sums, accs, parts = got
    finish = co.prologue_merge_plain
    for j, ks in enumerate(kss):
        ops = _split_ops(args, form, ks)
        k_out = finish(accs[j][None], ann, num_annotations=A)
        p_out = finish(plain[0](*ops, **kw)[None], ann, num_annotations=A)
        assert _scaled_err(k_out[0], p_out[0]) <= 1e-5
        assert _scaled_err(k_out[1], p_out[1]) <= 1e-5
        assert abs(float(k_out[2]) / float(p_out[2]) - 1) <= 1e-4
        assert _scaled_err(parts[j], plain[1](*ops, **kw)) <= 1e-5
        assert _scaled_err(fns[2](*ops, parts, **kw),
                           plain[2](*ops, parts, **kw)) <= 1e-5
    for a, b in zip(co.prologue_merge(accs, ann, num_annotations=A)[:2],
                    co.prologue_merge_plain(accs, ann,
                                            num_annotations=A)[:2]):
        assert _scaled_err(a, b) <= 1e-5
    wpm, wpv, wkl = fns[3](*args, **kw)
    assert _scaled_err(pm, wpm) <= 1e-5 and _scaled_err(pv, wpv) <= 1e-5
    assert abs(float(kl) / float(wkl) - 1) <= 1e-4
    assert _scaled_err(sums, fns[4](*args, **kw)) <= 1e-5


@pytest.mark.parametrize('P', [1, 2, 3])
def test_prologue_merge_repeats_across_sizes_and_streams(cuda, P):
    """The one-launch merge at I = 20,000 (four SNPs a thread) and
    I = 4,097 (one at a time: I is no multiple of 4), with pad SNPs,
    called back to back and on two streams in turn (each stream keeps
    its own ticket, which each launch leaves at 0): the same bits every
    time, one launch a call, pm and pv within the f32 band of the plain
    version and the KL within 1e-4 of it."""
    M, A = 3, 4
    gen = torch.Generator(device=cuda).manual_seed(P)
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    for I in (20_000, 4_097):
        rows = co.acc_rows(P)
        parts = torch.rand(M, rows, I, generator=gen, device=cuda) + 0.5
        parts[:, 0] = torch.randn(M, I, generator=gen, device=cuda) * 30
        ann = torch.randint(0, A + 1, (I,), generator=gen, device=cuda,
                            dtype=torch.int32)
        before = co.launches['prologue_merge']
        outs = [co.prologue_merge(parts, ann, num_annotations=A)
                for _ in range(3)]
        for st in streams + streams:
            st.wait_stream(torch.cuda.current_stream(cuda))
            with torch.cuda.stream(st):
                outs.append(co.prologue_merge(parts, ann, num_annotations=A))
            torch.cuda.current_stream(cuda).wait_stream(st)
        torch.cuda.synchronize()
        assert co.launches['prologue_merge'] == before + len(outs)
        for out in outs[1:]:
            assert all(torch.equal(a, b) for a, b in zip(outs[0], out))
        pm, pv, kl = outs[0]
        want = co.prologue_merge_plain(parts, ann, num_annotations=A)
        assert pm.shape == pv.shape == (P, I) and kl.dim() == 0
        assert _scaled_err(pm, want[0]) <= 1e-5
        assert _scaled_err(pv, want[1]) <= 1e-5
        assert abs(float(kl) / float(want[2]) - 1) <= 1e-4


@pytest.mark.parametrize('placement', ['one_card', 'two_cards'])
def test_comp_sharded_step_on_one_card(cuda, placement):
    """An outer step on a comp = 2, snp = 2 mesh equals the unsharded
    step on the card (f32) with the host syncs of the unsharded step: the
    K-split kernels and the merges run per shard, the whole-K kernels not
    at all. The shards co-located on the card, or each comp row on a card
    of its own (the comp gathers cross cards; skips with one card)."""
    from vilma_tpu_torch.inference import engine
    from vilma_tpu_torch.ops import blocks, lowrank
    from vilma_tpu_torch.parallel import mesh as mesh_mod
    if placement == 'two_cards' and torch.cuda.device_count() < 2:
        pytest.skip('needs two CUDA devices (a comp row on each)')
    devices = (['cuda:0'] * 4 if placement == 'one_card'
               else ['cuda:0', 'cuda:0', 'cuda:1', 'cuda:1'])
    rng = np.random.default_rng(0)
    n, P = 2048, 2
    factors, idx = [], []
    for a in range(0, n, 256):
        lag = np.abs(np.subtract.outer(np.arange(256), np.arange(256)))
        factors.append(lowrank.factor_block(X=0.6 ** lag, t=1.0))
        idx.append(np.arange(a, a + 256))
    se = rng.uniform(0.01, 0.05, (P, n))
    betas = rng.standard_normal((P, n)) * se * 2
    kw = dict(annotations=np.ones((n, 1)),
              mixture_covs=[np.eye(P) * s for s in (1e-6, 1e-5, 1e-4, 1e-3,
                                                     1e-2)],
              scaled=False, scale_se=False, gwas_N=np.full(P, 1e5),
              init_hg=np.full(P, 0.3), dtype=torch.float32)
    ld = blocks.pack(factors, idx, n, dtype=torch.float32, device=cuda)
    plain = engine.build_model_data(betas, se, [ld, ld], device=cuda, **kw)
    mesh = mesh_mod.make_mesh(2, n_comp=2, devices=devices)
    lds = blocks.pack(factors, idx, n, dtype=torch.float32,
                      device=list(mesh.devices), n_shards=2,
                      shards=list(mesh.snp_shards))
    sharded = engine.build_model_data(betas, se, [lds, lds], mesh=mesh, **kw)
    nat = torch.as_tensor(rng.standard_normal((P, n)) * 1e-2,
                          dtype=torch.float32, device=cuda)
    st = engine.VIState(nat_mu=nat, hyper_delta=torch.full((1, 5), 0.2,
                                                           device=cuda),
                        error_scaling=torch.ones(P, device=cuda),
                        L=(1., 1., 1.), elbo=0., running_elbo_delta=math.nan,
                        num_err=0)
    engine.host_syncs = 0
    a, pm = engine.outer_step(plain, st)
    syncs = engine.host_syncs
    before = dict(co.launches)
    b, pms = engine.outer_step(sharded, mesh_mod.shard_state(st, mesh))
    assert engine.host_syncs == 2 * syncs
    assert co.launches['prologue_partial'] - before['prologue_partial'] == \
        4 * syncs
    assert co.launches['prologue'] == before['prologue']
    assert _scaled_err(mesh.gather_spans(pms).to(pm.device), pm) <= 1e-5
    assert abs(b.elbo / a.elbo - 1) <= 1e-5
    assert [s.hyper_delta.shape[1] for s in b.shards] == [3, 3, 2, 2]


@pytest.mark.parametrize('rank_frac', [1.0, 0.5])
def test_synthetic_ld_card_route_matches_host(cuda, rank_frac):
    """utils/synthetic's card route (batched float64 eigh on the card,
    ragged last block) packs the host route's matrix: the same ranks and
    U diag(s) U^T within 1e-12, then the packed matrices' products."""
    from vilma_tpu_torch.ops import blocks
    from vilma_tpu_torch.utils import synthetic
    card = synthetic.synthetic_ld(2500, 1024, rank_frac, seed=3,
                                  device=cuda)
    host = synthetic.synthetic_ld(2500, 1024, rank_frac, seed=3,
                                  device='cpu')
    assert card.rank == host.rank and card.missing == host.missing == ()
    assert card.buckets[0].u.device.type == 'cuda'
    np.testing.assert_allclose(blocks.to_dense(card), blocks.to_dense(host),
                               rtol=0, atol=1e-12)
