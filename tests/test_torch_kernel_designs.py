"""The designs of the port's redesigned CUDA kernels, checked on the CPU.

The kernels run only on a card (tests/test_torch_cuda.py and
chip_smoke.py hold them against their plain versions there). Here:

* the matvec planner's route and group size for the bucket shapes of
  the 1M-SNP LD (977 blocks of 1024 SNPs at rank 512, whose last block in
  bench.py's LD holds 576 SNPs at rank 288), for bf16 and f32 U, and for
  blocks too large for a 16-CTA cluster (the group route), with the
  group route's CTAs per block independent of the number of blocks;
* the cluster matvec's arithmetic, emulated: row-slice partials of
  t = U^T x added in cluster-rank order, then scaled and rounded, then
  the second contraction, against the plain version and the JAX
  package's Pallas kernel in interpret mode;
* the group matvec's arithmetic, emulated in the kernel's order: each
  CTA's t for its own columns, its partial y, the partials added by row
  share in rank order; at f64 and in U's type;
* the one-pass prologue's online accumulators (epoch, [P, I] and kdim
  forms), emulated over K, against the two-pass clamped plain version
  (f64 at the JAX package's route-equality tolerances, f32 within
  chip_smoke.py's bands) and the Pallas kernel, on an ordinary and on a
  clamp-heavy input; at K = 42,999, the runs of 128 components that keep
  f32 sums from drifting;
* the z-only sums of all three forms in the kernel's order (pass 1's
  online normalizer, the clamped weights, each CTA's sums by annotation
  in SNP order across its grid stride, the partials added by
  reduce_rows), against the plain versions and the Pallas kernels;
* the sums' launch shapes: all of K = 582 in one tile, small enough for
  four CTAs per SM, and K taken in groups where K·A does not fit.
"""
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vilma_tpu.ops.pallas import block_matvec as jbm
from vilma_tpu.ops.pallas import compact_obj as jco
from vilma_tpu_torch.convert import tensor_from_numpy
from vilma_tpu_torch.ops.cuda import block_matvec as tbm
from vilma_tpu_torch.ops.cuda import compact_obj as tco
from vilma_tpu_torch.utils.config import epsilon

from tests.torch_parity import t2n

# chip_smoke.py's bands (kernel against plain version on the card)
BAND_F32 = 1e-5
BAND_BF16 = 2.0 ** -8
BAND_KL = 1e-4
# threads per CTA of the compact kernels (csrc kThreads): SNPs per tile
THREADS = 256
WARPS = THREADS // 32
# threads of a group-route matvec CTA that compute steps 1 and 2 and that
# reduce (step 3) (csrc/block_matvec.cu kComputeThreads, kReduceThreads)
COMPUTE_THREADS = 384
REDUCE_THREADS = 128


# ---------------------------------------------------------------------------
# the matvec planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('P,R,itemsize,route,G', [
    # the 1M-SNP LD: full blocks, and bench.py's last block
    (1024, 512, 2, 'cluster', 8),
    (1024, 512, 4, 'cluster', 16),
    (1024, 288, 2, 'cluster', 4),
    (1024, 288, 4, 'cluster', 8),
    # small blocks take fewer CTAs
    (128, 64, 2, 'cluster', 1),
    (256, 136, 2, 'cluster', 1),
    (512, 256, 2, 'cluster', 2),
    (2048, 512, 2, 'cluster', 16),
    (1024, 1024, 2, 'cluster', 16),
    # too large for 16 slices of shared memory, too wide a rank, or
    # fewer than 16 rows per CTA: the group route, up to 128 CTAs each
    # owning 16-byte column groups
    (2048, 512, 4, 'group', 128),
    (2048, 1024, 4, 'group', 128),
    (2048, 1024, 2, 'group', 128),
    (4096, 4096, 2, 'group', 128),
    (8, 8, 2, 'group', 1),
])
@pytest.mark.parametrize('C', [1, 2, 3])
def test_plan_routes_bucket_shapes(P, R, itemsize, route, G, C):
    pl = tbm.plan(P, R, itemsize, C)
    assert (pl.route, pl.cluster) == (route, G)
    if route == 'cluster':
        # the slice of U dominates the CTA's memory; a bf16 ring holds
        # one to two blocks' column blocks
        rows = P // G
        assert rows * R * itemsize < pl.smem <= 227 * 1024
        ncb = -(-R // 64)
        assert (ncb <= pl.slots <= 2 * ncb if itemsize == 2
                else pl.slots == 1)
        # no smaller cluster holds the slice: too many rows for one
        # tensor copy (bf16), or too many bytes even with the least ring
        for g in (1, 2, 4, 8):
            if g < G and P % g == 0:
                assert ((itemsize == 2 and P // g > 256)
                        or tbm.cluster_smem(P, R, C, itemsize, g,
                                            ncb if itemsize == 2 else 1)
                        > 227 * 1024)
    else:
        # the slice: all P rows by cgc column groups of 16 bytes, every
        # column group owned by one CTA; in two buffers where they fit,
        # else read from device memory (0 buffers)
        cgc = tbm.group_columns(R, itemsize, G)
        ncg = R * itemsize // 16
        assert G <= ncg <= G * cgc < 2 * ncg or cgc == 1
        assert pl.smem == tbm.group_smem(P, R, C, itemsize, G, pl.slots)
        assert pl.smem > pl.slots * P * cgc * 16
        fits = tbm.group_smem(P, R, C, itemsize, G, 2) <= 227 * 1024
        assert pl.slots == (2 if fits else 0)


@pytest.mark.parametrize('P,R,itemsize,C,route,G,slots', [
    # the main bf16 bucket keeps 8 CTAs: 12 ring slots at 4 cohorts (as at
    # 3), 10 at 8
    (1024, 512, 2, 4, 'cluster', 8, 12),
    (1024, 512, 2, 8, 'cluster', 8, 10),
    # f32: 16 CTAs at 4 cohorts; at 8 the wider buffers leave no room for
    # the 16 slices: the group route
    (1024, 512, 4, 4, 'cluster', 16, 1),
    (1024, 512, 4, 8, 'group', 128, 2),
    # a larger cluster where 8 no longer fits
    (1024, 288, 4, 4, 'cluster', 8, 1),
    (1024, 288, 4, 8, 'cluster', 16, 1),
    # the group route holds two slices and x [C, P] at 4 cohorts; at 8
    # f32 it reads U from device memory
    (2048, 1024, 4, 4, 'group', 128, 2),
    (2048, 1024, 4, 8, 'group', 128, 0),
    (2048, 1024, 2, 8, 'group', 128, 2),
])
def test_plan_wide_cohorts(P, R, itemsize, C, route, G, slots):
    """The plans at 4 and 8 cohorts per launch count the wider x, t and
    y-partial buffers: fewer ring slots, a larger cluster or the group
    route where the C <= 3 plan no longer fits. 5-7 cohorts run the
    8-cohort kernel."""
    pl = tbm.plan(P, R, itemsize, C)
    assert (pl.route, pl.cluster, pl.slots) == (route, G, slots)
    assert pl.smem <= 227 * 1024
    if route == 'cluster':
        assert pl.smem == tbm.cluster_smem(P, R, C, itemsize, G, slots)
    else:
        assert pl.smem == tbm.group_smem(P, R, C, itemsize, G, slots)
    assert [tbm.width(c) for c in range(1, 9)] == [1, 2, 3, 4, 8, 8, 8, 8]


def test_chip_smoke_resource_report_covers_every_kernel(monkeypatch,
                                                        capsys):
    """chip_smoke.py's ptxas summary, which runs right after a fresh
    build, names every kernel of its kernels line with its cluster size
    (each matvec entry, the backward's among them, has a plan)."""
    import chip_smoke
    from vilma_tpu_torch.ops.cuda import build
    monkeypatch.setattr(build, 'ptxas_report', (
        "ptxas info    : Compiling entry function '_Z6kernelv' for "
        "'sm_90a'\nptxas info    : Used 40 registers, 0 bytes smem"))
    chip_smoke.print_kernel_resources()
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(chip_smoke.KERNELS)
    for name, line in zip(chip_smoke.KERNELS, lines):
        cluster = (chip_smoke.matvec_plan(name).cluster
                   if name.startswith('bucket') else 1)
        assert line.startswith(f'  {name}: cluster {cluster};'), line


@pytest.mark.parametrize('P,R,itemsize,held,groups', [
    # one CTA per SM on 132 SMs: one group at a time
    (2048, 1024, 4, 132, 1),
    # two or three per SM: as many groups
    (2048, 1024, 2, 264, 2),
    (2048, 512, 4, 396, 3),
    # no slice fits: 32 MB blocks, one at a time (the whole card on one
    # block) however many the card holds
    (4096, 4096, 2, 1056, 1),
])
@pytest.mark.parametrize('B', [1, 4, 128])
def test_group_route_spreads_any_bucket_over_the_card(P, R, itemsize, held,
                                                      groups, B):
    """The group route's plan does not depend on B: a bucket of 1 or 4
    blocks runs on 128 CTAs (on as many SMs) per block all the same; more
    blocks fill as many groups as the card holds (`held` CTAs at once: the
    occupancy of the planned shared memory times 132 SMs)."""
    pl = tbm.plan(P, R, itemsize, 2)
    assert (pl.route, pl.cluster) == ('group', 128)
    n = tbm.group_count(B, held, pl)
    assert n == min(B, groups)
    assert n * pl.cluster >= 128


# ---------------------------------------------------------------------------
# the cluster matvec's arithmetic
# ---------------------------------------------------------------------------

def _cluster_matvec(u, s, d, x, G):
    """What the cluster route computes: CTA g's partial over rows
    [g P/G, (g+1) P/G), the G partials added in rank order, scaled by s
    and rounded to U's type, then y = U t + d x."""
    B, P, R = u.shape
    rows = P // G
    bf16 = u.dtype == torch.bfloat16
    uf = u.float()
    xr = x.to(torch.bfloat16).float() if bf16 else x
    t = None
    for g in range(G):
        sl = slice(g * rows, (g + 1) * rows)
        part = torch.einsum('bpr,bcp->bcr', uf[:, sl], xr[..., sl])
        t = part if t is None else t + part
    t = t * s[:, None, :]
    if bf16:
        t = t.to(torch.bfloat16).float()
    return torch.einsum('bpr,bcr->bcp', uf, t) + d[:, None, :] * x


def _matvec_inputs(u_dtype, C, seed, B=3, P=64, R=32):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, P, R)) / np.sqrt(P)
    s = rng.uniform(0.1, 2.0, (B, R))
    d = rng.uniform(0.0, 1.0, (B, P))
    x = rng.standard_normal((B, C, P))
    j = [jnp.asarray(u, dtype=u_dtype)] + [
        jnp.asarray(a, dtype=jnp.float32) for a in (s, d, x)]
    return j, [tensor_from_numpy(np.asarray(a)) for a in j]


def _scaled(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize('u_dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('C', [1, 2, 3, 4, 8])
@pytest.mark.parametrize('G', [1, 4, 16])
def test_cluster_matvec_arithmetic(u_dtype, C, G):
    """Within the kernel's bands of the plain version and of the Pallas
    kernel; with bf16 U also closer to the plain version than a product
    that skips rounding x or t."""
    dt = jnp.float32 if u_dtype == 'f32' else jnp.bfloat16
    band = BAND_F32 if u_dtype == 'f32' else BAND_BF16
    j, t = _matvec_inputs(dt, C, seed=10 * C + G)
    got = t2n(_cluster_matvec(*t, G))
    plain = t2n(tbm.bucket_matvec_multi_plain(*t))
    pallas = np.asarray(jbm.bucket_matvec_multi(*j, interpret=True))
    assert got.shape == plain.shape == pallas.shape
    err = _scaled(got, plain)
    assert err <= band
    assert _scaled(got, pallas) <= band
    if u_dtype == 'bf16':
        u, s, d, x = t
        for skipped in (x.to(torch.bfloat16).float(), None):
            xr = x if skipped is None else skipped
            tt = torch.einsum('bpr,bcp->bcr', u.float(), xr) * s[:, None, :]
            if skipped is None:
                tt = tt.to(torch.bfloat16).float()
            half = torch.einsum('bpr,bcr->bcp', u.float(), tt) + d[:, None] * x
            assert err < _scaled(t2n(half), plain)


# ---------------------------------------------------------------------------
# the group matvec's arithmetic
# ---------------------------------------------------------------------------

# a rank per group size G that the group route takes: at most 32 column
# groups of 16 bytes per CTA, and at least one
GROUP_RANK = {1: 64, 8: 256, 64: 512}


def _butterfly(v, n=32):
    """Lane 0 of a butterfly shuffle sum over the first axis (n lanes):
    v[l] + v[l ^ o] for o = n/2, ..., 2, 1 (warp_sum for n = 32)."""
    lanes = torch.arange(n)
    o = n // 2
    while o >= 1:
        v = v + v[lanes ^ o]
        o //= 2
    return v[0]


def _group_matvec(u, s, d, x, G):
    """What the group route computes (block_matvec.cu, group_matvec_kernel)
    in its order. CTA g owns cgc column groups of 16 bytes
    (block_matvec.group_columns) and rows [g rpc, (g + 1) rpc) of y,
    rpc = ceil(P / G):

    1. t_g: thread (part, column group) adds rows part, part + nparts, ...
       (nparts = 384 / cgc) in order; a butterfly over the 32 / cgc parts of
       each warp, then the 12 warps' sums in warp order; times s, rounded
       to U's type;
    2. its partial y_g[c][p] = sum over its columns, in order, of
       U[p][k] t_g[c][k];
    3. y[c][p] for CTA g's rows: L lanes per value, lane q adding ranks
       [q G/L, (q+1) G/L) in order, the lane sums added in lane order;
       + d x.
    x is rounded to U's type before step 1."""
    B, P, R = u.shape
    C = x.shape[1]
    bf16 = u.dtype == torch.bfloat16
    vec = 8 if bf16 else 4
    uf = u.float().to(x.dtype) if bf16 else u.to(x.dtype)
    xr = x.to(torch.bfloat16).to(x.dtype) if bf16 else x
    ncg = R // vec
    cgc = tbm.group_columns(R, u.element_size(), G)
    nparts = COMPUTE_THREADS // cgc
    lanes = 32 // cgc
    parts = []
    for g in range(G):
        cg0 = min(ncg, g * cgc)
        ncl = min(ncg, cg0 + cgc) - cg0
        cols = slice(cg0 * vec, (cg0 + ncl) * vec)
        yg = x.new_zeros((B, C, P))
        if ncl:
            acc = x.new_zeros((nparts, B, C, ncl * vec))
            for part in range(min(nparts, P)):
                for p in range(part, P, nparts):
                    acc[part] = acc[part] + uf[:, None, p, cols] * xr[:, :, p,
                                                                     None]
            warp_sums = [_butterfly(acc[w * lanes:(w + 1) * lanes], lanes)
                         for w in range(COMPUTE_THREADS // 32)]
            tot = warp_sums[0]
            for ws in warp_sums[1:]:
                tot = tot + ws
            t = tot * s[:, None, cols]
            if bf16:
                t = t.to(torch.bfloat16).to(x.dtype)
            for k in range(ncl * vec):
                yg = yg + uf[:, None, :, cols][..., k] * t[..., k, None]
        parts.append(yg)
    y = x.new_zeros((B, C, P))
    rpc = -(-P // G)
    for g in range(G):
        r0 = min(P, g * rpc)
        w = min(P, r0 + rpc) - r0
        if w == 0:
            continue
        L = 1
        while 2 * L * C * w <= REDUCE_THREADS and 2 * L <= G:
            L *= 2
        per = G // L
        rows = slice(r0, r0 + w)
        tot = None
        for q in range(L):
            acc = None
            for r in range(q * per, (q + 1) * per):
                acc = parts[r][..., rows] if acc is None else (
                    acc + parts[r][..., rows])
            tot = acc if tot is None else tot + acc
        y[..., rows] = tot + d[:, None, rows] * x[..., rows]
    return y


@pytest.mark.parametrize('C', [1, 2, 3, 4, 8])
@pytest.mark.parametrize('G', [1, 8, 64])
@pytest.mark.parametrize('u_dtype', ['f32', 'bf16'])
def test_group_matvec_f64_matches_plain_and_pallas(C, G, u_dtype):
    """At f64 (U's values from f32 or bf16) the group route's order equals
    the plain version to the route-equality tolerances, and the Pallas
    kernel (interpret mode), which accumulates in f32 whatever its inputs
    (preferred_element_type), within the f32 band (its own test,
    tests/test_pallas.py, allows 1e-3)."""
    rng = np.random.default_rng(100 * C + G + len(u_dtype))
    B, P, R = 3, 64, GROUP_RANK[G]
    u = rng.standard_normal((B, P, R)) / np.sqrt(P)
    u = np.asarray(jnp.asarray(u, dtype=jnp.float32 if u_dtype == 'f32'
                               else jnp.bfloat16), dtype=np.float64)
    s = rng.uniform(0.1, 2.0, (B, R))
    d = rng.uniform(0.0, 1.0, (B, P))
    x = rng.standard_normal((B, C, P))
    t = [torch.as_tensor(a) for a in (u, s, d, x)]
    got = t2n(_group_matvec(*t, G))
    plain = t2n(tbm.bucket_matvec_multi_plain(*t))
    pallas = np.asarray(jbm.bucket_matvec_multi(
        *[jnp.asarray(a) for a in (u, s, d, x)], interpret=True))
    np.testing.assert_allclose(got, plain, rtol=1e-9,
                               atol=1e-12 * np.abs(plain).max())
    assert _scaled(got, pallas) <= BAND_F32


@pytest.mark.parametrize('u_dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('C', [1, 2, 3, 4, 8])
@pytest.mark.parametrize('G', [1, 8, 64])
def test_group_matvec_arithmetic(u_dtype, C, G):
    """In U's type: within the kernel's bands of the plain version and of
    the Pallas kernel; with bf16 U also closer to the plain version than a
    product that skips rounding x or t."""
    dt = jnp.float32 if u_dtype == 'f32' else jnp.bfloat16
    band = BAND_F32 if u_dtype == 'f32' else BAND_BF16
    j, t = _matvec_inputs(dt, C, seed=30 * C + G, R=GROUP_RANK[G])
    got = t2n(_group_matvec(*t, G))
    plain = t2n(tbm.bucket_matvec_multi_plain(*t))
    pallas = np.asarray(jbm.bucket_matvec_multi(*j, interpret=True))
    assert got.shape == plain.shape == pallas.shape
    err = _scaled(got, plain)
    assert err <= band
    assert _scaled(got, pallas) <= band
    if u_dtype == 'bf16':
        u, s, d, x = t
        for skipped in (x.to(torch.bfloat16).float(), None):
            xr = x if skipped is None else skipped
            tt = torch.einsum('bpr,bcp->bcr', u.float(), xr) * s[:, None, :]
            if skipped is None:
                tt = tt.to(torch.bfloat16).float()
            half = torch.einsum('bpr,bcr->bcp', u.float(), tt) + d[:, None] * x
            assert err < _scaled(t2n(half), plain)


# ---------------------------------------------------------------------------
# the one-pass epoch prologue
# ---------------------------------------------------------------------------

RESCALE_NATS = 8.0     # csrc/compact_obj.cuh kRescale
FOLD = 128             # csrc/compact_obj.cuh kFold


def _g_term(dev):
    """The KL term of each (component, SNP) beside its log weight."""
    log_hd = dev['sel'] + 0.5 * dev['ldp']
    return ((0.5 * dev['quadform']
             + 0.5 * (dev['ldp'] + dev['logdet'] + dev['matches']))
            - log_hd)


def _online(y, diag, g_term, z, annotations, num_annotations, fold=FOLD):
    """Online softmax accumulators over K (compact_obj.cuh struct
    Online), vectorized over SNPs, with no clamp: each run of `fold`
    components is summed apart and then added into the totals (the
    kernel also starts a run at each component tile, which only shortens
    runs). Returns (post_means, post_vars, KL)."""
    P = len(y)
    K, I = z.shape
    zeros = z.new_zeros(I)
    m = torch.full_like(zeros, -math.inf)
    # [s0, sz, sg, sy..., ssec...]: the totals and the current run
    tot = [zeros] * (3 + 2 * P)
    run = [zeros] * (3 + 2 * P)
    for k in range(K):
        zk = z[k]
        move = zk > m + RESCALE_NATS
        alpha = torch.where(move, torch.exp(m - zk), torch.ones_like(zk))
        for acc in (tot, run):
            acc[1] = torch.where(move, torch.where(
                acc[0] > 0, (acc[1] + (m - zk) * acc[0]) * alpha, zeros),
                acc[1])
            for j in [0] + list(range(2, 3 + 2 * P)):
                acc[j] = acc[j] * alpha
        m = torch.where(move, zk, m)
        dz = zk - m
        w = torch.exp(dz)
        terms = ([w, w * dz, w * g_term[k]]
                 + [w * y[p][k] for p in range(P)]
                 + [w * (diag[p][k] + y[p][k] * y[p][k]) for p in range(P)])
        run = [a + t for a, t in zip(run, terms)]
        if (k + 1) % fold == 0 or k == K - 1:
            tot = [a + r for a, r in zip(tot, run)]
            run = [zeros] * len(run)
    s0, sz, sg = tot[:3]
    sy, ssec = tot[3:3 + P], tot[3 + P:]
    inv = 1.0 / s0
    pm = torch.stack([v * inv for v in sy])
    pv = torch.stack([ssec[p] * inv - pm[p] * pm[p] for p in range(P)])
    kl_i = (sz + sg) * inv - torch.log(s0)
    kl = torch.sum(kl_i * (annotations < num_annotations).to(kl_i.dtype))
    return pm, pv, kl


def _epoch_logits(coeffs, scores_t, annotations, sld, nat_u, hist_v,
                  inv_scales, hist_c, num_live):
    """The port's per-component epoch algebra and the logits z [K, I],
    quad = y (prec + diag(dt)) y."""
    P = nat_u.shape[0]
    dev = tco._derive_plain_epochs(coeffs, scores_t, annotations, sld, nat_u,
                                   hist_v, inv_scales, hist_c,
                                   epsilon(nat_u.dtype), num_live)
    c = tco._coeff_cols(coeffs)
    dt = [sld[p:p + 1] * inv_scales[0, p] for p in range(P)]
    y = dev['y']
    quad = tco._dot([tco._dot(row, y) for row in tco._precision(P, c, dt)],
                    y)
    return dev, 0.5 * (quad - dev['logdet']) + dev['sel']


def _one_pass_epochs(coeffs, scores_t, annotations, sld, nat_u, hist_v,
                     inv_scales, hist_c, *, num_annotations, num_live):
    """What the one-pass epoch prologue computes (compact_obj.cuh,
    derive_epochs and struct Online). Returns (post_means, post_vars, KL)
    and the logits z [K, I]."""
    dev, z = _epoch_logits(coeffs, scores_t, annotations, sld, nat_u,
                           hist_v, inv_scales, hist_c, num_live)
    return _online(dev['y'], dev['diag'], _g_term(dev), z, annotations,
                   num_annotations), z


def _compact_logits(coeffs, scores_t, annotations, dterm, nat_mu):
    """The port's [P, I] or kdim per-component algebra and the logits
    z [K, I]: y = sigma n, quad = y . n with the shared [P, I] or the
    per-component [K, P, I] natural mean n."""
    P = nat_mu.shape[-2]
    dev = tco._derive_plain(coeffs, scores_t, annotations, dterm, nat_mu,
                            epsilon(nat_mu.dtype))
    n = ([nat_mu[:, p] for p in range(P)] if nat_mu.dim() == 3
         else [nat_mu[p:p + 1] for p in range(P)])
    return dev, 0.5 * (tco._dot(dev['y'], n) - dev['logdet']) + dev['sel']


def _one_pass(coeffs, scores_t, annotations, dterm, nat_mu, *,
              num_annotations):
    """What the one-pass [P, I] and kdim prologue computes (compact_obj.cuh,
    derive_once and struct Online). Returns (post_means, post_vars, KL) and
    the logits z [K, I]."""
    dev, z = _compact_logits(coeffs, scores_t, annotations, dterm, nat_mu)
    return _online(dev['y'], dev['diag'], _g_term(dev), z, annotations,
                   num_annotations), z


def _epoch_inputs(P, kind, seed, K=24, I=300, A=3, B=4, live=2):
    """Epoch-kernel operands (numpy f64): `live` filled history slots of
    B, every 11th SNP a pad slot. kind:

    * 'ordinary': variances 1e-6..1e-2, small natural means;
    * 'clamp': variances 1e-8..1, natural means at z-scores up to 1.5
      (~100x the ordinary ones), and hyper-deltas of e^-600..e^-80 for
      ~80% of the components (what a converged fit leaves on the
      components it does not use): most components of most SNPs sit
      beyond the clamp at f32 and at f64;
    * 'large_means': variances 1e-8..1 and |z-scores| 20..40, where the
      logits spread over hundreds of nats. At f32 post_vars = E[y^2] -
      pm^2 then cancels in both versions alike, so only f64 uses it.
    """
    rng = np.random.default_rng(seed)
    lo, hi = (1e-6, 1e-2) if kind == 'ordinary' else (1e-8, 1.0)
    scales = np.exp(np.linspace(np.log(lo), np.log(hi), K))
    a = rng.standard_normal((K, P, P))
    corr = a @ np.swapaxes(a, 1, 2) + P * np.eye(P)
    dd = 1 / np.sqrt(np.einsum('kpp->kp', corr))
    covs = scales[:, None, None] * corr * dd[:, :, None] * dd[:, None, :]
    prec = np.linalg.inv(covs)
    log_det = np.linalg.slogdet(covs)[1]
    log_hd = np.log(rng.dirichlet(np.ones(K), A))
    if kind == 'clamp':
        unused = rng.random((A, K)) < 0.8
        log_hd[unused] = rng.uniform(-600, -80, unused.sum())
    ann = rng.integers(0, A, I).astype(np.int32)
    ann[::11] = A
    sld = 1.0 / rng.uniform(0.01, 0.05, (P, I)) ** 2
    if kind == 'ordinary':
        u = rng.standard_normal((P, I)) * 0.5
        hist_scale = 0.5
    else:
        if kind == 'clamp':
            zs = rng.uniform(-1.5, 1.5, (P, I))
        else:
            zs = rng.uniform(20, 40, (P, I)) * rng.choice([-1, 1], (P, I))
        u = zs * np.sqrt(sld)
        hist_scale = 0.5 * np.sqrt(sld)
    hist = np.zeros((B, P, I))
    hist[:live] = rng.standard_normal((live, P, I)) * hist_scale
    inv_scales = np.ones((B + 1, P))
    inv_scales[:live + 1] = 1 / rng.uniform(0.7, 1.4, (live + 1, P))
    hist_c = np.zeros(B)
    hist_c[:live] = rng.uniform(0.1, 1.0, live)
    coeffs = np.concatenate(
        [np.stack([prec[:, p, q] for p in range(P) for q in range(p, P)], 1),
         log_det[:, None]], axis=1)
    scores_t = (log_hd - 0.5 * log_det).T
    return [coeffs, scores_t, ann, sld, u, hist, inv_scales, hist_c], A, live


def _as_torch(args, dtype):
    return [tensor_from_numpy(a) if a.dtype == np.int32
            else torch.as_tensor(a, dtype=dtype) for a in args]


@pytest.mark.parametrize('P', [1, 2, 3])
@pytest.mark.parametrize('kind', ['ordinary', 'clamp', 'large_means'])
def test_one_pass_epochs_f64_matches_plain_and_pallas(P, kind):
    """At f64 the one-pass form equals the clamped two-pass plain version
    and the Pallas kernel to the route-equality tolerances of
    tests/test_torch_epoch.py: the clamp moves no sum by a visible amount."""
    args, A, live = _epoch_inputs(P, kind, seed=P + 10 * len(kind))
    t = _as_torch(args, torch.float64)
    kw = dict(num_annotations=A, num_live=live)
    (pm, pv, kl), z = _one_pass_epochs(*t, **kw)
    want = tco.prologue_epochs_plain(*t, **kw)
    jpm, jpv, jkl = jco.prologue_epochs(*[jnp.asarray(a) for a in args],
                                        num_annotations=A, interpret=True)
    for ref_pm, ref_pv, ref_kl in (want, (jpm, jpv, jkl)):
        for got, ref in ((pm, ref_pm), (pv, ref_pv)):
            ref = np.asarray(ref)
            np.testing.assert_allclose(t2n(got), ref, rtol=1e-9,
                                       atol=1e-9 * np.abs(ref).max())
        assert np.isclose(float(kl), float(ref_kl), rtol=1e-9)
    below = t2n(z - z.max(dim=0).values) < math.log(epsilon(torch.float64))
    if kind == 'ordinary':
        assert not below.any()
    else:
        assert below.mean() > 0.5       # the clamp is in play at f64 too


@pytest.mark.parametrize('P', [1, 2, 3])
@pytest.mark.parametrize('kind', ['ordinary', 'clamp'])
def test_one_pass_epochs_f32_within_bands(P, kind):
    """At f32 (eps = 1e-30) the one-pass form sits within chip_smoke.py's
    bands of the plain version on the same inputs."""
    args, A, live = _epoch_inputs(P, kind, seed=P + 20 * len(kind))
    t = _as_torch(args, torch.float32)
    kw = dict(num_annotations=A, num_live=live)
    (pm, pv, kl), z = _one_pass_epochs(*t, **kw)
    rpm, rpv, rkl = tco.prologue_epochs_plain(*t, **kw)
    for got, ref in ((pm, rpm), (pv, rpv)):
        assert np.all(np.isfinite(t2n(got)))
        assert _scaled(t2n(got).astype(np.float64),
                       t2n(ref).astype(np.float64)) <= BAND_F32
    assert abs(float(kl) - float(rkl)) <= BAND_KL * abs(float(rkl))
    below = t2n(z - z.max(dim=0).values) < math.log(epsilon(torch.float32))
    assert (below.mean() > 0.5) == (kind == 'clamp')


# ---------------------------------------------------------------------------
# the one-pass [P, I] and kdim prologue
# ---------------------------------------------------------------------------

def _compact_inputs(P, kind, seed, K, kdim):
    """[P, I] or kdim prologue operands (numpy f64) from _epoch_inputs:
    dterm the scaled LD diagonal, the natural mean its accumulator, and in
    the kdim form one perturbed copy of it per component."""
    args, A, _ = _epoch_inputs(P, kind, seed, K=K, live=0)
    coeffs, scores_t, ann, dterm, nat = args[:5]
    if kdim:
        rng = np.random.default_rng(seed + 1)
        scale = 0.1 if kind == 'ordinary' else 0.2 * np.sqrt(dterm)
        nat = nat[None] + rng.standard_normal((K, P, nat.shape[1])) * scale
    return [coeffs, scores_t, ann, dterm, nat], A


@pytest.mark.parametrize('P', [1, 2, 3])
@pytest.mark.parametrize('kind', ['ordinary', 'clamp', 'large_means'])
@pytest.mark.parametrize('kdim', [False, True])
def test_one_pass_prologue_f64_matches_plain_and_pallas(P, kind, kdim):
    """The one-pass [P, I] and kdim prologue at f64 equals the clamped
    two-pass plain version and the Pallas kernel to the route-equality
    tolerances of tests/test_torch_epoch.py."""
    args, A = _compact_inputs(P, kind, 3 * P + len(kind), 24, kdim)
    t = _as_torch(args, torch.float64)
    (pm, pv, kl), z = _one_pass(*t, num_annotations=A)
    want = tco.prologue_plain(*t, num_annotations=A)
    pallas = jco.prologue(*[jnp.asarray(a) for a in args],
                          num_annotations=A, interpret=True)
    for ref_pm, ref_pv, ref_kl in (want, pallas):
        for got, ref in ((pm, ref_pm), (pv, ref_pv)):
            ref = np.asarray(ref)
            np.testing.assert_allclose(t2n(got), ref, rtol=1e-9,
                                       atol=1e-9 * np.abs(ref).max())
        assert np.isclose(float(kl), float(ref_kl), rtol=1e-9)
    below = t2n(z - z.max(dim=0).values) < math.log(epsilon(torch.float64))
    assert below.any() == (kind != 'ordinary')


@pytest.mark.parametrize('P', [1, 2, 3])
@pytest.mark.parametrize('kind', ['ordinary', 'clamp'])
@pytest.mark.parametrize('kdim', [False, True])
@pytest.mark.parametrize('K', [24, 2500])
def test_one_pass_prologue_f32_within_bands(P, kind, kdim, K):
    """At f32 the one-pass [P, I] and kdim prologue sits within
    chip_smoke.py's bands of the plain version, also over more
    components than the kernel's shared-memory tile holds (2500)."""
    args, A = _compact_inputs(P, kind, 5 * P + len(kind) + K, K, kdim)
    t = _as_torch(args, torch.float32)
    (pm, pv, kl), z = _one_pass(*t, num_annotations=A)
    rpm, rpv, rkl = tco.prologue_plain(*t, num_annotations=A)
    for got, ref in ((pm, rpm), (pv, rpv)):
        assert np.all(np.isfinite(t2n(got)))
        assert _scaled(t2n(got).astype(np.float64),
                       t2n(ref).astype(np.float64)) <= BAND_F32
    assert abs(float(kl) - float(rkl)) <= BAND_KL * abs(float(rkl))
    below = t2n(z - z.max(dim=0).values) < math.log(epsilon(torch.float32))
    assert (below.mean() > 0.5) == (kind == 'clamp')


def test_one_pass_prologue_runs_keep_f32_at_large_k():
    """At K = 42,999 (the -K 12 grid at 3 cohorts) one f32 run over all
    of K drifts to ~6e-6 of the posterior means' scale; runs of FOLD
    components added into totals stay within 1e-6 of the f64 plain
    version, as the plain f32 version does (~2e-7)."""
    from chip_smoke import compact_inputs, max_err
    K, I = 42_999, 96
    t = dict(zip(('coeffs', 'scores_t', 'annotations', 'dterm', 'nat_mu'),
                 compact_inputs('cpu', 3, K, I, 1, seed=K)))
    want = tco.prologue_plain(**{k: v.double() if v.is_floating_point()
                                 else v for k, v in t.items()},
                              num_annotations=1)
    dev, z = _compact_logits(*t.values())
    errs = {}
    for fold in (FOLD, K):
        pm, pv, _ = _online(dev['y'], dev['diag'], _g_term(dev), z,
                            t['annotations'], 1, fold=fold)
        errs[fold] = max(max_err(pm, want[0])[1], max_err(pv, want[1])[1])
    assert errs[FOLD] <= 1e-6 < errs[K], errs


# ---------------------------------------------------------------------------
# the z-only sums (all three forms)
# ---------------------------------------------------------------------------

def _sorted_sums(z, annotations, num_annotations, nblocks, kg=None):
    """What the sums compute from the logits z [K, I] (compact_obj.cuh,
    SUMS), in the kernel's order: pass 1's online max and normalizer over
    K; the clamped weights max(exp(z - m) / s, eps); for each group of kg
    components (all K by default), per SNP tile, each annotation's weights
    added in SNP order (the sorted segment) into the partial of CTA (tile
    mod nblocks); then reduce_rows: warp w adds the partials of CTAs w,
    w + 8, ... in f64, and the warps' sums are added in warp order.
    Returns [A, K]."""
    A = num_annotations
    K, I = z.shape
    kg = K if kg is None else kg
    m = torch.full_like(z[0], -math.inf)
    s = torch.zeros_like(z[0])
    for k in range(K):
        move = z[k] > m
        s = torch.where(move, s * torch.exp(m - z[k]) + 1.0,
                        s + torch.exp(z[k] - m))
        m = torch.where(move, z[k], m)
    w = torch.clamp(torch.exp(z - m) * (1.0 / s), min=epsilon(z.dtype))
    part = z.new_zeros((nblocks, K, A))
    for g0 in range(0, K, kg):
        grp = slice(g0, min(K, g0 + kg))
        for t0 in range(0, I, THREADS):
            ann = annotations[t0:t0 + THREADS]
            for aa in range(A):
                v = z.new_zeros(grp.stop - g0)
                for i in torch.nonzero(ann == aa).flatten().tolist():
                    v = v + w[grp, t0 + i]
                part[(t0 // THREADS) % nblocks, grp, aa] += v
    rows = part.reshape(nblocks, K * A).double()
    warp_sums = []
    for wp in range(WARPS):
        acc = torch.zeros(K * A, dtype=torch.float64)
        for b in range(wp, nblocks, WARPS):
            acc = acc + rows[b]
        warp_sums.append(acc)
    tot = warp_sums[0]
    for acc in warp_sums[1:]:
        tot = tot + acc
    return tot.to(z.dtype).reshape(K, A).T


def _z_only_sums(coeffs, scores_t, annotations, sld, nat_u, hist_v,
                 inv_scales, hist_c, *, num_annotations, num_live, nblocks,
                 kg=None):
    """The epoch sums (z_epochs) in the kernel's order: [A, K]."""
    _, z = _epoch_logits(coeffs, scores_t, annotations, sld, nat_u, hist_v,
                         inv_scales, hist_c, num_live)
    return _sorted_sums(z, annotations, num_annotations, nblocks, kg)


def _z_only_compact_sums(coeffs, scores_t, annotations, dterm, nat_mu, *,
                         num_annotations, nblocks, kg=None):
    """The [P, I] and kdim sums (z_form) in the kernel's order: [A, K]."""
    _, z = _compact_logits(coeffs, scores_t, annotations, dterm, nat_mu)
    return _sorted_sums(z, annotations, num_annotations, nblocks, kg)


@pytest.mark.parametrize('P', [1, 2, 3])
@pytest.mark.parametrize('live', [0, 1, 2, 3])
@pytest.mark.parametrize('kind', ['ordinary', 'clamp'])
def test_z_only_sums_f64_matches_plain_and_pallas(P, live, kind):
    """At f64 the z-only epoch sums in the kernel's reduction order equal
    the plain version and the Pallas kernel to the route-equality
    tolerances; every 11th SNP is a pad slot. One CTA (all SNP tiles in
    its grid stride) or two."""
    args, A, _ = _epoch_inputs(P, kind, seed=7 * P + live + len(kind),
                               live=live)
    t = _as_torch(args, torch.float64)
    got = _z_only_sums(*t, num_annotations=A, num_live=live,
                       nblocks=1 + live % 2)
    plain = tco.delta_sums_epochs_plain(*t, num_annotations=A,
                                        num_live=live)
    pallas = jco.delta_sums_epochs(*[jnp.asarray(a) for a in args],
                                   num_annotations=A, interpret=True)
    for ref in (plain, pallas):
        ref = np.asarray(ref)
        assert got.shape == ref.shape == (A, args[1].shape[0])
        np.testing.assert_allclose(t2n(got), ref, rtol=1e-9,
                                   atol=1e-9 * np.abs(ref).max())


@pytest.mark.parametrize('P', [1, 2, 3])
@pytest.mark.parametrize('live', [1, 3])
@pytest.mark.parametrize('kind', ['ordinary', 'clamp'])
def test_z_only_sums_f32_within_band(P, live, kind):
    """At f32 the z-only epoch sums sit within chip_smoke.py's band of
    the plain version on the same inputs."""
    args, A, _ = _epoch_inputs(P, kind, seed=9 * P + live + len(kind),
                               live=live)
    t = _as_torch(args, torch.float32)
    got = _z_only_sums(*t, num_annotations=A, num_live=live, nblocks=2)
    ref = tco.delta_sums_epochs_plain(*t, num_annotations=A, num_live=live)
    assert np.all(np.isfinite(t2n(got)))
    assert _scaled(t2n(got).astype(np.float64),
                   t2n(ref).astype(np.float64)) <= BAND_F32


@pytest.mark.parametrize('P', [1, 2, 3])
@pytest.mark.parametrize('kind', ['ordinary', 'clamp'])
@pytest.mark.parametrize('kdim', [False, True])
def test_z_only_compact_sums_f64_matches_plain_and_pallas(P, kind, kdim):
    """At f64 the z-only [P, I] and kdim sums in the kernel's reduction
    order (pad SNPs every 11th, one CTA or two) equal the plain version
    and the Pallas kernel (`delta_sums`, interpret mode) to the
    route-equality tolerances."""
    args, A = _compact_inputs(P, kind, 11 * P + len(kind) + kdim, 24, kdim)
    t = _as_torch(args, torch.float64)
    got = _z_only_compact_sums(*t, num_annotations=A, nblocks=1 + kdim)
    plain = tco.delta_sums_plain(*t, num_annotations=A)
    pallas = jco.delta_sums(*[jnp.asarray(a) for a in args],
                            num_annotations=A, interpret=True)
    for ref in (plain, pallas):
        ref = np.asarray(ref)
        assert got.shape == ref.shape == (A, 24)
        np.testing.assert_allclose(t2n(got), ref, rtol=1e-9,
                                   atol=1e-9 * np.abs(ref).max())


@pytest.mark.parametrize('P', [1, 2, 3])
@pytest.mark.parametrize('kind', ['ordinary', 'clamp'])
@pytest.mark.parametrize('kdim', [False, True])
def test_z_only_compact_sums_f32_within_band(P, kind, kdim):
    """At f32 the z-only [P, I] and kdim sums sit within chip_smoke.py's
    band of the plain version on the same inputs."""
    args, A = _compact_inputs(P, kind, 13 * P + len(kind) + kdim, 24, kdim)
    t = _as_torch(args, torch.float32)
    got = _z_only_compact_sums(*t, num_annotations=A, nblocks=2)
    ref = tco.delta_sums_plain(*t, num_annotations=A)
    assert np.all(np.isfinite(t2n(got)))
    assert _scaled(t2n(got).astype(np.float64),
                   t2n(ref).astype(np.float64)) <= BAND_F32


def _sums_smem(kt, kg, A, ncol, table):
    """Bytes of shared memory of a sums launch (csrc/compact_obj.cuh
    extra_floats, compact launch)."""
    return 4 * (kt * (ncol + A) + kg * A + tco._CHUNK * (THREADS + 1)
                + (A + 1) * WARPS + A + 2 + table)


@pytest.mark.parametrize('K,A,tiles', [(582, 4, 1), (600, 12, 1),
                                       (3000, 12, 3)])
def test_epoch_sums_launch_shape(K, A, tiles):
    """The epoch sums hold all of K = 582 in one component tile beside
    their [K, A] partial, in at most 56 KB of shared memory (four CTAs of
    256 threads per SM), and split larger K over tiles beside the whole
    [K, A] partial within the card's per-block limit."""
    P, ncol = 2, 4
    table = 2 * P + 1                                  # 1 live epoch
    kt, kg, nblocks = tco._launch_shape(1_000_000, K, A, ncol, sums=True,
                                        table_floats=table)
    assert -(-K // kt) == tiles and kg == K
    assert nblocks == 1024
    smem = _sums_smem(kt, kg, A, ncol, table)
    assert smem <= tco._SMEM_MAX
    if (K, A) == (582, 4):
        assert smem <= 56 * 1024


@pytest.mark.parametrize('K,A', [(14_000, 4), (20_000, 8)])
@pytest.mark.parametrize('form', ['shared', 'kdim', 'epochs'])
def test_sums_any_k_times_a(K, A, form):
    """Past one group's partial in shared memory (K·A = 56,000 and
    160,000 floats) the sums take K in groups of kg components, a multiple
    of the tile, within the card's per-block limit, and the grouped order
    still equals the plain version at f64 (130 SNPs, pad SNPs, 1 live
    epoch for the epoch form)."""
    P, ncol = 2, 4
    live = 1 if form == 'epochs' else 0
    table = (live + 1) * P + live if form == 'epochs' else 0
    kt, kg, _ = tco._launch_shape(1_000_000, K, A, ncol, sums=True,
                                  table_floats=table)
    assert 1 <= kt <= kg < K and kg % kt == 0
    assert _sums_smem(kt, kg, A, ncol, table) <= tco._SMEM_MAX
    args, _, _ = _epoch_inputs(P, 'ordinary', seed=K + A, K=K, I=130, A=A,
                               live=live)
    if form == 'epochs':
        t = _as_torch(args, torch.float64)
        got = _z_only_sums(*t, num_annotations=A, num_live=live, nblocks=1,
                           kg=kg)
        ref = tco.delta_sums_epochs_plain(*t, num_annotations=A,
                                          num_live=live)
    else:
        coeffs, scores_t, ann, dterm, nat = args[:5]
        if form == 'kdim':
            rng = np.random.default_rng(K)
            nat = nat[None] + rng.standard_normal((K, P, 130)) * 0.1
        t = _as_torch([coeffs, scores_t, ann, dterm, nat], torch.float64)
        got = _z_only_compact_sums(*t, num_annotations=A, nblocks=1, kg=kg)
        ref = tco.delta_sums_plain(*t, num_annotations=A)
    assert got.shape == ref.shape == (A, K)
    np.testing.assert_allclose(t2n(got), t2n(ref), rtol=1e-9,
                               atol=1e-9 * float(ref.abs().max()))
