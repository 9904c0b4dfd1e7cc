"""Sharded fits of vilma_tpu_torch on the CPU at float64, against the
port's unsharded fit and against vilma_tpu's sharded one on the
simulated 8-device mesh (tests/conftest.py): the shard-local layout
planner, pack(n_shards) and the per-shard LD ops, outer steps of every
state form (shared, kdim, epoch history, P = 4 materialized), host
syncs per step, `fit --mesh snp=8`, checkpoints across the two layouts,
the global-gather layout's CLI fit on schemas that disagree on the
order of shared variants, what component sharding refuses, and the
launchers' device guard."""
import dataclasses
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from vilma_tpu import frontend as jfrontend
from vilma_tpu.inference import engine as jengine
from vilma_tpu.models import sigma as jsigma
from vilma_tpu.ops import blocks as jblocks
from vilma_tpu.parallel import alignment as jalign
from vilma_tpu.parallel import mesh as jmesh
from vilma_tpu.utils import synthetic
from vilma_tpu_torch import frontend as tfrontend
from vilma_tpu_torch.inference import engine as tengine
from vilma_tpu_torch.ops import blocks as tblocks
from vilma_tpu_torch.ops import lowrank
from vilma_tpu_torch.ops.cuda import block_matvec, build, compact_obj
from vilma_tpu_torch.parallel import alignment as talign
from vilma_tpu_torch.parallel import mesh as tmesh

from tests.test_torch_cli import _argv, _read_tsv, _write_case
from tests.torch_parity import state_to_torch, t2n

# tests/test_sharding.py's tolerances
PM_RTOL, PM_ATOL, ELBO_RTOL = 1e-10, 1e-12, 1e-8


def _factor(rng, k):
    a = rng.standard_normal((k, k))
    return lowrank.factor_block(X=a @ a.T / k, t=1.0, check_symmetric=False)


def _layout_case(name):
    """(n, per cohort: (factors, block indices)) of tests/test_alignment.py's
    inputs: contiguous blocks with different boundaries, blocks with
    holes, interleaved blocks, a shuffled two-cohort extract."""
    rng = np.random.default_rng({'contiguous': 0, 'holes': 5,
                                 'interleaved': 6, 'shuffled': 7}[name])
    if name == 'contiguous':
        n, cohorts = 320, [[100, 150, 50], [60, 90, 150]]
        order = np.arange(n)
    elif name == 'shuffled':
        n, cohorts = 512, [[100, 150, 50, 100, 112], [60, 90, 150, 120, 92]]
        order = rng.permutation(n)
    if name in ('contiguous', 'shuffled'):
        out = []
        for sizes in cohorts:
            f, ix, start = [], [], 0
            for sz in sizes:
                f.append(_factor(rng, sz))
                ix.append(order[np.arange(start, start + sz)])
                start += sz
            out.append((f, ix))
        return n, out
    if name == 'holes':
        def holey(start, window, keep):
            ix = np.sort(rng.choice(np.arange(start, start + window),
                                    size=keep, replace=False))
            return _factor(rng, keep), ix
        (f1, i1), (f2, i2) = holey(0, 120, 97), holey(120, 130, 110)
        f3, i3 = holey(0, 250, 250)
        return 260, [([f1, f2], [i1, i2]), ([f3], [i3])]
    ix1 = np.array([0, 2, 4, 6, 8, 10])
    ix2 = np.array([1, 3, 5, 7, 9, 11])
    return 40, [([_factor(rng, 6), _factor(rng, 6)], [ix1, ix2])]


def _scaled_err(got, want):
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-300))


def _gather(parts):
    return torch.cat([p.cpu() for p in parts], dim=-1).numpy()


@pytest.mark.parametrize('n_shards', [1, 4])
@pytest.mark.parametrize('case', ['contiguous', 'holes', 'interleaved',
                                  'shuffled'])
def test_layout_matches_jax(case, n_shards):
    """The planner gives vilma_tpu's layout_map, L and ok on
    tests/test_alignment.py's inputs; the port's relayouted matrices
    (sharded when n_shards > 1) are the JAX package's relayouted
    operators, and the original ones through the layout map."""
    n, cohorts = _layout_case(case)
    tlds = [tblocks.pack(f, ix, n) for f, ix in cohorts]
    jlds = [jblocks.pack(f, ix, n) for f, ix in cohorts]
    tmap, tL, tok = talign.compute_layout(tlds, n, n_shards=n_shards)
    jmap, jL, jok = jalign.compute_layout(jlds, n, n_shards=n_shards)
    assert tok and jok and tL == jL
    np.testing.assert_array_equal(tmap, np.asarray(jmap))
    rng = np.random.default_rng(1)
    v = rng.standard_normal(n)
    vl = talign.relayout_rows(v, tmap, tL)
    np.testing.assert_array_equal(vl, jalign.relayout_rows(v, jmap, jL))
    for tld, jld in zip(tlds, jlds):
        tl = talign.relayout_ld(tld, tmap, tL, n_shards=n_shards)
        jl = jalign.relayout_ld(jld, jmap, jL)
        assert tl.shard_count == n_shards
        want = np.asarray(jblocks.dot(jl, vl))
        x = torch.as_tensor(vl)
        if n_shards > 1:
            got = _gather(tblocks.dot(tl, tblocks.split(tl, x)))
            diag = _gather(tblocks.diag(tl))
        else:
            got = tblocks.dot(tl, x).numpy()
            diag = tblocks.diag(tl).numpy()
        assert _scaled_err(got, want) <= 1e-12
        assert _scaled_err(got[tmap],
                           tblocks.dot(tld, torch.as_tensor(v)).numpy()) \
            <= 1e-12
        assert _scaled_err(diag, np.asarray(jblocks.diag(jl))) <= 1e-12
        assert tl.get_rank() == tld.get_rank() == jl.get_rank()


def test_topological_merge_and_rows_match_jax():
    """Conflicting chains are refused by both packages; consistent ones
    merge to the same virtual order; relayout_annotations and the
    metadata intervals agree."""
    bad = [np.array([0, 1, 2]), np.array([2, 1, 3])]
    assert talign.topological_merge(bad, 4) is None
    assert jalign.topological_merge(bad, 4) is None
    good = [np.array([0, 3, 2]), np.array([3, 2, 4]), np.array([6, 5])]
    np.testing.assert_array_equal(talign.topological_merge(good, 7),
                                  jalign.topological_merge(good, 7))
    lmap, L, ok = talign.layout_via_virtual_order(
        [[np.array([0, 3]), np.array([2])], [np.array([3, 2, 4])]], 7, 2)
    jmap, jL, jok = jalign.layout_via_virtual_order(
        [[np.array([0, 3]), np.array([2])], [np.array([3, 2, 4])]], 7, 2)
    assert ok and jok and L == jL
    np.testing.assert_array_equal(lmap, jmap)
    one_hot = np.eye(3)[np.random.default_rng(0).integers(0, 3, 7)]
    np.testing.assert_array_equal(
        talign.relayout_annotations(one_hot, lmap, L),
        jalign.relayout_annotations(one_hot, jmap, jL))
    entries = [{'idx': np.array([4, 5, 6])}, {'idx': np.array([0, 2])},
               {'idx': np.array([], dtype=int)}]
    assert talign.entry_intervals(entries) == jalign.entry_intervals(
        entries) == [(0, 3), (4, 7)]
    entries.append({'idx': np.array([3, 1])})
    assert talign.entry_intervals(entries) is None
    assert jalign.entry_intervals(entries) is None


def _sharded_matrix(seed=3, n_shards=8):
    """An unsharded PackedLD of irregular blocks (a hole, an uncovered
    run), relayouted unsharded and in n_shards spans."""
    rng = np.random.default_rng(seed)
    n = 530
    factors, indices = [], []
    for a, b in [(0, 96), (96, 256), (256, 356), (376, 530)]:
        keep = np.setdiff1d(np.arange(a, b), [130])
        factors.append(_factor(rng, keep.size))
        indices.append(keep)
    ld = tblocks.pack(factors, indices, n)
    lmap, L, ok = talign.compute_layout([ld], n, n_shards=n_shards)
    assert ok
    return (talign.relayout_ld(ld, lmap, L),
            talign.relayout_ld(ld, lmap, L, n_shards=n_shards), lmap, L)


@pytest.mark.parametrize('op', ['dot', 'dot_multi_3', 'dot_multi_9',
                                'diag', 'inverse_dot', 'ridge_inverse_dot'])
def test_sharded_ops_match_unsharded(op):
    """pack(n_shards=8)'s per-shard ops equal the unsharded matrix's
    within 1e-14 of scale (8 shards, some without a block)."""
    plain, sharded, _, L = _sharded_matrix()
    assert sharded.shard_count == 8 and len(sharded.shards) == 8
    assert sharded.rank == plain.rank and sharded.n == plain.n == L
    rng = np.random.default_rng(2)
    if op.startswith('dot_multi'):
        x = torch.as_tensor(rng.standard_normal((int(op[-1]), L)))
    else:
        x = torch.as_tensor(rng.standard_normal(L))
    parts = tblocks.split(sharded, x)
    if op == 'diag':
        got, want = tblocks.diag(sharded), tblocks.diag(plain)
    elif op == 'ridge_inverse_dot':
        reg = torch.as_tensor(rng.uniform(0.5, 2.0, L))
        got = tblocks.ridge_inverse_dot(sharded, parts,
                                        tblocks.split(sharded, reg))
        want = tblocks.ridge_inverse_dot(plain, x, reg)
    else:
        fn = getattr(tblocks, op.rstrip('_39'))
        got, want = fn(sharded, parts), fn(plain, x)
    assert _scaled_err(_gather(got), want.numpy()) <= 1e-14


def test_sharded_dot_matches_jax_dot_sharded():
    """The per-shard dot and dot_multi equal vilma_tpu's collective-free
    shard_map matvecs (_dot_sharded, _dot_multi_sharded) on the 8-device
    mesh."""
    rng = np.random.default_rng(1)
    n = 1024
    factors, indices = [], []
    for a in range(0, n, 128):
        factors.append(_factor(rng, 128))
        indices.append(np.arange(a, a + 128))
    jld = jblocks.pack(factors, indices, n, n_shards=8)
    tld = tblocks.pack(factors, indices, n, n_shards=8)
    mesh = jmesh.make_mesh(n_snp=8, n_comp=1)
    v = rng.standard_normal(n)
    vm = rng.standard_normal((3, n))
    with jax.set_mesh(mesh):
        want = np.asarray(jax.jit(jblocks.dot)(jld, jax.numpy.asarray(v)))
        want_m = np.asarray(jax.jit(jblocks.dot_multi)(
            jld, jax.numpy.asarray(vm)))
    got = _gather(tblocks.dot(tld, tblocks.split(tld, torch.as_tensor(v))))
    got_m = _gather(tblocks.dot_multi(
        tld, tblocks.split(tld, torch.as_tensor(vm))))
    assert _scaled_err(got, want) <= 1e-14
    assert _scaled_err(got_m, want_m) <= 1e-14


def test_shard_regroups_an_unsharded_matrix():
    """blocks.shard of the unsharded relayouted matrix defines the
    operator pack(n_shards) builds, shard by shard."""
    plain, sharded, _, L = _sharded_matrix()
    regrouped = tblocks.shard(plain, 8)
    x = torch.as_tensor(np.random.default_rng(4).standard_normal((2, L)))
    for a, b in zip(tblocks.dot_multi(regrouped, tblocks.split(sharded, x)),
                    tblocks.dot_multi(sharded, tblocks.split(sharded, x))):
        assert _scaled_err(a.numpy(), b.numpy()) <= 1e-14
    assert [p.missing for p in regrouped.shards] == [
        p.missing for p in sharded.shards]


def test_shard_places_each_block_once_per_comp_shard():
    """blocks.shard for a comp mesh (each snp span listed once per comp
    shard) gives every local shard its span's blocks once."""
    plain, sharded, _, _ = _sharded_matrix()
    spans = [s for s in range(8) for _ in range(2)]
    regrouped = tblocks.shard(plain, 8, shards=spans)
    assert [p.rank for p in regrouped.shards] == [
        sharded.shards[s].rank for s in spans]
    assert [sum(b.u.shape[0] for b in p.buckets)
            for p in regrouped.shards] == [
        sum(b.u.shape[0] for b in sharded.shards[s].buckets) for s in spans]


def test_shard_data_places_an_unsharded_fit():
    """mesh.shard_data of a ModelData built unsharded in the layout is
    what build_model_data builds on the mesh (its precompute reduced
    across shards), and steps to the same point."""
    pr = _step_problem('kdim')
    n, P = pr['n'], pr['P']
    tld = tblocks.pack(pr['factors'], pr['indices'], n)
    lmap, L, _ = talign.compute_layout([tld], n, n_shards=8)
    mesh = tmesh.make_mesh(8, device='cpu')
    args = (talign.relayout_rows(pr['betas'], lmap, L),
            talign.relayout_rows(pr['std_errs'], lmap, L, fill=1.0))
    kw = dict(annotations=talign.relayout_annotations(pr['annotations'],
                                                      lmap, L),
              mixture_covs=pr['covs'], scaled=False, scale_se=True,
              gwas_N=np.full(P, 1e5), init_hg=np.full(P, 0.3),
              device='cpu')
    placed = tmesh.shard_data(tengine.build_model_data(
        *args, [talign.relayout_ld(tld, lmap, L)] * P, **kw), mesh)
    built = tengine.build_model_data(
        *args, [talign.relayout_ld(tld, lmap, L, n_shards=8)] * P,
        mesh=mesh, **kw)
    for f in dataclasses.fields(tengine.ModelData):
        if torch.is_tensor(getattr(built.shards[0], f.name)):
            x, y = (_gather([getattr(s, f.name) for s in d.shards])
                    for d in (placed, built))
            # the ridge solve of the initialization (inverse_betas) reads
            # its blocks in other bucket groupings: ~1e-11 of scale apart
            np.testing.assert_allclose(x, y, rtol=0,
                                       atol=1e-10 * np.abs(y).max(),
                                       err_msg=f.name)
    st = _transplant(_jax_state('kdim', jengine.build_model_data(
        pr['betas'], pr['std_errs'], [jblocks.pack(pr['factors'],
                                                   pr['indices'], n)] * P,
        pr['annotations'], pr['covs'], scaled=False, scale_se=True,
        gwas_N=np.full(P, 1e5), init_hg=np.full(P, 0.3))), lmap, L)
    pms = [_gather(tengine.outer_step(d, tmesh.shard_state(
        state_to_torch(st), mesh))[1]) for d in (placed, built)]
    np.testing.assert_allclose(pms[0], pms[1], rtol=PM_RTOL, atol=PM_ATOL)


@pytest.mark.parametrize('fault', ['straddle', 'spans'])
def test_pack_refuses_bad_spans(fault):
    """As in the JAX package: a block across a span boundary, or spans
    that do not divide n in multiples of 128, raise."""
    rng = np.random.default_rng(0)
    if fault == 'straddle':
        factors, idx = [_factor(rng, 64)], [np.arange(100, 164)]
        with pytest.raises(ValueError, match='straddles'):
            tblocks.pack(factors, idx, 256, n_shards=2)
        with pytest.raises(ValueError, match='straddles'):
            tblocks.shard(tblocks.pack(factors, idx, 256), 2)
    else:
        factors, idx = [_factor(rng, 64)], [np.arange(64)]
        for n, shards in ((384, 2), (512, 3)):
            with pytest.raises(ValueError, match='128-multiple'):
                tblocks.pack(factors, idx, n, n_shards=shards)


# ---------------------------------------------------------------------------
# outer steps of every state form, sharded against unsharded and JAX
# ---------------------------------------------------------------------------

def _step_problem(form):
    """The JAX package's inputs of test_shard_local_step_matches_unsharded
    (irregular blocks with a hole and an uncovered run), P = 4 for the
    materialized form."""
    P = 4 if form == 'materialized' else 2
    num_loci = 530
    rng = np.random.default_rng(7)
    factors, indices = [], []
    for a, b in [(0, 96), (96, 256), (256, 356), (376, 530)]:
        keep = np.setdiff1d(np.arange(a, b), [130])
        m = rng.standard_normal((keep.size, keep.size))
        factors.append(lowrank.factor_block(
            X=m @ m.T + keep.size * np.eye(keep.size), t=1.0,
            check_symmetric=False))
        indices.append(keep)
    std_errs = rng.uniform(0.01, 0.05, (P, num_loci))
    betas = rng.standard_normal((P, num_loci)) * std_errs * 2
    covs = [np.eye(P) * s for s in (1e-6, 1e-4, 1e-2)]
    annotations = np.zeros((num_loci, 2))
    annotations[np.arange(num_loci), rng.integers(0, 2, num_loci)] = 1
    return dict(n=num_loci, P=P, factors=factors, indices=indices,
                betas=betas, std_errs=std_errs, covs=covs,
                annotations=annotations,
                scale_se=form in ('kdim', 'epoch'))


def _jax_state(form, data):
    if form == 'materialized':
        return synthetic.synthetic_state(data)
    if form != 'epoch':
        return synthetic.synthetic_state(data, compact=True)
    P, I = data.marginal_effects.shape
    K = data.mixture_prec.shape[0]
    rng = np.random.default_rng(11)
    B, live = 4, 2
    hist = np.zeros((B, P, I))
    scale = np.ones((B, P))
    c = np.zeros(B)
    hist[:live] = rng.standard_normal((live, P, I)) * 1e-2
    scale[:live] = rng.uniform(0.7, 1.4, (live, P))
    c[:live] = rng.uniform(0.1, 1.0, live)
    hyper = rng.uniform(0.1, 1.0, (data.num_annotations, K))
    hyper /= hyper.sum(axis=1, keepdims=True)
    return jengine.VIState(
        vi_mu=None, vi_delta=None, nat_grad_vi_delta=None, sigma=None,
        nat_mu=jax.numpy.asarray(rng.standard_normal((P, I)) * 1e-2),
        nat_hist=jax.numpy.asarray(hist),
        nat_hist_scale=jax.numpy.asarray(scale),
        nat_hist_c=jax.numpy.asarray(c),
        nat_hist_n=jax.numpy.asarray(live, dtype=jax.numpy.int32),
        hyper_delta=jax.numpy.asarray(hyper),
        error_scaling=jax.numpy.asarray(rng.uniform(0.8, 1.2, P)),
        L=jax.numpy.ones(3), elbo=jax.numpy.asarray(0.),
        running_elbo_delta=jax.numpy.asarray(np.nan),
        num_err=jax.numpy.asarray(0, dtype=jax.numpy.int32))


def _transplant(st, lmap, L):
    """A JAX state of genome order in layout order: per-SNP fields
    scattered to lmap (pads: zero means, uniform vi_delta)."""
    def spread(x, fill=0.0):
        x = np.asarray(x)
        out = np.full(x.shape[:-1] + (L,), fill)
        out[..., lmap] = x
        return jax.numpy.asarray(out)

    upd = {}
    for name in ('nat_mu', 'nat_hist', 'vi_mu', 'nat_grad_vi_delta'):
        if getattr(st, name) is not None:
            upd[name] = spread(getattr(st, name))
    if st.vi_delta is not None:
        upd['vi_delta'] = spread(st.vi_delta, 1.0 / st.vi_delta.shape[0])
    return dataclasses.replace(st, **upd)


def _sigma_for(prec, log_det, sld, es):
    return jsigma.make_summaries(prec, log_det, sld / es[:, None])


def _run_forms(form):
    """One outer step of `form` from the same point: the port unsharded
    (genome order), the port on an 8-shard mesh (layout order) and the
    JAX package on its 8-device mesh. Returns a dict of results."""
    pr = _step_problem(form)
    n, P = pr['n'], pr['P']
    jld = jblocks.pack(pr['factors'], pr['indices'], n)
    tld = tblocks.pack(pr['factors'], pr['indices'], n)
    lmap, L, ok = talign.compute_layout([tld], n, n_shards=8)
    assert ok
    rows = talign.relayout_rows
    lay = dict(b=rows(pr['betas'], lmap, L),
               se=rows(pr['std_errs'], lmap, L, fill=1.0),
               an=talign.relayout_annotations(pr['annotations'], lmap, L))
    kw = dict(scaled=False, scale_se=pr['scale_se'],
              gwas_N=np.full(P, 1e5), init_hg=np.full(P, 0.3))

    jdata1 = jengine.build_model_data(pr['betas'], pr['std_errs'],
                                      [jld] * P, pr['annotations'],
                                      pr['covs'], **kw)
    st1 = _jax_state(form, jdata1)
    jl8 = jalign.relayout_ld(jld, lmap, L, n_shards=8)
    mesh_j = jmesh.make_mesh(n_snp=8, n_comp=1)
    with jax.set_mesh(mesh_j):
        jdata2 = jengine.build_model_data(lay['b'], lay['se'], [jl8] * P,
                                          lay['an'], pr['covs'], **kw)
    st2 = _transplant(st1, lmap, L)
    if form == 'materialized':
        st2 = dataclasses.replace(st2, sigma=_sigma_for(
            np.asarray(jdata2.mixture_prec), np.asarray(jdata2.log_det),
            np.asarray(jdata2.scaled_ld_diags),
            np.asarray(st1.error_scaling)))
    sdata = jmesh.shard_data(jdata2, mesh_j)
    sstate = jmesh.shard_state(st2, mesh_j)
    with jax.set_mesh(mesh_j):
        jst2, jpm2 = jengine.outer_step(sdata, sstate, line_search_rate=2.0)

    tdata1 = tengine.build_model_data(pr['betas'], pr['std_errs'],
                                      [tld] * P, pr['annotations'],
                                      pr['covs'], device='cpu', **kw)
    mesh = tmesh.make_mesh(8, device='cpu')
    tl8 = talign.relayout_ld(tld, lmap, L, n_shards=8)
    tdata2 = tengine.build_model_data(lay['b'], lay['se'], [tl8] * P,
                                      lay['an'], pr['covs'], device='cpu',
                                      mesh=mesh, **kw)
    tst1 = state_to_torch(st1)
    tst2 = tmesh.shard_state(state_to_torch(st2), mesh)
    tengine.host_syncs = 0
    a, pm1 = tengine.outer_step(tdata1, tst1)
    syncs1 = tengine.host_syncs
    tengine.host_syncs = 0
    b, pm2 = tengine.outer_step(tdata2, tst2)
    syncs2 = tengine.host_syncs
    return dict(lmap=lmap, L=L, a=a, b=b, pm1=t2n(pm1), pm2=_gather(pm2),
                jst2=jst2, jpm2=np.asarray(jpm2), syncs=(syncs1, syncs2),
                mesh=mesh)


@pytest.mark.parametrize('form', ['shared', 'kdim', 'epoch',
                                  'materialized'])
def test_outer_step_sharded_matches_unsharded_and_jax(form):
    """One outer step of each state form on an 8-shard mesh equals the
    port's unsharded step (through the layout map) and vilma_tpu's
    sharded step (layout order) at tests/test_sharding.py's tolerances;
    the pad slots stay exactly zero and the host syncs are those of the
    unsharded step."""
    r = _run_forms(form)
    lmap, pads = r['lmap'], np.setdiff1d(np.arange(r['L']), r['lmap'])
    np.testing.assert_allclose(r['pm2'][:, lmap], r['pm1'], rtol=PM_RTOL,
                               atol=PM_ATOL)
    np.testing.assert_allclose(r['pm2'], r['jpm2'], rtol=PM_RTOL,
                               atol=PM_ATOL)
    assert np.all(r['pm2'][:, pads] == 0)
    for other in (r['a'].elbo, float(r['jst2'].elbo)):
        np.testing.assert_allclose(r['b'].elbo, other, rtol=ELBO_RTOL)
    for st in (r['a'], r['jst2']):
        np.testing.assert_allclose(t2n(r['b'].hyper_delta),
                                   np.asarray(st.hyper_delta), rtol=1e-10)
        np.testing.assert_allclose(t2n(r['b'].error_scaling),
                                   np.asarray(st.error_scaling), rtol=1e-9)
    assert r['syncs'][0] == r['syncs'][1] > 0
    if form == 'epoch':
        assert r['b'].nat_hist_n == r['a'].nat_hist_n == int(
            r['jst2'].nat_hist_n)
        hist = r['mesh'].gather([s.nat_hist for s in r['b'].shards])
        np.testing.assert_allclose(t2n(hist)[..., lmap],
                                   t2n(r['a'].nat_hist), rtol=1e-10,
                                   atol=1e-14)


@pytest.mark.parametrize('form', ['shared', 'kdim', 'epoch',
                                  'materialized'])
def test_host_syncs_per_step_equal_under_a_mesh(form):
    """MultiPopVI's steps on a 4-shard mesh make as many host syncs as
    the unsharded fit's (the mesh reduces before the one fetch of each
    evaluation), and reach the same posterior means."""
    pr = _step_problem(form)
    n, P = pr['n'], pr['P']
    tld = tblocks.pack(pr['factors'], pr['indices'], n)
    lmap, L, _ = talign.compute_layout([tld], n, n_shards=4)
    rows = talign.relayout_rows
    kw = dict(mixture_covs=pr['covs'], checkpoint=False, scaled=False,
              scale_se=pr['scale_se'], gwas_N=np.full(P, 1e5),
              init_hg=np.full(P, 0.3), num_its=3, device='cpu')
    if form == 'epoch':
        kw['scale_se'] = True
    out = []
    for mesh in (None, tmesh.make_mesh(4, device='cpu')):
        if mesh is None:
            args = dict(marginal_effects=pr['betas'],
                        std_errs=pr['std_errs'], ld_mats=[tld] * P,
                        annotations=pr['annotations'])
        else:
            ld = talign.relayout_ld(tld, lmap, L, n_shards=4)
            args = dict(
                marginal_effects=rows(pr['betas'], lmap, L),
                std_errs=rows(pr['std_errs'], lmap, L, fill=1.0),
                ld_mats=[ld] * P,
                annotations=talign.relayout_annotations(pr['annotations'],
                                                        lmap, L),
                mesh=mesh, out_index=lmap)
        old = tengine._EPOCH_STATE_BYTES
        tengine._EPOCH_STATE_BYTES = 0 if form == 'epoch' else old
        try:
            vi = tengine.MultiPopVI(**args, **kw)
            assert vi._epoch == (form == 'epoch')
            np.random.seed(3)
            tengine.host_syncs = 0
            st = vi.optimize()
        finally:
            tengine._EPOCH_STATE_BYTES = old
        out.append((tengine.host_syncs, vi.real_posterior_mean(st)))
    assert out[0][0] == out[1][0] > 0
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-9, atol=1e-14)


# ---------------------------------------------------------------------------
# the CLI, checkpoints and what is refused
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def mesh_fits(tmp_path_factory):
    """The tests/test_torch_cli.py case with --learn-scaling (the kdim
    state): the port on --mesh snp=8 and unsharded, vilma_tpu on
    --mesh snp=8 (its simulated mesh)."""
    root = str(tmp_path_factory.mktemp('mesh_fit'))
    case = _write_case(root)
    outs = {}
    for tag, mesh in (('torch_mesh', True), ('torch', False),
                      ('jax_mesh', True)):
        outs[tag] = os.path.join(root, tag)
        argv = _argv(case, outs[tag]) + ['--learn-scaling']
        if mesh:
            argv += ['--mesh', 'snp=8']
        if tag.startswith('torch'):
            tfrontend.main(argv + ['--device', 'cpu'])
        else:
            jfrontend.main(argv)
    return outs


def _assert_estimates(got_prefix, want_prefix, rtol, atol):
    gh, got = _read_tsv(got_prefix + '.estimates.tsv')
    wh, want = _read_tsv(want_prefix + '.estimates.tsv')
    assert gh == wh
    for col in gh:
        if col.startswith('posterior'):
            np.testing.assert_allclose(np.array(got[col], dtype=float),
                                       np.array(want[col], dtype=float),
                                       rtol=rtol, atol=atol, err_msg=col)
        else:
            assert got[col] == want[col], col


def test_cli_mesh_matches_jax_mesh(mesh_fits):
    """fit --device cpu --mesh snp=8 against vilma_tpu's fit --mesh snp=8
    at tests/test_cli_mesh.py's tolerance: .estimates.tsv, every .npz
    member (in the original variant order) and the grid pickle."""
    _assert_estimates(mesh_fits['torch_mesh'], mesh_fits['jax_mesh'],
                      rtol=1e-4, atol=1e-10)
    t = np.load(mesh_fits['torch_mesh'] + '.npz')
    j = np.load(mesh_fits['jax_mesh'] + '.npz')
    assert sorted(t.files) == sorted(j.files)
    for key in j.files:
        assert t[key].shape == j[key].shape, key
        np.testing.assert_allclose(t[key], j[key], rtol=1e-4, atol=1e-10,
                                   err_msg=key)
    with open(mesh_fits['torch_mesh'] + '.covariance.pkl', 'rb') as fh:
        tcov = pickle.load(fh)
    with open(mesh_fits['jax_mesh'] + '.covariance.pkl', 'rb') as fh:
        jcov = pickle.load(fh)
    np.testing.assert_allclose(np.asarray(tcov[0]), np.asarray(jcov[0]),
                               rtol=1e-12, atol=0)


def test_cli_mesh_matches_unsharded(mesh_fits):
    """The sharded CLI fit writes the port's unsharded outputs (same RNG
    draws in the original order; reductions reassociated)."""
    _assert_estimates(mesh_fits['torch_mesh'], mesh_fits['torch'],
                      rtol=1e-4, atol=1e-10)
    t = np.load(mesh_fits['torch_mesh'] + '.npz')
    u = np.load(mesh_fits['torch'] + '.npz')
    assert sorted(t.files) == sorted(u.files)
    for key in u.files:
        np.testing.assert_allclose(t[key], u[key], rtol=1e-4, atol=1e-10,
                                   err_msg=key)


def test_cli_mesh_mmap_and_factor_cache(tmp_path):
    """--mesh snp=4 with --mmap (the relayout through the spill) and a
    --factor-cache the unsharded fit filled writes the unsharded --mmap
    fit's outputs; the cache serves every block."""
    from vilma_tpu_torch.io import load
    case = _write_case(str(tmp_path))
    cache = str(tmp_path / 'cache')
    outs = {}
    for tag, extra in (('plain', []), ('mesh', ['--mesh', 'snp=4'])):
        outs[tag] = str(tmp_path / tag)
        hits = load.factor_cache_hits
        tfrontend.main(_argv(case, outs[tag]) + [
            '--device', 'cpu', '--mmap', '--factor-cache', cache] + extra)
    # 3 blocks for each of the 2 cohorts (their masks differ)
    assert load.factor_cache_hits - hits == 6
    _assert_estimates(outs['mesh'], outs['plain'], rtol=1e-10, atol=1e-14)


def _vi(case_dir, mesh, **kw):
    """A MultiPopVI of the CLI case, sharded over `mesh` (or not)."""
    from vilma_tpu_torch.io import load
    schema, (s1, s2), extract, _ = case_dir
    variants = load.load_variant_list(extract)
    betas, ses = [], []
    for path in (s1, s2):
        sumstats, _ = load.load_sumstats(path, variants=variants)
        betas.append(np.asarray(sumstats['BETA']))
        ses.append(np.asarray(sumstats['SE']))
    ld, _ = load.load_ld_from_schema(schema, variants, [], 1.0)
    n = len(variants)
    betas, ses = np.array(betas), np.array(ses)
    annot = np.ones((n, 1))
    args = dict(marginal_effects=betas, std_errs=ses, ld_mats=[ld, ld],
                annotations=annot)
    if mesh is not None:
        lmap, L, ok = talign.compute_layout([ld], n, n_shards=mesh.n_snp)
        assert ok
        lds = talign.relayout_ld(ld, lmap, L, n_shards=mesh.n_snp)
        args = dict(
            marginal_effects=talign.relayout_rows(betas, lmap, L),
            std_errs=talign.relayout_rows(ses, lmap, L, fill=1.0),
            ld_mats=[lds, lds],
            annotations=talign.relayout_annotations(annot, lmap, L),
            mesh=mesh, out_index=lmap)
    covs = [np.eye(2) * s for s in (1e-6, 1e-4, 1e-2)]
    return tengine.MultiPopVI(mixture_covs=covs, gwas_N=np.full(2, 1e5),
                              init_hg=np.full(2, 0.3), device='cpu',
                              **args, **kw)


@pytest.mark.parametrize('scale_se', [False, True])
def test_sharded_checkpoint_resumes_unsharded(tmp_path, scale_se):
    """A sharded fit's checkpoint is the unsharded fit's (original
    variant order), and resuming it unsharded gives what resuming the
    unsharded checkpoint gives."""
    case = _write_case(str(tmp_path))
    ckpts = {}
    for tag, mesh in (('plain', None),
                      ('mesh', tmesh.make_mesh(4, device='cpu'))):
        vi = _vi(case, mesh, num_its=3, checkpoint=True, checkpoint_freq=2,
                 scale_se=scale_se, output=str(tmp_path / tag))
        np.random.seed(5)
        vi.optimize()
        ckpts[tag] = np.load(str(tmp_path / tag) + '-checkpoint.2.npz')
    assert sorted(ckpts['mesh'].files) == sorted(ckpts['plain'].files)
    for key in ckpts['plain'].files:
        np.testing.assert_allclose(ckpts['mesh'][key], ckpts['plain'][key],
                                   rtol=1e-9, atol=1e-14, err_msg=key)
    means = []
    for tag in ('mesh', 'plain'):
        vi = _vi(case, None, num_its=2, checkpoint=False,
                 scale_se=scale_se)
        means.append(vi.real_posterior_mean(vi.optimize(ckpts[tag])))
    np.testing.assert_allclose(means[0], means[1], rtol=1e-9, atol=1e-14)


def test_jax_checkpoint_resumes_sharded(tmp_path):
    """A vilma_tpu checkpoint resumes on a 4-shard mesh as it resumes
    unsharded in the port and in vilma_tpu."""
    import pandas as pd
    from vilma_tpu.io import load as jload
    case = _write_case(str(tmp_path))
    plain = _vi(case, None, num_its=3, checkpoint=False, scale_se=True)
    schema, _, extract, _ = case
    ld, _ = jload.load_ld_from_schema(schema, pd.read_csv(extract,
                                                          sep='\t'),
                                      [], 1.0)

    def jax_vi(**kw):
        return jengine.MultiPopVI(
            marginal_effects=t2n(plain.data.marginal_effects),
            std_errs=t2n(plain.data.std_errs), ld_mats=[ld, ld],
            annotations=np.ones((plain.num_loci, 1)),
            mixture_covs=[np.eye(2) * s for s in (1e-6, 1e-4, 1e-2)],
            scale_se=True, gwas_N=np.full(2, 1e5), init_hg=np.full(2, 0.3),
            **kw)

    np.random.seed(5)
    jax_vi(num_its=3, checkpoint=True, checkpoint_freq=2,
           output=str(tmp_path / 'jax')).optimize()
    ckpt = np.load(str(tmp_path / 'jax') + '-checkpoint.2.npz')
    means = []
    for mesh in (tmesh.make_mesh(4, device='cpu'), None):
        t = _vi(case, mesh, num_its=2, checkpoint=False, scale_se=True)
        means.append(t.real_posterior_mean(t.optimize(ckpt)))
    jr = jax_vi(num_its=2, checkpoint=False)
    means.append(jr.real_posterior_mean(jr.optimize(ckpt)))
    np.testing.assert_allclose(means[0], means[1], rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(means[0], means[2], rtol=1e-8, atol=1e-14)


def test_component_sharding_raises(tmp_path):
    """What component sharding still refuses: comp=0 in make_mesh, and
    through the CLI a grid of fewer components than comp shards (-K 1 at
    2 cohorts makes a grid of fewer than 100 components), each with a
    ValueError; a mesh that divides no process run evenly raises too."""
    with pytest.raises(ValueError, match='comp=0'):
        tmesh.make_mesh(2, n_comp=0, device='cpu')
    with pytest.raises(ValueError, match='unevenly'):
        tmesh.Mesh(3, ['cpu'] * 2, rank=0, world=3, n_comp=2)
    case = _write_case(str(tmp_path))
    argv = _argv(case, str(tmp_path / 'o'))
    argv[argv.index('-K') + 1] = '1'
    with pytest.raises(ValueError, match='comp=100'):
        tfrontend.main(argv + ['--device', 'cpu', '--mesh', 'comp=100'])


def conflicting_argv(root):
    """The tests/test_torch_cli.py case under `root` with a second panel
    that lists the first block's variants in reverse order: the two
    schemas disagree on the order of shared variants, so no shard-local
    layout exists. Returns argv(prefix), the CLI fit's argv."""
    case = _write_case(root)
    schema = case[0]
    with open(os.path.join(root, 'block0.var')) as fh:
        rows = fh.read().splitlines()
    u = np.load(os.path.join(root, 'block0.npy'))
    with open(os.path.join(root, 'rev0.var'), 'w') as fh:
        fh.write('\n'.join(rows[::-1]) + '\n')
    np.save(os.path.join(root, 'rev0.npy'),
            np.vstack([u[:-1][::-1], u[-1:]]))
    rev = os.path.join(root, 'rev.schema')
    with open(rev, 'w') as fh:
        fh.write('rev0.var\trev0.npy\n')

    def argv(prefix):
        out = _argv(case, prefix)
        out[out.index('--ld-schema') + 1] = f'{schema},{rev}'
        return out
    return argv


def test_conflicting_schemas_raise(tmp_path):
    """Two cohorts whose schemas disagree on the order of shared variants
    have no shard-local layout: --mesh snp=2 and comp=2,snp=2 no longer
    raise but take the global-gather layout (129 variants padded to 130
    slots), and write vilma_tpu's fallback fit (its --mesh snp=2; at
    comp=2 vilma_tpu needs K divisible by 2, and this grid has 69
    components) at tests/test_cli_mesh.py's tolerance: .estimates.tsv
    and every .npz member."""
    argv = conflicting_argv(str(tmp_path))
    jax_prefix = str(tmp_path / 'jax')
    jfrontend.main(argv(jax_prefix) + ['--mesh', 'snp=2'])
    for mesh in ('snp=2', 'comp=2,snp=2'):
        prefix = str(tmp_path / mesh.replace(',', '_').replace('=', ''))
        tfrontend.main(argv(prefix) + ['--device', 'cpu', '--mesh', mesh])
        _assert_estimates(prefix, jax_prefix, rtol=1e-4, atol=1e-10)
        t, j = np.load(prefix + '.npz'), np.load(jax_prefix + '.npz')
        assert sorted(t.files) == sorted(j.files)
        for key in j.files:
            assert t[key].shape == j[key].shape, key
            np.testing.assert_allclose(t[key], j[key], rtol=1e-4,
                                       atol=1e-10, err_msg=key)


def test_too_few_cards_raise(monkeypatch, tmp_path):
    """On cuda, --mesh snp=N with fewer than N cards raises before
    anything runs (no shard wraps round the cards, none drops to the
    CPU); a mesh-less --distributed is refused."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    with pytest.raises(RuntimeError, match='needs 2 CUDA devices'):
        tmesh.make_mesh(2)
    case = _write_case(str(tmp_path))
    loaded = []
    monkeypatch.setattr('vilma_tpu_torch.io.load.load_variant_list',
                        lambda *a: loaded.append(a))
    with pytest.raises(RuntimeError, match='needs 4 CUDA devices'):
        tfrontend.main(_argv(case, str(tmp_path / 'o'))
                       + ['--precision', 'f32', '--mesh', 'snp=4'])
    assert not loaded
    with pytest.raises(ValueError, match='needs a device mesh'):
        tfrontend.main(_argv(case, str(tmp_path / 'o'))
                       + ['--device', 'cpu', '--distributed'])
    # co-located shards on one card are allowed when asked for
    assert tmesh.make_mesh(2, devices=['cuda:0', 'cuda:0']).devices == (
        torch.device('cuda', 0),) * 2


# ---------------------------------------------------------------------------
# the launchers' device guard
# ---------------------------------------------------------------------------

class _FakeCuda(torch.Tensor):
    """A host tensor that reports itself on cuda:1."""

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device('cuda', 1)


class _OnFakeCard(torch.overrides.TorchFunctionMode):
    """Tensors made for a CUDA device are made on the host as _FakeCuda."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        dev = kwargs.get('device')
        fake = dev is not None and torch.device(dev).type == 'cuda'
        if fake:
            kwargs['device'] = 'cpu'
        out = func(*args, **kwargs)
        if fake and isinstance(out, torch.Tensor):
            out = out.as_subclass(_FakeCuda)
        return out


class _Recorder:
    """torch.cuda.device stand-in tracking the current device, and a
    kernel library whose entry points record it."""

    def __init__(self):
        self.current = torch.device('cuda', 0)
        self.calls = []
        outer = self

        class Device:
            def __init__(self, dev):
                self.dev = torch.device(dev)

            def __enter__(self):
                self.prev, outer.current = outer.current, self.dev

            def __exit__(self, *exc):
                outer.current = self.prev

        self.device = Device

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, self.current))
            if name.endswith('_fit'):
                args[-1]._obj.value = 64     # clusters the card holds
            return 0
        return entry


def _fake(x):
    return x.as_subclass(_FakeCuda)


@pytest.mark.parametrize('launcher', [
    'matvec_cluster', 'matvec_group', 'matvec_backward', 'prologue',
    'prologue_kdim', 'delta_sums', 'prologue_epochs', 'delta_sums_epochs'])
def test_launchers_enter_the_operands_device(launcher, monkeypatch):
    """Every kernel launcher runs its C entry points (the occupancy query
    and the launch) inside torch.cuda.device(<the operands' device>):
    operands on cuda:1 while cuda:0 is current, a stubbed library."""
    rec = _Recorder()
    monkeypatch.setattr(torch.cuda, 'device', rec.device)
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda dev=None: type('S', (), {'cuda_stream': 0}))
    monkeypatch.setattr(build, 'library', lambda: rec)
    monkeypatch.setattr(block_matvec, '_placeable', {})
    monkeypatch.setattr(block_matvec, '_workspace', {})
    monkeypatch.setattr(block_matvec, 'launches', 0)
    monkeypatch.setattr(block_matvec, 'launches_group', 0)
    monkeypatch.setattr(block_matvec, 'launches_backward', 0)
    monkeypatch.setattr(block_matvec, 'launches_by_cohorts', {})
    monkeypatch.setattr(compact_obj, 'launches',
                        dict.fromkeys(compact_obj.launches, 0))
    with _OnFakeCard():
        if launcher.startswith('matvec'):
            P = 2048 if launcher == 'matvec_group' else 1024
            u = _fake(torch.zeros(2, P, 64))
            s, d = _fake(torch.ones(2, 64)), _fake(torch.zeros(2, P))
            x = _fake(torch.ones(2, 2, P))
            if launcher == 'matvec_backward':
                block_matvec._launch(u, s, d, x, backward=True)
            else:
                block_matvec.bucket_matvec_multi(u, s, d, x)
        else:
            P, I, K, A = 2, 300, 5, 3
            ncol = P * (P + 1) // 2 + 1
            coeffs = _fake(torch.zeros(K, ncol))
            scores = _fake(torch.zeros(K, A))
            ann = _fake(torch.zeros(I, dtype=torch.int32))
            sld = _fake(torch.ones(P, I))
            nat = _fake(torch.zeros((K, P, I) if launcher.endswith('kdim')
                                    else (P, I)))
            if launcher.endswith('epochs'):
                fn = getattr(compact_obj, launcher)
                fn(coeffs, scores, ann, sld, nat, _fake(torch.zeros(4, P, I)),
                   _fake(torch.ones(5, P)), _fake(torch.zeros(4)),
                   num_annotations=A, num_live=1)
            else:
                fn = getattr(compact_obj, launcher.replace('_kdim', ''))
                fn(coeffs, scores, ann, sld, nat, num_annotations=A)
    assert rec.calls, 'no entry point was called'
    assert {dev for _, dev in rec.calls} == {torch.device('cuda', 1)}
    assert rec.current == torch.device('cuda', 0)
