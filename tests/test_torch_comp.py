"""Component sharding (--mesh comp=M[,snp=N]) of vilma_tpu_torch on the
CPU at float64, against vilma_tpu: the K-split plain versions and their
merges against the whole-K ones and the Pallas kernels in interpret mode,
comp-sharded outer steps of every state form on co-located CPU shards
against vilma_tpu's unsharded step and its n_comp = 2 mesh, host syncs,
each shard's K slice, the refusals, the CLI and resume."""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from vilma_tpu.inference import engine as jengine
from vilma_tpu.ops import blocks as jblocks
from vilma_tpu.ops.pallas import compact_obj as jco
from vilma_tpu.parallel import mesh as jmesh
from vilma_tpu_torch import frontend as tfrontend
from vilma_tpu_torch.inference import engine as tengine
from vilma_tpu_torch.ops import blocks as tblocks
from vilma_tpu_torch.ops.cuda import compact_obj as tco
from vilma_tpu_torch.parallel import alignment as talign
from vilma_tpu_torch.parallel import mesh as tmesh

from tests.test_torch_cli import _argv, _write_case
from tests.test_torch_epoch import _epoch_operands
from tests.test_torch_fused_kernels import _compact_operands
from tests.test_torch_materialized import _trait_case
from tests.test_torch_parallel import (_assert_estimates, _jax_state,
                                       _sigma_for, _step_problem,
                                       _transplant)
from tests.test_torch_scale_se import _kdim_operands
from tests.torch_parity import state_to_torch, t2n

# tests/test_sharding.py's tolerances; 1e-12 of scale for the K-split
# plain versions (f64, only the order of the sums over K changes), 1e-4
# for the CLI (tests/test_cli_mesh.py)
PM_RTOL, PM_ATOL, ELBO_RTOL = 1e-10, 1e-12, 1e-8
SPLIT_TOL = 1e-12
CLI_RTOL = 1e-4

MESHES = [(2, 1), (2, 2), (3, 1)]


def _problem(form):
    """tests/test_torch_parallel.py's step problem with a fourth
    component, so that vilma_tpu's comp = 2 mesh divides K (XLA takes no
    uneven shards) and comp = 3 splits it unevenly (2, 1, 1)."""
    pr = _step_problem(form)
    pr['covs'] = [np.eye(pr['P']) * v for v in (1e-6, 1e-4, 1e-3, 1e-2)]
    return pr


# ---------------------------------------------------------------------------
# the K-split plain versions and the merges
# ---------------------------------------------------------------------------

def _operands(form):
    """(JAX operands, torch operands, the form's whole-K and K-split
    functions) of a K = 5 point with pad SNPs."""
    if form == 'shared':
        j, t = _compact_operands(2, 3, seed=4)
    elif form == 'kdim':
        j, t = _kdim_operands(2, 3, seed=4)
    else:
        j, t = _epoch_operands(2, 3, seed=4)
    return j, t


def _slice_ops(form, t, ks):
    """The operands of one comp slice: the coefficient and score rows,
    and a kdim natural mean's rows."""
    out = list(t)
    out[0], out[1] = t[0][ks], t[1][ks]
    if form == 'kdim':
        out[4] = t[4][ks]
    return out


def _split(form, t, M, A):
    """(post_means, post_vars, kl, [A, K] sums) through the K-split plain
    versions over M comp slices and their merges."""
    K = t[1].shape[0]
    kss = [slice(a, b) for a, b in tmesh.k_slices(K, M)]
    epochs = form == 'epoch'
    part = tco.prologue_epochs_partial if epochs else tco.prologue_partial
    norm = tco.delta_norm_epochs if epochs else tco.delta_norm
    given = (tco.delta_sums_epochs_given if epochs
             else tco.delta_sums_given)
    accs = [part(*_slice_ops(form, t, ks), num_annotations=A)
            for ks in kss]
    pm, pv, kl = tco.prologue_merge(torch.stack(accs), t[2],
                                    num_annotations=A)
    merged = tco.norm_merge(torch.stack(
        [norm(*_slice_ops(form, t, ks), num_annotations=A) for ks in kss]))
    sums = torch.cat([given(*_slice_ops(form, t, ks), merged,
                            num_annotations=A) for ks in kss], dim=1)
    return pm, pv, kl, sums


@pytest.mark.parametrize('M', [1, 2, 3])
@pytest.mark.parametrize('form', ['shared', 'kdim', 'epoch'])
def test_split_plain_versions_match_whole_and_pallas(form, M):
    """The K-split prologue partials merged over M uneven slices of K = 5,
    and the split sums (pass 1 merged, pass 2 per slice), equal the
    whole-K plain versions and the JAX package's Pallas kernels in
    interpret mode at 1e-12 of scale (real SNPs: a pad slot's selected
    scores are a convention, tests/test_torch_fused_kernels.py)."""
    A = 3
    j, t = _operands(form)
    pm, pv, kl, sums = _split(form, t, M, A)
    if form == 'epoch':
        whole = tco.prologue_epochs(*t, num_annotations=A)
        wsums = tco.delta_sums_epochs(*t, num_annotations=A)
        jout = jco.prologue_epochs(*j, num_annotations=A, interpret=True)
        jsums = jco.delta_sums_epochs(*j, num_annotations=A, interpret=True)
    else:
        whole = tco.prologue(*t, num_annotations=A)
        wsums = tco.delta_sums(*t, num_annotations=A)
        jout = jco.prologue(*j, num_annotations=A, interpret=True)
        jsums = jco.delta_sums(*j, num_annotations=A, interpret=True)
    real = t2n(t[2]) < A
    for got, want, jwant in ((pm, whole[0], jout[0]),
                             (pv, whole[1], jout[1])):
        want = t2n(want)
        scale = np.abs(want).max()
        np.testing.assert_allclose(t2n(got), want, rtol=0,
                                   atol=SPLIT_TOL * scale)
        np.testing.assert_allclose(t2n(got)[:, real],
                                   np.asarray(jwant)[:, real], rtol=0,
                                   atol=SPLIT_TOL * scale)
    for want in (float(whole[2]), float(jout[2])):
        assert abs(float(kl) - want) <= SPLIT_TOL * abs(want)
    for want in (t2n(wsums), np.asarray(jsums)):
        np.testing.assert_allclose(t2n(sums), want, rtol=0,
                                   atol=SPLIT_TOL * want.max())


def test_k_slices_are_contiguous_uneven_and_refuse_k_below_m():
    """k_slices splits K into M contiguous slices, the first K % M one
    longer, with no pad component; K < M raises ValueError."""
    assert tmesh.k_slices(5, 2) == [(0, 3), (3, 5)]
    assert tmesh.k_slices(5, 3) == [(0, 2), (2, 4), (4, 5)]
    assert tmesh.k_slices(6, 3) == [(0, 2), (2, 4), (4, 6)]
    with pytest.raises(ValueError, match='comp=4'):
        tmesh.k_slices(3, 4)


def test_mesh_grid_order_and_reductions():
    """Shard (c, s) is flat c * N + s; comp_sum, comp_max, comp_gather,
    snp_sum and comp_cat reduce over the right shards, in order."""
    mesh = tmesh.make_mesh(3, n_comp=2, device='cpu')
    assert [mesh.coords(j) for j in range(6)] == [
        (0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]
    assert mesh.snp_shards == (0, 1, 2, 0, 1, 2)
    parts = [torch.tensor([float(f)]) for f in range(6)]
    assert [float(x) for x in mesh.comp_sum(parts)] == [3, 5, 7, 3, 5, 7]
    assert [float(x) for x in mesh.comp_max(parts)] == [3, 4, 5, 3, 4, 5]
    assert [float(x) for x in mesh.snp_sum(parts)] == [3, 3, 3, 12, 12, 12]
    assert [t2n(x).ravel().tolist() for x in mesh.comp_gather(parts)] == [
        [0, 3], [1, 4], [2, 5], [0, 3], [1, 4], [2, 5]]
    K = 5
    full = torch.arange(K * 2.).reshape(K, 2)
    sliced = [full[mesh.k_slice(j, K)] for j in range(6)]
    assert [sl.shape[0] for sl in sliced] == [3, 3, 3, 2, 2, 2]
    for x in mesh.comp_cat(sliced, 0, K):
        torch.testing.assert_close(x, full, rtol=0, atol=0)
    assert mesh.counts_once(2) and not mesh.counts_once(3)


# ---------------------------------------------------------------------------
# comp-sharded outer steps of every state form
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def jax_steps():
    """vilma_tpu's unsharded outer step of each form's point, and its
    step on the n_comp = 2 mesh (tests/test_sharding.py's
    test_comp_sharded_mesh, at n_snp = 1)."""
    out = {}
    for form in ('shared', 'kdim', 'epoch', 'materialized'):
        pr = _problem(form)
        n, P = pr['n'], pr['P']
        jld = jblocks.pack(pr['factors'], pr['indices'], n)
        kw = dict(scaled=False, scale_se=pr['scale_se'],
                  gwas_N=np.full(P, 1e5), init_hg=np.full(P, 0.3))
        data = jengine.build_model_data(pr['betas'], pr['std_errs'],
                                        [jld] * P, pr['annotations'],
                                        pr['covs'], **kw)
        st = _jax_state(form, data)
        jst, jpm = jengine.outer_step(data, st, line_search_rate=2.0)
        mesh = jmesh.make_mesh(n_snp=1, n_comp=2)
        with jax.set_mesh(mesh):
            cst, cpm = jengine.outer_step(jmesh.shard_data(data, mesh),
                                          jmesh.shard_state(st, mesh),
                                          line_search_rate=2.0)
        out[form] = dict(pr=pr, data=data, st=st, jst=jst,
                         jpm=np.asarray(jpm), cpm=np.asarray(cpm),
                         celbo=float(cst.elbo))
    return out


def _comp_step(r, form, comp, snp):
    """The port's outer step of the form's point on a (comp, snp) mesh of
    co-located CPU shards, in the shard-local layout. Returns (state,
    posterior mean in genome order, host syncs, layout map, mesh)."""
    pr, jdata = r['pr'], r['data']
    n, P = pr['n'], pr['P']
    tld = tblocks.pack(pr['factors'], pr['indices'], n)
    lmap, L, ok = talign.compute_layout([tld], n, n_shards=snp)
    assert ok
    rows = talign.relayout_rows
    mesh = tmesh.make_mesh(snp, n_comp=comp, device='cpu')
    ld = talign.relayout_ld(tld, lmap, L, n_shards=snp,
                            shards=list(mesh.snp_shards))
    data = tengine.build_model_data(
        rows(pr['betas'], lmap, L), rows(pr['std_errs'], lmap, L, fill=1.0),
        [ld] * P, talign.relayout_annotations(pr['annotations'], lmap, L),
        pr['covs'], scaled=False, scale_se=pr['scale_se'],
        gwas_N=np.full(P, 1e5), init_hg=np.full(P, 0.3), device='cpu',
        mesh=mesh)
    st = _transplant(r['st'], lmap, L)
    if form == 'materialized':
        st = dataclasses.replace(st, sigma=_sigma_for(
            np.asarray(jdata.mixture_prec), np.asarray(jdata.log_det),
            rows(np.asarray(jdata.scaled_ld_diags), lmap, L),
            np.asarray(r['st'].error_scaling)))
    tengine.host_syncs = 0
    new, pms = tengine.outer_step(data, tmesh.shard_state(
        state_to_torch(st), mesh))
    syncs = tengine.host_syncs
    pm = mesh.gather_spans(pms)
    return new, t2n(pm)[:, lmap], syncs, lmap, mesh


@pytest.mark.parametrize('comp,snp', MESHES)
@pytest.mark.parametrize('form', ['shared', 'kdim', 'epoch',
                                  'materialized'])
def test_comp_outer_step_matches_jax(jax_steps, form, comp, snp):
    """One outer step of each state form on a (comp, snp) mesh equals
    vilma_tpu's unsharded step and its n_comp = 2 mesh's at
    tests/test_sharding.py's tolerances; the hyper_delta columns gather
    to vilma_tpu's; the host syncs are those of the port's unsharded
    step."""
    r = jax_steps[form]
    new, pm, syncs, _, mesh = _comp_step(r, form, comp, snp)
    for want in (r['jpm'], r['cpm']):
        np.testing.assert_allclose(pm, want, rtol=PM_RTOL, atol=PM_ATOL)
    for want in (float(r['jst'].elbo), r['celbo']):
        np.testing.assert_allclose(new.elbo, want, rtol=ELBO_RTOL)
    K = r['st'].hyper_delta.shape[1]
    hd = mesh.comp_cat([s.hyper_delta for s in new.shards], 1, K)[0]
    np.testing.assert_allclose(t2n(hd), np.asarray(r['jst'].hyper_delta),
                               rtol=1e-10)
    np.testing.assert_allclose(t2n(new.error_scaling),
                               np.asarray(r['jst'].error_scaling),
                               rtol=1e-9)
    unsharded = tengine.build_model_data(
        r['pr']['betas'], r['pr']['std_errs'],
        [tblocks.pack(r['pr']['factors'], r['pr']['indices'],
                      r['pr']['n'])] * r['pr']['P'],
        r['pr']['annotations'], r['pr']['covs'], scaled=False,
        scale_se=r['pr']['scale_se'], gwas_N=np.full(r['pr']['P'], 1e5),
        init_hg=np.full(r['pr']['P'], 0.3), device='cpu')
    tengine.host_syncs = 0
    tengine.outer_step(unsharded, state_to_torch(r['st']))
    assert syncs == tengine.host_syncs > 0


@pytest.mark.parametrize('form', ['shared', 'kdim', 'epoch',
                                  'materialized'])
def test_each_shard_holds_its_k_slice(jax_steps, form):
    """On a comp = 3 mesh of K = 4 components (uneven: 2, 1 and 1)
    every [K, ...] array of a shard, after a step, holds its slice
    alone; the [P, I] state and the epoch history are whole on each."""
    r = jax_steps[form]
    new, _, _, _, mesh = _comp_step(r, form, 3, 1)
    K = r['st'].hyper_delta.shape[1]
    assert K == 4
    for j, st in enumerate(new.shards):
        k = 2 if mesh.coords(j)[0] == 0 else 1
        assert st.hyper_delta.shape[1] == k
        if form == 'kdim':
            assert st.nat_mu.shape[0] == k
        elif form == 'materialized':
            assert st.vi_mu.shape[0] == st.vi_delta.shape[0] == k
            for f in dataclasses.fields(st.sigma):
                assert getattr(st.sigma, f.name).shape[0] == k
        else:
            assert st.nat_mu.dim() == 2
        if form == 'epoch':
            assert st.nat_hist.shape[1:] == st.nat_mu.shape
    with pytest.raises(AttributeError, match='split over the comp'):
        new.hyper_delta


def test_k_below_comp_raises():
    """A grid of fewer components than comp shards is refused, by
    build_model_data and by shard_data."""
    pr = _problem('shared')
    n, P = pr['n'], pr['P']
    tld = tblocks.pack(pr['factors'], pr['indices'], n)
    mesh = tmesh.make_mesh(1, n_comp=5, device='cpu')
    lmap, L, _ = talign.compute_layout([tld], n, n_shards=1)
    ld = talign.relayout_ld(tld, lmap, L, n_shards=1,
                            shards=list(mesh.snp_shards))
    rows = talign.relayout_rows
    with pytest.raises(ValueError, match='comp=5'):
        tengine.build_model_data(
            rows(pr['betas'], lmap, L), rows(pr['std_errs'], lmap, L,
                                             fill=1.0),
            [ld] * P, talign.relayout_annotations(pr['annotations'], lmap,
                                                  L),
            pr['covs'], scaled=False, scale_se=False,
            gwas_N=np.full(P, 1e5), init_hg=np.full(P, 0.3), device='cpu',
            mesh=mesh)
    plain = tengine.build_model_data(
        pr['betas'], pr['std_errs'], [tld] * P, pr['annotations'],
        pr['covs'], scaled=False, scale_se=False, gwas_N=np.full(P, 1e5),
        init_hg=np.full(P, 0.3), device='cpu')
    with pytest.raises(ValueError, match='comp=5'):
        tmesh.shard_data(dataclasses.replace(
            plain, ld=(tblocks.pack(pr['factors'], pr['indices'], n),)),
            mesh)


@pytest.mark.parametrize('form', ['shared', 'kdim', 'epoch',
                                  'materialized'])
def test_host_syncs_per_step_equal_under_comp(form):
    """MultiPopVI's fit on a comp = 2, snp = 2 mesh makes as many host
    syncs as the unsharded fit and reaches its posterior means."""
    pr = _problem(form)
    n, P = pr['n'], pr['P']
    tld = tblocks.pack(pr['factors'], pr['indices'], n)
    lmap, L, _ = talign.compute_layout([tld], n, n_shards=2)
    rows = talign.relayout_rows
    kw = dict(mixture_covs=pr['covs'], checkpoint=False, scaled=False,
              scale_se=pr['scale_se'] or form == 'epoch',
              gwas_N=np.full(P, 1e5), init_hg=np.full(P, 0.3), num_its=3,
              device='cpu')
    out = []
    for mesh in (None, tmesh.make_mesh(2, n_comp=2, device='cpu')):
        if mesh is None:
            args = dict(marginal_effects=pr['betas'],
                        std_errs=pr['std_errs'], ld_mats=[tld] * P,
                        annotations=pr['annotations'])
        else:
            ld = talign.relayout_ld(tld, lmap, L, n_shards=2,
                                    shards=list(mesh.snp_shards))
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
            np.random.seed(3)
            tengine.host_syncs = 0
            st = vi.optimize()
        finally:
            tengine._EPOCH_STATE_BYTES = old
        out.append((tengine.host_syncs, vi.real_posterior_mean(st),
                    vi.real_posterior_variance(st), vi.create_dump_dict(st)))
    assert out[0][0] == out[1][0] > 0
    for a, b in zip(out[1][1:3], out[0][1:3]):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-14)
    assert sorted(out[1][3]) == sorted(out[0][3])
    for key, want in out[0][3].items():
        np.testing.assert_allclose(out[1][3][key], want, rtol=1e-9,
                                   atol=1e-14, err_msg=key)


# ---------------------------------------------------------------------------
# the CLI and resume
# ---------------------------------------------------------------------------

def _cli_argv(case, out, flags):
    if flags == 'trait':
        schema, paths, extract, annot = case
        return ['fit', '--trait', '--ld-schema', schema,
                '--sumstats', ','.join(paths), '--extract', extract,
                '--annotations', annot, '--names', 'a,b,c,d',
                '--samplesizes', ','.join(['1e5'] * 4),
                '--init-hg', ','.join(['0.2'] * 4), '--seed', '3',
                '--num-its', '5', '-K', '1', '--learn-scaling',
                '--precision', 'f64', '--output', out]
    argv = _argv(case, out)
    return argv + (['--learn-scaling'] if flags == 'scale' else [])


@pytest.mark.parametrize('flags', ['plain', 'scale', 'trait'])
def test_cli_comp_matches_unsharded(tmp_path, flags):
    """A 5-step `fit --device cpu --mesh snp=2,comp=2` (shared state,
    --learn-scaling's kdim state, --trait of 4 traits: the materialized
    state) writes the unsharded port's files, member for member, at
    tests/test_cli_mesh.py's tolerance."""
    case = (_trait_case(str(tmp_path)) if flags == 'trait'
            else _write_case(str(tmp_path)))
    outs = {}
    for tag, extra in (('plain', []), ('comp', ['--mesh', 'snp=2,comp=2'])):
        outs[tag] = str(tmp_path / tag)
        tfrontend.main(_cli_argv(case, outs[tag], flags)
                       + ['--device', 'cpu'] + extra)
    _assert_estimates(outs['comp'], outs['plain'], rtol=CLI_RTOL,
                      atol=1e-10)
    got, want = np.load(outs['comp'] + '.npz'), np.load(outs['plain']
                                                          + '.npz')
    assert sorted(got.files) == sorted(want.files)
    for key in want.files:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], rtol=CLI_RTOL,
                                   atol=1e-10, err_msg=key)
    names = {tag: sorted(f[len(tag):] for f in os.listdir(tmp_path)
                         if f.startswith(tag + '.')) for tag in outs}
    assert names['comp'] == names['plain']


@pytest.mark.parametrize('writer', ['jax', 'torch'])
def test_comp_resumes_a_checkpoint(tmp_path, writer):
    """A --learn-scaling (kdim) checkpoint written by vilma_tpu or by the
    port resumes on a comp = 2, snp = 2 mesh as it resumes unsharded."""
    from vilma_tpu import frontend as jfrontend
    case = _write_case(str(tmp_path))
    base = _argv(case, str(tmp_path / 'w')) + ['--learn-scaling',
                                               '--checkpoint-freq', '2']
    if writer == 'jax':
        jfrontend.main(base)
    else:
        tfrontend.main(base + ['--device', 'cpu'])
    ckpt = str(tmp_path / 'w-checkpoint.4.npz')
    outs = {}
    for tag, extra in (('plain', []), ('comp', ['--mesh', 'snp=2,comp=2'])):
        outs[tag] = str(tmp_path / tag)
        argv = _argv(case, outs[tag]) + [
            '--learn-scaling', '--num-its', '2', '--load-checkpoint', ckpt,
            str(tmp_path / 'w.covariance.pkl'), '--device', 'cpu'] + extra
        tfrontend.main(argv)
    _assert_estimates(outs['comp'], outs['plain'], rtol=1e-9, atol=1e-14)
