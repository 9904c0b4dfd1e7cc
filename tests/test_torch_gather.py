"""The global-gather mesh layout of vilma_tpu_torch (ops/blocks.py
pack_gathered, parallel/alignment.deal_ld, the mesh's snp_gather and
snp_sum_span) on the CPU at float64: the LD ops of a gathered matrix on
an 8-shard host mesh against the unsharded matrix's, and one outer step
of the shared, kdim and epoch states on gathered (comp, snp) meshes
against the unsharded step, the variants padded to a multiple of the
snp shards."""
import numpy as np
import pytest
import torch

from vilma_tpu.inference import engine as jengine
from vilma_tpu.ops import blocks as jblocks
from vilma_tpu_torch.inference import engine as tengine
from vilma_tpu_torch.ops import blocks as tblocks
from vilma_tpu_torch.parallel import alignment as talign
from vilma_tpu_torch.parallel import mesh as tmesh

from tests.test_torch_parallel import (_factor, _jax_state, _step_problem,
                                       _transplant)
from tests.torch_parity import state_to_torch, t2n

# tests/test_sharding.py's tolerances, as the shard-local steps'
PM_RTOL, PM_ATOL, ELBO_RTOL = 1e-10, 1e-12, 1e-8


def _gathered_matrix(n_shards=8, seed=3):
    """(unsharded PackedLD over n_pad slots, the same matrix gathered over
    an n_shards CPU mesh, n, n_pad): blocks of 95-159 SNPs whose rows are
    scattered over a permuted genome, one with a hole, an uncovered run;
    n = 530 is no multiple of 8, and each size tier holds 2 blocks, fewer
    than the shards."""
    rng = np.random.default_rng(seed)
    n = 530
    order = rng.permutation(n)
    factors, indices = [], []
    for a, b in [(0, 96), (96, 256), (256, 356), (376, 530)]:
        keep = np.setdiff1d(np.arange(a, b), [130])
        factors.append(_factor(rng, keep.size))
        indices.append(order[keep])
    n_pad = -(-n // n_shards) * n_shards
    plain = tblocks.pack(factors, indices, n_pad)
    mesh = tmesh.make_mesh(n_shards, device='cpu')
    return plain, talign.deal_ld(plain, n_pad, mesh), n, n_pad


def test_deal_blocks_runs_per_tier():
    """Each size tier's blocks go to the shards in contiguous runs of
    ceil(B / N), in manifest order, as the JAX loader deals them."""
    sizes = [100, 200, 120, 300, 90, 70, 110, 250]
    owners = tblocks.deal_blocks(sizes, 3)
    # tier 128: positions 0, 2, 4, 5, 6 (runs of 2, the last short);
    # tier 256: 1, 7 (runs of 1, shard 2 gets none); tier 512: 3
    assert owners.tolist() == [0, 0, 0, 0, 1, 1, 2, 1]


@pytest.mark.parametrize('op', ['dot', 'dot_multi_3', 'dot_multi_9',
                                'diag', 'inverse_dot', 'ridge_inverse_dot'])
def test_gathered_ops_match_unsharded(op):
    """The ops of a gathered matrix on 8 co-located host shards equal the
    unsharded matrix's within 1e-12 of scale, span by span; the pad
    slots past n come out zero; the mesh counts the gather's and the
    sum's bytes."""
    plain, gathered, n, L = _gathered_matrix()
    assert gathered.layout == 'gather' and gathered.shard_count == 8
    assert gathered.rank == plain.rank and gathered.n == L == 536
    assert gathered.missing == plain.missing
    held = [sum(bk.num_blocks for bk in p.buckets) for p in gathered.shards]
    assert held == [2, 2, 0, 0, 0, 0, 0, 0]
    rng = np.random.default_rng(2)
    shape = (int(op[-1]), L) if op.startswith('dot_multi') else (L,)
    x = torch.as_tensor(rng.standard_normal(shape))
    x[..., n:] = 0
    parts = tblocks.split(gathered, x)
    mesh = gathered.comm
    mesh.traffic.update(gather_bytes=0, sum_bytes=0, gathers=0, sums=0)
    if op == 'diag':
        got, want = tblocks.diag(gathered), tblocks.diag(plain)
    elif op == 'ridge_inverse_dot':
        reg = torch.as_tensor(rng.uniform(0.5, 2.0, L))
        got = tblocks.ridge_inverse_dot(gathered, parts,
                                        tblocks.split(gathered, reg))
        want = tblocks.ridge_inverse_dot(plain, x, reg)
    else:
        fn = getattr(tblocks, op.rstrip('_39'))
        got, want = fn(gathered, parts), fn(plain, x)
    got = torch.cat(got, dim=-1).numpy()
    want = want.numpy()
    assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))
    assert np.all(got[..., n:] == 0)
    full = x.numel() * 8
    gathered_args = {'diag': 0, 'ridge_inverse_dot': 2}.get(op, 1)
    assert mesh.traffic == dict(gather_bytes=8 * gathered_args * full,
                                sum_bytes=8 * full,
                                gathers=gathered_args, sums=1)


def test_gathered_shard_refuses_a_span():
    """A gathered shard's ops take the full vector: given its span (as a
    shard-local path would give it), they raise."""
    _, gathered, _, L = _gathered_matrix()
    part = gathered.shards[0]
    for fn in (tblocks.dot, tblocks.inverse_dot):
        with pytest.raises(ValueError, match='slots for a matrix'):
            fn(part, torch.zeros(L // 8, dtype=torch.float64))


def _gathered_step(form, comp, snp):
    """One outer step of `form` from one point: unsharded in genome order
    and on a gathered (comp, snp) mesh of host shards. Returns (unsharded
    state and posterior mean, sharded state and gathered posterior mean,
    their host syncs, n)."""
    pr = _step_problem(form)
    n, P = pr['n'], pr['P']
    kw = dict(scaled=False, scale_se=pr['scale_se'],
              gwas_N=np.full(P, 1e5), init_hg=np.full(P, 0.3))
    st = _jax_state(form, jengine.build_model_data(
        pr['betas'], pr['std_errs'],
        [jblocks.pack(pr['factors'], pr['indices'], n)] * P,
        pr['annotations'], pr['covs'], **kw))
    tld = tblocks.pack(pr['factors'], pr['indices'], n)
    data1 = tengine.build_model_data(pr['betas'], pr['std_errs'], [tld] * P,
                                     pr['annotations'], pr['covs'],
                                     device='cpu', **kw)
    L = -(-n // snp) * snp
    lmap = np.arange(n)
    mesh = tmesh.make_mesh(snp, n_comp=comp, device='cpu')
    gl = talign.deal_ld(tld, L, mesh)
    rows = talign.relayout_rows
    data2 = tengine.build_model_data(
        rows(pr['betas'], lmap, L), rows(pr['std_errs'], lmap, L, fill=1.0),
        [gl] * P, talign.relayout_annotations(pr['annotations'], lmap, L),
        pr['covs'], device='cpu', mesh=mesh, **kw)
    syncs = []
    tengine.host_syncs = 0
    a, pm1 = tengine.outer_step(data1, state_to_torch(st))
    syncs.append(tengine.host_syncs)
    tengine.host_syncs = 0
    b, pm2 = tengine.outer_step(data2, tmesh.shard_state(
        state_to_torch(_transplant(st, lmap, L)), mesh))
    syncs.append(tengine.host_syncs)
    return a, t2n(pm1), b, t2n(mesh.gather_spans(pm2)), syncs, n


@pytest.mark.parametrize('comp,snp', [(1, 8), (2, 4)])
@pytest.mark.parametrize('form', ['shared', 'kdim', 'epoch'])
def test_gathered_outer_step_matches_unsharded(form, comp, snp):
    """One outer step of each compact state on a gathered mesh (8 snp
    shards; 2 comp by 4 snp, the K-split kernels' plain versions) equals
    the unsharded step at 1e-10: posterior means in the original order,
    the pad slots exactly zero, the ELBO and error scalings; the host
    syncs are the unsharded step's."""
    a, pm1, b, pm2, syncs, n = _gathered_step(form, comp, snp)
    np.testing.assert_allclose(pm2[:, :n], pm1, rtol=PM_RTOL, atol=PM_ATOL)
    assert np.all(pm2[:, n:] == 0)
    np.testing.assert_allclose(b.elbo, a.elbo, rtol=ELBO_RTOL)
    np.testing.assert_allclose(t2n(b.error_scaling), t2n(a.error_scaling),
                               rtol=1e-9)
    if form == 'epoch':
        assert b.nat_hist_n == a.nat_hist_n
    assert syncs[0] == syncs[1] > 0


def test_reference_api_on_sharded_matrices():
    """PackedLD's reference API on a gathered and on a shard-local
    matrix: `.dot`, `.inverse.dot`, `.diag()`, `.ridge_inverse_dot`,
    `.dot_i` and `.get_rank()` are the unsharded matrix's, span by span;
    the gathered matrix's `.matrix_power` too (the whole matrix's
    sequential offsets); an inverted one refuses what vilma_tpu's
    refuses."""
    plain, gathered, n, L = _gathered_matrix()
    rows = talign.relayout_rows
    lmap, SL, _ = talign.compute_layout([plain], L, n_shards=4)
    local = talign.relayout_ld(plain, lmap, SL, n_shards=4)
    rng = np.random.default_rng(6)
    x = rng.standard_normal(L)
    x[n:] = 0
    reg = rng.uniform(0.5, 2.0, L)
    # layout pads read regularizer 1 (as the engine's SE 1 gives)
    for ld, fwd in ((gathered, lambda v: v), (local, lambda v: rows(
            v, lmap, SL, fill=float(v is reg)))):
        def cat(parts, ld=ld, fwd=fwd):
            got = torch.cat(parts, dim=-1).numpy()
            return got if ld is gathered else got[lmap]

        def split(v, ld=ld, fwd=fwd):
            return tblocks.split(ld, torch.as_tensor(fwd(v)))

        X = torch.as_tensor(x)
        for got, want in (
                (cat(ld.dot(split(x))), plain.dot(X)),
                (cat(ld.inverse.dot(split(x))), plain.inverse.dot(X)),
                (cat(ld.diag()), plain.diag()),
                (cat(ld.ridge_inverse_dot(split(x), split(reg))),
                 plain.ridge_inverse_dot(X, torch.as_tensor(reg)))):
            want = want.numpy()
            assert np.max(np.abs(got - want)) <= 1e-12 * np.abs(want).max()
        i = int(np.flatnonzero(np.abs(plain.diag().numpy()) > 0)[0])
        slot = i if ld is gathered else int(lmap[i])
        np.testing.assert_allclose(
            ld.dot_i(torch.as_tensor(fwd(x)), slot), plain.dot_i(X, i),
            rtol=1e-12)
        assert ld.get_rank() == plain.get_rank()
        for method, args in (('dot_i', (X, 0)), ('diag', ()),
                             ('ridge_inverse_dot', (X, 1.0))):
            with pytest.raises(NotImplementedError):
                getattr(ld.inverse, method)(*args)
    got = torch.cat(gathered.matrix_power(0.5).dot(
        tblocks.split(gathered, torch.as_tensor(x))), dim=-1).numpy()
    want = plain.matrix_power(0.5).dot(torch.as_tensor(x)).numpy()
    assert np.max(np.abs(got - want)) <= 1e-12 * np.abs(want).max()


def test_gathered_cli_mmap_cache_and_resume(tmp_path):
    """The CLI's gathered fit on conflicting schemas (--mesh snp=2)
    through --mmap and a --factor-cache writes the unsharded --mmap
    fit's outputs (both take the reference's mmap RNG draws), and resumes
    an unsharded fit's checkpoint as the unsharded fit resumes it."""
    from tests.test_torch_cli import _read_tsv
    from tests.test_torch_parallel import conflicting_argv
    from vilma_tpu_torch import frontend as tfrontend

    argv = conflicting_argv(str(tmp_path))
    cpu, mesh = ['--device', 'cpu'], ['--mesh', 'snp=2']
    spill = ['--mmap', '--factor-cache', str(tmp_path / 'cache')]
    runs = {}
    for tag, extra in (('gathered_mmap', cpu + mesh + spill),
                       ('plain_mmap', cpu + spill),
                       ('plain', cpu + ['--checkpoint-freq', '2'])):
        runs[tag] = str(tmp_path / tag)
        tfrontend.main(argv(runs[tag]) + extra)
    ckpt = [runs['plain'] + '-checkpoint.2.npz',
            runs['plain'] + '.covariance.pkl']
    for tag, extra in (('resumed_plain', cpu), ('resumed_gathered',
                                                 cpu + mesh)):
        runs[tag] = str(tmp_path / tag)
        tfrontend.main(argv(runs[tag]) + extra + ['--load-checkpoint']
                       + ckpt)
    for got, want in (('gathered_mmap', 'plain_mmap'),
                      ('resumed_gathered', 'resumed_plain')):
        gh, g = _read_tsv(runs[got] + '.estimates.tsv')
        wh, w = _read_tsv(runs[want] + '.estimates.tsv')
        assert gh == wh
        for col in gh:
            if col.startswith('posterior'):
                np.testing.assert_allclose(np.array(g[col], dtype=float),
                                           np.array(w[col], dtype=float),
                                           rtol=1e-10, atol=1e-14,
                                           err_msg=f'{got} {col}')
            else:
                assert g[col] == w[col], (got, col)
