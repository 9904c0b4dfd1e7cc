"""The K-chunked shapes: vilma_tpu_torch at K > 128 mixture components
against vilma_tpu with its K-chunked route forced.

The JAX package takes its chunked route (engine._objective_chunked,
_delta_sums_chunked) above K = 128 once a [K, I] buffer exceeds its
budget; the port has no such route, because its kernels and their plain
versions take any K. These tests pin that the port computes what the
chunked route computes, on the shared [P, I] state and on the epoch
state:

* at float64, the objective, posterior means, LD-linked estimates and
  annotation sums to the chunked route's own equality tolerances
  (tests/test_chunked_k.py: 1e-10 relative objective, 1e-9 relative
  and 1e-12 absolute moments), and three outer steps;
* at float32, the port against that float64 result (not against the
  JAX package's float32 chunked entropy, which cancels): objective to
  5e-7 relative, posterior means and linked estimates to 2e-6 of their
  scale, annotation sums to 1.2e-5 relative. The port's float32
  readings here are within 4.5e-8, 1.8e-7, 2.3e-7 and 1.2e-6 of those
  (both states); the bands leave ~10x room.

_use_chunked is monkeypatched to force the route, as
tests/test_chunked_k.py does: VILMA_XLA_KI_CHUNK_BYTES=0 alone does not
force it below K = 129, and the chunk width is shrunk so that several
chunks and a padded one run.
"""
import dataclasses

import numpy as np
import pytest
import torch

from vilma_tpu.inference import engine as jengine
from vilma_tpu.utils import synthetic
from vilma_tpu_torch.inference import engine as tengine
from vilma_tpu_torch.ops.blocks import BlockBucket, PackedLD

from tests.torch_parity import data_to_torch, ld_to_torch, state_to_torch
from tests.torch_parity import t2n

K = 160            # > 128: the JAX package's chunked route
NUM_LOCI = 384


@pytest.fixture
def force_chunked(monkeypatch):
    monkeypatch.setattr(jengine, '_XLA_KI_CHUNK_BYTES', 0)
    monkeypatch.setattr(jengine, '_use_chunked', lambda *a: True)
    monkeypatch.setattr(jengine, '_chunk_kc', lambda *a: 48)
    # the fused route, where another test enabled it, would bypass the
    # chunked one
    monkeypatch.setattr(jengine.blocks_mod, 'pallas_flags',
                        lambda: (False, False))
    traced = []
    real = jengine._objective_chunked

    def counted(*a, **k):
        traced.append(1)
        return real(*a, **k)
    monkeypatch.setattr(jengine, '_objective_chunked', counted)
    jengine.outer_step.clear_cache()
    yield
    jengine.outer_step.clear_cache()
    assert traced, 'the JAX package never took its chunked route'


def _problem(epoch):
    data = synthetic.synthetic_problem(num_loci=NUM_LOCI, num_pops=2,
                                       num_components=K, block_size=32,
                                       num_annotations=3, scale_se=epoch,
                                       seed=4)
    st = synthetic.synthetic_state(data, seed=9, compact=True,
                                   epoch_b=4 if epoch else None)
    if epoch:
        # a live epoch under an older scaling, and a non-unit current one
        rng = np.random.default_rng(2)
        hist = np.zeros((4, 2, NUM_LOCI))
        hist[0] = rng.standard_normal((2, NUM_LOCI)) * 1e-2
        st = dataclasses.replace(
            st, nat_hist=hist, nat_hist_c=np.array([0.6, 0, 0, 0]),
            nat_hist_scale=np.array([[1.1, 0.9]] + [[1., 1.]] * 3),
            nat_hist_n=np.asarray(1, dtype=np.int32),
            error_scaling=np.array([0.95, 1.08]))
        st = jax_state(st)
    return data, st


def jax_state(st):
    import jax.numpy as jnp
    return dataclasses.replace(
        st, **{f.name: jnp.asarray(getattr(st, f.name))
               for f in dataclasses.fields(st)
               if isinstance(getattr(st, f.name), np.ndarray)})


def _jax_eval(data, st):
    if st.nat_hist is not None:
        obj, pm, lk = jengine._objective_epoch(data, st, st.nat_mu,
                                               st.nat_hist_c, st.hyper_delta)
        sums = jengine._delta_sums_chunked(data, st, st.nat_mu,
                                           st.hyper_delta,
                                           hist_c=st.nat_hist_c)
    else:
        obj, pm, lk = jengine._objective_compact(data, st, st.nat_mu,
                                                 st.hyper_delta)
        sums = jengine._delta_sums_chunked(data, st, st.nat_mu,
                                           st.hyper_delta)
    return float(obj), np.asarray(pm), np.asarray(lk), np.asarray(sums)


def _port_eval(tdata, tst):
    params = tengine._params(tst)
    obj, pm, lk = tengine._objective(tdata, tst, params, tst.hyper_delta)
    sums = tengine._fused(tdata, tst, params, tst.hyper_delta, sums=True)
    return float(obj), t2n(pm), t2n(lk), t2n(sums)


def _f32(x):
    return x.float() if torch.is_tensor(x) and x.is_floating_point() else x


def _to_f32(data, st):
    """The port's data and state rounded to float32 (the card's dtype)."""
    lds = tuple(PackedLD(
        buckets=tuple(BlockBucket(**{f.name: _f32(getattr(bk, f.name))
                                     for f in dataclasses.fields(bk)})
                      for bk in ld.buckets),
        n=ld.n, has_diag=ld.has_diag, rank=ld.rank, missing=ld.missing)
        for ld in data.ld)
    data = dataclasses.replace(
        data, ld=lds, **{f.name: _f32(getattr(data, f.name))
                         for f in dataclasses.fields(data)
                         if torch.is_tensor(getattr(data, f.name))})
    st = dataclasses.replace(
        st, **{f.name: _f32(getattr(st, f.name))
               for f in dataclasses.fields(st)
               if torch.is_tensor(getattr(st, f.name))})
    return data, st


def _assert_close(got, want, obj_rtol, mom_rtol, mom_atol, sums_rtol):
    np.testing.assert_allclose(got[0], want[0], rtol=obj_rtol)
    for j in (1, 2):
        np.testing.assert_allclose(got[j], want[j], rtol=mom_rtol,
                                   atol=mom_atol * np.abs(want[j]).max())
    np.testing.assert_allclose(got[3], want[3], rtol=sums_rtol, atol=0)


@pytest.mark.parametrize('epoch', [False, True], ids=['shared', 'epoch'])
def test_port_matches_chunked_route_f64(epoch, force_chunked):
    data, st = _problem(epoch)
    want = _jax_eval(data, st)
    got = _port_eval(data_to_torch(data), state_to_torch(st))
    _assert_close(got, want, 1e-10, 1e-9, 1e-12, 1e-9)


@pytest.mark.parametrize('epoch', [False, True], ids=['shared', 'epoch'])
def test_port_f32_within_band_of_chunked_f64(epoch, force_chunked):
    data, st = _problem(epoch)
    want = _jax_eval(data, st)
    got = _port_eval(*_to_f32(data_to_torch(data), state_to_torch(st)))
    _assert_close(got, want, 5e-7, 0, 2e-6, 1.2e-5)


@pytest.mark.parametrize('epoch', [False, True], ids=['shared', 'epoch'])
def test_port_trajectory_matches_chunked_route(epoch, force_chunked):
    """Three outer steps: the chunked route feeds the line search, the
    hyper-delta update and (epoch state) the EM."""
    data, st = _problem(epoch)
    tdata, tst = data_to_torch(data), state_to_torch(st)
    for _ in range(3):
        st, jpm = jengine.outer_step(data, st, line_search_rate=2.0)
        tst, tpm = tengine.outer_step(tdata, tst, line_search_rate=2.0)
        np.testing.assert_allclose(tst.elbo, float(st.elbo), rtol=1e-9)
        jpm = np.asarray(jpm)
        np.testing.assert_allclose(t2n(tpm), jpm, rtol=1e-8,
                                   atol=1e-11 * np.abs(jpm).max())
    if epoch:
        assert tst.nat_hist_n == int(st.nat_hist_n)


@pytest.mark.parametrize('num_pops', [1, 2, 3])
def test_initialization_in_snp_chunks(num_pops, monkeypatch):
    """The initialization forms its [K, I] terms in SNP chunks of
    _INIT_CHUNK_BYTES: shrunk so that 7 chunks run, the last a partial
    one, it equals vilma_tpu's one-pass initialization at float64 (hyper
    delta to 1e-12 relative, the summed chunks reordering its annotation
    sums; natural mean to 1e-12 relative and 1e-14 of its scale)."""
    import jax.numpy as jnp
    from vilma_tpu.models import sigma as jsigma
    data = synthetic.synthetic_problem(num_loci=NUM_LOCI, num_pops=num_pops,
                                       num_components=K, block_size=32,
                                       num_annotations=3, seed=4)
    fake = np.random.default_rng(5).standard_normal((num_pops, NUM_LOCI))
    es = jnp.ones(num_pops)
    jsig = jsigma.make_summaries(data.mixture_prec, data.log_det,
                                 jengine._diag_term(data, es))
    _, _, jhyper, _, jnat = jengine.initialize_from_fake_mu(
        data, jsig, es, jnp.asarray(fake))
    chunk_i = 56
    monkeypatch.setattr(tengine, '_INIT_CHUNK_BYTES', K * 8 * chunk_i)
    assert -(-NUM_LOCI // chunk_i) == 7 and NUM_LOCI % chunk_i
    hyper, nat = tengine.initialize_from_fake_mu(
        data_to_torch(data), torch.ones(num_pops, dtype=torch.float64),
        torch.as_tensor(fake))
    np.testing.assert_allclose(t2n(hyper), np.asarray(jhyper), rtol=1e-12)
    jnat = np.asarray(jnat)
    np.testing.assert_allclose(t2n(nat), jnat, rtol=1e-12,
                               atol=1e-14 * np.abs(jnat).max())


# ---------------------------------------------------------------------------
# the [K, ...] output chunks (fit's streamed .npz members)
# ---------------------------------------------------------------------------

# chunk sizes that divide neither K = 160 nor I = 384: 4 component chunks
# (the last of 10) and 4 variant chunks (the last of 84)
CHUNK_K, CHUNK_I = 50, 100
# f64, the same algebra in both packages: 1e-12 of each array's scale
CHUNK_TOL = 1e-12


def _chunk_problem(form):
    """(JAX data, JAX state) of a state form at K = 160: the shared and
    epoch points of _problem, or a kdim [K, P, I] point."""
    if form != 'kdim':
        return _problem(form == 'epoch')
    data = synthetic.synthetic_problem(num_loci=NUM_LOCI, num_pops=2,
                                       num_components=K, block_size=32,
                                       num_annotations=3, scale_se=True,
                                       seed=4)
    return data, synthetic.synthetic_state(data, seed=9, compact=True)


def _vi_inputs(data):
    """MultiPopVI's inputs for `data`'s fit (genome order)."""
    A = data.num_annotations
    return dict(marginal_effects=np.asarray(data.marginal_effects),
                std_errs=np.asarray(data.std_errs),
                annotations=np.eye(A)[np.asarray(data.annotations)],
                mixture_covs=np.linalg.inv(np.asarray(data.mixture_prec)),
                checkpoint=False, scale_se=data.scale_se,
                gwas_N=np.full(2, 1e5), init_hg=np.full(2, 0.3), num_its=1)


def _chunks(vi, st):
    """The three streams at CHUNK_K and CHUNK_I, each a list of host
    arrays."""
    return dict(
        vi_mu=[np.asarray(c) for c in vi.vi_mu_chunks(st, chunk_k=CHUNK_K)],
        vi_sigma=[np.asarray(c) for c in vi.vi_sigma_chunks(chunk_k=CHUNK_K)],
        vi_delta=[np.asarray(c)
                  for c in vi.vi_delta_chunks(st, chunk_i=CHUNK_I)])


def _assert_chunks(got, want):
    for key, parts in want.items():
        assert [p.shape for p in got[key]] == [p.shape for p in parts], key
        _assert_scaled(np.concatenate(got[key]), np.concatenate(parts), key)


def _assert_scaled(got, want, key):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=CHUNK_TOL * np.abs(want).max(),
                               err_msg=key)


@pytest.fixture(scope='module')
def output_chunks():
    """Per state form: the JAX package's streams and its whole vi_sigma,
    and the port's streams and materialized dump, of one point."""
    out = {}
    for form in ('shared', 'kdim', 'epoch'):
        data, st = _chunk_problem(form)
        kw = _vi_inputs(data)
        jvi = jengine.MultiPopVI(ld_mats=[data.ld[0]] * 2, **kw)
        jvi.state = st
        tld = ld_to_torch(data.ld[0])
        tvi = tengine.MultiPopVI(ld_mats=[tld, tld], dtype=torch.float64,
                                 device='cpu', **kw)
        tst = state_to_torch(st)
        tvi.state = tst
        out[form] = dict(data=data, st=st, kw=kw, tld=tld,
                         jax=_chunks(jvi, st), jax_sigma=jvi.vi_sigma,
                         port=_chunks(tvi, tst),
                         dump=tvi.create_dump_dict(tst))
    return out


@pytest.mark.parametrize('form', ['shared', 'kdim', 'epoch'])
def test_output_chunks_match_jax(output_chunks, form):
    """vi_mu, vi_sigma and vi_delta streamed in chunks that divide
    neither K nor I: the same chunk shapes as the JAX package's and,
    joined, its arrays within 1e-12 of scale."""
    r = output_chunks[form]
    assert len(r['port']['vi_mu']) == len(r['port']['vi_sigma']) == 4
    assert len(r['port']['vi_delta']) == 4
    assert r['port']['vi_mu'][-1].shape == (K % CHUNK_K, 2, NUM_LOCI)
    assert r['port']['vi_delta'][-1].shape == (NUM_LOCI % CHUNK_I, K)
    _assert_chunks(r['port'], r['jax'])


@pytest.mark.parametrize('form', ['shared', 'kdim', 'epoch'])
def test_output_chunks_join_to_the_materialized_state(output_chunks, form):
    """The joined chunks equal the port's materialized outputs
    (create_dump_dict: vi_mu [K, P, I], vi_delta [I, K]) and the JAX
    package's whole vi_sigma [K, P, P, I]."""
    r = output_chunks[form]
    for key in ('vi_mu', 'vi_delta'):
        _assert_scaled(np.concatenate(r['port'][key]), r['dump'][key], key)
    _assert_scaled(np.concatenate(r['port']['vi_sigma']),
                   np.asarray(r['jax_sigma']), 'vi_sigma')


@pytest.mark.parametrize('form', ['shared', 'kdim', 'epoch'])
def test_output_chunks_under_comp(output_chunks, form):
    """At --mesh comp=2,snp=2 on co-located CPU shards (the shard-local
    layout, out_index in the original order; K = 160 split 80 / 80, so
    the component chunks [50, 100) and [100, 150) cross the slices) the
    streams equal the unsharded fit's chunk for chunk."""
    from tests.test_torch_parallel import _transplant
    from vilma_tpu_torch.parallel import alignment as talign
    from vilma_tpu_torch.parallel import mesh as tmesh
    r = output_chunks[form]
    kw, tld = dict(r['kw']), r['tld']
    mesh = tmesh.make_mesh(2, n_comp=2, device='cpu')
    lmap, L, ok = talign.compute_layout([tld], NUM_LOCI, n_shards=2)
    assert ok and L > NUM_LOCI
    rows = talign.relayout_rows
    ld = talign.relayout_ld(tld, lmap, L, n_shards=2,
                            shards=list(mesh.snp_shards))
    kw.update(marginal_effects=rows(kw['marginal_effects'], lmap, L),
              std_errs=rows(kw['std_errs'], lmap, L, fill=1.0),
              annotations=talign.relayout_annotations(kw['annotations'],
                                                      lmap, L))
    vi = tengine.MultiPopVI(ld_mats=[ld, ld], dtype=torch.float64,
                            device='cpu', mesh=mesh, out_index=lmap, **kw)
    st = tmesh.shard_state(state_to_torch(_transplant(r['st'], lmap, L)),
                           mesh)
    vi.state = st
    assert [s.hyper_delta.shape[1] for s in st.shards] == [80] * 4
    _assert_chunks(_chunks(vi, st), r['port'])
