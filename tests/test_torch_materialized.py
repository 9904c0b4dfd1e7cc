"""The port's materialized path (fits of P >= 4 cohorts or traits) against
vilma_tpu at float64 on the CPU, from the same numpy inputs carried
across by vilma_tpu_torch.convert: the generic P x P sigma algebra
(Cholesky, in I-chunks) at rtol 1e-12, materialized outer steps with and
without the error-scaling EM, MultiPopVI.optimize, a CLI `fit --trait`
of 4 traits, a resume of a materialized checkpoint written by either
package, and blocks.dot_multi over more cohorts than one kernel launch
takes."""
import os

import numpy as np
import pytest
import torch

from vilma_tpu import frontend as jfrontend
from vilma_tpu.inference import engine as jengine
from vilma_tpu.models import sigma as jsigma
from vilma_tpu.ops import blocks as jblocks
from vilma_tpu.utils import synthetic
from vilma_tpu_torch import frontend as tfrontend
from vilma_tpu_torch.inference import engine as tengine
from vilma_tpu_torch.models import sigma as tsigma
from vilma_tpu_torch.ops import blocks as tblocks
from vilma_tpu_torch.ops.cuda import block_matvec as tbm

from tests.test_torch_cli import _read_tsv, _write_case
from tests.torch_parity import data_to_torch, ld_to_torch, state_to_torch
from tests.torch_parity import t2n

# the band of tests/test_engine_edges.py's chunked-sigma test
RTOL, ATOL = 1e-12, 1e-14


def _close(got, want, rtol=RTOL, scale_atol=ATOL):
    want = np.asarray(want)
    np.testing.assert_allclose(
        t2n(got) if isinstance(got, torch.Tensor) else np.asarray(got),
        want, rtol=rtol, atol=scale_atol * max(np.abs(want).max(), 1e-300))


def _sigma_inputs(P, K=6, I=37, seed=0):
    rng = np.random.default_rng(seed + P)
    a = rng.standard_normal((K, P, P))
    return dict(prec=a @ np.swapaxes(a, 1, 2) + P * np.eye(P),
                dterm=rng.uniform(0.0, 3.0, (P, I)),
                x=rng.standard_normal((K, P, I)),
                delta=rng.uniform(0.1, 1.0, (K, I)),
                log_det=rng.standard_normal(K))


def _sigma_outputs(mod, x, conv):
    x = {k: conv(v) for k, v in x.items()}
    s = mod.make_summaries(x['prec'], x['log_det'], x['dterm'])
    return dict(apply=mod.apply_sigma(x['prec'], x['dterm'], x['x']),
                log_det_sigma=s.log_det_sigma,
                sigma_summary=s.sigma_summary, diag=s.diag,
                matches=s.matches,
                weighted=mod.sigma_weighted_sum(x['prec'], x['dterm'],
                                                x['delta']),
                dense=mod.materialize_sigma(x['prec'], x['dterm']))


@pytest.mark.parametrize('P', [4, 5])
def test_generic_sigma_matches_jax(P, monkeypatch):
    """apply_sigma, make_summaries, sigma_weighted_sum and
    materialize_sigma at P = 4 and 5 equal the JAX package's LU route;
    chunks of 5 SNPs (a ragged tail of 2) give the same bits as one
    chunk."""
    x = _sigma_inputs(P)
    want = _sigma_outputs(jsigma, x, np.asarray)
    whole = _sigma_outputs(tsigma, x, torch.as_tensor)
    K = x['prec'].shape[0]
    monkeypatch.setattr(tsigma, '_GENERIC_CHUNK_BYTES', K * P * P * 8 * 5)
    assert tsigma._chunk_len(torch.as_tensor(x['prec']), 37) == 5
    chunked = _sigma_outputs(tsigma, x, torch.as_tensor)
    for name, value in want.items():
        _close(whole[name], value)
        assert torch.equal(chunked[name], whole[name]), name


def test_generic_sigma_refuses_a_block_that_is_not_positive_definite():
    """A precision block whose Cholesky factorization fails raises; a
    trial of the line search defers the count to its own fetch."""
    x = _sigma_inputs(4)
    prec = torch.as_tensor(x['prec'])
    dterm = torch.as_tensor(x['dterm'])
    dterm[2, 7] = -1e6
    with pytest.raises(torch.linalg.LinAlgError, match='^6 precision'):
        tsigma.make_summaries(prec, torch.zeros(6, dtype=torch.float64),
                              dterm)
    failures = []
    tsigma.apply_sigma(prec, dterm, torch.as_tensor(x['x']), failures)
    assert int(sum(failures)) == 6        # one per component
    with pytest.raises(NotImplementedError, match='P <= 3'):
        tsigma.compact_exprs(prec, dterm, dterm)


@pytest.mark.parametrize('P', [2, 3])
def test_dense_sigma_of_a_block_not_positive_definite_at_p3(P):
    """materialize_sigma for P <= 3 inverts each block as the JAX package
    does, so a block that is not positive definite but has a positive
    determinant (which the grid's slogdet check admits) gives its inverse
    rather than a raise."""
    prec = np.tile(np.diag([-2.0, -3.0, 5.0][:P]), (2, 1, 1))
    prec[1] += 0.1
    dterm = np.linspace(0.5, 1.0, 7)[None, :] * np.ones((P, 1))
    want = jsigma.materialize_sigma(prec, dterm)
    got = tsigma.materialize_sigma(torch.as_tensor(prec),
                                   torch.as_tensor(dterm))
    _close(got, want)


def _kernel_inputs(P, K=300, I=64, A=3, seed=0):
    rng = np.random.default_rng(seed + P)
    delta = rng.uniform(0.1, 1.0, (K, I))
    delta /= delta.sum(axis=0, keepdims=True)
    hyper = rng.uniform(0.1, 1.0, (A, K))
    hyper /= hyper.sum(axis=1, keepdims=True)
    ann = rng.integers(0, A, I).astype(np.int32)
    ann[::9] = A                                  # pad slots
    a = rng.standard_normal((K, P, P))
    return dict(vi_mu=rng.standard_normal((K, P, I)) * 1e-2,
                nat_mu=rng.standard_normal((K, P, I)),
                delta=delta, hyper=hyper, ann=ann,
                prec=a @ np.swapaxes(a, 1, 2) + P * np.eye(P),
                log_det=rng.standard_normal(K),
                diag=rng.uniform(0.1, 1.0, (K, P, I)),
                mean=rng.standard_normal((P, I)) * 1e-2,
                ki=rng.standard_normal((K, I)),
                nat_k1=rng.standard_normal((K - 1, I)) * 3, A=A)


# the ops/kernels.py helpers the materialized path runs on [K, P, I] and
# [K, I] arrays
MATERIALIZED_KERNELS = {
    'fast_posterior_mean': lambda m, a, x: m.fast_posterior_mean(
        a(x['vi_mu']), a(x['delta'])),
    'fast_pmv': lambda m, a, x: m.fast_pmv(
        a(x['mean']), a(x['vi_mu']), a(x['delta']), a(x['diag'])),
    'fast_inner_product_comp': lambda m, a, x: m.fast_inner_product_comp(
        a(x['vi_mu']), a(x['prec']), a(x['delta'])),
    'sum_annotations': lambda m, a, x: m.sum_annotations(
        a(x['delta']), a(x['ann']), x['A']),
    'fast_delta_kl': lambda m, a, x: m.fast_delta_kl(
        a(x['delta']), a(x['hyper']), a(x['ann'])),
    'fast_vi_delta_grad': lambda m, a, x: m.fast_vi_delta_grad(
        a(x['hyper']), a(x['log_det']), a(x['ann'])),
    'fast_invert_nat_vi_delta': lambda m, a, x: m.fast_invert_nat_vi_delta(
        a(x['vi_mu']), a(x['nat_mu']), a(x['ki']), a(x['nat_k1'])),
}


@pytest.mark.parametrize('name', sorted(MATERIALIZED_KERNELS))
@pytest.mark.parametrize('P', [4, 5])
def test_materialized_kernels_match_jax(name, P):
    """The ops/kernels.py helpers of the materialized path at P = 4 and
    5 and K = 300 equal vilma_tpu/ops/kernels.py's."""
    from vilma_tpu.ops import kernels as jk
    from vilma_tpu_torch.ops import kernels as tk
    x = _kernel_inputs(P)
    fn = MATERIALIZED_KERNELS[name]
    want = np.asarray(fn(jk, np.asarray, x))
    got = fn(tk, torch.as_tensor, x)
    assert tuple(got.shape) == want.shape
    _close(got, want)


def _state_close(tst, jst):
    _close(tst.vi_mu, jst.vi_mu, 1e-8, 1e-9)
    _close(tst.vi_delta, jst.vi_delta, 1e-8, 1e-9)
    _close(tst.hyper_delta, jst.hyper_delta, 1e-7, 1e-10)
    _close(tst.error_scaling, jst.error_scaling, 1e-10)
    assert abs(tst.elbo - float(jst.elbo)) <= 1e-8 * abs(float(jst.elbo))
    assert np.isclose(tst.L[0], float(jst.L[0]), rtol=1e-12)
    assert tst.num_err == int(jst.num_err) == 0


@pytest.mark.parametrize('P', [2, 4])
@pytest.mark.parametrize('scale_se', [False, True])
def test_materialized_outer_steps_match_jax(P, scale_se):
    """Three outer steps of a materialized state (line searches, beta
    loops, hyper-delta updates and, with scale_se, the error-scaling EM,
    which fires at the third step) track the JAX engine; the host loop
    synchronizes once per objective it reads: each line-search trial's,
    each step's hyper-delta evaluation, the first step's start (every
    later step starts from the state's record of its last evaluation)
    and the EM's re-evaluation."""
    data = synthetic.synthetic_problem(num_loci=32, num_pops=P,
                                       num_components=4, block_size=16,
                                       num_annotations=2, seed=P,
                                       scale_se=scale_se)
    st = synthetic.synthetic_state(data, seed=1)
    tdata, tst = data_to_torch(data), state_to_torch(st)
    assert tst.nat_mu is None
    syncs, trials = tengine.host_syncs, tengine.trials
    for _ in range(3):
        st, pm_j = jengine.outer_step(data, st, line_search_rate=2.0)
        tst, pm_t = tengine.outer_step(tdata, tst)
        _close(pm_t, pm_j, 1e-8, 1e-8)
    assert tengine.host_syncs - syncs == (tengine.trials - trials + 3 + 1
                                          + int(scale_se))
    _state_close(tst, st)
    for name in ('log_det_sigma', 'diag', 'matches', 'sigma_summary'):
        _close(getattr(tst.sigma, name), getattr(st.sigma, name), 1e-9)
    moved = not np.allclose(t2n(tst.error_scaling), 1.0)
    assert moved == scale_se


def _scheme_inputs(num_pops, num_comps, n=48, seed=0):
    """The seeded setting of tests/test_engine_edges.py::_scheme (AR(1)
    LD of rho 0.5, K components of random correlation), here in two
    blocks."""
    rng = np.random.default_rng(seed)
    idx = np.abs(np.subtract.outer(np.arange(n // 2), np.arange(n // 2)))
    ld = 0.5 ** idx
    packed = jblocks.from_dense_blocks(
        [ld, ld], [np.arange(n // 2), np.arange(n // 2, n)], n)
    se = rng.uniform(0.02, 0.08, (num_pops, n))
    betas = rng.standard_normal((num_pops, n)) * 0.05
    scales = np.exp(np.linspace(np.log(1e-4), np.log(1e-2), num_comps))
    covs = []
    for k in range(num_comps):
        a = rng.standard_normal((num_pops, num_pops))
        c = 0.2 * (a @ a.T) + num_pops * np.eye(num_pops)
        d = 1 / np.sqrt(np.diag(c))
        covs.append(scales[k] * (c * np.outer(d, d)))
    return dict(marginal_effects=betas, std_errs=se, mixture_covs=covs,
                annotations=np.ones((n, 1)), scaled=False,
                gwas_N=np.full(num_pops, 1e4),
                init_hg=np.full(num_pops, 0.3)), packed


def _both_schemes(num_pops, num_comps, num_its, tmp, scale_se=False,
                  checkpoint_freq=-1):
    kw, packed = _scheme_inputs(num_pops, num_comps)
    common = dict(kw, checkpoint=checkpoint_freq > 0,
                  checkpoint_freq=checkpoint_freq, scale_se=scale_se,
                  num_its=num_its)
    jvi = jengine.MultiPopVI(ld_mats=[packed] * num_pops,
                             output=os.path.join(tmp, 'jax'), **common)
    tvi = tengine.MultiPopVI(ld_mats=[ld_to_torch(packed)] * num_pops,
                             output=os.path.join(tmp, 'torch'),
                             device='cpu', **common)
    return jvi, tvi


def _outputs_close(tvi, tst, jvi, jst):
    assert tst.nat_mu is None and jst.nat_mu is None
    _state_close(tst, jst)
    _close(tvi.real_posterior_mean(tst), jvi.real_posterior_mean(jst),
           1e-8, 1e-9)
    _close(tvi.real_posterior_variance(tst),
           jvi.real_posterior_variance(jst), 1e-8, 1e-9)
    assert np.isclose(tvi.elbo_value(tst), jvi.elbo_value(jst),
                      rtol=1e-10)


@pytest.mark.parametrize('scale_se', [False, True])
def test_optimize_p4_matches_jax(scale_se, tmp_path):
    """MultiPopVI.optimize at P = 4 (initialization from the seeded
    jitter and 12 steps, the first 10 never converging) against the JAX
    package's, with and without --learn-scaling; the dumped arrays
    agree too."""
    jvi, tvi = _both_schemes(4, 3, 12, str(tmp_path), scale_se)
    np.random.seed(6)
    jst = jvi.optimize()
    np.random.seed(6)
    tst = tvi.optimize()
    assert not tvi._compact and not tvi._epoch
    _outputs_close(tvi, tst, jvi, jst)
    tdump, jdump = tvi.create_dump_dict(tst), jvi.create_dump_dict(jst)
    assert sorted(tdump) == sorted(jdump)
    for key in jdump:
        _close(tdump[key], jdump[key], 1e-8, 1e-9)


@pytest.mark.parametrize('writer', ['jax', 'torch'])
def test_resume_p4_materialized_checkpoint(writer, tmp_path):
    """A P = 4 checkpoint, written by either package after 5 steps,
    resumes in both to the same trajectory (3 more steps)."""
    jvi, tvi = _both_schemes(4, 3, 6, str(tmp_path), checkpoint_freq=5)
    np.random.seed(6)
    (jvi if writer == 'jax' else tvi).optimize()
    path = os.path.join(str(tmp_path), f'{writer}-checkpoint.5.npz')
    jvi, tvi = _both_schemes(4, 3, 3, str(tmp_path))
    jst = jvi.optimize(np.load(path))
    tst = tvi.optimize(np.load(path))
    _outputs_close(tvi, tst, jvi, jst)


TRAITS = 4


def _trait_case(root, seed=0):
    """Phase-4-style inputs of tests/test_torch_cli.py (a three-block
    numpy schema, an extract list with an off-panel variant, an
    annotation file) with TRAITS traits' sumstats on the one panel."""
    schema, _, extract, annot = _write_case(root, seed)
    with open(extract) as fh:
        rows = [line.split() for line in fh][1:-1]
    rng = np.random.default_rng(seed + 1)
    paths = []
    for t in range(TRAITS):
        se = rng.uniform(0.01, 0.05, len(rows))
        beta = rng.standard_normal(len(rows)) * se * 2
        path = os.path.join(root, f'trait{t}.tsv')
        with open(path, 'w') as fh:
            fh.write('ID\tA1\tA2\tBETA\tSE\n')
            for i, (vid, a1, a2) in enumerate(rows):
                if i != 11:              # one missing row, shared
                    fh.write(f'{vid}\t{a1}\t{a2}\t{float(beta[i])!r}\t'
                             f'{float(se[i])!r}\n')
        paths.append(path)
    return schema, paths, extract, annot


def test_cli_trait_four_traits_matches_jax(tmp_path):
    """`fit --trait` with 4 traits on one panel (the -K 1 grid, 33
    components, --learn-scaling): the .npz and .estimates.tsv equal
    vilma_tpu's; the objective's matvec takes the 4 traits in one pass
    over the shared panel (C = 4)."""
    schema, paths, extract, annot = _trait_case(str(tmp_path))
    argv = ['fit', '--trait', '--ld-schema', schema,
            '--sumstats', ','.join(paths), '--extract', extract,
            '--annotations', annot, '--names', 'a,b,c,d',
            '--samplesizes', ','.join(['1e5'] * TRAITS),
            '--init-hg', ','.join(['0.2'] * TRAITS), '--seed', '3',
            '--num-its', '4', '-K', '1', '--learn-scaling',
            '--precision', 'f64']
    jout, tout = str(tmp_path / 'jax'), str(tmp_path / 'torch')
    jfrontend.main(argv + ['--output', jout])
    seen = []
    real = tbm.bucket_matvec_multi_plain

    def counted(u, s, d, x):
        seen.append(x.shape[1])
        return real(u, s, d, x)

    tbm.bucket_matvec_multi_plain = counted
    try:
        tfrontend.main(argv + ['--output', tout, '--device', 'cpu'])
    finally:
        tbm.bucket_matvec_multi_plain = real
    # the set-up's products run per cohort, the objective's on all four
    assert TRAITS in seen and set(seen) == {1, TRAITS}
    jz, tz = np.load(jout + '.npz'), np.load(tout + '.npz')
    assert sorted(tz.files) == sorted(jz.files)
    assert tz['vi_mu'].shape == (33, TRAITS, jz['vi_mu'].shape[2])
    for key in jz.files:
        _close(tz[key], jz[key], 1e-8, 1e-9)
    jh, jcols = _read_tsv(jout + '.estimates.tsv')
    th, tcols = _read_tsv(tout + '.estimates.tsv')
    assert th == jh
    for h in jh:
        if h.startswith('posterior'):
            _close(np.array(tcols[h], dtype=float),
                   np.array(jcols[h], dtype=float), 1e-8, 1e-9)
        else:
            assert tcols[h] == jcols[h], h


@pytest.mark.parametrize('C', [4, 9])
def test_dot_multi_groups_of_eight_match_jax(C):
    """dot_multi of C cohorts on one panel equals vilma_tpu's; the port
    hands the kernel groups of at most 8 (9 = 8 + 1: two launches)."""
    ld = synthetic.synthetic_ld(200, 64, rank_frac=0.5, seed=C)
    x = np.random.default_rng(C).standard_normal((C, 200))
    seen = []
    real = tbm.bucket_matvec_multi_plain

    def counted(u, s, d, xb):
        seen.append(xb.shape[1])
        return real(u, s, d, xb)

    tbm.bucket_matvec_multi_plain = counted
    try:
        got = tblocks.dot_multi(ld_to_torch(ld), torch.as_tensor(x))
    finally:
        tbm.bucket_matvec_multi_plain = real
    _close(got, jblocks.dot_multi(ld, x), 1e-12, 1e-14)
    nb = len(ld.buckets)
    assert seen == ([4] * nb if C == 4 else [8, 1] * nb)
