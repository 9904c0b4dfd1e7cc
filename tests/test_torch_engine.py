"""The port's slice-A engine (vilma_tpu_torch.inference.engine) against
vilma_tpu.inference.engine at float64 on the CPU: model set-up,
initialization, the compact objective, six outer steps and the derived
outputs, from the same numpy inputs."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vilma_tpu.inference import engine as jengine
from vilma_tpu.models import sigma as jsigma
from vilma_tpu.utils import synthetic
from vilma_tpu_torch.inference import engine as tengine

from tests.torch_parity import data_to_torch, ld_to_torch, state_to_torch
from tests.torch_parity import t2n


def _close(got, want, rtol=1e-10, scale_atol=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(
        t2n(got) if isinstance(got, torch.Tensor) else np.asarray(got),
        want, rtol=rtol, atol=scale_atol * max(np.abs(want).max(), 1e-300))


def _raw_problem(num_pops, num_annotations=2, seed=0, num_loci=192):
    rng = np.random.default_rng(seed)
    ld = synthetic.synthetic_ld(num_loci, 48, seed=seed)
    std_errs = rng.uniform(0.01, 0.05, (num_pops, num_loci))
    betas = rng.standard_normal((num_pops, num_loci)) * std_errs * 2
    covs = [np.eye(num_pops) * s + 0.3 * s for s in (1e-6, 1e-4, 1e-2)]
    annotations = np.zeros((num_loci, num_annotations))
    annotations[np.arange(num_loci),
                rng.integers(0, num_annotations, num_loci)] = 1
    return dict(marginal_effects=betas, std_errs=std_errs,
                ld_mats=[ld] * num_pops, annotations=annotations,
                mixture_covs=covs, scaled=False, scale_se=False,
                gwas_N=np.full(num_pops, 1e5),
                init_hg=np.full(num_pops, 0.3))


@pytest.mark.parametrize('num_pops', [1, 2, 3])
def test_build_model_data_matches_jax(num_pops):
    """Every ModelData field, from the same inputs and LD; cohorts that
    share one panel share one LD entry in both packages."""
    raw = _raw_problem(num_pops, seed=num_pops)
    jdata = jengine.build_model_data(**raw)
    tld = ld_to_torch(raw['ld_mats'][0])
    tdata = tengine.build_model_data(**dict(raw, ld_mats=[tld] * num_pops),
                                     device='cpu')
    assert tdata.ld_index == tuple(jdata.ld_index) == (0,) * num_pops
    assert len(tdata.ld) == 1
    assert tdata.num_annotations == jdata.num_annotations
    for name in ('marginal_effects', 'std_errs', 'scalings', 'ld_diags',
                 'scaled_ld_diags', 'adj_marginal_effects', 'chi_stat',
                 'ld_ranks', 'inverse_betas', 'annotations',
                 'annotation_counts', 'mixture_prec', 'log_det'):
        _close(getattr(tdata, name), getattr(jdata, name))


def test_floor_mixture_covs_matches_jax():
    covs = np.array([np.eye(2) * 1e-14, np.eye(2) * 1e-2,
                     [[1e-3, 0.5e-3], [0.5e-3, 1e-3]]])
    np.testing.assert_array_equal(tengine._floor_mixture_covs(covs),
                                  jengine._floor_mixture_covs(covs))


def test_initialization_matches_jax():
    """make_fake_mu draws from numpy's global stream in the reference's
    order; initialize_from_fake_mu gives the same hyper_delta and
    shared natural mean."""
    data = synthetic.synthetic_problem(num_loci=192, num_pops=2,
                                       num_components=5, block_size=48,
                                       num_annotations=3)
    tdata = data_to_torch(data)
    args = [np.asarray(a) for a in (data.inverse_betas, data.std_errs,
                                    data.ld_diags)]
    np.random.seed(11)
    jfake = jengine.make_fake_mu(*args)
    np.random.seed(11)
    tfake = tengine.make_fake_mu(*args)
    np.testing.assert_array_equal(tfake, jfake)

    es = jnp.ones(2)
    jsig = jsigma.make_summaries(data.mixture_prec, data.log_det,
                                 jengine._diag_term(data, es))
    _, _, jhyper, _, jnat = jengine.initialize_from_fake_mu(
        data, jsig, es, jnp.asarray(jfake))
    tes = torch.ones(2, dtype=torch.float64)
    thyper, tnat = tengine.initialize_from_fake_mu(
        tdata, tes, torch.as_tensor(tfake))
    _close(thyper, jhyper)
    _close(tnat, jnat)


@pytest.mark.parametrize('num_pops', [1, 2, 3])
def test_objective_compact_matches_jax(num_pops):
    data = synthetic.synthetic_problem(num_loci=192, num_pops=num_pops,
                                       num_components=5, block_size=48,
                                       num_annotations=2, seed=num_pops)
    st = synthetic.synthetic_state(data, seed=3, compact=True)
    tdata, tst = data_to_torch(data), state_to_torch(st)
    o1, pm1, lk1 = jengine._objective_compact(data, st, st.nat_mu,
                                              st.hyper_delta)
    o2, pm2, lk2 = tengine._objective_compact(tdata, tst, tst.nat_mu,
                                              tst.hyper_delta)
    assert np.isclose(float(o2), float(o1), rtol=1e-11)
    _close(pm2, pm1, scale_atol=1e-10)
    _close(lk2, lk1, scale_atol=1e-10)


def test_trajectory_matches_jax():
    """Six outer steps (line searches, beta loops, hyper-delta updates)
    track the JAX engine: pm within 1e-8 of its scale, the ELBO within
    1e-8 relative, hyper_delta within rtol 1e-7. The host loop
    synchronizes once per objective it reads: each line-search trial's,
    each step's hyper-delta evaluation and the first step's start (every
    later step starts from the state's record of its last
    evaluation)."""
    data = synthetic.synthetic_problem(num_loci=256, num_pops=2,
                                       num_components=4, block_size=64,
                                       num_annotations=2)
    st = synthetic.synthetic_state(data, compact=True)
    tdata, tst = data_to_torch(data), state_to_torch(st)
    syncs, trials = tengine.host_syncs, tengine.trials
    for _ in range(6):
        st, pm_j = jengine.outer_step(data, st, line_search_rate=2.0)
        tst, pm_t = tengine.outer_step(tdata, tst)
    assert tengine.host_syncs - syncs == tengine.trials - trials + 6 + 1
    pm_j = np.asarray(pm_j)
    np.testing.assert_allclose(t2n(pm_t), pm_j, rtol=0,
                               atol=1e-8 * np.abs(pm_j).max())
    assert abs(tst.elbo - float(st.elbo)) <= 1e-8 * abs(float(st.elbo))
    np.testing.assert_allclose(t2n(tst.hyper_delta),
                               np.asarray(st.hyper_delta), rtol=1e-7,
                               atol=1e-10)
    assert np.isclose(tst.L[0], float(st.L[0]), rtol=1e-12)
    assert tst.num_err == int(st.num_err) == 0
    assert np.isclose(tst.running_elbo_delta,
                      float(st.running_elbo_delta), rtol=1e-6)


def test_derived_state_matches_jax():
    """materialize_state (vi_mu, vi_delta, sigma summaries) and
    compact_nat_mu, which inverts vi_mu[0] back to the natural mean."""
    data = synthetic.synthetic_problem(num_loci=160, num_pops=3,
                                       num_components=5, block_size=32,
                                       num_annotations=3)
    st = synthetic.synthetic_state(data, seed=4, compact=True)
    tdata, tst = data_to_torch(data), state_to_torch(st)
    jm = jengine.materialize_state(data, st)
    tm = tengine.materialize_state(tdata, tst)
    _close(tm.vi_mu, jm.vi_mu)
    _close(tm.vi_delta, jm.vi_delta)
    _close(tm.nat_grad_vi_delta, jm.nat_grad_vi_delta)
    for field in ('log_det_sigma', 'sigma_summary', 'diag', 'matches'):
        _close(getattr(tm.sigma, field), getattr(jm.sigma, field))
    _close(tengine.compact_nat_mu(tdata, tst.error_scaling, tm.vi_mu),
           st.nat_mu, scale_atol=1e-10)


def test_initial_state_meets_kernel_contract():
    """At float32 the operands the fused kernels get from a freshly
    initialized fit (an einsum output among them) pass the CUDA
    wrappers' dtype, shape and contiguity checks."""
    from vilma_tpu_torch.ops.cuda import compact_obj
    raw = _raw_problem(2, seed=8)
    tld = ld_to_torch(synthetic.synthetic_ld(192, 48, seed=8,
                                             dtype=np.float32))
    np.random.seed(0)
    vi = tengine.MultiPopVI(**dict(raw, ld_mats=[tld, tld], num_its=1),
                            dtype=torch.float32, device='cpu')
    st = vi._initialize()
    args = tengine._fused_operands(vi.data, st.error_scaling, st.nat_mu,
                                   st.hyper_delta)
    compact_obj._check_operands('prologue', *args,
                                vi.data.num_annotations)
