"""The plain PyTorch versions of the port's three CUDA kernels against the
JAX package's Pallas kernels run in interpret mode on the CPU.

The CUDA kernels themselves run only on a card; chip_smoke.py (and
tests/test_torch_cuda.py there) hold each against these plain versions.
Bands are those of tests/test_pallas.py and tests/test_compact_obj.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vilma_tpu.inference import engine as jengine
from vilma_tpu.ops.pallas import block_matvec as jbm
from vilma_tpu.ops.pallas import compact_obj as jco
from vilma_tpu.utils import synthetic
from vilma_tpu_torch.convert import tensor_from_numpy
from vilma_tpu_torch.ops.cuda import block_matvec as tbm
from vilma_tpu_torch.ops.cuda import compact_obj as tco

from tests.torch_parity import t2n


# ---------------------------------------------------------------------------
# K1: the fused low-rank block matvec
# ---------------------------------------------------------------------------

def _matvec_inputs(u_dtype, seed=0, B=3, C=2, P=64, R=32):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, P, R)) / np.sqrt(P)
    s = rng.uniform(0.1, 2.0, (B, R))
    d = rng.uniform(0.0, 1.0, (B, P))
    x = rng.standard_normal((B, C, P))
    j = [jnp.asarray(u, dtype=u_dtype)] + [
        jnp.asarray(a, dtype=jnp.float32) for a in (s, d, x)]
    return j, [tensor_from_numpy(np.asarray(a)) for a in j]


@pytest.mark.parametrize('C', [1, 2, 3])
def test_matvec_plain_matches_pallas_f32(C):
    """f32 U: both accumulate in f32 in different orders (band 1e-5 of
    scale, as tests/test_compact_obj.py holds the matvec kernel)."""
    j, t = _matvec_inputs(jnp.float32, seed=C, C=C)
    want = np.asarray(jbm.bucket_matvec_multi(*j, interpret=True))
    got = t2n(tbm.bucket_matvec_multi(*t))
    assert got.dtype == np.float32 and got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


def test_matvec_plain_matches_pallas_bf16():
    """bf16 U: x and t are rounded to bf16 before each contraction and
    the products accumulate in f32. The plain version upcasts the
    rounded operands to f32 (a CPU bf16 matmul would round every sum);
    an f32 sum that lands within one ulp of a bf16 rounding boundary
    may round the other way, so the band is one bf16 ulp of scale."""
    j, t = _matvec_inputs(jnp.bfloat16, seed=7)
    assert t[0].dtype == torch.bfloat16
    want = np.asarray(jbm.bucket_matvec_multi(*j, interpret=True))
    got = t2n(tbm.bucket_matvec_multi(*t))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -8 * scale)
    # and it is not the unrounded f32 product
    f32 = t2n(tbm.bucket_matvec_multi(t[0].float(), *t[1:]))
    assert np.abs(f32 - want).max() > np.abs(got - want).max()


# ---------------------------------------------------------------------------
# K2 / K3: the fused compact prologue and annotation sums
# ---------------------------------------------------------------------------

def _compact_operands(num_pops, num_annotations, seed):
    """The fused kernels' operands of a synthetic compact point (f64),
    with every 11th SNP turned into a pad slot (annotation id == A)."""
    data = synthetic.synthetic_problem(num_loci=160, num_pops=num_pops,
                                       num_components=5, block_size=32,
                                       num_annotations=num_annotations,
                                       seed=seed)
    st = synthetic.synthetic_state(data, seed=seed + 1, compact=True)
    args, _ = jengine._fused_operands(data, st.error_scaling, st.nat_mu,
                                      st.hyper_delta)
    args = [np.asarray(a) for a in args]
    args[2] = args[2].copy()
    args[2][::11] = num_annotations
    return ([jnp.asarray(a) for a in args],
            [tensor_from_numpy(a) for a in args])


@pytest.mark.parametrize('num_pops', [1, 2, 3])
@pytest.mark.parametrize('num_annotations', [1, 3, 12])
def test_prologue_plain_matches_pallas(num_pops, num_annotations):
    j, t = _compact_operands(num_pops, num_annotations,
                             seed=num_pops * 13 + num_annotations)
    jpm, jpv, jkl = jco.prologue(*j, num_annotations=num_annotations,
                                 interpret=True)
    tpm, tpv, tkl = tco.prologue(*t, num_annotations=num_annotations)
    # A pad slot's moments are inert downstream (no LD row, zero
    # adjusted effect) and its selected scores are a convention: the
    # port reads column A-1 as the staged XLA route does, the Pallas
    # kernel's one-hot branch (A > 8) reads zeros. Compare real SNPs.
    real = np.asarray(j[2]) < num_annotations
    for got, want in ((tpm, jpm), (tpv, jpv)):
        want = np.asarray(want)[:, real]
        np.testing.assert_allclose(t2n(got)[:, real], want, rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max())
    if num_annotations <= 8:
        np.testing.assert_allclose(t2n(tpm), np.asarray(jpm), rtol=1e-10,
                                   atol=1e-10 * np.abs(jpm).max())
    assert np.isclose(float(tkl), float(jkl), rtol=1e-11)


@pytest.mark.parametrize('num_pops', [1, 2, 3])
@pytest.mark.parametrize('num_annotations', [1, 3, 12])
def test_delta_sums_plain_matches_pallas(num_pops, num_annotations):
    j, t = _compact_operands(num_pops, num_annotations,
                             seed=num_pops * 17 + num_annotations)
    want = np.asarray(jco.delta_sums(*j, num_annotations=num_annotations,
                                     interpret=True))
    got = t2n(tco.delta_sums(*t, num_annotations=num_annotations))
    assert got.shape == want.shape == (num_annotations, 5)
    np.testing.assert_allclose(got, want, rtol=1e-9,
                               atol=1e-9 * want.max())


def test_plain_chunking_is_exact():
    """The plain versions' SNP chunking (which bounds their [K, chunk]
    temporaries at genome scale) changes nothing but the order of the
    KL sum."""
    _, t = _compact_operands(2, 3, seed=5)
    whole = tco.prologue(*t, num_annotations=3)
    sums = tco.delta_sums(*t, num_annotations=3)
    old = tco._PLAIN_CHUNK_ELEMS
    try:
        tco._PLAIN_CHUNK_ELEMS = 5 * 16
        parts = tco.prologue(*t, num_annotations=3)
        sums_c = tco.delta_sums(*t, num_annotations=3)
    finally:
        tco._PLAIN_CHUNK_ELEMS = old
    torch.testing.assert_close(parts[0], whole[0], rtol=0, atol=0)
    torch.testing.assert_close(parts[1], whole[1], rtol=0, atol=0)
    assert np.isclose(float(parts[2]), float(whole[2]), rtol=1e-13)
    np.testing.assert_allclose(t2n(sums_c), t2n(sums), rtol=1e-13)


def test_build_coeffs_matches_jax():
    rng = np.random.default_rng(9)
    for P in (1, 2, 3):
        a = rng.standard_normal((4, P, P))
        prec = a @ np.swapaxes(a, 1, 2) + np.eye(P)
        ld = rng.standard_normal(4)
        want = np.asarray(jco.build_coeffs(jnp.asarray(prec),
                                           jnp.asarray(ld)))
        got = t2n(tco.build_coeffs(torch.as_tensor(prec),
                                   torch.as_tensor(ld)))
        np.testing.assert_array_equal(got, want)
