"""The operation and byte counts of harness/counts.py against counts
worked by hand at PERF.md's kernel-table shapes (rows 1, 1f, 2, 3, 4
and 5): B = 977 blocks of [1024, 512], C = 2; I = 1,000,448 SNPs, P = 2,
K = 582, A = 4, and 2 live epochs for rows 4 and 5."""
import types

import pytest

from harness import counts

I, P, K, A = 1_000_448, 2, 582, 4


def test_matvec_bf16_row_1():
    ops, nbytes = counts.matvec(977, 1024, 512, 2, 2)
    # U 977*1024*512*2, s 977*512*4, d 977*1024*4, x and y 2*977*2*1024*4
    assert nbytes == 1_024_458_752 + 2_000_896 + 4_001_792 + 16_007_168
    # per block and cohort: U'x 2*1024*512, s*t 512, U t 2*1024*512,
    # d*x + add 2*1024
    assert ops == 977 * 2 * (2_097_152 + 512 + 2048)
    # the bound is the bytes: 0.3124 ms (PERF.md row 1)
    assert counts.least_s(ops, nbytes) * 1e3 == pytest.approx(0.31238,
                                                             abs=1e-5)


def test_matvec_f32_row_1f():
    ops, nbytes = counts.matvec(977, 1024, 512, 2, 4)
    assert nbytes == 2_048_917_504 + 2_000_896 + 4_001_792 + 16_007_168
    assert counts.least_s(ops, nbytes) * 1e3 == pytest.approx(0.61819,
                                                             abs=1e-5)


def test_prologue_row_2():
    ops, nbytes = counts.prologue(I, P, K, A)
    # 66 operations per (SNP, component): solve 14, z 7, softmax 4,
    # moments 14, KL 27
    assert ops == I * K * 66
    # table 582*(4+4)*4, ids I*4, dterm and nat 2*2*I*4, pm and pv
    # 2*2*I*4, the KL 4
    assert nbytes == 582 * 8 * 4 + I * 4 + 16 * I + 16 * I + 4
    # bound by the operations: 0.5734 ms at 67 TFLOP/s
    assert counts.least_s(ops, nbytes) == pytest.approx(I * K * 66 / 67e12)


def test_sums_row_3():
    ops, nbytes = counts.sums(I, P, K, A)
    # 27 per (SNP, component): solve 14, z 7, softmax 4, normalize and
    # add 2
    assert ops == I * K * 27
    assert nbytes == 582 * 8 * 4 + I * 4 + 16 * I + 4 * 582 * 4


def test_epoch_rows_4_and_5():
    ops, nbytes = counts.prologue(I, P, K, A, 'epoch', 2)
    # row 2's 66, M y 6, and 18 for each live epoch
    assert ops == I * K * (66 + 6 + 36)
    # row 2's bytes (sld and the accumulator in place of dterm and nat)
    # + the 2 live epochs [2, P, I], their 3 x P inverse scalings and 2
    # coefficients
    assert nbytes == (582 * 8 * 4 + I * 4 + 16 * I + 2 * 2 * I * 4
                      + 3 * 2 * 4 + 2 * 4 + 16 * I + 4)
    ops, nbytes = counts.sums(I, P, K, A, 'epoch', 2)
    assert ops == I * K * (27 + 6 + 36)


def test_one_cohort_counts():
    assert counts.prologue(1000, 1, 14, 4)[0] == 1000 * 14 * 33
    assert counts.sums(1000, 1, 14, 4)[0] == 1000 * 14 * 14


def test_window_work_assigns_live_epochs():
    """In a step whose EM filed an epoch, the last prologue sees the new
    count; launches outside the steps see none."""
    shapes = dict(I=1000, P=2, K=10, A=4, buckets=[(4, 256, 128, 4)])
    recs = [dict(form='epoch', live_in=1, live_out=2, prologue=3, sums=1,
                 matvec=3)]
    totals = dict(prologue=5, sums=1, matvec=5)
    work = counts.window_work(shapes, recs, totals)
    want = (counts.prologue(1000, 2, 10, 4, 'epoch', 2)[0]
            + 2 * counts.prologue(1000, 2, 10, 4, 'epoch', 1)[0]
            + 2 * counts.prologue(1000, 2, 10, 4, 'epoch', 0)[0])
    assert work['prologue'][0] == want
    assert work['matvec'][0] == 5 * counts.matvec(4, 256, 128, 2, 4)[0]


def test_roofline_share_is_silent_without_a_trace():
    run = types.SimpleNamespace(trace=None, work={})
    assert counts.roofline_share(run, 'matvec') is None
    run = types.SimpleNamespace(
        trace={'by_kind': {'matvec': 0.0}}, work={'matvec': (1, 1, 1e-3)})
    assert counts.roofline_share(run, 'matvec') is None
