"""harness/widths.py and the metrics that read it (group_matvec_roofline,
u_pad_pct) against counts worked by hand on a made-up run of the ~6M
panel at an assumed uniform width: 2,215 blocks of 2,708 SNPs at rank 1,354
and a last one of 1,780 at 890, packed into [2,816, 1,360] and [1,792,
896] bf16 buckets (the pack's tiers) or [4,096, 1,360] and [2,048, 896] (the
power-of-two tiers); and the two cells that read the configuration
resolve by name."""
import importlib.util
import os
import types

import pytest

from conftest import BENCH

from harness import registry, widths

TIERS = [(1, 1792, 896, 2), (2215, 2816, 1360, 2)]
POW2 = [(1, 2048, 896, 2), (2215, 4096, 1360, 2)]


def _config(name='ukbb_6m_wide'):
    return registry.cell(name + '.default')['config']


def _metric(name):
    spec = importlib.util.spec_from_file_location(
        'bench_metric_' + name, os.path.join(BENCH, 'metrics', name + '.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_new_cells_resolve():
    for w, block in (('ukbb_6m_wide.default', 2708),
                     ('ukbb_6m.default', 1024)):
        cell = registry.cell(w)
        assert cell['config']['block_size'] == block
        assert cell['config']['num_snps'] == 6_000_000
        assert cell['traffic']['name'] == 'default'
        assert set(cell['limits']) == {'init_nat', 'init_hyper', 'elbo',
                                       'post_mean', 'hyper', 'update'}


def test_real_blocks():
    # 6,000,000 = 2,215 x 2,708 + 1,780; half rank, rounded down
    assert widths.real_blocks(_config()) == [(2215, 2708, 1354),
                                             (1, 1780, 890)]
    # 6,000,000 = 5,859 x 1,024 + 384
    assert widths.real_blocks(_config('ukbb_6m')) == [(5859, 1024, 512),
                                                      (1, 384, 192)]


def test_held_fills_the_narrowest_bucket_first():
    cfg = _config()
    assert widths.held(TIERS, cfg) == [[(1, 1780, 890)],
                                       [(2215, 2708, 1354)]]
    # one bucket of both
    assert widths.held([(2216, 2816, 1360, 2)], cfg) == [
        [(1, 1780, 890), (2215, 2708, 1354)]]
    # a bucket too narrow, or a block left over: no reading
    assert widths.held([(2216, 2560, 1360, 2)], cfg) is None
    assert widths.held(TIERS[1:], cfg) is None


def test_u_pad_pct():
    cfg = _config()
    # held: 1,792 x 896 x 2 + 2,215 x 2,816 x 1,360 x 2
    #     = 3,211,264 + 16,965,836,800 = 16,969,048,064 bytes
    # real: (2,215 x 2,708 x 1,354 + 1,780 x 890) x 2
    #     = (8,121,589,880 + 1,584,200) x 2 = 16,246,348,160 bytes
    want = 100 * (16_969_048_064 - 16_246_348_160) / 16_969_048_064
    assert widths.u_pad_pct(TIERS, cfg) == pytest.approx(want, rel=1e-12)
    assert 4.25 < want < 4.27
    # powers of two: 2,048 x 896 x 2 + 2,215 x 4,096 x 1,360 x 2
    #     = 3,670,016 + 24,677,580,800 = 24,681,250,816 bytes
    want = 100 * (24_681_250_816 - 16_246_348_160) / 24_681_250_816
    assert widths.u_pad_pct(POW2, cfg) == pytest.approx(want, rel=1e-12)
    assert 34.1 < want < 34.2
    run = types.SimpleNamespace(shapes={'buckets': TIERS},
                                cell={'config': cfg})
    assert _metric('u_pad_pct').read(run) == widths.u_pad_pct(TIERS, cfg)


def test_group_work_counts_real_widths():
    """200 matvec calls over 2 buckets: 100 a bucket. The group bucket's
    call at the real widths: U 2,215 x 2,708 x 1,354 x 2 =
    16,243,179,760, s 2,215 x 1,354 x 4 = 11,996,440, d 2,215 x 2,708 x
    4 = 23,992,880, x and y 2 x 2,215 x 2 x 2,708 x 4 = 95,971,520:
    16,375,140,600 bytes; operations 2,215 x 2 x (4 x 3,666,632 + 1,354
    + 2 x 2,708) = 65,002,710,140, under the bytes' bound."""
    shapes = dict(buckets=TIERS, P=2)
    ops, nbytes, least = widths.group_work(
        shapes, {'matvec': 200}, _config(),
        lambda B, p, r, ub, C: p == 2816)
    assert nbytes == 100 * 16_375_140_600
    assert ops == 100 * 65_002_710_140
    assert least == pytest.approx(100 * 16_375_140_600 / 3.35e12,
                                  rel=1e-12)
    # both buckets on the group route: the last block's call adds
    # 1,780 x 890 x 2 + 890 x 4 + 1,780 x 4 + 2 x 2 x 1,780 x 4 bytes
    _, both, _ = widths.group_work(shapes, {'matvec': 200}, _config(),
                                   lambda *a: True)
    assert both - nbytes == 100 * (3_168_400 + 3_560 + 7_120 + 28_480)


def test_group_matvec_roofline_reads_the_group_kernels():
    """The metric: the group route's least time over the device time of
    the kernels named group_matvec_kernel, the route of each bucket the
    program's planner's ([2,816, 1,360] bf16 group, [1,792, 896]
    cluster; at the power-of-two tiers both group)."""
    mod = _metric('group_matvec_roofline')
    least = 100 * 16_375_140_600 / 3.35e12              # 0.48881 s
    ops = [('group_matvec_kernel<__nv_bfloat16, 2>', 1.0),
           ('compact_kernel<2, false, 0, -1, 0>', 0.8),
           ('cluster_matvec_kernel<__nv_bfloat16, 2>', 0.01)]
    run = types.SimpleNamespace(
        shapes=dict(buckets=TIERS, P=2, I=6_000_000, K=582, A=4),
        totals={'matvec': 200}, trace={'device_ops': ops},
        cell={'config': _config()})
    assert mod.read(run) == pytest.approx(100 * least, rel=1e-12)
    run.shapes = dict(run.shapes, buckets=POW2)
    tail = 100 * (3_207_560 / 3.35e12)
    assert mod.read(run) == pytest.approx(100 * (least + tail), rel=1e-12)
    # no group kernel in the window, no trace, or buckets of another
    # panel: silent
    run.trace = {'device_ops': ops[1:]}
    assert mod.read(run) is None
    run.trace = None
    assert mod.read(run) is None
    run.trace = {'device_ops': ops}
    run.cell = {'config': _config('ukbb_6m')}
    assert mod.read(run) is None
