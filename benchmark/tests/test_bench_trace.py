"""The trace reading on made-up events: busy time as the union of the
device intervals, kernels by kind, idle gaps by the host's activity."""
from harness import trace


def _x(cat, name, ts, dur):
    return {'cat': cat, 'name': name, 'ph': 'X', 'ts': ts, 'dur': dur}


def test_summary():
    evts = [
        _x('user_annotation', trace.SPAN, 0, 1000),
        _x('kernel', 'void compact_kernel<2, false, 0, -1, 0>(Operands)',
           0, 100),
        _x('kernel', 'reduce_scalar(float const*, int, float*)', 100, 10),
        _x('kernel', 'void cluster_matvec_kernel<__nv_bfloat16, 2>()',
           150, 200),
        _x('gpu_memcpy', 'Memcpy DtoH', 340, 20),          # overlaps
        _x('kernel', 'void compact_kernel<2, true, 2, -1, 0>(Operands)',
           500, 100),
        _x('kernel', 'reduce_rows(float const*, int, int, float*)', 600, 5),
        _x('kernel', 'void at::native::elementwise_kernel<128, 2>()',
           700, 50),
        _x('cuda_runtime', 'cudaStreamSynchronize', 360, 140),
        _x('cpu_op', 'aten::item', 355, 150),
        _x('cpu_op', 'aten::mul', 605, 90),
    ]
    out = trace.summary(evts)
    assert out['window_s'] == 1000e-6
    # busy: 0-110, 150-360, 500-605, 700-750
    assert abs(out["busy_s"] - 475e-6) < 1e-12
    assert abs(out['by_kind']['prologue'] - 110e-6) < 1e-12
    assert abs(out['by_kind']['matvec'] - 200e-6) < 1e-12
    assert abs(out['by_kind']['sums'] - 105e-6) < 1e-12
    assert abs(out['by_kind']['glue'] - 50e-6) < 1e-12
    gaps = dict(out['idle_gaps'])
    # 110-150: no host event; 360-500 under the sync (the innermost);
    # 605-700 under aten::mul; 750-1000: none
    assert abs(gaps['host: cudaStreamSynchronize'] - 140e-6) < 1e-12
    assert abs(gaps['host: aten::mul'] - 95e-6) < 1e-12
    assert abs(gaps['host: none'] - 290e-6) < 1e-12
    assert out['device_ops'][0][0].startswith('cluster_matvec_kernel')
