"""The annotation sums behind the hyper-delta update (ops/cuda/
compact_obj.py, csrc/compact_obj*.cu), every state form: the larger of
bytes and operations as for the prologue, over their kernels' time.
Moves vi_steps_per_s."""
from harness import counts

KIND = 'per_layer'
UNIT = '%'


def read(run):
    return counts.roofline_share(run, 'sums')
