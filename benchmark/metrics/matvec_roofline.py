"""The block matvec (ops/cuda/block_matvec.py, csrc/block_matvec.cu):
its bytes (U, s, d and x read once, y written once) at 3.35 TB/s, over
the device time of its kernels.
Moves vi_steps_per_s."""
from harness import counts

KIND = 'per_layer'
UNIT = '%'


def read(run):
    return counts.roofline_share(run, 'matvec')
