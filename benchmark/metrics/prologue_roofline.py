"""The compact prologue (ops/cuda/compact_obj.py, csrc/compact_obj*.cu),
every state form: the larger of its bytes at 3.35 TB/s and its
operations at 67 TFLOP/s FP32, counted from I, P, K, A and the live
epochs, over the device time of its kernels.
Moves vi_steps_per_s."""
from harness import counts

KIND = 'per_layer'
UNIT = '%'


def read(run):
    return counts.roofline_share(run, 'prologue')
