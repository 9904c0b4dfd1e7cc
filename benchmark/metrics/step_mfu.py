"""The whole step's share of the chip's FP32 peak: the operations of
every hand-written kernel call in the window (harness/counts.py: the
prologue, the sums and the matvec), over the traced window's seconds
times 67 TFLOP/s. A kernel taken off the path leaves its roofline silent;
this share still bounds the step. Moves vi_steps_per_s."""
from harness import counts

KIND = 'per_layer'
UNIT = '%'


def read(run):
    if run.trace is None or run.trace['window_s'] <= 0:
        return None
    ops = sum(v[0] for v in run.work.values())
    return 100.0 * ops / (run.trace['window_s'] * counts.PEAK_FP32_S)
