"""The share of the traced window in which no kernel, copy or fill ran
on the device: 100 (1 - busy / window), busy the union of the device
intervals. Moves vi_steps_per_s."""
KIND = 'per_layer'
UNIT = '%'


def read(run):
    if run.trace is None or run.trace['window_s'] <= 0:
        return None
    return 100.0 * (1.0 - run.trace['busy_s'] / run.trace['window_s'])
