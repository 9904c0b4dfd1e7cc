"""Device milliseconds a step of every kernel that is not hand-written:
plain PyTorch's gathers and scatters (ops/blocks.py), the likelihood
(ops/kernels.py), the state updates and the EM (models/sigma.py,
inference/engine.py), from the window's trace. Moves vi_steps_per_s."""
KIND = 'per_layer'
UNIT = 'ms/step'


def read(run):
    if run.trace is None or not run.steps:
        return None
    return 1e3 * run.trace['by_kind']['glue'] / run.steps
