"""Device-to-host synchronizations of the optimizer's host loop a step
(the port's engine.host_syncs over the window, over its steps): one a
line-search trial and one a convergence fetch. Moves vi_steps_per_s."""
KIND = 'per_layer'
UNIT = 'syncs/step'


def read(run):
    return run.totals['host_syncs'] / run.steps if run.steps else None
