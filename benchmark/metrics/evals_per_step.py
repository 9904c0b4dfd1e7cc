"""Objective evaluations a step: the compact prologue's launches (the
port's compact_obj.launches) over the window, over its steps. Each is a
prologue and a matvec; one a step more with --learn-scaling's EM.
Moves vi_steps_per_s."""
KIND = 'per_layer'
UNIT = 'evals/step'


def read(run):
    return run.totals['prologue'] / run.steps if run.steps else None
