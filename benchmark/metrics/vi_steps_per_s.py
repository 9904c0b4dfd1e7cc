"""Outer VI steps completed in the window over the window's length (host
clock, from the first step's start to the end of the step that closes
the window, the device synchronized). A fit's time is its steps over
this rate."""
KIND = 'end_to_end'
UNIT = 'steps/s'


def read(run):
    return run.steps / run.window_s if run.window_s > 0 else None
