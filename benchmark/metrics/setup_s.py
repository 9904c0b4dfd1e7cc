"""Seconds from the process's start to the first timed step: imports,
the CUDA context, the kernels (built in the checkout's build directory
on a cell's first run there, loaded after), the inputs, the pack, the
model's construction and the warm-up fit's steps."""
KIND = 'end_to_end'
UNIT = 's'


def read(run):
    return run.setup_s
