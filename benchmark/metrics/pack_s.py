"""Seconds of the port's ops/blocks.pack of the panel (the host's
staging of every block's factor and the copy to the card), timed by the
benchmark around the call. Moves setup_s."""
KIND = 'per_layer'
UNIT = 's'


def read(run):
    return run.timings.get('pack_s')
