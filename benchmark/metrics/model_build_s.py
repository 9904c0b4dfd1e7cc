"""Seconds of the covariance grid and MultiPopVI's construction
(build_model_data: the LD diagonal, the adjusted effects, chi^2, the
LDpred-inf ridge solve), timed by the benchmark around them. Moves
setup_s."""
KIND = 'per_layer'
UNIT = 's'


def read(run):
    return run.timings.get('model_build_s')
