"""Gradient-based ELBO optimization (validation mode).

Port of vilma_tpu/inference/gradient.py. The coordinate-ascent engine
(inference.engine) is the production path; this module maximizes the
*same* ELBO with Adam over unconstrained parameters, as an independent
check that the natural-gradient updates converge to a true ELBO optimum.

Parameterization:
    vi_mu           unconstrained [K, P, I]
    vi_delta        logits [K, I] -> softmax over K
    hyper_delta     logits [A, K] -> softmax rows

The variational covariances stay at their closed-form optimum given
error_scaling (as in the reference, variational_inference.py:712-733), so
the ELBO here is the function the coordinate-ascent engine evaluates. On
the card its LD products run the block matvec kernel, whose backward is
the same kernel on the gradient (ops/cuda/block_matvec.BucketMatvec).

torch.optim.Adam stands in for optax.adam: both take b1 0.9, b2 0.999 and
eps 1e-8 added outside the square root of the bias-corrected second
moment.
"""
from dataclasses import dataclass

import torch

from vilma_tpu_torch.inference import engine


@dataclass(frozen=True)
class GradParams:
    vi_mu: torch.Tensor
    delta_logits: torch.Tensor
    hyper_logits: torch.Tensor


def _constrain(params):
    vi_delta = torch.softmax(params.delta_logits, dim=0)
    hyper_delta = torch.softmax(params.hyper_logits, dim=1)
    return params.vi_mu, vi_delta, hyper_delta


def elbo_of(data, sigma, error_scaling, params):
    vi_mu, vi_delta, hyper_delta = _constrain(params)
    return engine.elbo(data, sigma, error_scaling, vi_mu, vi_delta,
                       hyper_delta)


def initial_params(data, state):
    """(GradParams, sigma, error_scaling) of a VIState: its materialized
    parameters as leaves that require grad (vi_delta and hyper_delta as
    log-probabilities), and the closed-form sigma of its error_scaling,
    built once and held fixed."""
    with torch.no_grad():
        state = engine.materialize_state(data, state)
        tiny = torch.finfo(state.vi_delta.dtype).tiny
        params = GradParams(
            vi_mu=state.vi_mu.clone(),
            delta_logits=torch.log(torch.clamp(state.vi_delta, min=tiny)),
            hyper_logits=torch.log(torch.clamp(state.hyper_delta,
                                               min=tiny)))
    for leaf in (params.vi_mu, params.delta_logits, params.hyper_logits):
        leaf.requires_grad_(True)
    return params, state.sigma, state.error_scaling


def fit_elbo_gradient(data, state, num_steps=500, learning_rate=1e-2):
    """Maximize the ELBO with Adam starting from a VIState, on the
    device of `data`.

    Returns ((vi_mu, vi_delta, hyper_delta), trace): the final
    constrained parameters and the ELBO before each step, one host
    synchronization a step."""
    params, sigma, error_scaling = initial_params(data, state)
    opt = torch.optim.Adam(
        (params.vi_mu, params.delta_logits, params.hyper_logits),
        lr=learning_rate)
    trace = []
    for _ in range(num_steps):
        opt.zero_grad(set_to_none=True)
        loss = -elbo_of(data, sigma, error_scaling, params)
        loss.backward()
        opt.step()
        trace.append(-float(loss.detach()))
    with torch.no_grad():
        return tuple(t.detach() for t in _constrain(params)), trace
