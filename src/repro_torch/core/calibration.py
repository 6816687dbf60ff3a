"""Activation-range calibration (port of ``repro/core/calibration.py``,
paper sec. 5.2).

"We also found that both methods benefit from an initial calibration step
when used for activation quantization.  By calibration, we mean feeding a
few batches of data through the network to calibrate the quantization
ranges before training starts."

``calibrate`` runs one forward pass per batch with quantization
*observing but not applied* (ranges update; the 16-bit grids make the
applied error negligible) and returns the warmed-up quantization state.
At more than 8 bits every site takes the plain path on either backend:
the quantizers run in PyTorch and the contractions are fp32 products of
the on-grid values (``backend.int8_matmul_eligible`` is false).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

import torch

from .policy import QuantPolicy


def observation_policy(policy: QuantPolicy) -> QuantPolicy:
    """A copy of ``policy`` that still walks every quant site (so states
    update) but uses 16-bit grids, making the applied quantization error
    negligible during calibration."""
    return dataclasses.replace(
        policy,
        weight_spec=dataclasses.replace(policy.weight_spec, bits=16),
        act_spec=dataclasses.replace(policy.act_spec, bits=16),
        grad_spec=dataclasses.replace(policy.grad_spec, bits=16),
    )


@torch.no_grad()
def calibrate(forward: Callable, params, quant_state, batches: Iterable,
              policy: QuantPolicy):
    """Feed ``batches`` through ``forward`` updating activation ranges.

    ``forward(params, batch, quant_state, policy) -> (out,
    new_quant_state)`` is called with the observation policy.
    """
    obs = observation_policy(policy)
    for batch in batches:
        _, quant_state = forward(params, batch, quant_state, obs)
    return quant_state
