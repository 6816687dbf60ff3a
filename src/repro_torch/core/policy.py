"""Quantized-training policy (port of ``repro/core/policy.py``).

Three quantizer families: ``Q_W`` (weights, current min-max, symmetric),
``Q_Y`` (activations, the estimator under study) and ``Q_G`` (activation
gradients, stochastic rounding).  ``QuantPolicy`` is frozen and hashable;
its backend selection is validated at construction
(:func:`repro_torch.core.backend.validate`).
"""
from __future__ import annotations

import dataclasses

from repro_torch.telemetry.config import TelemetryConfig

from . import backend as backend_mod
from .estimators import HINDSIGHT, EstimatorConfig
from .quant import QuantSpec


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    enabled: bool = True

    weight_spec: QuantSpec = QuantSpec(bits=8, symmetric=True, stochastic=False)
    quantize_weights: bool = True
    int8_weight_gather: bool = False

    act_spec: QuantSpec = QuantSpec(bits=8, symmetric=False, stochastic=False)
    act_estimator: EstimatorConfig = EstimatorConfig(kind=HINDSIGHT, momentum=0.9)
    quantize_acts: bool = True

    grad_spec: QuantSpec = QuantSpec(bits=8, symmetric=False, stochastic=True)
    grad_estimator: EstimatorConfig = EstimatorConfig(kind=HINDSIGHT, momentum=0.9)
    quantize_grads: bool = True

    telemetry: TelemetryConfig = TelemetryConfig()

    # "simulated" (plain torch fake-quant) or "fused" (the CUDA kernels;
    # their plain versions for CPU tensors).  "fused" is legal only for a
    # fully static policy.
    backend: str = backend_mod.SIMULATED

    def __post_init__(self):
        backend_mod.validate(self)

    @staticmethod
    def disabled() -> "QuantPolicy":
        return QuantPolicy(enabled=False, quantize_weights=False,
                           quantize_acts=False, quantize_grads=False)

    @staticmethod
    def w8a8g8(act_kind: str = HINDSIGHT, grad_kind: str = HINDSIGHT,
               momentum: float = 0.9,
               backend: str = backend_mod.SIMULATED) -> "QuantPolicy":
        """The paper's fully-quantized-training setting (sec. 5.2)."""
        return QuantPolicy(
            act_estimator=EstimatorConfig(kind=act_kind, momentum=momentum),
            grad_estimator=EstimatorConfig(kind=grad_kind, momentum=momentum),
            backend=backend)

    @staticmethod
    def grad_only(kind: str, momentum: float = 0.9) -> "QuantPolicy":
        """Paper Table 1: forward in FP, only gradients quantized."""
        return QuantPolicy(
            quantize_weights=False, quantize_acts=False,
            grad_estimator=EstimatorConfig(kind=kind, momentum=momentum))

    @staticmethod
    def act_only(kind: str, momentum: float = 0.9) -> "QuantPolicy":
        """Paper Table 2: only activations quantized (backward in FP)."""
        return QuantPolicy(
            quantize_weights=False, quantize_grads=False,
            act_estimator=EstimatorConfig(kind=kind, momentum=momentum))

    @property
    def stat_width(self) -> int:
        return self.telemetry.stat_width

    def with_telemetry(self, **kw) -> "QuantPolicy":
        """Copy of this policy with telemetry enabled (keywords go to
        :class:`repro_torch.telemetry.TelemetryConfig`; validated)."""
        kw.setdefault("enabled", True)
        return dataclasses.replace(self, telemetry=TelemetryConfig(**kw))

    def with_backend(self, backend: str) -> "QuantPolicy":
        return dataclasses.replace(self, backend=backend)

    @property
    def is_fully_static(self) -> bool:
        ok_act = (not self.quantize_acts) or self.act_estimator.is_static
        ok_grad = (not self.quantize_grads) or self.grad_estimator.is_static
        return ok_act and ok_grad


DEFAULT_POLICY = QuantPolicy()
FP32_POLICY = QuantPolicy.disabled()
