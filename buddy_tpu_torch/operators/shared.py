"""Degradation-operator protocol (``buddy_tpu/operators/shared.py``): an
operator owns a static geometry plus explicit parameters, and its
``degradation`` is a function of (x, parameters) that autograd can
differentiate in both."""

from __future__ import annotations

import abc


class Operator(abc.ABC):
    """Base class for degradation operators A(x; params)."""

    params = None

    @abc.abstractmethod
    def degradation(self, x, **kwargs):
        """Apply the forward model to a waveform."""

    @abc.abstractmethod
    def update_params(self, *args, **kwargs) -> None:
        """Set or refresh the operator parameters."""
