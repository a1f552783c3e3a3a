"""Sampler base (``buddy_tpu/sampling/euler_heun.py``): schedule, churn,
Tweedie estimate, and the source of the sampler's Gaussian noise.

The JAX package compiles the T-step loop into one ``lax.scan``; here it is a
Python loop over eager steps.  The configured Snoise is never used (the
reference calls its stochastic step without it), and the second-order
correction is skipped where t_{i+1} == 0.
"""

from __future__ import annotations

import numpy as np
import torch

from buddy_tpu_torch.device import resolve_device
from buddy_tpu_torch.sampling.schedule import create_schedule, get_gamma


class NoiseSource:
    """Gaussian draws for the sampler, by kind: ``"init"`` (the initial
    noise), ``"eps"`` (the churn noise of each step) and ``"reg"`` (the RIR
    regulariser noise of each operator update).  The default draws from one
    ``torch.Generator`` on its own device and moves each draw to ``device``:
    a CPU generator gives a card run and a CPU run the same draws.  A test
    can replay another framework's draws by passing an object with the same
    ``normal`` method."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def normal(self, kind: str, shape, device) -> torch.Tensor:
        g = self.generator
        return torch.randn(shape, generator=g, device=g.device).to(device)


class Sampler:
    """Owns the model (a callable ``(x, cnoise) -> x̂``), the EDM
    parameterisation, the config and the device."""

    def __init__(self, model, diff_params, args, device=None):
        self.model = model
        self.diff_params = diff_params
        self.args = args
        self.device = resolve_device(device)
        sp = args["tester"]["sampling_params"]
        self.sde_hp = diff_params.sde_hp if sp["same_as_training"] else dict(sp["sde_hp"])
        self.T = int(sp["T"])
        self.schedule_kind = sp.get("schedule", "edm")

    def create_schedule(self) -> np.ndarray:
        hp = self.sde_hp
        return create_schedule(self.T, sigma_min=float(hp["sigma_min"]),
                               sigma_max=float(hp["sigma_max"]), rho=float(hp["rho"]),
                               schedule=self.schedule_kind)

    def get_tweedie_estimate(self, x: torch.Tensor, t_i) -> torch.Tensor:
        """Denoiser on a (B, n) waveform."""
        return self.diff_params.denoiser(x[:, None, :], self.model, t_i)[:, 0, :]

    def default_noise(self, seed: int = 0) -> NoiseSource:
        return NoiseSource(torch.Generator(device=self.device).manual_seed(seed))


class EulerHeunSampler(Sampler):
    """Stochastic Euler-Heun sampler settings (Schurn, Stmin, Stmax, order).
    Its unconditional program is not ported yet; the DPS sampler builds on it."""

    def __init__(self, model, diff_params, args, device=None):
        super().__init__(model, diff_params, args, device)
        sp = args["tester"]["sampling_params"]
        self.Schurn = float(sp["Schurn"])
        self.Snoise = float(sp["Snoise"])
        self.Stmin = float(sp["Stmin"])
        self.Stmax = float(sp["Stmax"])
        self.order = int(sp["order"])

    def get_gamma(self, t: np.ndarray) -> np.ndarray:
        return get_gamma(t, Schurn=self.Schurn, Stmin=self.Stmin, Stmax=self.Stmax)

    def _denoise(self, x, t):
        return self.get_tweedie_estimate(x, t)
