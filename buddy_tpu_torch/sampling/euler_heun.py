"""Sampler base and the unconditional Euler-Heun sampler
(``buddy_tpu/sampling/euler_heun.py``): schedule, churn, Tweedie estimate,
the reverse-diffusion loop, and the source of the sampler's Gaussian noise.

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
from buddy_tpu_torch.utils.spans import span


class NoiseSource:
    """Random draws by kind.  Gaussian: ``"init"`` (the sampler's initial
    noise), ``"eps"`` (the churn noise of each step), ``"reg"`` (the RIR
    regulariser noise of each operator update) and ``"prior"`` (the
    trainer's noise); uniform on [0, 1): ``"sigma"`` (the trainer's noise
    levels).  The default draws from one ``torch.Generator`` on its own
    device and moves each draw to ``device``: a CPU generator gives a card
    run and a CPU run the same draws.  A test can replay another framework's
    draws by passing an object with the same ``normal`` and ``uniform``
    methods.  ``NoiseSource.draws`` counts the draws of every source, made
    and moved to the device; each is the span ``noise.draw``."""

    draws = 0

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def normal(self, kind: str, shape, device) -> torch.Tensor:
        g = self.generator
        with span("noise.draw"):
            out = torch.randn(shape, generator=g, device=g.device).to(device)
        NoiseSource.draws += 1
        return out

    def uniform(self, kind: str, shape, device) -> torch.Tensor:
        g = self.generator
        with span("noise.draw"):
            out = torch.rand(shape, generator=g, device=g.device).to(device)
        NoiseSource.draws += 1
        return out


class ShardedNoise:
    """The draws of a batch split over ``count`` ranks: each call draws the
    global batch (``count`` times the rows asked for) from ``inner`` and
    hands out the ``index``-th of its ``count`` equal shares of rows, so
    that every row gets the draws it gets in a one-process run of the
    global batch.  Every draw a sampler,
    an operator reset or the trainer asks for leads with the batch axis."""

    def __init__(self, inner, index: int, count: int):
        self.inner, self.index, self.count = inner, int(index), int(count)

    def _rows(self, draw, shape, device):
        b = shape[0]
        full = draw((b * self.count,) + tuple(shape[1:]), device)
        return full[self.index * b:(self.index + 1) * b]

    def normal(self, kind: str, shape, device) -> torch.Tensor:
        return self._rows(lambda s, d: self.inner.normal(kind, s, d), shape, device)

    def uniform(self, kind: str, shape, device) -> torch.Tensor:
        return self._rows(lambda s, d: self.inner.uniform(kind, s, d), shape, device)


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


class NoSampler(Sampler):
    """Stub sampler: every entry point returns None."""

    def predict(self, *a, **k):
        return None

    predict_unconditional = predict
    predict_conditional = predict
    step = predict


class EulerHeunSampler(Sampler):
    """Unconditional stochastic Euler-Heun sampler; the DPS sampler builds
    on it."""

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

    def _step(self, x, t_i, t_ip1, gamma_i, noise):
        """One reverse-diffusion step."""
        t_i, t_ip1 = np.float32(t_i), np.float32(t_ip1)
        t_hat = np.float32(t_i + np.float32(gamma_i) * t_i)
        eps = noise.normal("eps", x.shape, x.device)
        x_hat = x + float(np.sqrt(np.maximum(t_hat ** 2 - t_i ** 2, np.float32(0)))) * eps
        d = (x_hat - self._denoise(x_hat, float(t_hat))) / float(t_hat)
        dt = float(t_ip1 - t_hat)
        x_next = x_hat + dt * d
        if self.order == 2 and t_ip1 != 0:
            d2 = (x_next - self._denoise(x_next, float(t_ip1))) / float(t_ip1)
            x_next = x_hat + dt * 0.5 * (d + d2)
        return x_next

    @torch.no_grad()
    def predict(self, shape, noise=None, **_ignored) -> torch.Tensor:
        """Sample ``shape`` = (B, n) waveforms from the prior; returns the
        final x (not the last denoised estimate)."""
        noise = noise if noise is not None else self.default_noise()
        t = self.create_schedule()
        gamma = self.get_gamma(t)
        x = float(t[0]) * noise.normal("init", tuple(shape), self.device)
        for i in range(len(t) - 1):
            x = self._step(x, t[i], t[i + 1], gamma[i], noise)
        return x

    def predict_unconditional(self, shape, noise=None, sharding=None,
                              **_ignored) -> torch.Tensor:
        """``shape`` = (B, n) samples; with ``sharding`` (``parallel.
        batch_sharding``) this rank samples its rows of the B, from the
        global batch's draws, and returns them."""
        if sharding is None or sharding.mesh.shape["dp"] == 1:
            return self.predict(shape, noise=noise)
        noise = noise if noise is not None else self.default_noise()
        mesh = sharding.mesh
        rows = sharding.block(shape)[0]
        local = (rows.stop - rows.start,) + tuple(shape[1:])
        return self.predict(local, noise=ShardedNoise(noise, mesh.coords["dp"],
                                                      mesh.shape["dp"]))

    def predict_conditional(self, *args, **kwargs):
        raise NotImplementedError
