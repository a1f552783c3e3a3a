"""EDM parameterisation (Karras et al. 2022), ``buddy_tpu/diffusion/edm.py``.

``D(x, sigma) = cskip*x + cout*net(cin*x, cnoise)``.  The scalar functions
take a float or a tensor of noise levels.  The training half draws its
randomness from a noise source (``sampling/euler_heun.py::NoiseSource`` or
any object with its ``uniform`` and ``normal`` methods): the noise levels
first (kind ``"sigma"``), then the prior noise (kind ``"prior"``), the order
of the JAX package's key split, so that a test can replay JAX's draws.
"""

from __future__ import annotations

import torch


def _rsqrt(v):
    return torch.rsqrt(v) if torch.is_tensor(v) else v ** -0.5


def _bcast(t, x: torch.Tensor) -> torch.Tensor:
    """Noise levels (a float or a (B,) tensor) as (B, 1, 1, ...) against x."""
    t = torch.as_tensor(t, dtype=x.dtype, device=x.device).reshape(-1)
    return t.reshape((-1,) + (1,) * (x.dim() - 1))


class EDM:
    """EDM hyperparameters (conf/diff_params/edm_VCTK.yaml) and the
    preconditioned denoiser."""

    def __init__(self, type: str = "ve_karras", sde_hp=None, **kwargs):
        hp = sde_hp or {}
        self.type = type
        self.sigma_data = float(hp.get("sigma_data", 0.05))
        self.sigma_min = float(hp.get("sigma_min", 1e-5))
        self.sigma_max = float(hp.get("sigma_max", 10.0))
        self.rho = float(hp.get("rho", 10.0))

    @property
    def sde_hp(self):
        return {"sigma_data": self.sigma_data, "sigma_min": self.sigma_min,
                "sigma_max": self.sigma_max, "rho": self.rho}

    def cskip(self, sigma):
        return self.sigma_data ** 2 / (sigma ** 2 + self.sigma_data ** 2)

    def cout(self, sigma):
        return sigma * self.sigma_data * _rsqrt(self.sigma_data ** 2 + sigma ** 2)

    def cin(self, sigma):
        return _rsqrt(self.sigma_data ** 2 + sigma ** 2)

    def cnoise(self, sigma):
        return 0.25 * torch.log(sigma)

    def lambda_w(self, sigma):
        return (sigma * self.sigma_data) ** -2 * (self.sigma_data ** 2 + sigma ** 2)

    # the mean and std of the VE-Karras perturbation kernel
    def _mean(self, x, t):
        return x

    def _std(self, t):
        return t

    def tweedie_to_score(self, tweedie, xt, t):
        return (tweedie - xt) / _bcast(t, xt) ** 2

    def score_to_tweedie(self, score, xt, t):
        return _bcast(t, xt) ** 2 * score + xt

    def ode_integrand(self, x, t, score):
        """The probability-flow ODE's dx/dt = -t * score."""
        return -_bcast(t, x) * score

    # --- training -----------------------------------------------------------------
    def sample_time_training(self, noise, n: int, device=None) -> torch.Tensor:
        """n noise levels, rho-warped uniformly between sigma_max and sigma_min."""
        a = noise.uniform("sigma", (n,), device)
        smin, smax, rho = self.sigma_min, self.sigma_max, self.rho
        return (smax ** (1 / rho) + a * (smin ** (1 / rho) - smax ** (1 / rho))) ** rho

    def sample_prior(self, noise, shape, device=None) -> torch.Tensor:
        return noise.normal("prior", tuple(shape), device)

    def prepare_train_preconditioning(self, x, t, n):
        """(network input cin * x_perturbed, the target, cnoise) for clean x,
        noise levels t (B,) and unit noise n of x's shape."""
        sigma = _bcast(self._std(t), x)
        x_perturbed = self._mean(x, t) + sigma * n
        cin, cout, cskip = self.cin(sigma), self.cout(sigma), self.cskip(sigma)
        target = (x - cskip * x_perturbed) / cout
        return cin * x_perturbed, target, self.cnoise(self._std(t))

    def loss_fn(self, net, noise, x: torch.Tensor, n: torch.Tensor | None = None):
        """(per-element squared denoising error, the sampled sigmas (B,)); the
        trainer takes the error's plain mean, with no lambda_w weighting."""
        t = self.sample_time_training(noise, x.shape[0], x.device)
        if n is None:
            n = self.sample_prior(noise, x.shape, x.device)
        inp, target, cnoise = self.prepare_train_preconditioning(x, t, n)
        return (net(inp, cnoise) - target) ** 2, self._std(t)

    def denoiser(self, xn: torch.Tensor, net, t) -> torch.Tensor:
        """cskip*x + cout*net(cin*x, cnoise) for xn (B, ...) at noise level
        t (a float or a (B,) tensor)."""
        t = torch.as_tensor(t, dtype=xn.dtype, device=xn.device).reshape(-1)
        if t.shape[0] == 1 and xn.shape[0] != 1:
            t = t.expand(xn.shape[0])
        sigma = t.reshape((-1,) + (1,) * (xn.dim() - 1))
        return self.cskip(sigma) * xn + self.cout(sigma) * net(self.cin(sigma) * xn,
                                                               self.cnoise(t))
