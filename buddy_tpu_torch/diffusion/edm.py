"""EDM preconditioning (Karras et al. 2022), ``buddy_tpu/diffusion/edm.py``.

``D(x, sigma) = cskip*x + cout*net(cin*x, cnoise)``.  The scalar functions
take a float or a tensor of noise levels.
"""

from __future__ import annotations

import torch


def _rsqrt(v):
    return torch.rsqrt(v) if torch.is_tensor(v) else v ** -0.5


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

    def denoiser(self, xn: torch.Tensor, net, t) -> torch.Tensor:
        """cskip*x + cout*net(cin*x, cnoise) for xn (B, ...) at noise level
        t (a float or a (B,) tensor)."""
        t = torch.as_tensor(t, dtype=xn.dtype, device=xn.device).reshape(-1)
        if t.shape[0] == 1 and xn.shape[0] != 1:
            t = t.expand(xn.shape[0])
        sigma = t.reshape((-1,) + (1,) * (xn.dim() - 1))
        return self.cskip(sigma) * xn + self.cout(sigma) * net(self.cin(sigma) * xn,
                                                               self.cnoise(t))
