"""BUDDy's blind posterior sampler (Moliner et al., arXiv 2405.04272;
sp-uhh/buddy ``testing/EulerHeunSamplerDPS.py``) in plain float32
PyTorch, batched over utterances.

Per diffusion step: churn, the EDM denoiser (kept with its graph under
full guidance), ``op_updates_per_step`` Adam updates of the operator on
the detached estimate (bias-corrected, eps outside the square root; the H
that guides is the one computed at the start of the last update), the
zeta-normalised likelihood guidance pulled back through the denoiser or
applied directly, the speech-magnitude constraint and the Euler update.
The warm start is single-channel WPE on a 512/128 STFT.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.operator import BlindSubband, CompressedLoss, WaveformOperator
from portbench.reference.signal import Stft, hann


def schedule(T: int, sigma_min: float, sigma_max: float, rho: float) -> np.ndarray:
    a = np.arange(0, T + 1, dtype=np.float64)
    t = (sigma_max ** (1 / rho) + a / (T - 1) * (sigma_min ** (1 / rho)
                                                 - sigma_max ** (1 / rho))) ** rho
    t[-1] = 0.0
    return t.astype(np.float32)


def gamma(t: np.ndarray, Schurn: float, Stmin: float, Stmax: float) -> np.ndarray:
    base = min(Schurn / t.shape[0], 2 ** 0.5 - 1)
    return np.where((t > Stmin) & (t < Stmax), base, 0.0).astype(t.dtype)


def wpe(y: torch.Tensor, taps: int, delay: int, iterations: int) -> torch.Tensor:
    """Single-channel WPE of (B, n) waveforms, in complex64 throughout."""
    geom = Stft(512, 128, hann(512), "constant", y.device)
    Y = geom.stft(y)                                         # (B, F, T)
    T = Y.shape[-1]
    Yt = torch.stack([F.pad(Y, (delay + k, 0))[..., :T] for k in range(taps)], dim=-2)
    X = Y
    for _ in range(iterations):
        power = torch.clamp(torch.abs(X) ** 2, min=1e-10)
        Yn = Yt / power[..., None, :]
        R = Yn @ Yt.conj().transpose(-1, -2)
        P = Yn @ Y.conj()[..., None]
        load = 1e-6 * torch.diagonal(R, dim1=-2, dim2=-1).real.sum(-1) / taps + 1e-10
        G = torch.linalg.solve(R + load[..., None, None] * torch.eye(taps, dtype=R.dtype,
                                                                     device=R.device), P)
        G = G[..., 0]
        X = Y - (G.conj()[..., None, :] @ Yt)[..., 0, :]
    return geom.istft(X, y.shape[-1])


def _std(x):
    return x.std(dim=-1, keepdim=True)


class BlindDPS:
    """The blind program for rows of one batch. ``noise(kind, shape)`` hands
    out the draws for these rows."""

    def __init__(self, args, net, edm, device):
        self.args, self.net, self.edm = args, net, edm
        ps = args["tester"]["posterior_sampling"]
        sp = args["tester"]["sampling_params"]
        self.ps, self.sp = ps, sp
        self.op = BlindSubband(args["tester"]["informed_dereverberation"]["op_hp"],
                               int(args["exp"]["sample_rate"]), device)
        self.rec = CompressedLoss(ps["rec_loss"], self.op)
        self.rec_params = CompressedLoss(ps["rec_loss_params"], self.op)
        reg = ps["RIR_noise_regularization"]
        self.reg = CompressedLoss(reg["loss"], self.op)
        self.reg_lo, self.reg_hi = float(reg["crop_sigma_min"]), float(reg["crop_sigma_max"])
        self.identity = ps.get("guidance_jacobian", "full") == "identity"
        self.zeta = float(ps["zeta"])
        self.n = int(args["exp"]["audio_len"])
        if int(sp["order"]) != 1 or ps["warm_initialization"]["mode"] != "wpe_scaled":
            raise NotImplementedError("order 1 with the WPE warm start")

    def _adam(self, params, grads, state):
        bh = self.ps["blind_hp"]
        lr, b1, b2 = float(bh["lr_op"]), float(bh["beta1"]), float(bh["beta2"])
        count, mu, nu = state
        count += 1
        mu = {k: (1 - b1) * grads[k] + b1 * mu[k] for k in params}
        nu = {k: (1 - b2) * grads[k] ** 2 + b2 * nu[k] for k in params}
        c1, c2 = 1 - b1 ** count, 1 - b2 ** count
        new = {k: params[k] - lr * (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + 1e-8) for k in params}
        return new, (count, mu, nu)

    def _fit_operator(self, x_den, t_hat, params, state, y_ref, noise):
        op = self.op
        t_op = float(np.clip(t_hat, self.reg_lo, self.reg_hi))
        with torch.no_grad():
            X_den = op.apply_stft(x_den)
        H = None
        for _ in range(int(self.ps["blind_hp"]["op_updates_per_step"])):
            p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            H = op.compute_H(p)
            y_hat = op.degradation(H=H, X=X_den, length=x_den.shape[-1])
            rir = op.time_rir(H)
            rir_noisy = (rir + t_op * noise("reg", rir.shape)).detach()
            loss = self.rec_params(y_ref, y_hat) + self.reg(self.reg.prepare(rir), rir_noisy)
            grads = dict(zip(p, torch.autograd.grad(loss.sum(), list(p.values()))))
            with torch.no_grad():
                params, state = self._adam(p, grads, state)
                params = op.project(params)
        return params, state, H.detach()

    def times(self):
        """The schedule t (T + 1,) and the churn gamma, float32."""
        sp = self.sp
        hp = sp["sde_hp"]
        t = schedule(int(sp["T"]), float(hp["sigma_min"]), float(hp["sigma_max"]),
                     float(hp["rho"]))
        return t, gamma(t, float(sp["Schurn"]), float(sp["Stmin"]), float(sp["Stmax"]))

    def prepare(self, y):
        """The observation's transforms for the two losses, hoisted."""
        self.y_ref, self.y_ref_params = self.rec.prepare(y), self.rec_params.prepare(y)

    def start(self, y, noise, reset_noise):
        """The state before the first step: the warm start x (B, n) and a
        fresh operator (params, Adam state, H)."""
        t, _ = self.times()
        params, H = self.op.reset(reset_noise)
        zeros = {k: torch.zeros_like(v) for k, v in params.items()}
        wi = self.ps["warm_initialization"]
        x = float(t[0]) * noise("init", y.shape)
        w = wi["wpe"]
        with torch.no_grad():
            x_pred = wpe(y, int(w["taps"]), int(w["delay"]), int(w["iterations"]))
        x = float(wi["scaling_factor"]) * x_pred / _std(x_pred) + x
        return x, params, (0, zeros, dict(zeros)), H

    def step(self, i: int, x, params, state, noise, H_guide=None):
        """Step i from the state (x, params, Adam state): a dict of the
        constrained denoised estimate ``x_den``, the update direction ``d``
        (x_next = x_hat + (t_{i+1} - t_hat) d), ``x_hat``, the new
        ``params``, ``state`` and ``H``; with ``H_guide``, also ``d_guide``,
        the direction that guidance through that filter gives."""
        t, g = self.times()
        t_i = np.float32(t[i])
        t_hat = self.t_hat(i)
        x_hat = x + float(np.sqrt(np.maximum(t_hat ** 2 - t_i ** 2, np.float32(0)))) \
            * noise("eps", x.shape)
        if self.identity:
            with torch.no_grad():
                x_den = self.edm.denoise(self.net, x_hat, float(t_hat))
            leaf = None
        else:
            leaf = x_hat.detach().requires_grad_(True)
            x_den = self.edm.denoise(self.net, leaf, float(t_hat))
        params, state, H = self._fit_operator(x_den.detach(), float(t_hat), params, state,
                                              self.y_ref_params, noise)
        scale = float(self.ps["constraint_speech_magnitude"]["speech_scaling"]) \
            / _std(x_den.detach())
        x_con = scale * x_den.detach()

        def direction(Hg, retain):
            xd = x_den.detach().requires_grad_(True)
            rec = self.rec(self.y_ref, self.op.degradation(xd, H=Hg))
            (gx,) = torch.autograd.grad(rec.sum(), xd)
            if leaf is not None:
                (gx,) = torch.autograd.grad(x_den, leaf, gx, retain_graph=retain)
            norm = gx.norm(dim=-1, keepdim=True) / self.n ** 0.5
            return ((x_hat - x_con) / float(t_hat) + self.zeta / (norm + 1e-8) * gx).detach()

        out = {"x_den": x_con, "x_hat": x_hat.detach(), "params": params, "state": state, "H": H}
        out["d"] = direction(H, H_guide is not None)
        if H_guide is not None:
            out["d_guide"] = direction(H_guide, False)
        return out

    def fit_loss(self, x_den, H):
        """The operator's reconstruction loss of the estimate through H, a row."""
        with torch.no_grad():
            return self.rec_params(self.y_ref_params, self.op.degradation(x_den, H=H))

    def t_hat(self, i: int):
        t, g = self.times()
        return np.float32(np.float32(t[i]) + np.float32(g[i]) * np.float32(t[i]))


class InformedDPS:
    """Informed posterior sampling (sp-uhh/buddy's informed DPS tester): the
    observation's own RIRs, FFT convolution as the forward model, guidance
    pulled back through the denoiser, Euler steps with Heun's correction
    where order is 2, the warm start the scaled observation plus noise."""

    def __init__(self, args, net, edm, device):
        ps, sp = args["tester"]["posterior_sampling"], args["tester"]["sampling_params"]
        self.args, self.net, self.edm, self.ps, self.sp = args, net, edm, ps, sp
        self.op = WaveformOperator(args["tester"]["informed_dereverberation"]["op_hp"], device)
        self.rec = CompressedLoss(ps["rec_loss"], self.op)
        self.zeta, self.n = float(ps["zeta"]), int(args["exp"]["audio_len"])
        self.order = int(sp["order"])
        wi = ps["warm_initialization"]
        csm = ps.get("constraint_speech_magnitude", {}) or {}
        if wi["mode"] != "reverb_scaled" or csm.get("use", False) \
                or ps.get("guidance_jacobian", "full") != "full":
            raise NotImplementedError("the reverb-scaled start, no constraint, full guidance")

    times = BlindDPS.times
    t_hat = BlindDPS.t_hat

    def prepare(self, y, rir):
        self.y_ref, self.rir = self.rec.prepare(y), rir

    def start(self, y, noise):
        t, _ = self.times()
        wi = self.ps["warm_initialization"]
        return float(wi["scaling_factor"]) * y / _std(y) + float(t[0]) * noise("init", y.shape)

    def _guided(self, x, sigma: float):
        leaf = x.detach().requires_grad_(True)
        x_den = self.edm.denoise(self.net, leaf, sigma)
        xd = x_den.detach().requires_grad_(True)
        rec = self.rec(self.y_ref, self.op.degradation(xd, self.rir))
        (gx,) = torch.autograd.grad(rec.sum(), xd)
        (gx,) = torch.autograd.grad(x_den, leaf, gx)
        norm = gx.norm(dim=-1, keepdim=True) / self.n ** 0.5
        x_den = x_den.detach()
        return x_den, ((x - x_den) / sigma + self.zeta / (norm + 1e-8) * gx).detach()

    def step(self, i: int, x, noise):
        """Step i from x: {"x_den", "d", "x_hat"}, x_next = x_hat + (t_{i+1} - t_hat) d."""
        t, _ = self.times()
        t_i, t_ip1 = np.float32(t[i]), np.float32(t[i + 1])
        t_hat = self.t_hat(i)
        x_hat = x + float(np.sqrt(np.maximum(t_hat ** 2 - t_i ** 2, np.float32(0)))) \
            * noise("eps", x.shape)
        x_den, d = self._guided(x_hat, float(t_hat))
        if self.order == 2 and t_ip1 != 0:
            x_den, d2 = self._guided(x_hat + float(t_ip1 - t_hat) * d, float(t_ip1))
            d = 0.5 * (d + d2)
        return {"x_den": x_den, "d": d, "x_hat": x_hat.detach()}
