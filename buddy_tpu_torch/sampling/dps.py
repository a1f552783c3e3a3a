"""Diffusion posterior sampling, informed and blind (``buddy_tpu/sampling/dps.py``).

One batch of B utterances runs at once, batch-first: waveforms (B, n),
operator parameters with a leading batch axis.  Per diffusion step:

* the EDM denoiser, kept with its autograd graph for full guidance;
* (blind) ``op_updates_per_step`` Adam updates of the subband operator on the
  detached denoised estimate — optax.adam semantics: bias correction, eps
  1e-8 outside the sqrt, no clipping (``blind_hp.grad_clip`` is never read);
  the H used by the guidance is the one computed at the start of the last
  update;
* the zeta-normalised likelihood guidance, pulled back through the denoiser
  (``guidance_jacobian="full"``) or applied directly ("identity");
* the speech-magnitude constraint and the Euler update (Heun where
  order == 2 and t_{i+1} != 0).

Every loss is per utterance; summing over the batch before a backward pass
leaves each utterance's gradient as the vmapped JAX program computes it.
``std`` is Bessel-corrected and ``predict`` returns x_den, not x.
"""

from __future__ import annotations

import numpy as np
import torch

from buddy_tpu_torch.losses import get_loss
from buddy_tpu_torch.sampling.euler_heun import EulerHeunSampler
from buddy_tpu_torch.utils.spans import span


def _std(x: torch.Tensor) -> torch.Tensor:
    """Per-utterance standard deviation with Bessel's correction, (B, 1)."""
    return x.reshape(x.shape[0], -1).std(dim=-1, keepdim=True)


class EulerHeunSamplerDPS(EulerHeunSampler):
    """Euler-Heun sampler with DPS likelihood guidance (informed + blind)."""

    def __init__(self, model, diff_params, args, device=None):
        super().__init__(model, diff_params, args, device)
        ps = args["tester"]["posterior_sampling"]
        self.ps = ps
        self.zeta = float(ps["zeta"])
        self.guidance_jacobian = str(ps.get("guidance_jacobian", "full"))
        if self.guidance_jacobian not in ("full", "identity"):
            raise ValueError(self.guidance_jacobian)
        self.audio_len = int(args["exp"]["audio_len"])
        self.rec_loss = self.rec_loss_params = self.reg_loss = None

    # --- set-up ----------------------------------------------------------
    def initialize_x(self, y: torch.Tensor, t0: float, noise) -> torch.Tensor:
        """Warm initialisation of a (B, n) batch."""
        wi = self.ps["warm_initialization"]
        mode = wi["mode"]
        x = t0 * noise.normal("init", y.shape, y.device)
        if mode == "none":
            return x
        if mode == "reverb_scaled":
            return float(wi["scaling_factor"]) * y / _std(y) + x
        if mode == "wpe_scaled":
            from buddy_tpu_torch.sampling.wpe import wpe_dereverb
            w = wi["wpe"]
            x_pred = wpe_dereverb(y, taps=int(w["taps"]), delay=int(w["delay"]),
                                  iterations=int(w["iterations"]))[..., :y.shape[-1]]
            return float(wi["scaling_factor"]) * x_pred / _std(x_pred) + x
        raise NotImplementedError(mode)

    def _build_losses(self, operator, blind: bool) -> None:
        ps = self.ps
        self.rec_loss = get_loss(ps["rec_loss"], operator=operator)
        self.rec_loss_params = self.reg_loss = None
        if blind:
            self.rec_loss_params = get_loss(ps["rec_loss_params"], operator=operator)
            reg_cfg = ps.get("RIR_noise_regularization", None)
            # active iff its loss.name != "none"; the ``use`` key is never read
            if reg_cfg is not None:
                self.reg_loss = get_loss(reg_cfg["loss"], operator=operator)
                if self.reg_loss is not None:
                    self.reg_sigma_min = float(reg_cfg["crop_sigma_min"])
                    self.reg_sigma_max = float(reg_cfg["crop_sigma_max"])

    def _prepare_observation(self, operator, y: torch.Tensor) -> None:
        """Hoist the loss-side transform of the observation out of the loop."""
        self.y = y
        y_ref = operator.apply_stft(y)
        prep = lambda loss: (loss.prepare(y_ref), True) if hasattr(loss, "prepare") \
            else (y, False)
        self._y_prep = prep(self.rec_loss)
        self._y_prep_params = prep(self.rec_loss_params) \
            if self.rec_loss_params is not None else None

    # --- the inner operator optimisation ----------------------------------
    def _adam(self, params, grads, state):
        """One optax.adam(lr, b1, b2) step; ``state`` = (count, mu, nu)."""
        bh = self.ps["blind_hp"]
        lr, b1, b2 = float(bh["lr_op"]), float(bh["beta1"]), float(bh["beta2"])
        count, mu, nu = state
        count += 1
        mu = {k: (1 - b1) * grads[k] + b1 * mu[k] for k in params}
        nu = {k: (1 - b2) * grads[k] ** 2 + b2 * nu[k] for k in params}
        c1, c2 = 1 - b1 ** count, 1 - b2 ** count
        new = {k: params[k] - lr * (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + 1e-8)
               for k in params}
        return new, (count, mu, nu)

    def _optimize_op(self, operator, x_den, t_hat, params, state, noise):
        """``op_updates_per_step`` Adam updates of the operator parameters on
        the detached x_den; returns the params, the optimiser state and the
        H computed at the start of the last update."""
        bh = self.ps["blind_hp"]
        if bh.get("optimizer", "adam") != "adam":
            raise NotImplementedError(bh["optimizer"])
        y_ref, prepared = self._y_prep_params if self._y_prep_params else (None, False)
        t_op = float(np.clip(t_hat, self.reg_sigma_min, self.reg_sigma_max)) \
            if self.reg_loss is not None else None
        with torch.no_grad():
            X_den = operator.apply_stft(x_den)
            Xf_den = operator.frame_fft(X_den)
        H = None
        for _ in range(int(bh["op_updates_per_step"])):
            p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            H = operator.compute_H(p)
            y_hat = operator.degradation(None, H=H, X=X_den, Xf=Xf_den,
                                         length=x_den.shape[-1])
            loss = torch.zeros(x_den.shape[0], device=x_den.device)
            if self.rec_loss_params is not None:
                loss = loss + self.rec_loss_params(y_ref, y_hat, x_prepared=prepared)
            if self.reg_loss is not None:
                rir = operator.get_time_RIR(H)
                rir_noisy = (rir + t_op * noise.normal("reg", rir.shape, rir.device)).detach()
                loss = loss + self.reg_loss(rir, rir_noisy)
            grads = dict(zip(p, torch.autograd.grad(loss.sum(), list(p.values()))))
            with torch.no_grad():
                params, state = self._adam(p, grads, state)
                params = operator.project(params)
        return params, state, H.detach()

    # --- guidance and the step ---------------------------------------------
    def _likelihood_score(self, x_den, x_hat, degrade):
        """zeta-normalised guidance.  ``x_hat`` None means identity-Jacobian
        mode: the operator-side gradient is used directly."""
        y_ref, prepared = self._y_prep
        xd = x_den.detach().requires_grad_(True)
        rec = self.rec_loss(y_ref, degrade(xd), x_prepared=True) if prepared \
            else self.rec_loss(y_ref, degrade(xd))
        (g,) = torch.autograd.grad(rec.sum(), xd)
        if x_hat is not None:
            with span("dps.vjp"):
                (g,) = torch.autograd.grad(x_den, x_hat, g)
        normguide = g.reshape(g.shape[0], -1).norm(dim=-1, keepdim=True) / self.audio_len ** 0.5
        return self.zeta / (normguide + 1e-8) * g

    def _guided_update(self, x_hat, t_hat, operator, blind, params, state, H, noise):
        """Denoise, (blind) optimise the operator, guide at one sigma."""
        if self.guidance_jacobian == "identity":
            with torch.no_grad(), span("dps.denoise"):
                x_den = self._denoise(x_hat, t_hat)
            x_leaf = None
        else:
            x_leaf = x_hat.detach().requires_grad_(True)
            with span("dps.denoise"):
                x_den = self._denoise(x_leaf, t_hat)
        if blind:
            params, state, H = self._optimize_op(operator, x_den.detach(), t_hat, params,
                                                 state, noise)
        if hasattr(operator, "subband_filtering"):
            degrade = lambda xd: operator.degradation(xd, H=H, mode="waveform")
        else:                      # RIROperator: H carries the time-domain RIRs (B, M)
            degrade = lambda xd: operator.degradation(xd, filt=H)
        lh_score = self._likelihood_score(x_den, x_leaf, degrade)
        x_den = x_den.detach()
        csm = self.ps.get("constraint_speech_magnitude", None)
        if csm is not None and csm.get("use", False):
            x_den = float(csm["speech_scaling"]) / _std(x_den) * x_den
        d = (x_hat - x_den) / t_hat + lh_score
        return x_den, d, params, state, H

    def _scan_step(self, operator, blind, carry, t_i, t_ip1, gamma_i, noise):
        """One guided reverse-diffusion step; carry = (x, params, state, H)."""
        with span("dps.step"):
            x, params, state, H = carry
            t_i, t_ip1 = np.float32(t_i), np.float32(t_ip1)
            t_hat = np.float32(t_i + np.float32(gamma_i) * t_i)
            eps = noise.normal("eps", x.shape, x.device)
            x_hat = x + float(np.sqrt(np.maximum(t_hat ** 2 - t_i ** 2, np.float32(0)))) * eps
            x_den, d, params, state, H = self._guided_update(
                x_hat, float(t_hat), operator, blind, params, state, H, noise)
            dt = float(t_ip1 - t_hat)
            x_next = x_hat + dt * d
            if self.order == 2 and t_ip1 != 0:
                x_den, d2, params, state, H = self._guided_update(
                    x_next, float(t_ip1), operator, blind, params, state, H, noise)
                x_next = x_hat + dt * 0.5 * (d + d2)
            return (x_next.detach(), params, state, H), x_den

    def _run(self, operator, blind, y, noise, params, H):
        self._prepare_observation(operator, y)
        t = self.create_schedule()
        gamma = self.get_gamma(t)
        x = self.initialize_x(y, float(t[0]), noise)
        zeros = {k: torch.zeros_like(v) for k, v in params.items()}
        state = (0, zeros, dict(zeros))
        carry, x_den = (x, params, state, H), None
        for i in range(len(t) - 1):
            carry, x_den = self._scan_step(operator, blind, carry, t[i], t[i + 1], gamma[i], noise)
        return carry[0], x_den, carry[1], carry[3]

    # --- entry points --------------------------------------------------------
    def predict_conditional_batched(self, ys, operator, blind: bool = False, noise=None,
                                    op_params_batch=None, H_batch=None):
        """Guided sampling of B utterances at once.

        ``ys``: (B, 1, n) observations.  Blind mode takes each utterance's
        operator parameters and initial H (leading batch axis, e.g. from
        ``BlindSubbandFiltering.reset_batched``); informed mode takes the
        subband filters ``H_batch`` (B, F, Nf) or, with a ``RIROperator``,
        the time-domain RIRs (B, M) — without them the operator's one RIR is
        shared by the batch.  ``noise`` is a ``NoiseSource`` (default: seed 0
        on the sampler's device).  Returns the final denoised estimates x_den
        (B, 1, n); in blind mode the final operator state is left on
        ``operator.params`` / ``operator.H``.
        """
        subband = hasattr(operator, "subband_filtering")
        if blind and (not subband or op_params_batch is None or H_batch is None):
            raise ValueError("blind mode needs a subband operator, op_params_batch and H_batch")
        if H_batch is None:
            if subband:
                raise ValueError("informed subband mode needs H_batch")
            H_batch = operator.params.expand((ys.shape[0],) + operator.params.shape[-1:])
        with span("dps.batch"):
            self._build_losses(operator, blind)
            noise = noise if noise is not None else self.default_noise()
            ys = ys.to(self.device)
            params = {k: v.to(self.device) for k, v in (op_params_batch or {}).items()}
            x, x_den, params, H = self._run(operator, blind, ys[:, 0], noise, params,
                                            H_batch.to(self.device))
        if blind:
            operator.params, operator.H = params, H
        return x_den[:, None]

    def predict_conditional(self, y, operator, blind: bool = False, noise=None):
        """Guided sampling of one utterance, the B = 1 case of the batched
        program.  ``y``: (1, n).  The operator carries its own state: blind
        mode starts from ``operator.params`` / ``operator.H`` (e.g. after
        ``reset``) and leaves the final state there, unbatched; informed mode
        reads ``operator.H`` (subband) or ``operator.params`` (the RIR).
        Returns the final denoised estimate (1, n)."""
        batch = lambda t: t if t is None else t[None]
        params = None
        if blind:
            params = {k: batch(v) for k, v in operator.params.items()}
            H = batch(operator.H) if operator.H is not None else operator.compute_H(params)
        elif hasattr(operator, "subband_filtering"):
            H = batch(operator.H)
        else:
            H = batch(operator.params)
        out = self.predict_conditional_batched(y[:, None, :], operator, blind=blind, noise=noise,
                                               op_params_batch=params, H_batch=H)
        if blind:
            operator.params = {k: v[0] for k, v in operator.params.items()}
            operator.H = operator.H[0]
        return out[:, 0, :]

    def predict_unconditional(self, *args, **kwargs):
        raise ValueError("DPS not made for unconditional sampling")
