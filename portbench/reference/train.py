"""The EDM training step of BUDDy's prior (sp-uhh/buddy ``training/trainer.py``
with optax's chain), in plain float32 PyTorch.

Per step: noise levels rho-warped between sigma_max and sigma_min, the
preconditioned denoising error's plain mean, its gradient, the global-norm
clip (left alone below max_norm, else scaled to it), Adam with its bias
corrections and eps outside the square root, then the EMA with its linear
rampup. The gradient of the whole batch is summed over blocks of rows so
that a large batch fits.
"""

from __future__ import annotations

import numpy as np
import torch


class TrainReference:
    def __init__(self, args, net, edm, block_rows: int):
        exp = args["exp"]
        opt = exp["optimizer"]
        self.net, self.edm, self.block = net, edm, int(block_rows)
        self.lr, self.eps = float(opt["lr"]), float(opt["eps"])
        self.b1, self.b2 = float(opt["betas"][0]), float(opt["betas"][1])
        self.max_norm = float(exp["max_grad_norm"]) if exp["use_grad_clip"] else None
        self.batch, self.rate, self.rampup = int(exp["batch_size"]), float(exp["ema_rate"]), \
            float(exp["ema_rampup"])
        self.params = dict(net.named_parameters())
        self.trainable = [n for n, p in self.params.items() if p.requires_grad]
        self.mu = {n: torch.zeros_like(self.params[n]) for n in self.trainable}
        self.nu = {n: torch.zeros_like(self.params[n]) for n in self.trainable}
        self.ema = {n: p.detach().clone() for n, p in self.params.items()}
        self.count = 0

    def sigmas(self, a):
        e = self.edm
        return (e.smax ** (1 / e.rho) + a * (e.smin ** (1 / e.rho) - e.smax ** (1 / e.rho))) \
            ** e.rho

    def step(self, x, a, n, it: int):
        """One step on the clean batch x (B, T) with uniform draws a (B,) and
        unit noise n (B, T); returns (loss, the clipped gradients)."""
        sigma = self.sigmas(a)[:, None]
        cskip, cout, cin = self.edm.coefficients(sigma)
        xp = x + sigma * n
        inp = cin * xp
        target = (x - cskip * xp) / cout
        cnoise = 0.25 * torch.log(sigma[:, 0])
        for p in self.params.values():
            p.grad = None
        total = float(x.numel())
        loss = torch.zeros((), device=x.device)
        for s in range(0, x.shape[0], self.block):
            sl = slice(s, s + self.block)
            err = (self.net(inp[sl][:, None], cnoise[sl])[:, 0] - target[sl]) ** 2
            part = err.sum() / total
            part.backward()
            loss = loss + part.detach()
        with torch.no_grad():
            grads = [self.params[k].grad for k in self.trainable]
            g_norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))
            if self.max_norm is not None and not bool(g_norm < self.max_norm):
                grads = [g / g_norm * self.max_norm for g in grads]
            self.count += 1
            bc1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(self.count))
            bc2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(self.count))
            for k, g in zip(self.trainable, grads):
                self.mu[k] = self.b1 * self.mu[k] + (1 - self.b1) * g
                self.nu[k] = self.b2 * self.nu[k] + (1 - self.b2) * g * g
                upd = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + self.eps)
                self.params[k].sub_(self.lr * upd)
            t = np.float32(it) * np.float32(self.batch)
            s = np.clip(t / np.float32(self.rampup), np.float32(0.0), np.float32(self.rate)) \
                if t < self.rampup else np.float32(self.rate)
            for k, p in self.params.items():
                self.ema[k] = self.ema[k] * float(s) + p * float(np.float32(1.0) - s)
        return loss, dict(zip(self.trainable, grads))
