"""STFT / ISTFT with torch.stft / torch.istft semantics, and kernel K2.

Semantics (``buddy_tpu/ops/stft.py``): center padding of n_fft//2 on both
sides (``reflect`` for the model, ``constant`` for the operators), onesided,
not normalized; the ISTFT overlap-adds, divides by the window-squared
envelope guarded at 1e-11, trims the centre padding and crops or zero-pads
to ``length``.  The window is given at full n_fft length (the operators
right-pad a hann(512) to 1024).

Formulation (the TPU's conv-STFT, ``_stft_conv`` / ``_istft_conv``): the
padded signal is cut into blocks of ``hop`` samples; frame t is
sum_j block[t + j] @ A[j], with A the window-folded real-DFT basis cut
into taps = ceil(window support / hop) slices of hop rows.  The ISTFT is the
tap sum in the other direction: output block b gathers
sum_j spec[b - j] @ V[j] with V the window-folded inverse-DFT basis.

K2 is that pair as CUDA kernels (``csrc/stft.cu``): ``stft_analysis`` and
``stft_synthesis``.  Each is the other's adjoint with the transposed basis,
so the autograd functions below use the pair both ways.  On a CPU tensor
the wrappers run the plain PyTorch tap sums instead.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from buddy_tpu_torch.device import resolve_device
from buddy_tpu_torch.ops import _build

_SIGNATURES = {
    name: [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    for name in ("stft_analysis", "stft_synthesis")
}


def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window — torch.hann_window(n, periodic=True) — as
    float32 numpy (computed in float64)."""
    k = np.arange(n)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * k / n))).astype(np.float32)


def window_support(w: np.ndarray) -> int:
    """Length of the window's nonzero prefix."""
    nz = np.nonzero(w)[0]
    return int(nz[-1]) + 1 if len(nz) else len(w)


def pad_spec_frames(spec: torch.Tensor, multiple: int = 16) -> torch.Tensor:
    """Zero-pad the frame axis (last) to a multiple of ``multiple``."""
    rem = spec.shape[-1] % multiple
    if rem == 0:
        return spec
    return F.pad(spec, (0, multiple - rem))


# ---------------------------------------------------------------------------
# K2: the two tap-sum kernels, their plain versions and autograd functions
# ---------------------------------------------------------------------------
def analysis_plain(blocks: torch.Tensor, basis: torch.Tensor, n_frames: int) -> torch.Tensor:
    """(N, nb, hop) real blocks, (taps, hop, 2F) basis -> (N, F, n_frames)
    complex: out[:, :, t] = sum_j blocks[:, t + j] @ basis[j]."""
    taps = basis.shape[0]
    out = sum(blocks[:, j:j + n_frames] @ basis[j] for j in range(taps))
    nbin = basis.shape[-1] // 2
    return torch.complex(out[..., :nbin], out[..., nbin:]).transpose(-1, -2)


def synthesis_plain(spec: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """(N, F, T) complex, (taps, 2F, hop) basis -> (N, (T + taps - 1) * hop):
    block b = sum_j [re; im](spec[:, :, b - j]) @ basis[j]."""
    taps = basis.shape[0]
    z = torch.cat([spec.real, spec.imag], dim=1).transpose(1, 2)   # (N, T, 2F)
    out = sum(F.pad(z @ basis[j], (0, 0, j, taps - 1 - j)) for j in range(taps))
    return out.reshape(out.shape[0], -1)


def _check(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous float32 CUDA tensor, "
                         f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})")


def _launch_analysis(blocks: torch.Tensor, basis: torch.Tensor, n_frames: int) -> torch.Tensor:
    """Kernel: (N, nb, hop) float blocks -> (N, F, n_frames) complex64."""
    _check(blocks, "stft_analysis blocks")
    _check(basis, "stft_analysis basis")
    taps, hop, two_f = basis.shape
    N, nb, hop_b = blocks.shape
    if hop_b != hop or nb < n_frames + taps - 1:
        raise ValueError(f"stft_analysis: blocks {tuple(blocks.shape)} do not fit "
                         f"basis {tuple(basis.shape)} at {n_frames} frames")
    out = torch.empty((N, two_f // 2, n_frames, 2), device=blocks.device, dtype=torch.float32)
    lib = _build.load("stft", _SIGNATURES)
    err = lib.stft_analysis(_build.ptr(blocks), _build.ptr(basis), _build.ptr(out), N, nb,
                            hop, taps, two_f // 2, n_frames, _build.stream(blocks.device))
    _build.check(err, "stft_analysis")
    stft_analysis.launches += 1
    return torch.view_as_complex(out)


def _launch_synthesis(spec: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """Kernel: (N, F, T) complex64 -> (N, T + taps - 1, hop) float."""
    z = torch.view_as_real(spec.resolve_conj().contiguous())
    _check(z, "stft_synthesis spectrum")
    _check(basis, "stft_synthesis basis")
    taps, two_f, hop = basis.shape
    N, nbin, T, _ = z.shape
    if 2 * nbin != two_f:
        raise ValueError(f"stft_synthesis: {nbin} bins do not fit basis {tuple(basis.shape)}")
    nb_out = T + taps - 1
    out = torch.empty((N, nb_out, hop), device=z.device, dtype=torch.float32)
    lib = _build.load("stft", _SIGNATURES)
    err = lib.stft_synthesis(_build.ptr(z), _build.ptr(basis), _build.ptr(out), N, nb_out,
                             hop, taps, nbin, T, _build.stream(z.device))
    _build.check(err, "stft_synthesis")
    stft_synthesis.launches += 1
    return out


class _AnalysisFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, blocks, basis, basis_adj, n_frames):
        ctx.save_for_backward(basis_adj)
        ctx.nb = blocks.shape[1]
        return _launch_analysis(blocks, basis, n_frames)

    @staticmethod
    def backward(ctx, grad):
        (basis_adj,) = ctx.saved_tensors
        g = _launch_synthesis(grad, basis_adj)             # (N, T + taps - 1, hop)
        g = F.pad(g, (0, 0, 0, ctx.nb - g.shape[1]))
        return g, None, None, None


class _SynthesisFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, basis, basis_adj):
        ctx.save_for_backward(basis_adj)
        ctx.n_frames = spec.shape[-1]
        return _launch_synthesis(spec, basis).reshape(spec.shape[0], -1)

    @staticmethod
    def backward(ctx, grad):
        (basis_adj,) = ctx.saved_tensors
        hop = basis_adj.shape[1]
        g = grad.contiguous().reshape(grad.shape[0], -1, hop)
        return _launch_analysis(g, basis_adj, ctx.n_frames), None, None


def stft_analysis(blocks, basis, basis_adj, n_frames: int) -> torch.Tensor:
    """K2 analysis: (N, nb, hop) real blocks -> (N, F, n_frames) complex.

    ``basis_adj`` is ``basis`` transposed to (taps, 2F, hop), used by the
    backward.  CPU tensors take the plain version; CUDA tensors the kernel.
    """
    if blocks.device.type == "cpu":
        return analysis_plain(blocks, basis, n_frames)
    return _AnalysisFn.apply(blocks, basis, basis_adj, n_frames)


def stft_synthesis(spec, basis, basis_adj) -> torch.Tensor:
    """K2 synthesis: (N, F, T) complex -> (N, (T + taps - 1) * hop) real,
    before the envelope division.  ``basis_adj`` is ``basis`` transposed to
    (taps, hop, 2F), used by the backward."""
    if spec.device.type == "cpu":
        return synthesis_plain(spec, basis)
    return _SynthesisFn.apply(spec, basis, basis_adj)


stft_analysis.launches = 0
stft_synthesis.launches = 0


# ---------------------------------------------------------------------------
# one STFT geometry
# ---------------------------------------------------------------------------
class STFT:
    """An STFT geometry (n_fft, hop, window, pad mode) with its bases on
    ``device``; ``stft`` and ``istft`` follow torch.stft / torch.istft."""

    def __init__(self, n_fft: int, hop_length: int, window: np.ndarray, *,
                 pad_mode: str = "reflect", device=None):
        window = np.asarray(window, np.float32)
        if window.shape != (n_fft,):
            raise ValueError("window must be length n_fft (pre-padded)")
        self.n_fft, self.hop, self.pad_mode = n_fft, hop_length, pad_mode
        self.device = resolve_device(device)
        self.n_bins = n_fft // 2 + 1
        self.taps = -(-window_support(window) // hop_length)
        rows = self.taps * hop_length
        w = window.astype(np.float64)
        k = np.arange(n_fft, dtype=np.float64)[:, None]
        f = np.arange(self.n_bins, dtype=np.float64)[None, :]
        ang = 2.0 * np.pi * k * f / n_fft                               # (n_fft, F)
        fwd = np.concatenate([w[:, None] * np.cos(ang), -w[:, None] * np.sin(ang)], 1)
        scale = np.full((1, self.n_bins), 2.0 / n_fft)
        scale[0, 0] = 1.0 / n_fft
        if n_fft % 2 == 0:
            scale[0, -1] = 1.0 / n_fft
        inv = np.concatenate([np.cos(ang) * scale, -np.sin(ang) * scale], 1).T * w[None, :]
        fwd = np.pad(fwd, ((0, max(0, rows - n_fft)), (0, 0)))[:rows]   # (rows, 2F)
        inv = np.pad(inv, ((0, 0), (0, max(0, rows - n_fft))))[:, :rows]  # (2F, rows)
        A = fwd.reshape(self.taps, hop_length, 2 * self.n_bins)
        V = inv.reshape(2 * self.n_bins, self.taps, hop_length).transpose(1, 0, 2)
        as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=self.device)
        self.A, self.A_adj = as_t(A), as_t(A.transpose(0, 2, 1))       # (taps, hop, 2F), adj
        self.V, self.V_adj = as_t(V), as_t(V.transpose(0, 2, 1))       # (taps, 2F, hop), adj
        self._wsq = w ** 2
        self._env: dict = {}

    def frame_blocks(self, x: torch.Tensor):
        """(N, L) real -> the centre-padded signal as (N, nb, hop) blocks,
        and the frame count."""
        p = self.n_fft // 2
        x = F.pad(x[:, None], (p, p), mode=self.pad_mode)[:, 0]
        L = x.shape[-1]
        n_frames = 1 + (L - self.n_fft) // self.hop
        nb = max(-(-L // self.hop), n_frames - 1 + self.taps)
        return F.pad(x, (0, nb * self.hop - L)).reshape(-1, nb, self.hop), n_frames

    def stft(self, x: torch.Tensor) -> torch.Tensor:
        """(..., L) real -> (..., F, n_frames) complex64."""
        lead = x.shape[:-1]
        blocks, n_frames = self.frame_blocks(x.reshape(-1, x.shape[-1]))
        spec = stft_analysis(blocks, self.A, self.A_adj, n_frames)
        return spec.reshape(lead + spec.shape[1:])

    def _envelope(self, n_frames: int) -> torch.Tensor:
        env = self._env.get(n_frames)
        if env is None:
            ola_len = self.n_fft + self.hop * (n_frames - 1)
            e = np.zeros(ola_len, np.float64)
            for t in range(n_frames):
                e[t * self.hop: t * self.hop + self.n_fft] += self._wsq
            env = torch.as_tensor(np.where(e > 1e-11, e, 1.0).astype(np.float32),
                                  device=self.device)
            self._env[n_frames] = env
        return env

    def istft(self, spec: torch.Tensor, length: int | None = None) -> torch.Tensor:
        """(..., F, n_frames) complex -> (..., length) real."""
        lead, n_frames = spec.shape[:-2], spec.shape[-1]
        spec = spec.reshape((-1,) + spec.shape[-2:]).to(torch.complex64)
        y = stft_synthesis(spec, self.V, self.V_adj)
        ola_len = self.n_fft + self.hop * (n_frames - 1)
        y = F.pad(y, (0, ola_len - y.shape[-1])) if y.shape[-1] < ola_len else y[:, :ola_len]
        y = y / self._envelope(n_frames)
        start = self.n_fft // 2
        end = start + length if length is not None else ola_len - start
        if end > ola_len:
            y = F.pad(y, (0, end - ola_len))
        y = y[:, start:end]
        return y.reshape(lead + y.shape[-1:])
