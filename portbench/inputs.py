"""What the benchmark makes from ``--seed`` and hands to both sides: the
network's weights, the reverberant observations, the training WAV files
and the seeds of every random draw.

Each quantity comes from its own stream, keyed by the seed and names
(``stream_seed``). Weights and inputs are made on the run's device, in a
few large calls. The sampler's and the trainer's draws come from the
program's own noise source over a host generator seeded from such a
stream, as its tester and trainer draw them (on the host, then moved to
the device); the reference makes them again from the same seed
(``replay``).
"""

from __future__ import annotations

import hashlib
import math
import os
import wave

import numpy as np
import torch
import torch.nn.functional as F


def stream_seed(seed: int, *parts) -> int:
    """A 63-bit generator seed for the stream named by ``parts`` under ``seed``."""
    digest = hashlib.blake2b(repr((int(seed),) + parts).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & (2 ** 63 - 1)


def generator(device, seed: int, *parts) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, *parts))
    return g


class LoggedNoise:
    """A noise source that hands every draw on to ``inner`` (the program's
    own source, as its tester and trainer build it) and keeps the method,
    kind and shape of each draw, in order, in ``log``."""

    def __init__(self, inner):
        self.inner, self.log = inner, []

    def normal(self, kind, shape, device):
        self.log.append(("normal", kind, tuple(int(s) for s in shape)))
        return self.inner.normal(kind, shape, device)

    def uniform(self, kind, shape, device):
        self.log.append(("uniform", kind, tuple(int(s) for s in shape)))
        return self.inner.uniform(kind, shape, device)


def replay(seed: int, draws, device, rows=None) -> dict:
    """{(kind, n): the n-th draw of kind}: ``draws`` ([(method, kind,
    shape)], the order a source is asked in) made again on the host from a
    generator seeded with ``seed``, as the program's source makes them, and
    moved to ``device``; only ``rows`` of each (every draw leads with the
    batch axis)."""
    g = torch.Generator().manual_seed(int(seed))
    out, counts = {}, {}
    for method, kind, shape in draws:
        d = (torch.randn if method == "normal" else torch.rand)(shape, generator=g)
        n = counts.get(kind, 0)
        counts[kind] = n + 1
        out[(kind, n)] = (d if rows is None else d[torch.as_tensor(rows)]).to(device)
    return out


class TableNoise:
    """Hands out the draws of a table from ``replay``: the n-th draw of a
    kind is the n-th asked for, counted in ``counts`` (which the caller may
    set to take up a later step)."""

    def __init__(self, table: dict):
        self.table, self.counts = table, {}

    def _take(self, kind, shape):
        n = self.counts.get(kind, 0)
        self.counts[kind] = n + 1
        out = self.table[(kind, n)]
        if tuple(out.shape[1:]) != tuple(int(s) for s in shape[1:]):
            raise ValueError(f"draw {kind} {n}: {tuple(out.shape)} asked as {tuple(shape)}")
        return out

    def normal(self, kind, shape, device=None):
        return self._take(kind, shape)

    uniform = normal


# --- weights ----------------------------------------------------------------
def make_weights(shapes: dict, seed: int, device, fourier_scale: float) -> dict:
    """A state dict for ``shapes`` ({name: shape}, the port's names): one
    uniform draw split into the leaves, then each leaf scaled. Convolution,
    dense and NIN weights are variance-scaled over the mean fan (scale 1 for
    every one of them, the residual branches' last convs and the output conv
    included); biases uniform in +-0.05; GroupNorm scales 1 +- 0.1 and
    offsets +- 0.05; the Fourier features normal with ``fourier_scale``."""
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.rand(total, generator=generator(device, seed, "weights"), device=device)
    flat.mul_(2.0).sub_(1.0)                                        # U(-1, 1)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        w = flat[at:at + n].view(shape)
        at += n
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "W" and len(shape) == 1:                         # Fourier features
            w.copy_(torch.randn(shape, generator=generator(device, seed, "fourier"),
                                device=device)).mul_(fourier_scale)
        elif "GroupNorm" in name:
            w.mul_(0.1).add_(1.0) if leaf == "weight" else w.mul_(0.05)
        elif len(shape) == 1:                                       # biases
            w.mul_(0.05)
        else:
            if len(shape) == 4:                                     # (O, I, kh, kw)
                rf = shape[2] * shape[3]
                fan = (shape[0] * rf + shape[1] * rf) / 2.0
            else:                                                   # (O, I) or NIN's (I, O)
                fan = (shape[0] + shape[1]) / 2.0
            w.mul_(math.sqrt(3.0 / fan))
        out[name] = w
    return out


# --- serving inputs -------------------------------------------------------------
def speech_like(g: torch.Generator, B: int, n: int, fs: int, device) -> torch.Tensor:
    """(B, n) speech-like signals: a harmonic source on a gliding f0 mixed
    with noise, voiced and unvoiced by a slow random switch, spectrally
    tilted, under a syllabic envelope with pauses (34 dB or more down, never
    silent: a short row could otherwise be all pause); unit variance a row."""
    t = torch.arange(n, device=device, dtype=torch.float32) / fs
    f0 = 90.0 + 160.0 * torch.rand((B, 1), generator=g, device=device)
    glide = 1.0 + 0.15 * torch.sin(2 * math.pi * (0.3 + 0.7 * torch.rand((B, 1), generator=g,
                                                                      device=device)) * t)
    phase = 2 * math.pi * torch.cumsum(f0 * glide / fs, dim=-1)
    harm = torch.arange(1, 13, device=device, dtype=torch.float32)
    voiced = (torch.sin(phase[..., None] * harm) / harm).sum(-1)
    noise = torch.randn((B, n), generator=g, device=device)

    def slow(rate_hz: float):
        k = max(2, int(n / fs * rate_hz))
        ctl = torch.randn((B, 1, k), generator=g, device=device)
        return F.interpolate(ctl, size=n, mode="linear", align_corners=True)[:, 0]

    voicing = torch.sigmoid(4.0 * slow(3.0))
    src = voicing * voiced + (1.0 - voicing) * 0.5 * noise
    spec = torch.fft.rfft(src)
    f = torch.fft.rfftfreq(n, 1.0 / fs).to(device)
    spec = spec / (1.0 + f / 400.0)
    x = torch.fft.irfft(spec, n=n) * (torch.relu(slow(5.0) + 0.3) + 0.02)
    return x / x.std(dim=-1, keepdim=True)


def exp_noise_rirs(g: torch.Generator, B: int, length: int, fs: int, t60, drr_db, device):
    """(B, length) RIRs: a unit direct path, then Gaussian noise decaying
    exponentially with a T60 drawn uniformly in ``t60`` (seconds), scaled
    to a direct-to-reverberant ratio drawn uniformly in ``drr_db``, a row."""
    t = torch.arange(1, length, device=device, dtype=torch.float32) / fs
    u = torch.rand((B, 2), generator=g, device=device)
    T = t60[0] + (t60[1] - t60[0]) * u[:, :1]
    drr = drr_db[0] + (drr_db[1] - drr_db[0]) * u[:, 1:]
    tail = torch.randn((B, length - 1), generator=g, device=device) * torch.exp(-6.908 * t / T)
    tail = tail * torch.sqrt(10.0 ** (-drr / 10.0) / (tail ** 2).sum(-1, keepdim=True))
    return torch.cat([torch.ones((B, 1), device=device), tail], dim=-1)


def observations(seed: int, batch_index: int, traffic: dict, scaling: float, device):
    """(B, n) reverberant observations of batch ``batch_index`` and their
    (B, M) RIRs: speech-like utterances at the tester's scale (``scaling`` /
    std), convolved with exponentially decaying noise RIRs, cropped to n
    samples."""
    g = generator(device, seed, "observations", batch_index)
    B, n, fs = int(traffic["batch"]), int(traffic["audio_len"]), int(traffic["sample_rate"])
    x = scaling * speech_like(g, B, n, fs, device)
    rir = exp_noise_rirs(g, B, int(traffic["rir_s"] * fs), fs, traffic["t60_s"],
                         traffic["drr_db"], device)
    m = n + rir.shape[-1]
    y = torch.fft.irfft(torch.fft.rfft(x, n=m) * torch.fft.rfft(rir, n=m), n=m)[:, :n]
    return y.contiguous(), rir


def reset_noise(seed: int, batch_index: int, B: int, length: int, device) -> torch.Tensor:
    """The phase noise (B, length) of batch ``batch_index``'s operator reset,
    drawn on the host from ``stream_seed(seed, "reset", batch_index)`` as the
    tester's reset source draws it."""
    g = torch.Generator().manual_seed(stream_seed(seed, "reset", batch_index))
    return torch.randn((B, length), generator=g).to(device)


# --- training inputs ------------------------------------------------------------
def write_training_set(root: str, seed: int, traffic: dict, device) -> dict:
    """``traffic["files"]`` speech-like utterances of ``traffic["file_s"]``
    seconds, 16-bit PCM, under ``root/<speaker>/``, the layout the port's
    training set scans. Returns {path: the float32 samples a reader gets}."""
    fs, n = int(traffic["sample_rate"]), int(traffic["file_s"] * traffic["sample_rate"])
    files, per = int(traffic["files"]), int(traffic["files_per_speaker"])
    x = speech_like(generator(device, seed, "train_files"), files, n, fs, device)
    pcm = torch.clamp(torch.round(0.1 * x * 32768.0), -32768, 32767).to(torch.int16).cpu().numpy()
    out = {}
    for i in range(files):
        spk = os.path.join(root, f"p{300 + i // per}")
        os.makedirs(spk, exist_ok=True)
        path = os.path.join(spk, f"utt{i:03d}.wav")
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(fs)
            w.writeframes(pcm[i].tobytes())
        out[path] = pcm[i].astype(np.float32) / np.float32(32768.0)
    return out
