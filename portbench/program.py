"""The one place that knows the port's entry points: the configuration it
composes, the objects the benchmark drives, and the launch counters of its
kernel wrappers. Imported only once the run has found its device."""

from __future__ import annotations

import json


def compose_args(config: dict, cell: dict, extra=()):
    """The port's composed configuration for a cell: the tester named by the
    cell, the configuration's network keys and the cell's precision
    profile, then the cell's own overrides and ``extra``."""
    from buddy_tpu_torch.config import compose
    net = {**config["network"], **config["profiles"][cell["profile"]]}
    ov = [f"tester={cell['tester']}"] if cell.get("tester") else []
    ov += [f"network.{k}={json.dumps(v)}" for k, v in net.items()]
    ov += list(cell.get("overrides", [])) + list(extra)
    return compose("conf_VCTK.yaml", ov)


def build_network(args, device, weights: dict, inference: bool):
    """The port's network from the composed config (``NCSNppTime`` through
    ``instantiate``, as the CLIs build it), with the benchmark's weights."""
    from buddy_tpu_torch.config import instantiate
    from buddy_tpu_torch.models import NetworkBundle
    module = instantiate(args["network"], device=device)
    module.load_state_dict(weights, strict=True)
    if inference:
        module.requires_grad_(False)
    return NetworkBundle(module)


def noise_source(seed: int):
    """The port's noise source over a host generator seeded with ``seed``,
    as ``Tester`` and ``Trainer`` build theirs: each draw made on the host
    and moved to the device."""
    import torch
    from buddy_tpu_torch.sampling.euler_heun import NoiseSource
    return NoiseSource(torch.Generator().manual_seed(int(seed)))


def launch_counters() -> dict:
    """{name: the wrapper function whose ``launches`` counts its launches}."""
    import importlib
    mod = lambda name: importlib.import_module(f"buddy_tpu_torch.ops.{name}")
    groupnorm, _stft, subband_conv, spec_loss = (mod(n) for n in ("groupnorm", "stft",
                                                                  "subband_conv", "spec_loss"))
    minphase, filter_design, wpe_solve, resample = (mod(n) for n in ("minphase", "filter_design",
                                                                     "wpe_solve", "resample"))
    return {
        "k1_fwd": groupnorm.group_norm_act, "k1_bwd": groupnorm.group_norm_act_backward,
        "k2_analysis": _stft.stft_analysis, "k2_synthesis": _stft.stft_synthesis,
        "k3_conv": subband_conv.subband_conv, "k3_adjoint": subband_conv.subband_conv_adjoint,
        "k3_filter_grad": subband_conv.subband_conv_filter_grad,
        "k3_frame_spectrum": subband_conv.frame_spectrum,
        "k4_compress": spec_loss.spec_compress, "k4_compress_bwd": spec_loss.spec_compress_backward,
        "k4_loss": spec_loss.comp_loss, "k4_loss_bwd": spec_loss.comp_loss_backward,
        "k5_fwd": minphase.minimum_phase_version, "k5_bwd": minphase.minimum_phase_backward,
        "k6_fwd": filter_design.filter_design, "k6_bwd": filter_design.filter_design_backward,
        "k7": wpe_solve.wpe_solve,
        "k11_fwd": resample.upfirdn2d, "k11_bwd": resample.upfirdn2d_backward,
    }


def read_counters() -> dict:
    return {k: int(getattr(f, "launches", 0)) for k, f in launch_counters().items()}


def k11_record(on: bool):
    """Start (``on``) or stop counting K11's launches by geometry; returns the
    record kept so far."""
    import importlib
    resample = importlib.import_module("buddy_tpu_torch.ops.resample")
    rec = resample.upfirdn2d.record
    resample.upfirdn2d.record = {} if on else None
    return rec


class GroupNormCalls:
    """Counts the K1 calls of a network by (shape, dtype, with backward):
    forward pre-hooks on its GroupNorm modules. A call whose input takes a
    gradient is followed by one backward launch."""

    def __init__(self, module):
        import torch
        self.calls: dict = {}
        self._handles = []
        for m in module.modules():
            if type(m).__name__ == "GroupNormAct":
                self._handles.append(m.register_forward_pre_hook(self._hook))
        self._torch = torch

    def _hook(self, _module, args):
        x = args[0]
        bwd = bool(self._torch.is_grad_enabled() and x.requires_grad)
        key = (tuple(x.shape), str(x.dtype), bwd)
        self.calls[key] = self.calls.get(key, 0) + 1

    def remove(self):
        for h in self._handles:
            h.remove()
        self._handles = []
