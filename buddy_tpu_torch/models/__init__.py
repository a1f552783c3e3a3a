import contextlib

import torch

from buddy_tpu_torch.models.ncsnpp import NCSNpp, NCSNppTime, NCSNppTimeModule


class NetworkBundle:
    """A network module presented as the callable ``(x, cnoise) -> x̂`` the
    samplers take (``buddy_tpu/models/__init__.py::NetworkBundle``, without
    the on-disk init cache: a random init here takes seconds)."""

    def __init__(self, module):
        self.module = module
        self._weights = None

    def __call__(self, x, cnoise):
        if self._weights is None:
            return self.module(x, cnoise)
        state = {**dict(self.module.named_buffers()), **self._weights}
        return torch.func.functional_call(self.module, state, (x, cnoise), strict=True)

    @contextlib.contextmanager
    def weights(self, state: dict):
        """Inside the block, calls run the module with the tensors of
        ``state`` (every parameter; buffers it lacks are the module's) in
        place of its own, which stay as they are: the trainer samples from
        its EMA this way while the module holds the weights it trains."""
        prev, self._weights = self._weights, state
        try:
            yield self
        finally:
            self._weights = prev

    def load_jax_params(self, tree) -> None:
        """Load the JAX package's variables (nested numpy dicts): the
        parameters, and the calibrated int8 scales of its "quant" collection
        where the network has them (zeros where the tree has none, as the
        JAX package's init gives)."""
        from buddy_tpu_torch.models.convert import from_jax_params
        state = from_jax_params(tree)
        scales = {n: b for n, b in self.module.named_buffers() if n.endswith("a_scale")}
        state = {k: v for k, v in state.items() if not k.endswith("a_scale") or k in scales}
        for name, buf in scales.items():
            state.setdefault(name, torch.zeros_like(buf, device="cpu"))
        self.module.load_state_dict(state, strict=True)

    def calibrate_quant(self, xs, cnoises) -> None:
        """Calibrate the int8 activation scales
        (``buddy_tpu/models/__init__.py::NetworkBundle.calibrate_quant``):
        run the network on each (x, cnoise) pair while every static int8
        conv maxes the |x| it sees, per input channel in float32, into its
        ``a_scale``.  As in the JAX package, the convs quantize dynamically
        while they observe, so a layer's maxima come from a network whose
        earlier layers ran the dynamic int8 path.  Later calls with
        ``quantize_static`` read the scales."""
        convs = [m for m in self.module.modules() if getattr(m, "a_scale", None) is not None]
        if not convs:
            raise ValueError("calibrate_quant: the network has no static int8 convolution "
                             "(network.quantize_int8 and network.quantize_static)")
        for m in convs:
            m.observing = True
        try:
            with torch.no_grad():
                for x, cnoise in zip(xs, cnoises):
                    self(x, cnoise)
        finally:
            for m in convs:
                m.observing = False

    @property
    def num_params(self) -> int:
        return sum(p.numel() for p in self.module.parameters())


__all__ = ["NCSNpp", "NCSNppTime", "NCSNppTimeModule", "NetworkBundle"]
