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
        return torch.func.functional_call(self.module, self._weights, (x, cnoise), strict=True)

    @contextlib.contextmanager
    def weights(self, state: dict):
        """Inside the block, calls run the module with the tensors of
        ``state`` (a full state dict) in place of its parameters, which stay
        as they are: the trainer samples from its EMA this way while the
        module holds the weights it trains."""
        prev, self._weights = self._weights, state
        try:
            yield self
        finally:
            self._weights = prev

    def load_jax_params(self, tree) -> None:
        """Load the JAX package's parameter tree (nested numpy dicts)."""
        from buddy_tpu_torch.models.convert import from_jax_params
        self.module.load_state_dict(from_jax_params(tree), strict=True)

    @property
    def num_params(self) -> int:
        return sum(p.numel() for p in self.module.parameters())


__all__ = ["NCSNpp", "NCSNppTime", "NCSNppTimeModule", "NetworkBundle"]
