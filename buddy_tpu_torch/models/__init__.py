from buddy_tpu_torch.models.ncsnpp import NCSNpp, NCSNppTime, NCSNppTimeModule


class NetworkBundle:
    """A network module presented as the callable ``(x, cnoise) -> x̂`` the
    samplers take (``buddy_tpu/models/__init__.py::NetworkBundle``, without
    the on-disk init cache: a random init here takes seconds)."""

    def __init__(self, module):
        self.module = module

    def __call__(self, x, cnoise):
        return self.module(x, cnoise)

    def load_jax_params(self, tree) -> None:
        """Load the JAX package's parameter tree (nested numpy dicts)."""
        from buddy_tpu_torch.models.convert import from_jax_params
        self.module.load_state_dict(from_jax_params(tree), strict=True)

    @property
    def num_params(self) -> int:
        return sum(p.numel() for p in self.module.parameters())


__all__ = ["NCSNpp", "NCSNppTime", "NCSNppTimeModule", "NetworkBundle"]
