from . import checkpoint, jax_params, logging, torch_convert

__all__ = ["checkpoint", "jax_params", "logging", "torch_convert"]
