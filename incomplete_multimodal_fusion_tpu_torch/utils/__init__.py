from . import jax_params

__all__ = ["jax_params"]
