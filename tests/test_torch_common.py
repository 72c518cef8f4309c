"""Shared helpers of the test_torch_* parity tests (this module holds no
tests): one seeded numpy source of inputs and weights for both the JAX
package and its PyTorch port, and the bridge that carries a flax parameter
tree into the port."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from incomplete_multimodal_fusion_tpu_torch.utils.jax_params import params_from_jax

torch.set_num_threads(1)

DOMAINS = ("s1", "s2", "dem")
CHANNELS = {"s1": 1, "s2": 3, "dem": 1}

# the shape of tests/test_fullmodel_parity.py:36-52
SMALL = dict(
    in_domains=DOMAINS, out_domains=DOMAINS, image_size=64, patch_size=16, dim_tokens=64,
    depth=2, dim_head=16, heads=2, ff_mult=4, num_fusion_tokens=16, decoder_dim=32,
    decoder_depth=2, decoder_num_heads=2,
)
NP_ = 16  # patches per modality at SMALL


def random_params(flax_module, seed, *args, **kwargs):
    """A flax parameter tree for ``flax_module.apply(..., *args)`` with
    values drawn from numpy: shapes come from ``jax.eval_shape`` (tracing
    only, no compile); norm gains near 1, kernels normals of std
    fan_in ** -0.5, biases and everything else small normals, so every
    parameter moves the output."""
    shapes = jax.eval_shape(lambda: flax_module.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = getattr(path[-1], "key", "")
        if name in ("gamma", "scale"):
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if name == "kernel" and len(leaf.shape) == 4:  # conv [kh, kw, in, out]
            scale = float(np.prod(leaf.shape[:3])) ** -0.5
        else:
            fan_in = leaf.shape[0] if len(leaf.shape) == 2 else 1
            scale = fan_in ** -0.5 if len(leaf.shape) == 2 else 0.1
        return (scale * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)["params"]


def port_module(module: torch.nn.Module, flax_params) -> torch.nn.Module:
    """``module`` with the flax tree's weights loaded (strict) in eval mode."""
    module.load_state_dict(params_from_jax(flax_params), strict=True)
    return module.eval()


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def as_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def as_torch(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}
