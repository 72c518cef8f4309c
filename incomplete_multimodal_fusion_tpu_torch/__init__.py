"""incomplete_multimodal_fusion_tpu_torch: the PyTorch and CUDA port of
``incomplete_multimodal_fusion_tpu`` for NVIDIA Hopper (H100).

The JAX package beside it is the reference this package is tested against.
This package imports ``torch`` and ``numpy``, never ``jax`` or ``flax``. Ported so far: the MultiMAE ``crossattn`` serving
forward (``infer.infer``, ``serving.infer_closure``), with three hand-written
CUDA kernels under ``csrc/`` (zorro attention, fused FFN, fusion-row
attention) in place of the JAX package's Pallas forward kernels.
"""

__version__ = "0.1.0"

from . import config, data, infer, modalities, models, ops, serving, utils

__all__ = ["config", "data", "infer", "modalities", "models", "ops", "serving", "utils",
           "__version__"]
