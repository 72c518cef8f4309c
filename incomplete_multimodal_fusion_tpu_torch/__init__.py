"""incomplete_multimodal_fusion_tpu_torch: the PyTorch and CUDA port of
``incomplete_multimodal_fusion_tpu`` for NVIDIA Hopper (H100).

The JAX package beside it is the reference this package is tested against.
This package imports ``torch`` and ``numpy``, never ``jax`` or ``flax``.
Ported so far: the MultiMAE ``crossattn`` serving forward (``infer.infer``,
``serving.infer_closure``), its pretraining step and state (``train.pretrain``
with the balancer, the EMA and ``make_multi_step``; ``utils.checkpoint``;
``cli.pretrain``), the converter of reference checkpoints
(``utils.torch_convert``) and the downstream MaskFormer segmentation forward
(``infer_segmentation.forward_segmentation`` and
``forward_instance_segmentation``), with hand-written CUDA kernels under
``csrc/`` (zorro attention, fused FFN, fusion-row attention, deformable
attention) in place of the JAX package's Pallas kernels.
"""

__version__ = "0.1.0"

from . import config, data, eval, infer, infer_segmentation, modalities, models, ops, serving, utils

__all__ = ["config", "data", "eval", "infer", "infer_segmentation", "modalities", "models", "ops",
           "serving", "utils", "__version__"]
