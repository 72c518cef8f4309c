"""incomplete_multimodal_fusion_tpu_torch: the PyTorch and CUDA port of
``incomplete_multimodal_fusion_tpu`` for NVIDIA Hopper (H100).

The JAX package beside it is the reference this package is tested against.
This package imports ``torch`` and ``numpy``, never ``jax`` or ``flax``.
Ported so far: the MultiMAE ``crossattn`` serving forward (``infer.infer``,
``serving.infer_closure``, the exported program of ``serving.export_infer`` /
``load_exported`` and ``cli.export_serving``), the batched decoder trunk, its pretraining step and state (``train.pretrain``
with the balancer, the EMA and ``make_multi_step``; ``utils.checkpoint``;
``cli.pretrain``), the converter of reference checkpoints
(``utils.torch_convert``, ``cli.convert_checkpoint``), the downstream
MaskFormer segmentation forward (``infer_segmentation.forward_segmentation``
and ``forward_instance_segmentation``) on every backbone and decoder of the
JAX package (the ViT-Adapter, 'sup', ResNet, Swin, the standard decoder),
its training step and CLI
(``train.downstream``, ``cli.train_downstream``), MAE inference with its
reconstruction grid (``cli.infer``), COCO mask evaluation
(``eval.coco_eval``, ``eval.structures``) and the host data path (``data``:
the DFC2023, COCO, quadruplet, ADE and SEN12MS readers, the TIFF codec, the
native raster ops, augmentation and the pinned loader that feeds the card),
with hand-written CUDA kernels under
``csrc/`` (zorro attention, fused FFN, fusion-row attention, deformable
attention) in place of the JAX package's Pallas kernels.
"""

__version__ = "0.1.0"

import importlib

__all__ = ["config", "data", "eval", "infer", "infer_segmentation", "modalities", "models", "ops",
           "serving", "utils", "__version__"]


def __getattr__(name):
    """The subpackages load on first use, so a process that only reloads an
    exported serving program (``serving.load_exported``) imports the
    kernels' operators and no model code."""
    if name in __all__:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
