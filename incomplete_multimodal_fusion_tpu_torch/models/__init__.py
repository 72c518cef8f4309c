from . import (adapters, dpt_utils, layers, mask2former_decoder, maskformer, maskformer_decoder, msda_module,
               multimae, pixel_decoder, position_encoding, resnet, swin, vit_adapter, vit_baseline)

__all__ = ["adapters", "dpt_utils", "layers", "mask2former_decoder", "maskformer", "maskformer_decoder",
           "msda_module", "multimae", "pixel_decoder", "position_encoding", "resnet", "swin", "vit_adapter",
           "vit_baseline"]
