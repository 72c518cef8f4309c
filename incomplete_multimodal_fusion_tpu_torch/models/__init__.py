from . import (adapters, layers, mask2former_decoder, maskformer, msda_module, multimae,
               pixel_decoder, position_encoding, vit_baseline)

__all__ = ["adapters", "layers", "mask2former_decoder", "maskformer", "msda_module", "multimae",
           "pixel_decoder", "position_encoding", "vit_baseline"]
