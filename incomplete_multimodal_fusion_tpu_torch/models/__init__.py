from . import adapters, layers, multimae

__all__ = ["adapters", "layers", "multimae"]
