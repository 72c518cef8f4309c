from . import coco_eval, metrics, structures

__all__ = ["coco_eval", "metrics", "structures"]
