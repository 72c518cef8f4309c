"""Single modality registry, entry for entry the JAX package's.

Token-type ids follow the reference Zorro enum
(downstream/instance_segmentation/modeling/multimae/zorro_utils.py:14-18):
the FUSION type is always the last id (== number of input modalities).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class ModalitySpec:
    name: str
    num_channels: int
    stride_level: int = 1
    loss: str = "mse"  # 'mse' | 'l1' | 'cross_entropy'
    adapter: str = "patched"  # 'patched' | 'semseg'
    num_classes: Optional[int] = None  # for 'semseg' adapters
    dim_class_emb: int = 64


# Reference configurations:
#  * 3-modality rgb/sar/dsm (pretrain_mmae.py:45-72): s1 1ch MSE, s2 3ch MSE,
#    dem 1ch L1.
#  * quadruplet (pretrain_mmae_my.py:46-92): s1 2ch, s2 4ch, dem 1ch,
#    dnw 9-class SemSeg w/ MaskedCrossEntropyLoss.
REGISTRY: Dict[str, ModalitySpec] = {
    "s1": ModalitySpec("s1", num_channels=1, loss="mse"),
    "s2": ModalitySpec("s2", num_channels=3, loss="mse"),
    "dem": ModalitySpec("dem", num_channels=1, loss="l1"),
    "s1_2ch": ModalitySpec("s1_2ch", num_channels=2, loss="mse"),
    "s2_4ch": ModalitySpec("s2_4ch", num_channels=4, loss="mse"),
    "dnw": ModalitySpec(
        "dnw", num_channels=1, loss="cross_entropy", adapter="semseg", num_classes=9
    ),
}


def get(name: str) -> ModalitySpec:
    return REGISTRY[name]


def token_type_ids(in_domains: Tuple[str, ...]) -> Dict[str, int]:
    """Map modality name -> token-type id; 'fusion' is the last id."""
    ids = {d: i for i, d in enumerate(in_domains)}
    ids["fusion"] = len(in_domains)
    return ids
