"""One downstream training step of the ported MaskFormer on the ResNet-18
and Swin-T backbones against the JAX package
(tests/test_torch_backbones_train.py's procedure: f32 loss to 1e-5
relative, every gradient to rel-L2 1e-4, the bf16 loss within 2e-2 of
JAX's), and ``cli.train_downstream --backbone resnet18`` and
``--backbone vit_adapter`` for one epoch of 2 CPU steps in subprocesses
(the ``tiny`` widths on 64^2 rasters): a finite loss and dice, and the
checkpoint restoring into the backbone's model.
"""
import math
import os

import pytest
import torch

from incomplete_multimodal_fusion_tpu_torch.cli import train_downstream as cli
from incomplete_multimodal_fusion_tpu_torch.models.maskformer import build_maskformer
from tests.test_torch_backbones_train import check_bf16_loss, check_loss_and_every_gradient
from tests.test_torch_cli_downstream import SMALL_RUN, _floats, _run

NONZERO = {
    "resnet18": ["backbone.conv1.weight", "backbone.layer1_0.bn1.scale", "backbone.layer4_0.downsample_bn.bias"],
    "swin": ["backbone.patch_embed.weight", "backbone.stage0_block1.attn.relative_position_bias_table",
             "backbone.merge2.reduction.weight", "backbone.out_norm3.weight"],
}


@pytest.mark.parametrize("name", list(NONZERO))
def test_loss_and_every_gradient_match_jax(name):
    check_loss_and_every_gradient(name, NONZERO[name])


@pytest.mark.parametrize("name", ["resnet18", "swin"])
def test_bf16_loss_near_jax_bf16_loss(name):
    check_bf16_loss(name)


@pytest.mark.parametrize("backbone", ["resnet18", "vit_adapter"])
def test_cli_trains_the_backbone(backbone, tmp_path):
    log = _run("train_downstream", *SMALL_RUN, "--epochs", "1", "--backbone", backbone,
               "--output_dir", str(tmp_path))
    losses, dice = _floats(r"epoch \d+: loss=(\S+)", log), _floats(r"eval dice=(\S+)", log)
    assert len(losses) == 1 and math.isfinite(losses[0]) and len(dice) == 1 and math.isfinite(dice[0])
    assert os.listdir(tmp_path) == ["checkpoint-1"]
    saved = torch.load(str(tmp_path / "checkpoint-1"), weights_only=True)
    model = build_maskformer(cli.build_config(cli.get_args(SMALL_RUN + ["--backbone", backbone])), device="cpu")
    assert saved["step"] == 2 and set(saved["model"]) == set(model.state_dict())
    model.load_state_dict(saved["model"])
    want = "backbone.layer4_1.bn2.scale" if backbone == "resnet18" else "backbone.injector3.gamma"
    assert want in saved["model"]
