from .balancing import init_uncertainty_params, no_weighting, uncertainty_weighting
from . import set_criterion
from .contrastive import (DINOCenterState, byol_loss, dino_center_loss, dino_loss, hard_negative_loss,
                          init_dino_center, vicreg_loss)
from .masked import (LOSS_FNS, PATCH_LOSS_FNS, masked_cross_entropy_loss,
                     masked_cross_entropy_loss_patch, masked_l1_loss, masked_l1_loss_patch,
                     masked_mse_loss, masked_mse_loss_patch)

__all__ = ["DINOCenterState", "LOSS_FNS", "PATCH_LOSS_FNS", "byol_loss", "dino_center_loss", "dino_loss",
           "hard_negative_loss", "init_dino_center", "init_uncertainty_params", "masked_cross_entropy_loss",
           "masked_cross_entropy_loss_patch", "masked_l1_loss", "masked_l1_loss_patch",
           "masked_mse_loss", "masked_mse_loss_patch", "no_weighting", "set_criterion",
           "uncertainty_weighting", "vicreg_loss"]
