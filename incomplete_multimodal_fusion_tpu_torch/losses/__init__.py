from .balancing import no_weighting
from . import set_criterion
from .contrastive import dino_loss
from .masked import (LOSS_FNS, PATCH_LOSS_FNS, masked_cross_entropy_loss,
                     masked_cross_entropy_loss_patch, masked_l1_loss, masked_l1_loss_patch,
                     masked_mse_loss, masked_mse_loss_patch)

__all__ = ["LOSS_FNS", "PATCH_LOSS_FNS", "dino_loss", "masked_cross_entropy_loss",
           "masked_cross_entropy_loss_patch", "masked_l1_loss", "masked_l1_loss_patch",
           "masked_mse_loss", "masked_mse_loss_patch", "no_weighting", "set_criterion"]
