"""The port stands alone: importing it pulls in neither JAX nor flax nor the
JAX package, builds nothing, and every CUDA source it ships is on the build
list."""
import os
import subprocess
import sys
from pathlib import Path

from incomplete_multimodal_fusion_tpu_torch.ops import cuda_build

ROOT = Path(__file__).resolve().parents[1]


def test_import_leaves_jax_and_flax_out():
    code = (
        "import sys\n"
        "import incomplete_multimodal_fusion_tpu_torch as p\n"
        "from incomplete_multimodal_fusion_tpu_torch import infer, serving\n"
        "from incomplete_multimodal_fusion_tpu_torch.models import multimae\n"
        "from incomplete_multimodal_fusion_tpu_torch import losses, train\n"
        "from incomplete_multimodal_fusion_tpu_torch.train import optim, pretrain, schedules\n"
        "from incomplete_multimodal_fusion_tpu_torch.utils import jax_params\n"
        "from incomplete_multimodal_fusion_tpu_torch import eval, infer_segmentation\n"
        "from incomplete_multimodal_fusion_tpu_torch.eval import metrics\n"
        "from incomplete_multimodal_fusion_tpu_torch.models import (mask2former_decoder, maskformer,\n"
        "    msda_module, pixel_decoder, position_encoding, vit_baseline)\n"
        "from incomplete_multimodal_fusion_tpu_torch.models import (dpt_utils, maskformer_decoder, resnet, swin,\n"
        "    vit_adapter)\n"
        "from incomplete_multimodal_fusion_tpu_torch.ops import cuda_msda, msda, resize\n"
        "from incomplete_multimodal_fusion_tpu_torch.ops import cuda_points, points\n"
        "from incomplete_multimodal_fusion_tpu_torch.losses import set_criterion\n"
        "from incomplete_multimodal_fusion_tpu_torch.train import downstream\n"
        "from incomplete_multimodal_fusion_tpu_torch.ops import cuda_block_attn, cuda_zorro_sparse\n"
        "from incomplete_multimodal_fusion_tpu_torch.train import ema\n"
        "from incomplete_multimodal_fusion_tpu_torch.utils import checkpoint, logging, torch_convert\n"
        "from incomplete_multimodal_fusion_tpu_torch.cli import pretrain as cli_pretrain\n"
        "from incomplete_multimodal_fusion_tpu_torch.cli import convert_checkpoint, infer, train_downstream\n"
        "from incomplete_multimodal_fusion_tpu_torch.eval import coco_eval, structures\n"
        "from incomplete_multimodal_fusion_tpu_torch.data import patchify_batch\n"
        "from incomplete_multimodal_fusion_tpu_torch.data.synthetic import synthetic_instances\n"
        "from incomplete_multimodal_fusion_tpu_torch.data import (ade_odgt, augment, coco_instance, dfc2023,\n"
        "    loader, native, quadruplet, sample_trees, sen12ms, tiff)\n"
        "assert native._lib is None  # nothing built or loaded at import\n"
        "import importlib.util\n"
        "spec = importlib.util.spec_from_file_location('learn', 'tools/train_downstream_synthetic_torch.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'incomplete_multimodal_fusion_tpu')]\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_every_cuda_source_is_built():
    shipped = sorted(p.name for p in cuda_build.CSRC.glob("*.cu"))
    assert shipped == sorted(cuda_build.SOURCES)
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS
    # the build directory sits inside the checkout and is git-ignored
    assert cuda_build.BUILD_DIR.is_relative_to(ROOT)
    assert "build/" in (ROOT / ".gitignore").read_text().split()


def test_library_name_follows_the_source():
    """An edited source gets a new library name, so a stale build is never
    loaded."""
    names = {cuda_build.library_path(s).name for s in cuda_build.SOURCES}
    assert len(names) == len(cuda_build.SOURCES)
    assert all(n.endswith(".so") for n in names)
