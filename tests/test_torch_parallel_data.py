"""Each data rank's rows of the global stream (data parallelism), on the
CPU: ``DFC2023Batches(shard=(i, k))`` reads share i of every global batch
(and reads nothing else), its ``skip`` on resume stays bitwise; the
``RowShard`` wrapper hands the downstream readers' rows of the global batch,
augmentation draws included; the pretraining CLI's synthetic stream gives a
rank its rows of the global draw."""
import numpy as np
import pytest

from incomplete_multimodal_fusion_tpu_torch.cli import pretrain as cli_pretrain
from incomplete_multimodal_fusion_tpu_torch.config import DataConfig, PretrainConfig, TrainConfig
from incomplete_multimodal_fusion_tpu_torch.data import augment, dfc2023, loader, quadruplet, sample_trees
from incomplete_multimodal_fusion_tpu_torch.parallel.mesh import Layout

DOMAINS = ("s1", "s2", "dem")


def fill(source):
    out = {k: np.empty(shape, dtype) for k, (shape, dtype) in source.specs.items()}
    source.fill(out)
    return out


@pytest.fixture(scope="module")
def dfc_root(tmp_path_factory):
    return sample_trees.write_dfc2023(str(tmp_path_factory.mktemp("dfc")), 9, 32, seed=21)


@pytest.mark.parametrize("crop", [False, True])
def test_dfc2023_shards_are_the_global_batchs_rows(dfc_root, crop, monkeypatch):
    kw = dict(in_domains=DOMAINS, batch_size=4, input_size=16 if crop else 32, seed=5, random_crop=crop,
              native=False, num_threads=1)
    whole = dfc2023.DFC2023Batches(dfc_root, **kw)
    batches = [fill(whole) for _ in range(5)]  # past an epoch of 2 batches
    read, real = [], dfc2023.DFC2023Dataset.__getitem__
    monkeypatch.setattr(dfc2023.DFC2023Dataset, "__getitem__", lambda self, i: read.append(i) or real(self, i))
    for index in range(2):
        part = dfc2023.DFC2023Batches(dfc_root, shard=(index, 2), **kw)
        assert part.specs["s1"][0][0] == 2
        read.clear()
        for want in batches:
            got = fill(part)
            for d in DOMAINS:
                np.testing.assert_array_equal(got[d], want[d][2 * index:2 * index + 2])
        assert len(read) == 2 * len(batches)  # its own rows alone


def test_dfc2023_shard_skip_is_bitwise(dfc_root):
    kw = dict(in_domains=DOMAINS, batch_size=4, input_size=32, seed=7, native=False, num_threads=1, shard=(1, 2))
    read = dfc2023.DFC2023Batches(dfc_root, **kw)
    outs = [fill(read) for _ in range(4)]
    skipped = dfc2023.DFC2023Batches(dfc_root, **kw)
    skipped.skip(3)
    got = fill(skipped)
    for d in DOMAINS:
        np.testing.assert_array_equal(got[d], outs[3][d])


def test_dfc2023_refuses_a_batch_the_shares_do_not_divide(dfc_root):
    with pytest.raises(ValueError, match="does not divide"):
        dfc2023.DFC2023Batches(dfc_root, DOMAINS, batch_size=3, input_size=32, shard=(0, 2))


def test_row_shard_keeps_the_global_draws(tmp_path):
    """The quadruplet reader draws each sample's augmentation from one
    generator in sample order: a rank's rows through RowShard are the
    global batch's rows, draws and all."""
    root = sample_trees.write_quadruplet(str(tmp_path), 6, 40, seed=13)

    def source():
        ds = quadruplet.QuadrupletDataset(root, unlabeled=False, crop_size=32)
        return quadruplet.QuadrupletBatches(ds, 4, seed=6, augment=augment.AugmentConfig())

    whole = source()
    want = [fill(whole) for _ in range(3)]
    for index in range(2):
        part = loader.RowShard(source(), index, 2)
        assert part.specs["label"][0][0] == 2
        for w in want:
            got = fill(part)
            for k in got:
                np.testing.assert_array_equal(got[k], w[k][2 * index:2 * index + 2])
    with pytest.raises(ValueError, match="does not divide"):
        loader.RowShard(source(), 0, 3)


def test_the_cli_synthetic_stream_gives_a_rank_its_rows():
    """--batch_size 2 on each of 2 data ranks, resumed after a step, K = 2:
    the rows of the one-device stream at batch 4."""
    cfg = PretrainConfig(data=DataConfig(input_size=32, batch_size=2), train=TrainConfig(seed=3))
    full = PretrainConfig(data=DataConfig(input_size=32, batch_size=4), train=TrainConfig(seed=3))
    glob, _ = cli_pretrain.open_data(full, False, 1, 1, "cpu")
    global_batches = [next(glob) for _ in range(2)]
    for rank in range(2):
        mine, _ = cli_pretrain.open_data(cfg, False, 1, 2, "cpu", Layout(dp=2, dp_rank=rank))
        group = next(mine)  # K = 2 stacked
        for j in range(2):
            for d in cfg.data.in_domains:
                np.testing.assert_array_equal(group[d][j], global_batches[j][d][2 * rank:2 * rank + 2])
