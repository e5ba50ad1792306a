"""The inputs made from the seed, and the work counted for the rooflines."""

import json

import pytest
import torch

from benchmark.lib import inputs, roofline
from benchmark.lib.manifest import Manifest

CPU = torch.device("cpu")
BIG_SEED = 2 ** 31 + 12345


def test_still_pool_is_a_function_of_the_seed(small_root):
    config = Manifest(small_root).config("still4k")
    a = inputs.stills(config, 3, BIG_SEED, CPU)
    b = inputs.stills(config, 3, BIG_SEED, CPU)
    c = inputs.stills(config, 3, BIG_SEED + 1, CPU)
    for pa, pb in zip(a, b):
        assert all(torch.equal(x, y) for x, y in zip(pa, pb))
    assert not all(torch.equal(x, y) for pa, pc in zip(a, c)
                   for x, y in zip(pa, pc))
    # the pictures of one pool differ from each other
    assert not torch.equal(a[0][0], a[1][0])


def test_video_job_is_a_function_of_the_seed(small_root):
    config = Manifest(small_root).config("video1080")
    a = inputs.video(config, 8, BIG_SEED, CPU)
    b = inputs.video(config, 8, BIG_SEED, CPU)
    c = inputs.video(config, 8, 7, CPU)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (8, 32, 64) and a[1].shape == (8, 16, 32)
    # every frame of the job differs from the next
    assert all(not torch.equal(a[0][t], a[0][t + 1]) for t in range(7))


@pytest.mark.parametrize("h, w, frames, want", [
    (3008, 4032, 1, 284_256),
    (1088, 1920, 8, 391_680),
    (16, 16, 1, 6),
])
def test_block_counts(h, w, frames, want):
    assert roofline.blocks(h, w, frames) == want


def test_least_time_of_a_known_batch():
    pk = roofline.PEAKS["NVIDIA H100 80GB HBM3"]
    # planes once, a 3.5 MB stream and one int32 size a block
    nbytes, ops = roofline.encode(1088, 1920, 8, chunk_bytes=3_500_000)
    assert nbytes == 25_067_520 + 3_500_000 + 4 * 391_680
    assert ops == 1984 * 391_680
    least, by = roofline.least_seconds(nbytes, ops, pk)
    assert by == "operations"
    assert least == pytest.approx(11.6e-6, rel=0.01)
    assert nbytes / pk["bytes_per_s"] == pytest.approx(9.0e-6, rel=0.01)
    rt_bytes, rt_ops = roofline.roundtrip(1088, 1920, 8)
    assert roofline.least_seconds(rt_bytes, rt_ops, pk)[0] == pytest.approx(
        23.2e-6, rel=0.01)
    st_bytes, st_ops = roofline.transform_step(3008, 4032, 1)
    assert roofline.least_seconds(st_bytes, st_ops, pk)[0] == pytest.approx(
        16.8e-6, rel=0.01)


def test_pool_bits_per_pixel_is_recorded():
    from conftest import REPO
    config = json.loads((REPO / "benchmark" / "configs" / "still4k.json")
                        .read_text())
    bpp = config["q50_bits_per_pixel"]
    assert bpp["golden_file"] == 2.22
    assert isinstance(bpp["pool_mean"], float) and 1.5 < bpp["pool_mean"] < 3
