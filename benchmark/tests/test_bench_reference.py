"""The benchmark's plain reference against the port's CPU route, at small
sizes, and the imports of the reference and the harness."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.content import dead_leaves
from benchmark.drivers.rd_sweep import fields_off
from benchmark.lib.inputs import generator
from benchmark.reference import codec, container, convert, expected
from conftest import REPO
from myyuv_tpu_torch.engine import device_stream as ds
from myyuv_tpu_torch.engine import pipeline, sweep
from myyuv_tpu_torch.entropy import device as edev
from myyuv_tpu_torch.formats.yuv import YUVImage
from myyuv_tpu_torch.kernels import device as kdev

CPU = torch.device("cpu")
PARAMS = {"r_min": 3.0, "r_max": 40, "coverage": 4.0, "lum": [16, 235],
          "chroma": 20.0, "shade": 0.3, "noise": 3.0, "spread": 0.5}


def picture(h, w, seed, frames=None):
    gen = generator(seed, CPU)
    if frames is None:
        return convert.bgrx_to_iyuv(dead_leaves.still(h, w, PARAMS, gen,
                                                      CPU))
    return dead_leaves.pan_job(frames, h, w, dict(PARAMS, pan=[8, 16]), gen,
                               CPU, convert.bgrx_to_iyuv)


def test_conversion_matches_the_port():
    gen = torch.Generator().manual_seed(3)
    px = torch.randint(0, 256, (2, 34, 50, 4), dtype=torch.uint8,
                       generator=gen)
    for a, b in zip(convert.bgrx_to_iyuv(px), kdev.bgrx_to_iyuv(px)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("quality", [1, 10, 50, 90, 100])
def test_transform_matches_the_port(quality):
    gen = torch.Generator().manual_seed(quality)
    blocks = torch.randint(0, 256, (500, 8, 8), dtype=torch.uint8,
                           generator=gen)
    for plane in range(3):
        q = codec.tables([quality] * 3, CPU)[plane]
        c = codec.forward(blocks, q)
        assert torch.equal(c, kdev.dct_quantize(blocks, q))
        assert torch.equal(codec.inverse(c, q), kdev.dequantize_idct(c, q))


@pytest.mark.parametrize("scale", [1, 40, 1024, 32767])
def test_huffman_chunks_match_the_port(scale):
    gen = torch.Generator().manual_seed(scale)
    coeffs = (torch.randn((300, 64), generator=gen) * scale).clamp(
        -32768, 32767).to(torch.int16)
    coeffs[::3, 5:] = 0           # short messages
    coeffs[1::7] = 0              # all-zero blocks
    coeffs[2::11] = 7             # one symbol
    lanes, sizes = codec.encode_chunks(coeffs)
    want_lanes, want_sizes, err = edev.encode_lanes(coeffs)
    assert not err.any()
    assert torch.equal(sizes, want_sizes)
    assert torch.equal(lanes, want_lanes)


@pytest.mark.parametrize("quality", [10, 50, 90])
def test_files_match_the_port(quality):
    planes = picture(64, 96, quality)
    raw = container.raw_file([p.numpy() for p in planes])
    img = YUVImage.from_bytes(raw)
    packed = pipeline.compress_dct(img, bytes([quality] * 3),
                                   device="cpu").to_bytes()
    back = pipeline.decompress_dct(YUVImage.from_bytes(packed),
                                   device="cpu").to_bytes()
    want_packed, want_back = expected.still_files(planes, [quality] * 3)
    assert packed == want_packed
    assert back == want_back
    assert [np.array_equal(a, b.numpy()) for a, b in
            zip(container.raw_planes(raw), planes)] == [True] * 3


def test_batch_stream_matches_the_port():
    planes = picture(32, 64, 5, frames=4)
    dct, qt = pipeline.codec_params([50] * 3, CPU)
    sizes, content = ds.compress_batch(*planes, qt, dct)
    back = ds.decompress_batch(content, sizes, qt, dct, 4, 32, 64)
    want_sizes, want_content, want_back = expected.batch_stream(planes,
                                                                [50] * 3)
    assert torch.equal(sizes, want_sizes)
    assert torch.equal(content, want_content)
    assert all(torch.equal(a, b) for a, b in zip(back, want_back))


def test_batch_roundtrip_matches_the_port():
    planes = picture(32, 64, 6, frames=4)
    dct, qt = pipeline.codec_params([90] * 3, CPU)
    rec, total, ok = ds.roundtrip_batch(*planes, qt, dct)
    want_rec, want_total = expected.batch_roundtrip(planes, [90] * 3)
    assert bool(ok) and int(total) == want_total
    assert all(torch.equal(a, b) for a, b in zip(rec, want_rec))


def test_rd_points_match_the_port():
    planes = picture(64, 96, 7)
    qualities = (10, 30, 50, 70, 90)
    got = sweep.quality_sweep([p.numpy() for p in planes], qualities,
                              device="cpu")
    want = expected.rd_points(planes, qualities)
    assert [fields_off(g, w) for g, w in zip(got, want)] == [0] * 5
    # one field off by more than its printed precision is counted
    bad = dict(got[2], psnr_u_db=got[2]["psnr_u_db"] + 0.002)
    assert fields_off(bad, want[2]) == 1


FORBIDDEN = "{'jax', 'jaxlib', 'flax', 'myyuv_tpu'}"


def _loaded_after(imports: str) -> set:
    code = (f"import sys; {imports}; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_harness_and_reference_load_no_jax():
    loaded = _loaded_after(
        "import benchmark.lib.harness, benchmark.reference.expected, "
        "benchmark.lib.inputs, benchmark.control; "
        "from benchmark.lib.manifest import Manifest; from pathlib import "
        "Path; m = Manifest(Path('.')); "
        "[m.driver(m.traffic(w['traffic'])['driver']) "
        "for w in m.data['workloads']]; "
        "[m.reader(p['name']) for p in m.data['per_layer']]")
    assert "myyuv_tpu_torch" in loaded
    assert not loaded & eval(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded_after(
        "import benchmark.reference.expected, benchmark.reference.convert, "
        "benchmark.content.dead_leaves")
    assert "torch" in loaded
    assert not loaded & (eval(FORBIDDEN) | {"myyuv_tpu_torch"})
