"""The port's CLI (``python -m myyuv_tpu_torch --device cpu``) writes the
same files as the JAX package's (``python -m myyuv_tpu --platform cpu``):
the codec commands and the -rgb / -preview exports.

Tolerance: byte equality."""

import subprocess
import sys
from pathlib import Path

import numpy as np

from myyuv_tpu_torch.formats import bmp as tbmp
from myyuv_tpu_torch.kernels import probe

REPO = Path(__file__).resolve().parent.parent


def _cli(module, *args):
    r = subprocess.run([sys.executable, "-m", module, *map(str, args)],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return r


def test_cli_files_identical_to_jax_cli(rng, tmp_path):
    """-to_yuv, -compress DCT 50 and -decompress of the port's CLI on the
    CPU write the same bytes as the JAX package's CLI."""
    px = rng.integers(0, 256, (48, 96, 4), np.uint8)
    px[..., 3] = 255
    src = tmp_path / "in.bmp"
    tbmp.BMPImage.from_pixels(px).dump(src)
    outs = {}
    for module, flags in (("myyuv_tpu_torch", ("--device", "cpu")),
                          ("myyuv_tpu", ("--platform", "cpu"))):
        d = tmp_path / module
        d.mkdir()
        _cli(module, src, "-to_yuv", "IYUV", "-o", d / "a.myyuv", *flags)
        _cli(module, d / "a.myyuv", "-compress", "DCT", "50", "-o",
             d / "c.myyuv", *flags)
        _cli(module, d / "c.myyuv", "-decompress", "-o", d / "d.myyuv",
             *flags)
        outs[module] = [(d / f).read_bytes()
                        for f in ("a.myyuv", "c.myyuv", "d.myyuv")]
    assert outs["myyuv_tpu_torch"] == outs["myyuv_tpu"]


def test_cli_rgb_and_preview_identical_to_jax_cli(rng, tmp_path):
    """-rgb -o and -preview -o of the port's CLI on the CPU write the same
    bytes as the JAX package's CLI, for a BMP and for a compressed
    .myyuv."""
    px = probe.smooth_picture(rng, 48, 96)
    src = tmp_path / "in.bmp"
    tbmp.BMPImage.from_pixels(px).dump(src)
    comp = tmp_path / "c.myyuv"
    _cli("myyuv_tpu_torch", src, "-to_yuv", "IYUV", "-o", tmp_path / "a.myyuv",
         "--device", "cpu")
    _cli("myyuv_tpu_torch", tmp_path / "a.myyuv", "-compress", "DCT", "75",
         "-o", comp, "--device", "cpu")
    for image in (src, comp):
        outs = {}
        for module, flags in (("myyuv_tpu_torch", ("--device", "cpu")),
                              ("myyuv_tpu", ("--platform", "cpu"))):
            rgb = tmp_path / f"{module}-{image.stem}.bmp"
            text = tmp_path / f"{module}-{image.stem}.txt"
            r = _cli(module, image, "-rgb", "-o", rgb, *flags)
            assert "rgb export : " in r.stdout
            _cli(module, image, "-preview", "-o", text, *flags)
            outs[module] = (rgb.read_bytes(), text.read_bytes())
        assert outs["myyuv_tpu_torch"] == outs["myyuv_tpu"], image.name


def test_cli_info_and_errors(rng, tmp_path, capsys):
    from myyuv_tpu_torch import cli
    px = rng.integers(0, 256, (16, 32, 4), np.uint8)
    src = tmp_path / "in.bmp"
    tbmp.BMPImage.from_pixels(px).dump(src)
    assert cli.main([str(src), "-info", "--device", "cpu"]) == 0
    assert "width: 32" in capsys.readouterr().out
    out = tmp_path / "a.myyuv"
    assert cli.main([str(src), "-to_yuv", "IYUV", "-o", str(out),
                     "--device", "cpu"]) == 0
    assert cli.main([str(out), "-info", "--device", "cpu"]) == 0
    assert "format: IYUV" in capsys.readouterr().out
    bad = tmp_path / "x.myyuv"
    bad.write_bytes(b"ZZ not an image")
    assert cli.main([str(bad), "-info", "--device", "cpu"]) == 1
    assert cli.main([str(out), "-compress", "DCT", "101", "--device",
                     "cpu"]) == 1
    assert cli.main([str(src), "-decompress", "--device", "cpu"]) == 1
    assert "error" in capsys.readouterr().err
    assert cli.main([str(src), "-preview", "--device", "cpu"]) == 0
    assert "\x1b[38;2;" in capsys.readouterr().out
    assert cli.main([str(bad), "-rgb", "--device", "cpu"]) == 1
    assert "error" in capsys.readouterr().err
