"""Command-line interface mirroring the reference ``myyuv_cli``.

Port of ``myyuv_tpu/cli.py``, every command:

  python -m myyuv_tpu_torch <image> -info
  python -m myyuv_tpu_torch <image.bmp> -to_yuv IYUV [-o out.myyuv]
  python -m myyuv_tpu_torch <image.myyuv> -compress DCT q [q2 q3] [-o out]
  python -m myyuv_tpu_torch <image.myyuv> -decompress [-o out.myyuv]
  python -m myyuv_tpu_torch <image> -rgb [-o out.bmp]      # RGB export
  python -m myyuv_tpu_torch <image> -preview [-o out.txt]  # terminal preview
  python -m myyuv_tpu_torch <image> -cube [-frames N] [-size S] [-shapes N]
      [-force_cube] [-flip_width_height] [-fly] [-o out_dir]  # cube demo

``--device cuda`` (the default) runs the CUDA kernels, ``--device cpu``
their plain PyTorch versions; both write the same bytes. Input type is
sniffed from the two magic bytes like the reference (main.cpp:215-234), and
each operation prints "<op> : N ms" like its MyTimer (main.cpp:11-41).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

from .engine import pipeline
from .formats.bmp import BMPImage
from .formats.yuv import Compressions, FourccFormats, YUVImage
from .runtime.errors import MyYUVError
from .viewer import cube, export, terminal

_FORMATS = {"IYUV": FourccFormats.IYUV}
_COMPRESSIONS = {"DCT": Compressions.DCT}


class _Timer:
    """Wall-clock op timing, printed like the reference MyTimer."""

    def __init__(self, label: str):
        self.label = label

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            ms = (time.perf_counter() - self.t0) * 1e3
            print(f"{self.label} : {ms:.3f} ms")


def _sniff(path: Path) -> str:
    try:
        with open(path, "rb") as f:
            magic = f.read(2)
    except OSError as e:
        raise MyYUVError(f"cannot read {path}: {e}") from e
    if magic == b"BM":
        return "bmp"
    if magic == b"YU":
        return "yuv"
    raise MyYUVError(f"Unknown image magic {magic!r} in {path}")


def _fill_qualities(vals: List[int]) -> bytes:
    """1-3 quality values; the last given fills the rest
    (myyuv_cli/main.cpp:56-78)."""
    if not 1 <= len(vals) <= 3:
        raise MyYUVError("compress takes 1 to 3 quality parameters")
    for v in vals:
        if not 1 <= v <= 100:
            raise MyYUVError("Level of quality must be between 1 and 100")
    return bytes(list(vals) + [vals[-1]] * (3 - len(vals)))


def _print_info(path: Path, kind: str) -> None:
    if kind == "bmp":
        bmp = BMPImage.load(path)
        h = bmp.header
        print("BMP image")
        print(f"  size: {h.file_size}")
        print(f"  width: {bmp.true_width}")
        print(f"  height: {bmp.true_height}  (stored {h.height},"
              f" {'bottom-up' if h.height > 0 else 'top-down'})")
        print(f"  bit_count: {h.bit_count}")
        print(f"  data_pos: {h.data_pos}")
        return
    img = YUVImage.load(path)
    h = img.header
    print(".myyuv image")
    print(f"  format: {img.descriptor.name}")
    print(f"  width: {h.width}")
    print(f"  height: {h.height}")
    print(f"  compression: {'DCT' if img.is_compressed() else 'NONE'}")
    print(f"  data_size: {h.data_size}")
    if h.compression_params_size:
        print(f"  compression_params: {list(img.compression_params)}")


def _default_out(path: Path, suffix: str, tag: str) -> Path:
    return path.with_name(path.stem + tag + suffix)


def _bgrx(path: Path, kind: str, device: str) -> np.ndarray:
    """An image's [H, W, 4] BGRX pixels: a BMP's own, a .myyuv's through
    ``pipeline.iyuv_to_bgrx`` on ``device`` (K2 then X2 on the card for a
    compressed file)."""
    if kind == "bmp":
        return export.ensure_bgrx(BMPImage.load(path).pixels_topdown())
    return pipeline.iyuv_to_bgrx(YUVImage.load(path), device)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m myyuv_tpu_torch",
        description="myyuv codec CLI on PyTorch/CUDA (reference: myyuv_cli)")
    p.add_argument("image", type=Path)
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("-info", action="store_true")
    g.add_argument("-to_yuv", metavar="FORMAT")
    g.add_argument("-compress", nargs="+", metavar=("TYPE", "QUALITY"))
    g.add_argument("-decompress", action="store_true")
    g.add_argument("-rgb", action="store_true",
                   help="decode to an RGB .bmp (viewer-equivalent export)")
    g.add_argument("-preview", action="store_true",
                   help="render to ANSI truecolor in the terminal")
    g.add_argument("-cube", action="store_true",
                   help="render the spinning-textured-cube demo frames "
                        "(software analog of myyuv_opengl_spinning_cube)")
    p.add_argument("-frames", type=int, default=24,
                   help="frame count for -cube")
    p.add_argument("-size", type=int, default=512,
                   help="output resolution for -cube (0 = the reference "
                        "1000x800 screen)")
    p.add_argument("-shapes", type=int, default=1, metavar="N",
                   help="number of shapes, 1..1000, placed without overlap"
                        " (spinning_cube.cpp:288-312)")
    p.add_argument("-force_cube", action="store_true",
                   help="force a cube even for non-square images "
                        "(spinning_cube main.cpp:20-57)")
    p.add_argument("-flip_width_height", action="store_true",
                   help="swap texture width/height for the shape aspect "
                        "(no-op with -force_cube)")
    p.add_argument("-fly", action="store_true",
                   help="drive the fly camera along the scripted path "
                        "(headless stand-in for WASD/arrows)")
    p.add_argument("-o", "--output", type=Path, default=None)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="'cuda' runs the CUDA kernels (default), 'cpu' "
                        "their plain PyTorch versions")
    args = p.parse_args(argv)

    try:
        pipeline.register_engine_codecs(args.device)
        kind = _sniff(args.image)
        if args.info:
            _print_info(args.image, kind)
            return 0

        if args.rgb:
            with _Timer("rgb export"):
                bgrx = _bgrx(args.image, kind, args.device)
            out = args.output or _default_out(args.image, ".bmp", "-rgb")
            export.write_bgrx_bmp(out, bgrx)
            print(f"wrote {out}")
            return 0

        if args.preview:
            text = terminal.render_ansi(_bgrx(args.image, kind, args.device))
            if args.output:
                args.output.write_text(text)
                print(f"wrote {args.output}")
            else:
                print(text)
            return 0

        if args.cube:
            tex = _bgrx(args.image, kind, args.device)
            out = args.output or _default_out(args.image, "", "-cube")
            with _Timer("cube render"):
                paths = cube.render_spinning_cube(
                    tex, out, n_frames=args.frames, out_size=args.size,
                    shapes=args.shapes, force_cube=args.force_cube,
                    flip_width_height=args.flip_width_height,
                    fly_script=(cube.default_fly_script if args.fly
                                else None), device=args.device)
            print(f"wrote {len(paths)} frames to {out}/")
            return 0

        if args.to_yuv is not None:
            if kind != "bmp":
                raise MyYUVError("-to_yuv needs a BMP input")
            fmt = _FORMATS.get(args.to_yuv.upper())
            if fmt is None:
                raise MyYUVError(f"Unknown YUV format {args.to_yuv}")
            bmp = BMPImage.load(args.image)
            with _Timer("to yuv"):
                img = YUVImage.from_bmp(bmp, fmt)
            out = args.output or _default_out(args.image, ".myyuv", "")
            img.dump(out)
            print(f"wrote {out}")
            return 0

        if kind != "yuv":
            raise MyYUVError("this command needs a .myyuv input")
        img = YUVImage.load(args.image)

        if args.compress is not None:
            ctype = _COMPRESSIONS.get(args.compress[0].upper())
            if ctype is None:
                raise MyYUVError(f"Unknown compression {args.compress[0]}")
            params = _fill_qualities([int(v) for v in args.compress[1:]])
            with _Timer("compression"):
                comp = img.compress(ctype, params)
            out = args.output or _default_out(
                args.image, ".myyuv", f"-DCT-{params[0]}")
            comp.dump(out)
            ratio = img.header.data_size / comp.header.data_size
            print(f"wrote {out}  ({comp.header.data_size} bytes,"
                  f" {ratio:.2f}x)")
            return 0

        with _Timer("decompression"):
            dec = img.decompress()
        out = args.output or _default_out(args.image, ".myyuv", "-decomp")
        dec.dump(out)
        print(f"wrote {out}")
        return 0
    except (MyYUVError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
