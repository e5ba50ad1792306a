"""The port's ``viewer/cube.py`` and the CLI's ``-cube`` against the JAX
package's: the numpy parts (camera, projection, placement, geometry, the
fly script) exactly, and the rasteriser and the CLI's frames to a share of
differing pixels.

Tolerance: exact equality for the numpy parts. Rendered frames: at most
MAX_DIFF_SHARE of the pixels may differ (the measured share is printed).
Pixels on triangle edges, at depth ties and at texel boundaries depend on
the order and contraction of float32 operations, which XLA on the CPU and
PyTorch choose each their own way."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from myyuv_tpu import cli as jcli
from myyuv_tpu.viewer import cube as jcube
from myyuv_tpu_torch import cli as tcli
from myyuv_tpu_torch.formats import bmp as tbmp
from myyuv_tpu_torch.viewer import cube as tcube

MAX_DIFF_SHARE = 1e-3


def test_numpy_parts_match_jax():
    for a in (-540.0, -180.5, -180.0, 0.0, 179.9, 180.0, 180.1, 359.0):
        assert tcube.normalize_angle(a) == jcube.normalize_angle(a)
    for aspect in (1.25, 1.0, 0.5):
        np.testing.assert_array_equal(tcube.perspective(aspect=aspect),
                                      jcube.perspective(aspect=aspect))
    for n in (1, 2, 8, 50):
        assert tcube.generation_radius(n) == jcube.generation_radius(n)
        np.testing.assert_array_equal(
            tcube.generate_shape_positions(n, np.random.default_rng(n)),
            jcube.generate_shape_positions(n, np.random.default_rng(n)))
    for bad in (0, 1001):
        with pytest.raises(ValueError):
            tcube.generate_shape_positions(bad)
    for flags in ((False, False), (True, False), (False, True)):
        for got, want in zip(tcube.shape_geometry(64, 48, *flags),
                             jcube.shape_geometry(64, 48, *flags)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    tcam, jcam = tcube.Camera(), jcube.Camera()
    for i in range(40):
        assert tcube.default_fly_script(i) == jcube.default_fly_script(i)
        x, y, z, vx, vy = tcube.default_fly_script(i)
        vy = (1, -1, 0)[i % 3]
        for cam in (tcam, jcam):
            cam.turn(vx, vy, 0.5)
            cam.move(x, (i % 2), z - 1, 0.5)
            cam.update()
        np.testing.assert_array_equal(tcam.view(), jcam.view())
        assert (tcam.yaw, tcam.pitch) == (jcam.yaw, jcam.pitch)


def _scene(h, w, shapes, frame):
    rng = np.random.default_rng(11)
    tex = rng.integers(0, 256, (48, 64, 4), np.uint8)
    verts, tris, uvs = tcube.shape_geometry(64, 48)
    pos = tcube.generate_shape_positions(shapes, np.random.default_rng(0))
    r = tcube.generation_radius(shapes)
    cam = tcube.Camera()
    cam.pos = np.array([r * 2.5 + 3, 0, r * 2.5 + 3], np.float32)
    cam.yaw = -135.0
    for i in range(4 * frame):
        cam.turn(1, 0, 0.04)
        cam.move(1, 0, 0, 0.04)
    cam.update()
    angles = np.full(shapes, 10.0 * frame, np.float32)
    return (tex, verts, tris, uvs, pos, angles, cam.view(),
            tcube.perspective(aspect=w / h))


def test_render_scene_matches_jax():
    h, w, shapes = 64, 80, 3
    diff = hit = 0
    for frame in range(4):
        args = _scene(h, w, shapes, frame)
        want = np.asarray(jcube.render_scene(
            *(jnp.asarray(a) for a in args), h, w))
        got = tcube.render_scene(
            *(torch.from_numpy(np.ascontiguousarray(a)) for a in args), h, w)
        assert got.dtype == torch.uint8 and got.shape == (h, w, 4)
        diff += int((got.numpy() != want).any(-1).sum())
        hit += int((want[..., :3] != tcube.CLEAR_BGR).any(-1).sum())
    share = diff / (4 * h * w)
    print(f"render_scene: {diff} of {4 * h * w} pixels differ from JAX's "
          f"(share {share:.3g}); {hit} pixels show a shape")
    assert hit > 0
    assert share <= MAX_DIFF_SHARE


@pytest.mark.parametrize("flags", [
    ("-fly", "-flip_width_height"),
    ("-force_cube", "-size", "0", "-frames", "1"),
])
def test_cli_cube_matches_jax_cli(tmp_path, flags):
    """-cube of the port's CLI on the CPU against ``python -m myyuv_tpu
    -cube --platform cpu`` (both called in-process)."""
    rng = np.random.default_rng(2)
    px = rng.integers(0, 256, (32, 48, 4), np.uint8)
    px[..., 3] = 255
    src = tmp_path / "tex.bmp"
    tbmp.BMPImage.from_pixels(px).dump(src)
    common = ["-cube", "-frames", "3", "-size", "48", "-shapes", "3",
              *flags]
    assert tcli.main([str(src), *common, "-o", str(tmp_path / "t"),
                      "--device", "cpu"]) == 0
    assert jcli.main([str(src), *common, "-o", str(tmp_path / "j"),
                      "--platform", "cpu"]) == 0
    got = sorted((tmp_path / "t").iterdir())
    want = sorted((tmp_path / "j").iterdir())
    assert [p.name for p in got] == [p.name for p in want]
    diff = total = 0
    for g, w in zip(got, want):
        a = tbmp.BMPImage.load(g).pixels_topdown()
        b = tbmp.BMPImage.load(w).pixels_topdown()
        assert a.shape == b.shape
        assert g.read_bytes()[:138] == w.read_bytes()[:138]   # headers
        diff += int((a != b).any(-1).sum())
        total += a.shape[0] * a.shape[1]
    print(f"-cube {' '.join(flags)}: {diff} of {total} pixels differ")
    assert diff / total <= MAX_DIFF_SHARE


@pytest.mark.parametrize("flag", [True, False])
def test_render_scene_leaves_the_tf32_flag_as_it_found_it(flag):
    """``render_scene`` reads and writes no process-wide PyTorch state:
    ``allow_tf32`` set True, then False, reads the same after a frame."""
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = flag
        args = _scene(16, 24, 2, 1)
        tcube.render_scene(
            *(torch.from_numpy(np.ascontiguousarray(a)) for a in args),
            16, 24)
        assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
