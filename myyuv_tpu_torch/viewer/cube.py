"""Spinning textured shapes: the software-rendered analog of the
reference's OpenGL demo (myyuv_opengl/spinning_cube/).

Port of ``myyuv_tpu/viewer/cube.py``. The camera, projection, placement
and geometry are the port's own numpy copies of the JAX package's
(``normalize_angle``, ``perspective``, ``Camera``, ``generation_radius``,
``generate_shape_positions``, ``shape_geometry``, ``default_fly_script``),
with the reference's rules:

* ``shapes`` = N (1..1000) shapes placed by the rejection sampling of
  ``generate_random_cube_pos`` (spinning_cube.cpp:288-312), drawn from
  ``np.random.default_rng(seed)``; shape 0 sits at the origin.
* each shape spins around +Y at 15 deg/s (spinning_cube.cpp:18).
* a +-1 cube under ``force_cube``, else a parallelepiped with half-extents
  normalize(w, h, w) (spinning_cube.cpp:157-160); ``flip_width_height``
  swaps w and h first.
* the reference's fly camera (spinning_cube.hpp:24-38, .cpp:46-74), driven
  headless by a scripted per-frame input (``fly_script``).
* perspective(45 deg, aspect, 0.1, 500) onto a 1000x800 target by default,
  clear colour (0.7, 0.75, 0.71).

``render_scene`` is the rasteriser in PyTorch on an explicit device: a
Python loop over the shapes takes the place of the JAX package's
``lax.scan``; within a shape all 12 triangles test all pixels at once
([12, H, W] edge functions, perspective-correct UV, a 1/w z-buffer merged
shape after shape). In the JAX package it is XLA, not a Pallas kernel, so
plain PyTorch is its port. Its small products (``proj @ view`` and the
vertex transforms) are float32 multiplies summed over k in ascending order
(``_small_product``), not ``torch.matmul``: no precision flag governs
them, and the renderer reads and writes no process-wide PyTorch state.

Pixels on triangle edges, at z ties and at texel boundaries may differ
between devices and from the JAX package's: each side evaluates the same
float32 expressions with its own operation order and contraction, and an
edge function of about 0, a depth tie or a texel coordinate at an integer
then lands on the other side.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np
import torch

F32 = torch.float32

SHAPES_COUNT_MAX = 1000          # spinning_cube.cpp:15
SCREEN_WIDTH = 1000              # spinning_cube.cpp:16
SCREEN_HEIGHT = 800              # spinning_cube.cpp:17
CUBE_ROTATION_SPEED = 15.0       # deg/s, spinning_cube.cpp:18
CLEAR_BGR = (181, 191, 178)      # (0.7, 0.75, 0.71) RGB as BGR bytes
_NEAR, _FAR = 0.1, 500.0


def normalize_angle(angle: float) -> float:
    """Wrap to (-180, 180] (spinning_cube.cpp:79-85)."""
    if angle > 180.0:
        angle -= 360.0
    elif angle < -180.0:
        angle += 360.0
    return angle


def perspective(fovy_deg: float = 45.0,
                aspect: float = SCREEN_WIDTH / SCREEN_HEIGHT,
                near: float = _NEAR, far: float = _FAR) -> np.ndarray:
    """Row-major glm::perspective (spinning_cube.cpp:19)."""
    t = np.tan(np.radians(fovy_deg) / 2)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = 1 / (aspect * t)
    m[1, 1] = 1 / t
    m[2, 2] = -(far + near) / (far - near)
    m[2, 3] = -2 * far * near / (far - near)
    m[3, 2] = -1.0
    return m


def _sgn(v) -> float:
    return float(v > 0) - float(v < 0)


@dataclasses.dataclass
class Camera:
    """The reference fly camera (spinning_cube.hpp:24-38, .cpp:46-74)."""

    pos: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    pitch: float = 0.0
    yaw: float = -90.0
    speed: float = 3.0
    sensitivity: float = 2.5
    world_up: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0, 1, 0], np.float32))

    def __post_init__(self):
        self.update()

    def update(self) -> None:
        cy, sy = np.cos(np.radians(self.yaw)), np.sin(np.radians(self.yaw))
        cp, sp = (np.cos(np.radians(self.pitch)),
                  np.sin(np.radians(self.pitch)))
        front = np.array([cy * cp, sp, sy * cp], np.float32)
        self.front = front / np.linalg.norm(front)
        right = np.cross(self.front, self.world_up)
        self.right = right / np.linalg.norm(right)
        up = np.cross(self.right, self.front)
        self.up = up / np.linalg.norm(up)

    def move(self, x: int, y: int, z: int, delta: float) -> None:
        vel = self.speed * delta
        self.pos = (self.pos + self.front * _sgn(x) * vel
                    + self.right * _sgn(z) * vel + self.up * _sgn(y) * vel)

    def turn(self, x: int, y: int, delta: float) -> None:
        self.yaw += _sgn(x) * self.sensitivity * delta * 10.0
        self.pitch = float(np.clip(
            self.pitch + _sgn(y) * self.sensitivity * delta * 10.0,
            -89.9, 89.9))
        self.yaw = normalize_angle(self.yaw)

    def view(self) -> np.ndarray:
        """Row-major glm::lookAt(pos, pos+front, up)."""
        f = self.front
        s = np.cross(f, self.up)
        s = s / np.linalg.norm(s)
        u = np.cross(s, f)
        m = np.eye(4, dtype=np.float32)
        m[0, :3], m[1, :3], m[2, :3] = s, u, -f
        m[0, 3] = -np.dot(s, self.pos)
        m[1, 3] = -np.dot(u, self.pos)
        m[2, 3] = np.dot(f, self.pos)
        return m


def generation_radius(shapes_count: int) -> float:
    """spinning_cube.cpp:279-282 ("Because it works")."""
    return float(np.sqrt(shapes_count))


def generate_shape_positions(shapes_count: int,
                             rng: Optional[np.random.Generator] = None
                             ) -> np.ndarray:
    """Rejection-sampled non-overlapping placement
    (generate_random_cube_pos, spinning_cube.cpp:288-312): shape 0 at the
    origin, candidates uniform in [-r, r]^3, rejected while any placed
    shape is within sqrt(3)*2; 1000 attempts per shape."""
    if not 1 <= shapes_count <= SHAPES_COUNT_MAX:
        raise ValueError(
            f"Shapes count must be between 1 and {SHAPES_COUNT_MAX}")
    rng = rng or np.random.default_rng(0)
    radius = generation_radius(shapes_count)
    two_radius = np.sqrt(3.0) * 2.0
    placed = [np.zeros(3, np.float32)]
    for _ in range(1, shapes_count):
        for attempt in range(1000):
            # generate_rand (spinning_cube.cpp:284-287) draws from
            # [min, max + 1): the +1 makes small fields placeable at all
            # (radius sqrt(2) < sqrt(3)*2), so mirror it exactly
            cand = rng.uniform(-radius, radius + 1.0, 3).astype(np.float32)
            d = np.linalg.norm(np.asarray(placed) - cand, axis=1)
            if (d > two_radius).all():
                placed.append(cand)
                break
        else:
            raise RuntimeError("Unable to generate new position")
    return np.asarray(placed, np.float32)


def shape_geometry(tex_w: int, tex_h: int, force_cube: bool = False,
                   flip_width_height: bool = False):
    """Vertices/triangles/UVs of the textured shape.

    ``force_cube``: the +-1 cube (create_cube, spinning_cube.cpp:86-155);
    otherwise half-extents normalize(w, h, w) (create_parallelepiped,
    spinning_cube.cpp:157-160). ``flip_width_height`` swaps w/h first
    (main.cpp:20-57; no-op for cubes)."""
    if force_cube:
        hx = hy = hz = 1.0
    else:
        w, h = (tex_h, tex_w) if flip_width_height else (tex_w, tex_h)
        c = np.array([w, h, w], np.float64)
        c = c / np.linalg.norm(c)
        hx, hy, hz = c
    v = np.array([[sx * hx, sy * hy, sz * hz]
                  for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                 np.float32)
    faces = [
        (0, 1, 3, 2),  # -x
        (5, 4, 6, 7),  # +x
        (4, 0, 2, 6),  # -z
        (1, 5, 7, 3),  # +z
        (2, 3, 7, 6),  # +y (top)
        (4, 5, 1, 0),  # -y (bottom)
    ]
    uv = np.array([(0, 1), (1, 1), (1, 0), (0, 0)], np.float32)
    tris, uvs = [], []
    for q in faces:
        tris += [(q[0], q[1], q[2]), (q[0], q[2], q[3])]
        uvs += [(uv[0], uv[1], uv[2]), (uv[0], uv[2], uv[3])]
    return (v, np.asarray(tris, np.int32), np.asarray(uvs, np.float32))


def _small_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[m, k] x [k, n] float32 as products summed over k, ascending: the
    same arithmetic on every device, under no matmul precision flag."""
    acc = a[:, 0:1] * b[0:1, :]
    for k in range(1, a.shape[1]):
        acc = acc + a[:, k:k + 1] * b[k:k + 1, :]
    return acc


def render_scene(texture_bgrx: torch.Tensor, verts: torch.Tensor,
                 tris: torch.Tensor, uvs: torch.Tensor,
                 positions: torch.Tensor, angles_deg: torch.Tensor,
                 view: torch.Tensor, proj: torch.Tensor,
                 out_h: int, out_w: int) -> torch.Tensor:
    """Render N spinning shapes -> [out_h, out_w, 4] uint8 BGRX, on the
    device of ``texture_bgrx`` (every input lies there: texture [th, tw, 4]
    u8, verts [8, 3], uvs [12, 3, 2], positions [N, 3], angles [N], view
    and proj [4, 4] float32, tris [12, 3] integer)."""
    dev = texture_bgrx.device
    tris = tris.long()
    vp = _small_product(proj, view)                        # [4, 4]
    ys = torch.arange(out_h, dtype=F32, device=dev)[:, None] + 0.5
    xs = torch.arange(out_w, dtype=F32, device=dev)[None, :] + 0.5

    def edge(x0, y0, x1, y1):
        return ((x1 - x0)[:, None, None] * (ys - y0[:, None, None])
                - (y1 - y0)[:, None, None] * (xs - x0[:, None, None]))

    uva, uvb, uvc = uvs[:, 0], uvs[:, 1], uvs[:, 2]
    best_iz = torch.full((out_h, out_w), -torch.inf, dtype=F32, device=dev)
    best_u = torch.zeros((out_h, out_w), dtype=F32, device=dev)
    best_v = torch.zeros((out_h, out_w), dtype=F32, device=dev)
    one = torch.ones((), dtype=F32, device=dev)
    for pos, ang in zip(positions.to(F32), angles_deg.to(F32)):
        ra = torch.deg2rad(ang)
        ca, sa = torch.cos(ra), torch.sin(ra)
        zero = torch.zeros_like(ca)
        rot_y = torch.stack([torch.stack([ca, zero, sa]),
                             torch.stack([zero, one, zero]),
                             torch.stack([-sa, zero, ca])])
        world = _small_product(verts, rot_y.T) + pos[None, :]
        clip = _small_product(torch.cat(
            [world, torch.ones((world.shape[0], 1), dtype=F32, device=dev)],
            1), vp.T)
        wc = clip[:, 3]
        ok_v = wc > _NEAR                                  # near-plane cull
        wsafe = torch.where(ok_v, wc, one)
        ndc = clip[:, :2] / wsafe[:, None]
        px = (ndc[:, 0] * 0.5 + 0.5) * out_w
        py = (0.5 - ndc[:, 1] * 0.5) * out_h
        iz = torch.where(ok_v, 1.0 / wsafe, 0.0)

        ax, ay = px[tris[:, 0]], py[tris[:, 0]]
        bx, by = px[tris[:, 1]], py[tris[:, 1]]
        cx, cy = px[tris[:, 2]], py[tris[:, 2]]
        za, zb, zc = iz[tris[:, 0]], iz[tris[:, 1]], iz[tris[:, 2]]
        tri_ok = ok_v[tris[:, 0]] & ok_v[tris[:, 1]] & ok_v[tris[:, 2]]

        w0 = edge(bx, by, cx, cy)
        w1 = edge(cx, cy, ax, ay)
        w2 = edge(ax, ay, bx, by)
        area = w0 + w1 + w2
        # back-face cull + inside test (counter-clockwise winding => area
        # < 0 in this y-down pixel space)
        inside = ((w0 <= 0) & (w1 <= 0) & (w2 <= 0)
                  & (area[..., :1, :1] < 0) & tri_ok[:, None, None])
        safe_area = torch.where(area == 0, one, area)
        l0, l1, l2 = w0 / safe_area, w1 / safe_area, w2 / safe_area
        izp = (l0 * za[:, None, None] + l1 * zb[:, None, None]
               + l2 * zc[:, None, None])
        izp_safe = torch.where(izp == 0, one, izp)

        def interp(attr_a, attr_b, attr_c):
            return (l0 * (attr_a * za)[:, None, None]
                    + l1 * (attr_b * zb)[:, None, None]
                    + l2 * (attr_c * zc)[:, None, None]) / izp_safe

        uu = interp(uva[:, 0], uvb[:, 0], uvc[:, 0])
        vv = interp(uva[:, 1], uvb[:, 1], uvc[:, 1])

        key = torch.where(inside, izp, -torch.inf)
        best = torch.argmax(key, 0)                        # [H, W]
        iz_here = torch.amax(key, 0)
        u_here = torch.gather(uu, 0, best[None])[0]
        v_here = torch.gather(vv, 0, best[None])[0]

        closer = iz_here > best_iz
        best_iz = torch.where(closer, iz_here, best_iz)
        best_u = torch.where(closer, u_here, best_u)
        best_v = torch.where(closer, v_here, best_v)

    hit = best_iz > -torch.inf
    th, tw = texture_bgrx.shape[:2]
    ti = torch.clamp((best_v * th).to(torch.int32), 0, th - 1).long()
    tj = torch.clamp((best_u * tw).to(torch.int32), 0, tw - 1).long()
    texel = texture_bgrx[ti, tj]                           # [H, W, 4]
    bg = torch.tensor([*CLEAR_BGR, 255], dtype=torch.uint8, device=dev)
    return torch.where(hit[..., None], texel, bg)


def default_fly_script(i: int) -> Tuple[int, int, int, int, int]:
    """Scripted stand-in for the interactive WASD/arrow input
    (handle_events, spinning_cube.cpp:233-275): fly forward while gently
    panning right — returns (x, y, z, view_x, view_y) for frame i."""
    return (1, 0, 0, 1 if i % 3 == 0 else 0, 0)


def render_spinning_cube(texture_bgrx: np.ndarray, out_dir,
                         n_frames: int = 24, out_size: int = 0,
                         shapes: int = 1, force_cube: bool = False,
                         flip_width_height: bool = False,
                         fly_script: Optional[Callable] = None,
                         frame_dt: float = 0.04, seed: int = 0,
                         device="cuda") -> list:
    """Render n_frames of the spinning-shapes demo on ``device`` to BMP
    files ``frame_NNN.bmp`` in ``out_dir``; returns their paths.

    ``out_size`` 0 uses the reference 1000x800 screen; otherwise a square
    out_size x out_size target. ``frame_dt`` is the per-frame time step
    (0.04 s = the reference's ~25 fps event loop)."""
    from ..engine.pipeline import resolve_device
    from . import export
    dev = resolve_device(device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    th, tw = texture_bgrx.shape[:2]
    if out_size and out_size > 0:
        out_h = out_w = int(out_size)
    else:
        out_h, out_w = SCREEN_HEIGHT, SCREEN_WIDTH
    verts, tris, uvs = shape_geometry(tw, th, force_cube, flip_width_height)
    positions = generate_shape_positions(shapes, np.random.default_rng(seed))
    radius = generation_radius(shapes)

    cam = Camera()
    cam.pos = np.array([radius * 2.5 + 3.0, 0.0, radius * 2.5 + 3.0],
                       np.float32)
    cam.yaw = -135.0
    cam.update()
    proj = perspective(aspect=out_w / out_h)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    tex, verts_t, tris_t, uvs_t, pos_t, proj_t = (
        put(a) for a in (texture_bgrx, verts, tris, uvs, positions, proj))
    angles = np.zeros(shapes, np.float32)
    paths = []
    for i in range(n_frames):
        if fly_script is not None:
            x, y, z, vx, vy = fly_script(i)
            cam.turn(vx, vy, frame_dt)
            cam.move(x, y, z, frame_dt)
            cam.update()
        frame = render_scene(tex, verts_t, tris_t, uvs_t, pos_t, put(angles),
                             put(cam.view()), proj_t, out_h, out_w)
        p = out_dir / f"frame_{i:03d}.bmp"
        export.write_bgrx_bmp(p, frame.cpu().numpy())
        paths.append(p)
        angles = np.array([normalize_angle(a + CUBE_ROTATION_SPEED
                                           * frame_dt) for a in angles],
                          np.float32)
    return paths
