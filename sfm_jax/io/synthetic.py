"""Seeded synthetic scenes with ground-truth poses (numpy only).

A box standing on a ground plane in front of a back wall: six
non-coplanar textured rectangles (a single plane would make the
essential matrix degenerate).  Each rectangle carries multi-scale
value noise — band-limited blobs at five cell sizes — which gives SIFT
stable extrema at every octave.  Images are rendered by casting one ray
per sub-pixel through known K, R, t and intersecting the rectangles, so
every pixel's 3-D point and texel are known exactly.

Pose convention matches the rest of the package: x_cam = R @ X + t.
World frame: y points down, the ground is the plane y = 0 seen from
y < 0, the box sits at the origin.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np

WIDTH, HEIGHT = 720, 576         # the reference's dino frame size
FOCAL = 1000.0
CELLS = (0.03, 0.06, 0.12, 0.24, 0.48)   # noise cell sizes, world units


@dataclasses.dataclass(frozen=True)
class Plane:
    origin: np.ndarray    # [3] corner of the rectangle
    e1: np.ndarray        # [3] first edge (length = extent along u)
    e2: np.ndarray        # [3] second edge
    grids: tuple          # per-cell-size noise grids over (u, v)
    mean: float           # base brightness 0..255


def _plane(rng, origin, e1, e2, mean):
    e1 = np.asarray(e1, np.float64)
    e2 = np.asarray(e2, np.float64)
    lu, lv = np.linalg.norm(e1), np.linalg.norm(e2)
    grids = tuple(
        rng.uniform(-1.0, 1.0, (int(lv / c) + 2, int(lu / c) + 2))
        for c in CELLS
    )
    return Plane(np.asarray(origin, np.float64), e1, e2, grids, mean)


def make_scene(seed: int = 0) -> list:
    """The box-on-ground scene; textures drawn from `seed`."""
    rng = np.random.default_rng(seed)
    b = 1.2   # box half-width
    hgt = 1.6  # box height
    return [
        _plane(rng, [-8, 0, -8], [16, 0, 0], [0, 0, 16], 110.0),      # ground
        _plane(rng, [-8, -8, 8], [16, 0, 0], [0, 8, 0], 140.0),      # back wall
        _plane(rng, [-b, -hgt, -b], [2 * b, 0, 0], [0, hgt, 0], 170.0),  # front
        _plane(rng, [-b, -hgt, -b], [0, 0, 2 * b], [0, hgt, 0], 90.0),   # left
        _plane(rng, [b, -hgt, -b], [0, 0, 2 * b], [0, hgt, 0], 130.0),   # right
        _plane(rng, [-b, -hgt, -b], [2 * b, 0, 0], [0, 0, 2 * b], 200.0),  # top
    ]


def intrinsics(width: int = WIDTH, height: int = HEIGHT,
               focal: float = FOCAL) -> np.ndarray:
    return np.array([[focal, 0, width / 2.0], [0, focal, height / 2.0],
                     [0, 0, 1]], np.float32)


def look_at(center, target=(0.0, -0.8, 0.0), up=(0.0, -1.0, 0.0)):
    """(R, t) of a camera at `center` looking at `target`."""
    center = np.asarray(center, np.float64)
    z = np.asarray(target, np.float64) - center
    z /= np.linalg.norm(z)
    x = np.cross(z, np.asarray(up, np.float64))
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z])
    return R, -R @ center


def orbit_poses(n: int, step_deg: float = 4.0, radius: float = 6.0,
                height: float = -2.2):
    """n cameras on a circle around the box, `step_deg` apart."""
    poses = []
    for i in range(n):
        a = np.deg2rad(-10.0 + step_deg * i)
        poses.append(look_at([radius * np.sin(a), height, -radius * np.cos(a)]))
    return poses


def _noise(grid, u, v, cell):
    """Value noise: smoothstep interpolation of a random grid."""
    gu, gv = u / cell, v / cell
    iu = np.clip(np.floor(gu).astype(np.int64), 0, grid.shape[1] - 2)
    iv = np.clip(np.floor(gv).astype(np.int64), 0, grid.shape[0] - 2)
    fu, fv = gu - iu, gv - iv
    fu = fu * fu * (3 - 2 * fu)
    fv = fv * fv * (3 - 2 * fv)
    g00, g01 = grid[iv, iu], grid[iv, iu + 1]
    g10, g11 = grid[iv + 1, iu], grid[iv + 1, iu + 1]
    return ((g00 * (1 - fu) + g01 * fu) * (1 - fv)
            + (g10 * (1 - fu) + g11 * fu) * fv)


def texture(plane: Plane, u, v):
    """Intensity 0..255 at plane coordinates (u, v) in world units."""
    val = sum(_noise(g, u, v, c) for g, c in zip(plane.grids, CELLS))
    return np.clip(plane.mean + 28.0 * val, 0.0, 255.0)


def cast(scene, K, R, t, px, py):
    """Nearest hit of the rays through pixels (px, py).

    Returns (plane index [-1 = miss], u, v, depth), each shaped like px.
    """
    Kinv = np.linalg.inv(np.asarray(K, np.float64))
    R = np.asarray(R, np.float64)
    C = -R.T @ np.asarray(t, np.float64)
    rays = np.stack([px, py, np.ones_like(px)], -1) @ Kinv.T  # camera frame
    d = rays @ R                                              # world frame
    best = np.full(px.shape, np.inf)
    pid = np.full(px.shape, -1, np.int64)
    U = np.zeros(px.shape)
    V = np.zeros(px.shape)
    for k, pl in enumerate(scene):
        n = np.cross(pl.e1, pl.e2)
        denom = d @ n
        with np.errstate(divide="ignore", invalid="ignore"):
            s = ((pl.origin - C) @ n) / denom
        X = C + s[..., None] * d
        rel = X - pl.origin
        u = rel @ pl.e1 / np.linalg.norm(pl.e1)
        v = rel @ pl.e2 / np.linalg.norm(pl.e2)
        hit = ((s > 1e-6) & (s < best) & (u >= 0) & (v >= 0)
               & (u <= np.linalg.norm(pl.e1)) & (v <= np.linalg.norm(pl.e2)))
        best = np.where(hit, s, best)
        pid = np.where(hit, k, pid)
        U = np.where(hit, u, U)
        V = np.where(hit, v, V)
    return pid, U, V, best  # s is the depth: rays have unit z in camera


def render(scene, K, R, t, width: int = WIDTH, height: int = HEIGHT,
           supersample: int = 2) -> np.ndarray:
    """[height, width] float32 image, 0..255, box-filtered supersamples."""
    ss = supersample
    off = (np.arange(ss) + 0.5) / ss - 0.5
    py, px = np.meshgrid(
        (np.arange(height)[:, None] + off[None, :]).ravel(),
        (np.arange(width)[:, None] + off[None, :]).ravel(), indexing="ij",
    )
    pid, U, V, _ = cast(scene, K, R, t, px, py)
    img = np.zeros(px.shape)
    for k, pl in enumerate(scene):
        m = pid == k
        img[m] = texture(pl, U[m], V[m])
    img = img.reshape(height, ss, width, ss).mean(axis=(1, 3))
    return img.astype(np.float32)


def relative_pose(pose1, pose2):
    """(R, unit t) of camera 2 in camera 1's frame (x2 = R x1 + t)."""
    R1, t1 = pose1
    R2, t2 = pose2
    R = R2 @ R1.T
    t = t2 - R @ t1
    return R, t / np.linalg.norm(t)


def two_view_poses():
    """The two-view pair: a sideways step with a few degrees of yaw."""
    return orbit_poses(2, step_deg=5.0)


def write_ppm(path, img) -> str:
    """Binary grey-replicated PPM (P6), the reference's image format."""
    u8 = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    h, w = u8.shape
    rgb = np.repeat(u8[:, :, None], 3, axis=2)
    pathlib.Path(path).write_bytes(f"P6\n{w} {h}\n255\n".encode() + rgb.tobytes())
    return str(path)


def write_sequence(directory, poses, seed: int = 0, width: int = WIDTH,
                   height: int = HEIGHT, focal: float = FOCAL) -> list:
    """Render the poses and write frame_XXX.ppm files; returns paths."""
    scene = make_scene(seed)
    K = intrinsics(width, height, focal)
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    return [
        write_ppm(directory / f"frame_{i:03d}.ppm",
                  render(scene, K, R, t, width, height))
        for i, (R, t) in enumerate(poses)
    ]


def scene_points(scene, n: int, seed: int = 0) -> np.ndarray:
    """[n, 3] points drawn uniformly on the scene's box and the ground
    around it (the textured surfaces the cameras see)."""
    rng = np.random.default_rng(seed)
    planes = [scene[0]] + list(scene[2:])          # ground + box faces
    k = rng.integers(0, len(planes), n)
    a, b = rng.uniform(0, 1, (2, n))
    pts = np.empty((n, 3))
    for i, pl in enumerate(planes):
        m = k == i
        if i == 0:   # ground: keep to the 6x6 patch around the box
            a[m] = 0.5 + (a[m] - 0.5) * 6.0 / 16.0
            b[m] = 0.5 + (b[m] - 0.5) * 6.0 / 16.0
        pts[m] = pl.origin + a[m, None] * pl.e1 + b[m, None] * pl.e2
    return pts


def ba_problem(poses, X, K, *, noise_px: float = 0.5, fix_first: bool = True,
               perturb: float = 0.01, seed: int = 0, obs_per_cam=None):
    """Bundle-adjustment problem from known poses and points.

    Every point in front of a camera and inside its image becomes an
    observation (or `obs_per_cam` of them, drawn at random), with
    Gaussian pixel noise.  Returns (problem, R0, t0, X0, R_gt, t_gt) with
    the initial state perturbed by `perturb` (radians / world units).
    fix_first=False holds no camera fixed: the gauge is then fixed only
    by the LM damping."""
    import jax
    import jax.numpy as jnp

    from sfm_jax.geometry import lie
    from sfm_jax.models import bundle_adjust as ba

    rng = np.random.default_rng(seed)
    R_gt = np.stack([p[0] for p in poses]).astype(np.float32)
    t_gt = np.stack([p[1] for p in poses]).astype(np.float32)
    X = np.asarray(X, np.float32)
    K = np.asarray(K, np.float64)
    w, h = 2 * K[0, 2], 2 * K[1, 2]
    cams, pts = [], []
    for m in range(len(poses)):
        Xc = X @ R_gt[m].T + t_gt[m]
        u = K[0, 0] * Xc[:, 0] / Xc[:, 2] + K[0, 2]
        v = K[1, 1] * Xc[:, 1] / Xc[:, 2] + K[1, 2]
        vis = np.flatnonzero((Xc[:, 2] > 0.1) & (u >= 0) & (u < w)
                             & (v >= 0) & (v < h))
        if obs_per_cam is not None:
            vis = rng.choice(vis, obs_per_cam, replace=False)
        cams.append(np.full(vis.shape, m, np.int32))
        pts.append(vis.astype(np.int32))
    cam_idx = np.concatenate(cams)
    pt_idx = np.concatenate(pts)
    Xc = np.einsum("oij,oj->oi", R_gt[cam_idx], X[pt_idx]) + t_gt[cam_idx]
    uv = Xc[:, :2] / Xc[:, 2:3]
    uv = uv + (noise_px / K[0, 0]) * rng.normal(size=uv.shape)
    fixed = np.zeros(len(poses), bool)
    fixed[0] = fix_first
    problem = ba.BAProblem(
        jnp.asarray(cam_idx), jnp.asarray(pt_idx),
        jnp.asarray(uv.astype(np.float32)),
        jnp.ones(cam_idx.shape, bool), jnp.asarray(fixed),
    )
    dr = perturb * rng.normal(size=(len(poses), 3)).astype(np.float32)
    dR = np.asarray(jax.vmap(lie.so3_exp)(jnp.asarray(dr)))
    keep = fixed[:, None, None]
    R0 = np.where(keep, R_gt, np.einsum("mij,mjk->mik", R_gt, dR))
    t0 = t_gt + np.where(fixed[:, None], 0.0,
                         perturb * rng.normal(size=t_gt.shape))
    X0 = X + 2 * perturb * rng.normal(size=X.shape)
    return (problem, R0.astype(np.float32), t0.astype(np.float32),
            X0.astype(np.float32), R_gt, t_gt)


def ring_ba_problem(n_cams: int = 50, n_pts: int = 50_000,
                    obs_per_cam: int = 8_000, seed: int = 0, **kw):
    """The BA benchmark shape: a ring of cameras looking inward at a
    cloud of points in the unit cube (M=50, P=50k, O=400k by default)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, size=(n_pts, 3))
    poses = []
    for a in np.linspace(0, 2 * np.pi, n_cams, endpoint=False):
        poses.append(look_at([4 * np.sin(a), 0.2, -4 * np.cos(a)],
                             target=(0.0, 0.0, 0.0)))
    K = intrinsics(WIDTH, HEIGHT, 300.0)
    return ba_problem(poses, X, K, obs_per_cam=obs_per_cam, seed=seed, **kw)
