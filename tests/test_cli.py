"""CLI driver test: the reference's main() equivalent (src/main.cpp:240).

Runs `reconstruct` in-process (conftest already forces CPU) on cropped
dino frames and asserts the PLY / metrics artifacts it writes.
"""

import json
import pathlib

import numpy as np
import pytest

from sfm_jax import cli
from sfm_jax.io.image_io import load_gray

DINO = pathlib.Path("/root/reference/data/dino")


@pytest.mark.skipif(not DINO.exists(), reason="dino dataset not available")
@pytest.mark.slow
def test_cli_two_view(tmp_path):
    # Crop to keep the compile small; write the crops as binary PGMs the
    # loader accepts.
    paths = []
    for i in range(2):
        img = np.asarray(load_gray(DINO / f"viff.{i:03d}.ppm"))[40:360, 100:612]
        u8 = np.clip(img, 0, 255).astype(np.uint8)
        p = tmp_path / f"crop{i}.pgm"
        h, w = u8.shape
        p.write_bytes(f"P5\n{w} {h}\n255\n".encode() + u8.tobytes())
        paths.append(str(p))

    out = tmp_path / "cloud.ply"
    met = tmp_path / "metrics.json"
    rc = cli.main([
        "reconstruct", *paths,
        "--focal", "2360",
        "--octaves", "4", "--max-pts", "512", "--ransac-hyps", "512",
        "--ransac-thresh", "3e-6",
        "--out", str(out), "--metrics", str(met),
    ])
    assert rc == 0
    m = json.loads(met.read_text())
    assert m["mode"] == "two_view"
    assert m["num_matches"] > 200, m
    assert m["num_points"] > 50, m
    assert m["mean_reproj_px"] < 2.0, m
    head = out.read_bytes()[:200]
    assert head.startswith(b"ply")
    assert f"element vertex {m['num_points']}".encode() in head


def test_cli_sift_pair(tmp_path):
    """`sift` subcommand ≙ the reference's standalone demo
    (mainSift.cpp:25-93): extract a pair, match, fit a homography,
    export features — on crops of the synthetic pair."""
    from sfm_jax.io import synthetic as syn

    scene = syn.make_scene(0)
    K = syn.intrinsics()
    paths = []
    for i, (R, t) in enumerate(syn.two_view_poses()):
        img = syn.render(scene, K, R, t)[120:440, 100:612]
        paths.append(syn.write_ppm(tmp_path / f"crop{i}.ppm", img))

    out = tmp_path / "feats.npz"
    met = tmp_path / "sift.json"
    rc = cli.main([
        "sift", *paths,
        "--octaves", "4", "--max-pts", "512", "--thresh", "1.0",
        "--homography", "--homography-thresh", "5.0",
        "--out", str(out), "--metrics", str(met),
    ])
    assert rc == 0
    m = json.loads(met.read_text())
    assert m["mode"] == "sift"
    assert m["features"][0] > 200 and m["features"][1] > 200, m
    assert m["num_matches"] > 100, m
    assert m["homography_inliers"] > 0, m
    z = np.load(out)
    assert z["descriptors0"].shape == (m["features"][0], 128)
    assert z["x1"].shape == (m["features"][1],)
    # Descriptors are L2-normalized.
    n = np.linalg.norm(z["descriptors0"], axis=1)
    assert np.allclose(n[n > 0], 1.0, atol=1e-3)


def test_view_ply_html_roundtrip(tmp_path, rng):
    """tools/view_ply.py: PLY -> self-contained HTML viewer (the
    headless replacement for the reference's GLFW orbit viewer,
    src/main.cpp:318-352).  The embedded base64 buffer must decode to
    the exact point set and no template markers may survive."""
    import base64
    import numpy as np
    import sys as _sys, os as _os
    _sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), "..",
                                      "tools"))
    import view_ply
    from sfm_jax.io.image_io import save_ply

    pts = rng.normal(size=(257, 3)).astype(np.float32)
    p = tmp_path / "cloud.ply"
    save_ply(str(p), pts)
    out = tmp_path / "cloud.html"
    xyz, rgb = view_ply.load_ply(str(p))
    np.testing.assert_allclose(xyz, pts, rtol=1e-6)
    view_ply.write_html(xyz, rgb, str(out))
    html = out.read_text()
    assert "@B64@" not in html and "@N@" not in html and "@RGB@" not in html
    b64 = html.split('atob("', 1)[1].split('")', 1)[0]
    dec = np.frombuffer(base64.b64decode(b64), np.float32).reshape(-1, 3)
    np.testing.assert_array_equal(dec, xyz)
