"""Sequence-mode throughput: ms per REGISTERED FRAME on a synthetic orbit.

The pair benchmark (bench.py) extracts BOTH images per pair; a
production sequence extracts each frame ONCE and reuses features for
the pair chain (reference has no sequence mode at all — src/main.cpp
is strictly two images).  This measures the streaming cost of one new
frame: extract(frame) + match(prev, frame) + two-view geometry, chained
N frames deep with one block_until_ready at the end.  The frames are the
seeded box scene of sfm_jax.io.synthetic at 720x576.

Usage: python tools/bench_seq.py [n_frames]
"""

from __future__ import annotations

import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from sfm_jax import device

    device.enable_compile_cache()
    from sfm_jax.config import SiftConfig, PipelineConfig, RansacConfig
    from sfm_jax.io import synthetic as syn
    from sfm_jax.models import two_view
    from sfm_jax.sift import frontend

    n_frames = int(sys.argv[1]) if len(sys.argv) > 1 else 12
    scene = syn.make_scene(0)
    K_np = syn.intrinsics()
    frames = [jnp.asarray(syn.render(scene, K_np, R, t))
              for R, t in syn.orbit_poses(n_frames)]
    K = jnp.asarray(K_np)
    cfg = PipelineConfig(
        sift=SiftConfig(max_pts_per_octave=1024),
        ransac=RansacConfig(n_hyps=1024, threshold=3e-6, chunk=256),
    )
    keys = [jax.random.PRNGKey(i) for i in range(64)]

    def step(prev_feat, img, key):
        """One streaming step: extract the new frame, pair it with the
        previous frame's features, run the geometry program."""
        feat = frontend.extract_sift(img, cfg.sift)
        uv1, uv2, mask = two_view._match_stage(prev_feat, feat, cfg)
        res = two_view.two_view_geometry(key, uv1, uv2, mask, K, cfg)
        return feat, res

    # Warm up / compile.
    t0 = time.time()
    feat0 = frontend.extract_sift(frames[0], cfg.sift)
    feat, res = step(feat0, frames[1], keys[0])
    px = math.sqrt(float(res.reproj_err) / 2) * syn.FOCAL
    print(
        f"compile+first step {time.time()-t0:.1f}s  "
        f"matches={int(res.num_matches)} inliers={int(res.num_inliers)} "
        f"reproj={px:.3f}px",
        flush=True,
    )

    best = float("inf")
    for rep in range(3):
        t0 = time.time()
        feat = feat0
        errs = []
        for i in range(1, n_frames):
            feat, res = step(feat, frames[i], keys[(rep * n_frames + i) % 64])
            errs.append(res.reproj_err)
        jax.block_until_ready(errs)
        ms = (time.time() - t0) * 1000.0 / (n_frames - 1)
        best = min(best, ms)
        print(f"rep {rep}: {ms:.2f} ms/frame", flush=True)
    print(f"sequence streaming: {best:.2f} ms/frame "
          f"({1000.0/best:.1f} fps, {n_frames-1} steps)", flush=True)


if __name__ == "__main__":
    main()
