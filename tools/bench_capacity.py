"""Reference-scale keypoint capacity demo: 32K-class frontend + matcher.

The reference allocates maxPts = 32768 SIFT slots (src/main.cpp:271)
and its CudaSift benchmark extracts ~1280x960 images at thresh 1-3
(CudaSift/mainSift.cpp).  This tool runs the frontend at the same
capacity class — 6 octaves x 8192 slots/octave detection capacity,
sample_cap=32768 sampled slots — on a 1440x1152 rendering of the
synthetic box scene (sfm_jax.io.synthetic), then matches the two 32K
descriptor sets, timing both stages (each call ended by
block_until_ready) and reporting peak device memory.

Usage: python tools/bench_capacity.py [--cpu]
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    if "--cpu" in sys.argv:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp

    from sfm_jax.config import SiftConfig, MatchConfig
    from sfm_jax.io import synthetic as syn
    from sfm_jax.sift import frontend, match as match_mod

    scene = syn.make_scene(0)
    K = syn.intrinsics(1440, 1152, 2.0 * syn.FOCAL)
    (R1, t1), (R2, t2) = syn.two_view_poses()
    img1 = jnp.asarray(syn.render(scene, K, R1, t1, 1440, 1152))
    img2 = jnp.asarray(syn.render(scene, K, R2, t2, 1440, 1152))
    print(f"image: {img1.shape}", file=sys.stderr)

    cfg = SiftConfig(
        num_octaves=6,
        max_pts_per_octave=8192,   # 49152-slot detection capacity
        sample_cap=32768,          # reference maxPts (src/main.cpp:271)
        thresh=0.6,                # denser detections for capacity fill
    )
    mcfg = MatchConfig()

    def timeit(fn, label, n=8):
        t0 = time.time()
        out = jax.block_until_ready(fn())
        print(f"{label}: compile {time.time()-t0:.1f}s", file=sys.stderr)
        best = 1e9
        for _ in range(3):
            t0 = time.time()
            jax.block_until_ready([fn() for _ in range(n)])
            best = min(best, (time.time() - t0) * 1000 / n)
        print(f"{label}: {best:.2f} ms", flush=True)
        return out

    r1 = timeit(lambda: frontend.extract_sift(img1, cfg), "extract[32K]")
    r2 = frontend.extract_sift(img2, cfg)
    n1 = int(np.asarray(jnp.sum(r1.keypoints.valid)))
    n2 = int(np.asarray(jnp.sum(r2.keypoints.valid)))
    print(f"keypoints: {n1} / {n2} of {r1.descriptors.shape[0]} slots")

    timeit(
        lambda: match_mod.match(
            r1.descriptors, r2.descriptors,
            r1.keypoints.valid, r2.keypoints.valid, mcfg,
        ),
        "match[32Kx32K]",
    )
    m = match_mod.match(
        r1.descriptors, r2.descriptors,
        r1.keypoints.valid, r2.keypoints.valid, mcfg,
    )
    print(f"matches: {int(np.asarray(jnp.sum(m.valid)))}")

    try:
        stats = jax.local_devices()[0].memory_stats()
        if stats:
            print(
                f"peak device memory: "
                f"{stats.get('peak_bytes_in_use', 0) / 2**20:.0f} MiB"
            )
    except Exception:
        pass


if __name__ == "__main__":
    main()
