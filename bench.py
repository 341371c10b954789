"""Benchmark: end-to-end two-view SfM on the synthetic pair, on the GPU.

Prints ONE JSON line: {"metric", "value", "unit", "gates", ...} with
the device named.  The pair is the seeded box scene of
sfm_jax.io.synthetic at 720x576 (the same pair chip_smoke.py renders),
so the gates are checked against ground-truth poses.  Per-pair time is
the median over repeated calls, each ended by block_until_ready.
Per-seed quality goes to stderr.  Cells, metrics and bounds are left to
the benchmark work that follows; this script fails unless JAX's
platform is "gpu".
"""

from __future__ import annotations

import json
import math
import sys
import time

import numpy as np


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp

    from sfm_jax import device
    from sfm_jax.config import PipelineConfig, RansacConfig, SiftConfig
    from sfm_jax.io import synthetic as syn
    from sfm_jax.models import two_view

    devs = device.require_gpu()
    device.enable_compile_cache()
    log(f"devices: {devs}")

    scene = syn.make_scene(0)
    K_np = syn.intrinsics()
    poses = syn.two_view_poses()
    img1, img2 = (jnp.asarray(syn.render(scene, K_np, R, t)) for R, t in poses)
    R_gt, t_gt = syn.relative_pose(*poses)
    K = jnp.asarray(K_np)
    cfg = PipelineConfig(
        sift=SiftConfig(max_pts_per_octave=1024),
        ransac=RansacConfig(n_hyps=1536, threshold=3e-6, chunk=256),
        tvote_rounds=0,
    )
    keys = [jax.random.PRNGKey(i) for i in range(16)]

    def run(i):
        return two_view.two_view_pipeline(img1, img2, K, keys[i % 16], cfg)

    t0 = time.perf_counter()
    jax.block_until_ready(run(0))
    log(f"compile+first run: {time.perf_counter() - t0:.1f} s")

    # Quality over several RANSAC seeds, gated per seed against ground
    # truth (CPU run of this pair: 1996 matches, 1816 inliers, 0.17 px,
    # 0.04 deg translation-direction error).
    gate_failures = []

    def gate(cond, msg):
        if not cond:
            gate_failures.append(msg)
            log(f"GATE FAIL: {msg}")

    for s in range(8):
        r = run(s)
        R = np.asarray(r.R)
        t = np.asarray(r.t)
        r_err = math.degrees(math.acos(
            np.clip((np.trace(R @ R_gt.T) - 1) / 2, -1, 1)))
        t_err = math.degrees(math.acos(
            np.clip(t @ t_gt / np.linalg.norm(t), -1, 1)))
        px = math.sqrt(float(r.reproj_err) / 2) * syn.FOCAL
        q = (int(r.num_matches), int(r.num_inliers),
             int(r.point_valid.sum()), px, r_err, t_err)
        log(f"seed {s}: matches={q[0]} inliers={q[1]} valid={q[2]} "
            f"px={px:.3f} rot_err={r_err:.4f} t_err={t_err:.4f}")
        gate(q[0] >= 1500, f"seed {s} matches {q[0]} < 1500")
        gate(q[2] >= 1300, f"seed {s} valid points {q[2]} < 1300")
        gate(px <= 0.35, f"seed {s} reproj {px:.3f} px > 0.35")
        gate(r_err <= 0.2, f"seed {s} rotation error {r_err:.4f} > 0.2 deg")
        gate(t_err <= 1.0, f"seed {s} translation error {t_err:.4f} > 1 deg")

    ts = []
    for i in range(30):
        t0 = time.perf_counter()
        jax.block_until_ready(run(i))
        ts.append((time.perf_counter() - t0) * 1e3)
    ms = float(np.median(ts))
    log(f"per pair: median {ms:.3f} ms, p90 {np.percentile(ts, 90):.3f} ms, "
        f"n={len(ts)}")
    print(json.dumps({
        "metric": "synthetic_pair_e2e_ms",
        "value": round(ms, 3),
        "unit": "ms",
        "samples": len(ts),
        "device": {"platform": devs[0].platform,
                   "kind": devs[0].device_kind, "count": len(devs)},
        "gates": "fail" if gate_failures else "pass",
        "gate_failures": gate_failures,
    }))
    if gate_failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
