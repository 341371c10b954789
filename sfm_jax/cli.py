"""Command-line driver — the replacement for the reference's app layer
(reference src/main.cpp:240-359: argv device/imgSet selection,
hard-coded paths and K, GL window).  Headless: reconstruct from image
files, export PLY + JSON metrics, optional checkpoint.

Usage:
  python -m sfm_jax reconstruct IMG1 IMG2 [IMG...] \
      --focal 2360 [--cx CX --cy CY] --out cloud.ply \
      [--metrics metrics.json] [--checkpoint map.npz] [--ba-iters 20]
  python -m sfm_jax sift IMG [IMG2] [--thresh 2.0] [--up-scale] \
      [--out feats.npz] [--metrics out.json] [--homography]
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time


def _build_K(args, w, h):
    import numpy as np

    cx = args.cx if args.cx is not None else w / 2.0
    cy = args.cy if args.cy is not None else h / 2.0
    return np.array(
        [[args.focal, 0, cx], [0, args.focal, cy], [0, 0, 1]], np.float32
    )


def _load_images(paths):
    from sfm_jax.io import image_io, native

    if native.available() and all(
        str(p).lower().endswith((".ppm", ".pgm")) for p in paths
    ):
        batch = native.load_gray_batch(paths)
        return [batch[i] for i in range(batch.shape[0])]
    return [image_io.load_gray(p) for p in paths]


def cmd_reconstruct(args):
    # Distribution wiring must precede any jax computation
    # (jax.distributed.initialize constraint).
    mesh = None
    if args.distributed or args.mesh:
        from sfm_jax.parallel import mesh as meshmod

        if args.distributed:
            n_proc = meshmod.init_distributed()
            mesh = meshmod.make_global_mesh()
            print(
                f"distributed: {n_proc} processes, mesh over "
                f"{mesh.size} devices", file=sys.stderr,
            )
        else:
            mesh = meshmod.make_mesh(args.mesh if args.mesh > 0 else None)

    import numpy as np
    import jax
    import jax.numpy as jnp

    from sfm_jax.config import PipelineConfig, SiftConfig, RansacConfig
    from sfm_jax.utils.timing import StageTimer

    timer = StageTimer()
    t_start = time.perf_counter()
    imgs = _load_images(args.images)
    h, w = imgs[0].shape
    K = _build_K(args, w, h)
    cfg = PipelineConfig(
        sift=SiftConfig(
            max_pts_per_octave=args.max_pts, thresh=args.thresh,
            num_octaves=args.octaves,
        ),
        ransac=RansacConfig(n_hyps=args.ransac_hyps,
                            threshold=args.ransac_thresh,
                            chunk=args.ransac_chunk),
        tvote_rounds=args.tvote_rounds,
    )
    timer.record("load_images", time.perf_counter() - t_start)

    if len(imgs) == 2:
        from sfm_jax.models import two_view

        t0 = time.perf_counter()
        res = two_view.run_two_view(
            jnp.asarray(imgs[0]), jnp.asarray(imgs[1]), jnp.asarray(K),
            cfg, seed=args.seed,
        )
        jax.block_until_ready(res)
        timer.record("pipeline", time.perf_counter() - t0)
        points = np.array(res.points)
        valid = np.array(res.point_valid)
        err_px = math.sqrt(float(res.reproj_err) / 2) * float(args.focal)
        metrics = {
            "mode": "two_view",
            "num_matches": int(res.num_matches),
            "num_inliers": int(res.num_inliers),
            "num_points": int(valid.sum()),
            "mean_reproj_px": round(err_px, 4),
            # Recovered relative pose (reference prints nothing; the
            # pose otherwise only lives in the point cloud's frame).
            "R": np.round(np.array(res.R), 6).tolist(),
            "t": np.round(np.array(res.t), 6).tolist(),
        }
        state = None
    else:
        from sfm_jax.models import incremental

        t0 = time.perf_counter()
        res = incremental.run_incremental(
            imgs, K, cfg, seed=args.seed, ba_iters=args.ba_iters,
            closure_pairs=args.closure, mesh=mesh,
        )
        jax.block_until_ready(res)
        timer.record("pipeline", time.perf_counter() - t0)
        state = res.state
        points = np.array(state.X)
        valid = np.array(state.X_valid)
        err_px = math.sqrt(float(res.mean_reproj) / 2) * float(args.focal)
        costs = np.array(res.ba_costs)
        metrics = {
            "mode": "incremental",
            "num_images": len(imgs),
            "poses_registered": int(np.array(state.pose_valid).sum()),
            "num_points": int(valid.sum()),
            "mean_reproj_px": round(err_px, 4),
            "ba_cost_initial": float(costs[0]),
            "ba_cost_final": float(costs[-1]),
            "ba_costs": [float(c) for c in costs],
            "R": np.round(np.array(state.R), 6).tolist(),
            "t": np.round(np.array(state.t), 6).tolist(),
        }

    if args.out:
        t0 = time.perf_counter()
        from sfm_jax.io import native

        if native.available():
            native.save_ply(args.out, points, valid=valid.astype(np.uint8))
        else:
            from sfm_jax.io.image_io import save_ply

            save_ply(args.out, points, valid=valid)
        timer.record("export", time.perf_counter() - t0)
        metrics["ply"] = args.out

    if args.checkpoint and state is not None:
        from sfm_jax.utils.checkpoint import save_map

        save_map(args.checkpoint, state, extra={"K": K.tolist()})
        metrics["checkpoint"] = args.checkpoint

    metrics["stage_times"] = timer.summary()
    out = json.dumps(metrics, indent=2)
    print(out)
    if args.metrics:
        with open(args.metrics, "w") as f:
            f.write(out)
    return 0


def cmd_sift(args):
    """Standalone SIFT demo: extract (+ match + homography on a pair).

    Replaces the reference's mainSift.cpp:25-93 (ExtractSift on
    data/left.pgm + data/righ.pgm, MatchSiftData, FindHomography,
    printed match stats); also exports the features the reference only
    keeps in device memory.
    """
    import numpy as np
    import jax
    import jax.numpy as jnp

    from sfm_jax.config import MatchConfig, SiftConfig
    from sfm_jax.sift import frontend, match as match_mod
    from sfm_jax.utils.timing import StageTimer

    timer = StageTimer()
    t0 = time.perf_counter()
    imgs = _load_images(args.images)
    timer.record("load_images", time.perf_counter() - t0)
    cfg = SiftConfig(
        num_octaves=args.octaves, thresh=args.thresh,
        max_pts_per_octave=args.max_pts, up_scale=args.up_scale,
    )

    t0 = time.perf_counter()
    results = [frontend.extract_sift(jnp.asarray(im), cfg) for im in imgs]
    counts = [int(r.keypoints.count()) for r in results]
    timer.record("extract", time.perf_counter() - t0)
    metrics = {"mode": "sift", "num_images": len(imgs), "features": counts}

    if len(imgs) == 2:
        t0 = time.perf_counter()
        f1, f2 = results
        m = match_mod.match(
            f1.descriptors, f2.descriptors,
            f1.keypoints.valid, f2.keypoints.valid, MatchConfig(),
        )
        n_match = int(jnp.sum(m.valid))
        timer.record("match", time.perf_counter() - t0)
        metrics["num_matches"] = n_match
        metrics["match_pct"] = round(100.0 * n_match / max(counts[0], 1), 1)

        if args.homography:
            from sfm_jax.geometry import homography

            t0 = time.perf_counter()
            uv1 = jnp.stack([f1.keypoints.x, f1.keypoints.y], axis=-1)
            uv2 = jnp.stack(
                [f2.keypoints.x, f2.keypoints.y], axis=-1
            )[m.index]
            res = homography.ransac_homography(
                jax.random.PRNGKey(args.seed), uv1, uv2, m.valid,
                n_hyps=1024, threshold=float(args.homography_thresh) ** 2,
            )
            timer.record("homography", time.perf_counter() - t0)
            metrics["homography_inliers"] = int(res.num_inliers)
            metrics["H"] = np.round(np.array(res.H), 6).tolist()

    if args.out:
        t0 = time.perf_counter()
        arrays = {}
        for i, r in enumerate(results):
            kp = r.keypoints
            v = np.asarray(kp.valid)
            arrays.update({
                f"x{i}": np.asarray(kp.x)[v],
                f"y{i}": np.asarray(kp.y)[v],
                f"scale{i}": np.asarray(kp.scale)[v],
                f"orientation{i}": np.asarray(kp.orientation)[v],
                f"descriptors{i}": np.asarray(r.descriptors)[v],
            })
        np.savez_compressed(args.out, **arrays)
        timer.record("export", time.perf_counter() - t0)
        metrics["out"] = args.out

    metrics["stage_times"] = timer.summary()
    out = json.dumps(metrics, indent=2)
    print(out)
    if args.metrics:
        with open(args.metrics, "w") as f:
            f.write(out)
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="sfm_jax", description=__doc__)
    p.add_argument(
        "--platform", choices=("auto", "cpu", "gpu"), default="auto",
        help="cpu: run on the CPU backend; gpu: fail unless JAX sees a "
             "GPU; auto: JAX's default backend",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("reconstruct", help="reconstruct from 2+ images")
    r.add_argument("images", nargs="+", help="input images (2 = two-view, 3+ = incremental)")
    r.add_argument("--focal", type=float, default=2360.0,
                   help="focal length in px (reference dino default 2360, src/main.cpp:292)")
    r.add_argument("--cx", type=float, default=None)
    r.add_argument("--cy", type=float, default=None)
    r.add_argument("--out", default=None, help="output PLY path")
    r.add_argument("--metrics", default=None, help="write metrics JSON here")
    r.add_argument("--checkpoint", default=None, help="save map checkpoint (npz)")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--octaves", type=int, default=5)
    r.add_argument("--thresh", type=float, default=1.0)
    r.add_argument("--max-pts", type=int, default=1024)
    r.add_argument("--ransac-hyps", type=int, default=1024)
    r.add_argument("--ransac-thresh", type=float, default=3e-6)
    r.add_argument("--ransac-chunk", type=int, default=512,
                   help="hypotheses scored per step")
    r.add_argument("--tvote-rounds", type=int, default=1,
                   help="translation re-vote rounds (0 disables)")
    r.add_argument("--ba-iters", type=int, default=20)

    def _pair(s):
        a, b = s.split(",")
        return (int(a), int(b))

    r.add_argument(
        "--closure", type=_pair, action="append", default=[],
        metavar="I,J",
        help="loop-closure frame pair (repeatable), e.g. --closure 35,0",
    )
    r.add_argument(
        "--mesh", type=int, default=0, metavar="N",
        help="shard matching + global BA over a local N-device mesh "
             "(-1 = all local devices)",
    )
    r.add_argument(
        "--distributed", action="store_true",
        help="multi-host: jax.distributed.initialize from the standard "
             "env (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / "
             "JAX_PROCESS_ID) and shard over ALL global devices",
    )
    r.set_defaults(fn=cmd_reconstruct)

    s = sub.add_parser(
        "sift", help="standalone SIFT extract/match demo (≙ mainSift.cpp)"
    )
    s.add_argument("images", nargs="+", help="1 image = extract only; "
                   "2 = extract + ratio-test match")
    s.add_argument("--octaves", type=int, default=5)
    s.add_argument("--thresh", type=float, default=2.0,
                   help="DoG threshold (reference mainSift.cpp default class)")
    s.add_argument("--max-pts", type=int, default=2048,
                   help="keypoint capacity per octave")
    s.add_argument("--up-scale", action="store_true",
                   help="2x upscale before the pyramid (Lowe's -1 octave)")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--homography", action="store_true",
                   help="fit a RANSAC homography to the matches "
                        "(≙ FindHomography, mainSift.cpp:80)")
    s.add_argument("--homography-thresh", type=float, default=3.0,
                   help="inlier gate in px")
    s.add_argument("--out", default=None,
                   help="write features (x/y/scale/orientation/descriptors "
                        "per image) to this .npz")
    s.add_argument("--metrics", default=None, help="write stats JSON here")
    s.set_defaults(fn=cmd_sift)

    args = p.parse_args(argv)
    if args.platform == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")
    elif args.platform == "gpu":
        from sfm_jax import device

        device.require_gpu()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
