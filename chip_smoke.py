"""Smoke run of the SfM main path on one NVIDIA GPU.

    python chip_smoke.py            # one GPU, every phase below
    python chip_smoke.py --four     # four GPUs: the sharded path only

Phases (one process; the card is never shared with a second one):

1. input        render a seeded synthetic scene (sfm_jax.io.synthetic):
                a pair and a 6-frame orbit at 720x576, with known poses;
2. two-view     `python -m sfm_jax reconstruct a.ppm b.ppm` in-process,
                gated on ground truth; keypoints and descriptors
                compared with the same functions on the CPU backend;
                steady-state time per pair and per stage;
3. incremental  `reconstruct` on the 6 frames; ATE / RPE vs ground
                truth, BA cost non-increasing;
4. BA           run_ba at M=50 / P=50k / O=400k, dense and CG; then a
                gauge-degenerate problem (no camera held fixed), dense
                and CG on the GPU against the same solves on the CPU;
5. kernels      the matcher against a float64 numpy top-2 at 5120^2
                and 16384^2 x 128, both score products; the blur bank
                and DoG against float64 numpy; the detect, sample and
                match stages timed (XLA's compiled code throughout: the
                repository has no hand-written kernel);
6. memory       compiled.memory_analysis() of the two-view programs and
                the device's peak bytes in use.

Any failed gate raises, and the process exits non-zero.  The last line
of standard output is the JSON object
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
Without a GPU the script exits non-zero before any phase runs.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
DATA = ROOT / ".smoke"

# bench.py's configuration (the dino pair's, applied to the synthetic pair).
TWO_VIEW_ARGS = [
    "--max-pts", "1024", "--ransac-hyps", "1536", "--ransac-thresh", "3e-6",
    "--ransac-chunk", "256", "--tvote-rounds", "0",
]


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(f"GATE FAILED: {msg}")
    log(f"  gate ok: {msg}")


def timed(fn, reps: int = 10):
    """Per-call wall times in ms, each call ended by block_until_ready
    (one warm-up call first)."""
    import jax

    jax.block_until_ready(fn())
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def summary(ts):
    return f"median {np.median(ts):.3f} ms, min {np.min(ts):.3f} ms, n={len(ts)}"


def interleaved(fa, fb, reps: int = 10):
    """A/B times taken in turns (a, b, b, a, ...) within one process."""
    import jax

    jax.block_until_ready(fa())
    jax.block_until_ready(fb())
    ta, tb = [], []
    for i in range(reps):
        order = ((fa, ta), (fb, tb)) if i % 2 == 0 else ((fb, tb), (fa, ta))
        for f, acc in order:
            t0 = time.perf_counter()
            jax.block_until_ready(f())
            acc.append((time.perf_counter() - t0) * 1e3)
    return ta, tb


def rot_err_deg(Ra, Rb):
    c = (np.trace(np.asarray(Ra) @ np.asarray(Rb).T) - 1.0) / 2.0
    return float(np.rad2deg(np.arccos(np.clip(c, -1.0, 1.0))))


def nvidia_smi_line() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


# ---------------------------------------------------------------- 1
def phase_input(width=None, height=None, n_seq=6):
    from sfm_jax.io import synthetic as syn

    width = width or syn.WIDTH
    height = height or syn.HEIGHT
    t0 = time.perf_counter()
    pair_poses = syn.two_view_poses()
    seq_poses = syn.orbit_poses(n_seq)
    pair = syn.write_sequence(DATA / "pair", pair_poses, width=width,
                              height=height, focal=syn.FOCAL * width / syn.WIDTH)
    seq = syn.write_sequence(DATA / "orbit", seq_poses, width=width,
                             height=height, focal=syn.FOCAL * width / syn.WIDTH)
    log(f"[1 input] {width}x{height}: pair + {n_seq}-frame orbit rendered "
        f"in {time.perf_counter() - t0:.1f} s")
    focal = syn.FOCAL * width / syn.WIDTH
    return {
        "pair": pair, "seq": seq, "focal": focal,
        "K": syn.intrinsics(width, height, focal),
        "pair_gt": syn.relative_pose(*pair_poses),
        "seq_gt": (np.stack([p[0] for p in seq_poses]),
                   np.stack([p[1] for p in seq_poses])),
    }


def _cli(platform, paths, focal, extra, name):
    from sfm_jax import cli

    met = DATA / f"{name}.json"
    t0 = time.perf_counter()
    rc = cli.main(["--platform", platform, "reconstruct", *paths,
                   "--focal", str(focal), *extra,
                   "--out", str(DATA / f"{name}.ply"),
                   "--metrics", str(met)])
    wall = time.perf_counter() - t0
    check(rc == 0, f"reconstruct ({name}) exit code 0")
    return json.loads(met.read_text()), wall


# ---------------------------------------------------------------- 2
def phase_two_view(inp, platform="gpu", reps=10, full=True):
    import jax
    import jax.numpy as jnp

    from sfm_jax.config import PipelineConfig, RansacConfig, SiftConfig
    from sfm_jax.io.image_io import load_gray
    from sfm_jax.models import two_view
    from sfm_jax.sift import frontend

    m, wall = _cli(platform, inp["pair"], inp["focal"], TWO_VIEW_ARGS,
                   "two_view")
    R_gt, t_gt = inp["pair_gt"]
    R = np.asarray(m["R"])
    t = np.asarray(m["t"])
    r_err = rot_err_deg(R, R_gt)
    t_err = float(np.rad2deg(np.arccos(np.clip(
        t @ t_gt / np.linalg.norm(t), -1.0, 1.0))))
    log(f"[2 two-view] first call (compile + run) {wall:.1f} s; "
        f"matches={m['num_matches']} inliers={m['num_inliers']} "
        f"valid={m['num_points']} reproj_px={m['mean_reproj_px']} "
        f"rot_err={r_err:.4f} deg t_err={t_err:.4f} deg")
    check(np.isfinite(R).all() and np.isfinite(t).all()
          and math.isfinite(m["mean_reproj_px"]), "outputs finite")
    check(r_err <= 0.2, f"rotation error {r_err:.4f} <= 0.2 deg")
    check(t_err <= 1.0, f"translation direction error {t_err:.4f} <= 1 deg")
    check(m["num_matches"] >= 1500, f"matches {m['num_matches']} >= 1500")
    check(m["num_inliers"] >= 1300, f"inliers {m['num_inliers']} >= 1300")
    check(m["num_points"] >= 1300, f"valid points {m['num_points']} >= 1300")
    check(m["mean_reproj_px"] <= 0.35,
          f"reprojection {m['mean_reproj_px']} <= 0.35 px")

    img1 = jnp.asarray(load_gray(inp["pair"][0]))
    img2 = jnp.asarray(load_gray(inp["pair"][1]))
    K = jnp.asarray(inp["K"])
    cfg = PipelineConfig(
        sift=SiftConfig(max_pts_per_octave=1024),
        ransac=RansacConfig(n_hyps=1536, threshold=3e-6, chunk=256),
        tvote_rounds=0,
    )
    key = jax.random.PRNGKey(0)
    out = {"two_view": m}

    # Same extraction on the CPU backend, in this process.
    cpu = jax.devices("cpu")[0]
    s_dev = frontend.extract_sift(img1, cfg.sift)
    with jax.default_device(cpu):
        s_cpu = frontend.extract_sift(jax.device_put(img1, cpu), cfg.sift)
    _compare_features(s_dev, s_cpu)

    if not full:
        return out

    ts = timed(lambda: two_view.two_view_pipeline(img1, img2, K, key, cfg),
               reps)
    log(f"[2 two-view] steady state per pair: {summary(ts)}")
    out["pair_ms"] = float(np.median(ts))
    uv1, uv2, mask = two_view.frontend_stage(img1, img2, cfg)
    tf = timed(lambda: two_view.frontend_stage(img1, img2, cfg), reps)
    tg = timed(lambda: two_view.two_view_geometry(key, uv1, uv2, mask, K,
                                                  cfg), reps)
    log(f"[2 two-view] frontend (SIFT x2 + match) {summary(tf)}; "
        f"geometry (RANSAC + pose + refine + triangulate) {summary(tg)}")
    out["frontend_ms"] = float(np.median(tf))
    out["geometry_ms"] = float(np.median(tg))
    return out


def _compare_features(a, b):
    """Device vs CPU extraction: counts, positional twins, descriptors."""
    def fields(s):
        v = np.asarray(s.keypoints.valid)
        k = s.keypoints
        return (np.stack([np.asarray(k.x)[v], np.asarray(k.y)[v],
                          np.asarray(k.scale)[v],
                          np.asarray(k.orientation)[v]], 1),
                np.asarray(s.descriptors)[v])

    ka, da = fields(a)
    kb, db = fields(b)
    na, nb = len(ka), len(kb)
    # Twin = same position/scale within 0.01 px and the nearest
    # orientation (dual-peak slots may swap between the two runs).
    twins, corr = 0, []
    by_pos = {}
    for j in range(nb):
        by_pos.setdefault(tuple(np.round(kb[j, :3], 2)), []).append(j)
    for i in range(na):
        js = by_pos.get(tuple(np.round(ka[i, :3], 2)), [])
        if not js:
            continue
        dd = np.abs((ka[i, 3] - kb[js, 3] + 180.0) % 360.0 - 180.0)
        j = js[int(dd.argmin())]
        twins += 1
        corr.append(float(da[i] @ db[j]))
    corr = np.asarray(corr)
    cover = twins / max(na, 1)
    good = float((corr > 0.99).mean()) if len(corr) else 0.0
    log(f"[2 two-view] device vs CPU extraction: keypoints {na} vs {nb}, "
        f"positional twins {cover:.4f}, descriptor dot > 0.99 for {good:.4f}"
        f" (min {corr.min() if len(corr) else float('nan'):.5f})")
    check(abs(na - nb) <= 0.02 * max(nb, 1),
          f"keypoint count {na} within 2% of the CPU's {nb}")
    check(cover >= 0.97, f"positional twins {cover:.4f} >= 0.97")
    check(good >= 0.97, f"descriptor agreement {good:.4f} >= 0.97")


# ---------------------------------------------------------------- 3
def phase_incremental(inp, platform="gpu", ate_max=0.02, rpe_t_max=1.0,
                      rpe_r_max=0.2):
    from sfm_jax.utils import metrics

    m, wall = _cli(platform, inp["seq"], inp["focal"],
                   TWO_VIEW_ARGS + ["--ba-iters", "20"], "incremental")
    R = np.asarray(m["R"])
    t = np.asarray(m["t"])
    R_gt, t_gt = inp["seq_gt"]
    ate, _ = metrics.ate_rmse(R, t, R_gt, t_gt)
    rpe_r, rpe_t = metrics.rpe_rmse(R, t, R_gt, t_gt)
    costs = np.asarray(m["ba_costs"])
    log(f"[3 incremental] {len(inp['seq'])} frames in {wall:.1f} s "
        f"(compile included): registered={m['poses_registered']} "
        f"points={m['num_points']} reproj_px={m['mean_reproj_px']} "
        f"ATE={float(ate):.5f} RPE_t={rpe_t:.4f} deg "
        f"RPE_r={rpe_r:.4f} deg BA cost {costs[0]:.4e} -> "
        f"{costs[-1]:.4e}")
    check(m["poses_registered"] == len(inp["seq"]), "all frames registered")
    check(np.isfinite(R).all() and np.isfinite(t).all()
          and np.isfinite(costs).all(), "poses and costs finite")
    check(float(ate) <= ate_max, f"ATE {float(ate):.5f} <= {ate_max}")
    check(rpe_t <= rpe_t_max, f"RPE_t {rpe_t:.4f} <= {rpe_t_max} deg")
    check(rpe_r <= rpe_r_max, f"RPE_r {rpe_r:.4f} <= {rpe_r_max} deg")
    check(bool(np.all(np.diff(costs) <= 1e-7 * max(costs[0], 1.0))),
          "BA cost non-increasing")
    return {"incremental": m, "ate": float(ate), "rpe_t_deg": rpe_t,
            "rpe_r_deg": rpe_r, "wall_s": wall}


# ---------------------------------------------------------------- 4
def phase_ba(M=50, P=50_000, obs=8_000, iters=15, gauge_cams=12,
             gauge_pts=3000):
    import jax
    import jax.numpy as jnp

    from sfm_jax.io import synthetic as syn
    from sfm_jax.models import bundle_adjust as ba

    out = {}
    prob, R0, t0, X0, _, _ = syn.ring_ba_problem(M, P, obs)
    args = (jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(X0), prob)
    for solver in ("dense", "cg"):
        t_c = time.perf_counter()
        _, costs = ba.run_ba(*args, iters=iters, solver=solver)
        jax.block_until_ready(costs)
        first = time.perf_counter() - t_c
        ts = timed(lambda: ba.run_ba(*args, iters=iters, solver=solver), 3)
        c = np.asarray(costs)
        log(f"[4 BA] M={M} P={P} O={M * obs} {solver}: first call "
            f"{first:.1f} s; {iters} LM iters {summary(ts)} "
            f"({np.median(ts) / iters:.2f} ms/iter); cost {c[0]:.6e} -> "
            f"{c[-1]:.6e}")
        check(np.isfinite(c).all() and c[-1] < c[0],
              f"{solver} BA cost finite and decreasing")
        out[f"ba_{solver}"] = {"cost0": float(c[0]), "cost": float(c[-1]),
                               "ms": float(np.median(ts))}
    d, g = out["ba_dense"]["cost"], out["ba_cg"]["cost"]
    check(abs(d - g) <= 0.01 * d, f"dense {d:.6e} and CG {g:.6e} within 1%")

    # Gauge-degenerate problem: no camera held fixed, as in the
    # turntable's free BA stage; the gauge is held by LM damping alone.
    scene = syn.make_scene(0)
    gp = syn.ba_problem(syn.orbit_poses(gauge_cams, step_deg=6.0),
                        syn.scene_points(scene, gauge_pts), syn.intrinsics(),
                        fix_first=False)
    prob, R0, t0, X0 = gp[:4]
    cpu = jax.devices("cpu")[0]
    res = {}
    for where, dev in (("device", None), ("cpu", cpu)):
        for solver in ("dense", "cg"):
            a = (R0, t0, X0, prob)
            if dev is not None:
                a = jax.device_put(a, dev)
                with jax.default_device(dev):
                    fin, c = ba.run_ba(*a, iters=30, solver=solver)
            else:
                fin, c = ba.run_ba(*map(jnp.asarray, a[:3]), prob, iters=30,
                                   solver=solver)
            res[(where, solver)] = (float(np.asarray(c)[-1]),
                                    np.asarray(fin.R), np.asarray(fin.t))
    ref = res[("cpu", "dense")][0]
    for k, (c, R, t) in res.items():
        dR = max(rot_err_deg(R[i], res[("cpu", "dense")][1][i])
                 for i in range(len(R)))
        log(f"[4 BA] gauge-degenerate M={gauge_cams} {k[0]:6s} {k[1]:5s}: "
            f"final cost {c:.6e} ({(c - ref) / ref:+.2e} vs CPU dense), "
            f"max rotation diff vs CPU dense {dR:.4f} deg")
        check(np.isfinite(c) and abs(c - ref) <= 0.01 * ref,
              f"{k} final cost within 1% of CPU dense")
    out["gauge"] = {f"{a}_{b}": v[0] for (a, b), v in res.items()}
    return out


# ---------------------------------------------------------------- 5
def _planted_descriptors(n1, n2, rng):
    """Unit descriptors where most left rows have one clear partner."""
    d1 = rng.normal(size=(n1, 128))
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 = rng.normal(size=(n2, 128))
    k = min(n1, n2) * 3 // 4
    d2[:k] = d1[:k] + 0.6 * rng.normal(size=(k, 128)) / math.sqrt(128)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    perm = rng.permutation(n2)
    return d1.astype(np.float32), d2[perm].astype(np.float32)


def numpy_top2(d1, d2, valid2, block=2048):
    """float64 reference top-2 (best, second, index), ties -> lowest."""
    best = np.empty(len(d1))
    second = np.empty(len(d1))
    idx = np.empty(len(d1), np.int64)
    b2 = d2.astype(np.float64)
    for s in range(0, len(d1), block):
        S = d1[s:s + block].astype(np.float64) @ b2.T
        S[:, ~valid2] = -2.0
        i = S.argmax(1)
        rows = np.arange(len(S))
        best[s:s + block] = S[rows, i]
        S[rows, i] = -2.0
        second[s:s + block] = S.max(1)
        idx[s:s + block] = i
    return best, second, idx


def phase_kernels(sizes=(5120, 16384), reps=10, img_path=None,
                  platform="gpu"):
    import jax
    import jax.numpy as jnp

    from sfm_jax.config import SiftConfig
    from sfm_jax.io.image_io import load_gray
    from sfm_jax.ops import image as imops
    from sfm_jax.sift import frontend, match as match_mod, pyramid

    out = {}
    rng = np.random.default_rng(0)
    for n in sizes:
        d1, d2 = _planted_descriptors(n, n, rng)
        v2 = np.ones(n, bool)
        v2[rng.integers(0, n, n // 50)] = False
        rb, rs, ri = numpy_top2(d1, d2, v2)
        margin = rb - rs
        D1, D2, V2 = jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v2)
        for bf16, tol in ((True, 1e-2), (False, 1e-5)):
            tag = "bf16" if bf16 else "f32"
            f = lambda: match_mod.match_descriptors_top2(D1, D2, V2,
                                                         bf16=bf16)
            b, s, i = (np.asarray(a) for a in f())
            err = max(np.abs(b - rb).max(), np.abs(s - rs).max())
            clear = margin > tol
            agree = float((i[clear] == ri[clear]).mean())
            log(f"[5 kernels] matcher {tag} {n}x{n}x128: max score error "
                f"{err:.2e} (tol {tol:g}); index agreement {agree:.6f} on "
                f"{int(clear.sum())} rows with margin > {tol:g}")
            check(err <= tol, f"{tag} {n}^2 score error <= {tol:g}")
            check(agree == 1.0, f"{tag} {n}^2 indices agree")
            if platform == "gpu":
                ts = timed(f, reps)
                log(f"[5 kernels] matcher {tag} {n}^2 (XLA scan) "
                    f"{summary(ts)}")
                out[f"match_{tag}_{n}_ms"] = float(np.median(ts))

    # Blur bank + DoG of octave 0 against float64 numpy.
    img = np.asarray(load_gray(img_path), np.float64)
    cfg = SiftConfig(max_pts_per_octave=1024)
    lp = imops.gaussian_kernel(cfg.lowpass_radius, cfg.init_blur ** 2)
    bank = pyramid.octave_kernel_bank(cfg, 0)

    def np_blur(x, taps):
        r = len(taps) // 2
        p = np.pad(x, r, mode="edge")
        tmp = sum(t * p[:, j:j + x.shape[1]] for j, t in enumerate(taps))
        return sum(t * tmp[j:j + x.shape[0]] for j, t in enumerate(taps))

    base = np_blur(img, lp.astype(np.float64))
    blurs = np.stack([np_blur(base, b.astype(np.float64)) for b in bank])
    dog_ref = blurs[1:] - blurs[:-1]
    for prec in ("HIGHEST", "HIGH"):
        saved = imops.BLUR_PRECISION
        imops.BLUR_PRECISION = getattr(jax.lax.Precision, prec)
        try:
            f = jax.jit(lambda x: pyramid.build_pyramid(x, cfg)[0].dog)
            dog = np.asarray(f(jnp.asarray(img, jnp.float32)))
        finally:
            imops.BLUR_PRECISION = saved
        err = float(np.abs(dog - dog_ref).max())
        log(f"[5 kernels] octave-0 DoG at Precision.{prec} vs float64: "
            f"max abs error {err:.3e} (DoG threshold {cfg.thresh})")
        if prec == "HIGHEST":
            check(err <= 1e-3, f"DoG error {err:.3e} <= 1e-3 at HIGHEST")
        out[f"dog_err_{prec}"] = err

    if platform != "gpu":
        return out
    # Detect stage (grouped-conv pyramid + NMS) and sample stage.
    x = jnp.asarray(img, jnp.float32)
    tc = timed(lambda: frontend._detect_stage(x, cfg), reps)
    log(f"[5 kernels] detect stage 720x576 (grouped conv) {summary(tc)}")
    out["detect_ms"] = float(np.median(tc))
    offsets, subs = frontend.atlas_layout(x.shape, cfg)
    atlas, dets = frontend._detect_stage(x, cfg)
    ts = timed(lambda: frontend._sample_stage(atlas, offsets, subs, dets,
                                              cfg), reps)
    log(f"[5 kernels] sample stage (orientation + descriptors, XLA "
        f"gathers) {summary(ts)}")
    out["sample_ms"] = float(np.median(ts))
    return out


# ---------------------------------------------------------------- 6
def phase_memory(inp):
    import jax
    import jax.numpy as jnp

    from sfm_jax.config import PipelineConfig, RansacConfig, SiftConfig
    from sfm_jax.io.image_io import load_gray
    from sfm_jax.models import two_view
    from sfm_jax.sift import frontend

    cfg = PipelineConfig(
        sift=SiftConfig(max_pts_per_octave=1024),
        ransac=RansacConfig(n_hyps=1536, threshold=3e-6, chunk=256),
        tvote_rounds=0,
    )
    img = jnp.asarray(load_gray(inp["pair"][0]))
    offsets, subs = frontend.atlas_layout(img.shape, cfg.sift)
    atlas, dets = frontend._detect_stage(img, cfg.sift)
    s = frontend._sample_stage(atlas, offsets, subs, dets, cfg.sift)
    uv1, uv2, mask = two_view._match_stage(s, s, cfg)
    progs = {
        "detect": frontend._detect_stage.lower(img, cfg.sift),
        "sample": frontend._sample_stage.lower(atlas, offsets, subs, dets,
                                               cfg.sift),
        "match": two_view._match_stage.lower(s, s, cfg),
        "geometry": two_view.two_view_geometry.lower(
            jax.random.PRNGKey(0), uv1, uv2, mask, jnp.asarray(inp["K"]),
            cfg),
    }
    out = {}
    for name, low in progs.items():
        ma = low.compile().memory_analysis()
        fields = {k: int(getattr(ma, k)) for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
            if hasattr(ma, k)}
        log(f"[6 memory] {name}: {fields}")
        out[name] = fields
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    log(f"[6 memory] device peak_bytes_in_use {peak} "
        f"({(peak or 0) / 2**20:.1f} MiB)")
    out["peak_bytes_in_use"] = peak
    return out


# ---------------------------------------------------------------- 7
def phase_four(inp, n_dev=4, n_match=16384, platform="gpu", ate_max=0.02):
    """The sharded path on an n_dev mesh, and what it is compared with."""
    import jax
    import jax.numpy as jnp

    from sfm_jax.models import bundle_adjust as ba
    from sfm_jax.io import synthetic as syn
    from sfm_jax.parallel import dist_ba, dist_match, mesh as meshmod
    from sfm_jax.sift import match as match_mod
    from sfm_jax.utils import metrics

    devs = jax.devices()
    check(len(devs) >= n_dev, f"{len(devs)} devices >= {n_dev}")
    mesh = meshmod.make_mesh(n_dev)

    # Incremental with the mesh-sharded matcher and distributed BA.
    m, wall = _cli(platform, inp["seq"], inp["focal"],
                   TWO_VIEW_ARGS + ["--ba-iters", "20", "--mesh", str(n_dev)],
                   "incremental_mesh")
    R_gt, t_gt = inp["seq_gt"]
    ate, _ = metrics.ate_rmse(np.asarray(m["R"]), np.asarray(m["t"]),
                              R_gt, t_gt)
    costs = np.asarray(m["ba_costs"])
    log(f"[7 four] incremental --mesh {n_dev}: {wall:.1f} s, registered="
        f"{m['poses_registered']} ATE={float(ate):.5f} BA cost "
        f"{costs[0]:.4e} -> {costs[-1]:.4e}")
    check(m["poses_registered"] == len(inp["seq"]), "all frames registered")
    check(float(ate) <= ate_max, f"ATE {float(ate):.5f} <= {ate_max}")
    check(bool(np.all(np.diff(costs) <= 1e-7 * max(costs[0], 1.0))),
          "BA cost non-increasing")

    # dist_match against the single-card matcher.
    rng = np.random.default_rng(1)
    d1, d2 = _planted_descriptors(n_match, n_match, rng)
    D1 = jnp.asarray(d1)
    D2 = jax.device_put(jnp.asarray(d2), meshmod.sharded_leading(mesh))
    V2 = jax.device_put(jnp.ones((n_match,), bool),
                        meshmod.sharded_leading(mesh))
    shards = {s.device for s in D2.addressable_shards}
    check(len(shards) == n_dev, f"descriptors sharded over {len(shards)} "
          f"devices")
    fd = lambda: dist_match.dist_match_top2(D1, D2, V2, mesh, bf16=True)
    D2_one = jnp.asarray(d2)
    fl = lambda: match_mod.match_descriptors_top2(D1, D2_one, bf16=True)
    bd, sd, idd = (np.asarray(a) for a in fd())
    bl, sl, il = (np.asarray(a) for a in fl())
    same = float((idd == il).mean())
    log(f"[7 four] dist_match {n_match}^2 on {n_dev} devices vs one: index "
        f"agreement {same:.6f}, max score diff "
        f"{max(np.abs(bd - bl).max(), np.abs(sd - sl).max()):.2e}")
    check(same == 1.0, "dist_match indices equal the single-card matcher's")
    td, tl = interleaved(fd, fl, 10)
    log(f"[7 four] dist_match {summary(td)}; single card {summary(tl)}")

    # run_dist_ba against run_ba.
    prob, R0, t0, X0, _, _ = syn.ring_ba_problem(16, 256 * n_dev * 8, 4096)
    fin, c_s = ba.run_ba(jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(X0),
                         prob, iters=15, solver="cg")
    X_sh, prob_sh = dist_ba.partition_problem(prob, X0, n_dev)
    R_d, t_d, X_d, c_d = dist_ba.run_dist_ba(
        jnp.asarray(R0), jnp.asarray(t0), X_sh, prob_sh, mesh, iters=15,
        solver="cg")
    cs, cd = float(np.asarray(c_s)[-1]), float(np.asarray(c_d)[-1])
    x_devs = {s.device for s in X_d.addressable_shards}
    # The cost it reports must be the cost of the poses (device 0's
    # copy) and points (every shard) it returns: replicas that drifted
    # apart inside the mesh program would break this.
    R1, t1, X1 = meshmod.gather_to_one((R_d, t_d, X_d), mesh)
    with jax.default_matmul_precision("float32"):
        c_back = float(ba.robust_cost(
            R1, t1, dist_ba.unpartition_points(X1, X0.shape[0]),
            jax.device_put(prob, X1.sharding), 3e-3))
    log(f"[7 four] run_dist_ba on {len(x_devs)} devices: cost {cd:.6e} "
        f"(recomputed from its outputs {c_back:.6e}); run_ba: {cs:.6e} "
        f"(rel diff {(cd - cs) / cs:+.2e})")
    check(len(x_devs) == n_dev, "BA points sharded over every device")
    check(abs(c_back - cd) <= 1e-4 * cd,
          "dist BA's reported cost is that of its returned poses and points")
    check(abs(cd - cs) <= 0.01 * cs, "dist BA final cost within 1% of run_ba")
    for d in devs[:n_dev]:
        st = d.memory_stats() or {}
        log(f"[7 four] {d}: peak_bytes_in_use {st.get('peak_bytes_in_use')}")
        if platform == "gpu":
            check((st.get("peak_bytes_in_use") or 0) > 0, f"{d} did work")
    return {"ate": float(ate), "dist_ba_cost": cd, "ba_cost": cs}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the sharded path on a 4-GPU mesh")
    args = p.parse_args(argv)

    log(nvidia_smi_line())
    import jax

    try:
        devs = jax.devices()
    except RuntimeError as e:
        sys.exit(f"chip_smoke: JAX found no accelerator ({e})")
    from sfm_jax import device

    if device.platform() != "gpu":
        sys.exit(f"chip_smoke: JAX found no GPU (platform "
                 f"{devs[0].platform!r}); this smoke run needs one")
    log(f"devices: {devs}; compile cache {device.enable_compile_cache()}")
    t0 = time.perf_counter()
    inp = phase_input()
    results = {}
    if args.four:
        results["four"] = phase_four(inp)
        count = 4
    else:
        results.update(phase_two_view(inp))
        results.update(phase_incremental(inp))
        results.update(phase_ba())
        results.update(phase_kernels(img_path=inp["pair"][0]))
        results["memory"] = phase_memory(inp)
        count = len(devs)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    (DATA / "results.json").write_text(json.dumps(results, indent=1,
                                                  default=str))
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": count}}))


if __name__ == "__main__":
    main()
