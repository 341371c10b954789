"""Bundle-adjustment benchmark: LM with a Schur solve at production scale.

A ring of M cameras observing P points (O observations) from
sfm_jax.io.synthetic.ring_ba_problem, perturbed, solved by run_ba.
Each timed call ends with block_until_ready.

Usage: python tools/bench_ba.py [M] [P] [obs_per_cam] [--solver=cg|dense]
                                [--cpu]
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    argv = [a for a in sys.argv[1:] if not a.startswith("--")]
    solver = "cg"
    for a in sys.argv[1:]:
        if a.startswith("--solver="):
            solver = a.split("=", 1)[1]
    if "--cpu" in sys.argv:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp

    from sfm_jax import device
    from sfm_jax.io import synthetic as syn
    from sfm_jax.models import bundle_adjust as ba

    device.enable_compile_cache()
    M = int(argv[0]) if len(argv) > 0 else 50
    P = int(argv[1]) if len(argv) > 1 else 50_000
    obs_per_cam = int(argv[2]) if len(argv) > 2 else 8_000
    prob, R0, t0, X0, _, _ = syn.ring_ba_problem(M, P, obs_per_cam)
    args = (jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(X0), prob)

    iters, cg_iters = 15, 32
    t_c = time.time()
    st, costs = ba.run_ba(*args, iters=iters, solver=solver, cg_iters=cg_iters)
    c_final = float(costs[-1])
    print(f"compile+first: {time.time()-t_c:.1f}s", flush=True)

    ts = []
    for _ in range(3):
        tt = time.time()
        jax.block_until_ready(
            ba.run_ba(*args, iters=iters, solver=solver, cg_iters=cg_iters))
        ts.append((time.time() - tt) * 1000.0)
    best = float(np.median(ts))
    print(
        f"BA M={M} P={P} O={M * obs_per_cam} {solver}: median {best:.1f} ms "
        f"for {iters} LM iters (cg {cg_iters}) = {best/iters:.1f} ms/iter; "
        f"cost {float(costs[0]):.3e} -> {c_final:.3e} "
        f"[{jax.devices()[0].platform} {jax.devices()[0].device_kind}]",
        flush=True,
    )


if __name__ == "__main__":
    main()
