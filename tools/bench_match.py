"""Brute-force matcher micro-benchmark on the GPU.

Counterpart of the reference's benchmark CudaSift/match.cu (16384 x
16384 128-D descriptor matching).  Times the running top-2 matcher
(sift.match.match_descriptors_top2, an XLA scan over N2 chunks) at each
N given, for both score products and a few chunk sizes.  Variants run
in turns in one process; each call ends with block_until_ready.

Usage: python tools/bench_match.py [N ...]      (default: 5120 16384)
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from sfm_jax import device
    from sfm_jax.sift.match import match_descriptors_top2

    device.require_gpu()
    device.enable_compile_cache()
    sizes = [int(a) for a in sys.argv[1:]] or [5120, 16384]
    rng = np.random.default_rng(0)
    for n in sizes:
        d1 = rng.normal(size=(n, 128)).astype(np.float32)
        d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
        d2 = rng.normal(size=(n, 128)).astype(np.float32)
        d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
        a, b = jnp.asarray(d1), jnp.asarray(d2)
        variants = {
            f"{'bf16' if bf16 else 'f32'} chunk={chunk}":
                (lambda bf16=bf16, chunk=chunk: match_descriptors_top2(
                    a, b, chunk=chunk, bf16=bf16))
            for bf16 in (True, False) for chunk in (1024, 2048, 4096)
        }
        for f in variants.values():
            jax.block_until_ready(f())
        times = {k: [] for k in variants}
        for _ in range(10):
            for k, f in variants.items():
                t0 = time.perf_counter()
                jax.block_until_ready(f())
                times[k].append((time.perf_counter() - t0) * 1e3)
        flops = 2.0 * n * n * 128
        for k, ts in times.items():
            med = float(np.median(ts))
            print(f"{n}x{n}x128 {k}: median {med:.4f} ms, min "
                  f"{min(ts):.4f} ms ({flops / med / 1e9:.1f} TFLOP/s) "
                  f"[{jax.devices()[0].device_kind}]", flush=True)


if __name__ == "__main__":
    main()
