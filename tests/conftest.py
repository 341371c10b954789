"""Test configuration: run everything on a virtual 8-device CPU mesh.

Tests run on the CPU (fast compiles, 8 virtual devices for the
sharding tests), so the env is set *and* jax.config is overridden,
which wins over a GPU plugin that would otherwise become the default.
The program has no GPU-only code path today (no hand-written kernel);
the card itself is exercised by `python chip_smoke.py`.  A test that
needs the card gets a registered marker and decides inside the test,
never at import, whether a GPU is present.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def _n_maps() -> int:
    try:
        with open("/proc/self/maps") as f:
            return sum(1 for _ in f)
    except OSError:  # non-Linux: no map-count limit to worry about
        return 0


@pytest.fixture(autouse=True)
def _jit_cache_pressure_relief():
    """Keep the process under vm.max_map_count (65530 default).

    Every XLA:CPU compile leaves hundreds of anonymous mappings that
    are only released when the executable is dropped; the full suite
    accumulates ~65k maps and then SEGFAULTS inside a later compile
    when mmap starts failing (measured r2: maps hit exactly 65530 at
    the crash).  jax.clear_caches() releases them (2067 -> 702 in a
    micro-test), so clear once we cross half the limit.
    """
    yield
    if _n_maps() > 32000:
        import gc

        jax.clear_caches()
        gc.collect()


@pytest.fixture()
def rng(request):
    # Deterministic PER-TEST stream: the old session-scoped generator
    # made every test's draws depend on which tests ran before it
    # (order/selection-dependent failures).
    seed = int.from_bytes(request.node.name.encode(), "little") % (2**31)
    return np.random.default_rng(seed)
