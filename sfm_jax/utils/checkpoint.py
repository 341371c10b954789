"""Map/pose checkpointing.

NO reference counterpart (survey §5: the reference persists nothing).
Needed for long multi-view runs and multi-host BA restart: the full
reconstruction state (poses, points, track tables) serializes to one
npz; restore rebuilds device arrays.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np


def save_map(path, state, extra: dict | None = None):
    """Persist an incremental.MapState (or any NamedTuple of arrays)."""
    arrays = {f"f_{name}": np.asarray(v) for name, v in state._asdict().items()}
    meta = {"fields": list(state._asdict().keys()), "type": type(state).__name__}
    if extra:
        meta["extra"] = extra
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8
    )
    np.savez_compressed(path, **arrays)


def load_map(path, cls=None):
    """Load a checkpoint; returns (state_or_dict, extra_meta)."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(data["__meta__"]).decode())
    fields = {name: data[f"f_{name}"] for name in meta["fields"]}
    extra = meta.get("extra")
    if cls is None:
        from sfm_jax.models.incremental import MapState

        cls = MapState if meta.get("type") == "MapState" else None
    if cls is not None and meta.get("type") == cls.__name__:
        import jax.numpy as jnp

        return cls(**{k: jnp.asarray(v) for k, v in fields.items()}), extra
    return fields, extra
