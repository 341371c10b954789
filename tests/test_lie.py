"""Tests for SO(3) exp/log and tangent bases."""

import numpy as np
import jax.numpy as jnp

from sfm_jax.geometry import lie
from helpers import rot


def test_so3_exp_matches_rodrigues(rng):
    w = rng.normal(size=(16, 3)).astype(np.float32)
    R = np.array(lie.so3_exp(jnp.asarray(w)))
    for i in range(16):
        angle = np.linalg.norm(w[i])
        R_ref = rot(w[i] / max(angle, 1e-12), angle)
        np.testing.assert_allclose(R[i], R_ref, atol=1e-5)


def test_so3_exp_small_angle():
    w = jnp.asarray([[1e-9, 0.0, 0.0], [0.0, 0.0, 0.0]], jnp.float32)
    R = np.array(lie.so3_exp(w))
    np.testing.assert_allclose(R, np.eye(3)[None].repeat(2, 0), atol=1e-6)


def test_so3_log_roundtrip(rng):
    w = rng.normal(size=(32, 3)).astype(np.float32)
    # Keep |w| < pi for uniqueness.
    norms = np.linalg.norm(w, axis=-1, keepdims=True)
    w = w / norms * (norms % 3.0)
    R = lie.so3_exp(jnp.asarray(w))
    w_back = np.array(lie.so3_log(R))
    np.testing.assert_allclose(w_back, w, atol=1e-3)


def test_tangent_basis_orthonormal(rng):
    t = rng.normal(size=(20, 3)).astype(np.float32)
    B = np.array(lie.tangent_basis(jnp.asarray(t)))
    tn = t / np.linalg.norm(t, axis=-1, keepdims=True)
    # Columns unit and orthogonal to t and each other
    assert np.abs(np.einsum("bi,bik->bk", tn, B)).max() < 1e-5
    G = np.einsum("bik,bil->bkl", B, B)
    assert np.abs(G - np.eye(2)).max() < 1e-5
