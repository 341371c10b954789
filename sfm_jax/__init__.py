"""sfm_jax — a JAX Structure-from-Motion framework for NVIDIA GPUs.

A ground-up JAX re-design of the capabilities of
Black-Phoenix/CUDA-SfM (SIFT extraction, brute-force matching, 8-point
RANSAC essential estimation, pose recovery, DLT triangulation), extended
with bundle adjustment, incremental multi-view SfM, and multi-chip
sharding the reference lacks.
"""

__version__ = "0.1.0"
