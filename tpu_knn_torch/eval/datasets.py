"""Synthetic benchmark datasets (counterpart of tpu_knn/eval/datasets.py).

Real ANN benchmark sets (SIFT-1M, GloVe-1.2M) can't be fetched in a
sealed environment, so benchmarks use clustered synthetic data with a
realistic *intrinsic* dimensionality instead: uniform random 128-d data
is near-equidistant (intrinsic dim == d, the provable worst case for
any ANN index), while real descriptor data has intrinsic dim ~10-20.

``sift_like`` mimics SIFT's statistics: a GMM with a few thousand
centers on a low-dimensional latent manifold, non-negative, scaled to
the u8 range. Pure numpy: the same seed gives the same bits as tpu_knn.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from ..utils.rng import np_rng

#: On-disk cache for generated sets: host RNG throughput dominates on
#: small hosts. Defaults to the checkout's ``.datacache/`` (git-ignored);
#: ``TPU_KNN_DATA_CACHE`` overrides it.
_CACHE_DIR = os.environ.get(
    "TPU_KNN_DATA_CACHE", str(Path(__file__).resolve().parents[2] / ".datacache")
)


def _cached(key: str, maker):
    path = os.path.join(_CACHE_DIR, key + ".npy")
    try:
        return np.load(path)
    except OSError:
        pass
    x = maker()
    try:
        os.makedirs(_CACHE_DIR, exist_ok=True)
        tmp = os.path.join(_CACHE_DIR, f".{key}.{os.getpid()}.tmp.npy")
        np.save(tmp, x)
        os.replace(tmp, path)
    except OSError:
        pass
    return x


def clustered(
    n: int,
    d: int,
    n_clusters: int = 1000,
    latent_dim: int = 16,
    noise: float = 0.15,
    seed: int = 0,
    dtype=np.float32,
) -> np.ndarray:
    """GMM on a ``latent_dim``-dimensional manifold embedded in R^d."""
    rng = np_rng(seed)
    f32 = np.float32
    basis = rng.standard_normal((latent_dim, d), dtype=f32) / np.sqrt(latent_dim)
    centers_lat = rng.standard_normal((n_clusters, latent_dim), dtype=f32)
    assign = rng.integers(0, n_clusters, size=n)
    lat = centers_lat[assign] + noise * rng.standard_normal((n, latent_dim), dtype=f32)
    x = lat @ basis + (noise * 0.5) * rng.standard_normal((n, d), dtype=f32)
    return x.astype(dtype, copy=False)


def sift_like(n: int, d: int = 128, seed: int = 0) -> np.ndarray:
    """Non-negative clustered f32 vectors scaled to the u8 value range,
    mimicking SIFT descriptor statistics (sparse-ish, clustered)."""

    def make():
        x = clustered(n, d, n_clusters=max(n // 500, 64), latent_dim=16, seed=seed)
        x = np.maximum(x - np.percentile(x, 30), 0.0)
        mx = np.percentile(x, 99.9)
        return np.clip(x * (255.0 / max(mx, 1e-6)), 0, 255).astype(np.float32)

    return _cached(f"sift_like_{n}x{d}_s{seed}", make)
