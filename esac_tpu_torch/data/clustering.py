"""Expert clustering: partition a large scene into expert regions
(counterpart of ``esac_tpu/data/clustering.py``).

The Aachen setup's k-means over ground-truth camera positions, whose ~50
clusters define the experts: the assignment gives the gating net's expert
labels and each expert's ``scene_center``.  Deterministic k-means++ in
numpy, run once at dataset-setup time (the port keeps its own copy of the
JAX package's numpy code, so the labels and centers are the same).
"""

from __future__ import annotations

import numpy as np


def kmeans_cluster_cameras(
    positions: np.ndarray,
    n_clusters: int,
    seed: int = 0,
    iters: int = 100,
) -> tuple[np.ndarray, np.ndarray]:
    """k-means over camera positions (N, 3).

    Returns (labels (N,) int64, centers (n_clusters, 3) float32).  k-means++
    init for stability; an empty cluster is re-seeded at the point farthest
    from its center.
    """
    positions = np.asarray(positions, dtype=np.float64)
    n = positions.shape[0]
    if n_clusters > n:
        raise ValueError(f"{n_clusters} clusters for {n} cameras")
    rng = np.random.default_rng(seed)

    # k-means++ seeding.
    centers = [positions[rng.integers(n)]]
    for _ in range(1, n_clusters):
        d2 = np.min(((positions[:, None] - np.stack(centers)[None]) ** 2).sum(-1), axis=1)
        prob = d2 / (d2.sum() + 1e-12)
        centers.append(positions[rng.choice(n, p=prob)])
    centers = np.stack(centers)

    labels = np.zeros(n, dtype=np.int64)
    for it in range(iters):
        d2 = ((positions[:, None] - centers[None]) ** 2).sum(-1)
        new_labels = d2.argmin(axis=1)
        if np.array_equal(new_labels, labels) and it > 0:
            break
        labels = new_labels
        for k in range(n_clusters):
            mask = labels == k
            if mask.any():
                centers[k] = positions[mask].mean(axis=0)
            else:
                centers[k] = positions[d2.min(axis=1).argmax()]
    return labels.astype(np.int64), centers.astype(np.float32)


def cluster_scene(dataset, n_clusters: int, seed: int = 0):
    """Cluster a scene dataset's frames into expert regions by each frame's
    camera center -R^T t.  Returns (labels, centers)."""
    import torch

    from esac_tpu_torch.geometry.rotations import rodrigues

    centers_cam = []
    for i in range(len(dataset)):
        f = dataset[i]
        R = rodrigues(torch.as_tensor(f.rvec, dtype=torch.float32)).cpu().numpy()
        centers_cam.append(-R.T @ np.asarray(torch.as_tensor(f.tvec).cpu()))
    return kmeans_cluster_cameras(np.stack(centers_cam), n_clusters, seed)
