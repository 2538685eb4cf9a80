"""Prepare Aachen Day-Night: SfM poses -> the per-image layout, clustered
into experts (the port's counterpart of ``datasets/setup_aachen.py``; the
same flags, the same tree).  The outdoor benchmark has no depth; its experts
are k-means clusters of the ground-truth camera positions (~50 for Aachen).
Nothing is downloaded:

    python -m esac_tpu_torch.scripts.setup_aachen --images /data/aachen/images \\
        --poses /data/aachen/poses.txt --dest datasets/aachen --clusters 50

Pose list (one line per training image, SfM convention):
    <relative/image/path> qw qx qy qz cx cy cz <focal_px>
where (qw..qz) rotates world->camera and (cx cy cz) is the camera center in
world coordinates.  Writes ``<dest>/cluster<k>/training/{rgb,poses,
calibration}`` per expert (camera-to-world 4x4 poses) and
``<dest>/clusters.json`` (centers, each image's label, cluster sizes).

Host-side numpy and PyTorch on the CPU; no device is touched.  Rotations are
computed in float32, as the JAX script's are.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np
import torch

from esac_tpu_torch.data.clustering import kmeans_cluster_cameras
from esac_tpu_torch.geometry.rotations import quaternion_to_matrix
from esac_tpu_torch.scripts.setup_7scenes import _link


def quat_to_R(q: np.ndarray) -> np.ndarray:
    """(w, x, y, z) -> (3, 3) float32 world->camera rotation."""
    return quaternion_to_matrix(torch.as_tensor(np.asarray(q, dtype=np.float32))).numpy()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--images", required=True)
    p.add_argument("--poses", required=True)
    p.add_argument("--dest", default="datasets/aachen")
    p.add_argument("--clusters", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    images, dest = pathlib.Path(args.images), pathlib.Path(args.dest)

    entries = []
    for line in pathlib.Path(args.poses).read_text().splitlines():
        parts = line.split()
        if len(parts) < 9 or line.startswith("#"):
            continue
        entries.append((parts[0], np.array([float(v) for v in parts[1:5]]),
                        np.array([float(v) for v in parts[5:8]]), float(parts[8])))
    if not entries:
        print("no pose entries parsed", file=sys.stderr)
        return 1

    labels, cluster_centers = kmeans_cluster_cameras(
        np.stack([e[2] for e in entries]), args.clusters, seed=args.seed)
    for (name, q, center, focal), k in zip(entries, labels):
        out = dest / f"cluster{k}" / "training"
        stem = name.replace("/", "_").rsplit(".", 1)[0]
        src = images / name
        if src.exists():
            _link(src, out / "rgb" / f"{stem}{src.suffix}")
        T = np.eye(4)  # camera-to-world, the common layout's convention
        T[:3, :3] = quat_to_R(q).T
        T[:3, 3] = center
        pose_f = out / "poses" / f"{stem}.txt"
        pose_f.parent.mkdir(parents=True, exist_ok=True)
        np.savetxt(pose_f, T)
        calib = out / "calibration" / f"{stem}.txt"
        calib.parent.mkdir(parents=True, exist_ok=True)
        calib.write_text(f"{focal}\n")

    sizes = np.bincount(labels, minlength=args.clusters).tolist()
    dest.mkdir(parents=True, exist_ok=True)
    (dest / "clusters.json").write_text(json.dumps({
        "n_clusters": args.clusters,
        "centers": cluster_centers.tolist(),
        "labels": {e[0]: int(k) for e, k in zip(entries, labels)},
        "sizes": sizes,
    }, indent=2))
    print(f"{len(entries)} images -> {args.clusters} expert clusters; sizes {sizes}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
