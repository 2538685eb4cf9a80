"""Dataset loaders (counterpart of ``esac_tpu/data/datasets.py``): the
common on-disk relocalization layout and the synthetic box-room scenes.

The on-disk layout, as the dataset setup scripts write it:

    <root>/<scene>/{training,test}/
        rgb/*.png                 RGB frames
        poses/*.txt               4x4 camera-to-scene pose matrices
        calibration/*.txt         focal length (one float per frame)
        init/*.npy  (optional)    (h, w, 3) GT scene coordinates
        depth/*.png (optional)    16-bit depth in mm, back-projected into GT
                                  scene coordinates when init/ is absent

On-disk poses are camera-to-scene, the inverse of the (R, t) scene ->
camera transform used everywhere else; loading inverts them once.  Images
are decoded with PIL, imported inside the read: importing this module
needs no PIL, and synthetic scenes never decode an image.

Frames hold tensors on the dataset's device; a synthetic scene is rendered
there once, in chunks of 64 frames.
"""

from __future__ import annotations

import pathlib
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from esac_tpu_torch.data.synthetic import (
    CAMERA_F,
    output_pixel_grid,
    random_poses_in_box,
    render_box_scene,
    trajectory_poses_in_box,
)
from esac_tpu_torch.geometry.rotations import so3_log
from esac_tpu_torch.utils.precision import resolve_device


@dataclass
class Frame:
    image: torch.Tensor      # (H, W, 3) float32 in [0, 1]
    rvec: torch.Tensor       # (3,) scene -> camera
    tvec: torch.Tensor       # (3,)
    focal: float
    coords_gt: torch.Tensor | None = None  # (h, w, 3) or None
    expert: int = 0          # GT expert/scene label


def _invert_pose(T: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """4x4 camera-to-scene matrix -> (rvec, tvec) scene -> camera, float32."""
    R = T[:3, :3].T
    t = -R @ T[:3, 3]
    rvec = so3_log(torch.as_tensor(R, dtype=torch.float32)).numpy()
    return rvec, t.astype(np.float32)


class SceneDataset:
    """One scene of an on-disk dataset in the common layout; frames are read
    on indexing and land on ``device`` (the card unless it says "cpu")."""

    def __init__(self, root: str | pathlib.Path, scene: str, split: str = "training",
                 expert: int = 0, coord_stride: int = 8, device=None):
        self.dir = pathlib.Path(root) / scene / split
        self.expert = expert
        self.stride = coord_stride
        self.device = resolve_device(device)
        self._warned_525 = False
        rgb = self.dir / "rgb"
        if not rgb.is_dir():
            raise FileNotFoundError(f"no rgb/ under {self.dir}")
        self.names = sorted(p.stem for p in rgb.iterdir())
        if not self.names:
            raise FileNotFoundError(f"empty scene {self.dir}")

    def __len__(self) -> int:
        return len(self.names)

    def _find(self, sub: str, stem: str, exts: tuple[str, ...]):
        for ext in exts:
            p = self.dir / sub / f"{stem}{ext}"
            if p.exists():
                return p
        return None

    def __getitem__(self, i: int) -> Frame:
        from PIL import Image  # decoded on read: importing the module needs no PIL

        stem = self.names[i]
        img_path = self._find("rgb", stem, (".png", ".jpg", ".jpeg"))
        image = np.asarray(Image.open(img_path).convert("RGB"), dtype=np.float32) / 255.0
        T = np.loadtxt(self._find("poses", stem, (".txt",))).reshape(4, 4)
        rvec, tvec = _invert_pose(T)
        calib = self._find("calibration", stem, (".txt",))
        focal = float(np.loadtxt(calib)) if calib else CAMERA_F
        if abs(focal - 525.0) < 1e-6 and not self._warned_525:
            # Trees converted before the 525 -> 585 focal change of the
            # 7-Scenes setup keep 525 calibration files; accuracy under the
            # two conventions is not comparable.  Once per dataset.
            self._warned_525 = True
            warnings.warn(
                f"{self.dir}: calibration reads f=525 (pre-585-default "
                "conversion, or deliberate --focal 525). Regenerate the "
                "tree with datasets/setup_7scenes.py for the current "
                "convention, or keep 525 consistently — do not compare "
                "accuracy across the two.", stacklevel=2,
            )
        coords = None
        init = self._find("init", stem, (".npy",))
        if init is not None:
            coords = np.load(init).astype(np.float32)
        else:
            depth_path = self._find("depth", stem, (".png",))
            if depth_path is not None:
                depth = np.asarray(Image.open(depth_path), dtype=np.float32)
                # Kinect invalid-depth sentinel (65535) -> 0 before mm -> m.
                depth[depth >= 65535.0] = 0.0
                depth /= 1000.0
                coords = self._coords_from_depth(depth, T, focal, image.shape)
        dev = self.device
        return Frame(torch.as_tensor(image, device=dev), torch.as_tensor(rvec, device=dev),
                     torch.as_tensor(tvec, device=dev), focal,
                     None if coords is None else torch.as_tensor(coords, device=dev),
                     self.expert)

    def _coords_from_depth(self, depth, T_cs, focal, img_shape):
        """Back-project the depth at the cell centers through the
        camera-to-scene pose; cells without depth (0) get 0."""
        H, W = img_shape[:2]
        s = self.stride
        d = depth[s // 2::s, s // 2::s][: H // s, : W // s]
        grid = output_pixel_grid(H, W, s).numpy().reshape(H // s, W // s, 2)
        cx, cy = W / 2.0, H / 2.0
        x = (grid[..., 0] - cx) / focal * d
        y = (grid[..., 1] - cy) / focal * d
        cam = np.stack([x, y, d], axis=-1)
        coords = cam @ T_cs[:3, :3].T + T_cs[:3, 3]
        coords[d == 0] = 0.0
        return coords.astype(np.float32)


class SyntheticScene:
    """Procedural box-room scene ``synthN`` with its own texture, rendered
    once on ``device``.

    Splits: ``training`` / ``test`` draw i.i.d. poses; ``trajectory`` one
    smooth camera path (:func:`trajectory_poses_in_box`).  Poses come from
    a CPU generator seeded by scene and split, so a scene has the same
    poses on every device.
    """

    def __init__(self, scene: str = "synth0", split: str = "training",
                 n_frames: int = 64, height: int = 96, width: int = 128,
                 coord_stride: int = 8, expert: int | None = None, device=None):
        sid = int(scene.replace("synth", "") or 0)
        self.sid = sid
        # The label is the caller's position in its scene list, not the
        # name's suffix: 'synth2 synth5' with M = 2 must label frames 0 / 1,
        # or gating cross-entropy trains on out-of-range classes.
        self.expert = sid if expert is None else expert
        self.height, self.width, self.stride = height, width, coord_stride
        self.focal = CAMERA_F * width / 640.0
        dev = resolve_device(device)
        seed = sid * 1000 + {"training": 0, "trajectory": 2}.get(split, 1)
        sampler = trajectory_poses_in_box if split == "trajectory" else random_poses_in_box
        self.rvecs, self.tvecs = sampler(torch.Generator().manual_seed(seed), n_frames,
                                         device=dev)
        # Chunks of 64 frames keep the render's per-pixel intermediates
        # (a few (64, H*W, 3) tensors) bounded at any --frames.
        imgs, crds = [], []
        for i in range(0, n_frames, 64):
            out = render_box_scene(self.rvecs[i:i + 64], self.tvecs[i:i + 64], height, width,
                                   self.focal, (width / 2.0, height / 2.0), coord_stride,
                                   texture_phase=1.7 * sid)
            imgs.append(out["image"])
            crds.append(out["coords_gt"])
        h, w = height // coord_stride, width // coord_stride
        self.images = torch.cat(imgs)
        self.coords = torch.cat(crds).reshape(n_frames, h, w, 3)

    def __len__(self) -> int:
        return self.images.shape[0]

    def __getitem__(self, i: int) -> Frame:
        return Frame(self.images[i], self.rvecs[i], self.tvecs[i], self.focal,
                     self.coords[i], self.expert)


def open_scene(root: str, scene: str, split: str, expert: int | None = None,
               device=None, **kw):
    """``synthN`` -> :class:`SyntheticScene`, else an on-disk
    :class:`SceneDataset`.  ``expert=None`` keeps each class's own default
    label (sid for synthetic scenes, 0 on disk).  The synthetic-scale
    kwargs (n_frames / height / width) mean nothing on disk and are dropped
    there with a warning."""
    if scene.startswith("synth"):
        return SyntheticScene(scene, split, expert=expert, device=device, **kw)
    dropped = [k for k in ("n_frames", "height", "width") if kw.pop(k, None) is not None]
    if dropped:
        warnings.warn(f"synthetic-scale kwargs {dropped} ignored for on-disk scene {scene!r}")
    return SceneDataset(root, scene, split, expert=expert or 0, device=device, **kw)


def batch_frames(ds, idx, device=None) -> dict:
    """Stack frames ``idx`` of ``ds`` into tensors on ``device`` (the
    frames' own device when None): 'images', 'rvecs', 'tvecs', 'labels',
    'focal' (frame 0's), 'focals' (per frame: outdoor datasets mix
    cameras) and 'coords_gt' where the frames have it."""
    frames = [ds[int(i)] for i in idx]
    dev = frames[0].image.device if device is None else device

    def stack(xs):
        return torch.stack(list(xs)).to(dev)

    out = {
        "images": stack(f.image for f in frames),
        "rvecs": stack(f.rvec for f in frames),
        "tvecs": stack(f.tvec for f in frames),
        "labels": torch.as_tensor([f.expert for f in frames], device=dev),
        "focal": frames[0].focal,
        "focals": torch.as_tensor([f.focal for f in frames], dtype=torch.float32, device=dev),
    }
    if frames[0].coords_gt is not None:
        out["coords_gt"] = stack(f.coords_gt for f in frames)
    return out
