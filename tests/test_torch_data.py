"""The port's data slice (esac_tpu_torch.data, geometry.camera.backproject_at_depth)
against the JAX package on the CPU, inputs made from a numpy seed.

Tolerances: the renderer's image and coordinates within atol 1e-4 off the
wall seams (float32 ray / wall arithmetic in another order: measured ~4e-6);
a seam pixel, where two walls' exits lie within 1e-5 of each other, may take
the other wall on one ulp, and seams are held to at most 0.1% of pixels.
backproject_at_depth within rtol / atol 1e-6 and the warp within atol 1e-5
(the same float32 formulas; measured ~1e-7).
"""

import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esac_tpu.data.augment import _warp_resample as j_warp
from esac_tpu.data.datasets import SceneDataset as JSceneDataset
from esac_tpu.data.datasets import SyntheticScene as JSyntheticScene
from esac_tpu.data.datasets import batch_frames as j_batch_frames
from esac_tpu.data.synthetic import render_box_scene as j_render
from esac_tpu.geometry import backproject_at_depth as j_backproject
from esac_tpu.geometry import rodrigues as j_rodrigues
from esac_tpu_torch.data.augment import _warp_resample, augment_frame
from esac_tpu_torch.data.datasets import (
    SceneDataset,
    SyntheticScene,
    batch_frames,
    open_scene,
)
from esac_tpu_torch.data.synthetic import (
    ROOM_SIZE,
    make_correspondence_frame,
    random_poses_in_box,
    render_box_scene,
    trajectory_poses_in_box,
)
from esac_tpu_torch.geometry.camera import backproject_at_depth, project, transform_points
from esac_tpu_torch.geometry.rotations import rodrigues

CPU = torch.device("cpu")


def _pose(seed):
    """A pose inside the room from a numpy seed: (rvec, tvec) float32."""
    rng = np.random.default_rng(seed)
    rvec = rng.uniform(-0.35, 0.35, 3).astype(np.float32)
    center = ROOM_SIZE * (0.5 + rng.uniform(-0.2, 0.2, 3))
    R = np.asarray(j_rodrigues(jnp.asarray(rvec)), np.float64)
    return rvec, (-R @ center).astype(np.float32)


def _seams(rvec, tvec, px, f, c):
    """Pixels whose two nearest wall exits lie within 1e-5 of each other
    (float64 rays)."""
    R = np.asarray(j_rodrigues(jnp.asarray(rvec)), np.float64)
    center = -R.T @ tvec.astype(np.float64)
    rays = np.concatenate([(px - c) / f, np.ones((len(px), 1))], 1) @ R
    safe = np.where(np.abs(rays) < 1e-9, 1e-9, rays)
    s_exit = np.sort(np.maximum((0.0 - center) / safe, (ROOM_SIZE - center) / safe), -1)
    return s_exit[:, 1] - s_exit[:, 0] < 1e-5


@pytest.mark.parametrize("height,width,seed", [(48, 64, 0), (480, 640, 1)],
                         ids=["48x64", "480x640"])
def test_render_box_scene_matches_jax(height, width, seed):
    rvec, tvec = _pose(seed)
    f, c = 525.0 * width / 640.0, (width / 2.0, height / 2.0)
    want = j_render(jnp.asarray(rvec), jnp.asarray(tvec), height, width, f, c, 8,
                    texture_phase=1.7)
    got = render_box_scene(torch.as_tensor(rvec), torch.as_tensor(tvec), height, width, f, c,
                           8, texture_phase=1.7)
    ys, xs = np.meshgrid(np.arange(height) + 0.5, np.arange(width) + 0.5, indexing="ij")
    px_full = np.stack([xs, ys], -1).reshape(-1, 2)
    seam_img = _seams(rvec, tvec, px_full, f, np.asarray(c))
    seam_cell = _seams(rvec, tvec, np.asarray(want["pixels"], np.float64), f, np.asarray(c))
    assert seam_img.mean() <= 1e-3 and seam_cell.mean() <= 1e-3
    img_err = np.abs(got["image"].numpy() - np.asarray(want["image"])).reshape(-1, 3)
    assert img_err[~seam_img].max() <= 1e-4
    crd_err = np.abs(got["coords_gt"].numpy() - np.asarray(want["coords_gt"]))
    assert crd_err[~seam_cell].max() <= 1e-4
    np.testing.assert_array_equal(got["pixels"].numpy(), np.asarray(want["pixels"]))


def test_render_batched_equals_one_by_one():
    poses = [_pose(s) for s in (2, 3, 4)]
    rv = torch.as_tensor(np.stack([p[0] for p in poses]))
    tv = torch.as_tensor(np.stack([p[1] for p in poses]))
    batch = render_box_scene(rv, tv, 24, 32, 26.25, (16.0, 12.0), 8)
    for i in range(3):
        one = render_box_scene(rv[i], tv[i], 24, 32, 26.25, (16.0, 12.0), 8)
        torch.testing.assert_close(batch["image"][i], one["image"], rtol=0, atol=1e-6)
        torch.testing.assert_close(batch["coords_gt"][i], one["coords_gt"], rtol=0, atol=1e-6)


def test_backproject_at_depth_matches_jax():
    rng = np.random.default_rng(5)
    rvecs = rng.uniform(-0.5, 0.5, (3, 3)).astype(np.float32)
    t = rng.uniform(-2, 2, (3, 3)).astype(np.float32)
    pixels = rng.uniform(0, 128, (50, 2)).astype(np.float32)
    f = rng.uniform(90, 120, 3).astype(np.float32)
    c = np.array([64.0, 48.0], np.float32)
    R = np.array(j_rodrigues(jnp.asarray(rvecs)))
    want = jax.vmap(lambda R_, t_, f_: j_backproject(R_, t_, jnp.asarray(pixels), f_,
                                                     jnp.asarray(c), 5.0))(
        jnp.asarray(R), jnp.asarray(t), jnp.asarray(f))
    got = backproject_at_depth(torch.as_tensor(R), torch.as_tensor(t), torch.as_tensor(pixels),
                               torch.as_tensor(f), torch.as_tensor(c), 5.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # A scalar focal broadcasts over the poses.
    one = backproject_at_depth(torch.as_tensor(R), torch.as_tensor(t), torch.as_tensor(pixels),
                               float(f[0]), torch.as_tensor(c), 5.0)
    np.testing.assert_allclose(one[0].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("deg", [0.0, 30.0, -30.0])
@pytest.mark.parametrize("scale", [0.8, 1.2])
def test_warp_resample_matches_jax(deg, scale):
    rng = np.random.default_rng([int(deg) + 100, int(10 * scale)])
    img = rng.uniform(0, 1, (48, 64, 3)).astype(np.float32)
    coords = rng.uniform(0, 6, (6, 8, 3)).astype(np.float32)
    angle, s = np.float32(np.radians(deg)), np.float32(scale)
    for x in (img, coords):
        want = np.asarray(j_warp(jnp.asarray(x), jnp.float32(angle), jnp.float32(s)))
        got = _warp_resample(torch.as_tensor(x), torch.tensor(angle), torch.tensor(s))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # Batched: one angle and scale per frame.
    both = _warp_resample(torch.as_tensor(np.stack([img, img[::-1].copy()])),
                          torch.tensor([angle, -angle]), torch.tensor([s, s]))
    want1 = np.asarray(j_warp(jnp.asarray(img[::-1].copy()), jnp.float32(-angle),
                              jnp.float32(s)))
    np.testing.assert_allclose(both[1].numpy(), want1, rtol=0, atol=1e-5)


@pytest.mark.parametrize("batch", [None, 3], ids=["one_frame", "three_frames"])
def test_augment_geometric_consistency(batch):
    """As tests/test_data.py holds the JAX package: the augmented coords,
    reprojected through the augmented pose and focal, land on the cells."""
    H, W, focal = 96, 128, 105.0
    poses = [_pose(s) for s in range(1 if batch is None else batch)]
    rv = torch.as_tensor(np.stack([p[0] for p in poses]))
    tv = torch.as_tensor(np.stack([p[1] for p in poses]))
    fr = render_box_scene(rv, tv, H, W, focal, (W / 2, H / 2), 8)
    images, coords = fr["image"], fr["coords_gt"].reshape(-1, H // 8, W // 8, 3)
    if batch is None:
        images, coords, rv, tv = images[0], coords[0], rv[0], tv[0]
    aug = augment_frame(torch.Generator().manual_seed(1), images, coords, rv, tv, focal)
    pix = project(transform_points(rodrigues(aug["rvec"]), aug["tvec"],
                                   aug["coords_gt"].reshape(coords.shape[:-3] + (-1, 3))),
                  aug["focal"], torch.tensor([W / 2.0, H / 2.0]))
    grid = fr["pixels"]
    err = torch.linalg.norm(pix - grid, dim=-1)
    interior = ((grid[:, 0] > 24) & (grid[:, 0] < W - 24)
                & (grid[:, 1] > 24) & (grid[:, 1] < H - 24))
    med = err[..., interior].median(dim=-1).values
    assert bool((med < 6.0).all()), med
    assert aug["image"].shape == images.shape and float(aug["image"].max()) <= 1.0
    assert bool(((aug["scale"] >= 0.8) & (aug["scale"] <= 1.2)).all())


def test_augment_draws_come_from_the_generator():
    rv, tv = (torch.as_tensor(x) for x in _pose(7))
    fr = render_box_scene(rv, tv, 48, 64, 52.5, (32, 24), 8)
    args = (fr["image"], fr["coords_gt"].reshape(6, 8, 3), rv, tv, 52.5)
    a = augment_frame(torch.Generator().manual_seed(3), *args)
    b = augment_frame(torch.Generator().manual_seed(3), *args)
    c = augment_frame(torch.Generator().manual_seed(4), *args)
    assert torch.equal(a["image"], b["image"]) and torch.equal(a["rvec"], b["rvec"])
    assert not torch.equal(a["image"], c["image"])
    ident = augment_frame(torch.Generator().manual_seed(3), *args, max_rotation_deg=0.0,
                          scale_range=(1.0, 1.0), brightness=0.0)
    torch.testing.assert_close(ident["image"], fr["image"], rtol=0, atol=1e-6)
    torch.testing.assert_close(ident["rvec"], rv, rtol=0, atol=1e-5)


@pytest.mark.parametrize("sampler", [random_poses_in_box, trajectory_poses_in_box],
                         ids=["iid", "trajectory"])
def test_pose_samplers_bounds_and_seeds(sampler):
    rv, tv = sampler(torch.Generator().manual_seed(11), 300)
    assert rv.shape == (300, 3) and tv.shape == (300, 3)
    assert float(rv.abs().max()) <= 0.35 + 1e-6
    centers = -torch.einsum("nij,ni->nj", rodrigues(rv), tv).numpy()
    room = ROOM_SIZE
    assert (centers >= room * 0.3 - 1e-4).all() and (centers <= room * 0.7 + 1e-4).all()
    rv2, tv2 = sampler(torch.Generator().manual_seed(11), 300)
    assert torch.equal(rv, rv2) and torch.equal(tv, tv2)
    rv3, _ = sampler(torch.Generator().manual_seed(12), 300)
    assert not torch.equal(rv, rv3)


def test_trajectory_steps_are_small():
    rv, tv = trajectory_poses_in_box(torch.Generator().manual_seed(0), 200)
    centers = -torch.einsum("nij,ni->nj", rodrigues(rv), tv)
    step_c = torch.linalg.norm(centers[1:] - centers[:-1], dim=-1)
    step_r = torch.linalg.norm(rv[1:] - rv[:-1], dim=-1)
    assert float(step_c.max()) < 0.05 and float(step_r.max()) < 0.01
    iid_rv, _ = random_poses_in_box(torch.Generator().manual_seed(0), 200)
    assert float(torch.linalg.norm(iid_rv[1:] - iid_rv[:-1], dim=-1).median()) > 0.1


def test_correspondence_frame_geometry():
    fr = make_correspondence_frame(torch.Generator().manual_seed(2), 48, 64, 8,
                                   f=52.5, c=(32.0, 24.0))
    assert torch.equal(fr["coords"], fr["coords_gt"])
    pix = project(transform_points(rodrigues(fr["rvec"]), fr["tvec"], fr["coords_gt"]), 52.5,
                  torch.tensor([32.0, 24.0]))
    assert float((pix - fr["pixels"]).abs().max()) < 1e-3
    noisy = make_correspondence_frame(torch.Generator().manual_seed(2), 96, 128, 8, noise=0.02,
                                      outlier_frac=0.3, f=105.0, c=(64.0, 48.0))
    moved = torch.linalg.norm(noisy["coords"] - noisy["coords_gt"], dim=-1)
    assert 0.15 < float((moved > 0.2).float().mean()) < 0.45


def _write_tree(root, names, focal):
    """A two-frame scene in the common on-disk layout: PNG frames, pose
    txt, calibration; frame 0 with init/*.npy, frame 1 with a depth PNG."""
    from PIL import Image

    rng = np.random.default_rng(9)
    d = root / "scene" / "test"
    for sub in ("rgb", "poses", "calibration", "init", "depth"):
        (d / sub).mkdir(parents=True, exist_ok=True)
    for k, name in enumerate(names):
        Image.fromarray(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)).save(
            d / "rgb" / f"{name}.png")
        rvec, tvec = _pose(20 + k)
        R = np.asarray(j_rodrigues(jnp.asarray(rvec)), np.float64)
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R.T, -R.T @ tvec  # camera-to-scene
        np.savetxt(d / "poses" / f"{name}.txt", T)
        np.savetxt(d / "calibration" / f"{name}.txt", [focal])
        if k == 0:
            np.save(d / "init" / f"{name}.npy", rng.uniform(0, 3, (6, 8, 3)).astype(np.float32))
        else:
            depth = rng.integers(500, 4000, (48, 64)).astype(np.uint16)
            depth[0, :] = 65535  # Kinect's invalid sentinel
            depth[4, 4] = 0
            Image.fromarray(depth).save(d / "depth" / f"{name}.png")
    return root


@pytest.mark.parametrize("focal", [525.0, 585.0], ids=["f525_warns_once", "f585"])
def test_scene_dataset_frames_match_jax(tmp_path, focal):
    root = _write_tree(tmp_path, ["frame-000000", "frame-000001"], focal)
    ours, ref = SceneDataset(root, "scene", "test", expert=2, device=CPU), \
        JSceneDataset(root, "scene", "test", expert=2)
    assert len(ours) == len(ref) == 2
    for ds in (ours, ref):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            frames = [ds[0], ds[1], ds[0]]
        msgs = [w for w in caught if "f=525" in str(w.message)]
        assert len(msgs) == (1 if focal == 525.0 else 0)
        if ds is ours:
            got = frames
        else:
            want = frames
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.image.numpy(), w.image)
        np.testing.assert_allclose(g.rvec.numpy(), w.rvec, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(g.tvec.numpy(), w.tvec)
        np.testing.assert_array_equal(g.coords_gt.numpy(), w.coords_gt)
        assert g.focal == w.focal and g.expert == w.expert == 2


def test_open_scene_labels_by_position():
    """As tests/test_data.py holds the JAX package: 'synth2 synth5' with
    M = 2 labels frames 0 / 1 by position, not by the name's suffix."""
    scenes = ["synth2", "synth5"]
    dsets = [open_scene("unused", s, "training", expert=i, device=CPU, n_frames=2,
                        height=24, width=32) for i, s in enumerate(scenes)]
    assert [ds[0].expert for ds in dsets] == [0, 1]
    b = batch_frames(dsets[1], np.array([0, 1]))
    assert int(b["labels"].max()) < len(scenes)
    assert SyntheticScene("synth3", n_frames=2, height=24, width=32, device=CPU)[0].expert == 3


def test_synthetic_scene_frames_and_batch_keys():
    ds = SyntheticScene("synth1", "training", n_frames=3, height=48, width=64, device=CPU)
    fr = ds[2]
    want = render_box_scene(fr.rvec, fr.tvec, 48, 64, ds.focal, (32.0, 24.0), 8,
                            texture_phase=1.7)
    torch.testing.assert_close(fr.image, want["image"], rtol=0, atol=1e-6)
    torch.testing.assert_close(fr.coords_gt.reshape(-1, 3), want["coords_gt"], rtol=0, atol=1e-6)
    assert not torch.equal(SyntheticScene("synth1", "test", n_frames=3, height=48, width=64,
                                          device=CPU)[0].rvec, ds[0].rvec)
    ours = batch_frames(ds, np.array([0, 2, 1]))
    ref = j_batch_frames(JSyntheticScene("synth1", n_frames=2, height=48, width=64),
                         np.array([0, 1]))
    assert set(ours) == set(ref)
    assert ours["images"].shape == (3, 48, 64, 3) and ours["coords_gt"].shape == (3, 6, 8, 3)
    assert ours["focals"].dtype == torch.float32 and ours["focal"] == ds.focal


def test_scenes_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        open_scene("unused", "synth0", "training", n_frames=1, height=16, width=16)


def test_port_imports_without_pil():
    """The card's machine has no PIL: every port module imports without it."""
    code = (
        "import sys\n"
        "sys.modules['PIL'] = None\n"
        "import importlib, pkgutil, esac_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(esac_tpu_torch.__path__, "
        "'esac_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'esac_tpu_torch.scripts.train_esac' in names, names\n"
        "print('ok', len(names))\n"
    )
    root = __import__("pathlib").Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.startswith("ok"), out.stderr
