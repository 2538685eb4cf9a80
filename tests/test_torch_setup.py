"""The port's dataset preparation (esac_tpu_torch.scripts.setup_*,
esac_tpu_torch.data.clustering, geometry.rotations.quaternion_to_matrix)
against the JAX package's scripts and functions, on fabricated miniature
source trees (the fixtures of tests/test_setup_scripts.py).

The JAX scripts run as subprocesses, as their own tests run them; the port's
in process.  Output trees are equal file for file and byte for byte, except
Aachen poses from quaternions other than the identity: the port's float32
rotations agree with XLA's within 1e-6 (a few ulps of the normalization),
not bit for bit, so those pose files are compared as numbers within 1e-6.
k-means labels are equal and centers equal (one numpy algorithm).
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from esac_tpu.data.clustering import kmeans_cluster_cameras as j_kmeans
from esac_tpu.geometry.rotations import quaternion_to_matrix as j_quat
from esac_tpu_torch.data.clustering import cluster_scene, kmeans_cluster_cameras
from esac_tpu_torch.geometry.rotations import quaternion_to_matrix
from esac_tpu_torch.scripts import setup_7scenes, setup_12scenes, setup_aachen

REPO = pathlib.Path(__file__).resolve().parent.parent

pytest.importorskip("PIL")
from PIL import Image  # noqa: E402


def _write_frame(d: pathlib.Path, stem: str, depth: bool = True, suffix: str = ".png"):
    d.mkdir(parents=True, exist_ok=True)
    Image.fromarray(
        (np.random.default_rng(0).uniform(size=(16, 24, 3)) * 255).astype(np.uint8)
    ).save(d / f"{stem}.color{suffix}")
    T = np.eye(4)
    T[:3, 3] = [1.0, 2.0, 3.0]
    np.savetxt(d / f"{stem}.pose.txt", T)
    if depth:
        Image.fromarray(np.full((16, 24), 1500, dtype=np.uint16)).save(d / f"{stem}.depth.png")


def _tree(root: pathlib.Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _jax_script(name, argv):
    r = subprocess.run([sys.executable, str(REPO / "datasets" / f"{name}.py"), *argv],
                       capture_output=True, text=True, cwd=REPO)
    assert r.returncode == 0, r.stderr
    return r.stdout


def _port_script(module, argv, capsys):
    assert module.main(argv) == 0
    return capsys.readouterr().out


def test_setup_7scenes_writes_the_jax_scripts_tree(tmp_path, capsys):
    src = tmp_path / "raw" / "chess"
    for seq in (1, 2):
        for i in range(2):
            _write_frame(src / f"seq-{seq:02d}", f"frame-{i:06d}", depth=seq == 1 or i == 0)
    (src / "TrainSplit.txt").write_text("sequence1\n")
    (src / "TestSplit.txt").write_text("sequence2\n")
    outs = {}
    for who in ("jax", "port"):
        argv = ["--source", str(tmp_path / "raw"), "--dest", str(tmp_path / who),
                "--scenes", "chess", "heads", "--focal", "525"]
        outs[who] = (_jax_script("setup_7scenes", argv) if who == "jax"
                     else _port_script(setup_7scenes, argv, capsys))
    assert outs["port"] == outs["jax"] == "chess: 4 frames\nskip heads: not found under " \
        f"{tmp_path / 'raw'}\n"
    want = _tree(tmp_path / "jax")
    assert _tree(tmp_path / "port") == want and len(want) == 4 * 3 + 3
    assert want["chess/test/calibration/seq02-frame-000000.txt"] == b"525.0\n"


def test_setup_12scenes_writes_the_jax_scripts_tree(tmp_path, capsys):
    data = tmp_path / "raw" / "apt1" / "kitchen" / "data"
    for i in range(5):
        _write_frame(data, f"frame-{i:06d}", depth=i % 2 == 0, suffix=".jpg" if i < 4 else ".png")
    outs = {}
    for who in ("jax", "port"):
        argv = ["--source", str(tmp_path / "raw"), "--dest", str(tmp_path / who),
                "--scenes", "apt1/kitchen", "apt2/bed", "--test-frames", "2"]
        if who == "jax":  # the JAX script imports its sibling setup_7scenes by name
            r = subprocess.run([sys.executable, "setup_12scenes.py", *argv],
                               capture_output=True, text=True, cwd=REPO / "datasets")
            assert r.returncode == 0, r.stderr
            outs[who] = r.stdout
        else:
            outs[who] = _port_script(setup_12scenes, argv, capsys)
    assert outs["port"] == outs["jax"]
    want = _tree(tmp_path / "jax")
    assert _tree(tmp_path / "port") == want
    assert len([k for k in want if "/test/rgb/" in k]) == 2 and len(want) == 5 * 3 + 3


def _aachen_fixture(tmp_path, quaternions):
    """The 18 images of tests/test_setup_scripts.py around three locations,
    their quaternions from ``quaternions(rng)``."""
    rng = np.random.default_rng(1)
    lines = []
    for b, loc in enumerate([(0, 0, 0), (50, 0, 0), (0, 50, 0)]):
        for i in range(6):
            name = f"db/im{b}_{i}.png"
            (tmp_path / "images" / "db").mkdir(parents=True, exist_ok=True)
            Image.fromarray(np.zeros((8, 8, 3), dtype=np.uint8)).save(tmp_path / "images" / name)
            c = np.asarray(loc) + rng.normal(0, 0.5, 3)
            q = " ".join(str(v) for v in quaternions(rng))
            lines.append(f"{name} {q} {c[0]} {c[1]} {c[2]} 800.0")
    lines.insert(3, "# a comment line")
    (tmp_path / "poses.txt").write_text("\n".join(lines))


@pytest.mark.parametrize("quats", ["identity", "random"])
def test_setup_aachen_writes_the_jax_scripts_tree(tmp_path, capsys, quats):
    _aachen_fixture(tmp_path, (lambda rng: (1, 0, 0, 0)) if quats == "identity"
                    else (lambda rng: rng.normal(size=4)))
    outs = {}
    for who in ("jax", "port"):
        argv = ["--images", str(tmp_path / "images"), "--poses", str(tmp_path / "poses.txt"),
                "--dest", str(tmp_path / who), "--clusters", "3", "--seed", "2"]
        outs[who] = (_jax_script("setup_aachen", argv) if who == "jax"
                     else _port_script(setup_aachen, argv, capsys))
    assert outs["port"] == outs["jax"]
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert got.keys() == want.keys() and len(want) == 18 * 3 + 1
    meta = json.loads(want["clusters.json"])
    assert sorted(meta["sizes"]) == [6, 6, 6]
    for key in want:
        if quats == "random" and "/poses/" in key:
            a = np.loadtxt(tmp_path / "port" / key)
            b = np.loadtxt(tmp_path / "jax" / key)
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        else:
            assert got[key] == want[key], key


def test_quaternion_to_matrix_matches_jax():
    """Random, unnormalized and near-zero-w quaternions, float32: within
    1e-6 of the JAX function, and a rotation."""
    q = np.random.default_rng(0).normal(size=(256, 4)).astype(np.float32)
    q[0] = [1, 0, 0, 0]
    q[1] = [0, 3, 0, 4]
    got = quaternion_to_matrix(torch.from_numpy(q))
    np.testing.assert_allclose(got.numpy(), np.asarray(j_quat(q)), rtol=0, atol=1e-6)
    assert got.shape == (256, 3, 3) and torch.equal(got[0], torch.eye(3))
    np.testing.assert_allclose((got @ got.transpose(-1, -2)).numpy(),
                               np.broadcast_to(np.eye(3), (256, 3, 3)), atol=1e-5)


@pytest.mark.parametrize("n,k,seed", [(18, 3, 0), (200, 7, 1), (40, 40, 2)])
def test_kmeans_equals_the_jax_packages(n, k, seed):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)) * 10 + rng.integers(0, 4, (n, 1)) * 30
    labels, centers = kmeans_cluster_cameras(pos, k, seed=seed)
    want_labels, want_centers = j_kmeans(pos, k, seed=seed)
    np.testing.assert_array_equal(labels, want_labels)
    np.testing.assert_allclose(centers, want_centers, rtol=0, atol=1e-9)
    assert labels.dtype == np.int64 and centers.dtype == np.float32
    with pytest.raises(ValueError, match="clusters"):
        kmeans_cluster_cameras(pos[:2], 3)


def test_cluster_scene_matches_jax():
    """cluster_scene over frames of numpy poses around three places: the
    JAX function's labels, centers within 1e-5 (camera centers -R^T t from
    the two packages' float32 rotations)."""
    import types

    from esac_tpu.data.clustering import cluster_scene as j_cluster_scene

    rng = np.random.default_rng(5)
    frames = []
    for loc in ((0.0, 0.0, 0.0), (20.0, 0.0, 0.0), (0.0, 20.0, 5.0)):
        for _ in range(5):
            rvec = rng.uniform(-1, 1, 3).astype(np.float32)
            R = quaternion_to_matrix(torch.tensor([1.0, *(rvec / 2)])).numpy()
            center = (np.asarray(loc) + rng.normal(0, 0.5, 3)).astype(np.float32)
            frames.append(types.SimpleNamespace(rvec=rvec, tvec=(-R @ center).astype(np.float32)))
    labels, centers = cluster_scene(frames, 3, seed=4)
    want_labels, want_centers = j_cluster_scene(frames, 3, seed=4)
    np.testing.assert_array_equal(labels, want_labels)
    np.testing.assert_allclose(centers, want_centers, rtol=0, atol=1e-5)
    assert sorted(np.bincount(labels)) == [5, 5, 5]
