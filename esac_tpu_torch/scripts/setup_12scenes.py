"""Convert the Stanford 12-Scenes release into the common dataset layout
(the port's counterpart of ``datasets/setup_12scenes.py``; the same flags,
the same tree).  Nothing is downloaded: point it at an unpacked release.

    python -m esac_tpu_torch.scripts.setup_12scenes --source /data/12scenes --dest datasets/12scenes

Source layout (per scene, e.g. ``apt1/kitchen``):
    data/frame-XXXXXX.color.jpg      RGB (1296x968)
    data/frame-XXXXXX.pose.txt       4x4 camera-to-world pose
    data/frame-XXXXXX.depth.png      16-bit depth (mm)

12-Scenes ships no split files: the first ``--test-frames`` frames of a
scene are its test split, the rest train.  Focal length f = 572 px at
1296x968, written per frame.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

from esac_tpu_torch.scripts.setup_7scenes import _link

SCENES = (
    "apt1/kitchen", "apt1/living",
    "apt2/bed", "apt2/kitchen", "apt2/living", "apt2/luke",
    "office1/gates362", "office1/gates381", "office1/lounge", "office1/manolis",
    "office2/5a", "office2/5b",
)
FOCAL = 572.0


def convert_scene(source: pathlib.Path, dest: pathlib.Path, scene: str,
                  test_frames: int) -> int:
    """One scene, ``apt1/kitchen`` written as ``apt1_kitchen``; returns the
    frames written."""
    data = source / scene / "data"
    colors = sorted(data.glob("frame-*.color.jpg")) + sorted(data.glob("frame-*.color.png"))
    flat = scene.replace("/", "_")
    for i, color in enumerate(colors):
        out = dest / flat / ("test" if i < test_frames else "training")
        stem = color.name.split(".")[0]
        _link(color, out / "rgb" / f"{stem}{color.suffix}")
        _link(data / f"{stem}.pose.txt", out / "poses" / f"{stem}.txt")
        depth = data / f"{stem}.depth.png"
        if depth.exists():
            _link(depth, out / "depth" / f"{stem}.png")
        calib = out / "calibration" / f"{stem}.txt"
        calib.parent.mkdir(parents=True, exist_ok=True)
        calib.write_text(f"{FOCAL}\n")
    return len(colors)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--source", required=True)
    p.add_argument("--dest", default="datasets/12scenes")
    p.add_argument("--scenes", nargs="*", default=list(SCENES))
    p.add_argument("--test-frames", type=int, default=200,
                   help="first N frames of each scene form the test split")
    args = p.parse_args(argv)
    source, dest = pathlib.Path(args.source), pathlib.Path(args.dest)
    for scene in args.scenes:
        if not (source / scene / "data").is_dir():
            print(f"skip {scene}: not found under {source}")
            continue
        n = convert_scene(source, dest, scene, args.test_frames)
        print(f"{scene}: {n} frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
