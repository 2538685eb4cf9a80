"""Convert the MSR 7-Scenes release into the common dataset layout (the
port's counterpart of ``datasets/setup_7scenes.py``; the same flags, the
same tree).  Nothing is downloaded: point it at an unpacked release.

    python -m esac_tpu_torch.scripts.setup_7scenes --source /data/7scenes --dest datasets/7scenes

Source layout (per scene, e.g. ``chess/``):
    seq-XX/frame-XXXXXX.color.png       RGB
    seq-XX/frame-XXXXXX.pose.txt        4x4 camera-to-world pose
    seq-XX/frame-XXXXXX.depth.png       16-bit depth (mm), 65535 = invalid
    TrainSplit.txt / TestSplit.txt      lines like "sequence1"

Destination: ``<dest>/<scene>/{training,test}/{rgb,poses,calibration,depth}``
with a focal-length file per frame (f = 585 px by default, the Kinect depth
stream's convention; ``--focal 525`` gives the PrimeSense RGB one).  Files
are hard-linked where possible (copied otherwise); images are never
decoded.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import shutil
import sys

SCENES = ("chess", "fire", "heads", "office", "pumpkin", "redkitchen", "stairs")
FOCAL = 585.0


def _link(src: pathlib.Path, dst: pathlib.Path) -> None:
    """Hard-link ``src`` at ``dst`` (a copy across file systems); an
    existing ``dst`` is kept."""
    dst.parent.mkdir(parents=True, exist_ok=True)
    if dst.exists():
        return
    try:
        os.link(src, dst)
    except OSError:
        shutil.copy2(src, dst)


def convert_scene(source: pathlib.Path, dest: pathlib.Path, scene: str,
                  focal: float = FOCAL) -> int:
    """One scene's training and test splits; returns the frames written."""
    sdir = source / scene
    n = 0
    for split_file, split in (("TrainSplit.txt", "training"), ("TestSplit.txt", "test")):
        seqs = [int(line.strip().replace("sequence", ""))
                for line in (sdir / split_file).read_text().splitlines() if line.strip()]
        out = dest / scene / split
        for seq in seqs:
            seq_dir = sdir / f"seq-{seq:02d}"
            for color in sorted(seq_dir.glob("frame-*.color.png")):
                stem = f"seq{seq:02d}-{color.name.split('.')[0]}"
                _link(color, out / "rgb" / f"{stem}.png")
                _link(seq_dir / color.name.replace(".color.png", ".pose.txt"),
                      out / "poses" / f"{stem}.txt")
                depth = seq_dir / color.name.replace(".color.png", ".depth.png")
                if depth.exists():
                    _link(depth, out / "depth" / f"{stem}.png")
                calib = out / "calibration" / f"{stem}.txt"
                calib.parent.mkdir(parents=True, exist_ok=True)
                calib.write_text(f"{focal}\n")
                n += 1
    return n


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--source", required=True, help="downloaded 7-Scenes root")
    p.add_argument("--dest", default="datasets/7scenes")
    p.add_argument("--scenes", nargs="*", default=list(SCENES))
    p.add_argument("--focal", type=float, default=FOCAL,
                   help="focal length written to calibration/ (585 = Kinect "
                        "depth convention; 525 reproduces the PrimeSense-RGB "
                        "convention some releases use)")
    args = p.parse_args(argv)
    source, dest = pathlib.Path(args.source), pathlib.Path(args.dest)
    for scene in args.scenes:
        if not (source / scene).is_dir():
            print(f"skip {scene}: not found under {source}")
            continue
        n = convert_scene(source, dest, scene, focal=args.focal)
        print(f"{scene}: {n} frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
