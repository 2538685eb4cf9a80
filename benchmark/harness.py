"""One run of one cell: set-up, the measured window, the correctness check
and the metrics, returned as the result line's object.

Order of a run: build the system (weights from the seed, the checkpoint,
the registry, its buckets warmed) and the request images; the traffic
kind's generator warms its own path and measures the window; the peak
memory is read and the program's state freed; the reference answers a
sample of the served frames; the metrics are read.  The reference and the
metric reduction are not part of ``setup_s`` or of the window.
"""

from __future__ import annotations

import dataclasses
import gc
import pathlib
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from benchmark import compare, counts, reduce, reference, scene, spec
from benchmark import system as system_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "esac_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is a forbidden one, compared whole
    (``esac_tpu_torch`` is not ``esac_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


@dataclasses.dataclass
class Context:
    """What a traffic generator gets: the system, the request images (host
    numpy, one pool), the cell's parameters and the profiler switch."""
    wl: spec.Workload
    system: system_mod.System
    images: list
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    profile: dict | None = None
    t_open: float | None = None
    _prof: object = None
    _prof_t0: float | None = None

    def frame(self, image_index: int, request_seed: int) -> dict:
        return {"image": self.images[image_index % len(self.images)],
                "seed": np.int64(request_seed)}

    def rng(self, stream: int) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence([self.seed, stream]))

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def open_window(self) -> float:
        self.sync()
        self.t_open = time.perf_counter()
        return self.t_open

    def profile_start(self) -> None:
        if self.trace and self._prof is None and self.device.type == "cuda":
            self._prof = _profiler()
            self._prof.__enter__()
            self._prof_t0 = time.perf_counter()

    def profile_stop(self, t_end: float | None = None) -> None:
        """Stop the profiler; the traced window ends at ``t_end`` (host
        clock; default now)."""
        if self._prof is None:
            return
        self.sync()
        t_end = time.perf_counter() if t_end is None else t_end
        self._prof.__exit__(None, None, None)
        self.profile = {"prof": self._prof, "window_s": t_end - self._prof_t0,
                        "t0": self._prof_t0, "t1": t_end}
        self._prof = None


class GCClock:
    """Times the interpreter's garbage collections while it is entered (the
    run file reports the pause time a window held, by generation)."""

    def __init__(self):
        self.pauses = {0: 0.0, 1: 0.0, 2: 0.0}
        self.counts = {0: 0, 1: 0, 2: 0}
        self._t = None

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            g = info["generation"]
            self.pauses[g] += time.perf_counter() - self._t
            self.counts[g] += 1
            self._t = None

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)

    def report(self) -> dict:
        return {"gc_pause_s": sum(self.pauses.values()),
                "gc_gen2_pause_s": self.pauses[2], "gc_collections": self.counts}


def _profiler():
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    try:
        from torch._C._profiler import _ExperimentalConfig

        # The dispatcher's worker thread issues the ops: record every thread.
        return profile(activities=acts,
                       experimental_config=_ExperimentalConfig(profile_all_threads=True))
    except TypeError:
        return profile(activities=acts)


def warm_profiler(device) -> None:
    """Initialize the device tracer once in set-up, so the traced window
    does not pay it."""
    if device.type == "cuda":
        with _profiler():
            torch.ones(1, device=device).add_(1)
            torch.cuda.synchronize(device)


def process_age() -> float:
    """Seconds since this process started (from /proc; 0 where it is not
    there), read first thing in the entry script so that ``setup_s``
    counts the interpreter's own start too."""
    try:
        import os

        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        return max(0.0, time.clock_gettime(time.CLOCK_BOOTTIME)
                   - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError, AttributeError):
        return 0.0


def reference_answers(cfg: dict, seed: int, pool: int, picks: list, device, precision: str,
                      block: int) -> dict:
    """The reference on the sampled frames ``picks`` [(image index, request
    seed)], in blocks of ``block`` frames, from weights and the ``pool``
    request images made again from the seed.  TF32 is off."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    experts, gating = scene.make_weights(cfg, seed, device)
    images = scene.make_frames(cfg, seed, pool, device)["images"]
    parts = []
    with torch.no_grad():
        for lo in range(0, len(picks), block):
            chunk = picks[lo:lo + block]
            parts.append(reference.serve_frames(
                cfg, experts, gating, images[[i for i, _ in chunk]], [s for _, s in chunk],
                precision))
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def kinds(prof: dict, top: int = 12) -> dict:
    """Per kind of device event: launches, seconds and the names that took
    most time (for the run's file, not the result line)."""
    out = {}
    for name, _, d, k in prof["kernels"]:
        o = out.setdefault(k, {"launches": 0, "seconds": 0.0, "names": {}})
        o["launches"] += 1
        o["seconds"] += d / 1e6
        o["names"][name[:100]] = o["names"].get(name[:100], 0.0) + d / 1e6
    for o in out.values():
        o["names"] = sorted(o["names"].items(), key=lambda kv: -kv[1])[:top]
    return out


def _plant(system, fault) -> None:
    """Break the served path underneath the dispatcher: every bucket
    function's result goes through ``fault`` (a test's planted fault)."""
    fn_for = system.registry._fn_for

    def faulty(*args, **kwargs):
        fn = fn_for(*args, **kwargs)

        def run(params, batch):
            return fault(fn(params, batch))

        run._cache_size = fn._cache_size
        return run

    system.registry._fn_for = faulty


def _sample(served: list, n: int, seed: int) -> list:
    """``n`` served frames drawn from the seed (all of them when fewer)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 3]))
    if len(served) <= n:
        return served
    return [served[i] for i in sorted(rng.choice(len(served), size=n, replace=False))]


def run_cell(wl: spec.Workload, seed: int, seconds: float, trace: bool, device,
             t0: float, fault=None) -> dict:
    """One run; returns the result line's object.  ``t0`` is the host perf
    clock at this process's start: set-up runs from it to the window's
    opening.  ``fault`` breaks the served path underneath (the tests'
    planted faults)."""
    device = torch.device(device)
    cfg = wl.cfg
    tmp = tempfile.mkdtemp(prefix="esac_bench_")
    try:
        system = system_mod.build(cfg, wl.mix, seed, device, pathlib.Path(tmp))
        pool = scene.make_frames(cfg, seed, wl.mix["image_pool"], device)
        images = list(pool["images"].cpu().numpy())
        del pool
        if trace:
            warm_profiler(device)
        if fault is not None:
            _plant(system, fault)
        ctx = Context(wl=wl, system=system, images=images, seed=seed, seconds=seconds,
                      trace=trace, device=device)
        with GCClock() as gc_clock:
            window = spec.generator(wl.mix["generator"]).run(ctx)
        peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0)
        system_mod.release(system, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    setup_s = ctx.t_open - t0
    t_ref = time.perf_counter()

    sample = _sample(window["served"], wl.cell["correct_sample"], seed)
    ref = reference_answers(cfg, seed, wl.mix["image_pool"], [(i, s) for i, s, _ in sample],
                            device, "float32", wl.cell["reference_block"])
    served = compare.served_arrays([row for _, _, row in sample], device)
    nums = compare.numbers(served, ref)
    correct, shown = compare.judge(nums, cfg["limits"])
    print(f"set-up {setup_s:.3f} s, window and release {t_ref - ctx.t_open:.3f} s, "
          f"reference {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)

    e2e = dict(window["end_to_end"], setup_s=setup_s)
    metrics = {}
    if not trace:
        for m in wl.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    out_device = {"platform": "gpu" if device.type == "cuda" else device.type,
                  "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                           else "cpu"),
                  "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics, "device": out_device}
    if trace:
        prof = None
        if ctx.profile is not None:
            t_red = time.perf_counter()
            prof = reduce.reduce_profile(ctx.profile["prof"].events(),
                                         ctx.profile["window_s"])
            prof.update(frames=window["profile_frames"], conv_frames=window["profile_lanes"],
                        score_frames=window["profile_lanes"])
            print(f"trace reduced in {time.perf_counter() - t_red:.3f} s, "
                  f"{len(prof['kernels'])} device events", file=sys.stderr)
            out_device["busy_s"] = prof["busy_s"]
            out_device["window_s"] = prof["window_s"]
            result["breakdown"] = {"device_ops": prof["device_ops"],
                                   "idle_gaps": prof["idle_gaps"]}
            result["kinds"] = kinds(prof)
        run = {"cfg": cfg, "cell": wl.cell, "mix": wl.mix, "window": window, "profile": prof,
               "peaks": counts.PEAKS.get(out_device["kind"])}
        for m in wl.per_layer:
            value = spec.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result["generator"] = dict(window.get("generator", {}), **gc_clock.report())
    result["compared"] = shown
    return result
