"""The shared case of tests/test_torch_bench_modes*.py: every named mode of
the port's bench (``esac_tpu_torch.bench``) runs on the CPU at the smallest
arguments its function takes and prints exactly one JSON line; its
payload's nested keys equal the committed artifact of the root
``bench.py`` for that mode (``.scoring_fused.json`` and the rest), its
headline is ``bench.py``'s headline of the same payload, and it writes only
its own artifact, into ``scaffold.ARTIFACT_DIR``.

Shapes are cut here only (the card runs them whole: ``chip_smoke.py`` phase
12).  Keys whose children are data -- outcome counts, per-lane and per-scene
maps, observed lock edges and fault pairs, obs snapshots -- are compared
down to that key (``DATA_KEYED``).

The twelve modes are split over three test files by mode group, so that
``--dist loadfile`` runs the drills that start replica and prefetch
threads (city, fleet, obs, loadtest) on different workers."""

import contextlib
import io
import json
import pathlib

import torch

import bench
from esac_tpu_torch import bench as port
from esac_tpu_torch.bench import obs, scaffold
from esac_tpu_torch.serve.slo import SLOPolicy

ROOT = pathlib.Path(__file__).resolve().parent.parent

# Each test file's modes: city, fleet, obs and loadtest (the slowest, with
# replica, router and prefetch threads) each in another file.
GROUPS = {
    "test_torch_bench_modes.py": ("city", "hostpath", "prefetch", "registry"),
    "test_torch_bench_modes_fleet.py": ("chaos", "fleet", "scoring", "sessions"),
    "test_torch_bench_modes_serve.py": ("loadtest", "obs", "routed", "serve"),
}

ARTIFACTS = {
    "scoring": ".scoring_fused.json", "serve": ".serve_amortization.json",
    "loadtest": ".serve_loadtest.json", "routed": ".routed_serve.json",
    "registry": ".registry_swap.json", "prefetch": ".weight_tiers.json",
    "chaos": ".chaos_drill.json", "fleet": ".fleet_serve.json",
    "city": ".city_retrieval.json", "sessions": ".session_serve.json",
    "hostpath": ".hostpath.json", "obs": ".obs_overhead.json",
}

# The smallest arguments each measure function takes (repeats 1, windows of
# ~0.2 s, tiny sweeps).  City's retriever needs a few dozen steps before an
# easy query clears the calibrated confidence floor at all.
SMALL = {
    "scoring": dict(n_hyps_sweep=(16,), batch=2, repeats=1),
    "serve": dict(n_frames=4, n_hyps=8, buckets=(1, 4), repeats=1),
    "routed": dict(n_frames=2, n_hyps=4, repeats=1),
    "registry": dict(n_scenes=2, repeats=1),
    "prefetch": dict(n_scenes=4, n_requests=8),
    "loadtest": dict(buckets=(2,), mults=(0.4, 2.0), seconds=0.2),
    "chaos": dict(seconds=0.2),
    "obs": dict(n_frames=3, n_hyps=8, repeats=1),
    "hostpath": dict(n_requests=5),
    "fleet": dict(seconds=0.1),
    "city": dict(train_steps=40),
    "sessions": dict(seq_frames=6, load_frames=2),
}

# Dicts keyed by what a run observed, not by the code.
DATA_KEYED = {
    "obs_snapshot", "outcomes", "error_types", "typed_errors", "observed",
    "error_free_outcomes", "edges_observed", "hold_seconds", "blocked_while_held_worst",
    "quarantined", "scene_homes", "health_events", "by_mix", "per_scene", "per_route_k",
    "exemplar_slow_traces", "stage_table", "stage_p50_ms",
}

# (mode, key path) the port's payload has and the committed artifact lacks,
# or the reverse, each with its reason.
PAYLOAD_DIFFERENCES = {
    ("prefetch", ".legs.host_tier_prefetch.prefetch_stats.feed_errors"):
        "the committed .weight_tiers.json predates the JAX prefetcher's posterior "
        "feed counters (esac_tpu/registry/prefetch.py:384-385): a JAX run today "
        "records them too",
    ("prefetch", ".legs.host_tier_prefetch.prefetch_stats.posterior_feeds"):
        "as feed_errors",
}


def key_paths(x, prefix=""):
    out = set()
    if isinstance(x, dict):
        for k, v in x.items():
            out.add(f"{prefix}.{k}")
            if k not in DATA_KEYED:
                out |= key_paths(v, f"{prefix}.{k}")
    elif isinstance(x, list):
        for v in x:
            out |= key_paths(v, prefix + "[]")
    return out


def _dotfiles():
    """The committed root artifacts of ``bench.py``: the port never writes them."""
    return {n: (ROOT / n).stat().st_mtime_ns for n in ARTIFACTS.values()}


# The drills whose dispatcher, replica, router and prefetch threads ran
# 20-40x slower under a loaded 6-worker run than alone (fleet 191 s against
# 7 s, city 156 against 10, chaos 84 against 2, loadtest 137 against 4):
# each worker's 8 intra-op threads oversubscribe the host's cores, and
# every Python thread of the drill waits behind them.  The cases check
# payload keys, not speed, so these run with one intra-op thread (restored
# after the case).
ONE_THREAD = {"chaos", "city", "fleet", "loadtest"}


@contextlib.contextmanager
def intra_op_threads(n: int):
    saved = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def run_mode_case(mode, tmp_path, monkeypatch):
    """One mode's case (module docstring)."""
    if mode in ONE_THREAD:
        with intra_op_threads(1):
            return _run_mode_case(mode, tmp_path, monkeypatch)
    return _run_mode_case(mode, tmp_path, monkeypatch)


def _run_mode_case(mode, tmp_path, monkeypatch):
    monkeypatch.setattr(scaffold, "ARTIFACT_DIR", tmp_path)
    if mode == "obs":
        # The failover drill's 250 ms watchdog (bench.py's) can fire on the
        # drill's first, unstalled dispatch when a loaded CPU runs other test
        # workers; the payload's keys do not depend on it.
        monkeypatch.setattr(obs, "SLOPolicy", lambda **kw: SLOPolicy(
            **{**kw, **({"watchdog_ms": 5_000.0} if "watchdog_ms" in kw else {})}))
    before = _dotfiles()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        port.run(mode, torch.device("cpu"), **SMALL[mode])
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    ref = json.loads((ROOT / ARTIFACTS[mode]).read_text())
    payload = line[mode]

    headline = getattr(bench, f"_{mode}_headline")(payload)
    assert {k: line[k] for k in headline} == headline
    assert line["unit"] == ref["unit"]
    assert line["platform"] == "cpu" and line["device"]["name"] is None
    assert "loadavg_prepause" in line["contention"]

    ours, want = key_paths(payload), key_paths(ref[mode])
    diff = {(mode, k) for k in ours ^ want}
    assert diff == {d for d in PAYLOAD_DIFFERENCES if d[0] == mode}, sorted(diff)

    assert sorted(p.name for p in tmp_path.iterdir()) == [f"{mode}.json"]
    artifact = json.loads((tmp_path / f"{mode}.json").read_text())
    assert artifact[mode] == payload and artifact["platform"] == "cpu"
    assert {"recorded_at", "obs_provenance", "device"} <= set(artifact)
    assert artifact["obs_provenance"]["has_fleet_snapshot"] == (
        payload.get("obs_snapshot") is not None)
    assert _dotfiles() == before
