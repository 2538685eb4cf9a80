"""``BENCHMARK.json`` against the benchmark contract, and every piece found
by name: configurations, traffic mixes, cells, generators, metric readers."""

import dataclasses
import json
import re

import pytest

from benchmark import compare, spec

BENCH = json.loads((spec.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# Keys of a configuration file that the harness reads or that describe the
# configuration; every other key is a ``RansacConfig`` field.
HARNESS_KEYS = {
    "name", "source", "what", "published", "deployment", "reduced", "changed", "assumed",
    "assumed_why", "shares", "scene", "limits", "height", "width", "stride", "num_experts",
    "gated", "stem_channels", "head_channels", "head_depth", "gating_channels",
    "compute_dtype"}


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    # A full check of 24 cells fits in 43200 s.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entries():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[key]]
    assert all(NAME.match(n) for n in names)
    for key in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[key]}) == len(BENCH[key])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "layer", "moves",
                          "workloads"}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200


def test_every_cell_reports_what_the_contract_asks():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        wl = spec.load(w["name"])
        got = {m["name"] for m in wl.end_to_end}
        assert "setup_s" in got and len(got) >= 2
        assert wl.per_layer
        for m in wl.per_layer:
            assert m["moves"] in got, (w["name"], m["name"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", [])) <= {w["name"] for w in BENCH["workloads"]}


def test_configs_hold_the_ref_widths_and_name_their_changes():
    from esac_tpu_torch.ransac.config import RansacConfig

    fields = {f.name for f in dataclasses.fields(RansacConfig)}
    for c in BENCH["configs"]:
        cfg = json.loads((spec.REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert (cfg["height"], cfg["width"]) == (480, 640)
        assert cfg["stem_channels"] == [64, 128, 256] and cfg["head_channels"] == 512
        assert cfg["head_depth"] == 4 and cfg["gating_channels"] == [32, 64, 128, 256]
        assert not any(k.endswith(("_dim", "_rank", "channels")) for k in cfg["reduced"])
        # Each key changed from the source says how; each width is assumed.
        assert set(cfg["changed"]) == set(cfg["reduced"])
        assert {"stem_channels", "head_channels", "gating_channels"} <= set(cfg["assumed"])
        assert set(cfg["limits"]) == set(compare.NUMBERS)
        # Every other key is a RansacConfig field: a misspelt one would
        # otherwise be dropped without a word (a dense serve for a routed
        # configuration).
        assert set(cfg) <= HARNESS_KEYS | fields, c["name"]
        assert set(cfg["scene"]) <= {"room_extents_m", "weight_noise", "gating"}
        assert cfg["scene"].get("gating", "rooms") == "rooms"
        if cfg.get("serve_topk"):
            assert cfg["gated"] and 1 <= cfg["serve_topk"] < cfg["num_experts"]


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_pieces_are_found_by_name(workload):
    wl = spec.load(workload)
    assert wl.cfg["name"] == next(w["config"] for w in BENCH["workloads"]
                                  if w["name"] == workload)
    assert callable(spec.generator(wl.mix["generator"]).run)
    for m in wl.per_layer:
        assert callable(spec.reader(m["name"]))


def test_one_reader_serves_every_suffix_of_its_quantity():
    assert spec.reader("device_idle_share.open").__code__.co_filename.endswith(
        "metrics/device_idle_share.py")
    assert spec.reader("queue_ms.open").__code__.co_filename.endswith(
        "metrics/queue_ms.open.py")


def test_unknown_names_are_refused():
    with pytest.raises(spec.SpecError):
        spec.load("no_such_cell")
    with pytest.raises(spec.SpecError):
        spec.reader("no_such_metric")


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_a_reader_that_finds_nothing_returns_nothing(metric):
    empty = {"cfg": spec.load(BENCH["workloads"][0]["name"]).cfg, "cell": {}, "mix": {},
             "window": {"spans": [], "served_frames": 0, "dispatches": 0, "window_s": 0.0},
             "profile": None, "peaks": None}
    assert spec.reader(metric)(empty) is None


def test_room_extents_make_no_two_rooms_similar():
    """Expert m reads a frame of room r as room r stretched by e_m / e_r: no
    two rooms may be scaled copies of each other on any pair of axes."""
    import itertools
    import math

    for c in BENCH["configs"]:
        ext = json.loads((spec.REPO / c["file"]).read_text())["scene"]["room_extents_m"]
        for a, b in itertools.combinations(ext, 2):
            r = [math.log(x / y) for x, y in zip(a, b)]
            assert min(abs(r[i] - r[j]) for i, j in ((0, 1), (0, 2), (1, 2))) > 0.1
