"""The reader of ``graph_replay_share.open`` on hand-made run records."""

import pytest

from benchmark import spec


def _run(spans):
    return {"cfg": {}, "cell": {}, "mix": {}, "peaks": None, "profile": None,
            "window": {"spans": list(spans), "served_frames": 0, "dispatches": 0,
                       "window_s": 0.0}}


def test_every_span_with_the_replayed_refine_stage_reads_100():
    spans = [{"dispatched": 0.1, "dispatched.refine": 0.01, "graph.refine": 0.001}] * 3
    assert spec.reader("graph_replay_share.open")(_run(spans)) == pytest.approx(100.0)


def test_spans_without_the_key_read_0():
    spans = [{"dispatched": 0.1, "dispatched.refine": 0.05}, {"dispatched": 0.1}]
    assert spec.reader("graph_replay_share.open")(_run(spans)) == 0.0


def test_a_share_of_the_spans():
    spans = [{"graph.refine": 0.001}, {"dispatched.refine": 0.05},
             {"graph.hypotheses": 0.001}, {"graph.refine": 0.002}]
    assert spec.reader("graph_replay_share.open")(_run(spans)) == pytest.approx(50.0)


def test_no_spans_read_nothing():
    assert spec.reader("graph_replay_share.open")(_run([])) is None
