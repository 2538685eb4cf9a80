"""The reader of ``cnn_fused_share.open`` on hand-made run records."""

import pytest

from benchmark import spec


def _run(spans):
    return {"cfg": {}, "cell": {}, "mix": {}, "peaks": None, "profile": None,
            "window": {"spans": list(spans), "served_frames": 0, "dispatches": 0,
                       "window_s": 0.0}}


def _read(spans):
    return spec.reader("cnn_fused_share.open")(_run(spans))


def test_each_dispatch_counts_once_on_its_first_request():
    # two dispatches: 112 of 127 fused (three requests) and 0 of 127 (one)
    spans = [{"dispatched": 0.1, "cnn.convs": 127, "cnn.fused_convs": 112},
             {"dispatched": 0.1}, {"dispatched": 0.1},
             {"dispatched": 0.1, "cnn.convs": 127, "cnn.fused_convs": 0}]
    assert _read(spans) == pytest.approx(100.0 * 112 / 254)


@pytest.mark.parametrize("convs, fused, share", [(212, 187, 100.0 * 187 / 212),
                                                 (127, 127, 100.0), (127, 0, 0.0)])
def test_the_share_of_one_dispatch(convs, fused, share):
    assert _read([{"cnn.convs": convs, "cnn.fused_convs": fused}]) == pytest.approx(share)


@pytest.mark.parametrize("spans", [[], [{"dispatched": 0.1, "route.pairs": 2}],
                                   [{"cnn.convs": 127}], [{"cnn.convs": 0, "cnn.fused_convs": 0}]])
def test_a_program_without_the_counts_reads_nothing(spans):
    assert _read(spans) is None
