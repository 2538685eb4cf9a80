"""Bucket lanes the window's dispatches rode per frame they served: 1 when
every dispatch fills its bucket; a 5-frame dispatch on the 16-lane bucket
reads 3.2.  It reads the padding the bucket ladder costs, and which
coalescing mode (see ``latency_p50_ms.open``) a run spent its time in."""


def read(run):
    w = run["window"]
    return w["bucket_lanes"] / w["bucket_frames"] if w.get("bucket_frames") else None
