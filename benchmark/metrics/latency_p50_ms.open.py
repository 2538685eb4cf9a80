"""Median latency of every request due in the window, ms (the open loop's
own reading, on the benchmark's clock).

It is a per-layer reading, not an end-to-end one: at 80 requests/s on the
1 / 4 / 16 bucket ladder the dispatcher's coalescing is bistable.  A
dispatch of up to 4 frames (~28 ms on an H100) lets ~2 frames gather, so
the next rides the 4-lane bucket again; one of 5 or more rides the 16-lane
bucket (~80 ms), in which ~6 frames gather, so the next rides it again.
Poisson bursts switch between the two every few seconds, and the share of
a 20 s window spent in each swings the median from run to run (45-85 ms
on one seed).  ``lanes_per_frame.open`` reads which mode a run was in."""


def read(run):
    return run["window"].get("end_to_end", {}).get("latency_p50_ms")
