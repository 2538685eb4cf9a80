"""Share of the profiled window in which the card sat idle while no host
op ran through the gap (the idle gaps labelled ``no host op``), %.  0 where
the label is missing from a list of gaps shorter than the breakdown's ten.
Where a full list leaves it out, its seconds lie below the tenth label's
and below the idle time of every gap left unlisted (all gaps between the
device intervals less the listed labels' seconds): the smaller of the two
is given, an upper bound of the share."""

from benchmark import reduce

LABEL = "no host op"
LISTED = 10  # the labels the breakdown keeps (reduce_profile's default top)


def read(run):
    prof = run["profile"]
    if prof is None or prof["window_s"] <= 0:
        return None
    listed = prof["idle_gaps"]
    gaps = dict(listed)
    if LABEL in gaps:
        return 100.0 * gaps[LABEL] / prof["window_s"]
    if len(listed) < LISTED:
        return 0.0
    idle_s = sum(g1 - g0 for g0, g1 in
                 reduce.idle_gaps([(s, s + d) for _, s, d, _ in prof["kernels"]])) / 1e6
    unlisted_s = max(0.0, idle_s - sum(v for _, v in listed))
    return 100.0 * min(min(v for _, v in listed), unlisted_s) / prof["window_s"]
