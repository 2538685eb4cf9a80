"""Mean time a traced request waited in the dispatcher's queue and hold
(the ``coalesced`` span stage), ms."""


def read(run):
    spans = [s["coalesced"] for s in run["window"]["spans"] if "coalesced" in s]
    return 1e3 * sum(spans) / len(spans) if spans else None
