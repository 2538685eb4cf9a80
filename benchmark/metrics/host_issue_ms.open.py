"""Mean time the registry's bucket function took to return, i.e. to issue
one dispatch's work from the host (the ``dispatched`` span stage), ms."""


def read(run):
    spans = [s["dispatched"] for s in run["window"]["spans"] if "dispatched" in s]
    return 1e3 * sum(spans) / len(spans) if spans else None
