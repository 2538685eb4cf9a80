"""Mean time from a dispatch's start to its batch on the device (the
``staged`` span stage: ``StagingCache`` row copies and the copy), ms."""


def read(run):
    spans = [s["staged"] for s in run["window"]["spans"] if "staged" in s]
    return 1e3 * sum(spans) / len(spans) if spans else None
