"""Share of the traced requests whose bucket call replayed its refine stage
as a CUDA graph (their spans carry ``graph.refine``), %.  0 where spans
exist and none carries it (every request ran the chain eagerly); nothing
where no request was traced."""


def read(run):
    spans = run["window"]["spans"]
    if not spans:
        return None
    return 100.0 * sum("graph.refine" in s for s in spans) / len(spans)
