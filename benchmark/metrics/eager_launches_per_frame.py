"""Device kernels per served frame in the profiled window that are neither
convolutions nor the scoring kernels: the eager PyTorch ops of sampling,
P3P + polish, IRLS and the glue around the CNNs."""

from benchmark import reduce


def read(run):
    prof = run["profile"]
    if prof is None or not prof["frames"]:
        return None
    return reduce.launches(prof, "eager") / prof["frames"]
