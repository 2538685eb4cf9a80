"""``hostpath`` mode (counterpart of ``bench.py``'s ``_measure_hostpath``): the
stage-attributed host-overhead breakdown and the per-replica closed-loop
capacity, riding ``esac_tpu_torch/tools/hostpath_profile.py``.

The JAX bench forces this measurement onto the CPU and judges capacity
against a committed CPU number of the JAX package (629.94 rps).  The port
runs the dispatcher where its entry points run, on the card, and has no
committed number of its own: ``committed_baseline_rps``,
``speedup_x_vs_committed`` and ``gate_1p3x`` keep their keys and hold
None."""

from __future__ import annotations

from esac_tpu_torch.bench.constants import HOSTPATH_REQUESTS
from esac_tpu_torch.bench.fixtures import accounting_exact
from esac_tpu_torch.tools.hostpath_profile import profile


def measure_hostpath(n_requests: int = HOSTPATH_REQUESTS, device=None) -> dict:
    out = profile(n_requests=n_requests, device=device)
    out["capacity"] = {**out["capacity"], "committed_baseline_rps": None,
                       "speedup_x_vs_committed": None, "gate_1p3x": None}
    out["accounting_exact"] = accounting_exact(out["accounting"])
    return out


def hostpath_headline(hostpath: dict) -> dict:
    cap = hostpath["capacity"]
    return {
        "metric": "hostpath_per_replica_capacity_rps",
        "value": cap["per_replica_capacity_rps"],
        "unit": "rps",
        "vs_baseline": cap["speedup_x_vs_committed"],
        "gate_1p3x_vs_committed": cap["gate_1p3x"],
        "host_share": hostpath["host_overhead"]["host_share"],
        "hot_path_recompiles": hostpath["compiled_programs"]["hot_path_recompiles"],
        "accounting_exact": hostpath["accounting_exact"],
    }
