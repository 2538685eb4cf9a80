"""The port's bench modes chaos, fleet, scoring and sessions on the CPU: each
prints one JSON line whose payload has the keys of ``bench.py``'s committed
artifact for that mode, and writes only its own artifact.

The case itself is tests/torch_bench_modes_cases.py's (one shared helper
for the three files of mode groups)."""

import pytest

import torch_bench_modes_cases as cases


@pytest.mark.parametrize("mode", cases.GROUPS["test_torch_bench_modes_fleet.py"])
def test_mode_runs_on_the_cpu_with_the_jax_payload_keys(mode, tmp_path, monkeypatch):
    cases.run_mode_case(mode, tmp_path, monkeypatch)
