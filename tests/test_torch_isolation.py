"""The port stands alone: esac_tpu_torch and chip_smoke.py import no JAX,
no Flax, no Orbax and nothing of esac_tpu; its entry points never fall back
to the CPU quietly; its copies of the JAX package's config and presets
stay equal to the originals."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import pytest
import torch

from esac_tpu.cli import EXPERT_PRESETS as J_EXPERT_PRESETS
from esac_tpu.cli import GATING_PRESETS as J_GATING_PRESETS
from esac_tpu.ransac.config import SCORING_IMPLS as J_SCORING_IMPLS
from esac_tpu.ransac.config import RansacConfig as JRansacConfig
from esac_tpu_torch.models.presets import EXPERT_PRESETS, GATING_PRESETS
from esac_tpu_torch.ransac.config import SCORING_IMPLS, RansacConfig

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "optax", "ml_dtypes", "esac_tpu")


def _port_files():
    """The port's sources; ``esac_tpu_torch/build/`` holds build outputs
    (gitignored), not sources."""
    pkg = ROOT / "esac_tpu_torch"
    return sorted(p for p in pkg.rglob("*.py")
                  if (pkg / "build") not in p.parents) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_files_import_no_jax_or_reference_package():
    files = _port_files()
    assert len(files) > 20 and (ROOT / "chip_smoke.py") in files
    bad = {str(p.relative_to(ROOT)): sorted(_imported_roots(p) & set(FORBIDDEN))
           for p in files}
    assert not {k: v for k, v in bad.items() if v}, bad


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, importlib, pkgutil, esac_tpu_torch\n"
        "for m in pkgutil.walk_packages(esac_tpu_torch.__path__, 'esac_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_refuse_to_run_without_cuda(monkeypatch):
    """device=None means CUDA; without it every entry point raises instead
    of continuing on the CPU."""
    from esac_tpu_torch.ransac import esac, kernel
    from esac_tpu_torch.registry import serving
    from esac_tpu_torch.registry.manifest import ScenePreset

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    preset = ScenePreset(height=16, width=16, num_experts=1)
    gen = torch.Generator()
    calls = [
        lambda: serving.make_scene_bucket_fn(preset, RansacConfig()),
        lambda: serving.init_scene_params(preset),
        lambda: kernel.dsac_infer(gen, torch.zeros(4, 3), torch.zeros(4, 2), 1.0, [0, 0]),
        lambda: kernel.dsac_infer_frames([gen], torch.zeros(1, 4, 3), torch.zeros(4, 2),
                                         1.0, [0, 0]),
        lambda: esac.esac_infer(gen, torch.zeros(1), torch.zeros(1, 4, 3),
                                torch.zeros(4, 2), 1.0, [0, 0]),
        lambda: esac.esac_infer_frames([gen], torch.zeros(1, 1), torch.zeros(1, 1, 4, 3),
                                       torch.zeros(4, 2), 1.0, [0, 0]),
        lambda: serving.make_routed_scene_bucket_fn(preset, RansacConfig(), 1),
        lambda: esac.esac_infer_topk(gen, torch.zeros(1), torch.zeros(1, 4, 3),
                                     torch.zeros(4, 2), 1.0, [0, 0], k=1),
        lambda: esac.esac_infer_topk_frames([gen], torch.zeros(1, 1), torch.zeros(1, 1, 4, 3),
                                            torch.zeros(4, 2), 1.0, [0, 0], k=1),
        lambda: esac.esac_infer_routed_frames(
            [gen], torch.zeros(1, 1), torch.zeros(1, 1, 4, 3), torch.zeros(1, 1),
            torch.ones(1, 1), torch.zeros(4, 2), 1.0, [0, 0]),
        lambda: esac.esac_infer_prior(gen, torch.zeros(1), torch.zeros(1, 4, 3),
                                      torch.zeros(4, 2), 1.0, [0, 0], torch.zeros(2, 3),
                                      torch.zeros(2, 3), torch.zeros(2)),
        lambda: esac.esac_infer_frames_prior(
            [gen], torch.zeros(1, 1), torch.zeros(1, 1, 4, 3), torch.zeros(4, 2), 1.0, [0, 0],
            torch.zeros(1, 2, 3), torch.zeros(1, 2, 3), torch.zeros(1, 2)),
        lambda: esac.esac_infer_routed_frames_prior(
            [gen], torch.zeros(1, 1), torch.zeros(1, 1, 4, 3), torch.zeros(1, 1),
            torch.ones(1, 1), torch.zeros(4, 2), 1.0, [0, 0], torch.zeros(1, 2, 3),
            torch.zeros(1, 2, 3), torch.zeros(1, 2)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_config_and_presets_copies_equal_the_reference():
    assert SCORING_IMPLS == J_SCORING_IMPLS
    ours = {f.name: f.default for f in dataclasses.fields(RansacConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JRansacConfig)}
    assert ours == ref
    assert RansacConfig(use_pallas_scoring=True).scoring_impl == "pallas"
    with pytest.raises(ValueError):
        RansacConfig(scoring_impl="bogus")
    assert EXPERT_PRESETS == J_EXPERT_PRESETS
    assert GATING_PRESETS == J_GATING_PRESETS


def _defaults(cls):
    return {f.name: f.default for f in dataclasses.fields(cls)}


def test_slo_and_health_policies_equal_the_reference():
    from esac_tpu.registry.health import HealthPolicy as JHealthPolicy
    from esac_tpu.serve.slo import SLOPolicy as JSLOPolicy
    from esac_tpu_torch.registry.health import HealthPolicy
    from esac_tpu_torch.serve.slo import SLOPolicy

    assert _defaults(SLOPolicy) == _defaults(JSLOPolicy)
    assert _defaults(HealthPolicy) == _defaults(JHealthPolicy)


def _typed_errors(modules):
    out = {}
    for mod in modules:
        for name, obj in vars(mod).items():
            if isinstance(obj, type) and issubclass(obj, Exception) \
                    and obj.__module__ == mod.__name__:
                out[name] = (obj.wire_name, obj.retryable,
                             sorted(b.__name__ for b in obj.__mro__ if b is not obj
                                    and b.__module__.split(".")[0] != "builtins"))
    return out


def test_typed_errors_keep_the_reference_wire_names_and_retry_flags():
    """Every typed error of the ported serving and registry modules has the
    JAX package's wire_name, retryable flag and class tree."""
    from esac_tpu.registry import health as j_health
    from esac_tpu.registry import manifest as j_manifest
    from esac_tpu.serve import slo as j_slo
    from esac_tpu_torch.registry import health, manifest
    from esac_tpu_torch.serve import slo

    ours = _typed_errors([slo, health, manifest])
    ref = _typed_errors([j_slo, j_health, j_manifest])
    assert len(ours) == 12 and ours == ref


def test_fleet_tier_policies_and_configs_equal_the_reference():
    """The fleet slice's frozen knob sets keep the JAX package's defaults."""
    from esac_tpu.fleet import FleetPolicy as JFleetPolicy
    from esac_tpu.registry import PrefetchPolicy as JPrefetchPolicy
    from esac_tpu.retrieval import RetrievalPolicy as JRetrievalPolicy
    from esac_tpu.retrieval.model import RetrievalConfig as JRetrievalConfig
    from esac_tpu.serve import SessionPolicy as JSessionPolicy
    from esac_tpu_torch.fleet import FleetPolicy
    from esac_tpu_torch.registry.prefetch import PrefetchPolicy
    from esac_tpu_torch.retrieval import RetrievalConfig, RetrievalPolicy
    from esac_tpu_torch.serve import SessionPolicy

    pairs = [(SessionPolicy, JSessionPolicy), (FleetPolicy, JFleetPolicy),
             (PrefetchPolicy, JPrefetchPolicy), (RetrievalPolicy, JRetrievalPolicy),
             (RetrievalConfig, JRetrievalConfig)]
    for ours, ref in pairs:
        assert _defaults(ours) == _defaults(ref), ours.__name__


def test_fleet_tier_typed_errors_keep_the_reference_wire_names():
    from esac_tpu.fleet import router as j_router
    from esac_tpu.retrieval import errors as j_errors
    from esac_tpu.serve import session as j_session
    from esac_tpu_torch.fleet import router
    from esac_tpu_torch.retrieval import errors
    from esac_tpu_torch.serve import session

    ours = _typed_errors([router, errors, session])
    ref = _typed_errors([j_router, j_errors, j_session])
    assert len(ours) == 5 and ours == ref


def test_bench_entry_points_refuse_to_run_without_cuda(monkeypatch, capsys):
    """The bench's measure functions, its pipeline and host-path profile run
    on the card by default and raise without one; the two command lines
    exit non-zero without a line."""
    from esac_tpu_torch import bench
    from esac_tpu_torch.bench import accuracy, pipeline
    from esac_tpu_torch.tools import hostpath_profile

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [measure for measure, _ in bench.MODES.values()]
    calls += [pipeline.measure_pipeline, hostpath_profile.profile]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    for mode in [None, "streaming", *bench.MODES]:
        assert bench.main([] if mode is None else [mode]) == 2
    assert accuracy.main([]) == 2
    assert capsys.readouterr().out == ""
