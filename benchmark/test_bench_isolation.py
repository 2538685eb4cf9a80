"""Nothing a run loads imports JAX, jaxlib, Flax, orbax or the JAX package
``esac_tpu``, judged by the whole top-level module name (``esac_tpu_torch``
begins with ``esac_tpu`` and is the program)."""

import ast
import json
import pathlib
import subprocess
import sys

from benchmark import harness

HERE = pathlib.Path(__file__).resolve().parent


def test_whole_top_level_names():
    assert harness.forbidden_modules(["esac_tpu_torch", "esac_tpu_torch.serve",
                                      "jaxtyping", "flaxen", "numpy"]) == []
    assert harness.forbidden_modules(["esac_tpu.ransac", "jax.numpy", "flax",
                                      "orbax.checkpoint", "jaxlib"]) == [
        "esac_tpu", "flax", "jax", "jaxlib", "orbax"]


def test_sources_import_no_forbidden_package():
    for path in HERE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in harness.FORBIDDEN, (path, n)


def test_a_run_loads_no_forbidden_module():
    """Import everything a run imports -- the harness, the generators, the
    readers and the program's serving path -- in a fresh interpreter and
    list what got loaded."""
    code = """
import json, sys
sys.path.insert(0, %r)
from benchmark import harness, spec, system, control, sweep
import esac_tpu_torch.registry.serving, esac_tpu_torch.serve.dispatcher
bench = json.load(open(%r))
for w in bench["workloads"]:
    wl = spec.load(w["name"])
    spec.generator(wl.mix["generator"])
    for m in wl.per_layer:
        spec.reader(m["name"])
print(json.dumps(sorted(sys.modules)))
""" % (str(HERE.parent), str(HERE.parent / "BENCHMARK.json"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=HERE.parent)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "esac_tpu_torch" in loaded
    assert harness.forbidden_modules(loaded) == []
