"""No run loads JAX or the JAX package, and the reference loads nothing
of the program: top-level module names compared whole, in fresh
interpreters."""
import json
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rec_now_tpu")


def _modules(code: str):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_pb_run_and_reference_load_no_jax():
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r}); sys.path.insert(0, {str(ROOT / 'tests')!r})
from conftest import small_cell
cell = small_cell()
out = cell.driver().run(cell)
assert out["correct"], out["checks"]
print(json.dumps(sorted(sys.modules)))
"""
    tops = {m.split(".", 1)[0] for m in _modules(code)}
    assert "rec_now_tpu_torch" in tops
    assert not tops & set(FORBIDDEN)


def test_pb_reference_loads_nothing_of_the_program():
    code = f"""
import importlib.util, json, sys
sys.path.insert(0, {str(ROOT / 'reference')!r})
import plain
for name in ("xdeepfm-criteo",):
    spec = importlib.util.spec_from_file_location(
        name.replace("-", "_"), {str(ROOT / 'reference')!r} + "/" + name + ".py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted(sys.modules)))
"""
    tops = {m.split(".", 1)[0] for m in _modules(code)}
    assert "torch" in tops
    assert not tops & (set(FORBIDDEN) | {"rec_now_tpu_torch"})


def test_pb_forbidden_compares_whole_names():
    import harness
    sys.modules["rec_now_tpu_torch_probe"] = object()
    try:
        assert "rec_now_tpu_torch_probe" not in harness.forbidden_loaded()
    finally:
        del sys.modules["rec_now_tpu_torch_probe"]
