"""No benchmark module loads JAX or the JAX package (compared by whole
top-level names), and the reference loads nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "cholesky_tpu"}


def loaded_after(code):
    """The top-level names of the modules loaded by a fresh interpreter
    after running ``code`` from the repository's root."""
    probe = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); {code}; "
             "import json; print(json.dumps(sorted({m.split('.')[0] "
             "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_every_harness_module_loads_no_jax():
    code = ("from benchmark import harness, census, compare, faults, "
            "inputs, kernel_time, readings, traffic; "
            "import benchmark.reference.gp, benchmark.reference.lapack; "
            "[harness.load(k, p.stem) for k in ('calls', 'metrics', "
            "'counts') for p in (harness.BENCH / k).glob('*.py') "
            "if p.stem != '__init__']")
    names = loaded_after(code)
    assert "cholesky_tpu_torch" in names      # the program is loaded
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = loaded_after("import benchmark.reference.gp, "
                         "benchmark.reference.lapack")
    assert not names & (FORBIDDEN | {"cholesky_tpu_torch"})


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not set(tops) & (FORBIDDEN | {"cholesky_tpu_torch"}), \
                f"{path.name} imports {tops}"


def test_a_run_refuses_a_loaded_jax_module():
    from benchmark import harness

    sys.modules["jax"] = sys  # any module object under the name
    try:
        assert harness.loaded_forbidden() == ["jax"]
    finally:
        del sys.modules["jax"]
    # a name that only begins with a forbidden one is not forbidden
    assert "cholesky_tpu_torch" not in harness.loaded_forbidden()
