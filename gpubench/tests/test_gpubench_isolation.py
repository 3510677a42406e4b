"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program: checked on the modules a fresh
interpreter holds after the imports, and on every import statement of
``gpubench/**/*.py`` by its top-level name, compared whole (the port's
name begins with the JAX package's)."""
import ast
import subprocess
import sys

import pytest

from harness import spec

JAX = {"jax", "jaxlib", "flax", "kiri_tpu"}
PROGRAM = "kiri_tpu_torch"


def loaded_after(code: str) -> set:
    prog = (f"import sys; sys.path[:0] = [{str(spec.HERE)!r}, "
            f"{str(spec.ROOT)!r}]\n{code}\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=300, check=True)
    return set(out.stdout.split())


def test_run_and_program_load_no_jax():
    names = loaded_after(
        "import run, control\n"
        "from harness import cell, entries, spec, trace\n"
        "import kiri_tpu_torch.engine, kiri_tpu_torch.pipeline")
    assert PROGRAM in names
    assert not names & JAX


def test_reference_loads_no_program():
    names = loaded_after(
        "from reference import check, detector, judge, recognizer, "
        "tokens, weights")
    assert not names & (JAX | {PROGRAM})


def imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


FILES = sorted(p for p in spec.HERE.rglob("*.py")
               if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: p.relative_to(spec.HERE).as_posix())
def test_imports(path):
    names = set(imports(path))
    assert not names & JAX
    if "reference" in path.relative_to(spec.HERE).parts:
        assert PROGRAM not in names


def test_whole_name_comparison():
    # The port's name starts with the JAX package's: a prefix test would
    # refuse it, a whole-name test must not.
    assert PROGRAM.startswith("kiri_tpu") and PROGRAM not in JAX
