"""What the benchmark imports, by top-level module name compared whole: no
file under regbench/ imports JAX or the JAX package, the reference imports
nothing of the program either, and a run loads none of them."""

from __future__ import annotations

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "regbench"
JAX = {"jax", "jaxlib", "flax", "kss_icp_tpu"}


def imported_top_levels(path: Path) -> set:
    """The top-level names of every module a file imports (absolute imports)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(node.args[0].value.split(".")[0])
    return names


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def test_top_levels_are_compared_whole():
    # The port's name begins with the JAX package's: only the whole name counts.
    assert "kss_icp_torch" not in JAX and "kss_icp_torch".startswith("kss_icp_t")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax(path):
    assert not imported_top_levels(path) & JAX


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not imported_top_levels(path) & (JAX | {"kss_icp_torch", "regbench"})


def test_reference_loads_nothing_of_the_program():
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(ROOT)!r})
        import regbench.reference.registration
        print(sorted({{m.split('.')[0] for m in sys.modules}} & set({sorted(JAX | {"kss_icp_torch"})!r})))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a_run_loads_no_jax():
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(ROOT)!r})
        from regbench import harness
        from regbench.tests.small import small_spec
        harness.run("objects.full-overlap.b64", 5, 0.1, False, device="cpu",
                    spec=small_spec("objects.full-overlap.b64"))
        print(harness.forbidden_modules())
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
