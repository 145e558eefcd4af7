"""Whole top-level module names: nothing under bench/ imports JAX, jaxlib,
flax or the JAX package ``repro`` (``repro_torch`` begins with ``repro``,
so names are compared whole), and bench/reference/ imports nothing of the
program (``repro_torch``) nor of the harness that drives it."""
import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
JAX_NAMES = {"jax", "jaxlib", "flax", "repro"}


def _top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_under_bench_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not (_top_level_imports(f) & JAX_NAMES), f


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        assert not _top_level_imports(f) & ({"repro_torch", "harness"} | JAX_NAMES), f


def test_whole_names_tell_the_port_from_the_jax_package():
    src = "import repro_torch.core\nfrom repro_torch import serving\n"
    tree = ast.parse(src)
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names} | {n.module.split(".")[0] for n in ast.walk(tree)
                                  if isinstance(n, ast.ImportFrom)}
    assert names == {"repro_torch"} and not names & JAX_NAMES


def test_loading_the_harness_and_the_references_loads_no_jax():
    code = ("import sys; sys.path[:0] = [{src!r}, {bench!r}];"
            "import harness.cell, harness.stack, harness.trace, reference.lm;"
            "import repro_torch.serving.service, repro_torch.serving.engine;"
            "bad = {{m.split('.')[0] for m in sys.modules}} & {names!r};"
            "assert not bad, bad").format(src=str(BENCH.parent / "src"), bench=str(BENCH),
                                          names=JAX_NAMES)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
