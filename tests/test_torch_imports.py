"""The port stands alone: no module of ``src/repro_torch`` (nor
``chip_smoke.py``, nor the port's ``examples/torch_*.py``) imports ``jax``
or the reference package, importing the serving stack and its gateway
leaves ``jax`` out of ``sys.modules``, and every module
imports without ``triton``, ``nvcc`` or a CUDA device (kernels build on
first use, never at import)."""
import ast
import importlib
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "triton")


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    + sorted((ROOT / "examples").glob("torch_*.py")),
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_or_reference_import(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_serving_stack_import_leaves_jax_out():
    code = (
        "import sys, repro_torch, repro_torch.serving.service, repro_torch.core, "
        "repro_torch.serving.engine, repro_torch.models.ssm, repro_torch.kernels.ssd_scan, "
        "repro_torch.distributed.sharded_read, repro_torch.launch.mesh, "
        "repro_torch.gateway, repro_torch.gateway.traffic, repro_torch.launch.serve; "
        "assert 'jax' not in sys.modules, 'jax imported'; "
        "assert 'repro' not in sys.modules, 'repro imported'; "
        "assert 'triton' not in sys.modules, 'triton imported'"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_every_module_imports_without_a_build():
    import repro_torch
    from repro_torch.kernels.decode_attention import kernel as decode
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.similarity_topk import kernel as topk
    from repro_torch.kernels.ssd_scan import kernel as ssd

    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
    assert "repro_torch.serving.service" in names and len(names) > 25
    assert "repro_torch.models.ssm" in names and "repro_torch.kernels.ssd_scan.kernel" in names
    assert "repro_torch.distributed.sharded_read" in names and "repro_torch.launch.mesh" in names
    gateway = {f"repro_torch.gateway.{m}" for m in
               ("protocol", "errors", "http", "client", "app", "traffic")}
    assert gateway <= set(names) and "repro_torch.launch.serve" in names
    for name in names:
        importlib.import_module(name)
    if not torch.cuda.is_available():
        for kernel in (topk, flash, decode, ssd):
            assert not kernel.LIB.loaded  # nothing was compiled or loaded


def test_port_examples_exist_beside_the_reference():
    ported = {p.name for p in (ROOT / "examples").glob("torch_*.py")}
    assert ported == {f"torch_{n}.py" for n in (
        "quickstart", "async_service", "http_gateway", "serve_with_cache",
        "hierarchical_multipod", "adaptive_tuning")}
