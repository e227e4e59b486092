"""The PyTorch port stands alone: nothing in ``dstack_tpu_torch/`` or
``chip_smoke.py`` imports JAX or the JAX package (``dstack_tpu``), nor a
package the card's machine lacks that only the JAX side's checkpointing
used (``safetensors``, ``orbax``, ``ml_dtypes``), and the chip smoke
script refuses to run without a card or outside a checkout."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "dstack_tpu", "safetensors", "orbax",
             "ml_dtypes")
PORT = ROOT / "dstack_tpu_torch"
# build/ holds compiled kernels (and nothing git tracks): not the port's code
PORT_FILES = sorted(p for p in PORT.rglob("*.py")
                    if "build" not in p.relative_to(PORT).parts) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


def test_forbidden_matches_the_package_not_the_port():
    assert _forbidden("dstack_tpu.serving.engine")
    assert _forbidden("jax.numpy")
    assert _forbidden("safetensors.torch") and _forbidden("ml_dtypes")
    assert _forbidden("orbax.checkpoint")
    assert not _forbidden("dstack_tpu_torch.serving.engine")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_file_imports_no_jax(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert bad == [], f"{path.relative_to(ROOT)} imports {bad}"


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Run from a directory that holds only the script: no card here and no
    package beside it, so it must exit non-zero and print no result."""
    script = tmp_path / "chip_smoke.py"
    script.write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
