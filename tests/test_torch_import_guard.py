"""The port imports no JAX: no module under avmoe_tpu_torch/, not
chip_smoke.py and not the port's chip tools under tools/ import jax, flax,
optax or the JAX package avmoe_tpu (avmoe_tpu_torch itself is allowed)."""

from __future__ import annotations

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "avmoe_tpu"}
SOURCES = sorted((ROOT / "avmoe_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "k1b_variants.py",
    ROOT / "tools" / "k2_tile_variants.py", ROOT / "tools" / "k2b_bit_check.py",
    ROOT / "tools" / "k2b_wgmma_variants.py", ROOT / "tools" / "k3_phase_ablation.py",
    ROOT / "tools" / "train_grad_conditioning.py", ROOT / "tools" / "frozen_backward_parent.py",
    ROOT / "tools" / "s4_grad_diagnosis.py", ROOT / "tools" / "s4_train_curve.py"]


def _imported_roots(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.lineno, str(node.args[0].value).split(".")[0]


def test_sources_found():
    assert len(SOURCES) > 20
    assert (ROOT / "avmoe_tpu_torch" / "models" / "ave.py") in SOURCES
    assert (ROOT / "avmoe_tpu_torch" / "kernels" / "block_chain.py") in SOURCES


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, mod) for line, mod in _imported_roots(tree) if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_guard_catches_a_jax_import():
    tree = ast.parse("import jax.numpy as jnp\nfrom avmoe_tpu.ops import swin\n"
                     "from avmoe_tpu_torch.ops import swin\n")
    assert [m for _, m in _imported_roots(tree)] == ["jax", "avmoe_tpu", "avmoe_tpu_torch"]
