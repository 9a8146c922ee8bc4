"""The port imports no JAX: no module under avmoe_tpu_torch/, not
chip_smoke.py, not the port's chip tools under tools/ and not the test
helper chip_smoke.py imports import jax, flax, optax or the JAX package
avmoe_tpu (avmoe_tpu_torch itself is allowed).
Nor does any of them import pandas, which the card's machine lacks, or PIL
at import time (the readers import it where they decode an image)."""

from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "avmoe_tpu", "pandas"}
IMPORT_TIME_FORBIDDEN = {"PIL", "matplotlib"}
SOURCES = sorted((ROOT / "avmoe_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "k1b_variants.py",
    ROOT / "tools" / "k2_tile_variants.py", ROOT / "tools" / "k2b_bit_check.py",
    ROOT / "tools" / "k2b_wgmma_variants.py", ROOT / "tools" / "k3_phase_ablation.py",
    ROOT / "tools" / "train_grad_conditioning.py", ROOT / "tools" / "frozen_backward_parent.py",
    ROOT / "tools" / "s4_grad_diagnosis.py", ROOT / "tools" / "s4_train_curve.py",
    ROOT / "tools" / "cli_seed_init_grads.py",
    ROOT / "tests" / "torch_reference_layout.py"]     # a test helper chip_smoke.py imports


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


def _import_time_roots(tree: ast.Module):
    """The imports that run when the module is imported: every statement
    outside a function's or a lambda's body (under if / try included)."""
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            yield from _imported_roots(node)
            continue
        stack.extend(ast.iter_child_nodes(node))


def test_sources_found():
    assert len(SOURCES) > 20
    pkg = ROOT / "avmoe_tpu_torch"
    for mod in ("models/ave.py", "kernels/block_chain.py", "data/avvp.py", "data/avqa.py",
                "data/avs.py", "models/avqa_grounding.py", "cli/train_avvp.py",
                "cli/train_avqa.py", "cli/train_avs.py", "metrics/avs.py", "utils/runtime.py",
                "checkpoint/convert.py", "audio/kaldi.py", "cli/compute_audio_stats.py",
                "cli/preprocess.py"):
        assert pkg / mod in SOURCES, mod


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, mod) for line, mod in _imported_roots(tree) if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_pil_import_at_import_time(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, mod) for line, mod in _import_time_roots(tree)
           if mod in IMPORT_TIME_FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad} when it is imported"


def test_importing_every_module_loads_none_of_them():
    """Every module of the package and chip_smoke.py, imported in a fresh
    interpreter, leave jax, the JAX package, pandas and PIL unloaded."""
    code = ("import importlib, pkgutil, sys, avmoe_tpu_torch\n"
            "for m in pkgutil.walk_packages(avmoe_tpu_torch.__path__, 'avmoe_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "import chip_smoke\n"
            "print(sorted({k.split('.')[0] for k in sys.modules} & {'jax', 'flax', 'optax', "
            "'avmoe_tpu', 'pandas', 'PIL'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_guard_catches_a_jax_import():
    tree = ast.parse("import jax.numpy as jnp\nfrom avmoe_tpu.ops import swin\n"
                     "from avmoe_tpu_torch.ops import swin\n")
    assert [m for _, m in _imported_roots(tree)] == ["jax", "avmoe_tpu", "avmoe_tpu_torch"]
    tree = ast.parse("from PIL import Image\ntry:\n    import pandas\nexcept ImportError:\n"
                     "    pass\ndef f():\n    import cv2\n")
    assert sorted(m for _, m in _import_time_roots(tree)) == ["PIL", "pandas"]
