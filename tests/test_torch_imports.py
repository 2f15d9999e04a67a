"""The port stands alone: no file under ``src/repro_torch/`` imports ``jax``
or anything of the JAX package ``repro``, and every module of the port
imports in a process where both are blocked."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == \
                "import_module" and node.args and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_port_has_modules():
    assert "core/spec_decode.py" in FILES and "kernels/ops.py" in FILES


def test_port_has_the_training_path():
    assert {"training/optimizer.py", "training/train_step.py", "training/data.py",
            "training/checkpoint.py", "launch/train.py", "kernels/flash_attn.py",
            "kernels/rmsnorm.py", "configs/internlm2_1_8b.py"} <= set(FILES)


def test_port_has_the_mamba2_path():
    assert {"models/mamba2.py", "configs/mamba2_1_3b.py", "kernels/ssd_chunk.py"} <= set(FILES)
    assert (PORT / "kernels" / "csrc" / "ssd_chunk.cu").is_file()


@pytest.mark.parametrize("rel", FILES)
def test_file_imports_neither_jax_nor_repro(rel):
    tree = ast.parse((PORT / rel).read_text(), filename=rel)
    bad = [m for m in _imported(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{rel} imports {bad}"


def test_every_module_imports_with_jax_and_repro_blocked():
    mods = ["repro_torch." + rel[:-3].replace("/", ".").removesuffix(".__init__")
            for rel in FILES]
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
            "               for k, v in sys.modules.items() if v is not None)\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]
