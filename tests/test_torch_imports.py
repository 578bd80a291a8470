"""The port, chip_smoke.py, the port's tools (``tools/torch_*.py``) and
the cases they share import nothing of JAX or the JAX package."""

import ast
import glob
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "vit_marl_tpu"}
FILES = sorted(glob.glob(os.path.join(ROOT, "vit_marl_tpu_torch", "**",
                                      "*.py"), recursive=True)
               + sorted(glob.glob(os.path.join(ROOT, "tools", "torch_*.py")))
               + [os.path.join(ROOT, "chip_smoke.py"),
                  os.path.join(ROOT, "tests", "torch_cases.py")])


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_the_walk_sees_the_package():
    assert len(FILES) > 15
    for mod in ("ops/book_kernel.py", "ops/attention_kernel.py",
                "ops/block_kernel.py", "models/vit.py", "utils/cli.py",
                "env/world.py", "env/execution.py"):
        assert any(p.endswith(mod) for p in FILES), mod
    tools = [p for p in FILES if os.path.dirname(p).endswith("tools")]
    assert len(tools) >= 9
    for tool in ("torch_fuzz_engine.py", "torch_kernel_bench.py",
                 "torch_profile_vit.py"):
        assert any(p.endswith(tool) for p in tools), tool
