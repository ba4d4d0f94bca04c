"""No module of the benchmark imports JAX, flax or the JAX package, judged
by each import's top-level name compared whole (the port's name starts
with the JAX package's); the reference also imports nothing of the
program under test."""

import ast
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "vae_gan_mark_tpu"}
MODULES = sorted(p.relative_to(BENCH_DIR).as_posix()
                 for p in BENCH_DIR.rglob("*.py"))


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


@pytest.mark.parametrize("rel", MODULES)
def test_no_jax(rel):
    found = set(top_level_imports(BENCH_DIR / rel)) & FORBIDDEN
    assert not found, f"{rel} imports {found}"


@pytest.mark.parametrize("rel", [m for m in MODULES
                                 if m.startswith("reference/")])
def test_reference_imports_nothing_of_the_program(rel):
    names = set(top_level_imports(BENCH_DIR / rel))
    assert "vae_gan_mark_tpu_torch" not in names
    # hashlib: plain.py's own copy of the program's sentence pseudo-embedding
    assert names <= {"__future__", "hashlib", "math", "typing", "numpy",
                     "torch", "reference"}, names


def test_the_check_compares_whole_names():
    from harness.common import FORBIDDEN as RUNTIME
    assert set(RUNTIME) == FORBIDDEN
    assert "vae_gan_mark_tpu_torch".split(".", 1)[0] not in RUNTIME
