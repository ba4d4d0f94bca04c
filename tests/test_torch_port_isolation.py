"""The port stands alone: neither ``vae_gan_mark_tpu_torch`` nor
``chip_smoke.py`` imports JAX, Flax, Orbax or any module of the JAX package
``vae_gan_mark_tpu``. (The package names share a prefix, so the checks
match the module name ``vae_gan_mark_tpu`` or the prefix
``vae_gan_mark_tpu.``, never the bare prefix.)

The import check runs in a fresh interpreter, because this test process has
JAX loaded already (tests/conftest.py imports it)."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "vae_gan_mark_tpu_torch"
FORBIDDEN_ROOTS = ("jax", "jaxlib", "flax", "orbax", "optax",
                   "vae_gan_mark_tpu")


def forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN_ROOTS


def test_forbidden_matches_names_not_prefixes():
    assert forbidden("vae_gan_mark_tpu") and forbidden("vae_gan_mark_tpu.ops")
    assert forbidden("jax.numpy") and forbidden("flax.linen")
    assert not forbidden("vae_gan_mark_tpu_torch.ops.gru")
    assert not forbidden("jaxtyping_like") and not forbidden("torch")


def test_importing_the_whole_port_loads_no_jax():
    script = """
import importlib, json, pkgutil, sys
import vae_gan_mark_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"imported": names, "loaded": sorted(sys.modules)}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    for module in ("serve.engine", "ops.gru", "train.step",
                   "models.discriminator", "ops.conv_probe"):
        assert f"vae_gan_mark_tpu_torch.{module}" in result["imported"]
    bad = [m for m in result["loaded"] if forbidden(m)]
    assert not bad, bad


def imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                raise AssertionError(f"{path}: relative import")
            yield node.module


def test_no_source_file_names_a_forbidden_module():
    files = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in imported_modules(f) if forbidden(m)]
    assert not bad, bad
