"""``run.py`` without a card: it exits non-zero and prints no result, in
the checkout and in a directory that holds only BENCHMARK.json and
``portbench/``; and so does a cell whose configuration names no reference
module that is there, before it looks for a card."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "v2.train.graphs", "--seed", "2147483651",
        "--seconds", "2", "--trace", "0"]


def _run(cwd: Path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_VISIBLE_DEVICES",)}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def _no_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if "correct" in json.loads(line):
                return False
        except (ValueError, TypeError):
            continue
    return True


def _copy(tmp_path: Path) -> Path:
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def test_no_card_no_result():
    proc = _run(ROOT)
    assert proc.returncode != 0
    assert _no_result(proc.stdout)
    assert "CUDA" in proc.stderr


def test_only_the_benchmark_files(tmp_path):
    proc = _run(_copy(tmp_path))
    assert proc.returncode != 0
    assert _no_result(proc.stdout)


@pytest.mark.parametrize("reference", [None, "no_such_module"],
                         ids=["no_key", "missing_module"])
def test_config_without_its_reference_fails(tmp_path, reference):
    root = _copy(tmp_path)
    path = root / "portbench" / "configs" / "v2.json"
    cfg = json.loads(path.read_text())
    del cfg["reference"]
    if reference is not None:
        cfg["reference"] = reference
    path.write_text(json.dumps(cfg))
    proc = _run(root)
    assert proc.returncode != 0
    assert _no_result(proc.stdout)
    assert "reference" in proc.stderr and "device(s)" not in proc.stderr


def test_unknown_workload_fails():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "nope", "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and _no_result(proc.stdout)


@pytest.mark.parametrize("value", ["x", "2"])
def test_bad_trace_flag_fails(value):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "v2.serve.patch",
         "--seed", "1", "--seconds", "1", "--trace", value], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and _no_result(proc.stdout)
