"""A reader of the program's own counters comes from a new file and a
``per_layer`` entry alone: a copy of BENCHMARK.json and ``portbench/``
gains ``metrics/rows_computed.serve.py``, which reads the counter
``serve.rows_computed``, and its entry for ``v2.serve.patch``, and nothing
else. A traced run of the cell at a tiny geometry through ``run.run_cell``
on the CPU, in a process of its own on the copy (a stand-in for
``trace.DeviceTrace``, which traces no card here), reports the counter's
change over the traced requests."""

import filecmp
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CELL = "v2.serve.patch"
READER = '''"""rows_computed.serve (rows): the rows the engine computed in the
profiled slice (the program's counter)."""


def read(run):
    return run.counters.get("serve.rows_computed")
'''

# Runs the cell traced on the copy in the working directory; argv: the
# program's checkout, the seed.
DRIVER = r'''
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path.cwd() / "portbench"),
                str(Path.cwd() / "portbench" / "tests"), str(Path.cwd())]
sys.path.append(sys.argv[1])
import torch

torch.set_num_threads(2)
import run
from conftest import make_tiny
from harness import trace


class StandInTrace:
    def start(self):
        self.t = trace.now_ns()

    def stop(self):
        return [trace.Event("stand_in_kernel", self.t, self.t + 1000)]


trace.DeviceTrace = StandInTrace
cell = make_tiny("v2.serve.patch")
out = run.run_cell(cell, int(sys.argv[2]), 1.0, True, torch.device("cpu"), 0)
print(json.dumps({"correct": out["correct"], "metrics": out["metrics"],
                  "traffic": cell.traffic}))
'''


def harness_files(bench_dir: Path):
    return {p.relative_to(bench_dir).as_posix() for p in bench_dir.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def copy_with_reader(tmp_path: Path) -> Path:
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "portbench" / "metrics" / "rows_computed.serve.py"
     ).write_text(READER)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "rows_computed.serve", "unit": "rows", "better": "higher",
        "source": "program_counter",
        "layer": "serve/engine.py and serve/chunks.py",
        "moves": "serve_img_per_s", "workloads": [CELL]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp_path


def test_a_new_counter_reader_needs_no_harness_edit(tmp_path):
    root = copy_with_reader(tmp_path)
    tree, copy = ROOT / "portbench", root / "portbench"
    tree_files = harness_files(tree)
    assert harness_files(copy) - tree_files == {
        "metrics/rows_computed.serve.py"}
    for rel in tree_files:
        assert filecmp.cmp(tree / rel, copy / rel, shallow=False), rel

    (root / "driver.py").write_text(DRIVER)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "driver.py", str(ROOT), str(2 ** 31 + 41)],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"]
    tr = out["traffic"]
    assert out["metrics"]["rows_computed.serve"] == {
        "value": float(tr["trace_requests"] * tr["engine_batch"]),
        "unit": "rows"}
