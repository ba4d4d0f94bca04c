"""On a card: a short run of every cell prints a last line that meets the
benchmark's contract. Skips where there is no card (decided inside the
test)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return torch.cuda.get_device_name(0)


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_meets_the_contract(cell, trace):
    kind = _card()
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 17 + trace), "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(out)
    assert out["correct"] is True, out["checks"]
    assert list(out)[-1] == "checks"
    dev = out["device"]
    assert dev["platform"] == "gpu" and dev["kind"] == kind
    assert dev["count"] == 1 and dev["memory_peak_bytes"] > 0
    wanted = {m["name"] for m in (BENCH["per_layer"] if trace
                                  else BENCH["end_to_end"])
              if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) == wanted
    for name, m in out["metrics"].items():
        # An eager cell replays nothing: its replayed share reads 0.
        assert m["value"] > 0 or "idle" in name or \
            name.startswith("replayed_share"), (name, m)
        if "roofline" in name or "mfu" in name:
            assert m["value"] <= 105.0
    if trace:
        assert 0 < dev["busy_s"] <= dev["window_s"]
        assert len(out["breakdown"]["device_ops"]) <= 10
        # No CUDA-graph capture inside the slice that the readers read.
        assert out["graph_captures_in_slice"] == 0
    last_err = proc.stderr.strip().splitlines()[-len(out["checks"]):]
    assert all(line.startswith("check ") for line in last_err)
