"""A configuration of another architecture gets cells from data files and
entries alone: a copy of BENCHMARK.json and ``portbench/`` gains a
tiny-width ``vanilla`` configuration (the plain generator with the sbert
text path, ``"reference": "plain"``), its ``serve.patch`` and
``train.eager`` cells and their limits files (v2's), and nothing else. Each
cell runs through ``run.run_cell`` on the CPU in a process of its own on
the copy: it comes out ``correct``, its reference following the program to
rounding, and not ``correct`` where the program's plain decoder skips the
BatchNorm of its last ConvTranspose block. With both learning rates 0 the
reference follows the program's train steps to rounding."""

import dataclasses
import filecmp
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from harness.compare import train_numbers

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[2]
CELLS = {"vanilla.serve.patch": "serve.patch",
         "vanilla.train.eager": "train.eager"}
LIMITS = {"vanilla.serve.patch": "v2.serve.patch",
          "vanilla.train.eager": "v2.train.graphs"}
TINY = dict(patch_h=32, patch_w=64, enc_chans=[8, 16, 24, 32], z_ch=16,
            text_ch=16, compute_dtype="float32")

# Runs one cell of the copy in the working directory; argv: the program's
# checkout, the cell, the seed, "sound" or "fault".
DRIVER = r'''
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path.cwd() / "portbench"), str(Path.cwd())]
sys.path.append(sys.argv[1])
import torch

torch.set_num_threads(2)
if sys.argv[4] == "fault":
    from vae_gan_mark_tpu_torch.models.decoders import PlainDecoder

    def skip_last_norm(self, zc):
        skip = len(self.decode) - 4     # the last block's BatchNorm
        for i, layer in enumerate(self.decode):
            if i != skip:
                zc = layer(zc)
        return zc
    PlainDecoder.forward = skip_last_norm
import run
from harness import manifest

out = run.run_cell(manifest.Cell(sys.argv[2]), int(sys.argv[3]), 1.0, False,
                   torch.device("cpu"), 0)
print(json.dumps({"correct": out["correct"], "failed": out["failed"],
                  "checks": out["checks"],
                  "numbers": out["extra"]["numbers"]}))
'''


def vanilla_config() -> dict:
    from vae_gan_mark_tpu_torch.config import VARIANTS
    cfg = dataclasses.asdict(VARIANTS["vanilla"])
    cfg.update(TINY, variant="vanilla", reference="plain",
               source="Andrey1408/vae-gan-mark vae-gan.py, at tiny widths")
    return cfg


def add_vanilla(root: Path) -> None:
    """The data files and the entries of the new configuration's cells."""
    bench_dir = root / "portbench"
    (bench_dir / "configs" / "vanilla.json").write_text(
        json.dumps(vanilla_config(), indent=1))
    for cell, parent in LIMITS.items():
        shutil.copy(bench_dir / "limits" / f"{parent}.json",
                    bench_dir / "limits" / f"{cell}.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "vanilla", "source": "Andrey1408/vae-gan-mark vae-gan.py",
        "file": "portbench/configs/vanilla.json",
        "reduced": sorted(TINY), "why": "the plain generator, sbert text"})
    for cell, traffic in CELLS.items():
        bench["workloads"].append({
            "name": cell, "config": "vanilla", "traffic": traffic,
            "chips": 1, "why": "the plain generator's " + traffic})
    kind = {"train_img_per_s": "vanilla.train.eager",
            "serve_img_per_s": "vanilla.serve.patch",
            "serve_p95_ms": "vanilla.serve.patch"}
    for m in bench["end_to_end"]:
        if m["name"] in kind:
            m["workloads"].append(kind[m["name"]])
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


def copy_with_vanilla(tmp_path: Path) -> Path:
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    add_vanilla(tmp_path)
    return tmp_path


def harness_files(bench_dir: Path):
    return {p.relative_to(bench_dir).as_posix() for p in bench_dir.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_the_copy_only_adds_data_files(tmp_path):
    root = copy_with_vanilla(tmp_path)
    tree, copy = ROOT / "portbench", root / "portbench"
    tree_files = harness_files(tree)
    assert harness_files(copy) - tree_files == {
        "configs/vanilla.json", "limits/vanilla.serve.patch.json",
        "limits/vanilla.train.eager.json"}
    for rel in tree_files:
        assert filecmp.cmp(tree / rel, copy / rel, shallow=False), rel


def run_copy(root: Path, cell: str, mode: str) -> dict:
    driver = root / "driver.py"
    driver.write_text(DRIVER)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(driver), str(ROOT), cell, str(2 ** 31 + 29),
         mode], cwd=root, env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(tmp_path, cell):
    out = run_copy(copy_with_vanilla(tmp_path), cell, "sound")
    assert out["correct"] and out["failed"] == 0, out["checks"]
    numbers = out["numbers"]
    if cell.endswith("serve.patch"):
        assert numbers["patch_max_gap"]["value"] < 1e-5
    else:
        assert numbers["text_grad_gap"]["leaf"].startswith("G.text_encoder.")
        assert "val_perc_gap" not in numbers     # full_loss_val is off


def test_reference_follows_the_program_train_steps(tiny_cell):
    """As for the char U-Nets (test_portbench_reference.py): with both
    learning rates 0 every checked number is rounding."""
    from harness import manifest, train_cell
    cell = tiny_cell("oldv.train.eager")
    cell.config = dict(vanilla_config(), lr_g=0.0, lr_d=0.0)
    cell.reference = manifest.reference_module(cell.config)
    trainer, train, _ = train_cell.build_trainer(cell, 2 ** 31 + 11, CPU)
    prog = train_cell.checked_steps(cell, trainer, train)
    ref = train_cell.reference_steps(cell, 2 ** 31 + 11, CPU)
    numbers = train_numbers(prog, ref)
    for key in ("loss_gap", "grad_gap", "text_grad_gap", "val_gap"):
        assert numbers[key]["value"] < 1e-5, (key, numbers[key])
    assert numbers["change_gap"]["value"] == 0.0


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_planted_decoder_fault_is_not_correct(tmp_path, cell):
    out = run_copy(copy_with_vanilla(tmp_path), cell, "fault")
    assert not out["correct"], out["checks"]
