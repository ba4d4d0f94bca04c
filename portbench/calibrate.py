"""Readings that the limits of ``correct`` are set from, on the card at the
cells' own sizes (not part of a benchmark run).

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--seconds 3] [--out FILE]

For each seed of ``--seeds``, the program's numbers against the reference
(training: the checked epochs and validation; serving: a short window at
the cell's own load, with the same sample as a run). For each seed of
``--control-seeds``, the control's: the reference computed one precision
below the configuration's (``reference/precision.py``) put in the
program's place; for a training cell also the faults planted in the
reference in the program's place (``reference/train.py``: a step that
leaves the state unchanged; half of each batch left out, the mean taken over the rest; a group that reuses its
first batch; the text encoder's gradients doubled; validation over half
the val set), for a serving cell an answer altered (the first patch of
each sampled request inverted). For each seed
of ``--witness-seeds`` (training) the program run in float32 against the
reference. Prints one JSON line per reading and writes them all to
``--out``.
"""

from __future__ import annotations

import argparse
import copy
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def _numbers(numbers: dict) -> dict:
    return {k: v["value"] for k, v in numbers.items()
            if not k.startswith("_")}


CONTROLS = ("control", "unchanged", "half_batch", "reuse", "text_grad_x2",
            "val_half")


def train_readings(cell, seeds, control_seeds, witness_seeds, kinds,
                   device):
    from harness import common, train_cell
    from harness.compare import train_numbers
    for seed in witness_seeds:
        # The program in float32 (TF32 off): the second witness that the
        # reference draws the program's noise and dropout on the card.
        f32 = copy.copy(cell)
        f32.config = dict(cell.config, compute_dtype="float32")
        trainer, train, workdir = train_cell.build_trainer(f32, seed, device)
        prog = train_cell.checked_steps(f32, trainer, train)
        shutil.rmtree(workdir, ignore_errors=True)
        del trainer, train
        common.free_device(device)
        ref = train_cell.reference_steps(f32, seed, device)
        yield {"kind": "program_float32", "seed": seed,
               **_numbers(train_numbers(prog, ref))}
    for seed in seeds:
        trainer, train, workdir = train_cell.build_trainer(cell, seed, device)
        prog = train_cell.checked_steps(cell, trainer, train)
        shutil.rmtree(workdir, ignore_errors=True)
        del trainer, train
        common.free_device(device)
        ref = train_cell.reference_steps(cell, seed, device)
        yield {"kind": "program", "seed": seed,
               **_numbers(train_numbers(prog, ref))}
    for seed in control_seeds:
        ref = train_cell.reference_steps(cell, seed, device)
        for kind in kinds:
            kw = ({"precision": "control"} if kind == "control"
                  else {"fault": kind})
            other = train_cell.reference_steps(cell, seed, device, **kw)
            yield {"kind": kind, "seed": seed,
                   **_numbers(train_numbers(other, ref))}


def serve_readings(cell, seeds, control_seeds, seconds, device):
    from harness import common, serve_cell
    from harness.compare import serve_numbers
    for seed in seeds:
        pool = serve_cell.make_pool(cell, seed, device)
        g_sd, _ = serve_cell.generator_weights(cell, seed, device)
        engine = serve_cell.build_engine(cell, seed, g_sd, device)
        serve_cell.warm(engine, pool, cell.traffic["engine_batch"])
        rec = serve_cell.window(engine, cell, pool, seed, seconds)
        del engine
        common.free_device(device)
        items = rec["sample"].items()
        pairs = serve_cell.reference_pairs(cell, seed, g_sd, pool, items,
                                           device)
        yield {"kind": "program", "seed": seed, "requests": rec["attempted"],
               **_numbers(serve_numbers(pairs))}
        if seed in control_seeds:
            ref = [r for _, r in pairs]
            ctl = serve_cell.reference_pairs(cell, seed, g_sd, pool, items,
                                             device, "control")
            yield {"kind": "control", "seed": seed,
                   **_numbers(serve_numbers(
                       [(c, r) for (_, c), r in zip(ctl, ref)]))}
            altered = [np.concatenate([1.0 - out[:1], out[1:]])
                       for out, _ in pairs]
            yield {"kind": "altered_answer", "seed": seed,
                   **_numbers(serve_numbers(list(zip(altered, ref))))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--witness-seeds", default="")
    p.add_argument("--controls", default=",".join(CONTROLS),
                   help="training: the control and the faults to read")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    for path in (str(BENCH_DIR), str(ROOT)):
        if path not in sys.path:
            sys.path.insert(0, path)
    import run as bench_run
    bench_run.set_cache_dirs()
    import torch

    from harness import manifest
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = manifest.Cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    t0 = time.time()
    if cell.traffic["kind"] == "train":
        witness = [int(s) for s in args.witness_seeds.split(",") if s]
        kinds = [k for k in args.controls.split(",") if k]
        readings = train_readings(cell, seeds, controls, witness, kinds,
                                  device)
    else:
        readings = serve_readings(cell, seeds, controls, args.seconds, device)
    out = []
    for r in readings:
        r["workload"] = args.workload
        r["t_s"] = round(time.time() - t0, 1)
        out.append(r)
        print(json.dumps(r), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for r in out:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
