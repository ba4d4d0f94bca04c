"""Run one cell of the benchmark once and print its result as the last line
of standard output.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, traffic and limits are found by name from
``BENCHMARK.json`` (``harness/manifest.py``). The program under test is
``vae_gan_mark_tpu_torch`` on the card; without a card, or with fewer cards
than the cell asks for, or where the cell's files do not describe it (its
configuration names no reference module that is there, say), the run exits
with code 2 and prints no result.
With ``--trace 0`` the result holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiled slice of the
window. The numbers that decide ``correct`` are printed with their limits
as the last lines of standard error and, under ``checks``, last in the
result line. The run also fails, with no result, if JAX or the JAX package
was loaded in this process.
"""

from __future__ import annotations

import time

T_START = time.time_ns()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CACHE = ROOT / ".portbench_cache"


def set_cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout; libraries that
    would pull in JAX by themselves are told not to."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(cell, seed: int, seconds: float, traced: bool, device,
             t_start: int) -> dict:
    from harness import serve_cell, train_cell
    kind = cell.traffic["kind"]
    drivers = {"train": train_cell.run, "serve": serve_cell.run}
    if kind not in drivers:
        raise ValueError(f"traffic kind {kind!r}")
    return drivers[kind](cell, seed, seconds, traced, device, t_start)


def main(argv=None) -> int:
    args = parse(argv)
    set_cache_dirs()
    for path in (str(BENCH_DIR), str(ROOT)):
        if path not in sys.path:
            sys.path.insert(0, path)
    import torch

    from harness import common, manifest

    try:
        cell = manifest.Cell(args.workload)
    except manifest.ManifestError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found {cards}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                   T_START)
    found = common.loaded_forbidden()
    if found:
        print(f"portbench: the process loaded {found} (JAX or the JAX "
              "package)", file=sys.stderr)
        return 3
    common.print_checks(out["checks"])
    print(common.result_line(out["correct"], out["attempted"], out["failed"],
                             out["metrics"], out["device"], out["checks"],
                             out.get("breakdown"), out.get("extra")),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
