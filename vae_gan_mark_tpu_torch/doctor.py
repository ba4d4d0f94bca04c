"""Pre-flight checks: ``python -m vae_gan_mark_tpu_torch.doctor`` (the JAX
package's ``doctor.py``, for the card).

One line a check, ``[ok]`` or ``[FAIL]``; exit 1 when a hard check fails:

* ``device``: a child process (one the parent can kill at a deadline, since
  a hung CUDA runtime can block inside a native call that holds the GIL) runs a
  bf16 matrix product on the card and checks its result. Without a card
  this check fails; ``--skip-device`` leaves out it and the two after it,
  for host-only work on the CPU;
* ``nvcc``: the CUDA compiler the kernels are built with;
* ``kernels``: the three kernels (``csrc/*.cu``) build into ``_build/``
  and load;
* ``build-dir`` and ``workdir``: writable;
* ``native-warp``: the host loader's C++ warp, or the cv2 path without it;
* ``text-embedder``: SBERT from the local cache, or the hash fallback;
* ``checkpoints``: the workdir's checkpoints and the last epoch.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from typing import Tuple

_PROBE = """
import json, torch
if not torch.cuda.is_available():
    print(json.dumps({"cuda": False}))
    raise SystemExit(0)
x = torch.ones((128, 128), dtype=torch.bfloat16, device="cuda")
v = float((x @ x).float().sum())
print(json.dumps({"cuda": True, "name": torch.cuda.get_device_name(0),
                  "count": torch.cuda.device_count(),
                  "matmul_ok": v == 128.0 * 128 * 128}))
"""


def check_device(timeout_s: float) -> Tuple[bool, str]:
    """A CUDA matrix product in a child process with a deadline."""
    try:
        out = subprocess.run([sys.executable, "-c", _PROBE],
                             capture_output=True, text=True,
                             timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return False, (f"the device probe did not answer in "
                       f"{timeout_s:.0f} s (a hung CUDA runtime?)")
    if out.returncode != 0:
        tail = (out.stderr or "").strip().splitlines()[-1:]
        return False, f"probe failed rc={out.returncode}: {tail}"
    try:
        info = json.loads(out.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        return False, f"unparseable probe output: {out.stdout[-200:]!r}"
    if not info["cuda"]:
        return False, ("no CUDA device: torch.cuda.is_available() is false "
                       "(--skip-device for host-only checks)")
    ok = bool(info["matmul_ok"])
    return ok, (f"{info['name']}, {info['count']} device(s), matmul "
                f"{'ok' if ok else 'WRONG RESULT'}")


def check_nvcc() -> Tuple[bool, str]:
    from vae_gan_mark_tpu_torch.ops.cuda_build import _nvcc
    path = _nvcc()
    version = subprocess.run([path, "--version"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    return True, f"{path} ({version.splitlines()[-1] if version else '?'})"


def check_kernels() -> Tuple[bool, str]:
    """Build every kernel (one nvcc each, in parallel) and load each."""
    from vae_gan_mark_tpu_torch.ops import conv_probe, gru, resize
    from vae_gan_mark_tpu_torch.ops.cuda_build import build_all
    kernels = (gru.KERNEL, gru.BACKWARD_KERNEL, conv_probe.KERNEL,
               resize.RESIZE_KERNEL, resize.RESIZE_BACKWARD_KERNEL)
    build_all([k.source for k in kernels])
    for kernel in kernels:
        kernel.load()
    names = dict.fromkeys(k.source.name for k in kernels)
    return True, ", ".join(names) + " built, loaded"


def check_writable(path: str) -> Tuple[bool, str]:
    try:
        os.makedirs(path, exist_ok=True)
        with tempfile.NamedTemporaryFile(dir=path):
            pass
        return True, f"writable: {path}"
    except OSError as e:
        return False, f"{path}: {e}"


def check_native_warp() -> Tuple[bool, str]:
    from vae_gan_mark_tpu_torch.data import native_warp
    if native_warp._load() is None:
        return True, "not built (optional; the cv2 host path is in use)"
    return True, f"loaded: {native_warp._LIB_PATH}"


def check_sbert() -> Tuple[bool, str]:
    from vae_gan_mark_tpu_torch.data.text_embed import make_text_embedder
    try:
        make_text_embedder(require_sbert=True)
        return True, "SBERT (MiniLM) available (local cache)"
    except Exception:
        return True, ("SBERT unavailable: sbert-variant serving and eval "
                      "refuse unless --allow-hash-embed; the char-token "
                      "variants (unet, v2, oldv) are unaffected")


def check_workdir(path: str) -> Tuple[bool, str]:
    found = [n for n in ("last_checkpoint", "best_model")
             if os.path.isdir(os.path.join(path, n))]
    if not found:
        return False, f"no checkpoints under {path}"
    meta = os.path.join(path, "last_checkpoint", "host_meta.json")
    note = ""
    if os.path.isfile(meta):
        with open(meta) as f:
            note = f" (epoch {json.load(f).get('epoch', '?')})"
    return True, f"{', '.join(found)}{note}"


def main(argv=None) -> int:
    from vae_gan_mark_tpu_torch.ops.cuda_build import BUILD_DIR

    p = argparse.ArgumentParser(
        prog="python -m vae_gan_mark_tpu_torch.doctor",
        description="pre-flight checks of the card, the kernels and the host")
    p.add_argument("--device-timeout", type=float, default=90.0,
                   help="seconds before the device probe counts as hung")
    p.add_argument("--skip-device", action="store_true",
                   help="host-only checks: no device probe, nvcc or kernel "
                        "build")
    p.add_argument("--workdir", default=None,
                   help="also check this training workdir: writable, its "
                        "checkpoints and epoch")
    args = p.parse_args(argv)

    checks = []
    if not args.skip_device:
        checks += [("device", lambda: check_device(args.device_timeout)),
                   ("nvcc", check_nvcc), ("kernels", check_kernels)]
    checks.append(("build-dir", lambda: check_writable(str(BUILD_DIR))))
    if args.workdir:
        checks.append(("workdir", lambda: check_writable(args.workdir)))
    checks += [("native-warp", check_native_warp),
               ("text-embedder", check_sbert)]
    if args.workdir:
        checks.append(("checkpoints", lambda: check_workdir(args.workdir)))

    failed = 0
    for name, fn in checks:
        try:
            ok, msg = fn()
        except Exception as e:  # a check that crashes fails
            ok, msg = False, f"check crashed: {type(e).__name__}: {e}"
        failed += 0 if ok else 1
        print(f"[{'ok' if ok else 'FAIL'}] {name}: {msg}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
