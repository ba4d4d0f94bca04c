"""Checkpoints with the reference's last/best policy (the JAX package's
``train/checkpoint.py``, with ``torch.save`` in place of Orbax).

A checkpoint is a directory ``root/name`` (``last_checkpoint``,
``best_model``) holding:

* ``state.pt``: ``{"generator", "discriminator"}`` (the modules'
  ``state_dict``s, BatchNorm running statistics and spectral ``u``
  included), ``{"opt_g", "opt_d"}`` (both Adams' ``state_dict``s) and
  ``step``; a checkpoint of the card's capturable Adams loads into the
  CPU's plain ones and back (``train/state.py:load_optimizer_state``);
* ``host_meta.json``: the JAX package's keys ``epoch``, ``best_val``,
  ``sched_g``, ``sched_d`` (the plateau states), ``lr_g`` and ``lr_d``.

A save writes ``name.tmp`` (clearing a stale one first) and then replaces
``name``, so a crash leaves either the old checkpoint or the new one.

In a process group (``parallel/``) every process holds the same state, so
process 0 alone writes, fenced by barriers, and every process then checks
that it sees the checkpoint: the workdir must be on storage that all of
them share. A restore raises unless every process sees the checkpoint or
none does, and then every process loads it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Dict, Optional

import torch

from vae_gan_mark_tpu_torch.parallel import mesh
from vae_gan_mark_tpu_torch.train.schedule import PlateauState
from vae_gan_mark_tpu_torch.train.state import (
    TrainState, load_optimizer_state)

STATE_FILE = "state.pt"
META_FILE = "host_meta.json"


def save_checkpoint(root: str, name: str, state: TrainState, epoch: int,
                    best_val: float, sched_g: PlateauState,
                    sched_d: PlateauState, lr_g: float, lr_d: float) -> str:
    """Write checkpoint ``root/name``, replacing any existing one; returns
    its path; only process 0 of a process group writes."""
    path = os.path.abspath(os.path.join(root, name))
    mesh.barrier()
    if mesh.process_index() == 0:
        _write(path, state, epoch, best_val, sched_g, sched_d, lr_g, lr_d)
    mesh.barrier()
    if not os.path.isdir(path):
        raise RuntimeError(
            f"process {mesh.process_index()}: checkpoint {path} is not "
            "visible after the save: with several processes the workdir "
            "must be on storage that all of them share")
    return path


def _write(path: str, state: TrainState, epoch: int, best_val: float,
           sched_g: PlateauState, sched_d: PlateauState, lr_g: float,
           lr_d: float) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    torch.save({"generator": state.generator.state_dict(),
                "discriminator": state.discriminator.state_dict(),
                "opt_g": state.opt_g.state_dict(),
                "opt_d": state.opt_d.state_dict(),
                "step": state.step}, os.path.join(tmp, STATE_FILE))
    with open(os.path.join(tmp, META_FILE), "w") as f:
        json.dump({"epoch": epoch, "best_val": best_val,
                   "sched_g": dataclasses.asdict(sched_g),
                   "sched_d": dataclasses.asdict(sched_d),
                   "lr_g": lr_g, "lr_d": lr_d}, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def load_state_file(root: str, name: str, map_location="cpu",
                    mmap: bool = False) -> Optional[Dict]:
    """``state.pt`` of checkpoint ``root/name``, or None without one. With
    ``mmap`` the file is mapped and only the tensors a caller uses are
    read."""
    path = os.path.join(root, name, STATE_FILE)
    if not os.path.isfile(path):
        return None
    return torch.load(path, map_location=map_location, weights_only=True,
                      mmap=mmap)


def restore_checkpoint(root: str, name: str,
                       state: TrainState) -> Optional[Dict]:
    """Load checkpoint ``root/name`` into ``state`` (modules, optimizers,
    step) in place; returns its host meta, or None when there is no
    checkpoint (on every process of a group, or raises)."""
    if not mesh.agree(os.path.isfile(os.path.join(root, name, STATE_FILE))):
        return None
    device = next(state.generator.parameters()).device
    saved = load_state_file(root, name, map_location=device)
    state.generator.load_state_dict(saved["generator"])
    state.discriminator.load_state_dict(saved["discriminator"])
    for opt, key in ((state.opt_g, "opt_g"), (state.opt_d, "opt_d")):
        load_optimizer_state(opt, saved[key])
    state.step = int(saved["step"])
    with open(os.path.join(root, name, META_FILE)) as f:
        meta = json.load(f)
    meta["sched_g"] = PlateauState(**meta["sched_g"])
    meta["sched_d"] = PlateauState(**meta["sched_d"])
    return meta
