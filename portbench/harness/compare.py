"""The comparison that decides ``correct``: the numbers compared, each
against its limit from ``limits/<workload>.json``. Only the numbers that
file names decide; the others are printed with the run's result.

Training (the checked epochs of the one Trainer that the window then
drives, through ``train_epoch`` and ``validate``, against the reference
from the same weights, batches and seeds):

* ``loss_gap``: the largest relative gap of a checked epoch's mean
  ``loss_G`` or ``loss_D``, |program - reference| / |reference|;
  ``loss1_gap`` the first epoch's (its one step);
* ``grad_gap``: the gradient each optimizer received at the first step,
  per leaf (the program's read from Adam's state, ``exp_avg / (1 - b1)``):
  the worst leaf's |norm - reference norm| over the larger of that leaf's
  reference norm and the median leaf's of its network; ``grad_med_gap``
  the median leaf's;
* ``text_grad_gap``: as ``grad_gap`` over the text path's leaves alone
  (the reference's ``text_leaves``, by its module's ``TEXT_PREFIXES``: for
  the char path the BiGRU, whose gradient the GRU backward kernel makes,
  and the rest of its encoder), against the median leaf of that group;
* ``change_gap``: each parameter's change over the checked steps, per leaf,
  measured as ``grad_gap``; ``change_med_gap`` the median leaf's;
* ``val_recon_gap``, ``val_perc_gap``: the relative gaps of validation's
  mean ``recon`` and ``perc``, the terms of the generator's eval-mode
  output, where the reference's validation gives them (``perc`` only with
  ``full_loss_val``); ``val_gap`` the largest; ``val_missing`` the number
  of the reference's validation terms that the program's validation did
  not return (a missing term also reads infinite in the gaps). The
  discriminator's terms are not compared: five Adam steps part its outputs
  by several percent at rounding's level of difference (the witness: with
  both rates 0 every term agrees to 1e-6 on the CPU).

Leaves whose reference gradient at the first step is under a thousandth of
the median leaf's of their network move under Adam by round-off alone (a
convolution's bias ahead of a normalisation): they are left out of every
leaf number, by that rule and not by name.

Serving (a sample of the window's requests, drawn from the seed, and the
longest request, against the reference over the same rows, texts and
noise): ``patch_max_gap``, the largest absolute gap of a pixel, and
``patch_mean_gap``, the mean absolute gap over every sampled pixel.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np

EXCLUDE_BELOW = 1e-3
VAL_TERMS = ("recon", "perc")


def _median_by_net(norms: Mapping[str, float]) -> Dict[str, float]:
    nets = {k.split(".", 1)[0] for k in norms}
    return {n: float(np.median([v for k, v in norms.items()
                                if k.startswith(n + ".")])) for n in nets}


def kept_leaves(ref_grad1: Mapping[str, float]) -> List[str]:
    med = _median_by_net(ref_grad1)
    return [k for k, v in ref_grad1.items()
            if v >= EXCLUDE_BELOW * med[k.split(".", 1)[0]]]


def _gap(p: float, r: float, med: float) -> float:
    gap = abs(p - r) / max(r, med, 1e-30)
    return gap if np.isfinite(gap) else float("inf")


def leaf_gaps(prog: Mapping[str, float], ref: Mapping[str, float],
              leaves: List[str]) -> Dict[str, float]:
    """Each leaf's |program norm - reference norm| over the larger of its
    reference norm and the median leaf's of its network."""
    med = _median_by_net({k: ref[k] for k in leaves})
    return {k: _gap(prog[k], ref[k], med[k.split(".", 1)[0]])
            for k in leaves}


def _rel(p: float, r: float) -> float:
    gap = abs(p - r) / max(abs(r), 1e-30)
    return gap if np.isfinite(gap) else float("inf")


def _worst_and_median(name: str, gaps: Mapping[str, float]
                       ) -> Dict[str, dict]:
    worst = max(gaps, key=gaps.get)
    return {f"{name}_gap": {"value": gaps[worst], "leaf": worst},
            f"{name}_med_gap": {"value": float(np.median(list(
                gaps.values())))}}


def train_numbers(prog: dict, ref: dict) -> Dict[str, dict]:
    epochs = [max(_rel(p["loss_G"], r["loss_G"]),
                  _rel(p["loss_D"], r["loss_D"]))
              for p, r in zip(prog["losses"], ref["losses"])]
    leaves = kept_leaves(ref["grad1"])
    out = {"loss_gap": {"value": max(epochs)},
           "loss1_gap": {"value": epochs[0]}}
    for name, key in (("grad", "grad1"), ("change", "change")):
        out.update(_worst_and_median(name, leaf_gaps(prog[key], ref[key],
                                                     leaves)))
    text_leaves = set(ref["text_leaves"])
    text = [k for k in leaves if k in text_leaves]
    med = float(np.median([ref["grad1"][k] for k in text]))
    gaps = {k: _gap(prog["grad1"][k], ref["grad1"][k], med) for k in text}
    worst = max(gaps, key=gaps.get)
    out["text_grad_gap"] = {"value": gaps[worst], "leaf": worst}
    val_terms = [k for k in VAL_TERMS if k in ref["val"]]
    for k in val_terms:
        out[f"val_{k}_gap"] = {"value": _rel(prog["val"].get(k, float("nan")),
                                             ref["val"][k])}
    out["val_gap"] = {"value": max(out[f"val_{k}_gap"]["value"]
                                   for k in val_terms)}
    out["val_missing"] = {"value": float(len(set(ref["val"])
                                             - set(prog["val"])))}
    out["_leaves"] = {"kept": len(leaves),
                      "left_out": sorted(set(ref["grad1"]) - set(leaves))}
    return out


def serve_numbers(pairs: List[Tuple[np.ndarray, np.ndarray]]
                  ) -> Dict[str, dict]:
    """``pairs``: (program patches, reference patches) of each sampled
    request."""
    worst, total, count = 0.0, 0.0, 0
    for prog, ref in pairs:
        if prog.shape != ref.shape:
            return {"patch_max_gap": {"value": float("inf")},
                    "patch_mean_gap": {"value": float("inf")}}
        diff = np.abs(prog.astype(np.float64) - ref)
        if not np.all(np.isfinite(diff)):
            worst = float("inf")
        else:
            worst = max(worst, float(diff.max()))
        total += float(diff.sum())
        count += diff.size
    return {"patch_max_gap": {"value": worst},
            "patch_mean_gap": {"value": total / max(count, 1)}}


def decide(numbers: Mapping[str, dict], limits: Mapping[str, float]
           ) -> Tuple[bool, Dict[str, dict]]:
    """Every number named in ``limits`` at or under its limit."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        if name.startswith("_"):
            continue
        value = numbers.get(name, {}).get("value", float("inf"))
        passed = bool(np.isfinite(value) and value <= limit)
        ok = ok and passed
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
