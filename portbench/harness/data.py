"""Inputs from the seed, made on the device in a few large draws.

Patches are (N, H, W, 3) smooth colour fields (uniform values in
[40, 215] / 255 on a grid of 16 x 16-pixel cells, upsampled bilinearly),
each with a rectangular text region of half the patch's height and width
at a seeded corner (the mask, (N, H, W, 1)); the target ``en`` is the
patch with its channels rotated inside the region. Target strings are 3 to
60 characters of the configuration's alphabet, drawn with numpy from the
seed. Sub-seeds come from ``sub_seed(seed, tag)``, so the weights, the data,
the noise and the traffic are independent streams of one run seed. The
strings become the generator's text inputs by the configuration's
reference module (``text_inputs``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

TAGS = {"weights": 1, "data": 2, "trainer": 3, "engine": 4, "traffic": 5,
        "sample": 6, "calib": 7}


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream of run ``seed``."""
    state = np.random.SeedSequence(
        [int(seed) % 2 ** 63, TAGS[tag]]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def patches(cfg: dict, n: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """``ru``, ``en`` (n, H, W, 3) and ``mask`` (n, H, W, 1), float32."""
    h, w = cfg["patch_h"], cfg["patch_w"]
    gen = torch.Generator(device=device).manual_seed(seed)
    coarse = torch.rand((n, 3, max(h // 16, 2), max(w // 16, 2)),
                        generator=gen, device=device) * (175.0 / 255.0) \
        + 40.0 / 255.0
    ru = F.interpolate(coarse, size=(h, w), mode="bilinear",
                       align_corners=False).permute(0, 2, 3, 1).contiguous()
    y0 = torch.randint(0, h // 2, (n, 1, 1), generator=gen, device=device)
    x0 = torch.randint(0, w // 2, (n, 1, 1), generator=gen, device=device)
    yy = torch.arange(h, device=device)[None, :, None]
    xx = torch.arange(w, device=device)[None, None, :]
    inside = (yy >= y0) & (yy < y0 + h // 2) & (xx >= x0) & \
        (xx < x0 + w // 2)
    mask = inside.float()[..., None]
    en = torch.where(mask > 0, ru[..., [1, 2, 0]], ru)
    return {"ru": ru, "en": en, "mask": mask}


def texts(cfg: dict, n: int, seed: int) -> List[str]:
    rng = np.random.default_rng(seed)
    alphabet = np.array(list(cfg["alphabet"]))
    lengths = rng.integers(3, cfg["max_text_len"] + 1, n)
    return ["".join(rng.choice(alphabet, int(k))) for k in lengths]


class DeviceSource:
    """The Trainer's data source (``epoch -> iterator of batches``) over
    arrays on the device: batch ``i`` of epoch ``e`` gathers rows
    ``(arange(bs) + (e * steps + i) * bs) % n`` when ``advance``, else
    ``(arange(bs) + i * bs) % n`` (the validation set). ``only(first,
    count)`` makes an epoch batches ``first`` to ``first + count - 1``
    alone, ``only(None)`` all of them again: the checked steps go through
    the same source as the window."""

    def __init__(self, data: Dict[str, torch.Tensor], strings: Sequence[str],
                 batch_size: int, advance: bool):
        self.data = data
        self.strings = list(strings)
        self.n = data["ru"].shape[0]
        self.batch_size = batch_size
        self.steps = self.n // batch_size
        self.advance = advance
        self.span = range(self.steps)

    def only(self, first, count: int = 0) -> None:
        self.span = range(self.steps) if first is None else \
            range(first, first + count)

    def rows(self, epoch: int, i: int) -> np.ndarray:
        base = epoch * self.steps if self.advance else 0
        return (np.arange(self.batch_size) + (base + i) * self.batch_size) \
            % self.n

    def batch(self, idx: np.ndarray) -> dict:
        rows = torch.from_numpy(idx).to(self.data["ru"].device)
        out = {k: v.index_select(0, rows) for k, v in self.data.items()}
        out["raw_text"] = [self.strings[j] for j in idx]
        return out

    def __call__(self, epoch: int):
        for i in self.span:
            yield self.batch(self.rows(epoch, i))


def train_sets(cell, seed: int, device):
    """(train source, val source) of the cell's traffic's sizes."""
    cfg, traffic = cell.config, cell.traffic
    n_train, n_val = traffic["train_samples"], traffic["val_samples"]
    data_seed = sub_seed(seed, "data")
    arrays = patches(cfg, n_train + n_val, data_seed, device)
    strings = texts(cfg, n_train + n_val, data_seed)
    arrays["text"] = cell.reference.text_inputs(cfg, strings, device)
    bs = traffic["batch_size"]
    train = DeviceSource({k: v[:n_train] for k, v in arrays.items()},
                         strings[:n_train], bs, advance=True)
    val = DeviceSource({k: v[n_train:] for k, v in arrays.items()},
                       strings[n_train:], bs, advance=False)
    return train, val
