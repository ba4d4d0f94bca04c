"""Annotation index and grouped train/val split (a copy of the JAX
package's ``data/index.py``).

``build_index`` scans ``json_dir`` for ``*.json`` in sorted order; for each
base name it tries .jpg/.png/.jpeg/.webp to find ``{base}_ru{ext}`` in
``ru_image_dir`` and ``{base}_en{ext}`` in ``en_image_dir``; the mask is
always ``{base}_ru.png`` in ``mask_dir``. Each JSON file holds a list of
items; an item is a sample when ``bbox_ru`` is a 4x[x, y] list and ``text``
a string; a malformed ``bbox_en`` becomes None.

``grouped_split`` splits by unique RU image path (all crops of one image
land on one side), test fraction 0.1, seed 42, with sklearn's
``train_test_split`` shuffle reproduced exactly.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

IMAGE_EXTS = (".jpg", ".png", ".jpeg", ".webp")


@dataclasses.dataclass
class Sample:
    ru_image_path: str
    en_image_path: Optional[str]
    mask_path: Optional[str]
    bbox_ru: List[List[float]]
    bbox_en: Optional[List[List[float]]]
    text: str


def _valid_bbox(b) -> bool:
    return (isinstance(b, list) and len(b) == 4
            and all(isinstance(p, list) and len(p) == 2 for p in b))


def build_index(json_dir: str, ru_image_dir: str, en_image_dir: str,
                mask_dir: str) -> List[Sample]:
    samples: List[Sample] = []
    for fname in sorted(os.listdir(json_dir)):
        if not fname.lower().endswith(".json"):
            continue
        base = Path(fname).stem
        ru_path = en_path = mask_path = None
        for ext in IMAGE_EXTS:
            candidate = os.path.join(ru_image_dir, f"{base}_ru{ext}")
            if os.path.exists(candidate):
                ru_path = candidate
                en_candidate = os.path.join(en_image_dir, f"{base}_en{ext}")
                if os.path.exists(en_candidate):
                    en_path = en_candidate
                mask_candidate = os.path.join(mask_dir, f"{base}_ru.png")
                if os.path.exists(mask_candidate):
                    mask_path = mask_candidate
                break
        if ru_path is None:
            continue
        try:
            with open(os.path.join(json_dir, fname), encoding="utf-8") as f:
                annots = json.load(f)
        except Exception:
            continue
        if not isinstance(annots, list):
            continue
        for item in annots:
            if not isinstance(item, dict):
                continue
            bbox_ru = item.get("bbox_ru")
            bbox_en = item.get("bbox_en")
            text = item.get("text")
            if not _valid_bbox(bbox_ru) or not isinstance(text, str):
                continue
            if bbox_en and not _valid_bbox(bbox_en):
                bbox_en = None
            samples.append(Sample(ru_path, en_path, mask_path,
                                  bbox_ru, bbox_en, text))
    return samples


def grouped_split(samples: Sequence[Sample], val_fraction: float = 0.1,
                  seed: int = 42) -> Tuple[List[int], List[int]]:
    """Split sample indices by unique RU image path: permute with
    ``np.random.RandomState(seed).permutation(n)`` and take the first
    ``ceil(n * val_fraction)`` images as validation, as sklearn's
    ``train_test_split(shuffle=True, random_state=seed)`` does."""
    unique = sorted({s.ru_image_path for s in samples})
    n = len(unique)
    if n == 0:
        return list(range(len(samples))), []
    n_val = int(np.ceil(n * val_fraction))
    perm = np.random.RandomState(seed).permutation(n)
    val_imgs = {unique[i] for i in perm[:n_val]}
    train_idx = [i for i, s in enumerate(samples)
                 if s.ru_image_path not in val_imgs]
    val_idx = [i for i, s in enumerate(samples)
               if s.ru_image_path in val_imgs]
    return train_idx, val_idx
