"""The traffic generator: the same seed gives the same requests and
inputs, another seed another order of the same sizes."""

import json
from collections import Counter
from itertools import islice
from pathlib import Path

import numpy as np
import pytest
import torch

from harness import data, traffic

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"
ALPHABET = "abcdefghij"


def take(name, seed, n):
    spec = json.loads((TRAFFIC / f"{name}.json").read_text())
    return list(islice(traffic.requests(spec, ALPHABET, 60, seed), n)), spec


@pytest.mark.parametrize("name", ["serve.patch"])
def test_same_seed_same_requests(name):
    a, _ = take(name, 2 ** 31 + 5, 150)
    b, _ = take(name, 2 ** 31 + 5, 150)
    assert a == b


@pytest.mark.parametrize("name", ["serve.patch"])
def test_other_seed_same_sizes_other_order(name):
    a, spec = take(name, 1, spec_cycle := 200)
    b, _ = take(name, 2, spec_cycle)
    assert [r.texts for r in a] != [r.texts for r in b]
    cycle = spec["cycle"]
    for k in range(len(a) // cycle):
        sa = Counter(r.size for r in a[k * cycle:(k + 1) * cycle])
        sb = Counter(r.size for r in b[k * cycle:(k + 1) * cycle])
        assert sa == sb
    if spec["sizes"]["dist"] == "geometric":
        assert [r.size for r in a] != [r.size for r in b]
    for r in a:
        assert 0 <= r.offset <= spec["pool_patches"] - r.size
        assert all(3 <= len(t) <= 60 for t in r.texts)


def test_geometric_sizes():
    sizes = traffic.cycle_sizes({"dist": "geometric", "p": 0.25, "min": 1,
                                 "max": 24}, 100)
    assert sizes.min() == 1 and sizes.max() <= 24
    assert 3.5 < sizes.mean() < 4.5


def test_patches_and_texts_follow_the_seed():
    cfg = {"patch_h": 32, "patch_w": 64, "alphabet": ALPHABET,
           "max_text_len": 60}
    a = data.patches(cfg, 4, 7, "cpu")
    b = data.patches(cfg, 4, 7, "cpu")
    c = data.patches(cfg, 4, 8, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["ru"], c["ru"])
    assert float(a["mask"].mean()) == pytest.approx(0.25)
    assert data.texts(cfg, 5, 3) == data.texts(cfg, 5, 3)
    assert data.texts(cfg, 5, 3) != data.texts(cfg, 5, 4)
    assert data.sub_seed(2 ** 31 + 9, "data") != data.sub_seed(
        2 ** 31 + 9, "weights")
    assert isinstance(np.int64(data.sub_seed(-3, "data")), np.int64)
