"""What the cells read stays as it was before the architecture became a
property of the configuration: values recorded with the harness as it was,
where ``harness/`` and ``reference/model.py`` knew the char U-Nets
themselves, asserted on the harness that reaches the generator through the
configuration's reference module. At the ``tiny_cell`` geometry on the CPU
for one seed: the seeded weights (each of G, D and the VGG head: the sum
and the sum of squares of every leaf, and the sum weighted by each leaf's
place in key order, which moves if a draw lands in another leaf), the
first train batch's ``text`` and ``ru``, and the serving cell's
calibration text; at the cells' own shapes, the work count to the FLOP."""

import hashlib
import math

import numpy as np
import pytest
import torch

from harness import data, flops, manifest, serve_cell
from harness.weights import make_state_dicts

SEED = 2 ** 31 + 7
CPU = torch.device("cpu")

WEIGHTS = {
    "v2.train.graphs": {
        "G": (1110.3040302686516, 3156.6153937432346, 98204.9268123865),
        "D": (868.5866420991455, 1221.3282634001087, 14960.260666810618),
        "VGG": (-24.115872900362998, 1798.8279613594575,
                -116.53563155458214)},
    "oldv.train.eager": {
        "G": (922.4457675453771, 2780.3547874366745, 65905.28109043642),
        "D": (865.3695073436932, 1221.8208876218998, 14928.920493278925),
        "VGG": (-26.245370602243707, 1799.3557746547729,
                -227.1970232973745)},
}
FIRST_TEXT = "4366a9c2481e6fa969a48ada5c7477e50f0649c3d846f24ca8ddbd67b2d5905e"
FIRST_RU = (25551.560115486383, 14565.121567198094)
CALIB_TEXT = "4c59d6a218c2eeca8d36f15aa8f365b20aeee17a0bef652136c8aa679375f7cd"
FLOPS = {
    "v2.train.graphs": {"bf16": 2802717818880.0, "f32": 194953347072.0},
    "oldv.train.eager": {"bf16": 1954365308928.0, "f32": 194953347072.0},
    "v2.serve.patch": {"bf16": 47765258240.0, "f32": 212336640.0},
}


def moments(t: torch.Tensor):
    """The exactly rounded sum and sum of squares of a float32 tensor."""
    v = t.detach().double().flatten().tolist()
    return math.fsum(v), math.fsum(x * x for x in v)


def part(sd):
    names = sorted(sd)
    total, squares = moments(torch.cat([sd[k].flatten() for k in names]))
    placed = math.fsum((i + 1) * moments(sd[k])[0]
                       for i, k in enumerate(names))
    return total, squares, placed


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(np.ascontiguousarray(
        t.cpu().numpy().astype(np.int64)).tobytes()).hexdigest()


@pytest.mark.parametrize("name", sorted(WEIGHTS))
def test_seeded_weights_and_first_batch(tiny_cell, name):
    cell = tiny_cell(name)
    g, d, vgg = make_state_dicts(cell, SEED, CPU)
    for key, sd in (("G", g), ("D", d), ("VGG", vgg)):
        assert part(sd) == pytest.approx(WEIGHTS[name][key], rel=1e-12,
                                         abs=1e-9), key
    train, _ = data.train_sets(cell, SEED, CPU)
    batch = next(iter(train(0)))
    assert digest(batch["text"]) == FIRST_TEXT
    assert moments(batch["ru"]) == pytest.approx(FIRST_RU, rel=1e-12)


def test_serving_calibration_text(tiny_cell):
    cell = tiny_cell("v2.serve.patch")
    cfg = cell.config
    text = cell.reference.text_inputs(cfg, data.texts(
        cfg, serve_cell.CALIB_ROWS, data.sub_seed(SEED, "calib")), CPU)
    assert digest(text) == CALIB_TEXT


@pytest.mark.parametrize("name", sorted(FLOPS))
def test_work_count_to_the_flop(name):
    cell = manifest.Cell(name)
    if cell.traffic["kind"] == "train":
        count = flops.train_step_flops(cell.reference, cell.config,
                                       cell.traffic["batch_size"])
    else:
        count = flops.generate_flops_per_patch(
            cell.reference, cell.config, cell.traffic["engine_batch"])
    assert count == FLOPS[name]
