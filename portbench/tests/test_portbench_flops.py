"""The FLOP count and the least time: the counter on the meta device
equals a hand count on a small conv stack, and a step's count splits by
the precision that the configuration states."""

import json
from pathlib import Path

import pytest
import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from harness import flops, manifest, peaks

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def test_counter_equals_hand_count():
    with torch.device("meta"):
        stack = nn.Sequential(nn.Conv2d(3, 8, 3, padding=1), nn.ReLU(),
                              nn.Conv2d(8, 16, 3, stride=2, padding=1))
        x = torch.randn(2, 3, 16, 32)
        with FlopCounterMode(display=False) as counter:
            stack(x)
    hand = 2 * (2 * 16 * 32 * 8 * 3 * 9) + 2 * (2 * 8 * 16 * 16 * 8 * 9)
    assert counter.get_total_flops() == hand


def test_train_step_splits_by_precision(tmp_path):
    cfg = json.loads((CONFIGS / "v2.json").read_text())
    cfg.update(patch_h=32, patch_w=64, enc_chans=[8, 16, 24, 32],
               bottleneck_ch=48, z_ch=16, char_emb_dim=16,
               char_rnn_hidden=16, max_text_len=12)
    arch = manifest.reference_module(cfg)
    step = flops.train_step_flops(arch, cfg, 4)
    fwd = flops.generate_flops_per_patch(arch, cfg, 4)
    assert step["bf16"] > 0 and step["f32"] > 0
    # The GRU's forward: 2 layers x 2 directions x (input projection +
    # recurrence) at 12 steps a row, float32.
    h, e, length = 16, 16, 12
    gru = 2 * length * 3 * h * (2 * (e + h) + 2 * (2 * h + h))
    assert fwd["f32"] == pytest.approx(gru)
    assert peaks.least_seconds(step) == pytest.approx(
        step["bf16"] / 989e12 + step["f32"] / 67e12)


def test_gru_kernel_bounds_are_compute_bound_at_the_cells_shape():
    fwd = peaks.gru_forward_launch(60, 16, 256)
    assert fwd == pytest.approx(2 * 2 * 60 * 16 * 256 * 768 / 67e12)
    assert peaks.gru_backward_launch(60, 16, 256) == pytest.approx(fwd)
