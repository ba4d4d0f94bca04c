"""The harness's modules import as the run does: ``portbench/`` and the
checkout's root on the path. ``tiny_cell`` gives a cell of BENCHMARK.json
at a geometry the CPU runs in seconds (float32, narrow widths, small
sets), for the tests that drive a run without a card."""

import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
for _p in (str(BENCH_DIR), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

TINY = dict(patch_h=32, patch_w=64, enc_chans=[8, 16, 24, 32],
            bottleneck_ch=48, z_ch=16, char_emb_dim=16, char_rnn_hidden=16,
            max_text_len=12, compute_dtype="float32")


def make_tiny(name: str):
    from harness import manifest
    cell = manifest.Cell(name)
    cfg = dict(cell.config, **TINY)
    if cfg["generator"] == "film3":
        cfg["enc_chans"] = [8, 16, 24]
    cell.config = cfg
    tr = dict(cell.traffic)
    if tr["kind"] == "train":
        # 6 batches an epoch: the checked epochs' 5 batches all differ.
        tr.update(batch_size=8, train_samples=48, val_samples=16)
    else:
        tr.update(pool_patches=40, check_requests=4)
    cell.traffic = tr
    return cell


@pytest.fixture
def tiny_cell():
    import torch
    torch.manual_seed(0)
    torch.set_num_threads(2)
    return make_tiny
