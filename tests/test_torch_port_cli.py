"""The port's command lines on the CPU at the tiny geometry (``--device
cpu``, ``--set``), and what serving and evaluation from a checkpoint stand
on: the train CLI writes the metric log and both checkpoints and resumes
when run again, the serve CLI renders a PNG from that workdir, the eval CLI
prints one JSON line, unported variants are refused, ``from_checkpoint``
serves the checkpoint's generator, and ``eval``'s full-image path matches
the JAX package's (rtol 1e-3, atol 2e-4, as the whole generators in
test_torch_port_models.py), its uint8-mask quirk included."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vae_gan_mark_tpu import eval as jax_eval
from vae_gan_mark_tpu.models import vaegan as jax_vaegan
from vae_gan_mark_tpu_torch import cli
from vae_gan_mark_tpu_torch import eval as port_eval
from vae_gan_mark_tpu_torch.config import get_config
from vae_gan_mark_tpu_torch.eval import __main__ as eval_cli
from vae_gan_mark_tpu_torch.models import vaegan as port_vaegan
from vae_gan_mark_tpu_torch.serve import InferenceEngine
from vae_gan_mark_tpu_torch.serve import __main__ as serve_cli
from vae_gan_mark_tpu_torch.train.checkpoint import load_state_file

from torch_port_common import TINY, TORCH_THREADS, Pair

ROOT = Path(__file__).resolve().parent.parent
SETS = [arg for key, value in (
    ("patch_h", "32"), ("patch_w", "64"), ("enc_chans", "8,16,24,32"),
    ("bottleneck_ch", "48"), ("z_ch", "16"), ("char_emb_dim", "16"),
    ("char_rnn_hidden", "16"), ("max_text_len", "12"),
    ("compute_dtype", "float32")) for arg in ("--set", f"{key}={value}")]
TRAIN_ARGS = ["--variant", "v2", "--synthetic", "--synthetic-samples", "16",
              "--batch-size", "4"] + SETS


def run_train_cli(workdir, epochs):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = str(TORCH_THREADS)
    proc = subprocess.run(
        [sys.executable, "-m", "vae_gan_mark_tpu_torch.train", *TRAIN_ARGS,
         "--device", "cpu", "--epochs", str(epochs), "--workdir",
         str(workdir)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A workdir trained for 1 epoch by the train CLI, then resumed for a
    second; the two runs' outputs."""
    workdir = tmp_path_factory.mktemp("cli_run")
    first = run_train_cli(workdir, 1)
    second = run_train_cli(workdir, 2)
    return workdir, first, second


def tiny_cfg():
    return get_config("v2", **TINY)


def test_train_cli_writes_checkpoints_and_resumes(trained):
    workdir, first, second = trained
    assert "[resume]" not in first and "done; best val recon" in first
    assert "[resume] from epoch 0" in second
    for name in ("last_checkpoint", "best_model"):
        assert sorted(os.listdir(workdir / name)) == ["host_meta.json",
                                                      "state.pt"]
    with open(workdir / "last_checkpoint" / "host_meta.json") as f:
        assert json.load(f)["epoch"] == 1
    with open(workdir / "v2.metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["epoch"] for r in records] == [1, 2]
    assert {"train/generator_loss", "val/recon_loss", "val/kl_loss_raw",
            "val/kl_loss_weighted", "learning_rate/generator"} <= set(
                records[-1])
    assert os.path.isfile(workdir / "val_images_ep2" / "captions.txt")


def test_serve_cli_renders_a_png(trained, tmp_path, capsys):
    from PIL import Image
    workdir = trained[0]
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 256, (90, 160, 3), dtype=np.uint8)).save(
        tmp_path / "image.png")
    Image.fromarray(((rng.uniform(size=(90, 160)) > 0.5) * 255).astype(
        np.uint8)).save(tmp_path / "mask.png")
    out = tmp_path / "out.png"
    serve_cli.main(["--workdir", str(workdir), "--image",
                    str(tmp_path / "image.png"), "--mask",
                    str(tmp_path / "mask.png"), "--quad",
                    "20,20,140,25,138,70,18,65", "--text", "HELLO",
                    "--out", str(out), "--device", "cpu"] + SETS)
    assert "rendered 'HELLO'" in capsys.readouterr().out
    rendered = np.asarray(Image.open(out))
    assert rendered.shape == (90, 160, 3) and rendered.dtype == np.uint8


@pytest.mark.parametrize("extra", [[], ["--shuffle-text"]],
                         ids=["text", "shuffled_text"])
def test_eval_cli_prints_one_json_line(trained, capsys, extra):
    eval_cli.main(["--synthetic", "--synthetic-samples", "8",
                   "--batch-size", "4", "--workdir", str(trained[0]),
                   "--device", "cpu"] + SETS + extra)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert set(result) == {"recon", "kl", "psnr", "masked_l1",
                           "mark_recovery", "gan_g", "perc", "loss_G",
                           "loss_D", "samples", "checkpoint_epoch"}
    assert result["samples"] == 8
    assert all(np.isfinite(v) for v in result.values())


# oldv is ported; with the sbert text path it is refused.
@pytest.mark.parametrize("variant,overrides", [
    ("vanilla", []), ("lr_sh", []), ("oldv", ["--set", "text_encoder=sbert"])],
    ids=["vanilla", "lr_sh", "oldv"])
def test_unported_variants_are_refused(variant, overrides, tmp_path):
    for main, extra in ((cli.main, ["--synthetic"]),
                        (eval_cli.main, ["--synthetic"]),
                        (serve_cli.main, ["--image", "i", "--mask", "m",
                                          "--quad", "0", "--text", "t",
                                          "--out", "o"])):
        with pytest.raises(SystemExit, match="not ported to PyTorch yet"):
            main(["--variant", variant, "--workdir", str(tmp_path)]
                 + overrides + extra)


def test_clis_default_to_the_card(trained, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(TRAIN_ARGS + ["--workdir", str(tmp_path)])
    assert not os.listdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_cli.main(["--synthetic", "--workdir", str(trained[0])])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine.from_checkpoint(tiny_cfg(), str(trained[0]))


def test_from_checkpoint_serves_the_saved_generator(trained):
    workdir = str(trained[0])
    cfg = tiny_cfg()
    saved = load_state_file(workdir, "best_model")
    engine = InferenceEngine.from_checkpoint(cfg, workdir, batch_size=4,
                                             seed=3, device="cpu")
    reference = InferenceEngine(cfg, saved["generator"], batch_size=4,
                                seed=3, device="cpu")
    for key, value in saved["generator"].items():
        assert torch.equal(engine.model.state_dict()[key], value), key
    rng = np.random.default_rng(1)
    ru = rng.uniform(0, 1, (6, 32, 64, 3)).astype(np.float32)
    mask = (rng.uniform(0, 1, (6, 32, 64, 1)) > 0.5).astype(np.float32)
    texts = [f"t{i}" for i in range(6)]
    assert np.array_equal(engine.generate(ru, mask, texts),
                          reference.generate(ru, mask, texts))
    with pytest.raises(FileNotFoundError):
        InferenceEngine.from_checkpoint(cfg, workdir, name="missing",
                                        device="cpu")


def test_psnr_matches_jax():
    rng = np.random.default_rng(2)
    a, b = rng.uniform(0, 1, (2, 2, 8, 8, 3)).astype(np.float32)
    got = float(port_eval.psnr(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(got, float(jax_eval.psnr(a, b)), rtol=1e-6)
    assert float(port_eval.psnr(torch.from_numpy(a),
                                torch.from_numpy(a))) == pytest.approx(120.0)


def test_render_full_image_matches_jax(monkeypatch):
    """Both sides get the same weights, tokens and noise (each side's
    ``reparameterize`` patched to one fixed eps) and a float mask of 0/1.
    A uint8 mask is not rescaled (the JAX package's quirk): the port renders
    it as the same values in float32."""
    pair = Pair("v2", **TINY)
    cfg = pair.cfg
    rng = np.random.default_rng(4)
    image = rng.integers(0, 256, (70, 120, 3), dtype=np.uint8)
    mask = (rng.uniform(size=(70, 120, 1)) > 0.5).astype(np.float32)
    # Corners off the pixel grid: no pixel centre on the quad's edges, where
    # the two sides' float32 homographies could place it on either side.
    quad = np.array([[10.3, 8.2], [110.4, 12.1], [108.2, 60.3], [12.1, 58.4]],
                    np.float32)
    tokens = np.zeros(cfg.max_text_len, np.int32)
    tokens[:5] = rng.integers(1, cfg.vocab_size, 5)
    eps = rng.normal(0, 1, (1, 1, 1, cfg.z_ch)).astype(np.float32)

    monkeypatch.setattr(jax_vaegan, "reparameterize",
                        lambda rng_, mu, logvar: mu + eps * jnp.exp(
                            0.5 * logvar))
    monkeypatch.setattr(port_vaegan, "reparameterize",
                        lambda mu, logvar, eps_, gen: mu + torch.from_numpy(
                            eps).permute(0, 3, 1, 2) * torch.exp(0.5 * logvar))
    ref = np.asarray(jax_eval.render_full_image(
        pair.jax_cfg, pair.params, pair.batch_stats, image, mask, quad,
        tokens))
    got = port_eval.render_full_image(pair.port, image, mask, quad, tokens)
    assert got.shape == ref.shape == (70, 120, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=2e-4)
    mask8 = (mask * 255).astype(np.uint8)
    unscaled = port_eval.render_full_image(pair.port, image, mask8, quad,
                                           tokens)
    assert torch.equal(unscaled, port_eval.render_full_image(
        pair.port, image, mask8.astype(np.float32), quad, tokens))
    assert not torch.equal(unscaled, got)
    fake, mu, _ = port_eval.generate_patch(pair.port, {
        "ru": torch.zeros(1, 32, 64, 3), "mask": torch.zeros(1, 32, 64, 1),
        "text": torch.from_numpy(tokens[None].astype(np.int64))})
    assert fake.shape == (1, 32, 64, 3) and mu.shape == (1, 1, 1, cfg.z_ch)
