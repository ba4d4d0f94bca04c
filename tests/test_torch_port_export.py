"""The serving artifact (``vae_gan_mark_tpu_torch/serve/export.py``): the
eval-mode generator as a ``torch.export`` program, exported and served on
the CPU at the tiny geometry.

* Its chunks against the JAX generator with the same weights (through the
  bridge) and the same ``eps``: rtol 1e-3, atol 2e-4, the whole-generator
  tolerance of ``tests/test_torch_port_models.py`` (float32 sum orders of
  some 20 convolutions).
* ``generate`` against ``InferenceEngine.generate`` with the same seed:
  bit for bit. Both run the same chunks and noise (``serve/chunks.py``)
  through the same ATen kernels on the CPU.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vae_gan_mark_tpu.serve import export as jax_export
from vae_gan_mark_tpu_torch.data.text_embed import hash_embed
from vae_gan_mark_tpu_torch.ops import gru
from vae_gan_mark_tpu_torch.serve import InferenceEngine
from vae_gan_mark_tpu_torch.serve.export import (
    EXPORT_NAME, MANIFEST_NAME, ExportedGenerator, export_generator, main)

from torch_port_common import TINY, Pair

ROOT = Path(__file__).resolve().parent.parent
BATCH, SEED = 4, 3
GEN_TOL = dict(rtol=1e-3, atol=2e-4)


def requests(cfg, n, seed=1):
    rng = np.random.default_rng(seed)
    ru = rng.uniform(0, 1, (n, cfg.patch_h, cfg.patch_w, 3)).astype(np.float32)
    mask = (rng.uniform(0, 1, (n, cfg.patch_h, cfg.patch_w, 1)) > 0.5
            ).astype(np.float32)
    return ru, mask, [f"MARK {i}" for i in range(n)]


@pytest.fixture(scope="module")
def v2(tmp_path_factory):
    pair = Pair("v2", seed=0, **TINY)
    art = str(tmp_path_factory.mktemp("export") / "v2")
    export_generator(pair.cfg, pair.port, art, batch_size=BATCH,
                     device="cpu")
    return pair, art, ExportedGenerator.load(art)


def test_artifact_matches_the_jax_generator(v2):
    pair, _, gen = v2
    image, mask, tokens, eps = pair.inputs(BATCH, seed=2)
    got = gen.call(image, mask, tokens, eps)
    ref, _, _ = pair.run_jax(image, mask, tokens, eps)
    np.testing.assert_allclose(got, ref, **GEN_TOL)


def test_generate_equals_the_engine_bit_for_bit(v2):
    """10 rows in chunks of 4 (the last padded), seed 3."""
    pair, _, gen = v2
    ru, mask, texts = requests(pair.cfg, 10)
    engine = InferenceEngine(pair.cfg, pair.state_dict, batch_size=BATCH,
                             seed=SEED, device="cpu")
    want = engine.generate(ru, mask, texts)
    got = gen.generate(ru, mask, texts, seed=SEED)
    assert got.shape == want.shape == (10, pair.cfg.patch_h,
                                       pair.cfg.patch_w, 3)
    np.testing.assert_array_equal(got, want)
    empty = gen.generate(ru[:0], mask[:0], [])
    assert empty.shape == (0, pair.cfg.patch_h, pair.cfg.patch_w, 3)


def test_manifest_has_the_jax_keys(v2, tmp_path, monkeypatch):
    """The JAX manifest's keys, with ``torch_version`` for ``jax_version``
    and ``device`` for ``platforms``. The JAX export writes its manifest
    after lowering; the lowering is stubbed, since only the keys are
    compared."""
    import jax

    class Lowered:
        def serialize(self):
            return b""

    monkeypatch.setattr(jax.export, "export",
                        lambda *a, **k: lambda *args: Lowered())
    pair, art, _ = v2
    jax_dir = jax_export.export_generator(
        pair.jax_cfg, pair.params, pair.batch_stats, str(tmp_path / "jax"),
        batch_size=BATCH, platforms=("cpu",))
    with open(os.path.join(jax_dir, jax_export.MANIFEST_NAME)) as f:
        jax_keys = set(json.load(f))
    with open(os.path.join(art, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    assert set(manifest) == (jax_keys - {"jax_version", "platforms"}
                             | {"torch_version", "device"})
    assert manifest["device"] == "cpu"
    assert manifest["text_shape"] == [BATCH, pair.cfg.max_text_len]
    assert manifest["batch_size"] == BATCH


def test_artifact_serves_in_a_fresh_interpreter_without_model_code(v2,
                                                                   tmp_path):
    """A new interpreter loads the artifact and serves it; it imports no
    module of the port's ``models/`` or ``train/`` and no JAX, and gives
    the engine's patches bit for bit."""
    pair, art, _ = v2
    ru, mask, texts = requests(pair.cfg, 6, seed=4)
    np.savez(tmp_path / "req.npz", ru=ru, mask=mask)
    script = f"""
import json, sys
import numpy as np
from vae_gan_mark_tpu_torch.serve.export import ExportedGenerator
req = np.load({str(tmp_path / 'req.npz')!r})
gen = ExportedGenerator.load({art!r})
out = gen.generate(req["ru"], req["mask"], {texts!r}, seed={SEED})
np.save({str(tmp_path / 'out.npy')!r}, out)
print(json.dumps(sorted(sys.modules)))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    port = [m for m in loaded if m.startswith("vae_gan_mark_tpu_torch.")]
    assert "vae_gan_mark_tpu_torch.ops.gru" in port
    assert not [m for m in port if m.split(".")[1] in ("models", "train")]
    assert not [m for m in loaded if m.split(".")[0] in
                ("jax", "flax", "vae_gan_mark_tpu")]
    engine = InferenceEngine(pair.cfg, pair.state_dict, batch_size=BATCH,
                             seed=SEED, device="cpu")
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"),
                                  engine.generate(ru, mask, texts))


def test_exported_graph_calls_the_gru_op(v2):
    """The program holds the port's bidirectional GRU op, one node per
    BiGRU layer, and no trace of the recurrence's loop in its place (a
    traced loop would hold two sigmoids a step and direction; the output
    layer holds one)."""
    pair, _, gen = v2
    program = gen.program
    targets = [n.target for n in program.graph.nodes
               if n.op == "call_function"]
    op = getattr(torch.ops, gru.NAMESPACE).bigru_forward.default
    assert targets.count(op) == 2
    assert sum("sigmoid" in str(t) for t in targets) <= 1
    launches = gru.KERNEL.launches
    gen.generate(*requests(pair.cfg, 2))
    assert gru.KERNEL.launches == launches      # the CPU runs the plain loop


def test_sbert_artifact_refuses_pseudo_embeddings(tmp_path):
    """A vanilla artifact (the sbert text path) refuses to serve without
    ``text_embed_fn``; with one, it gives the engine's patches."""
    pair = Pair("vanilla", seed=1, **TINY)
    art = export_generator(pair.cfg, pair.port, str(tmp_path / "vanilla"),
                           batch_size=2, device="cpu")
    ru, mask, texts = requests(pair.cfg, 3)
    with pytest.raises(RuntimeError, match="text_embed_fn"):
        ExportedGenerator.load(art).generate(ru, mask, texts)
    got = ExportedGenerator.load(art, text_embed_fn=hash_embed).generate(
        ru, mask, texts, seed=SEED)
    want = InferenceEngine(pair.cfg, pair.state_dict, batch_size=2,
                           seed=SEED, device="cpu",
                           text_embed_fn=hash_embed).generate(ru, mask, texts)
    np.testing.assert_array_equal(got, want)


def test_export_cli_from_a_checkpoint(tmp_path):
    """``python -m vae_gan_mark_tpu_torch.serve.export`` exports a
    checkpoint's generator; without ``--device cpu`` it needs the card."""
    pair = Pair("v2", seed=2, **TINY)
    ckpt = tmp_path / "work" / "best_model"
    ckpt.mkdir(parents=True)
    torch.save({"generator": pair.state_dict}, ckpt / "state.pt")
    sets = [f"--set={k}={','.join(map(str, v)) if isinstance(v, tuple) else v}"
            for k, v in TINY.items()]
    args = ["--workdir", str(tmp_path / "work"), "--out",
            str(tmp_path / "art"), "--batch-size", "2", *sets]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(args)
    main(args + ["--device", "cpu"])
    assert os.path.getsize(tmp_path / "art" / EXPORT_NAME) > 0
    ru, mask, texts = requests(pair.cfg, 2)
    np.testing.assert_array_equal(
        ExportedGenerator.load(str(tmp_path / "art")).generate(
            ru, mask, texts),
        InferenceEngine(pair.cfg, pair.state_dict, batch_size=2,
                        device="cpu").generate(ru, mask, texts))
