"""The port's tooling on the CPU: ``doctor`` (the cases of
``tests/test_doctor.py``, and the device check failing without a card),
``utils/profiling.py``, ``utils/debug.py``, ``data/acquire.py:
device_report``, and ``utils/reference_checkpoint.py`` against the JAX
package's ``port_v2_generator`` / ``port_vanilla_generator`` on a seeded
reference-key state dict (generator rtol 1e-3, atol 2e-4, the
whole-generator tolerance of ``tests/test_torch_port_models.py``).
"""

import json
import time

import numpy as np
import pytest
import torch

from vae_gan_mark_tpu.models import VAEGANGenerator as JaxGenerator
from vae_gan_mark_tpu.utils.port_torch import port_generator
from vae_gan_mark_tpu_torch import doctor
from vae_gan_mark_tpu_torch.data.acquire import device_report
from vae_gan_mark_tpu_torch.serve import InferenceEngine
from vae_gan_mark_tpu_torch.utils import reference_checkpoint
from vae_gan_mark_tpu_torch.utils.debug import enable_nan_debugging
from vae_gan_mark_tpu_torch.utils.port_jax import (
    discriminator_state_dict_from_jax, random_discriminator_tree,
    random_jax_tree, state_dict_from_jax)
from vae_gan_mark_tpu_torch.utils.profiling import (
    NO_SPAN, count, span, trace)

from torch_port_common import TINY, Pair

GEN_TOL = dict(rtol=1e-3, atol=2e-4)


@pytest.fixture
def quick_sbert(monkeypatch):
    """The text-embedder check without importing sentence-transformers,
    which takes some 20 s here; ``test_host_checks_pass_without_device``
    runs the real one."""
    monkeypatch.setattr(doctor, "check_sbert", lambda: (True, "stubbed"))


def test_host_checks_pass_without_device(capsys):
    rc = doctor.main(["--skip-device"])
    out = capsys.readouterr().out
    assert rc == 0, out
    for name in ("build-dir", "native-warp", "text-embedder"):
        assert f"[ok] {name}" in out
    assert "device" not in out and "nvcc" not in out


def test_missing_workdir_fails(tmp_path, capsys, quick_sbert):
    rc = doctor.main(["--skip-device", "--workdir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 1
    assert "[ok] workdir" in out and "[FAIL] checkpoints" in out


def test_workdir_with_checkpoint_reports_epoch(tmp_path, capsys,
                                               quick_sbert):
    ck = tmp_path / "last_checkpoint"
    ck.mkdir()
    (ck / "host_meta.json").write_text(json.dumps({"epoch": 7}))
    rc = doctor.main(["--skip-device", "--workdir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "epoch 7" in out


def test_without_a_card_the_device_check_fails(capsys, quick_sbert):
    """The probe child finds no CUDA device: the device check fails and
    the doctor exits 1; it does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    ok, msg = doctor.check_device(timeout_s=120.0)
    assert not ok and "no CUDA device" in msg
    assert doctor.main([]) == 1
    assert "[FAIL] device" in capsys.readouterr().out


def test_unresponsive_probe_times_out(monkeypatch):
    monkeypatch.setattr(doctor, "_PROBE", "import time; time.sleep(60)")
    ok, msg = doctor.check_device(timeout_s=2.0)
    assert not ok and "did not answer" in msg


def test_step_timer_and_trace_on_the_cpu(tmp_path):
    """``trace`` writes the profiler's Chrome trace and, beside it, the
    block's spans and counters (``StepTimer`` is gone: nothing read it)."""
    with trace(str(tmp_path), "probe", "cpu") as prof:
        with span("probe.outer", rows=2):
            with span("probe.inner"):
                time.sleep(0.001)
                torch.ones(64, 64) @ torch.ones(64, 64)
        count("probe.count", 3)
    assert any("mm" in e.key for e in prof.key_averages())
    events = json.loads((tmp_path / "probe.trace.json").read_text())
    assert events["traceEvents"]
    spans = json.loads((tmp_path / "probe.spans.json").read_text())
    assert spans["counters"] == {"probe.count": 3}
    inner, outer = spans["spans"]
    assert (inner["name"], outer["name"]) == ("probe.inner", "probe.outer")
    assert inner["parent"] == outer["id"] == inner["root"]
    assert outer["attrs"] == {"rows": 2}
    assert outer["start"] <= inner["start"] < inner["end"] <= outer["end"]
    assert span("probe.after") is NO_SPAN          # off after the block


def test_nan_debugging_and_device_report():
    try:
        enable_nan_debugging()
        assert torch.is_anomaly_enabled()
    finally:
        enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()
    report = device_report()
    assert report["process_count"] == 1
    if not torch.cuda.is_available():
        assert report["backend"] == "cpu" and report["device_count"] == 0


def reference_checkpoint_dict(cfg, seed):
    """A seeded checkpoint in the reference's format: the generator and D
    with the reference's keys, plus what torch adds and the port does not
    keep (BatchNorm's counters, spectral norm's v, the frozen MiniLM)."""
    params, stats = random_jax_tree(cfg, seed)
    g = dict(state_dict_from_jax(params, stats, cfg))
    for key in [k for k in g if k.endswith("running_mean")]:
        g[key[:-len("running_mean")] + "num_batches_tracked"] = \
            torch.tensor(12)
    if cfg.text_encoder == "sbert":
        g["text_encoder.model.embeddings.weight"] = torch.zeros(3, 4)
    d = dict(discriminator_state_dict_from_jax(
        *random_discriminator_tree(seed)))
    for key in [k for k in d if k.endswith("weight_u")]:
        d[key[:-1] + "v"] = torch.zeros(3)
    return {"model_state_dict": g, "disc_state_dict": d, "epoch": 4}


@pytest.mark.parametrize("variant", ["v2", "vanilla"])
def test_reference_checkpoint_matches_the_jax_port(variant):
    """The same reference-key state dict through the JAX package's
    ``port_generator`` and through the port's loader: the two generators
    agree on the same inputs and noise."""
    pair = Pair(variant, seed=4, **TINY)
    ckpt = reference_checkpoint_dict(pair.cfg, seed=4)
    generator, discriminator = reference_checkpoint.load_reference_checkpoint(
        ckpt, pair.cfg)
    assert discriminator is not None
    params, stats = port_generator(ckpt["model_state_dict"], pair.jax_cfg)
    image, mask, text, eps = pair.inputs(2, seed=6)
    ref, _, _ = JaxGenerator(cfg=pair.jax_cfg, train=False).apply(
        {"params": params, "batch_stats": stats}, image, mask, text, eps=eps)
    pair.port = generator.eval()
    got, _, _ = pair.run_port(image, mask, text, eps)
    np.testing.assert_allclose(got, np.asarray(ref), **GEN_TOL)


def test_reference_checkpoint_keys_are_strict():
    pair = Pair("v2", seed=4, **TINY)
    ckpt = reference_checkpoint_dict(pair.cfg, seed=4)
    missing = dict(ckpt["model_state_dict"])
    missing.pop(next(k for k in missing if k.endswith("weight_hh_l0")))
    with pytest.raises(RuntimeError, match="Missing"):
        reference_checkpoint.load_reference_checkpoint(
            {"model_state_dict": missing}, pair.cfg)
    extra = dict(ckpt["model_state_dict"], **{"stray.weight": torch.zeros(1)})
    with pytest.raises(RuntimeError, match="Unexpected"):
        reference_checkpoint.load_reference_checkpoint(
            {"model_state_dict": extra}, pair.cfg)


def test_reference_checkpoint_cli_feeds_the_engine(tmp_path):
    pair = Pair("v2", seed=4, **TINY)
    ckpt = reference_checkpoint_dict(pair.cfg, seed=4)
    torch.save(ckpt, tmp_path / "last_checkpoint.pth")
    sets = [f"--set={k}={','.join(map(str, v)) if isinstance(v, tuple) else v}"
            for k, v in TINY.items()]
    reference_checkpoint.main([str(tmp_path / "last_checkpoint.pth"),
                               str(tmp_path / "out"), *sets])
    engine = InferenceEngine.from_checkpoint(pair.cfg, str(tmp_path / "out"),
                                             batch_size=2, device="cpu")
    generator, _ = reference_checkpoint.load_reference_checkpoint(
        ckpt, pair.cfg)
    for key, value in generator.state_dict().items():
        assert torch.equal(engine.model.state_dict()[key], value), key
