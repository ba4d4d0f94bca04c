"""Data parallelism across processes (``vae_gan_mark_tpu_torch/parallel/``)
on the CPU: two gloo processes, each with half of every global batch,
against one process with the whole batch and against the JAX train step at
the global batch, at the tiny geometry with float32.

The two processes run ``tests/torch_port_dp_worker.py`` (no JAX) once for
the whole file: the train steps (with ``eps`` in the batch and dropout 0,
as the JAX comparison needs; and with the noise and a dropout of 0.1 drawn
from the step's generator, which the processes draw at the global shape),
BatchNorm's statistics, and the Trainer's save and resume.

Tolerances, and why:

* Two processes against one: metrics rtol 1e-4, BatchNorm running
  statistics and D's ``u`` atol 1e-5, both Adams' first moments after the
  first step as ``assert_moments_close`` holds them. The processes sum
  each BatchNorm's statistics and each gradient in another order than one
  process does (two local sums and an all-reduce), float32 rounding of
  1e-7 relative; D's first Adam update, lr * g / (|g| + eps), turns such
  differences in its near-zero gradients into steps of up to lr = 1e-4
  (ROADMAP section 3 item 3), so the parameters after three steps are held
  to atol 2 * steps * lr, the bound Adam's step size sets. Read on this
  build host: metrics 8.3e-5 relative (dropout job 8.0e-5), buffers
  8.1e-7 (2.3e-6), parameters 4.0e-4 (4.3e-4).
* Two processes against the JAX step at the global batch: the float32
  train-step tolerances of ``tests/test_torch_port_train.py`` (metrics rtol
  1e-3, buffers rtol 1e-3 atol 3e-5).
* BatchNorm across processes against the JAX BatchNorm over the global
  batch (the row-weighted form against the materialised rows): rtol 1e-5,
  atol 1e-6, float32 sums of at most 360 terms.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vae_gan_mark_tpu.config import get_config as jax_get_config
from vae_gan_mark_tpu.models.vgg import load_vgg_params
from vae_gan_mark_tpu.ops.norms import BatchNorm as JaxBatchNorm
from vae_gan_mark_tpu.train.step import (
    build_train_step as jax_build_train_step)
from vae_gan_mark_tpu_torch import cli
from vae_gan_mark_tpu_torch.config import get_config
from vae_gan_mark_tpu_torch.parallel import distributed, mesh
from vae_gan_mark_tpu_torch.train import batch_to_device, build_train_step
from vae_gan_mark_tpu_torch.train.step import make_generator
from vae_gan_mark_tpu_torch.utils.port_jax import (
    discriminator_state_dict_from_jax, state_dict_from_jax)

from torch_port_common import (
    KL_WEIGHT, METRIC_TOL, STATE_TOL, STEPS, TINY, TRAIN, adam_mu,
    assert_moments_close, jax_init, make_batch, numpy_tree, port_from_jax)

ROOT = Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "torch_port_dp_worker.py"
DP_METRIC_TOL = dict(rtol=1e-4, atol=1e-7)
DP_BUFFER_ATOL = 1e-5
LR = 1e-4
ROW_WEIGHTS = (1.0, 4.0, 1.0)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def worker_env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONSTARTUP", "MASTER_ADDR", "WORLD_SIZE",
                        "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "1"
    return env


def run_processes(commands, timeout=300):
    """Start every command at once; raise unless all exit 0."""
    procs = [subprocess.Popen(cmd, cwd=ROOT, env=worker_env(),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in commands]
    outputs = []
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=timeout)
            outputs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, out in zip(procs, outputs):
        assert proc.returncode == 0, out[-4000:]
    return outputs


def train_steps(g, d, vgg, overrides, batches):
    """One process, the whole batch: the worker's ``train`` job."""
    cfg = get_config("v2", **overrides)
    from vae_gan_mark_tpu_torch.train import create_train_state
    from vae_gan_mark_tpu_torch.models import VGG16Features
    state = create_train_state(cfg, g, d, device="cpu")
    vgg_model = VGG16Features()
    vgg_model.load_state_dict(vgg)
    step = build_train_step(cfg)
    out = {"metrics": []}
    for i, batch in enumerate(batches):
        state, metrics = step(state, vgg_model, batch_to_device(batch, "cpu"),
                              make_generator("cpu", 7, state.step), KL_WEIGHT)
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        if i == 0:
            out["g_moments"] = {n: state.opt_g.state[p]["exp_avg"].clone()
                                for n, p in state.generator.named_parameters()}
            out["d_moments"] = {
                n: state.opt_d.state[p]["exp_avg"].clone()
                for n, p in state.discriminator.named_parameters()}
    out["g"] = {k: v.clone() for k, v in state.generator.state_dict().items()}
    out["d"] = {k: v.clone()
                for k, v in state.discriminator.state_dict().items()}
    return out


def without_eps(batch):
    return {k: v for k, v in batch.items() if k != "eps"}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    jax_state, jax_vgg = jax_init("v2"), load_vgg_params()
    cfg, state, vgg = port_from_jax("v2", jax_state, jax_vgg)
    batches = [make_batch(cfg, 10 + i) for i in range(STEPS)]
    rng = np.random.default_rng(5)
    jobs = {
        "eps": dict(kind="train", overrides=TRAIN, batches=batches,
                    kl_weight=KL_WEIGHT),
        "dropout": dict(kind="train",
                        overrides=dict(TRAIN, char_rnn_dropout=0.1),
                        batches=[without_eps(b) for b in batches],
                        kl_weight=KL_WEIGHT),
        "batch_norm": dict(
            kind="batch_norm", row_weights=ROW_WEIGHTS,
            x=rng.normal(1.0, 2.0, (4, 3, 3, 5)).astype(np.float32),
            scale=rng.normal(1.0, 0.1, 3).astype(np.float32),
            bias=rng.normal(0.0, 0.1, 3).astype(np.float32),
            cotangent=rng.normal(0, 1, (4, 3, 3, 5)).astype(np.float32)),
        "trainer": dict(kind="trainer", overrides=dict(TRAIN, batch_size=4),
                        batches=[make_batch(cfg, 20 + i) for i in range(4)],
                        workdir=str(tmp / "fit")),
    }
    setup = dict(g=state.generator.state_dict(),
                 d=state.discriminator.state_dict(), vgg=vgg.state_dict(),
                 jobs=jobs)
    torch.save(setup, tmp / "setup.pt")
    port = free_port()
    run_processes([[sys.executable, str(WORKER), str(tmp / "setup.pt"),
                    str(rank), "2", str(port), str(tmp)]
                   for rank in range(2)])
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    return dict(jax_state=jax_state, jax_vgg=jax_vgg, setup=setup,
                ranks=ranks, tmp=tmp, cfg=cfg)


@pytest.mark.parametrize("job", ["eps", "dropout"])
def test_two_processes_equal_one_process(run, job):
    """Three f32 steps of two processes at 2 rows each against one process
    at 4: the metrics of every step, BatchNorm's running statistics and
    D's u, both Adams' moments after the first step, and the parameters;
    the two processes hold the same G and D bit for bit."""
    setup = run["setup"]
    spec = setup["jobs"][job]
    ref = train_steps(setup["g"], setup["d"], setup["vgg"],
                      spec["overrides"], spec["batches"])
    r0, r1 = (r[job] for r in run["ranks"])
    for net in ("g", "d"):
        for key in r0[net]:
            assert torch.equal(r0[net][key], r1[net][key]), (net, key)
    for i, (got, want) in enumerate(zip(r0["metrics"], ref["metrics"])):
        for key in want:
            np.testing.assert_allclose(got[key], want[key], err_msg=
                                       f"step {i}: {key}", **DP_METRIC_TOL)
    for net, marker in (("g", "running_"), ("d", "weight_u")):
        for key, want in ref[net].items():
            if marker in key:
                np.testing.assert_allclose(r0[net][key].numpy(),
                                           want.numpy(), rtol=0,
                                           atol=DP_BUFFER_ATOL, err_msg=key)
    for net in ("g", "d"):
        assert_moments_close({k: v.numpy() for k, v in
                              r0[f"{net}_moments"].items()},
                             ref[f"{net}_moments"])
        for key, want in ref[net].items():
            np.testing.assert_allclose(r0[net][key].numpy(), want.numpy(),
                                       rtol=0, atol=2 * STEPS * LR,
                                       err_msg=key)


def test_two_processes_match_the_jax_step(run):
    """The same two processes against the JAX train step on the global
    batch: every step's metrics, and BatchNorm's running statistics and
    D's u after the last; Adam's first moments after the first step."""
    cfg = run["cfg"]
    jax_cfg = jax_get_config("v2", **TRAIN)
    jax_step = jax.jit(jax_build_train_step(jax_cfg))
    jax_state = run["jax_state"]
    got = run["ranks"][0]["eps"]
    for i, batch in enumerate(run["setup"]["jobs"]["eps"]["batches"]):
        jax_state, ref = jax_step(jax_state, run["jax_vgg"], batch,
                                  jax.random.PRNGKey(1),
                                  jnp.float32(KL_WEIGHT))
        for key in ref:
            np.testing.assert_allclose(got["metrics"][i][key],
                                       float(ref[key]),
                                       err_msg=f"step {i}: {key}",
                                       **METRIC_TOL)
        if i == 0:
            g_mu = state_dict_from_jax(adam_mu(jax_state.opt_g),
                                       numpy_tree(jax_state.g_batch_stats),
                                       cfg)
            d_mu = discriminator_state_dict_from_jax(
                adam_mu(jax_state.opt_d), numpy_tree(jax_state.d_spectral),
                cfg)
            for net, mu in (("g", g_mu), ("d", d_mu)):
                assert_moments_close({k: v.numpy() for k, v in
                                      got[f"{net}_moments"].items()}, mu)
    g_ref = state_dict_from_jax(numpy_tree(jax_state.g_params),
                                numpy_tree(jax_state.g_batch_stats), cfg)
    d_ref = discriminator_state_dict_from_jax(
        numpy_tree(jax_state.d_params), numpy_tree(jax_state.d_spectral), cfg)
    for net, ref_sd, marker in (("g", g_ref, "running_"),
                                ("d", d_ref, "weight_u")):
        for key, value in got[net].items():
            if marker in key:
                np.testing.assert_allclose(value.numpy(),
                                           ref_sd[key].numpy(), err_msg=key,
                                           **STATE_TOL)


@pytest.mark.parametrize("form", ["plain", "rows"])
def test_batch_stats_across_processes_match_jax_batch_norm(run, form):
    """A train-mode BatchNorm forward and backward on two processes' rows
    against the JAX BatchNorm over the global batch: outputs, the input's
    gradient (which crosses processes through the statistics), the
    affine parameters' gradients (summed over processes) and the running
    statistics. The row-weighted form (row i of the map stands for
    ``ROW_WEIGHTS[i]`` rows, the FiLM fast path) against the JAX BatchNorm
    over the map with those rows repeated."""
    job = run["setup"]["jobs"]["batch_norm"]
    repeats = ROW_WEIGHTS if form == "rows" else (1, 1, 1)
    x = np.repeat(job["x"], np.asarray(repeats, int), axis=2)
    cot = np.repeat(job["cotangent"], np.asarray(repeats, int), axis=2)
    bn = JaxBatchNorm()
    nhwc = jnp.asarray(np.transpose(x, (0, 2, 3, 1)))
    variables = bn.init(jax.random.PRNGKey(0), nhwc)
    params = {"scale": jnp.asarray(job["scale"]),
              "bias": jnp.asarray(job["bias"])}

    def loss(params, inputs):
        y, updates = bn.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            inputs, mutable=["batch_stats"])
        return jnp.sum(y * np.transpose(cot, (0, 2, 3, 1))), (y, updates)

    (_, (y, updates)), (dparams, dx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, nhwc)
    first = np.cumsum((0,) + repeats[:-1]).astype(int)   # a row of each group
    y = np.transpose(np.asarray(y), (0, 3, 1, 2))[:, :, first]
    dx = np.add.reduceat(np.transpose(np.asarray(dx), (0, 3, 1, 2)), first,
                         axis=2)
    got = [r["batch_norm"][form] for r in run["ranks"]]
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(torch.cat([g["y"] for g in got]).numpy(), y,
                               **tol)
    np.testing.assert_allclose(torch.cat([g["dx"] for g in got]).numpy(), dx,
                               **tol)
    np.testing.assert_allclose(sum(g["dscale"] for g in got).numpy(),
                               np.asarray(dparams["scale"]), **tol)
    np.testing.assert_allclose(sum(g["dbias"] for g in got).numpy(),
                               np.asarray(dparams["bias"]), **tol)
    stats = updates["batch_stats"]
    for g in got:
        np.testing.assert_allclose(g["mean"].numpy(),
                                   np.asarray(stats["mean"]), **tol)
        np.testing.assert_allclose(g["var"].numpy(),
                                   np.asarray(stats["var"]), **tol)


def test_rank0_saves_and_both_processes_resume_equal(run):
    """``Trainer.fit`` on two processes: process 0 alone writes the record
    and the checkpoints; a new Trainer on each process resumes from them
    with the state process 0 saved, and the processes end the third epoch
    with the same G; ``multi_step > 1`` and device-resident data are
    refused in a process group."""
    r0, r1 = (r["trainer"] for r in run["ranks"])
    workdir = Path(run["setup"]["jobs"]["trainer"]["workdir"])
    for r in (r0, r1):
        assert r["resumed_epoch"] == 2 and r["resumed_step"] == 4
        assert r["resumed_equal"]
        assert len(r["refused"]) == 2
        assert "multi_step" in r["refused"][0]
        assert "device-resident" in r["refused"][1]
    for key in r0["g"]:
        assert torch.equal(r0["g"][key], r1["g"][key]), key
    assert r0["lr_g"] == r1["lr_g"]
    records = [json.loads(line) for line in
               (workdir / "v2.metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records] == [1, 2, 3]
    assert sorted(p.name for p in workdir.iterdir()
                  if p.is_dir() and not p.name.startswith("val_")) == [
        "best_model", "last_checkpoint"]
    assert not list(workdir.glob("*.tmp"))


def test_without_a_group_nothing_is_collective():
    """With no process group every collective of ``parallel.mesh`` is the
    identity, and ``initialize`` without a coordinator or a count joins
    none."""
    assert not mesh.active() and mesh.process_count() == 1
    assert mesh.local_rows(6) == slice(0, 6)
    assert distributed.process_local_slice(4) == slice(0, 4)
    assert distributed.initialize(device="cpu") == torch.device("cpu")
    assert not mesh.active()
    t = {"a": torch.tensor(1.5)}
    assert mesh.mean_over_processes(t)["a"] is t["a"]
    draws = mesh.global_rows(lambda s: torch.arange(6.0).view(s), (2, 3))
    assert torch.equal(draws, torch.arange(6.0).view(2, 3))


TINY_SET = [f"--set={k}={','.join(map(str, v)) if isinstance(v, tuple) else v}"
            for k, v in TINY.items()]


@pytest.mark.parametrize("flags,message", [
    (["--no-mesh", "--num-processes", "2"], "--no-mesh"),
    (["--multi-step", "2", "--num-processes", "2"], "--multi-step")])
def test_cli_refuses_one_process_options_with_two(flags, message):
    with pytest.raises(SystemExit, match=message):
        cli.main(["--synthetic", "--device", "cpu", "--coordinator",
                  "localhost:1", "--process-id", "0", *flags, *TINY_SET])


def test_cli_trains_on_two_processes(tmp_path):
    """The train CLI as two processes on the CPU: each loads its rows of
    the synthetic batches, process 0 writes the record and checkpoints,
    and the same command again resumes on both."""
    port = free_port()
    workdir = tmp_path / "run"

    def commands(epochs):
        return [[sys.executable, "-m", "vae_gan_mark_tpu_torch.train",
                 "--synthetic", "--synthetic-samples", "16", "--batch-size",
                 "4", "--epochs", str(epochs), "--workdir", str(workdir),
                 "--device", "cpu", "--coordinator", f"localhost:{port}",
                 "--num-processes", "2", "--process-id", str(rank),
                 *TINY_SET] for rank in range(2)]

    run_processes(commands(1))
    port = free_port()
    outputs = run_processes(commands(2))
    for out in outputs:
        assert "[resume] from epoch 0" in out
    records = (workdir / "v2.metrics.jsonl").read_text().splitlines()
    assert [json.loads(r)["epoch"] for r in records] == [1, 2]
