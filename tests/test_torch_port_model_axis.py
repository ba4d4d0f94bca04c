"""The ``model`` axis (tensor parallelism, ``vae_gan_mark_tpu_torch/parallel/
mesh.py:partition_params``) against the JAX package's ``parallel/mesh.py``.

* Which leaves are sharded: the port's generators at full width (built on
  the ``meta`` device) against the JAX rule on ``jax.eval_shape`` of the
  JAX generators (``_tp_spec_for`` and the divisibility test of
  ``partition_params``), for v2, oldv and vanilla, and at the tiny geometry
  with ``kernel_min_ch=64``.
* Gloo processes on the CPU (``tests/torch_port_tp_worker.py``, no JAX),
  1 x 2 and 2 x 2 (data x model), at the tiny geometry widened so that the
  GRU's weights and FiLM's predictor are sharded too (``TP``), float32,
  ``kernel_min_ch=64``: one train step against one process at the same
  global batch, at ``tests/mesh_check.py``'s limits (metrics rtol 2e-4
  atol 1e-5; parameters rtol 2e-3 atol 3e-4, on ``gather_params``: Adam's
  first step moves a parameter by up to lr = 1e-4 on the sign of a
  near-zero gradient, which sum order can flip); and against the JAX step
  at the limits of ``tests/test_torch_port_parallel.py``
  (``METRIC_TOL``, ``STATE_TOL``). The blocks and their Adam moments are
  block-sized, and ranks of one model index hold equal blocks. With D's
  rate 0, G's Adam first moments (its gradient) against one process at
  ``assert_moments_close``'s limits, and G's one-step change against one
  process's within lr / 10 where the gradient's sign is not rounding
  noise. With every whole parameter's gradient shifted on model rank 1,
  the model ranks still hold G and D equal bit for bit.
* The gather's backward takes this rank's slice (not tp times it); the
  clip norm with the model axis equals one process's (rtol 1e-5: float32
  sums of squares in another order).
"""

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
from vae_gan_mark_tpu.parallel.mesh import _tp_spec_for
from vae_gan_mark_tpu.train.step import (
    build_train_step as jax_build_train_step)
from vae_gan_mark_tpu_torch.config import get_config
from vae_gan_mark_tpu_torch.models import VAEGANGenerator
from vae_gan_mark_tpu_torch.parallel import mesh
from vae_gan_mark_tpu_torch.utils.port_jax import generator_entries

from torch_port_common import (
    KL_WEIGHT, METRIC_TOL, STATE_TOL, TRAIN, assert_moments_close, jax_init,
    jax_tree_shapes_of, make_batch, numpy_tree, port_from_jax)
from jax.sharding import PartitionSpec

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_port_tp_worker as worker  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "torch_port_tp_worker.py"
# The JAX dry run's tiny widths (``__graft_entry__._dryrun_pass``), with a
# BiGRU of hidden 32 so that its 3H = 96 gate dim reaches 64.
WIDER = dict(enc_chans=(8, 16, 24, 64), bottleneck_ch=64, char_rnn_hidden=32)
TP = dict(TRAIN, **WIDER)
KERNEL_MIN_CH = 64
MESH_METRIC_TOL = dict(rtol=2e-4, atol=1e-5)
MESH_PARAM_TOL = dict(rtol=2e-3, atol=3e-4)
LAYOUTS = {"1x2": (2, 2), "2x2": (4, 2)}       # (processes, model_parallel)
# The transposed conv's bias ahead of the bottleneck BatchNorm: a zero
# gradient in exact arithmetic, rounding noise on either side.
ZERO_GRADIENT = ("image_vae_decoder_module.bottleneck_proc.0.bias",)
# Added to a whole parameter's gradient on model rank 1 (the drift job):
# a stand-in for the rounding by which the card's model ranks differ.
PERTURB = 1e-7


def jax_sharded(cfg, kernel_min_ch, tp=2):
    """{JAX path: shape} of the generator leaves the JAX rule shards."""
    params = jax_tree_shapes_of(cfg)["params"]
    out = {}

    def visit(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                visit(v, path + (k,))
        elif (_tp_spec_for(node, kernel_min_ch) != PartitionSpec()
              and node[-1] % tp == 0):
            out[path] = node

    visit(params, ())
    return out


def port_partition(cfg, kernel_min_ch, tp=2, model_index=0):
    """The port's generator on the meta device, partitioned as model rank
    ``model_index`` of ``tp``: {key: (dim, shape)} of its sharded
    parameters and the parameters it holds."""
    with torch.device("meta"):
        g = VAEGANGenerator(cfg)
    layout = mesh.Mesh(data=1, model=tp, data_index=0,
                       model_index=model_index)
    mesh.partition_params(g, layout, kernel_min_ch=kernel_min_ch)
    sharded = {n: (mesh.sharded_dim(p), tuple(p.shape))
               for n, p in g.named_parameters()
               if mesh.sharded_dim(p) is not None}
    return sharded, sum(p.numel() for p in g.parameters())


@pytest.mark.parametrize("variant,overrides,kernel_min_ch,count", [
    ("v2", {}, 512, 23), ("oldv", {}, 512, 14), ("vanilla", {}, 512, 4),
    ("v2", TP, KERNEL_MIN_CH, 23)])
def test_partition_shards_the_leaves_of_the_jax_rule(
        variant, overrides, kernel_min_ch, count):
    cfg = get_config(variant, **overrides)
    want = jax_sharded(jax_get_config(variant, **overrides), kernel_min_ch)
    by_path = {e.path: e for e in generator_entries(cfg)
               if e.collection == "params"}
    got, held = port_partition(cfg, kernel_min_ch)
    assert len(want) == count
    assert set(got) == {by_path[p].key for p in want}
    with torch.device("meta"):
        whole = dict(VAEGANGenerator(cfg).named_parameters())
    for path, shape in want.items():
        dim, block = got[by_path[path].key]
        full = tuple(whole[by_path[path].key].shape)
        assert full[dim] == shape[-1]
        assert block == full[:dim] + (shape[-1] // 2,) + full[dim + 1:]
    total = sum(p.numel() for p in whole.values())
    halved = sum(int(np.prod(s)) for s in want.values()) // 2
    assert held == total - halved
    if variant == "v2" and not overrides:       # v2 at full width, tp=2
        assert round(total / 1e6, 2) == 76.22
        assert round(halved * 2 / 1e6, 2) == 42.53
        assert round(held / 1e6, 2) == 54.96


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


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both layouts at once: their processes start together."""
    tmp = tmp_path_factory.mktemp("tp")
    jax_state, jax_vgg = jax_init("v2", **WIDER), load_vgg_params()
    cfg, state, vgg = port_from_jax("v2", jax_state, jax_vgg, **WIDER)
    batches = [make_batch(cfg, 10)]
    rng = np.random.default_rng(3)
    full = rng.normal(0, 1, (6, 8)).astype(np.float32)
    jobs = {
        "train": dict(kind="train", overrides=TP, batches=batches,
                      kl_weight=KL_WEIGHT, kernel_min_ch=KERNEL_MIN_CH),
        "update": dict(kind="train", overrides=dict(TP, lr_d=0.0),
                       batches=batches, kl_weight=KL_WEIGHT,
                       kernel_min_ch=KERNEL_MIN_CH),
        "drift": dict(kind="train", overrides=TP, batches=batches * 2,
                      kl_weight=KL_WEIGHT, kernel_min_ch=KERNEL_MIN_CH,
                      perturb=PERTURB),
        "clip": dict(kind="clip", overrides=TP, batches=batches,
                     kernel_min_ch=KERNEL_MIN_CH, max_norm=1e-3),
        "gather": dict(kind="gather", full=torch.from_numpy(full), dim=1,
                       cotangent=torch.from_numpy(
                           rng.normal(0, 1, (6, 8)).astype(np.float32))),
    }
    setup = dict(g=state.generator.state_dict(),
                 d=state.discriminator.state_dict(), vgg=vgg.state_dict(),
                 jobs=jobs)
    torch.save(setup, tmp / "setup.pt")
    procs = []
    for name, (world, tp) in LAYOUTS.items():
        out = tmp / name
        out.mkdir()
        port = free_port()
        procs += [subprocess.Popen(
            [sys.executable, str(WORKER), str(tmp / "setup.pt"), str(rank),
             str(world), str(tp), str(port), str(out)], cwd=ROOT,
            env=worker_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for rank in range(world)]
    outputs = []
    try:
        for proc in procs:
            outputs.append(proc.communicate(timeout=300)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, text in zip(procs, outputs):
        assert proc.returncode == 0, text[-4000:]
    ranks = {name: [torch.load(tmp / name / f"rank{r}.pt",
                               weights_only=False) for r in range(world)]
             for name, (world, _) in LAYOUTS.items()}
    one = {name: worker.run_job(setup, job) for name, job in jobs.items()
           if name not in ("gather", "drift")}
    return dict(ranks=ranks, one=one, setup=setup, cfg=cfg,
                jax_state=jax_state, jax_vgg=jax_vgg)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_tensor_parallel_step_equals_one_process(run, layout):
    ranks, one = run["ranks"][layout], run["one"]["train"]
    world, tp = LAYOUTS[layout]
    for r, got in enumerate(ranks):
        assert got["mesh"] == dict(data=world // tp, model=tp,
                                   data_index=r // tp, model_index=r % tp)
        train = got["train"]
        for key in one["metrics"][0]:
            np.testing.assert_allclose(train["metrics"][0][key],
                                       one["metrics"][0][key],
                                       err_msg=key, **MESH_METRIC_TOL)
        assert set(train["g"]) == set(one["g"])
        for key, want in one["g"].items():
            np.testing.assert_allclose(train["g"][key].numpy(),
                                       want.numpy(), err_msg=key,
                                       **MESH_PARAM_TOL)
        for key, want in one["d"].items():
            np.testing.assert_allclose(train["d"][key].numpy(),
                                       want.numpy(), err_msg=key,
                                       **MESH_PARAM_TOL)
        # A sharded leaf is its block, and so are its Adam moments.
        assert len(train["blocks"]) == 23
        for key, block in train["blocks"].items():
            assert train["block_moment_shapes"][key] == (
                tuple(block.shape),) * 2
        assert train["g_numel"] < sum(v.numel() for k, v in one["g"].items()
                                      if "running_" not in k
                                      and "num_batches" not in k)
    # Ranks of one model index hold the same blocks, bit for bit.
    for r in range(tp, world):
        for key, block in ranks[r]["train"]["blocks"].items():
            assert torch.equal(block, ranks[r % tp]["train"]["blocks"][key])


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_tensor_parallel_gradients_equal_one_process(run, layout):
    """G's Adam first moments (its gradient, gathered) after a step with
    D's rate 0 (G's gradient comes before G's update), as
    ``assert_moments_close`` holds them. With D's rate, D's first update
    turns sum-order noise in its near-zero gradients into +-lr steps,
    which move G's gradient through D by some percent (the parameter
    limits above allow for that, the moments would not). D is not
    partitioned and its moments are not held here: at this geometry a
    LeakyReLU unit of D flips between the two sides' fake images, which
    differ by 5.7e-7, and moves D's first-layer gradient by 1.5% of its
    largest value (a jump, not a slope: half that difference in the image
    moves it as much, a tenth by 1.6e-7)."""
    one = run["one"]["update"]
    for got in run["ranks"][layout]:
        assert_moments_close(
            {k: v.numpy() for k, v in got["update"]["g_moments"].items()},
            one["g_moments"], zero_gradient=ZERO_GRADIENT)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_tensor_parallel_update_equals_one_process(run, layout):
    """G's change in one step (gathered, less its start) against one
    process's, with D's rate 0 so that G's gradient is one process's as the
    test above holds it. Adam's first step moves an entry by
    lr * g / (|g| + eps): by at most lr (plus the float32 rounding of the
    parameter, which is below 1% of it here), and by nearly lr with the
    gradient's sign where |g| stands clear of eps. So wherever the first
    moment stands clear of ``assert_moments_close``'s limit (and the sign
    is the same on both sides) the changes agree within lr / 10; elsewhere
    the sign is rounding noise. No update, a flipped one or one applied to
    the wrong block fails. Every block moved."""
    start, one = run["setup"]["g"], run["one"]["update"]
    lr = run["cfg"].lr_g
    top = max(float(m.abs().max()) for m in one["g_moments"].values())
    for got in run["ranks"][layout]:
        update = got["update"]
        for key, m in one["g_moments"].items():
            want = one["g"][key] - start[key]
            delta = update["g"][key] - start[key]
            assert float(delta.abs().max()) <= lr * 1.01, key
            limit = max(2e-4 * float(m.abs().max()), 1e-5 * top)
            clear = m.abs() > 2 * limit
            if key in ZERO_GRADIENT or not clear.any():
                continue
            err = float((delta - want)[clear].abs().max())
            assert err <= lr / 10, (key, err)
        for key in update["blocks"]:
            moved = update["g"][key] - start[key]
            assert float(moved.abs().max()) > lr / 2, key


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_tensor_parallel_whole_leaves_stay_equal_over_model_ranks(
        run, layout):
    """Two steps at both rates with every whole parameter's gradient
    shifted by ``PERTURB`` on model rank 1 before the gradients are
    averaged (the card's float32 atomics make the model ranks' gradients
    differ in rounding): the model ranks of a data index still hold G and D
    equal bit for bit, so Adam cannot turn the difference into +-lr steps
    that part them."""
    world, tp = LAYOUTS[layout]
    ranks = run["ranks"][layout]
    for r in range(world):
        first = ranks[r - r % tp]["drift"]
        for net in ("g", "d"):
            for key, value in ranks[r]["drift"][net].items():
                assert torch.equal(value, first[net][key]), (r, net, key)


def test_tensor_parallel_step_matches_the_jax_step(run):
    """The 2 x 2 step against the JAX train step at the global batch: the
    metrics, and BatchNorm's running statistics after it."""
    from vae_gan_mark_tpu_torch.utils.port_jax import state_dict_from_jax
    jax_cfg = jax_get_config("v2", **TP)
    batch = run["setup"]["jobs"]["train"]["batches"][0]
    jax_state, ref = jax.jit(jax_build_train_step(jax_cfg))(
        run["jax_state"], run["jax_vgg"], batch, jax.random.PRNGKey(1),
        jnp.float32(KL_WEIGHT))
    got = run["ranks"]["2x2"][0]["train"]
    for key in ref:
        np.testing.assert_allclose(got["metrics"][0][key], float(ref[key]),
                                   err_msg=key, **METRIC_TOL)
    g_ref = state_dict_from_jax(numpy_tree(jax_state.g_params),
                                numpy_tree(jax_state.g_batch_stats),
                                run["cfg"])
    for key, value in got["g"].items():
        if "running_" in key:
            np.testing.assert_allclose(value.numpy(), g_ref[key].numpy(),
                                       err_msg=key, **STATE_TOL)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_clip_norm_with_the_model_axis_equals_one_process(run, layout):
    one = run["one"]["clip"]
    for got in run["ranks"][layout]:
        np.testing.assert_allclose(got["clip"]["norm"], one["norm"],
                                   rtol=1e-5)
        assert one["norm"] > 1e-3          # the clip scaled the gradients
        for key, want in one["grads"].items():
            np.testing.assert_allclose(got["clip"]["grads"][key].numpy(),
                                       want.numpy(), rtol=1e-4, atol=1e-9,
                                       err_msg=key)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_gather_backward_is_the_slice(run, layout):
    """The whole tensor forward; backward, this rank's block of the
    cotangent, once (``torch.distributed.nn``'s all_gather would sum the
    ranks' equal cotangents: tp times it)."""
    job = run["setup"]["jobs"]["gather"]
    world, tp = LAYOUTS[layout]
    for got in run["ranks"][layout]:
        i = got["mesh"]["model_index"]
        size = job["full"].shape[1] // tp
        assert torch.equal(got["gather"]["whole"], job["full"])
        assert torch.equal(got["gather"]["grad"],
                           job["cotangent"][:, i * size:(i + 1) * size])


def test_dryrun_on_the_cpu():
    """``python -m vae_gan_mark_tpu_torch.parallel.dryrun --processes 2
    --device cpu --tiny``: a (1, 2) mesh, one line a process, every metric
    finite; without ``--device cpu`` it needs the card."""
    proc = subprocess.run(
        [sys.executable, "-m", "vae_gan_mark_tpu_torch.parallel.dryrun",
         "--processes", "2", "--device", "cpu", "--tiny"], cwd=ROOT,
        env=worker_env(), capture_output=True, text=True, timeout=300)
    output = proc.stdout[-6000:] + proc.stderr[-3000:]
    assert proc.returncode == 0, output
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("dryrun tiny ok")]
    assert [ln.split()[4] for ln in lines] == ["0/2", "1/2"], output
    assert all("mesh={'data': 1, 'model': 2}" in ln for ln in lines)
    if not torch.cuda.is_available():
        refused = subprocess.run(
            [sys.executable, "-m", "vae_gan_mark_tpu_torch.parallel.dryrun",
             "--processes", "2"], cwd=ROOT, env=worker_env(),
            capture_output=True, text=True, timeout=300)
        assert refused.returncode != 0
        assert "no CUDA device" in refused.stderr
