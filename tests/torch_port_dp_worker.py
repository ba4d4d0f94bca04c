"""One process of a data-parallel run of the port on the CPU (gloo), for
``tests/test_torch_port_parallel.py``; it imports no JAX.

    python tests/torch_port_dp_worker.py SETUP RANK WORLD PORT OUT_DIR

``SETUP`` is a ``torch.save`` file from the test: the config overrides, the
G, D and VGG state dicts, the global batches, and the list of jobs. The
process joins the group at ``localhost:PORT``, runs every job on its rows
and writes what the test compares to ``OUT_DIR/rank{RANK}.pt``:

* ``train``: train steps on the global batches (this process's rows),
  the metrics of each step, both Adams' first moments after the first,
  G and D (parameters and buffers) after the last;
* ``batch_norm``: one train-mode ``BatchNorm`` forward and backward, plain
  and row-weighted, on this process's rows of a global input;
* ``trainer``: ``Trainer.fit`` for two epochs into a shared workdir, then a
  new ``Trainer`` that resumes and trains a third, and the refusals of
  ``multi_step > 1`` and of device-resident data.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from vae_gan_mark_tpu_torch.config import get_config  # noqa: E402
from vae_gan_mark_tpu_torch.models import VGG16Features  # noqa: E402
from vae_gan_mark_tpu_torch.ops.norms import BatchNorm  # noqa: E402
from vae_gan_mark_tpu_torch.parallel import distributed, mesh  # noqa: E402
from vae_gan_mark_tpu_torch.train import (  # noqa: E402
    batch_to_device, build_train_step, create_train_state)
from vae_gan_mark_tpu_torch.train.step import make_generator  # noqa: E402


def state_tensors(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def exp_avgs(module, opt):
    return {name: opt.state[p]["exp_avg"].clone()
            for name, p in module.named_parameters()}


def train_job(setup, job):
    cfg = get_config("v2", **job["overrides"])
    state = create_train_state(cfg, setup["g"], setup["d"], device="cpu")
    vgg = VGG16Features()
    vgg.load_state_dict(setup["vgg"])
    step = build_train_step(cfg)
    out = {"metrics": []}
    for i, batch in enumerate(job["batches"]):
        local = mesh.shard_batch(batch_to_device(batch, "cpu"))
        state, metrics = step(state, vgg, local,
                              make_generator("cpu", 7, state.step),
                              job["kl_weight"])
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        if i == 0:
            out["g_moments"] = exp_avgs(state.generator, state.opt_g)
            out["d_moments"] = exp_avgs(state.discriminator, state.opt_d)
    out["g"] = state_tensors(state.generator)
    out["d"] = state_tensors(state.discriminator)
    return out


def batch_norm_job(setup, job):
    out = {}
    for name, weights in (("plain", None), ("rows", job["row_weights"])):
        x = torch.from_numpy(job["x"])[mesh.local_rows(job["x"].shape[0])]
        x = x.clone().requires_grad_(True)
        bn = BatchNorm(x.shape[1])
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(job["scale"]))
            bn.bias.copy_(torch.from_numpy(job["bias"]))
        y = bn.train()(x, weights)
        cot = torch.from_numpy(job["cotangent"])[mesh.local_rows(
            job["x"].shape[0])]
        if weights is not None:     # row i stands for weights[i] rows
            cot = cot * torch.tensor(weights).view(1, 1, -1, 1)
        (y * cot).sum().backward()
        out[name] = {"y": y.detach(), "dx": x.grad,
                     "dscale": bn.weight.grad, "dbias": bn.bias.grad,
                     "mean": bn.running_mean.clone(),
                     "var": bn.running_var.clone()}
    return out


def trainer_job(setup, job):
    from vae_gan_mark_tpu_torch.train.loop import Trainer

    cfg = get_config("v2", **job["overrides"])
    batches = job["batches"]

    def train_data(epoch):
        for i in range(2):
            yield mesh.shard_batch(batches[(i + 2 * epoch) % len(batches)])

    def val_data(epoch):
        yield mesh.shard_batch(batches[0])

    def trainer():
        return Trainer(cfg, train_data, val_data, job["workdir"], seed=3,
                       device="cpu", init=(setup["g"], setup["d"]),
                       vgg_state_dict=setup["vgg"])

    first = trainer()
    first.fit(2)
    saved = state_tensors(first.state.generator)
    resumed = trainer()
    out = {"resumed_epoch": resumed.epoch, "resumed_step":
           resumed.state.step,
           "resumed_equal": all(torch.equal(saved[k], v) for k, v in
                                state_tensors(resumed.state.generator)
                                .items())}
    resumed.fit(3)
    out["g"] = state_tensors(resumed.state.generator)
    out["lr_g"] = resumed.state.opt_g.param_groups[0]["lr"]
    refused = []
    try:
        Trainer(cfg, train_data, val_data, job["workdir"] + "_k", seed=3,
                device="cpu", init=(setup["g"], setup["d"]),
                vgg_state_dict=setup["vgg"], multi_step=2)
    except ValueError as e:
        refused.append(str(e))

    from vae_gan_mark_tpu_torch.data.device_synthetic import (
        DeviceResidentSynthetic)
    from vae_gan_mark_tpu_torch.data.synthetic import SyntheticPatchDataset
    resident = DeviceResidentSynthetic(SyntheticPatchDataset(cfg, 8), 4, 2,
                                       device="cpu")
    try:
        Trainer(cfg, resident, None, job["workdir"] + "_d", seed=3,
                device="cpu", init=(setup["g"], setup["d"]),
                vgg_state_dict=setup["vgg"])
    except ValueError as e:
        refused.append(str(e))
    out["refused"] = refused
    return out


JOBS = {"train": train_job, "batch_norm": batch_norm_job,
        "trainer": trainer_job}


def main():
    setup_path, rank, world, port, out_dir = sys.argv[1:6]
    torch.set_num_threads(1)
    setup = torch.load(setup_path, weights_only=False)
    distributed.initialize(f"localhost:{port}", int(world), int(rank),
                           device="cpu")
    results = {name: JOBS[job["kind"]](setup, job)
               for name, job in setup["jobs"].items()}
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    distributed.shutdown()


if __name__ == "__main__":
    main()
