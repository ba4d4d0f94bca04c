"""One process of a tensor-parallel (data x model) run of the port over
gloo, for ``tests/test_torch_port_model_axis.py`` (on the CPU) and the card
tests of ``tests/test_torch_port_gpu.py``; it imports no JAX.

    python tests/torch_port_tp_worker.py SETUP RANK WORLD TP PORT OUT_DIR \
        [DEVICE]

``SETUP`` is a ``torch.save`` file from the test: the config overrides, the
G, D and VGG state dicts, the global batches, ``kernel_min_ch`` and the
jobs. The process joins the group at ``localhost:PORT`` (gloo, its tensors
on ``DEVICE``, the CPU by default), lays the ranks
out as ``make_mesh(TP)``, runs every job and writes what the test compares
to ``OUT_DIR/rank{RANK}.pt`` (``run_job`` is also the test's one-process
reference, without a group):

* ``train``: G partitioned, train steps on this data index's rows of the
  global batches; the metrics, ``gather_params`` of G, both Adams' first
  moments (G's gathered), this rank's blocks and their moments' shapes,
  the G parameters this rank holds, D, and the GRU kernels' launches
  (0 on the CPU, where the plain GRU runs). With ``perturb``, every whole
  parameter's gradient (G's and D's) gets ``perturb`` times the model
  index added as it is computed, before the gradients are averaged: the
  rounding by which model ranks' gradients differ on the card, made
  larger;
* ``clip``: one G forward and backward, then ``clip_by_global_norm_``:
  the norm and the clipped gradients gathered;
* ``gather``: ``gather_at_use`` of a block, forward and backward.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from vae_gan_mark_tpu_torch.config import get_config  # noqa: E402
from vae_gan_mark_tpu_torch.models import (  # noqa: E402
    VAEGANGenerator, VGG16Features)
from vae_gan_mark_tpu_torch.ops import gru  # noqa: E402
from vae_gan_mark_tpu_torch.parallel import distributed, mesh  # noqa: E402
from vae_gan_mark_tpu_torch.train import (  # noqa: E402
    batch_to_device, build_train_step, create_train_state)
from vae_gan_mark_tpu_torch.train.state import (  # noqa: E402
    clip_by_global_norm_)
from vae_gan_mark_tpu_torch.train.step import make_generator  # noqa: E402


def gathered(module, values):
    """{name: tensor} of ``module``'s parameters, each gathered whole, on
    the CPU."""
    params = dict(module.named_parameters())
    return {k: (v.detach().clone() if mesh.sharded_dim(params[k]) is None
                else mesh.gather_tensor(v, mesh.sharded_dim(params[k]))).cpu()
            for k, v in values.items()}


def train_job(setup, job, device="cpu"):
    cfg = get_config("v2", **job["overrides"])
    state = create_train_state(cfg, setup["g"], setup["d"], device=device)
    mesh.replicate_(state.generator)
    mesh.partition_params(state.generator,
                          kernel_min_ch=job["kernel_min_ch"])
    if job.get("perturb"):
        shift = job["perturb"] * mesh.current_mesh().model_index
        for p in [*state.generator.parameters(),
                  *state.discriminator.parameters()]:
            if mesh.sharded_dim(p) is None:
                p.register_hook(lambda grad: grad + shift)
    vgg = VGG16Features()
    vgg.load_state_dict(setup["vgg"])
    vgg.to(device)
    step = build_train_step(cfg)
    out = {"metrics": []}
    launches = gru.KERNEL.launches, gru.BACKWARD_KERNEL.launches
    for batch in job["batches"]:
        local = mesh.shard_batch(batch_to_device(batch, device))
        state, metrics = step(state, vgg, local,
                              make_generator(device, 7, state.step),
                              job["kl_weight"])
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
    out["gru_launches"] = (gru.KERNEL.launches - launches[0],
                           gru.BACKWARD_KERNEL.launches - launches[1])
    g = state.generator
    opt = state.opt_g
    out["g"] = {k: v.cpu().clone() for k, v in mesh.gather_params(g).items()}
    out["g_moments"] = gathered(g, {n: opt.state[p]["exp_avg"]
                                    for n, p in g.named_parameters()})
    out["d_moments"] = {n: state.opt_d.state[p]["exp_avg"].cpu().clone()
                        for n, p in state.discriminator.named_parameters()}
    out["blocks"] = {n: p.detach().cpu().clone()
                     for n, p in g.named_parameters()
                     if mesh.sharded_dim(p) is not None}
    out["block_moment_shapes"] = {
        n: (tuple(opt.state[p]["exp_avg"].shape),
            tuple(opt.state[p]["exp_avg_sq"].shape))
        for n, p in g.named_parameters() if mesh.sharded_dim(p) is not None}
    out["g_numel"] = sum(p.numel() for p in g.parameters())
    out["d"] = {k: v.cpu().clone()
                for k, v in state.discriminator.state_dict().items()}
    return out


def clip_job(setup, job, device="cpu"):
    cfg = get_config("v2", **job["overrides"])
    g = VAEGANGenerator(cfg)
    g.load_state_dict(setup["g"])
    g.to(device)
    mesh.partition_params(g, kernel_min_ch=job["kernel_min_ch"])
    g.train()
    batch = mesh.shard_batch(batch_to_device(job["batches"][0], device))
    recon, mu, logvar = g(batch["ru"], batch["mask"], batch["text"],
                          eps=batch["eps"])
    loss = (recon - batch["en"]).abs().mean() + mu.square().mean() \
        + logvar.square().mean()
    loss.backward()
    mesh.average_gradients_(g.parameters())
    norm = clip_by_global_norm_(g.parameters(), job["max_norm"])
    return {"norm": float(norm),
            "grads": gathered(g, {n: p.grad
                                  for n, p in g.named_parameters()})}


def gather_job(setup, job, device="cpu"):
    full = job["full"].to(device)
    m = mesh.current_mesh()
    size = full.shape[job["dim"]] // m.model
    block = full.narrow(job["dim"], m.model_index * size, size).clone()
    block.requires_grad_(True)
    setattr(block, mesh.SHARD_DIM, job["dim"])
    whole = mesh.gather_at_use(block)
    (whole * job["cotangent"].to(device)).sum().backward()
    return {"whole": whole.detach().cpu(), "grad": block.grad.cpu(),
            "device": str(whole.device)}


JOBS = {"train": train_job, "clip": clip_job, "gather": gather_job}


def run_job(setup, job, device="cpu"):
    return JOBS[job["kind"]](setup, job, device)


def main():
    setup_path, rank, world, tp, port, out_dir = sys.argv[1:7]
    device = sys.argv[7] if len(sys.argv) > 7 else "cpu"
    torch.set_num_threads(1)
    setup = torch.load(setup_path, weights_only=False)
    distributed.initialize(f"localhost:{port}", int(world), int(rank),
                           backend="gloo", device=device)
    m = mesh.make_mesh(int(tp))
    results = {name: run_job(setup, job, device)
               for name, job in setup["jobs"].items()}
    results["mesh"] = dict(m.shape, data_index=m.data_index,
                           model_index=m.model_index)
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    distributed.shutdown()


if __name__ == "__main__":
    main()
