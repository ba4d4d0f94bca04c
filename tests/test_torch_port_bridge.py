"""The weight bridge (``vae_gan_mark_tpu_torch/utils/port_jax.py``): its
tables of leaves match the JAX generator's, discriminator's and VGG head's
parameter trees, its keys match the port's ``state_dict``s, and the JAX
package's ``port_v2_generator``, ``port_discriminator`` and
``port_vgg_head`` invert it exactly."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vae_gan_mark_tpu.config import get_config as jax_get_config
from vae_gan_mark_tpu.models.discriminator import (
    PatchDiscriminator as JaxDiscriminator)
from vae_gan_mark_tpu.models.vgg import VGG16Features as JaxVGG
from vae_gan_mark_tpu.utils.port_torch import (
    port_discriminator, port_v2_generator, port_vgg_head)
from vae_gan_mark_tpu_torch.config import get_config
from vae_gan_mark_tpu_torch.models import (
    PatchDiscriminator, VAEGANGenerator, VGG16Features)
from vae_gan_mark_tpu_torch.utils.port_jax import (
    discriminator_state_dict_from_jax, random_discriminator_tree,
    random_jax_tree, random_vgg_tree, state_dict_from_jax,
    vgg_state_dict_from_jax)

from torch_port_common import TINY, jax_tree_shapes_of

CASES = {"v2_tiny": ("v2", TINY), "unet_tiny": ("unet", TINY),
         "v2_full": ("v2", {}),
         "oldv_tiny": ("oldv", dict(TINY, enc_chans=(8, 16, 24))),
         "oldv_full": ("oldv", {})}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tree_shapes_match_jax_init(case):
    variant, overrides = CASES[case]
    jax_shapes = jax_tree_shapes_of(jax_get_config(variant, **overrides))
    trees = random_jax_tree(get_config(variant, **overrides), seed=0)
    params, stats = jax.tree.map(np.shape, trees)
    assert params == jax_shapes["params"]
    assert stats == jax_shapes["batch_stats"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_state_dict_keys_and_shapes_match_port(case):
    variant, overrides = CASES[case]
    cfg = get_config(variant, **overrides)
    params, stats = random_jax_tree(cfg, seed=0)
    sd = state_dict_from_jax(params, stats, cfg)
    model_sd = VAEGANGenerator(cfg).state_dict()
    assert sd.keys() == model_sd.keys()
    for key, value in sd.items():
        assert value.shape == model_sd[key].shape, key
        assert value.dtype == torch.float32, key


@pytest.mark.parametrize("case", ["v2_tiny", "unet_tiny", "oldv_tiny"])
def test_round_trip_through_port_v2_generator(case):
    variant, overrides = CASES[case]
    cfg = get_config(variant, **overrides)
    params, stats = random_jax_tree(cfg, seed=1)
    sd = state_dict_from_jax(params, stats, cfg)
    back_params, back_stats = port_v2_generator(sd, cfg)
    flat = jax.tree_util.tree_flatten_with_path
    for ours, theirs in ((params, back_params), (stats, back_stats)):
        a, b = flat(ours)[0], flat(theirs)[0]
        assert [p for p, _ in a] == [p for p, _ in b]
        for (path, x), (_, y) in zip(a, b):
            assert x.shape == y.shape, path
            np.testing.assert_array_equal(x, y, err_msg=str(path))


def test_random_tree_is_seeded():
    cfg = get_config("v2", **TINY)
    a, _ = random_jax_tree(cfg, seed=5)
    b, _ = random_jax_tree(cfg, seed=5)
    c, _ = random_jax_tree(cfg, seed=6)
    leaves = jax.tree_util.tree_leaves
    assert all(np.array_equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    assert not all(np.array_equal(x, y) for x, y in zip(leaves(a), leaves(c)))
    _, stats = random_jax_tree(cfg, seed=5)
    assert all(v.min() > 0 for path, v in
               jax.tree_util.tree_flatten_with_path(stats)[0]
               if "var" in str(path[-1]))


def test_bridge_rejects_wrong_shapes_and_variants():
    cfg = get_config("v2", **TINY)
    params, stats = random_jax_tree(cfg, seed=0)
    params["decoder"]["Conv_0"]["bias"] = np.zeros(4, np.float32)
    with pytest.raises(ValueError, match="Conv_0"):
        state_dict_from_jax(params, stats, cfg)
    with pytest.raises(NotImplementedError):
        random_jax_tree(get_config("vanilla"), seed=0)


def _disc_trees(seed):
    params, spectral = random_discriminator_tree(seed)
    return {"params": params, "spectral": spectral}


def _vgg_trees(seed):
    return {"params": random_vgg_tree(seed)}


NETWORKS = {
    # name: (seeded trees, JAX module, input shape, bridge, port module,
    #        the JAX package's inverse)
    "discriminator": (
        _disc_trees, JaxDiscriminator(), (1, 32, 64, 3),
        lambda t: discriminator_state_dict_from_jax(t["params"],
                                                    t["spectral"]),
        PatchDiscriminator,
        lambda sd: dict(zip(("params", "spectral"), port_discriminator(sd)))),
    "vgg": (
        _vgg_trees, JaxVGG(), (1, 32, 32, 3),
        lambda t: vgg_state_dict_from_jax(t["params"]), VGG16Features,
        lambda sd: {"params": port_vgg_head(sd)}),
}


@pytest.mark.parametrize("network", sorted(NETWORKS))
def test_other_networks_match_jax_and_invert(network):
    """Tree shapes equal the JAX module's init, the state dict loads into
    the port's module with every key, and the JAX package's inverse gives
    the trees back bit for bit."""
    make, jax_module, in_shape, bridge, port_cls, inverse = NETWORKS[network]
    trees = make(seed=3)
    variables = jax.eval_shape(
        lambda x: jax_module.init(jax.random.PRNGKey(0), x),
        jax.ShapeDtypeStruct(in_shape, jnp.float32))
    assert jax.tree.map(np.shape, trees) == jax.tree.map(
        lambda v: tuple(v.shape), dict(variables))
    sd = bridge(trees)
    port = port_cls()
    assert sd.keys() == port.state_dict().keys()
    port.load_state_dict(sd)
    back = inverse(sd)
    flat = jax.tree_util.tree_flatten_with_path
    a, b = flat(trees)[0], flat(jax.tree.map(np.asarray, back))[0]
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        np.testing.assert_array_equal(x, y, err_msg=str(path))
    if network == "discriminator":
        for u in trees["spectral"].values():
            assert np.linalg.norm(u["u"]) == pytest.approx(1.0, rel=1e-6)
