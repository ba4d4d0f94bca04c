"""The weight bridge (``vae_gan_mark_tpu_torch/utils/port_jax.py``): its
table of leaves matches the JAX generator's parameter trees, its keys match
the port's ``state_dict``, and the JAX package's ``port_v2_generator``
inverts it exactly."""

import numpy as np
import pytest
import torch

import jax

from vae_gan_mark_tpu.config import get_config as jax_get_config
from vae_gan_mark_tpu.utils.port_torch import port_v2_generator
from vae_gan_mark_tpu_torch.config import get_config
from vae_gan_mark_tpu_torch.models import VAEGANGenerator
from vae_gan_mark_tpu_torch.utils.port_jax import (
    random_jax_tree, state_dict_from_jax)

from torch_port_common import TINY, jax_tree_shapes_of

CASES = {"v2_tiny": ("v2", TINY), "unet_tiny": ("unet", TINY),
         "v2_full": ("v2", {})}


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


@pytest.mark.parametrize("case", ["v2_tiny", "unet_tiny"])
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
        random_jax_tree(get_config("oldv"), seed=0)
