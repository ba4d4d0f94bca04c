"""vae_gan_mark_tpu_torch -- the generator's serving path in PyTorch for an
NVIDIA H100, beside the JAX package it ports.

* ``config``, ``data/tokenizer``: copies of the JAX package's host modules.
* ``ops``: BatchNorm (eval), conv blocks, pooling, resize, sampling,
  SpatialFiLM, the GRU layers and the perspective warp, all NCHW tensors
  except where a function keeps the JAX package's NHWC layout.
* ``ops/gru.py`` + ``csrc/gru_fwd.cu``: the GRU recurrence as a CUDA kernel
  for ``sm_90a``, built with ``nvcc`` at first use, with its plain PyTorch
  version for CPU tensors.
* ``models``: the v2 (and unet) generator, with the reference's
  state-dict keys.
* ``serve/engine.py``: ``InferenceEngine`` (NHWC numpy in and out).
* ``utils/port_jax.py``: JAX parameter trees -> ``state_dict``.

Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``;
without a card they raise. Nothing here imports JAX or the JAX package.
"""

__version__ = "0.1.0"

from vae_gan_mark_tpu_torch.config import VariantConfig, VARIANTS, get_config  # noqa: F401
