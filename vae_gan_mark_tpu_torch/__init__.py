"""vae_gan_mark_tpu_torch -- the generator's serving path and the v2 GAN
train step in PyTorch for an NVIDIA H100, beside the JAX package it ports.

* ``config``, ``data/tokenizer``: copies of the JAX package's host modules.
* ``ops``: BatchNorm (train and eval), InstanceNorm, spectral norm, conv
  blocks, pooling, resize, sampling and the KL term, SpatialFiLM, the GRU
  layers and the perspective warp, all NCHW tensors except where a function
  keeps the JAX package's NHWC layout.
* ``ops/gru.py`` + ``csrc/gru_fwd.cu``, ``csrc/gru_bwd.cu``: the GRU
  recurrence and its gradient as CUDA kernels for ``sm_90a``;
  ``ops/conv_probe.py`` + ``csrc/conv3x3.cu``: the conv probe's 3x3 conv.
  Each is built with ``nvcc`` at first use (``ops/cuda_build.py``) and has
  its plain PyTorch version for CPU tensors.
* ``models``: the v2 (and unet) generator, the patch discriminator and the
  VGG16 head, with the reference's state-dict keys.
* ``losses``, ``eval``: the training losses and the eval step's metrics.
* ``train``: the train state and the train and eval steps.
* ``serve/engine.py``: ``InferenceEngine`` (NHWC numpy in and out).
* ``utils/port_jax.py``: JAX parameter trees -> ``state_dict``.

Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``;
without a card they raise. Nothing here imports JAX or the JAX package.
"""

__version__ = "0.2.0"

from vae_gan_mark_tpu_torch.config import VariantConfig, VARIANTS, get_config  # noqa: F401
