"""vae_gan_mark_tpu_torch -- the JAX package ``vae_gan_mark_tpu`` in
PyTorch for an NVIDIA H100: serving, training, data parallelism and the
serving artifact, beside the JAX package it ports.

* ``config``, ``data/tokenizer``: copies of the JAX package's host modules.
* ``ops``: BatchNorm (train and eval), InstanceNorm, spectral norm, conv
  blocks, pooling, resize, sampling and the KL term, SpatialFiLM, the GRU
  layers and the perspective warp, all NCHW tensors except where a function
  keeps the JAX package's NHWC layout.
* ``ops/gru.py`` + ``csrc/gru_fwd.cu``, ``csrc/gru_bwd.cu``: the GRU
  recurrence and its gradient as CUDA kernels for ``sm_90a``;
  ``ops/conv_probe.py`` + ``csrc/conv3x3.cu``: the conv probe's 3x3 conv.
  Each is built with ``nvcc`` at first use (``ops/cuda_build.py``) and has
  its plain PyTorch version for CPU tensors; the GRU's are also
  ``torch.library`` custom ops.
* ``models``: every variant's generator, the patch discriminator and the
  VGG16 head, with the reference's state-dict keys.
* ``losses``, ``eval``: the training losses and the eval step's metrics.
* ``train``: the train state, the train and eval steps, the epoch loop
  (``Trainer``) and its checkpoints.
* ``parallel``: one process per card in a ``torch.distributed`` group.
* ``serve/engine.py``: ``InferenceEngine`` (NHWC numpy in and out);
  ``serve/export.py``: the ``torch.export`` serving artifact.
* ``doctor``, ``utils``: pre-flight checks, profiling, the JAX and
  reference-checkpoint weight loaders.

Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``;
without a card they raise. Nothing here imports JAX or the JAX package.
"""

__version__ = "0.2.0"

from vae_gan_mark_tpu_torch.config import VariantConfig, VARIANTS, get_config  # noqa: F401
