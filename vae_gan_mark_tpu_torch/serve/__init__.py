"""Serving: a fixed-batch inference engine over the generator."""

from vae_gan_mark_tpu_torch.serve.engine import InferenceEngine  # noqa: F401
