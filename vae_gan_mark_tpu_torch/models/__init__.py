"""Generator modules."""

from vae_gan_mark_tpu_torch.models.vaegan import VAEGANGenerator  # noqa: F401
