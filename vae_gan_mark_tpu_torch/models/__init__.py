"""Generator, discriminator and the VGG16 head of the perceptual loss."""

from vae_gan_mark_tpu_torch.models.discriminator import PatchDiscriminator  # noqa: F401
from vae_gan_mark_tpu_torch.models.vaegan import VAEGANGenerator  # noqa: F401
from vae_gan_mark_tpu_torch.models.vgg import VGG16Features  # noqa: F401
