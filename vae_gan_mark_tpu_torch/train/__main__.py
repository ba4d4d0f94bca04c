"""`python -m vae_gan_mark_tpu_torch.train`: the training CLI (see cli.py)."""

from vae_gan_mark_tpu_torch.cli import main

if __name__ == "__main__":
    main()
