"""Training: the state (G, D, two Adam optimizers) and the train and eval
steps."""

from vae_gan_mark_tpu_torch.train.state import (  # noqa: F401
    TrainState, create_train_state, get_lr, set_lr)
from vae_gan_mark_tpu_torch.train.step import (  # noqa: F401
    batch_to_device, build_eval_step, build_train_step)
