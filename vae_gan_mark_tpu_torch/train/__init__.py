"""Training: the state (G, D, two Adam optimizers), the train and eval
steps, checkpoints, schedules, the metric logger and the epoch driver
``Trainer`` (``python -m vae_gan_mark_tpu_torch.train``)."""

from vae_gan_mark_tpu_torch.train.state import (  # noqa: F401
    TrainState, create_train_state, get_lr, init_state_dicts, set_lr)
from vae_gan_mark_tpu_torch.train.step import (  # noqa: F401
    batch_to_device, build_eval_step, build_train_step)
