"""GAN training, so the fingerprint -> attribute loop can be proven on a
generator trained here: a small StyleGAN2 on procedural synthetic data or an
image folder (``cli/train.py``), then ``cli.attribute --ckpt`` on its export.
Counterpart of the reference package's ``training/``."""

from .data import sample_batch  # noqa: F401
from .gan import TrainConfig, TrainState, draw_step, init_train_state, train_step  # noqa: F401
