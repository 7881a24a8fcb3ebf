"""The training slice: losses, state, the train step, checkpoints, the loop."""

from pwstablenet_tpu_torch.train.state import (  # noqa: F401
    TrainState,
    create_train_state,
)
from pwstablenet_tpu_torch.train.step import make_train_step  # noqa: F401
