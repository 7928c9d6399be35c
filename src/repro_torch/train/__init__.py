from .optimizer import AdamState, OptConfig, ZeroState, adam_init, adam_update  # noqa: F401
from .train_step import TrainConfig, make_train_step  # noqa: F401
