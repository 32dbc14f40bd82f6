from repro_torch.train.state import TrainState  # noqa: F401
from repro_torch.train.step import build_train_step, build_loss_fn  # noqa: F401
from repro_torch.train.optimizer import adamw  # noqa: F401
from repro_torch.train.schedule import warmup_cosine  # noqa: F401
