"""Training orchestration."""
from learning_to_adapt_torch.trainers.trainer import Trainer  # noqa: F401
