"""Training substrate: optimizer, data pipeline, train loop."""

from .data import DataConfig, SyntheticLMDataset, sample_device_tasks, task_profiles  # noqa: F401
from .optimizer import OptimizerConfig, apply_gradients, init_optimizer  # noqa: F401
from .train_loop import lm_loss, make_eval_step, make_train_step  # noqa: F401
