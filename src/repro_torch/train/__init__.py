"""Training: the optimizer, the train step, gradient compression,
checkpoints and the fault-tolerant driver (counterpart of
``repro.train``)."""

from .checkpoint import (  # noqa: F401
    latest_step,
    restore_checkpoint,
    restore_latest,
    save_checkpoint,
    wait_for_async_saves,
)
from .fault_tolerance import (  # noqa: F401
    DriverConfig,
    FaultTolerantDriver,
    StragglerMonitor,
    TrainingAborted,
    elastic_plan,
)
from .optimizer import AdamWConfig, OptState, adamw_update, init_opt_state  # noqa: F401
from .train_loop import TrainConfig, init_train_state, make_train_step  # noqa: F401
