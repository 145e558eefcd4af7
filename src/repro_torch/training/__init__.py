from repro_torch.training.optimizer import AdamWConfig, adamw_update, init_opt_state  # noqa: F401
from repro_torch.training.train_loop import (  # noqa: F401
    TrainState,
    init_train_state,
    make_eval_step,
    make_train_step,
)
