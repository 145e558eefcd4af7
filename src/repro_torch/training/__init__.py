from repro_torch.training.optimizer import (  # noqa: F401
    AdamWConfig,
    adamw_update,
    init_opt_state,
    opt_state_specs,
)
from repro_torch.training.train_loop import (  # noqa: F401
    TrainState,
    abstract_train_state,
    init_train_state,
    make_eval_step,
    make_train_step,
    train_state_specs,
)
