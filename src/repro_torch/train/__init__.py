"""The training stack: the train step (loss -> grads -> AdamW), the
Trainer (data, checkpoints, restarts, straggler monitoring) and GPipe
pipeline parallelism over a mesh dim of stages."""
from repro_torch.train.train_step import (  # noqa: F401
    TrainConfig,
    abstract_train_state,
    init_train_state,
    make_train_step,
)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: F401
from repro_torch.train.pipeline import gpipe, pipeline_apply  # noqa: F401
