"""Training (port of ``src/repro/train``): optimizers, the train step, and
checkpoints into OffloadDB; ``train.e2e`` is the end-to-end trainer."""
from repro_torch.train.optim import adafactor, adamw, sgd_momentum  # noqa: F401
from repro_torch.train.step import init_state, make_eval_step, make_train_step  # noqa: F401
