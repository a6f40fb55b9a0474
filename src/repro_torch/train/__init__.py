"""Training: loss, optimizer, train-step factory (port of
`repro.train`)."""
from repro_torch.train.loss import chunked_cross_entropy  # noqa: F401
from repro_torch.train.optimizer import adamw_init, adamw_update  # noqa: F401
from repro_torch.train.train_step import make_train_step  # noqa: F401
