"""Federated-learning building blocks of the port: the CNN and LM tasks,
the cohort's local update, the FedAvg server and the legacy round wrappers."""
from repro_torch.fl.config import FLConfig  # noqa: F401
from repro_torch.fl.rounds import make_round_fn, rounds_to_target, run_training  # noqa: F401
from repro_torch.fl.task import FLTask, make_cnn_task, make_lm_task  # noqa: F401
