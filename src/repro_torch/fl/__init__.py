"""Federated-learning building blocks of the port: the CNN task and the
cohort's local update."""
from repro_torch.fl.task import FLTask, make_cnn_task  # noqa: F401
