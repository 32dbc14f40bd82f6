"""Flor core: the paper's record-replay machinery."""
from repro_torch.core.adaptive import AdaptiveController  # noqa: F401
from repro_torch.core.context import FlorContext, get_context  # noqa: F401
