from repro_torch.models.api import build_model, Model  # noqa: F401
