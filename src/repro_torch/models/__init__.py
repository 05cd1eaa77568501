from repro_torch.models.api import build_model  # noqa: F401
