from repro_torch.models.api import build_model, card_unless_asked  # noqa: F401
