"""Public model-construction API."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.stack import StackModel


def build_model(cfg: ModelConfig, device=None) -> StackModel:
    """Build the model's modules on ``device``, by default the card.

    The parameters are allocated but not initialised: call
    ``model.init(generator)`` or load weights. ``device="cpu"`` builds on
    the CPU, and ``"meta"`` allocates nothing (for counting); without a
    device and without CUDA this raises rather than falling back to the CPU.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model: CUDA is not available; the port runs on the "
                           "card by default (pass device='cpu' to ask for the CPU)")
    return StackModel(cfg, device)
