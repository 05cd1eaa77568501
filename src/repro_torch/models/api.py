"""Public model-construction API, and the scope that pins the kernels' impls."""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers, ssm  # noqa: F401 (each makes its switch)
from repro_torch.models.stack import StackModel
from repro_torch.models.switch import SWITCHES

_UNSET = "unset"


def build_model(cfg: ModelConfig, device=None, sharder=None) -> StackModel:
    """Build the model's modules on ``device``, by default the card.

    The parameters are allocated but not initialised: call
    ``model.init(generator)`` or load weights. ``device="cpu"`` builds on
    the CPU, and ``"meta"`` allocates nothing (for counting); without a
    device and without CUDA this raises rather than falling back to the CPU.
    ``sharder`` is the activation-constraint hook of a mesh
    (``distributed.sharding.make_sharder``), None on one device.
    """
    return StackModel(cfg, card_unless_asked(device), sharder)


def card_unless_asked(device=None, ask: str = "pass device='cpu'") -> torch.device:
    """``device`` as a ``torch.device``, by default the card; a CUDA device
    where CUDA is missing raises rather than fall back to the CPU (``ask``
    says how a caller asks for the CPU)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"CUDA is not available; the port runs on the card by default "
                           f"({ask} to ask for the CPU)")
    return device


@contextlib.contextmanager
def use_impls(attention: Optional[str] = _UNSET, ssd: Optional[str] = _UNSET,
              norm: Optional[str] = _UNSET) -> Iterator[None]:
    """Pin the impls of the named kernels (``"plain"``, ``"cuda"`` or None,
    as their ``set_*_impl``) inside the scope, for the calling thread only;
    an impl not named is left as it is. Other threads keep their own impls,
    and overlapping scopes in several threads cannot undo one another
    (``repro_torch.models.switch``)."""
    asked = {"attention": attention, "ssd": ssd, "norm": norm}
    with contextlib.ExitStack() as pins:
        for name, impl in asked.items():
            if impl != _UNSET:
                pins.enter_context(SWITCHES[name].pinned(impl))
        yield
