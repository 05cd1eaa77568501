"""Public model-construction API, and the scope that pins the kernels' impls."""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.stack import StackModel

_UNSET = "unset"
# name -> (getter, setter) of each kernel's impl switch
_SWITCHES = {
    "attention": (attn.get_attention_impl, attn.set_attention_impl),
    "ssd": (ssm_lib.get_ssd_impl, ssm_lib.set_ssd_impl),
    "norm": (L.get_norm_impl, L.set_norm_impl),
}


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


@contextlib.contextmanager
def use_impls(attention: Optional[str] = _UNSET, ssd: Optional[str] = _UNSET,
              norm: Optional[str] = _UNSET) -> Iterator[None]:
    """Pin the impls of the named kernels (``"plain"``, ``"cuda"`` or None,
    as their ``set_*_impl``) inside the scope and restore them after it; an
    impl not named is left as it is."""
    asked = {"attention": attention, "ssd": ssd, "norm": norm}
    saved = {name: get() for name, (get, _) in _SWITCHES.items()}
    try:
        for name, impl in asked.items():
            if impl != _UNSET:
                _SWITCHES[name][1](impl)
        yield
    finally:
        for name, impl in saved.items():
            _SWITCHES[name][1](impl)
