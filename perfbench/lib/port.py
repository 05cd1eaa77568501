"""The program under test, as the benchmark drives it: the ``repro_torch``
package from the checkout's ``src``.

``model_config`` turns a configuration file into the port's
``ModelConfig`` (its registered architecture, with every field the file
states set as stated). ``build`` makes the port's model without drawing
anything: the modules are built on the ``meta`` device and each parameter
is then the benchmark's own tensor, the same one the reference reads.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path
from typing import Dict

import torch
from torch import nn

SRC = Path(__file__).resolve().parents[2] / "src"


def import_port():
    """Put the checkout's ``src`` first on the path (the program under
    test; the JAX package beside it is never imported)."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    import repro_torch  # noqa: F401


def model_config(cfg: Dict):
    import_port()
    from repro_torch.configs import get_config

    base = get_config(cfg["arch"])
    fields = {f.name for f in dataclasses.fields(base)}
    return dataclasses.replace(base, **{k: v for k, v in cfg.items()
                                        if k in fields and k != "name"})


def build(cfg: Dict, weights: Dict[str, torch.Tensor]):
    """The port's model over ``weights`` (its parameters are these tensors,
    not copies); every parameter must have a weight of its shape and dtype."""
    from repro_torch.models import build_model

    model = build_model(model_config(cfg), device="meta")
    names = dict(model.named_parameters())
    if set(names) != set(weights):
        raise KeyError(f"weights and the port's parameters differ: "
                       f"{sorted(set(names) ^ set(weights))[:6]}")
    for name, p in names.items():
        w = weights[name]
        if tuple(w.shape) != tuple(p.shape) or w.dtype != p.dtype:
            raise ValueError(f"{name}: weight {tuple(w.shape)} {w.dtype}, the port's "
                             f"{tuple(p.shape)} {p.dtype}")
        owner, _, leaf = name.rpartition(".")
        model.get_submodule(owner).register_parameter(leaf, nn.Parameter(w, requires_grad=False))
    return model
