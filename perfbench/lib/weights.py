"""The weights of a run, drawn on the device from the seed.

A reference family's ``layout`` lists each weight with its shape, storage
kind ("model": the configuration's dtype; "fp32") and the mean and spread
of its values. All weights of one kind live in one flat buffer, each at an
offset aligned to 256 bytes, and the whole buffer is filled by a few large
``normal_`` calls from one ``torch.Generator`` on the device; each weight
is then shifted and scaled in place. The same seed on the same device
gives the same weights. The program under test and the reference both
read these tensors; neither makes weights of its own.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from perfbench.lib.seeds import derive

ALIGN_BYTES = 256
DRAW = 1 << 30  # elements a normal_ call fills
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def draw(layout, seed: int, device, model_dtype: str) -> Dict[str, torch.Tensor]:
    """{name: tensor} for every entry of ``layout``, views of one buffer per
    storage kind."""
    kinds = {"model": DTYPES[model_dtype], "fp32": torch.float32}
    offsets, sizes = {}, {k: 0 for k in kinds}
    for name, shape, kind, _, _ in layout:
        dt = kinds[kind]
        align = ALIGN_BYTES // torch.tensor([], dtype=dt).element_size()
        offsets[name] = sizes[kind]
        sizes[kind] += -(-math.prod(shape) // align) * align
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "weights"))
    buffers = {}
    for kind, dt in kinds.items():
        buf = torch.empty(sizes[kind], dtype=dt, device=device)
        for part in buf.split(DRAW):
            part.normal_(generator=gen)
        buffers[kind] = buf
    out = {}
    for name, shape, kind, mean, std in layout:
        n = math.prod(shape)
        t = buffers[kind][offsets[name]:offsets[name] + n].view(shape)
        t.mul_(std).add_(mean)
        out[name] = t
    return out


def synchronize(device) -> None:
    """Wait for the draw on a card (so that set-up's parts time what they name)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
