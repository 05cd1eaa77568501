"""The stacked sequence model, as a PyTorch ``nn.Module``.

Port of ``repro.models.stack.StackModel``. The reference scans one layer
body over parameters stacked across the periods of the layer pattern; here
each layer is its own submodule and the stack is a loop over them. The
parameters live in the module (``nn.ParameterDict`` per sub-block, named as
the reference's tree), so the entry points take no ``params`` argument:

  ``loss(batch)``                       training objective (+ metrics)
  ``forward(batch)``                    full-sequence logits
  ``prefill(batch)``                    last-token logits + decode cache
  ``decode_step(cache, tokens, pos)``   one-token serving step

Only dense attention layers, ``("attn", "dense")``, are ported so far; the
decode cache is a list with one ``{"k", "v"}`` dict per layer.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.module import (Tree, count_params, init_params, stack_specs,
                                       unstack_layers)

# Layer kinds the port cannot build yet, and the ROADMAP Queue A item that
# ports each of them.
_UNPORTED = {
    "ssm": "Queue A item 4 (models/ssm.py)",
    "moe": "Queue A item 5 (models/moe.py)",
    "moe_dense": "Queue A item 5 (models/moe.py)",
    "cross": "Queue A item 6 (VLM cross-attention in models/stack.py)",
    "attn_cross": "Queue A item 6 (encoder-decoder in models/stack.py)",
    "none": "Queue A item 4 (models/ssm.py)",
}

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _param_dict(flat: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in flat.items()})


def _empty(spec_tree: Tree, dtype: torch.dtype, device) -> nn.ParameterDict:
    return _param_dict({k: torch.empty(ps.shape, dtype=ps.dtype or dtype, device=device)
                        for k, ps in spec_tree.items()})


class DenseAttnLayer(nn.Module):
    """One ``("attn", "dense")`` decoder layer: pre-norm attention + SwiGLU."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device):
        super().__init__()
        self.cfg = cfg
        for name, sub in StackModel.layer_spec(cfg).items():
            setattr(self, name, _empty(sub, dtype, device))

    def forward(self, x, positions):
        y, kv = attn.apply_self_attn(self.mixer, self.cfg, L.apply_norm(self.norm1, x),
                                     positions)
        x = x + y
        x = x + L.apply_mlp(self.mlp, L.apply_norm(self.norm2, x))
        return x, kv

    def decode(self, x, cache, pos):
        y, cache = attn.decode_self_attn(self.mixer, self.cfg, L.apply_norm(self.norm1, x),
                                         cache, pos)
        x = x + y
        x = x + L.apply_mlp(self.mlp, L.apply_norm(self.norm2, x))
        return x, cache


class StackModel(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        for kind in cfg.pattern():
            if kind != ("attn", "dense"):
                mixer, mlp = kind
                todo = _UNPORTED.get(mixer if mixer != "attn" else mlp, "a later slice")
                raise NotImplementedError(
                    f"{cfg.name}: layer kind {kind} is not ported to PyTorch yet; "
                    f"ROADMAP {todo} ports it")
        self.cfg = cfg
        self.dtype = dtype_of(cfg)
        self.pattern = cfg.pattern()
        spec_tree = self.param_spec()
        self.embed = _empty(spec_tree["embed"], self.dtype, device)
        self.layers = nn.ModuleList(DenseAttnLayer(cfg, self.dtype, device)
                                    for _ in range(cfg.num_layers))
        self.final_norm = _empty(spec_tree["final_norm"], self.dtype, device)

    # ------------------------------------------------------------------
    # Parameter specs
    # ------------------------------------------------------------------
    @staticmethod
    def layer_spec(cfg: ModelConfig) -> Tree:
        return {"norm1": L.norm_spec(cfg), "mixer": attn.attn_spec(cfg),
                "norm2": L.norm_spec(cfg), "mlp": L.mlp_spec(cfg)}

    @staticmethod
    def param_spec_of(cfg: ModelConfig) -> Tree:
        """The reference's spec tree: layer parameters stacked over periods."""
        layer_specs = {f"L{i}": StackModel.layer_spec(cfg) for i in range(cfg.period)}
        return {
            "embed": L.embed_spec(cfg),
            "layers": stack_specs(layer_specs, cfg.num_periods, None),
            "final_norm": L.norm_spec(cfg),
        }

    def param_spec(self) -> Tree:
        return self.param_spec_of(self.cfg)

    def param_count(self, active_only: bool = False) -> int:
        # Dense layers only: every parameter is active.
        return count_params(self.param_spec())

    @property
    def device(self) -> torch.device:
        return self.final_norm["scale"].device

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "StackModel":
        """Fill every parameter with the reference's initialisers, drawn from
        ``generator`` (which lives on the model's device)."""
        flat = init_params(self.param_spec(), generator, self.dtype, self.device)
        self.load_state_dict(unstack_layers(flat, self.cfg.period))
        return self

    # ------------------------------------------------------------------
    # Forward pass
    # ------------------------------------------------------------------
    def _positions(self, s: int):
        return torch.arange(s, dtype=torch.int32, device=self.device)[None, :]

    def forward(self, batch):
        """batch: {"tokens": (B,S) int}. -> (logits (B,S,V_padded) fp32, aux)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = L.embed_tokens(self.embed, tokens, self.dtype)
        positions = self._positions(tokens.shape[1])
        for layer in self.layers:
            x, _ = layer(x, positions)
        x = L.apply_norm(self.final_norm, x)
        logits = L.unembed(self.embed, x, cfg.logits_softcap, cfg.vocab_size)
        return logits, torch.zeros((), dtype=torch.float32, device=self.device)

    def loss(self, batch):
        logits, aux = self.forward(batch)
        ce = L.cross_entropy(logits, batch["labels"], batch.get("mask"))
        total = ce + aux
        return total, {"loss": total, "ce": ce, "aux": aux}

    # ------------------------------------------------------------------
    # Serving: prefill + decode (inference only, so no autograd)
    # ------------------------------------------------------------------
    def cache_spec(self, batch: int, seq: int) -> List[Dict[str, tuple]]:
        """Per layer: {"k"/"v": (shape, dtype)} of the decode cache."""
        kvs = attn.kv_cache_shape(self.cfg, batch, seq)
        return [{k: (shp, self.dtype) for k, shp in kvs.items()}
                for _ in range(self.cfg.num_layers)]

    def init_cache(self, batch: int, seq: int):
        return [{k: torch.zeros(shp, dtype=dt, device=self.device)
                 for k, (shp, dt) in entry.items()}
                for entry in self.cache_spec(batch, seq)]

    @torch.no_grad()
    def prefill(self, batch):
        """Full-sequence forward that also builds the decode cache, sized to
        the prompt. Returns (last_token_logits (B,1,V_padded), cache)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = L.embed_tokens(self.embed, tokens, self.dtype)
        positions = self._positions(tokens.shape[1])
        cache = []
        for layer in self.layers:
            x, (k, v) = layer(x, positions)
            cache.append({"k": k.to(self.dtype), "v": v.to(self.dtype)})
        x = L.apply_norm(self.final_norm, x[:, -1:])
        return L.unembed(self.embed, x, cfg.logits_softcap, cfg.vocab_size), cache

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos):
        """tokens (B,1) int; pos (B,) write positions. -> (logits, cache)."""
        cfg = self.cfg
        x = L.embed_tokens(self.embed, tokens, self.dtype)
        new_cache = []
        for layer, c in zip(self.layers, cache):
            x, c = layer.decode(x, c, pos)
            new_cache.append(c)
        x = L.apply_norm(self.final_norm, x)
        return L.unembed(self.embed, x, cfg.logits_softcap, cfg.vocab_size), new_cache
