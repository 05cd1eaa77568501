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

The layer kinds ported so far are dense attention, ``("attn", "dense")``,
and Mamba2 SSD, ``("ssm", "none")``; any other kind raises. The decode
cache is a list with one dict per layer: ``{"k", "v"}`` for attention,
``{"state", "conv_x", "conv_b", "conv_c"}`` for SSD (the state in fp32).

Under autograd, ``cfg.remat == "full"`` (the default) runs each period of
layers as one ``torch.utils.checkpoint`` region, the reference's
``jax.checkpoint`` around its scan body: only the period's input is kept,
and its activations are recomputed in the backward pass.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.module import (Tree, count_params, init_params, stack_specs,
                                       unstack_layers)

# Mixer and MLP kinds of the layer kinds the port cannot build yet, and the
# ROADMAP Queue A item that ports each of them. Any other combination (an
# SSM layer with a dense MLP, as in jamba) is left to item 6.
_UNPORTED = {
    "moe": "Queue A item 5 (models/moe.py)",
    "moe_dense": "Queue A item 5 (models/moe.py)",
    "cross": "Queue A item 6 (VLM cross-attention in models/stack.py)",
    "attn_cross": "Queue A item 6 (encoder-decoder in models/stack.py)",
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


class _Layer(nn.Module):
    """One decoder layer of kind ``KIND``, holding the parameters of its spec.

    ``forward`` returns the new residual stream and the layer's entry of the
    decode cache; ``decode`` takes and returns that entry; ``cache_spec``
    gives the entry's {name: (shape, dtype)}.
    """

    KIND: tuple

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device):
        super().__init__()
        self.cfg = cfg
        for name, sub in StackModel.layer_spec(cfg, self.KIND).items():
            setattr(self, name, _empty(sub, dtype, device))


class DenseAttnLayer(_Layer):
    """One ``("attn", "dense")`` decoder layer: pre-norm attention + SwiGLU."""

    KIND = ("attn", "dense")

    def forward(self, x, positions):
        y, (k, v) = attn.apply_self_attn(self.mixer, self.cfg, L.apply_norm(self.norm1, x),
                                         positions)
        x = x + y
        x = x + L.apply_mlp(self.mlp, L.apply_norm(self.norm2, x))
        return x, {"k": k, "v": v}

    def cache_spec(self, batch: int, seq: int, dtype: torch.dtype):
        return {k: (shp, dtype) for k, shp in attn.kv_cache_shape(self.cfg, batch, seq).items()}

    def decode(self, x, cache, pos):
        y, cache = attn.decode_self_attn(self.mixer, self.cfg, L.apply_norm(self.norm1, x),
                                         cache, pos)
        x = x + y
        x = x + L.apply_mlp(self.mlp, L.apply_norm(self.norm2, x))
        return x, cache


class SSMLayer(_Layer):
    """One ``("ssm", "none")`` Mamba2 layer: pre-norm SSD mixer, no MLP."""

    KIND = ("ssm", "none")

    def forward(self, x, positions):
        y, cache = ssm_lib.apply_ssm(self.mixer, self.cfg, L.apply_norm(self.norm1, x),
                                     return_cache=True)
        return x + y, cache

    def cache_spec(self, batch: int, seq: int, dtype: torch.dtype):
        # no sequence axis; the state stays fp32
        return {k: (shp, torch.float32 if k == "state" else dtype)
                for k, shp in ssm_lib.ssm_cache_shape(self.cfg, batch).items()}

    def decode(self, x, cache, pos):
        y, cache = ssm_lib.decode_ssm(self.mixer, self.cfg, L.apply_norm(self.norm1, x), cache)
        return x + y, cache


_LAYERS = {cls.KIND: cls for cls in (DenseAttnLayer, SSMLayer)}


def _run_period(layers, x, positions):
    for layer in layers:
        x, _ = layer(x, positions)
    return x


class StackModel(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        for kind in cfg.pattern():
            if kind not in _LAYERS:
                mixer, mlp = kind
                todo = _UNPORTED.get(mlp) or _UNPORTED.get(mixer) or \
                    "Queue A item 6 (the other layer kinds in models/stack.py)"
                raise NotImplementedError(
                    f"{cfg.name}: layer kind {kind} is not ported to PyTorch yet; "
                    f"ROADMAP {todo} ports it")
        self.cfg = cfg
        self.dtype = dtype_of(cfg)
        self.pattern = cfg.pattern()
        spec_tree = self.param_spec()
        self.embed = _empty(spec_tree["embed"], self.dtype, device)
        self.layers = nn.ModuleList(_LAYERS[self.pattern[i % cfg.period]](cfg, self.dtype, device)
                                    for i in range(cfg.num_layers))
        self.final_norm = _empty(spec_tree["final_norm"], self.dtype, device)

    # ------------------------------------------------------------------
    # Parameter specs
    # ------------------------------------------------------------------
    @staticmethod
    def layer_spec(cfg: ModelConfig, kind: tuple) -> Tree:
        """The reference's parameter tree of one layer of ``kind``."""
        mixer, mlp = kind
        p = {"norm1": L.norm_spec(cfg)}
        p["mixer"] = ssm_lib.ssm_spec(cfg) if mixer == "ssm" else attn.attn_spec(cfg)
        if mlp != "none":
            p["norm2"] = L.norm_spec(cfg)
            p["mlp"] = L.mlp_spec(cfg)
        return p

    @staticmethod
    def param_spec_of(cfg: ModelConfig) -> Tree:
        """The reference's spec tree: layer parameters stacked over periods."""
        layer_specs = {f"L{i}": StackModel.layer_spec(cfg, kind)
                       for i, kind in enumerate(cfg.pattern())}
        return {
            "embed": L.embed_spec(cfg),
            "layers": stack_specs(layer_specs, cfg.num_periods, None),
            "final_norm": L.norm_spec(cfg),
        }

    def param_spec(self) -> Tree:
        return self.param_spec_of(self.cfg)

    def param_count(self, active_only: bool = False) -> int:
        # No MoE layer is ported yet: every parameter is active.
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
        x = self._run_stack(x, self._positions(tokens.shape[1]))
        x = L.apply_norm(self.final_norm, x)
        logits = L.unembed(self.embed, x, cfg.logits_softcap, cfg.vocab_size)
        return logits, torch.zeros((), dtype=torch.float32, device=self.device)

    def _run_stack(self, x, positions):
        remat = self.cfg.remat if torch.is_grad_enabled() else "none"
        if remat not in ("none", "full"):
            raise NotImplementedError(
                f"{self.cfg.name}: remat={remat!r} is not ported to PyTorch yet; ROADMAP "
                "Queue A item 6 ports it (selective checkpointing of matrix products)")
        period = self.cfg.period
        for i in range(0, len(self.layers), period):
            layers = self.layers[i:i + period]
            if remat == "full":
                x = checkpoint(_run_period, layers, x, positions, use_reentrant=False,
                               preserve_rng_state=False)  # the model draws no random numbers
            else:
                x = _run_period(layers, x, positions)
        return x

    def loss(self, batch):
        logits, aux = self.forward(batch)
        ce = L.cross_entropy(logits, batch["labels"], batch.get("mask"))
        total = ce + aux
        return total, {"loss": total, "ce": ce, "aux": aux}

    # ------------------------------------------------------------------
    # Serving: prefill + decode (inference only, so no autograd)
    # ------------------------------------------------------------------
    def cache_spec(self, batch: int, seq: int) -> List[Dict[str, tuple]]:
        """Per layer: {name: (shape, dtype)} of the decode cache."""
        return [layer.cache_spec(batch, seq, self.dtype) for layer in self.layers]

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
            x, entry = layer(x, positions)
            cache.append(entry)
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
