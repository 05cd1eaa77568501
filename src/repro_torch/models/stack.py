"""The stacked sequence model covering all ten architectures, as a PyTorch
``nn.Module``.

Port of ``repro.models.stack.StackModel``: dense / MoE / hybrid (SSM +
attention) / VLM (cross-attention) / encoder-decoder (audio) / pure-SSM
stacks are all instances of a periodic layer pattern of (mixer, mlp) kinds.
The reference scans one layer body over parameters stacked across the
periods of the pattern; here each layer is its own submodule and the stack
is a loop over them. The parameters live in the module (``nn.ParameterDict``
per sub-block, named as the reference's tree), so the entry points take no
``params`` argument:

  ``loss(batch)``                       training objective (+ metrics)
  ``forward(batch)``                    full-sequence logits and MoE aux loss
  ``prefill(batch)``                    last-token logits + decode cache
  ``decode_step(cache, tokens, pos)``   one-token serving step

Mixers: ``attn`` (causal self-attention), ``ssm`` (Mamba2 SSD), ``cross``
(gated cross-attention to the batch's stub ``patches``) and ``attn_cross``
(self-attention, then cross-attention to the encoder's output); MLPs:
``none``, ``dense``, ``moe`` and ``moe_dense`` (MoE plus a parallel dense
branch). An encoder-decoder config runs ``encoder_layers`` non-causal
layers over the batch's stub ``frames`` first where a decoder layer reads
their output (``attn_cross``): the reference writes the encoder into every
step, and XLA drops it from the compiled step where no layer reads it
(whisper-tiny's pattern holds no ``attn_cross``). The decode cache is a
list with one dict per layer: ``{"k", "v"}`` for attention (for ``cross``
sized to the memory), plus ``{"xk", "xv"}`` for ``attn_cross``, and
``{"state", "conv_x", "conv_b", "conv_c"}`` for SSD (the state in fp32).

Under autograd, ``cfg.remat`` picks the reference's ``jax.checkpoint``
around its scan body: ``"full"`` (the default) runs each period of layers,
and each encoder layer, as one ``torch.utils.checkpoint`` region, keeping
only its input; ``"dots"`` keeps the outputs of the region's unbatched
matrix products (``mm``, ``addmm``: the reference's
``dots_with_no_batch_dims_saveable``) and recomputes the rest; ``"none"``
keeps everything.

``sharder`` is the reference's hook (``distributed.sharding.make_sharder``):
``sharder(name, shape)`` gives the layout of an activation at a named
constraint point, or None. The points are the reference's: the residual
stream (``"acts"``) after the embedding and after each block's residual in
the forward pass, once a layer in prefill; attention's q/k/v and context
(``"acts_qkv"``, ``"acts_kv_repl"``) where the reference passes the hook
(self-attention in the forward pass and the encoder); the MoE dispatch
(``"moe_disp"``, ``"moe_xe"``); and the grouped decode scores
(``"decode_scores5"``). On DTensor activations a constraint redistributes;
on plain tensors it does nothing, so without a mesh nothing changes.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.module import (_STACKS, ParamSpec, Tree, count_params, fill_leaf,
                                       flatten, port_names, spec, stack_specs)
from repro_torch.models.switch import with_the_impls_in_force

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}
ENCODER_KIND = ("enc_attn", "dense")
REMATS = ("none", "dots", "full")


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _params(sub, dtype: torch.dtype, device):
    """One entry of a layer's spec, allocated: a sub-block's
    ``nn.ParameterDict``, or a single parameter (a cross layer's gate)."""
    def one(ps):
        return nn.Parameter(torch.empty(ps.shape, dtype=ps.dtype or dtype, device=device))
    if isinstance(sub, ParamSpec):
        return one(sub)
    return nn.ParameterDict({k: one(ps) for k, ps in sub.items()})


def _whole(sharder, sub, keep=None):
    """A sub-block's parameters (or one parameter) made whole for compute
    along the data-parallel axes, where the sharder says so; ``keep`` maps a
    parameter's name to the mesh dims whose split it keeps."""
    whole = getattr(sharder, "whole", None)
    if whole is None:
        return sub
    if isinstance(sub, nn.ParameterDict):
        return {k: whole(v, keep=(keep or {}).get(k, ())) for k, v in sub.items()}
    return whole(sub)


def _add(aux, a):
    return a if aux is None else aux if a is None else aux + a


class _Layer(nn.Module):
    """One layer of ``kind`` = (mixer, mlp), holding the parameters of its
    spec. ``forward(x, positions, memory)`` returns the new residual stream,
    the layer's entry of the decode cache and its MoE aux loss (None without
    MoE); ``decode(x, cache, pos)`` takes and returns that entry;
    ``cache_spec`` gives the entry's {name: (shape, dtype)}."""

    def __init__(self, cfg: ModelConfig, kind: tuple, dtype: torch.dtype, device,
                 sharder=None):
        super().__init__()
        self.cfg, self.kind, self.sharder = cfg, kind, sharder
        for name, sub in StackModel.layer_spec(cfg, kind).items():
            setattr(self, name, _params(sub, dtype, device))

    def _w(self, name: str):
        """The parameters ``name`` in their compute layout (``Sharder.whole``)."""
        return _whole(self.sharder, getattr(self, name))

    def _moe_w(self, x):
        """The MoE block's parameters in their compute layout for the tokens
        ``x``: as ``_w``, but ``wi`` and ``wo`` keep an FSDP split of their
        expert dim over the mesh dims that do not split the rows of ``x``,
        so that each rank there serves its own experts, and of d_model where
        a group spans the ranks that split the rows (``moe.compute_split``),
        as GSPMD divides the expert products, where a gather would have
        every rank repeat all of them."""
        sub = self.mlp
        dims = moe_lib.compute_split(self.cfg, sub["wi"], sub["wo"], x)
        return _whole(self.sharder, sub, {"wi": dims, "wo": dims})

    def _norm1(self, x):
        return L.apply_norm(self._w("norm1"), x)

    def _acts(self, x):
        return constrain(self.sharder, "acts", x)

    def _mlp(self, x, acts: bool = True):
        """The pre-norm MLP block on the residual stream: (x, aux or None),
        the new residual stream constrained to ``"acts"`` where ``acts``
        (the forward pass; prefill constrains once at the layer's end, decode
        and the encoder not at all, as the reference)."""
        mlp = self.kind[1]
        if mlp == "none":
            return x, None
        h = L.apply_norm(self._w("norm2"), x)
        if mlp == "dense":
            y, aux = L.apply_mlp(self._w("mlp"), h), None
        else:
            y, aux = moe_lib.apply_moe(self._moe_w(h), self.cfg, h, shard=self.sharder)
            if mlp == "moe_dense":
                y = y + L.apply_mlp(self._w("mlp_dense"), h)
        x = x + y
        return (self._acts(x) if acts else x), aux

    def _block(self, x, y, prefill: bool):
        """The mixer's output ``y`` added to the residual stream, then the
        MLP block, with the reference's ``"acts"`` constraints."""
        x = x + y
        if prefill:
            x, aux = self._mlp(x, acts=False)
            return self._acts(x), aux
        return self._mlp(self._acts(x))

    def _kv_spec(self, batch: int, seq: int, dtype: torch.dtype, prefix: str = ""):
        return {prefix + k: (shp, dtype)
                for k, shp in attn.kv_cache_shape(self.cfg, batch, seq).items()}


class AttnLayer(_Layer):
    """Pre-norm causal self-attention, then the layer's MLP."""

    def forward(self, x, positions, memory=None, prefill=False):
        y, (k, v) = attn.apply_self_attn(self._w("mixer"), self.cfg, self._norm1(x),
                                         positions, shard=None if prefill else self.sharder)
        x, aux = self._block(x, y, prefill)
        return x, {"k": k, "v": v}, aux

    def cache_spec(self, batch: int, seq: int, dtype: torch.dtype):
        return self._kv_spec(batch, seq, dtype)

    def decode(self, x, cache, pos):
        y, cache = attn.decode_self_attn(self._w("mixer"), self.cfg, self._norm1(x),
                                         cache, pos, shard=self.sharder)
        return self._mlp(x + y, acts=False)[0], cache


class SSMLayer(_Layer):
    """Pre-norm Mamba2 SSD mixer, then the layer's MLP (none in Mamba2)."""

    def forward(self, x, positions, memory=None, prefill=False):
        y, cache = ssm_lib.apply_ssm(self._w("mixer"), self.cfg, self._norm1(x),
                                     return_cache=True)
        x, aux = self._block(x, y, prefill)
        return x, cache, aux

    def cache_spec(self, batch: int, seq: int, dtype: torch.dtype):
        # no sequence axis; the state stays fp32
        return {k: (shp, torch.float32 if k == "state" else dtype)
                for k, shp in ssm_lib.ssm_cache_shape(self.cfg, batch).items()}

    def decode(self, x, cache, pos):
        y, cache = ssm_lib.decode_ssm(self._w("mixer"), self.cfg, self._norm1(x), cache)
        return self._mlp(x + y, acts=False)[0], cache


class CrossLayer(_Layer):
    """Pre-norm cross-attention to the image memory, scaled by
    ``tanh(gate_attn)`` (zero at init), then the layer's MLP. Its cache
    holds the memory's K/V."""

    def _gated(self, y):
        return y * torch.tanh(self._w("gate_attn")).to(y.dtype)

    def forward(self, x, positions, memory, prefill=False):
        y, (k, v) = attn.apply_cross_attn(self._w("mixer"), self.cfg, self._norm1(x),
                                          memory)
        x, aux = self._block(x, self._gated(y), prefill)
        return x, {"k": k, "v": v}, aux

    def cache_spec(self, batch: int, seq: int, dtype: torch.dtype):
        return self._kv_spec(batch, self.cfg.vision_seq, dtype)

    def decode(self, x, cache, pos):
        y, cache = attn.decode_cross_attn(self._w("mixer"), self.cfg, self._norm1(x),
                                          cache)
        return self._mlp(x + self._gated(y), acts=False)[0], cache


class AttnCrossLayer(_Layer):
    """Pre-norm causal self-attention, then pre-norm (``norm_x``)
    cross-attention to the encoder's output, then the layer's MLP."""

    def forward(self, x, positions, memory, prefill=False):
        y, (k, v) = attn.apply_self_attn(self._w("mixer"), self.cfg, self._norm1(x),
                                         positions)
        x = x + y
        hx = L.apply_norm(self._w("norm_x"), x)
        y, (xk, xv) = attn.apply_cross_attn(self._w("cross"), self.cfg, hx,
                                            memory)
        x, aux = self._block(x, y, prefill)
        return x, {"k": k, "v": v, "xk": xk, "xv": xv}, aux

    def cache_spec(self, batch: int, seq: int, dtype: torch.dtype):
        return {**self._kv_spec(batch, seq, dtype),
                **self._kv_spec(batch, self.cfg.audio_seq, dtype, prefix="x")}

    def decode(self, x, cache, pos):
        y, sc = attn.decode_self_attn(self._w("mixer"), self.cfg, self._norm1(x),
                                      {"k": cache["k"], "v": cache["v"]}, pos,
                                      shard=self.sharder)
        x = x + y
        hx = L.apply_norm(self._w("norm_x"), x)
        y, _ = attn.decode_cross_attn(self._w("cross"), self.cfg, hx,
                                      {"k": cache["xk"], "v": cache["xv"]})
        return self._mlp(x + y, acts=False)[0], {**sc, "xk": cache["xk"], "xv": cache["xv"]}


class EncoderLayer(_Layer):
    """One ``("enc_attn", "dense")`` encoder layer: pre-norm non-causal
    self-attention and the dense MLP; no cache."""

    def forward(self, x, positions):
        y, _ = attn.apply_self_attn(self._w("mixer"), self.cfg, self._norm1(x),
                                    positions, causal=False, shard=self.sharder)
        return self._mlp(x + y, acts=False)[0]


_MIXERS = {"attn": AttnLayer, "ssm": SSMLayer, "cross": CrossLayer,
           "attn_cross": AttnCrossLayer}


def _run_period(layers, x, positions, memory):
    aux = None
    for layer in layers:
        x, _, a = layer(x, positions, memory)
        aux = _add(aux, a)
    return x, aux


# the reference's dots_with_no_batch_dims_saveable: matrix products with no
# batch dimension (``x @ w`` of a layer lowers to mm/addmm; the attention and
# MoE einsums, with batch dimensions, to bmm)
_SAVED_PRODUCTS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


class StackModel(nn.Module):
    def __init__(self, cfg: ModelConfig, device, sharder=None):
        super().__init__()
        if cfg.remat not in REMATS:
            raise ValueError(f"{cfg.name}: remat {cfg.remat!r} not in {REMATS}")
        self.cfg = cfg
        self.sharder = sharder  # (name, shape) -> NamedSharding | None
        self.dtype = dtype_of(cfg)
        self.pattern = cfg.pattern()
        spec_tree = self.param_spec()
        self.embed = _params(spec_tree["embed"], self.dtype, device)
        kinds = [self.pattern[i % cfg.period] for i in range(cfg.num_layers)]
        self.layers = nn.ModuleList(_MIXERS[kind[0]](cfg, kind, self.dtype, device, sharder)
                                    for kind in kinds)
        self.final_norm = _params(spec_tree["final_norm"], self.dtype, device)
        if cfg.is_encoder_decoder:
            self.encoder = nn.ModuleList(EncoderLayer(cfg, ENCODER_KIND, self.dtype, device,
                                                      sharder)
                                         for _ in range(cfg.encoder_layers))
            self.enc_norm = _params(spec_tree["enc_norm"], self.dtype, device)

    # ------------------------------------------------------------------
    # Parameter specs
    # ------------------------------------------------------------------
    @staticmethod
    def layer_spec(cfg: ModelConfig, kind: tuple) -> Tree:
        """The reference's parameter tree of one layer of ``kind``."""
        mixer, mlp = kind
        p: Tree = {"norm1": L.norm_spec(cfg)}
        if mixer in ("attn", "enc_attn"):
            p["mixer"] = attn.attn_spec(cfg)
        elif mixer == "cross":
            p["mixer"] = attn.attn_spec(cfg)
            p["gate_attn"] = spec((), (), "zeros", dtype=torch.float32)
        elif mixer == "attn_cross":
            p["mixer"] = attn.attn_spec(cfg)
            p["norm_x"] = L.norm_spec(cfg)
            p["cross"] = attn.attn_spec(cfg)
        elif mixer == "ssm":
            p["mixer"] = ssm_lib.ssm_spec(cfg)
        else:
            raise ValueError(f"unknown mixer kind {mixer!r}")
        if mlp not in ("none", "dense", "moe", "moe_dense"):
            raise ValueError(f"unknown mlp kind {mlp!r}")
        if mlp != "none":
            p["norm2"] = L.norm_spec(cfg)
        if mlp == "dense":
            p["mlp"] = L.mlp_spec(cfg)
        elif mlp in ("moe", "moe_dense"):
            p["mlp"] = moe_lib.moe_spec(cfg)
        if mlp == "moe_dense":
            p["mlp_dense"] = L.mlp_spec(cfg)
        return p

    @staticmethod
    def param_spec_of(cfg: ModelConfig) -> Tree:
        """The reference's spec tree: layer parameters stacked over periods,
        the encoder's over its layers."""
        layer_specs = {f"L{i}": StackModel.layer_spec(cfg, kind)
                       for i, kind in enumerate(cfg.pattern())}
        tree = {
            "embed": L.embed_spec(cfg),
            "layers": stack_specs(layer_specs, cfg.num_periods, None),
            "final_norm": L.norm_spec(cfg),
        }
        if cfg.is_encoder_decoder:
            enc = {"L0": StackModel.layer_spec(cfg, ENCODER_KIND)}  # encoder period is 1
            tree["encoder"] = stack_specs(enc, cfg.encoder_layers, None)
            tree["enc_norm"] = L.norm_spec(cfg)
        return tree

    def param_spec(self) -> Tree:
        return self.param_spec_of(self.cfg)

    def param_axes(self) -> Dict[str, tuple]:
        """{parameter name: logical axes}, the reference's ``param_axes``
        without the stacked layer dim (each layer is its own tensor here)."""
        out = {}
        for key, ps in flatten(self.param_spec()).items():
            names = port_names(key, self.cfg)
            stacked = key.split("/")[0] in _STACKS
            out.update({name: ps.axes[1:] if stacked else ps.axes for name in names})
        return out

    def cache_axes(self) -> List[Dict[str, tuple]]:
        """Per layer: {name: logical axes} of the decode cache, the
        reference's ``cache_spec`` axes without the stacked layer dim."""
        kv = ("batch", "cache_seq", "kv_heads", "head_dim")
        ssm = {"state": ("batch", "heads", None, None), "conv_x": ("batch", None, "mlp"),
               "conv_b": ("batch", None, None), "conv_c": ("batch", None, None)}
        return [{k: ssm[k] if isinstance(layer, SSMLayer) else kv
                 for k in layer.cache_spec(1, 1, self.dtype)} for layer in self.layers]

    def param_count(self, active_only: bool = False) -> int:
        spec_tree = self.param_spec()
        total = count_params(spec_tree)
        cfg = self.cfg
        if not active_only or not cfg.num_experts:
            return total
        # Scale expert tensors by top_k / num_experts.
        inactive = 0
        for key, ps in flatten(spec_tree).items():
            if "mlp" in key.split("/") and "experts" in ps.axes:
                inactive += int(math.prod(ps.shape) * (1 - cfg.top_k / cfg.num_experts))
        return total - inactive

    @property
    def device(self) -> torch.device:
        return self.final_norm["scale"].device

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "StackModel":
        """Fill every parameter with the reference's initialisers and fan-in
        scales, drawn from ``generator`` (which lives on the model's device):
        leaf by leaf in sorted key order, a stacked leaf one layer at a time
        (``fill_leaf``), so no draw is held beside the model but a bounded
        one. One seed gives one model."""
        params = dict(self.named_parameters())
        for key, ps in flatten(self.param_spec()).items():
            for name in port_names(key, self.cfg):
                fill_leaf(params[name], ps, generator)
        return self

    # ------------------------------------------------------------------
    # Forward pass
    # ------------------------------------------------------------------
    def _w(self, name: str):
        """The parameters ``name`` in their compute layout (``Sharder.whole``)."""
        return _whole(self.sharder, getattr(self, name))

    def _positions(self, s: int):
        return torch.arange(s, dtype=torch.int32, device=self.device)[None, :]

    def _remat(self, fn, *args):
        """``fn(*args)`` under the config's remat policy while autograd
        records, else as it is."""
        remat = self.cfg.remat if torch.is_grad_enabled() else "none"
        if remat == "none":
            return fn(*args)
        kw = {}
        if remat == "dots":
            kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                 _dots_policy)
        # the model draws no random numbers
        return checkpoint(with_the_impls_in_force(fn), *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)

    def _encode(self, frames):
        """Whisper-style encoder over stub frame embeddings (B,M,D)."""
        x = frames.to(self.dtype)
        positions = self._positions(x.shape[1])
        for layer in self.encoder:
            x = self._remat(layer, x, positions)
        return L.apply_norm(self._w("enc_norm"), x)

    def _memory_of(self, batch):
        if self.cfg.is_encoder_decoder:
            # the encoder runs only where a layer reads its output (an
            # ``attn_cross`` layer): the reference writes it in every step,
            # and XLA drops it where no layer reads it
            if not any(mixer == "attn_cross" for mixer, _ in self.pattern):
                return None
            return self._encode(batch["frames"])
        if self.cfg.cross_every:
            return batch["patches"].to(self.dtype)
        return None

    def forward(self, batch):
        """batch: {"tokens": (B,S) int[, "patches" | "frames": (B,M,D)]}.
        -> (logits (B,S,V_padded) fp32, aux: the MoE layers' summed aux loss,
        fp32, 0 without MoE)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = constrain(self.sharder, "acts", L.embed_tokens(self._w("embed"), tokens, self.dtype))
        positions = self._positions(tokens.shape[1])
        memory = self._memory_of(batch)
        aux = None
        for i in range(0, len(self.layers), cfg.period):
            x, a = self._remat(_run_period, self.layers[i:i + cfg.period], x, positions, memory)
            aux = _add(aux, a)
        x = L.apply_norm(self._w("final_norm"), x)
        logits = L.unembed(self._w("embed"), x, cfg.logits_softcap, cfg.vocab_size)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=self.device)
        return logits, aux

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
        the prompt (a cross layer's to the memory). Returns
        (last_token_logits (B,1,V_padded), cache)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = L.embed_tokens(self._w("embed"), tokens, self.dtype)
        positions = self._positions(tokens.shape[1])
        memory = self._memory_of(batch)
        cache = []
        for layer in self.layers:
            x, entry, _ = layer(x, positions, memory, prefill=True)
            cache.append(entry)
        x = L.apply_norm(self._w("final_norm"), x[:, -1:])
        return L.unembed(self._w("embed"), x, cfg.logits_softcap, cfg.vocab_size), cache

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos):
        """tokens (B,1) int; pos (B,) write positions. -> (logits, cache)."""
        cfg = self.cfg
        x = L.embed_tokens(self._w("embed"), tokens, self.dtype)
        new_cache = []
        for layer, c in zip(self.layers, cache):
            x, c = layer.decode(x, c, pos)
            new_cache.append(c)
        x = L.apply_norm(self._w("final_norm"), x)
        return L.unembed(self._w("embed"), x, cfg.logits_softcap, cfg.vocab_size), new_cache
