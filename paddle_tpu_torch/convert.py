"""Weights into the port: from the JAX package's parameters, or from a seed.

``state_dict_from_numpy`` takes ``{name: ndarray}`` as the JAX package
gives it (``paddle_tpu.jit.param_arrays(model)`` or ``Layer.state_dict``,
then ``np.asarray``): names and ``[in, out]`` layouts already match the
port's modules, so no renaming or transposing happens here. Floating
weights take the requested dtype; integer arrays (quantized weights) stay
integer and ``weight_scale`` arrays stay f32.

A weight-only quantized JAX model crosses over by one recipe, which
``llama_from_numpy(..., quant_algo=...)`` and ``gpt_from_numpy(...,
quant_algo=...)`` follow: take its parameters AND buffers
(``paddle_tpu.jit.state_arrays``), build the float port model, run
``nn.quant.quantize_for_decode`` with the same algo (so the same Linears
become ``WeightOnlyLinear`` with buffers of the right shapes), then
``load_state_dict(strict=True)``.

``init_llama`` and ``init_gpt`` initialise a model directly on its device
from a seed with an explicit ``torch.Generator`` (normal, std
``initializer_range``; norm scales ones, biases zeros), so a 7B model is
made on the card with no host copy. ``gpt_from_numpy`` builds the GPT from
the JAX package's ``param_arrays`` the way ``llama_from_numpy`` does.

``resnet_from_numpy`` builds a ``vision.models.ResNet`` holding a JAX
ResNet's parameters and batch-norm buffers (``Layer.state_dict``, each
``np.asarray``): the names and layouts match, so nothing is renamed or
transposed. ``init_resnet`` draws one from a seed on its device.

``bert_from_numpy`` builds a ``BertForMaskedLM`` holding a JAX BERT's
``param_arrays`` (names and layouts match; the tied decoder weight is the
word embedding's one entry); ``init_bert`` draws one from a seed on its
device.

``fused_multi_transformer_from_numpy`` builds an
``incubate.nn.FusedMultiTransformer`` from the JAX layer's per-layer lists
(``{"qkv_weights": [layer 0, layer 1, ...], ...}``, each ``np.asarray``
of the JAX parameter), in the reference's layouts, with no transposes;
``init_fused_multi_transformer`` draws one from a seed on its device.

The shard step: ``shard_state_dict`` takes a full converted state dict
and returns one rank's shard of it, by the serving runner's plan
(``tp=``, ``ep=`` and the rank's ``tp_rank``, ``ep_rank``:
``inference.runner.serving_spec``) or by the ``dist_spec``s of a model's
parameters (the tensor-parallel and fused layers' ``mp`` splits, with
``mp_rank`` of ``mp``). ``fused_multi_transformer_from_numpy(...,
nranks=)`` takes the full per-layer lists and builds this rank's layer
from their shards. Shards are contiguous blocks, rank r taking block r, so
concatenating the ranks' shards along the split dim gives the full tensor
back.

``pipeline_stage_from_numpy`` fills one rank's stage of a
``PipelineLayer`` (or the ``PipelineParallel`` around it) from the
reference pipeline model's parameters (``{"run_function.{i}.…": ndarray}``,
the whole model): each local parameter and buffer takes the array of its
global name, cut to this rank's ``mp`` shard by its ``dist_spec``
(``shard_state_dict``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .framework.device import resolve_device, resolve_dtype
from .incubate.nn.layer.fused_transformer import (_LISTS,
                                                  FusedMultiTransformer)
from .models.bert import BertConfig, BertForMaskedLM
from .models.gpt import GPTConfig, GPTForCausalLM
from .models.llama import LlamaConfig, LlamaForCausalLM
from .nn.quant import quantize_for_decode
from .vision.models.resnet import BasicBlock, BottleneckBlock, ResNet

__all__ = ["state_dict_from_numpy", "shard_state_dict", "init_llama",
           "llama_from_numpy",
           "init_gpt", "gpt_from_numpy", "fused_multi_transformer_from_numpy",
           "init_fused_multi_transformer", "resnet_from_numpy",
           "init_resnet", "bert_from_numpy", "init_bert",
           "pipeline_stage_from_numpy"]


def _port_tensor(name: str, a: np.ndarray, dev, dt) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind in "iub":
        return torch.from_numpy(np.array(a, order="C", copy=True)).to(dev)
    if name.rsplit(".", 1)[-1] == "weight_scale":
        keep = np.array(a, np.float32, order="C", copy=True)
        return torch.from_numpy(keep).to(dev)
    return torch.from_numpy(np.array(a, np.float32, order="C",
                                     copy=True)).to(device=dev, dtype=dt)


def state_dict_from_numpy(arrays: Dict[str, np.ndarray], device=None,
                          dtype=torch.float32) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    dt = resolve_dtype(dtype)
    return {name: _port_tensor(name, a, dev, dt)
            for name, a in arrays.items()}


def shard_state_dict(state: Dict[str, object], tp: int = 1, ep: int = 1,
                     tp_rank: int = 0, ep_rank: int = 0, model=None,
                     mp: int = 1, mp_rank: int = 0) -> Dict[str, object]:
    """One rank's shard of ``state`` (``{name: tensor or ndarray}``, full
    shapes). With ``model``, each entry splits by the ``dist_spec`` of
    ``model``'s parameter of that name over ``mp`` ranks (rank
    ``mp_rank``); otherwise by the serving runner's plan at ``(tp, ep)``
    for rank ``(tp_rank, ep_rank)``. Entries the plan keeps whole come back
    as they are."""
    from .distributed.fleet.meta_parallel.tensor_parallel import \
        shard_tensor
    from .inference.runner import serving_spec

    if model is not None:
        specs = {n: getattr(p, "dist_spec", None)
                 for n, p in model.named_parameters()}
        coords = {"mp": (int(mp_rank), int(mp))}
        return {n: shard_tensor(t, specs.get(n), coords)
                for n, t in state.items()}
    coords = {"tp": (int(tp_rank), int(tp)), "ep": (int(ep_rank), int(ep))}
    return {n: shard_tensor(t, serving_spec(n, t.shape, tp, ep), coords)
            for n, t in state.items()}


def llama_from_numpy(cfg: LlamaConfig, arrays: Dict[str, np.ndarray],
                     device=None, dtype=torch.float32,
                     quant_algo: Optional[str] = None) -> LlamaForCausalLM:
    """A port model holding the given arrays (every name must match).
    ``quant_algo`` (``"weight_only_int8"`` / ``"weight_only_int4"``) takes
    a quantized model's parameters and buffers: the Linears are swapped by
    ``quantize_for_decode`` first (the recipe above)."""
    model = LlamaForCausalLM(cfg, device=device, dtype=dtype)
    return _load(model, arrays, device, dtype, quant_algo).eval()


def _load(model, arrays, device, dtype, quant_algo):
    if quant_algo is not None:
        with torch.no_grad():
            for p in model.parameters():
                p.zero_()  # quantize defined values; the load overwrites
        quantize_for_decode(model, algo=quant_algo)
    model.load_state_dict(state_dict_from_numpy(arrays, device, dtype),
                          strict=True)
    return model


@torch.no_grad()
def init_llama(cfg: LlamaConfig, seed: int = 0, device=None,
               dtype=torch.bfloat16) -> LlamaForCausalLM:
    """A ``LlamaForCausalLM`` with random weights drawn on ``device`` from
    ``seed``: every matrix (the MoE router and expert stacks included)
    normal(0, ``initializer_range``), norm scales one. Parameters are drawn
    in ``named_parameters`` order."""
    model = LlamaForCausalLM(cfg, device=device, dtype=dtype)
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    for name, p in model.named_parameters():
        if name.endswith("layernorm.weight") or name == "model.norm.weight":
            p.fill_(1.0)
        else:
            p.normal_(0.0, cfg.initializer_range, generator=gen)
    return model.eval()


def gpt_from_numpy(cfg: GPTConfig, arrays: Dict[str, np.ndarray],
                   device=None, dtype=torch.float32,
                   quant_algo: Optional[str] = None) -> GPTForCausalLM:
    """A port GPT holding the given arrays (``paddle_tpu.jit.param_arrays``
    of a JAX ``GPTForCausalLM``; every name must match). ``quant_algo``
    takes a quantized model's parameters and buffers, as for LLaMA (the
    tied LM head stays the float embedding)."""
    model = GPTForCausalLM(cfg, device=device, dtype=dtype)
    return _load(model, arrays, device, dtype, quant_algo)


@torch.no_grad()
def init_gpt(cfg: GPTConfig, seed: int = 0, device=None,
             dtype=torch.float32, generator=None) -> GPTForCausalLM:
    """A ``GPTForCausalLM`` with random weights drawn on ``device`` from
    ``seed``: every matrix (the embeddings included) normal(0,
    ``initializer_range``), LayerNorm scales one, biases zero, in
    ``named_parameters`` order. ``generator`` goes to the dropout layers."""
    model = GPTForCausalLM(cfg, device=device, dtype=dtype,
                           generator=generator)
    gen = torch.Generator(device=model.device).manual_seed(int(seed))
    for name, p in model.named_parameters():
        if p.dim() == 1:
            p.fill_(1.0 if ".ln_" in name and name.endswith("weight")
                    else 0.0)
        else:
            p.normal_(0.0, cfg.initializer_range, generator=gen)
    return model


@torch.no_grad()
def fused_multi_transformer_from_numpy(
        lists: Dict[str, Sequence[np.ndarray]], activation="gelu",
        epsilon=1e-5, device=None, dtype=torch.float32,
        nranks: int = 1) -> FusedMultiTransformer:
    """A port ``FusedMultiTransformer`` holding the JAX layer's parameters:
    ``lists`` maps each of its per-layer list names (``ln_scales``,
    ``qkv_weights``, ..., ``ffn2_biases``) to one array a layer. The
    widths come from the arrays (``qkv_weights[0]`` is ``[3, num_heads,
    head_dim, embed_dim]``, ``ffn1_weights[0]`` ``[embed_dim,
    dim_feedforward]``). ``nranks > 1``: the layer of this rank of the
    model-parallel group, holding its shard of the full arrays."""
    missing = [name for name in _LISTS if name not in lists]
    if missing:
        raise ValueError(f"fused_multi_transformer_from_numpy: missing "
                         f"{missing}")
    _, nh, hd, h = np.shape(lists["qkv_weights"][0])
    layer = FusedMultiTransformer(
        h, nh, np.shape(lists["ffn1_weights"][0])[1], activation=activation,
        epsilon=epsilon, num_layers=len(lists["qkv_weights"]),
        nranks=nranks, device=device, dtype=dtype)
    dev, dt = resolve_device(device), resolve_dtype(dtype)
    coords = ({} if layer.group is None
              else {"mp": (layer.group.rank, layer.group.nranks)})
    from .distributed.fleet.meta_parallel.tensor_parallel import \
        shard_tensor

    for name in _LISTS:
        arrays = lists[name]
        if len(arrays) != layer.num_layers:
            raise ValueError(f"{name}: {len(arrays)} arrays for "
                             f"{layer.num_layers} layers")
        for p, a in zip(getattr(layer, name), arrays):
            full = _port_tensor(name, a, dev, dt)
            p.copy_(shard_tensor(full, getattr(p, "dist_spec", None),
                                 coords))
    return layer.eval()


@torch.no_grad()
def init_fused_multi_transformer(embed_dim, num_heads, dim_feedforward,
                                 num_layers, seed: int = 0, std=0.02,
                                 activation="gelu", device=None,
                                 dtype=torch.bfloat16, nranks: int = 1
                                 ) -> FusedMultiTransformer:
    """A ``FusedMultiTransformer`` with random weights drawn on ``device``
    from ``seed``: every weight matrix normal(0, ``std``), LN scales one,
    biases zero, in ``named_parameters`` order. ``nranks > 1``: this
    rank's layer, each split matrix drawn whole (the same draws as
    ``nranks=1``) and its shard kept."""
    from .distributed.fleet.meta_parallel.tensor_parallel import \
        shard_tensor

    layer = FusedMultiTransformer(embed_dim, num_heads, dim_feedforward,
                                  activation=activation,
                                  num_layers=num_layers, nranks=nranks,
                                  device=device, dtype=dtype)
    dev = next(layer.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    g = layer.group
    coords = {} if g is None else {"mp": (g.rank, g.nranks)}
    for name, p in layer.named_parameters():
        if "_weights_" not in name:
            continue
        spec = getattr(p, "dist_spec", None)
        shape = [n * (g.nranks if spec and d < len(spec) and spec[d]
                      else 1) for d, n in enumerate(p.shape)]
        full = torch.empty(shape, device=dev, dtype=p.dtype)
        full.normal_(0.0, std, generator=gen)
        p.copy_(shard_tensor(full, spec, coords))
    return layer.eval()


def _resnet_block(depth):
    return BasicBlock if depth in (18, 34) else BottleneckBlock


@torch.no_grad()
def init_resnet(depth: int = 50, seed: int = 0, device=None,
                dtype=torch.float32, **kwargs) -> ResNet:
    """A ``ResNet`` of ``depth`` (18 and 34 on ``BasicBlock``, deeper on
    ``BottleneckBlock``) with its weights drawn on ``device`` from
    ``seed``; ``kwargs`` go to ``ResNet`` (``num_classes``, ``width``,
    ``with_pool``, ``groups``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return ResNet(_resnet_block(depth), depth, device=dev, dtype=dtype,
                  generator=gen, **kwargs)


@torch.no_grad()
def resnet_from_numpy(arrays: Dict[str, np.ndarray], depth: int = 50,
                      device=None, dtype=torch.float32, **kwargs) -> ResNet:
    """A port ``ResNet`` of ``depth`` holding the JAX ResNet's parameters
    and buffers (every name must match; the buffers stay f32)."""
    model = init_resnet(depth, 0, device, dtype, **kwargs)
    model.load_state_dict({name: torch.from_numpy(np.array(a, copy=True))
                           for name, a in arrays.items()}, strict=True)
    return model


def bert_from_numpy(cfg: BertConfig, arrays: Dict[str, np.ndarray],
                    device=None, dtype=torch.float32,
                    generator=None) -> BertForMaskedLM:
    """A port ``BertForMaskedLM`` holding the given arrays
    (``paddle_tpu.jit.param_arrays`` of a JAX ``BertForMaskedLM``, each
    ``np.asarray``; every name must match). ``generator`` goes to the
    dropout layers."""
    model = BertForMaskedLM(cfg, device=device, dtype=dtype,
                            generator=generator)
    model.load_state_dict(state_dict_from_numpy(arrays, device, dtype),
                          strict=True)
    return model


@torch.no_grad()
def init_bert(cfg: BertConfig, seed: int = 0, device=None,
              dtype=torch.float32, std=0.02,
              generator=None) -> BertForMaskedLM:
    """A ``BertForMaskedLM`` with random weights drawn on ``device`` from
    ``seed``: every matrix and embedding table normal(0, ``std``),
    LayerNorm scales one, biases zero, in ``named_parameters`` order.
    ``generator`` goes to the dropout layers."""
    model = BertForMaskedLM(cfg, device=device, dtype=dtype,
                            generator=generator)
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    for name, p in model.named_parameters():
        if p.dim() > 1:
            p.normal_(0.0, std, generator=gen)
        else:
            p.fill_(1.0 if "norm" in name and name.endswith("weight")
                    else 0.0)
    return model


@torch.no_grad()
def pipeline_stage_from_numpy(model, arrays: Dict[str, np.ndarray],
                              mp: Optional[int] = None,
                              mp_rank: Optional[int] = None):
    """Copy ``arrays`` (the whole pipeline model's, by global name: a
    mapping of ndarrays or tensors, read only at this rank's names) into
    this rank's parameters and buffers of ``model``, each cut to rank
    ``mp_rank`` of ``mp`` by its ``dist_spec`` (default: ``fleet``'s
    model-parallel group). Every local parameter must have an array.
    Returns ``model``."""
    layer = getattr(model, "_layers", model)
    if mp is None:
        from .distributed.fleet.meta_parallel.mp_layers import mp_group_of
        from .distributed.parallel import is_initialized

        group = mp_group_of(None) if is_initialized() else None
        mp = 1 if group is None else group.nranks
        mp_rank = 0 if group is None else group.rank
    own = dict(layer.named_parameters())
    missing = [n for n in own if n not in arrays]
    if missing:
        raise KeyError(f"no array for the parameters {missing}")
    def tensor(v):
        return v if isinstance(v, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(v))

    for n, p in own.items():
        v = arrays[n]
        v = v if isinstance(v, torch.Tensor) else np.asarray(v)
        shard = shard_state_dict({n: v}, model=layer, mp=mp,
                                 mp_rank=int(mp_rank or 0))[n]
        p.copy_(tensor(shard))
    for n, b in layer.named_buffers():
        if n in arrays:
            b.copy_(tensor(arrays[n]))
    return model
