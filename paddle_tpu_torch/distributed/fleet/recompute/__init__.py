"""Activation recomputation, after
``paddle_tpu/distributed/fleet/recompute/__init__.py``: ``recompute``,
``recompute_sequential`` and ``POLICY_MAP``.

``torch.utils.checkpoint.checkpoint`` with ``use_reentrant=False`` is the
mechanism: the forward keeps only the region's inputs (and, by policy,
some outputs), and the backward runs the region again before it
differentiates it. So the flash kernels of a checkpointed attention layer
launch again inside the backward.

RNG: torch's checkpoint restores the default generators' states for the
re-run, but not an explicit ``torch.Generator``'s, which the port's
dropout layers draw from. ``recompute`` therefore saves the state of each
generator held by the region's modules (a module's ``generator``
attribute) before the forward, sets it back for the re-run, and after the
re-run returns it to where the forward left it: the re-run draws the
forward's masks, and later draws are what they would be without
recompute. ``preserve_rng_state=False`` turns both off.

``granularity`` keeps the reference's names: ``"full"`` re-runs the whole
region; ``"full_attn"`` and ``"core_attn"`` keep every matrix-product
output without batch dims resident and re-run the rest. The reference
keeps them with ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``;
here a selective-checkpoint policy (``create_selective_checkpoint_contexts``)
marks ``aten.mm`` and ``aten.addmm`` (the Linears' products) must-save.
"""
from __future__ import annotations

import functools

import torch
from torch.utils import checkpoint as _ckpt

__all__ = ["recompute", "recompute_sequential", "POLICY_MAP"]

_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """The products without batch dims stay; everything else re-runs."""
    if op in _SAVED_OPS:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


#: recompute_granularity -> selective-checkpoint policy (None: re-run all)
POLICY_MAP = {
    "full": None,
    "full_attn": _save_dots,
    "core_attn": _save_dots,
}


def _generators(*objs):
    """The distinct ``torch.Generator``s held as ``generator`` by the
    modules of ``objs``."""
    seen = {}
    for obj in objs:
        if not isinstance(obj, torch.nn.Module):
            continue
        for m in obj.modules():
            g = getattr(m, "generator", None)
            if isinstance(g, torch.Generator):
                seen[id(g)] = g
    return list(seen.values())


def _checkpoint(function, gens, args, kwargs, granularity,
                preserve_rng_state):
    if granularity not in POLICY_MAP:
        raise ValueError(f"granularity {granularity!r} not in "
                         f"{sorted(POLICY_MAP)}")
    policy = POLICY_MAP[granularity]
    if not preserve_rng_state:
        gens = []
    before = [g.get_state() for g in gens]
    calls = [0]

    def run(*a, **k):
        if calls[0] == 0:  # the forward
            calls[0] = 1
            return function(*a, **k)
        after = [g.get_state() for g in gens]  # the re-run in backward
        for g, s in zip(gens, before):
            g.set_state(s)
        try:
            return function(*a, **k)
        finally:
            for g, s in zip(gens, after):
                g.set_state(s)

    extra = {}
    if policy is not None:
        extra["context_fn"] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, policy)
    return _ckpt.checkpoint(run, *args, use_reentrant=False,
                            preserve_rng_state=preserve_rng_state,
                            **extra, **kwargs)


def recompute(function, *args, **kwargs):
    """``function(*args, **kwargs)`` with activation checkpointing.
    ``function`` is a module, a module's bound method (``layer.forward``)
    or any callable over tensors. Keyword knobs: ``granularity``
    (``"full"``, the default; ``"full_attn"``, ``"core_attn"``),
    ``preserve_rng_state`` (True), ``use_reentrant`` (accepted and
    ignored: one implementation, the non-reentrant one).

    A module's parameters enter the region as explicit inputs, bound to
    the module again for the forward and for the re-run (as the
    reference's region takes them), so the re-run in the backward uses the
    tensors the forward used even when those were bound by
    ``jit.functional_call``, whose binding has ended by then."""
    kwargs.pop("use_reentrant", None)
    preserve = kwargs.pop("preserve_rng_state", True)
    granularity = kwargs.pop("granularity", "full")
    owner = function if isinstance(function, torch.nn.Module) \
        else getattr(function, "__self__", None)
    if not isinstance(owner, torch.nn.Module):
        return _checkpoint(function, [], args, kwargs, granularity,
                           preserve)
    from torch.nn.utils.stateless import _reparametrize_module

    named = list(owner.named_parameters())
    n_in = len(args)

    def bound(*arrs, **kw):
        params = {name: t for (name, _), t in zip(named, arrs[n_in:])}
        with _reparametrize_module(owner, params):
            return function(*arrs[:n_in], **kw)

    return _checkpoint(bound, _generators(owner),
                       args + tuple(p for _, p in named), kwargs,
                       granularity, preserve)


class _Chunk(torch.nn.Module):
    """A chunk of ``recompute_sequential``'s layers as one module, so that
    ``recompute`` binds the chunk's parameters for its re-run; a tuple
    output is splatted into the next layer."""

    def __init__(self, layers):
        super().__init__()
        self.mods = torch.nn.ModuleList(
            m for m in layers if isinstance(m, torch.nn.Module))
        self.layers = list(layers)

    def forward(self, *xs):
        x = xs[0] if len(xs) == 1 else xs
        for layer in self.layers:
            x = layer(*x) if isinstance(x, tuple) else layer(x)
        return x


def recompute_sequential(ctx: dict, functions, *args, **kwargs):
    """Checkpoint a sequence of layers (a ``Sequential`` or a list) in
    ``ctx["segments"]`` chunks, each chunk one ``recompute`` region (its
    parameters bound as ``recompute`` binds a module's); a tuple output is
    splatted into the next layer. ``ctx`` may also hold
    ``preserve_rng_state``."""
    segments = int(ctx.get("segments", 1))
    layers = list(functions)
    if not layers:
        raise ValueError("recompute_sequential: empty layer list")
    kwargs.setdefault("preserve_rng_state",
                      ctx.get("preserve_rng_state", True))
    per = max(1, len(layers) // segments)
    out = args
    for i in range(0, len(layers), per):
        out = recompute(_Chunk(layers[i:i + per]),
                        *(out if isinstance(out, tuple) else (out,)),
                        **kwargs)
    return out
