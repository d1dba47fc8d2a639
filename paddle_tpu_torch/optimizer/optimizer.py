"""Optimizers, after ``paddle_tpu/optimizer/optimizer.py``: the base class
(grad clip, f32 master weights for bf16/fp16 parameters, ``clear_grad``,
``minimize``, ``state_dict``) and the update rules of SGD, Momentum, Adam,
AdamW, Adagrad, RMSProp and Lamb.

``opt.step()`` reads each parameter's ``.grad`` (filled by
``loss.backward()``) and updates it in place. Each rule runs in f32 on
the parameter (or its f32 master copy when ``multi_precision`` and the
parameter is low-precision), the gradient cast to f32, and f32 state; the
result is written back in the parameter's dtype. The port updates the
master copy and the state in place, where the reference makes new arrays.
Learning rates and bias corrections are host floats (the step count lives
on the host), so a step never waits for the device.

The functional API (``init_state_tree`` / ``apply_gradients_tree``) runs
the same rules over nested dicts, lists and tuples of tensors, as the
reference's pytrees: it is pure, returning new parameters and new state
and writing neither input (the rules run on copies). A gradient of None
(a parameter the loss does not reach) counts as zeros, as the
reference's ``jax.grad`` gives them.

``parameters`` takes tensors or ``(name, tensor)`` pairs (such as
``model.named_parameters()``). Names key ``state_dict`` and are what
``AdamW``'s ``apply_decay_param_fun`` sees; a bare tensor is named
``param_<i>`` in the state dict and ``""`` for the decay function, as the
reference's unnamed parameters are.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "RMSProp", "Lamb"]

_LOW = (torch.float16, torch.bfloat16)


def _bias_correction(beta: float, step: int) -> float:
    """``1 - beta ** step`` in f32, as the reference computes it."""
    return float(np.float32(1.0) - np.float32(beta) ** np.float32(step))


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=True,
                 name=None):
        self._lr = learning_rate
        self._params: List[torch.Tensor] = []
        self._names: List[Optional[str]] = []
        for item in (parameters if parameters is not None else []):
            name_i, p = item if isinstance(item, tuple) else (None, item)
            self._params.append(p)
            self._names.append(name_i)
        self._weight_decay = 0.0 if weight_decay is None \
            else float(weight_decay)
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._accumulators: Dict[int, Dict[str, torch.Tensor]] = {}
        self._master_weights: Dict[int, torch.Tensor] = {}
        self._step_count = 0

    # ---------------------------------------------------------------- config
    def _parameter_list(self):
        return [p for p in self._params if p.requires_grad]

    def _named_parameter_list(self):
        return [(n, p) for n, p in zip(self._names, self._params)
                if p.requires_grad]

    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return float(self._lr)

    def set_lr(self, value):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = float(value)

    # ---------------------------------------------------------------- state
    def _state_for(self, p: torch.Tensor):
        pid = id(p)
        if pid not in self._accumulators:
            low = p.dtype in _LOW
            if self._multi_precision and low:
                self._master_weights[pid] = p.detach().float()
            self._accumulators[pid] = self.init_state(
                torch.zeros_like(p, dtype=torch.float32))
        return self._accumulators[pid]

    def init_state(self, zeros_f32) -> Dict[str, Any]:
        """The rule's state for one parameter, from f32 zeros of its
        shape."""
        return {}

    # ------------------------------------------------------------ eager step
    @torch.no_grad()
    def step(self):
        lr = self.get_lr()
        self._step_count += 1
        named = self._named_parameter_list()
        if self._grad_clip is not None:
            pg = [(p, p.grad) for _, p in named]
            for (_, p), (_, g) in zip(named, self._grad_clip(pg)):
                p.grad = g
        for name, p in named:
            if p.grad is None:
                continue
            state = self._state_for(p)
            master = self._master_weights.get(id(p))
            pf = master if master is not None else (
                p if p.dtype == torch.float32 else p.float())
            wd = self._weight_decay if self._decay_applies(name, p) else 0.0
            self._update_rule(pf, p.grad.float(), state, lr,
                              self._step_count, wd)
            if pf is not p:
                p.copy_(pf)

    def _decay_applies(self, name, p) -> bool:
        return True

    def _update_rule(self, p, g, state, lr, step, wd):
        """Update the f32 parameter ``p`` and ``state`` in place from the f32
        gradient ``g``."""
        raise NotImplementedError

    def clear_grad(self, set_to_zero=False):
        for p in self._params:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()

    # -------------------------------------------------------- functional API
    @torch.no_grad()
    def init_state_tree(self, params_tree):
        """The state tree of a params tree (nested dicts / lists / tuples
        of tensors): one dict a parameter, with its f32 master copy under
        ``"master"`` when ``multi_precision`` and it is bf16 or fp16."""
        def per_param(p):
            st = self.init_state(torch.zeros_like(p, dtype=torch.float32))
            if self._multi_precision and p.dtype in _LOW:
                st["master"] = p.detach().float()
            return st

        return _rebuild(params_tree, [per_param(p)
                                      for p in _leaves(params_tree)])

    @torch.no_grad()
    def apply_gradients_tree(self, params_tree, grads_tree, state_tree, lr,
                             step, decay_mask_tree=None):
        """One step over trees: returns ``(new_params, new_state)`` and
        writes none of its inputs. ``lr`` and ``step`` are numbers (or
        one-element tensors); ``decay_mask_tree``, of the params' structure,
        says which parameters take weight decay (all when None)."""
        lr = float(lr)
        step = float(step)
        new_p, new_s = [], []
        params = _leaves(params_tree)
        grads = _leaves(grads_tree, like=params_tree)
        states = _leaves(state_tree, like=params_tree)
        masks = ([True] * len(params) if decay_mask_tree is None
                 else _leaves(decay_mask_tree, like=params_tree))
        for p, g, st, decay in zip(params, grads, states, masks):
            st = {k: v.clone() for k, v in st.items()}
            master = st.pop("master", None)
            pf = master if master is not None else p.detach().float().clone()
            g = torch.zeros_like(pf) if g is None else g.detach().float()
            self._update_rule(pf, g, st, lr, step,
                              self._weight_decay if decay else 0.0)
            if master is not None:
                st["master"] = pf
            new_p.append(pf.to(p.dtype))
            new_s.append(st)
        return _rebuild(params_tree, new_p), _rebuild(params_tree, new_s)

    # -------------------------------------------------------------- state IO
    def _state_names(self):
        return [(n or f"param_{i}", p)
                for i, (n, p) in enumerate(self._named_parameter_list())]

    def state_dict(self):
        out: Dict[str, Any] = {"step": self._step_count}
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        for name, p in self._state_names():
            for k, v in self._accumulators.get(id(p), {}).items():
                out[f"{name}.{k}"] = v
            if id(p) in self._master_weights:
                out[f"{name}.master"] = self._master_weights[id(p)]
        return out

    @torch.no_grad()
    def set_state_dict(self, state):
        self._step_count = int(state.get("step", 0))
        if isinstance(self._lr, LRScheduler) and "LR_Scheduler" in state:
            self._lr.set_state_dict(state["LR_Scheduler"])
        for name, p in self._state_names():
            st = self._state_for(p)
            for k in list(st):
                if f"{name}.{k}" in state:
                    st[k].copy_(torch.as_tensor(state[f"{name}.{k}"]))
            if f"{name}.master" in state:
                self._master_weights[id(p)] = torch.as_tensor(
                    state[f"{name}.master"], dtype=torch.float32,
                    device=p.device).clone()


def _leaves(tree, like=None):
    """The leaves of ``tree`` in order, walking dicts (by key), lists and
    tuples. With ``like``, ``tree`` is walked only as deep as ``like``'s
    structure, so each leaf of ``like`` gives one (possibly structured)
    value of ``tree``."""
    shape = tree if like is None else like
    if isinstance(shape, dict):
        return [x for k in shape for x in _leaves(
            tree[k], None if like is None else like[k])]
    if isinstance(shape, (list, tuple)):
        return [x for i in range(len(shape)) for x in _leaves(
            tree[i], None if like is None else like[i])]
    return [tree]


def _rebuild(like, values):
    """``like``'s structure with its leaves replaced by ``values`` in
    order."""
    it = iter(values)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


class SGD(Optimizer):
    def _update_rule(self, p, g, state, lr, step, wd):
        if wd:
            g = g + wd * p
        p.sub_(lr * g)


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=True, name=None):
        self._momentum = momentum
        self._nesterov = use_nesterov
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def init_state(self, zeros_f32):
        return {"velocity": zeros_f32}

    def _update_rule(self, p, g, state, lr, step, wd):
        if wd:
            g = g + wd * p
        v = state["velocity"]
        v.mul_(self._momentum).add_(g)
        update = g + self._momentum * v if self._nesterov else v
        p.sub_(lr * update)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=True,
                 name=None):
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def init_state(self, zeros_f32):
        return {"moment1": zeros_f32, "moment2": zeros_f32.clone()}

    def _moments(self, g, state, step):
        """Update the moments in place; return the Adam direction
        ``mhat / (sqrt(vhat) + eps)``."""
        m, v = state["moment1"], state["moment2"]
        m.mul_(self._beta1).add_(g, alpha=1 - self._beta1)
        v.mul_(self._beta2).addcmul_(g, g, value=1 - self._beta2)
        mhat = m / _bias_correction(self._beta1, step)
        vhat = v / _bias_correction(self._beta2, step)
        return mhat.div_(vhat.sqrt_().add_(self._eps))

    def _update_rule(self, p, g, state, lr, step, wd):
        # L2-style decay folded into the gradient (paddle Adam semantics)
        if wd:
            g = g + wd * p
        p.sub_(lr * self._moments(g, state, step))


class AdamW(Adam):
    """Decoupled weight decay; ``apply_decay_param_fun(name) -> bool``
    picks the parameters that decay."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=True, name=None):
        self._apply_decay_fun = apply_decay_param_fun
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name)

    def _decay_applies(self, name, p):
        if self._apply_decay_fun is not None:
            return bool(self._apply_decay_fun(name or ""))
        return True

    def _update_rule(self, p, g, state, lr, step, wd):
        upd = self._moments(g, state, step)
        if wd:
            upd.add_(wd * p)
        p.sub_(lr * upd)


class Adagrad(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=True,
                 initial_accumulator_value=0.0, name=None):
        self._eps = epsilon
        self._init_acc = initial_accumulator_value
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def init_state(self, zeros_f32):
        return {"moment": zeros_f32.fill_(self._init_acc)}

    def _update_rule(self, p, g, state, lr, step, wd):
        if wd:
            g = g + wd * p
        acc = state["moment"]
        acc.addcmul_(g, g)
        p.sub_(lr * g / (acc.sqrt() + self._eps))


class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, rho=0.95, epsilon=1e-6,
                 momentum=0.0, centered=False, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=True,
                 name=None):
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def init_state(self, zeros_f32):
        st = {"mean_square": zeros_f32, "moment": zeros_f32.clone()}
        if self._centered:
            st["mean_grad"] = zeros_f32.clone()
        return st

    def _update_rule(self, p, g, state, lr, step, wd):
        if wd:
            g = g + wd * p
        ms = state["mean_square"]
        ms.mul_(self._rho).addcmul_(g, g, value=1 - self._rho)
        if self._centered:
            mg = state["mean_grad"]
            mg.mul_(self._rho).add_(g, alpha=1 - self._rho)
            denom = torch.sqrt(ms - mg * mg + self._eps)
        else:
            denom = torch.sqrt(ms + self._eps)
        mom = state["moment"]
        mom.mul_(self._momentum).add_(lr * g / denom)
        p.sub_(mom)


class Lamb(Adam):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=True, name=None):
        self._exclude_fn = exclude_from_weight_decay_fn
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         lamb_weight_decay, grad_clip, False,
                         multi_precision, name)

    def _decay_applies(self, name, p):
        if self._exclude_fn is not None:
            return not self._exclude_fn(p)
        return True

    def _update_rule(self, p, g, state, lr, step, wd):
        r = self._moments(g, state, step)
        if wd:
            r.add_(wd * p)
        w_norm = torch.linalg.vector_norm(p)
        r_norm = torch.linalg.vector_norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones((), device=p.device))
        p.sub_(lr * trust * r)
