"""``Model`` — the Keras-like trainer, after ``paddle_tpu/hapi/model.py``:
``prepare``, ``train_batch`` / ``eval_batch`` / ``predict_batch``,
``fit`` with its resilience surface, ``evaluate``, ``predict``, ``save``
and ``load``.

Each batch goes to the device of the network's parameters (from pinned
host memory when that is the card: ``fit`` builds its loaders with
``pin_memory``). A step runs eagerly: forward, ``loss.backward()``,
``optimizer.step()``, ``clear_grad()``, and the losses come back as host
floats. ``prepare(amp_configs=)`` is accepted and ignored, as in the
reference.

Fault points (``testing.faultinject``) fired here: ``train-step-exception``
(before each attempt of a step, in ``_guarded_train_batch``),
``train-nan-loss`` (turns a step's loss into NaN, after the step) and
``preempt-signal`` (at each step's end, as a SIGTERM would).
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from .callbacks import Callback, CallbackList, ProgBarLogger

__all__ = ["Model"]


def _to_tensor(x, device):
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
    return x.to(device, non_blocking=True)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self.stop_training = False

    @property
    def device(self) -> torch.device:
        """Where the network's parameters (or buffers) live."""
        for t in list(self.network.parameters()) + list(
                self.network.buffers()):
            return t.device
        return torch.device("cpu")

    # ------------------------------------------------------------- prepare
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = _as_list(metrics)

    # -------------------------------------------------------------- batches
    def train_batch(self, inputs, labels=None, update: bool = True):
        self.network.train()
        dev = self.device
        ins = [_to_tensor(i, dev) for i in _as_list(inputs)]
        outs = self.network(*ins)
        losses = self._compute_loss(outs, labels, dev)
        total = losses[0]
        for l in losses[1:]:
            total = total + l
        total.backward()
        if update and self._optimizer is not None:
            self._optimizer.step()
            self._optimizer.clear_grad()
        return [float(l.detach()) for l in losses]

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        dev = self.device
        ins = [_to_tensor(i, dev) for i in _as_list(inputs)]
        outs = self.network(*ins)
        losses = self._compute_loss(outs, labels, dev)
        self._update_metrics(outs, labels, dev)
        return [float(l) for l in losses]

    @torch.no_grad()
    def predict_batch(self, inputs):
        self.network.eval()
        dev = self.device
        ins = [_to_tensor(i, dev) for i in _as_list(inputs)]
        outs = self.network(*ins)
        return [_np(o) for o in _as_list(outs)]

    def _compute_loss(self, outs, labels, dev):
        if self._loss is None:
            return [o.mean() for o in _as_list(outs)]
        labels = [_to_tensor(l, dev) for l in _as_list(labels)]
        out_list = _as_list(outs)
        return [self._loss(*out_list, *labels)]

    def _update_metrics(self, outs, labels, dev):
        if not self._metrics:
            return
        import warnings

        labels_t = [_to_tensor(l, dev) for l in _as_list(labels)]
        for m in self._metrics:
            try:
                corr = m.compute(*_as_list(outs), *labels_t)
                if isinstance(corr, tuple):
                    m.update(*[_np(c) for c in corr])
                else:
                    m.update(_np(corr))
            except Exception as e:  # surface, don't abort the eval loop
                warnings.warn(
                    f"metric {type(m).__name__} failed: {e!r}; its "
                    "accumulated value will be unreliable")

    # ------------------------------------------------------------------ fit
    def fit(self, train_data=None, eval_data=None, batch_size: int = 1,
            epochs: int = 1, eval_freq: int = 1, log_freq: int = 10,
            save_dir=None, save_freq: int = 1, verbose: int = 2,
            drop_last: bool = False, shuffle: bool = True, num_workers: int = 0,
            callbacks: Optional[List[Callback]] = None,
            ckpt_dir: Optional[str] = None, ckpt_freq: Optional[int] = None,
            resume=None, keep_last_n: int = 3, async_ckpt: bool = False,
            grace_secs: float = 30.0, max_step_retries: int = 0,
            retry_backoff: float = 0.1,
            divergence_factor: Optional[float] = None,
            fault_plan=None):
        """Train. The resilience surface (all opt-in via ``ckpt_dir``):

        * ``ckpt_dir`` — CheckpointManager root: atomic ``step-<N>``
          checkpoints of params + optimizer slots + global RNG position +
          the (epoch, step) dataloader cursor, saved every ``ckpt_freq``
          global steps (always at epoch end), ``keep_last_n`` retained,
          written in the background when ``async_ckpt``.
        * ``resume="auto"`` — restart from ``latest`` (no-op when the root
          is empty); ``resume=<int>`` pins a step. A resumed run replays
          the interrupted epoch's exact batch order (per-epoch seeded
          shuffle) from the saved cursor, so loss curves and params are
          bit-identical to an uninterrupted run.
        * SIGTERM / ``preempt-signal`` — the in-flight step drains, a
          final checkpoint force-commits synchronously (warned when it
          blows ``grace_secs``), then :class:`TrainingPreempted` is
          raised carrying the committed step.
        * ``max_step_retries`` — transient step faults retry with
          exponential backoff (grads cleared between attempts).
        * divergence guard — a NaN/inf loss (or, with
          ``divergence_factor``, a loss above ``factor×EMA``) rolls back
          to the last-good checkpoint and skips the offending batch.
        """
        import math
        import time as _time

        from ..testing.faultinject import FaultPlan, plan_from_flags

        loader = self._as_loader(train_data, batch_size, shuffle, drop_last,
                                 num_workers)
        eval_loader = (self._as_loader(eval_data, batch_size, False, False,
                                       num_workers)
                       if eval_data is not None else None)
        cbs = CallbackList((callbacks or [])
                           + ([ProgBarLogger(log_freq, verbose)]
                              if verbose else []))
        cbs.set_model(self)
        cbs.set_params({"epochs": epochs, "verbose": verbose})
        self.stop_training = False

        plan = (FaultPlan.from_spec(fault_plan) if fault_plan is not None
                else plan_from_flags())
        manager = None
        if ckpt_dir is not None:
            from ..distributed.ckpt_manager import CheckpointManager

            manager = CheckpointManager(ckpt_dir, keep_last_n=keep_last_n,
                                        async_save=async_ckpt,
                                        fault_plan=plan)
        start_epoch = start_step = global_step = 0
        last_saved = None
        if resume is not None and manager is not None:
            restored = self._restore_for_resume(manager, resume)
            if restored is not None:
                start_epoch, start_step, global_step = restored
                last_saved = global_step
                self._train_metric("paddle_tpu_train_resumes_total",
                                   "exact-resume restarts from a "
                                   "committed checkpoint")
                if verbose:
                    print(f"resuming from step-{global_step} "
                          f"(epoch {start_epoch}, batch {start_step})")

        from ..distributed.ckpt_manager import (PreemptionGuard,
                                                TrainingPreempted)

        loss_ema = None
        cbs.on_train_begin()
        history = {"loss": []}
        # entered manually so the epoch loop keeps its indentation; the
        # finally below restores the previous SIGTERM handler either way
        guard = PreemptionGuard()
        guard.__enter__()
        try:
            for epoch in range(start_epoch, epochs):
                if manager is not None:
                    self._seed_loader_epoch(loader, epoch)
                skip = start_step if epoch == start_epoch else 0
                cbs.on_epoch_begin(epoch)
                epoch_losses = []
                for step, batch in enumerate(loader):
                    if step < skip:  # fast-forward to the saved cursor
                        continue
                    cbs.on_train_batch_begin(step)
                    ins, labels = self._split_batch(batch)
                    losses = self._guarded_train_batch(
                        ins, labels, plan, max_step_retries, retry_backoff)
                    loss0 = losses[0]
                    if plan is not None and plan.fire("train-nan-loss"):
                        loss0 = float("nan")
                    guard_on = (manager is not None
                                or divergence_factor is not None)
                    spiked = (divergence_factor is not None
                              and loss_ema is not None
                              and loss0 > divergence_factor
                              * max(abs(loss_ema), 1e-8))
                    if guard_on and (not math.isfinite(loss0) or spiked):
                        self._rollback_to_last_good(manager, verbose,
                                                    loss0, epoch, step)
                        continue  # the offending batch is skipped
                    loss_ema = (loss0 if loss_ema is None
                                else 0.9 * loss_ema + 0.1 * loss0)
                    global_step += 1
                    epoch_losses.append(loss0)
                    cbs.on_train_batch_end(step, {"loss": loss0})
                    if (manager is not None and ckpt_freq
                            and global_step % ckpt_freq == 0):
                        manager.save(global_step, self._snapshot_train_state(
                            epoch, step + 1, global_step))
                        last_saved = global_step
                    if guard.preempted or (plan is not None
                                           and plan.fire("preempt-signal")):
                        ck_path = self._drain_and_commit(
                            manager, epoch, step + 1, global_step,
                            grace_secs, _time, verbose)
                        raise TrainingPreempted(
                            f"preempted at global step {global_step}; "
                            f"checkpoint {'committed' if ck_path else 'skipped (no ckpt_dir)'}",
                            step=global_step, checkpoint_path=ck_path)
                    if self.stop_training:
                        break
                logs = {"loss": float(np.mean(epoch_losses))
                        if epoch_losses else 0.0}
                history["loss"].append(logs["loss"])
                if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                    eval_logs = self.evaluate(eval_loader, callbacks=cbs,
                                              _in_fit=True)
                    logs.update(eval_logs)
                cbs.on_epoch_end(epoch, logs)
                if save_dir and (epoch % save_freq == 0):
                    self.save(os.path.join(save_dir, str(epoch)))
                if manager is not None and last_saved != global_step:
                    # epoch-boundary checkpoint: cursor points at the next
                    # epoch's first batch
                    manager.save(global_step, self._snapshot_train_state(
                        epoch + 1, 0, global_step))
                    last_saved = global_step
                start_step = 0
                if self.stop_training:
                    break
        except BaseException:
            # training died mid-epoch (OOM, KeyboardInterrupt, a traced
            # error): the scalar writers' buffered events must still hit
            # disk — flush+close every callback that can, then re-raise.
            # on_train_end is NOT fanned out here: checkpoint-on-end etc.
            # must not run on a half-trained model.
            for c in cbs.callbacks:
                for meth in ("flush", "close"):
                    fn = getattr(c, meth, None)
                    if callable(fn):
                        try:
                            fn()
                        except Exception:
                            pass  # best-effort: never mask the real error
            raise
        finally:
            guard.__exit__(None, None, None)
        if manager is not None:
            manager.wait()  # surface a failed trailing async write
        cbs.on_train_end()
        if save_dir:
            self.save(os.path.join(save_dir, "final"))
        return history

    def evaluate(self, eval_data, batch_size: int = 1, log_freq: int = 10,
                 verbose: int = 0, num_workers: int = 0, callbacks=None,
                 _in_fit: bool = False):
        loader = self._as_loader(eval_data, batch_size, False, False,
                                 num_workers)
        cbs = callbacks if isinstance(callbacks, CallbackList) else (
            CallbackList(_as_list(callbacks)))
        if not _in_fit:
            cbs.set_model(self)
        for m in self._metrics:
            m.reset()
        cbs.on_eval_begin()
        losses = []
        for step, batch in enumerate(loader):
            cbs.on_eval_batch_begin(step)
            ins, labels = self._split_batch(batch)
            losses.append(self.eval_batch(ins, labels)[0])
            cbs.on_eval_batch_end(step)
        logs = {"eval_loss": float(np.mean(losses)) if losses else 0.0}
        for m in self._metrics:
            acc = m.accumulate()
            logs[f"eval_{m.name()}" if callable(getattr(m, 'name', None))
                 else "eval_metric"] = acc
        cbs.on_eval_end(logs)
        return logs

    def predict(self, test_data, batch_size: int = 1, num_workers: int = 0,
                stack_outputs: bool = False, callbacks=None):
        loader = self._as_loader(test_data, batch_size, False, False,
                                 num_workers)
        outs: List[List[np.ndarray]] = []
        for batch in loader:
            ins, _ = self._split_batch(batch)
            outs.append(self.predict_batch(ins))
        if stack_outputs and outs:
            n = len(outs[0])
            return [np.concatenate([o[i] for o in outs]) for i in range(n)]
        return outs

    # ------------------------------------------------------------------- io
    def save(self, path: str, training: bool = True):
        from ..serialization import save as psave

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        psave(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None and hasattr(
                self._optimizer, "state_dict"):
            psave(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path: str, skip_mismatch: bool = False,
             reset_optimizer: bool = False):
        """``path + ".pdparams"`` (of either package) into the network,
        every name required; ``.pdopt`` into the optimizer when present."""
        from ..serialization import load as pload

        self.network.load_state_dict(pload(path + ".pdparams"))
        opt_path = path + ".pdopt"
        if (not reset_optimizer and self._optimizer is not None
                and os.path.exists(opt_path)):
            self._optimizer.set_state_dict(pload(opt_path))

    def parameters(self, *a, **k):
        return self.network.parameters(*a, **k)

    def summary(self, input_size=None, dtype=None):
        lines = [f"{type(self.network).__name__}:"]
        total = 0
        for n, p in self.network.named_parameters():
            cnt = int(np.prod(p.shape))
            total += cnt
            lines.append(f"  {n}: {tuple(p.shape)} ({cnt})")
        lines.append(f"Total params: {total}")
        s = "\n".join(lines)
        print(s)
        return {"total_params": total}

    # ------------------------------------------------- resilience helpers
    def _guarded_train_batch(self, ins, labels, plan, max_retries, backoff):
        """One train step under the transient-fault contract: the
        ``train-step-exception`` hook fires BEFORE compute (a dispatch
        fault), and any step exception is retried up to ``max_retries``
        times with exponential backoff, clearing accumulated grads so a
        half-run backward can't double-count."""
        import time as _time

        from ..testing.faultinject import InjectedFault

        attempt = 0
        while True:
            try:
                if plan is not None and plan.fire("train-step-exception"):
                    raise InjectedFault("injected train-step exception")
                return self.train_batch(ins, labels)
            except Exception:
                if attempt >= max_retries:
                    raise
                attempt += 1
                self._train_metric(
                    "paddle_tpu_train_step_retries_total",
                    "transient train-step faults retried with backoff")
                if self._optimizer is not None:
                    self._optimizer.clear_grad()
                _time.sleep(backoff * (2 ** (attempt - 1)))

    def _snapshot_train_state(self, epoch, next_step, global_step):
        """The full resume closure at a step boundary: params, optimizer
        slots, global RNG position, and the dataloader cursor (epoch +
        next batch index within it)."""
        from ..distributed.ckpt_manager import pack_train_state

        opt_sd = (self._optimizer.state_dict()
                  if self._optimizer is not None
                  and hasattr(self._optimizer, "state_dict") else None)
        return pack_train_state(self.network.state_dict(), opt_sd,
                                epoch=int(epoch), step=int(next_step),
                                global_step=int(global_step))

    def _restore_train_state(self, unpacked):
        """Params + optimizer + RNG from an unpacked checkpoint (the
        progress cursor is the caller's concern)."""
        from ..framework import random as _random

        if unpacked["model"]:
            self.network.load_state_dict(unpacked["model"])
        if (unpacked["optimizer"] and self._optimizer is not None
                and hasattr(self._optimizer, "set_state_dict")):
            self._optimizer.set_state_dict(unpacked["optimizer"])
        if unpacked["rng"]:
            _random.rng_state_restore(unpacked["rng"])

    def _restore_for_resume(self, manager, resume):
        """Resolve ``resume=`` against the checkpoint root; returns the
        (epoch, step, global_step) cursor or None for a fresh start."""
        from ..distributed.ckpt_manager import unpack_train_state

        # identity check: resume=1 means step 1, not auto (1 == True!)
        target = None if (resume is True or resume == "auto") else int(resume)
        try:
            ck_step, state = manager.restore(step=target)
        except FileNotFoundError:
            if target is not None:
                raise
            return None  # resume="auto" on an empty root: fresh run
        u = unpack_train_state(state)
        self._restore_train_state(u)
        prog = u["progress"]
        return (int(prog.get("epoch", 0)), int(prog.get("step", 0)),
                int(prog.get("global_step", ck_step)))

    def _seed_loader_epoch(self, loader, epoch):
        """Pin the epoch's batch order to a deterministic function of
        (global seed, epoch) so an interrupted epoch replays identically
        on resume. Respects a user-pinned sampler generator."""
        from ..framework import random as _random

        bs = getattr(loader, "batch_sampler", None)
        if bs is None:
            return
        if hasattr(bs, "set_epoch"):
            try:
                bs.set_epoch(epoch)
            except Exception:
                pass
        sampler = getattr(bs, "sampler", None)
        if sampler is None:
            return
        # seed when unpinned, and RE-seed every epoch once we own the
        # generator — otherwise epoch N>0 silently replays epoch 0's
        # permutation in a fresh process but not in a resumed one
        owned = getattr(sampler, "_pt_fit_seeded", False)
        if owned or getattr(sampler, "generator", "absent") is None:
            sampler.generator = (
                _random.get_seed() * 1000003 + 7919 * epoch + 1) & 0x7FFFFFFF
            sampler._pt_fit_seeded = True

    def _rollback_to_last_good(self, manager, verbose, loss, epoch, step):
        """Divergence guard: restore the last-good committed checkpoint
        (params/opt/RNG — the cursor keeps advancing so the offending
        batch is skipped) and count the rollback."""
        from ..distributed.ckpt_manager import unpack_train_state

        self._train_metric(
            "paddle_tpu_train_rollbacks_total",
            "divergence-guard rollbacks to the last-good checkpoint")
        if verbose:
            print(f"divergence guard: loss={loss} at epoch {epoch} "
                  f"step {step}; rolling back and skipping the batch")
        if self._optimizer is not None:
            self._optimizer.clear_grad()
        if manager is None or manager.latest_step() is None:
            return  # nothing committed yet: skip the batch only
        manager.wait()  # join an in-flight async write first
        _, state = manager.restore()
        self._restore_train_state(unpack_train_state(state))

    def _drain_and_commit(self, manager, epoch, next_step, global_step,
                          grace_secs, _time, verbose):
        """Preemption drain: the current step has completed; force-commit
        a final checkpoint SYNCHRONOUSLY (the process is about to die)
        and warn when the commit blows the grace budget."""
        import warnings

        self._train_metric("paddle_tpu_train_preemptions_total",
                           "preemption signals drained by the train loop")
        if manager is None:
            return None
        t0 = _time.perf_counter()
        manager.save(global_step,
                     self._snapshot_train_state(epoch, next_step,
                                                global_step),
                     sync=True)
        manager.wait()
        took = _time.perf_counter() - t0
        if took > grace_secs:
            warnings.warn(
                f"preemption checkpoint commit took {took:.1f}s, over the "
                f"{grace_secs:.1f}s grace budget — consider async_ckpt or "
                "a larger ckpt_freq")
        elif verbose:
            print(f"preempted: committed step-{global_step} in {took:.2f}s")
        return manager.step_path(global_step)

    @staticmethod
    def _train_metric(name, help_text):
        from ..observability import counter

        counter(name, help_text).inc()

    # -------------------------------------------------------------- helpers
    def _as_loader(self, data, batch_size, shuffle, drop_last, num_workers):
        from ..io import DataLoader, Dataset

        if data is None:
            raise ValueError("data is required")
        if isinstance(data, DataLoader):
            return data
        if hasattr(data, "__iter__") and not isinstance(data, Dataset):
            return data  # already an iterable of batches
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          drop_last=drop_last, num_workers=num_workers,
                          pin_memory=self.device.type == "cuda")

    @staticmethod
    def _split_batch(batch):
        if isinstance(batch, (list, tuple)):
            if len(batch) >= 2:
                return list(batch[:-1]), [batch[-1]]
            return [batch[0]], None
        return [batch], None
