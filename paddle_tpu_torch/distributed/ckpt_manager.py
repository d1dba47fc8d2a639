"""Training checkpoints and preemption, after
``paddle_tpu/distributed/ckpt_manager.py``.

* :class:`CheckpointManager` — ``step-<N>`` checkpoints under one root
  through the atomic commit of ``distributed/checkpoint.py``: keep-last-N
  retention, the root ``MANIFEST.json`` and staging GC, all run in the
  writer (a thread when ``async_save``) right after the commit; ``restore``
  walks back to the newest step whose digests verify.
* :func:`pack_train_state` / :func:`unpack_train_state` — one flat dict
  with the whole resume closure: ``model/`` parameters and buffers,
  ``opt/`` slots, ``rng/seed`` and ``rng/counter``
  (``framework.random``), and the ``train/`` epoch, step and global step.
* :class:`PreemptionGuard` / :exc:`TrainingPreempted` — SIGTERM is
  latched, never acted on mid-step; the train loop drains the step,
  force-commits a checkpoint and raises :exc:`TrainingPreempted`.

Counters, as in the reference: ``paddle_tpu_train_checkpoints_total{mode}``
and ``paddle_tpu_train_ckpt_commit_seconds`` here; the fit loop records
the retries, rollbacks, resumes and preemptions. The manager passes its
fault plan to the writer; it fires no point of its own.
"""
from __future__ import annotations

import os
import signal as _signal
import threading
import time
from typing import Any, Dict, Optional, Tuple

from ..framework import random as _random
from . import checkpoint as _ckpt

__all__ = ["CheckpointManager", "PreemptionGuard", "TrainingPreempted",
           "pack_train_state", "unpack_train_state"]

_MODEL = "model/"
_OPT = "opt/"
_RNG = "rng/"
_TRAIN = "train/"


class TrainingPreempted(RuntimeError):
    """Raised by the train loop AFTER the drain + force-commit completed:
    the process may exit; ``fit(resume='auto')`` on the next incarnation
    continues from ``checkpoint_path`` exactly."""

    def __init__(self, message: str, step: Optional[int] = None,
                 checkpoint_path: Optional[str] = None):
        super().__init__(message)
        self.step = step
        self.checkpoint_path = checkpoint_path


class PreemptionGuard:
    """Latches preemption signals instead of dying mid-step.

    SIGTERM (a preemption notice) sets a flag; the training loop
    polls ``preempted`` at step boundaries, so the step in flight always
    drains and the force-committed checkpoint is step-aligned. Installed
    handlers are restored on exit. Off the main thread (where CPython
    refuses ``signal.signal``) the guard degrades to a pure flag that
    fault injection (``preempt-signal``) or the host can still
    ``trip()``."""

    def __init__(self, signals=None):
        self.signals = tuple(signals) if signals is not None else (
            _signal.SIGTERM,)
        self._flag = threading.Event()
        self._prev: Dict[int, Any] = {}

    def __enter__(self) -> "PreemptionGuard":
        for s in self.signals:
            try:
                self._prev[s] = _signal.signal(s, self._on_signal)
            except ValueError:  # not the main thread: flag-only mode
                break
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            try:
                _signal.signal(s, prev)
            except ValueError:
                pass
        self._prev.clear()
        return False

    def _on_signal(self, signum, frame):
        self._flag.set()

    def trip(self):
        """Arm the flag without a real signal (fault injection / tests)."""
        self._flag.set()

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()


def pack_train_state(model_state: Optional[Dict[str, Any]] = None,
                     optimizer_state: Optional[Dict[str, Any]] = None,
                     rng: bool = True,
                     **progress) -> Dict[str, Any]:
    """Flatten the full resume closure into one checkpointable dict:
    ``model/<name>`` params, ``opt/<name>`` slots, ``rng/seed`` +
    ``rng/counter`` (the global stream position), and ``train/<k>``
    progress scalars (epoch / step / global_step / samples cursor)."""
    out: Dict[str, Any] = {}
    for k, v in (model_state or {}).items():
        out[_MODEL + k] = v
    for k, v in (optimizer_state or {}).items():
        out[_OPT + k] = v
    if rng:
        snap = _random.rng_state_snapshot()
        out[_RNG + "seed"] = snap["seed"]
        out[_RNG + "counter"] = snap["counter"]
    for k, v in progress.items():
        out[_TRAIN + k] = v
    return out


def unpack_train_state(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Invert :func:`pack_train_state`: ``{"model": {...}, "optimizer":
    {...}, "rng": {seed, counter} | None, "progress": {...}}``."""
    model: Dict[str, Any] = {}
    opt: Dict[str, Any] = {}
    rng: Dict[str, int] = {}
    progress: Dict[str, Any] = {}
    for k, v in flat.items():
        if k.startswith(_MODEL):
            model[k[len(_MODEL):]] = v
        elif k.startswith(_OPT):
            opt[k[len(_OPT):]] = v
        elif k.startswith(_RNG):
            rng[k[len(_RNG):]] = int(v)
        elif k.startswith(_TRAIN):
            progress[k[len(_TRAIN):]] = v
    return {"model": model, "optimizer": opt,
            "rng": rng if rng else None, "progress": progress}


class CheckpointManager:
    """``step-<N>`` checkpoints under one root, committed atomically.

    * ``save(step, state)`` — sync or background (``async_save=True``);
      retention (keep-last-N), the root manifest, and staging GC run in
      the writer right AFTER the commit rename, so the root is always
      tidy and ``latest`` discovery never races a half-written dir.
    * ``latest_step()`` / ``all_steps()`` — committed steps only.
    * ``restore(step=None)`` — load the newest
      or a specific committed checkpoint.

    A second ``save()`` while one is in flight joins the previous write
    first (single-writer, ordered landings); a failed background write
    re-raises on the next ``save()``/``wait()`` and on every
    ``handle.wait()``.
    """

    def __init__(self, root: str, keep_last_n: int = 3,
                 async_save: bool = False, fault_plan=None):
        self.root = os.path.abspath(root)
        self.keep_last_n = keep_last_n
        self.async_save = async_save
        self.fault_plan = fault_plan
        os.makedirs(self.root, exist_ok=True)
        self._writer = _ckpt.AsyncCheckpointer()
        self._fs_lock = threading.Lock()
        self._inflight_stage: set = set()
        self._last_integrity_error = None  # newest skipped-corrupt cause
        # a previous incarnation may have died mid-save: reclaim its
        # staging dirs now, before the first write lands next to them
        self.gc()

    # ------------------------------------------------------------- layout
    def step_path(self, step: int) -> str:
        return _ckpt.step_dir(self.root, step)

    def all_steps(self):
        return _ckpt.list_steps(self.root)

    def latest_step(self) -> Optional[int]:
        return _ckpt.latest_step(self.root)

    def gc(self):
        with self._fs_lock:
            return _ckpt.gc_staging(self.root,
                                    in_flight=self._inflight_stage)

    # --------------------------------------------------------------- save
    def save(self, step: int, state_dict: Dict[str, Any],
             sync: Optional[bool] = None) -> _ckpt.AsyncSaveHandle:
        """Commit ``state_dict`` as ``step-<step>``. ``sync=True`` forces
        a blocking save regardless of the manager mode (the preemption
        drain path needs the commit ON DISK before the process exits)."""
        use_async = self.async_save if sync is None else (not sync)
        t0 = time.perf_counter()

        def _post_commit(path: str):
            with self._fs_lock:
                _ckpt.retain_last(self.root, self.keep_last_n)
                _ckpt.write_manifest(self.root)
                _ckpt.gc_staging(self.root, in_flight=self._inflight_stage)
            self._record_commit(use_async, time.perf_counter() - t0)

        path = self.step_path(step)
        if use_async:
            return self._writer.save(state_dict, path,
                                     fault_plan=self.fault_plan,
                                     on_commit=_post_commit)
        # still route through the single-writer so a sync save can't
        # interleave with a previous async one to the same root
        self._writer.wait()
        return _ckpt.save_state_dict(state_dict, path,
                                     fault_plan=self.fault_plan,
                                     on_commit=_post_commit)

    def wait(self):
        """Join the in-flight background save (re-raising its failure)."""
        self._writer.wait()

    # ------------------------------------------------------------ restore
    def restore(self, step: Optional[int] = None
                ) -> Tuple[int, Dict[str, Any]]:
        """Load the newest VERIFYING (or a specific) committed
        checkpoint; returns ``(step, state_dict)`` (CPU tensors).

        Silent-corruption fallback: with ``step=None`` the
        walk goes newest-first through ``list_steps`` and a step whose
        content digests fail verification is SKIPPED (counted in
        ``paddle_tpu_integrity_failures_total{target="checkpoint"}``)
        instead of aborting the restore — a bit flipped in the newest
        checkpoint costs one retention slot, not the training run.
        Raises ``FileNotFoundError`` when the root has no committed
        checkpoint (or the requested step is missing/incomplete), and —
        only for an EXPLICIT ``step=`` — the typed ``IntegrityError``
        when that step is committed but corrupt (an explicit step is a
        human decision; silently loading a different one would be
        worse than failing)."""
        from ..inference.errors import IntegrityError

        if step is not None:
            path = self.step_path(step)
            if not _ckpt.is_complete(path):
                raise FileNotFoundError(
                    f"checkpoint step-{step} under {self.root} is "
                    "missing or incomplete")
            return int(step), _ckpt.load_state_dict(path)
        steps = self.all_steps()
        if not steps:
            raise FileNotFoundError(
                f"no committed checkpoint under {self.root}")
        corrupt = []
        for s in reversed(steps):
            path = self.step_path(s)
            try:
                # cheap digest sweep first: a corrupt step is rejected
                # before any array materializes
                _ckpt.verify_contents(path)
                state = _ckpt.load_state_dict(path)
            except IntegrityError as e:
                # fall back to the next-newest step — the whole point
                # of keep-last-N retention under an SDC threat model
                self._note_restore_fault(corrupt, s, e)
                continue
            return int(s), state
        raise FileNotFoundError(
            f"every committed checkpoint under {self.root} failed "
            f"content verification (steps {corrupt}); nothing safe to "
            "restore") from self._last_integrity_error

    def _note_restore_fault(self, corrupt: list, step: int,
                            exc: BaseException):
        """One corrupt step skipped by the restore walk: the detection
        stays attributable — the cause is retained (re-raised as the
        chained exception when NOTHING verifies), the step recorded,
        and the verify pass already counted it in
        ``paddle_tpu_integrity_failures_total{target="checkpoint"}``."""
        corrupt.append(int(step))
        self._last_integrity_error = exc

    # ------------------------------------------------------------ metrics
    @staticmethod
    def _record_commit(was_async: bool, seconds: float):
        from ..observability import counter, histogram

        counter("paddle_tpu_train_checkpoints_total",
                "committed training checkpoints, by save mode",
                labelnames=("mode",)).labels(
                    mode="async" if was_async else "sync").inc()
        histogram("paddle_tpu_train_ckpt_commit_seconds",
                  "wall time from save() to atomic commit").observe(seconds)
