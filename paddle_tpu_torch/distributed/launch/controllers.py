"""Process supervision of the launcher (after
``paddle_tpu/distributed/launch/controllers.py``; upstream
``launch/controllers/watcher.py``, ``collective.py``'s teardown and
``fleet/elastic/manager.py``'s ``ElasticManager``).

:func:`build_env` is the launch environment contract, the ``PADDLE_*``
variables each worker reads (``distributed/parallel.py`` ``ParallelEnv``).
:class:`Watcher` polls the workers and tears the world down on the first
non-zero exit. :class:`ElasticSupervisor` restarts the whole world after a
failure, up to ``max_restarts`` times; the training script resumes from
its own checkpoint, as upstream documents. No partial world goes on.
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

__all__ = ["Watcher", "ElasticSupervisor", "build_env"]


def build_env(rank: int, world_size: int, endpoints: Sequence[str],
              base_env: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """The launch env contract (reference: launch/controllers/collective.py
    sets PADDLE_* per worker)."""
    env = dict(os.environ if base_env is None else base_env)
    env.update({
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_TRAINERS_NUM": str(world_size),
        "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
        "PADDLE_CURRENT_ENDPOINT": endpoints[rank],
        "PADDLE_MASTER": endpoints[0],
    })
    return env


class Watcher:
    """Monitors worker processes; on any failure kills the rest (reference:
    controllers/watcher.py + Controller.watch)."""

    def __init__(self, procs: List[subprocess.Popen],
                 log_prefix: str = "worker", owned_files=None):
        self.procs = procs
        self.log_prefix = log_prefix
        self._owned_files = list(owned_files or [])

    def close_files(self):
        for f in self._owned_files:
            try:
                f.close()
            except OSError:
                pass
        self._owned_files = []

    def poll(self) -> Optional[int]:
        """None while all alive; first non-zero exit code once any worker
        dies; 0 when all exited cleanly."""
        codes = [p.poll() for p in self.procs]
        bad = [c for c in codes if c not in (None, 0)]
        if bad:
            return bad[0]
        if all(c == 0 for c in codes):
            return 0
        return None

    def kill_all(self, sig=signal.SIGTERM, grace: float = 5.0):
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.send_signal(sig)
                except OSError:
                    pass
        deadline = time.time() + grace
        for p in self.procs:
            while p.poll() is None and time.time() < deadline:
                time.sleep(0.05)
            if p.poll() is None:
                try:
                    p.kill()
                except OSError:
                    pass

    def wait(self, poll_interval: float = 0.2) -> int:
        try:
            while True:
                code = self.poll()
                if code == 0:
                    return 0
                if code is not None:
                    self.kill_all()
                    return code
                time.sleep(poll_interval)
        finally:
            self.close_files()


class ElasticSupervisor:
    """Restart-from-checkpoint elasticity (reference: ElasticManager fault
    tolerance levels, minus etcd — membership is the process table; training
    scripts are expected to resume from their own checkpoints, exactly as
    upstream documents)."""

    def __init__(self, cmd_builder, world_size: int,
                 endpoints: Sequence[str], max_restarts: int = 3,
                 log_dir: Optional[str] = None,
                 compile_cache_dir: Optional[str] = None):
        self.cmd_builder = cmd_builder  # rank -> argv list
        self.world_size = world_size
        self.endpoints = list(endpoints)
        self.max_restarts = max_restarts
        self.log_dir = log_dir
        # PADDLE_COMPILATION_CACHE_DIR stays in the environment contract
        # (the reference points it at an XLA cache shared across
        # restarts). The port compiles no program at run time that it
        # could keep there: its kernels' build directory
        # (build/paddle_tpu_torch/) already outlives a restart. A worker
        # may read the variable; nothing in the port does.
        if compile_cache_dir is None and log_dir:
            compile_cache_dir = os.path.join(log_dir, "compile_cache")
        self.compile_cache_dir = compile_cache_dir
        self.restarts = 0

    def _spawn_world(self) -> Watcher:
        procs = []
        files = []
        for rank in range(self.world_size):
            env = build_env(rank, self.world_size, self.endpoints)
            if self.compile_cache_dir:
                env["PADDLE_COMPILATION_CACHE_DIR"] = self.compile_cache_dir
            stdout = stderr = None
            if self.log_dir:
                os.makedirs(self.log_dir, exist_ok=True)
                # reference layout: log/workerlog.N
                f = open(os.path.join(self.log_dir, f"workerlog.{rank}"),
                         "ab")
                files.append(f)
                stdout = stderr = f
            procs.append(subprocess.Popen(
                self.cmd_builder(rank), env=env, stdout=stdout,
                stderr=stderr,
            ))
        return Watcher(procs, owned_files=files)

    def run(self) -> int:
        while True:
            watcher = self._spawn_world()
            code = watcher.wait()
            if code == 0:
                return 0
            self.restarts += 1
            if self.restarts > self.max_restarts:
                print(f"[elastic] giving up after {self.restarts - 1} "
                      f"restarts (exit {code})", file=sys.stderr)
                return code
            print(f"[elastic] worker failed (exit {code}); restarting world "
                  f"(attempt {self.restarts}/{self.max_restarts})",
                  file=sys.stderr)
