"""The launch command (after ``paddle_tpu/distributed/launch/main.py``;
upstream ``python/paddle/distributed/launch/main.py``).

    python -m paddle_tpu_torch.distributed.launch \
        [--nnodes 1] [--node_rank 0] [--master ip:port] \
        [--nproc_per_node 1] [--devices 0,1] [--log_dir log] \
        [--elastic N] [--elastic_master http://host:port] \
        train.py [script args...]

Each worker is ``python train.py ...`` with the ``PADDLE_*`` environment
(:func:`~.controllers.build_env`), its output in ``<log_dir>/workerlog.N``.
The script starts its world with ``distributed.init_parallel_env``, which
reads that environment and rendezvouses at ``PADDLE_MASTER``.

* ``--nproc_per_node`` keeps the reference's default of 1. The torch
  model is one process a GPU: pass the number of cards of the node (or
  more ranks than cards over gloo, which then share cards).
* ``--devices`` gives local rank ``l`` the card ``devices[l % n]`` through
  ``FLAGS_selected_gpus`` (the reference sets the JAX package's visible
  devices instead). Without it, ``init_parallel_env`` takes card
  ``rank % device_count``.
* ``--elastic N`` restarts the whole world up to N times after a worker
  fails; the script resumes from its checkpoint.
* ``--elastic_master`` joins an :class:`~.master.ElasticMaster`'s
  membership (:func:`launch_with_master`).
"""
from __future__ import annotations

import argparse
import os
import socket
import sys
from typing import List, Optional, Sequence

from .controllers import ElasticSupervisor, Watcher, build_env

__all__ = ["launch", "main"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _select_device(env, devices: str, local_rank: int):
    """Give local rank ``local_rank`` its card of ``devices`` ("0,1,...")
    in ``FLAGS_selected_gpus``, which ``init_parallel_env`` reads."""
    ids = [d.strip() for d in devices.split(",") if d.strip()] \
        if devices else []
    if ids:
        env["FLAGS_selected_gpus"] = ids[local_rank % len(ids)]


def _parse(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="launch distributed training (one process a rank)",
    )
    p.add_argument("--nnodes", type=int, default=1)
    p.add_argument("--node_rank", type=int, default=int(
        os.environ.get("PADDLE_NODE_RANK", "0")))
    p.add_argument("--master", type=str,
                   default=os.environ.get("PADDLE_MASTER", ""))
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="processes per node (one a GPU)")
    p.add_argument("--devices", "--gpus", "--xpus", type=str, default="",
                   help="card ids for this node's ranks, in local rank order")
    p.add_argument("--log_dir", type=str, default="log")
    p.add_argument("--elastic", type=int, default=0,
                   help="max whole-world restarts on worker failure")
    p.add_argument("--elastic_master", type=str, default="",
                   help="http://host:port of the rendezvous master "
                        "(multi-node elastic membership)")
    p.add_argument("--node_endpoint", type=str, default="",
                   help="this node's advertised host:base_port "
                        "(with --elastic_master)")
    p.add_argument("--run_mode", type=str, default="collective")
    p.add_argument("script", type=str)
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def launch(script: str, script_args: Sequence[str] = (),
           nproc_per_node: int = 1, nnodes: int = 1, node_rank: int = 0,
           master: str = "", log_dir: Optional[str] = "log",
           elastic: int = 0, devices: str = "") -> int:
    """Programmatic entry (what main() calls; usable from tests)."""
    world_size = nnodes * nproc_per_node
    if world_size == 1 and not master:
        # degenerate single-process: exec in-process environment, run script
        env = build_env(0, 1, [f"127.0.0.1:{_free_port()}"])
        _select_device(env, devices, 0)
        import subprocess

        return subprocess.call([sys.executable, script, *script_args],
                               env=env)

    if nnodes > 1 and not master:
        raise ValueError("--master ip:port is required for multi-node")

    # The multi-node contract is (master address, world size, rank): the
    # endpoint list is derived from the master address, identical on every
    # node, and rank 0's endpoint is where torch.distributed rendezvouses
    # (the reference gathers real per-node endpoints through its HTTP/etcd
    # master). Single-node runs use local free ports.
    if master:
        host, mport = master.split(":")
        base_port = int(mport)
    else:
        host, base_port = "127.0.0.1", _free_port()
    all_eps: List[str] = [
        f"{host}:{base_port + n * nproc_per_node + l}"
        for n in range(nnodes) for l in range(nproc_per_node)
    ]

    def cmd(rank_local: int) -> List[str]:
        return [sys.executable, script, *script_args]

    def builder(local_rank: int):
        return cmd(local_rank)

    first_rank = node_rank * nproc_per_node

    class _NodeSupervisor(ElasticSupervisor):
        def _spawn_world(self):
            import subprocess

            procs = []
            files = []
            for local in range(nproc_per_node):
                rank = first_rank + local
                env = build_env(rank, world_size, all_eps)
                _select_device(env, devices, local)
                stdout = stderr = None
                if self.log_dir:
                    os.makedirs(self.log_dir, exist_ok=True)
                    f = open(os.path.join(self.log_dir,
                                          f"workerlog.{rank}"), "ab")
                    files.append(f)
                    stdout = stderr = f
                procs.append(subprocess.Popen(
                    self.cmd_builder(local), env=env,
                    stdout=stdout, stderr=stderr,
                ))
            return Watcher(procs, owned_files=files)

    sup = _NodeSupervisor(builder, world_size, all_eps,
                          max_restarts=elastic, log_dir=log_dir)
    if elastic > 0:
        return sup.run()
    watcher = sup._spawn_world()
    return watcher.wait()


def launch_with_master(script: str, script_args: Sequence[str] = (),
                       master_url: str = "", node_endpoint: str = "",
                       nproc_per_node: int = 1, log_dir: Optional[str] = "log",
                       max_restarts: int = 3, devices: str = "",
                       poll_interval: float = 0.5) -> int:
    """Agent-driven multi-node elastic launch (reference: ElasticManager's
    watch loop over etcd membership + controllers/master.py).

    Registers this node with the HTTP master, waits for the world to be
    ready, spawns the local workers, then watches BOTH the local processes
    and the membership epoch. A worker failure or an epoch change (node died
    elsewhere / node joined) tears the local world down and relaunches under
    the new assignment; scripts resume from their checkpoints."""
    import subprocess
    import time as _time

    from .master import NodeAgent

    if not node_endpoint:
        node_endpoint = f"{socket.gethostbyname(socket.gethostname())}:" \
                        f"{_free_port()}"
    host, base_port = node_endpoint.rsplit(":", 1)
    base_port = int(base_port)
    agent = NodeAgent(master_url, node_id=node_endpoint,
                      endpoint=node_endpoint).start()
    restarts = 0
    code = 1
    try:
        while True:
            node_rank, world_nodes, epoch = agent.wait_ready()
            nnodes = len(world_nodes)
            world_size = nnodes * nproc_per_node
            all_eps: List[str] = []
            for ep in world_nodes:
                h, p0 = ep.rsplit(":", 1)
                all_eps += [f"{h}:{int(p0) + l}"
                            for l in range(nproc_per_node)]
            procs, files = [], []
            for local in range(nproc_per_node):
                rank = node_rank * nproc_per_node + local
                env = build_env(rank, world_size, all_eps)
                env["PADDLE_ELASTIC_EPOCH"] = str(epoch)
                _select_device(env, devices, local)
                stdout = stderr = None
                if log_dir:
                    os.makedirs(log_dir, exist_ok=True)
                    f = open(os.path.join(log_dir, f"workerlog.{rank}"),
                             "ab")
                    files.append(f)
                    stdout = stderr = f
                procs.append(subprocess.Popen(
                    [sys.executable, script, *script_args], env=env,
                    stdout=stdout, stderr=stderr))
            watcher = Watcher(procs, owned_files=files)
            reason = None
            while reason is None:
                code = watcher.poll()
                if code == 0:
                    agent.stop()
                    watcher.close_files()
                    return 0
                if code is not None:
                    reason = f"local worker failed (exit {code})"
                elif agent.epoch_changed(epoch):
                    reason = "membership epoch changed"
                else:
                    _time.sleep(poll_interval)
            watcher.kill_all()
            watcher.close_files()
            restarts += 1
            if restarts > max_restarts:
                print(f"[elastic] giving up after {restarts - 1} restarts "
                      f"({reason})", file=sys.stderr)
                return code if isinstance(code, int) and code else 1
            print(f"[elastic] {reason}; relaunching "
                  f"(attempt {restarts}/{max_restarts})", file=sys.stderr)
    finally:
        agent.stop()


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _parse(argv)
    if args.elastic_master:
        return launch_with_master(
            args.script, args.script_args, master_url=args.elastic_master,
            node_endpoint=args.node_endpoint,
            nproc_per_node=args.nproc_per_node, log_dir=args.log_dir,
            max_restarts=args.elastic, devices=args.devices,
        )
    return launch(
        args.script, args.script_args, nproc_per_node=args.nproc_per_node,
        nnodes=args.nnodes, node_rank=args.node_rank, master=args.master,
        log_dir=args.log_dir, elastic=args.elastic, devices=args.devices,
    )


if __name__ == "__main__":
    sys.exit(main())
