"""The port's launcher (``paddle_tpu_torch.distributed.launch``: the
environment contract, the watcher's teardown, the elastic restart and
giving up) and ``spawn``, in the reference's scenarios
(``tests/test_launch.py``), plus ``python -m
paddle_tpu_torch.distributed.launch`` itself, ``--devices``, and a
launched two-rank gloo world that trains an expert-parallel MoE layer,
dies once and resumes from its checkpoint to the uninterrupted run's
parameters, bit for bit (one process a rank on the CPU, the same
arithmetic in the same order).
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import torch

from paddle_tpu_torch.distributed.launch import launch
from paddle_tpu_torch.distributed.launch.controllers import (
    ElasticSupervisor,
    Watcher,
    build_env,
)

REPO = Path(__file__).resolve().parents[1]
JOB = REPO / "tests" / "_torch_ep_job.py"


def test_build_env_contract():
    env = build_env(1, 4, [f"h:{p}" for p in range(4)], base_env={})
    assert env["PADDLE_TRAINER_ID"] == "1"
    assert env["PADDLE_TRAINERS_NUM"] == "4"
    assert env["PADDLE_TRAINER_ENDPOINTS"] == "h:0,h:1,h:2,h:3"
    assert env["PADDLE_CURRENT_ENDPOINT"] == "h:1"
    assert env["PADDLE_MASTER"] == "h:0"


WORKER = textwrap.dedent("""
    import os, pathlib
    rank = os.environ["PADDLE_TRAINER_ID"]
    world = os.environ["PADDLE_TRAINERS_NUM"]
    eps = os.environ["PADDLE_TRAINER_ENDPOINTS"].split(",")
    assert len(eps) == int(world)
    assert os.environ["PADDLE_CURRENT_ENDPOINT"] == eps[int(rank)]
    assert os.environ["PADDLE_MASTER"] == eps[0]
    pathlib.Path(os.environ["OUT_DIR"], f"rank{rank}").write_text(
        f"{world} {os.environ.get('FLAGS_selected_gpus')}")
""")


def test_launch_two_workers_env(tmp_path, monkeypatch):
    """Two processes: each finds its rank, the world and the endpoints in
    the contract, and ``--devices`` gives local rank l the card
    ``devices[l]`` in ``FLAGS_selected_gpus`` (which ``ParallelEnv``
    reads; the launched job below reads the rest through it)."""
    script = tmp_path / "w.py"
    script.write_text(WORKER)
    monkeypatch.setenv("OUT_DIR", str(tmp_path))
    code = launch(str(script), nproc_per_node=2, devices="3,5",
                  log_dir=str(tmp_path / "log"))
    assert code == 0
    assert (tmp_path / "rank0").read_text() == "2 3"
    assert (tmp_path / "rank1").read_text() == "2 5"
    # per-rank logs written (the reference's layout, log/workerlog.N)
    assert (tmp_path / "log" / "workerlog.0").exists()


def test_python_m_launch(tmp_path):
    """The command line: ``python -m paddle_tpu_torch.distributed.launch
    --nproc_per_node 2 --log_dir L script``; without ``--devices`` no
    card is chosen (``init_parallel_env`` takes rank % device count)."""
    script = tmp_path / "w.py"
    script.write_text(WORKER)
    env = dict(os.environ, OUT_DIR=str(tmp_path),
               PYTHONPATH=str(REPO))
    env.pop("FLAGS_selected_gpus", None)
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--log_dir", str(tmp_path / "log"),
         str(script)], env=env, cwd=str(tmp_path), capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert (tmp_path / "rank0").read_text() == "2 None"
    assert (tmp_path / "rank1").read_text() == "2 None"


def test_watcher_kills_world_on_failure():
    good = subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(60)"])
    bad = subprocess.Popen([sys.executable, "-c", "import sys; sys.exit(3)"])
    w = Watcher([good, bad])
    code = w.wait()
    assert code == 3
    assert good.poll() is not None  # the sibling was torn down


def test_elastic_restart_from_failure(tmp_path):
    """A worker crashes in its first life and succeeds in its second (a
    flag file): the supervisor restarts the whole world and exits 0."""
    flag = tmp_path / "flag"
    script = tmp_path / "w.py"
    script.write_text(textwrap.dedent(f"""
        import os, pathlib, sys
        flag = pathlib.Path({str(flag)!r})
        if not flag.exists():
            flag.write_text("")
            sys.exit(7)
        sys.exit(0)
    """))
    sup = ElasticSupervisor(
        cmd_builder=lambda rank: [sys.executable, str(script)],
        world_size=2, endpoints=["127.0.0.1:1", "127.0.0.1:2"],
        max_restarts=2, log_dir=str(tmp_path / "log"))
    assert sup.run() == 0
    assert sup.restarts == 1


def test_elastic_gives_up():
    sup = ElasticSupervisor(
        cmd_builder=lambda rank: [sys.executable, "-c",
                                  "import sys; sys.exit(9)"],
        world_size=1, endpoints=["127.0.0.1:1"], max_restarts=1)
    assert sup.run() == 9
    assert sup.restarts == 2


def test_spawn_env_contract(tmp_path):
    """``distributed.spawn``: each worker finds its rank and the world
    in the contract, and ``ParallelEnv`` reads it (the worker imported the
    port before the contract was set). The function must be importable,
    so a driver script runs it."""
    out = tmp_path / "o"
    out.mkdir()
    script = tmp_path / "driver.py"
    script.write_text(textwrap.dedent(f"""
        import os, pathlib, sys
        sys.path.insert(0, {str(REPO)!r})

        def f(base):
            from paddle_tpu_torch.distributed import parallel
            pathlib.Path(base, os.environ["PADDLE_TRAINER_ID"]).write_text(
                f"{{os.environ['PADDLE_TRAINERS_NUM']}} "
                f"{{parallel.get_rank()}} {{parallel.get_world_size()}}")

        if __name__ == "__main__":
            from paddle_tpu_torch.distributed import spawn
            spawn(f, args=({str(out)!r},), nprocs=2)
    """))
    ctx = subprocess.run([sys.executable, str(script)], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=120)
    assert ctx.returncode == 0, ctx.stderr
    assert (out / "0").read_text() == "2 0 2"
    assert (out / "1").read_text() == "2 1 2"


def test_launched_ep_moe_world_resumes_after_a_death(tmp_path):
    """``launch(..., elastic=1)`` of a two-rank gloo job that trains an
    ep = 2 MoE block (``tests/_torch_ep_job.py``): rank 1 exits non-zero
    after step 1's checkpoint, the supervisor restarts the world, the
    ranks resume from the checkpoint (each its experts under their global
    names, the optimizer state with them) and end, bitwise, where the same
    job run from the start without a stop ends (run again in memory by the
    restarted world)."""
    out = tmp_path / "job"
    assert launch(str(JOB), [str(out), "--die-after", "1"],
                  nproc_per_node=2, log_dir=str(out / "log"),
                  elastic=1) == 0
    assert (out / "died").exists()
    logs = (out / "log" / "workerlog.0").read_text()
    assert "rank 0 done from step 1" in logs, logs[-2000:]
    for r in range(2):
        got = torch.load(out / f"final.rank{r}.pt")
        want = torch.load(out / f"uninterrupted.rank{r}.pt")
        experts = {n for n in want if ".experts." in n}
        assert experts == {f"moe.experts.{e}.{leaf}" for e in
                           (2 * r, 2 * r + 1) for leaf in (
                               "fc1.weight", "fc1.bias", "fc2.weight",
                               "fc2.bias")}
        assert sorted(got) == sorted(want)
        for n in want:
            assert torch.equal(got[n], want[n]), n
