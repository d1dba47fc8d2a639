"""The port's elastic membership (``distributed/launch/master.py``:
``ElasticMaster``, ``NodeAgent``) and the agent-driven launch
(``launch_with_master``), in the reference's scenarios
(``tests/test_elastic_master.py``): the rendezvous, scale-in on a death,
scale-out on a join, a full world refused, a master restart rehydrating
its epoch from the journal, and a launch from the master's assignment.
"""
import os
import textwrap
import time

import pytest

from paddle_tpu_torch.distributed.launch.master import ElasticMaster, \
    NodeAgent


@pytest.fixture
def master():
    m = ElasticMaster(min_nodes=2, ttl=2.0).start()
    yield m
    m.shutdown()


def _wait(cond, what, timeout=15):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.2)


class TestMembership:
    def test_rendezvous_two_nodes(self, master):
        url = f"http://127.0.0.1:{master.port}"
        a = NodeAgent(url, "n1", "10.0.0.1:9000",
                      heartbeat_interval=0.3).start()
        assert not a.state()["ready"]  # not ready with one node
        b = NodeAgent(url, "n2", "10.0.0.2:9000",
                      heartbeat_interval=0.3).start()
        ra, wa, ea = a.wait_ready(timeout=10)
        rb, wb, eb = b.wait_ready(timeout=10)
        assert wa == wb == ["10.0.0.1:9000", "10.0.0.2:9000"]
        assert sorted([ra, rb]) == [0, 1]
        assert ea == eb
        a.stop(), b.stop()

    def test_scale_in_on_death(self, master):
        master.min_nodes = 1
        url = f"http://127.0.0.1:{master.port}"
        a = NodeAgent(url, "n1", "10.0.0.1:9000",
                      heartbeat_interval=0.3).start()
        b = NodeAgent(url, "n2", "10.0.0.2:9000",
                      heartbeat_interval=0.3).start()
        _wait(lambda: len(a.state().get("world", [])) >= 2,
              "n2 never joined")
        _, world, epoch = a.wait_ready(timeout=10)
        assert len(world) == 2
        b.stop()  # node 2 dies (stops heartbeating); ttl=2s
        _wait(lambda: a.epoch_changed(epoch), "epoch never bumped")
        r, world2, _ = a.wait_ready(timeout=10)
        assert world2 == ["10.0.0.1:9000"] and r == 0
        a.stop()

    def test_scale_out_on_join(self, master):
        master.min_nodes = 1
        url = f"http://127.0.0.1:{master.port}"
        a = NodeAgent(url, "n1", "10.0.0.1:9000",
                      heartbeat_interval=0.3).start()
        _, world, epoch = a.wait_ready(timeout=10)
        assert len(world) == 1
        b = NodeAgent(url, "n2", "10.0.0.2:9000",
                      heartbeat_interval=0.3).start()
        _wait(lambda: a.epoch_changed(epoch), "epoch never bumped")
        _, world2, _ = a.wait_ready(timeout=10)
        assert len(world2) == 2
        a.stop(), b.stop()

    def test_world_full_rejected(self, master):
        master.min_nodes, master.max_nodes = 1, 1
        url = f"http://127.0.0.1:{master.port}"
        a = NodeAgent(url, "n1", "10.0.0.1:9000").start()
        with pytest.raises(RuntimeError, match="rejected"):
            NodeAgent(url, "n2", "10.0.0.2:9000").start()
        a.stop()


def test_master_restart_rehydrates_epoch(tmp_path):
    """With ``state_path``, a restarted master resumes its epoch numbering
    and re-admits the journaled members, which must confirm within
    ``ttl`` or be reaped (a scale-in, bumping the epoch)."""
    state = str(tmp_path / "master.json")
    m1 = ElasticMaster(min_nodes=1, ttl=1.0, state_path=state).start()
    url = f"http://127.0.0.1:{m1.port}"
    a = NodeAgent(url, "n1", "10.0.0.1:9000", heartbeat_interval=0.2).start()
    _, _, epoch1 = a.wait_ready(timeout=10)
    a.stop()
    m1.shutdown()
    assert os.path.exists(state)
    m2 = ElasticMaster(min_nodes=1, ttl=1.0, state_path=state).start()
    try:
        snap = m2._snapshot()
        assert snap["epoch"] >= epoch1
        assert snap["world"] == ["10.0.0.1:9000"]
        _wait(lambda: m2._snapshot()["nnodes"] == 0,
              "the journaled member was never reaped", timeout=10)
        assert m2._snapshot()["epoch"] > epoch1
    finally:
        m2.shutdown()


def test_agent_driven_launch_end_to_end(tmp_path):
    """``launch_with_master`` spawns the local world from the master's
    assignment (the epoch in ``PADDLE_ELASTIC_EPOCH``) and exits 0 when
    the script does."""
    from paddle_tpu_torch.distributed.launch import launch_with_master

    m = ElasticMaster(min_nodes=1, ttl=5.0).start()
    try:
        script = tmp_path / "ok.py"
        script.write_text(textwrap.dedent("""
            import os
            assert os.environ["PADDLE_TRAINERS_NUM"] == "2"
            assert "PADDLE_ELASTIC_EPOCH" in os.environ
            print("WORKER_DONE", os.environ["PADDLE_TRAINER_ID"])
        """))
        rc = launch_with_master(
            str(script), master_url=f"http://127.0.0.1:{m.port}",
            node_endpoint="127.0.0.1:53100", nproc_per_node=2,
            log_dir=str(tmp_path / "log"), max_restarts=1)
        assert rc == 0
        logs = "".join((tmp_path / "log" / f"workerlog.{i}").read_text()
                       for i in range(2))
        assert "WORKER_DONE 0" in logs and "WORKER_DONE 1" in logs
    finally:
        m.shutdown()
