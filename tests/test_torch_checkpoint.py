"""One process's checkpoints and the fit loop's resilience in the port
(``distributed/checkpoint.py``, ``distributed/ckpt_manager.py``,
``hapi/model.py``, ``framework/random.py``, ``serialization.py``),
after the reference's ``tests/test_train_resilience.py``, plus the
on-disk format held against paddle_tpu's in both directions. At the end,
a checkpoint saved by two gloo processes: a ZeRO-1 model and optimizer,
each rank's slices and marker, loaded whole in one process and back into
two, and a save that one member fails refused as incomplete.

Exactness: checkpoints carry f32 values bit for bit either way; a
preempted and resumed ``fit`` ends with the clean run's losses and
parameters bitwise (no tolerance). The training cases run a small
conv + batch-norm + linear classifier on 16 images of 8x8.
"""
import json
import os
import subprocess
import sys
import textwrap
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.distributed import checkpoint as jckpt

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as nn
import paddle_tpu_torch.optimizer as popt
from paddle_tpu_torch.distributed import (CheckpointManager,
                                          TrainingPreempted,
                                          load_state_dict, pack_train_state,
                                          save_state_dict,
                                          unpack_train_state)
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.framework import random as prandom
from paddle_tpu_torch.hapi.callbacks import Callback
from paddle_tpu_torch.inference.errors import IntegrityError
from paddle_tpu_torch.io import Dataset
from paddle_tpu_torch.observability import metric_total, render_prometheus
from paddle_tpu_torch.testing.faultinject import FaultPlan
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------- helpers
class _Data(Dataset):
    def __init__(self, n=16, seed=3):
        r = np.random.default_rng(seed)
        self.x = r.standard_normal((n, 3, 8, 8)).astype(np.float32)
        self.y = r.integers(0, 3, (n,)).astype(np.int64)

    def __getitem__(self, i):
        return self.x[i], self.y[i]

    def __len__(self):
        return len(self.x)


class _Net(torch.nn.Module):
    def __init__(self, gen):
        super().__init__()
        self.conv = nn.Conv2D(3, 4, 3, padding=1, generator=gen)
        self.bn = nn.BatchNorm2D(4)
        self.pool = nn.AdaptiveAvgPool2D(1)
        self.fc = nn.Linear(4, 3)
        with torch.no_grad():
            self.fc.weight.normal_(0.0, 0.5, generator=gen)

    def forward(self, x):
        h = self.pool(torch.relu(self.bn(self.conv(x))))
        return self.fc(h.flatten(1))


def _build_model(seed=7, lr=0.05):
    pt.seed(seed)
    net = _Net(torch.Generator().manual_seed(seed))
    m = pt.Model(net)
    m.prepare(optimizer=popt.Momentum(learning_rate=lr, momentum=0.9,
                                      parameters=net.parameters()),
              loss=nn.CrossEntropyLoss())
    return m


class _LossRec(Callback):
    def __init__(self, sink):
        self.sink = sink

    def on_train_batch_end(self, step, logs=None):
        self.sink.append(float(logs["loss"]))


def _params(model):
    return {k: v.detach().numpy().copy()
            for k, v in model.network.state_dict().items()}


def _fit(model, root, **kw):
    kw = dict(dict(batch_size=4, epochs=2, shuffle=True, verbose=0,
                   ckpt_freq=2), **kw)
    return model.fit(_Data(), ckpt_dir=str(root), **kw)


# ---------------------------------------------------- atomic commit layer
def test_io_error_never_leaves_a_torn_committed_dir(tmp_path):
    """ckpt-io-error at every write: the failed save leaves only staging
    wreckage, the previous checkpoint stays committed and loadable."""
    root = str(tmp_path / "root")
    good = CheckpointManager(root, keep_last_n=5)
    good.save(1, {"w": torch.full((4, 4), 1.0), "b": torch.zeros(4),
                  "meta": 7})
    n_checks = len([f for f in os.listdir(good.step_path(1))
                    if f.endswith(".npy")]) + 1
    for at in range(1, n_checks + 1):
        mgr = CheckpointManager(root, keep_last_n=5,
                                fault_plan=FaultPlan(f"ckpt-io-error:at={at}"))
        with pytest.raises(OSError):
            mgr.save(2, {"w": torch.full((4, 4), 2.0), "b": torch.ones(4),
                         "meta": 8})
        assert mgr.all_steps() == [1] and mgr.latest_step() == 1
        out = load_state_dict(ckpt.step_dir(root, 1))
        assert torch.equal(out["w"], torch.full((4, 4), 1.0))
        assert out["meta"] == 7
    mgr = CheckpointManager(
        root, keep_last_n=5,
        fault_plan=FaultPlan(f"ckpt-io-error:at={n_checks + 50}"))
    mgr.save(2, {"w": torch.full((4, 4), 2.0), "meta": 8})
    assert mgr.latest_step() == 2


def test_commit_layout_incomplete_dirs_and_gc(tmp_path):
    path = str(tmp_path / "ck")
    save_state_dict({"w": torch.ones(4)}, path)
    assert ckpt.is_complete(path)
    assert [e for e in os.listdir(tmp_path)
            if e.startswith(ckpt.STAGE_PREFIX)] == []
    # a hand-torn dir is invisible and refused
    torn = os.path.join(str(tmp_path), "step-5")
    os.makedirs(torn)
    np.save(os.path.join(torn, "w.p0.c0.npy"), np.ones(3))
    assert ckpt.list_steps(str(tmp_path)) == []
    with pytest.raises(FileNotFoundError):
        load_state_dict(torn)
    with open(os.path.join(torn, "metadata.p0.json"), "w") as f:
        json.dump({"process_count": 2, "tensors": {}, "objects": {}}, f)
    assert not ckpt.is_complete(torn)
    with pytest.raises(FileNotFoundError, match="incomplete"):
        load_state_dict(torn)
    orphan = os.path.join(str(tmp_path), f"{ckpt.STAGE_PREFIX}deadbeef")
    os.makedirs(orphan)
    CheckpointManager(str(tmp_path))  # the init-time GC
    assert not os.path.exists(orphan)


def test_retention_manifest_and_slow_write(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "r"), keep_last_n=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"w": torch.full((2,), float(s))})
    assert mgr.all_steps() == [3, 4]
    man = ckpt.read_manifest(str(tmp_path / "r"))
    assert man["steps"] == [3, 4] and man["latest"] == 4
    step, state = mgr.restore()
    assert step == 4 and torch.equal(state["w"], torch.full((2,), 4.0))
    slow = CheckpointManager(str(tmp_path / "s"), fault_plan=FaultPlan(
        "slow-ckpt-write:delay_ms=60,times=1"))
    t0 = time.perf_counter()
    slow.save(1, {"w": torch.ones(2)})
    assert time.perf_counter() - t0 >= 0.05
    slow.save(2, {"w": torch.ones(2)})
    assert slow.fault_plan.fired("slow-ckpt-write") == 1  # times=1
    assert slow.latest_step() == 2


def test_async_handles_and_single_writer(tmp_path):
    h = save_state_dict({"w": torch.ones(2)}, str(tmp_path / "a"),
                        async_save=True,
                        fault_plan=FaultPlan("ckpt-io-error:at=1"))
    for _ in range(2):
        with pytest.raises(RuntimeError, match="async checkpoint"):
            h.wait()
    assert h.done and h.failed and not h.succeeded
    assert isinstance(h.exception(), OSError)
    ok = save_state_dict({"w": torch.ones(2)}, str(tmp_path / "b"),
                         async_save=True)
    ok.wait()
    assert ok.succeeded and ok.exception() is None
    writer = ckpt.AsyncCheckpointer()
    writer.save({"w": torch.ones(2)}, str(tmp_path / "c"),
                fault_plan=FaultPlan("ckpt-io-error:at=1"))
    with pytest.raises(RuntimeError, match="async checkpoint"):
        writer.save({"w": torch.ones(2)}, str(tmp_path / "d"))
    writer.save({"w": torch.full((2,), 5.0)}, str(tmp_path / "e")).wait()
    assert torch.equal(load_state_dict(str(tmp_path / "e"))["w"],
                       torch.full((2,), 5.0))
    # a live tensor changed after save() does not leak into the file
    live = torch.zeros(3)
    mgr = CheckpointManager(str(tmp_path / "m"), async_save=True,
                            fault_plan=FaultPlan(
                                "slow-ckpt-write:delay_ms=40,times=1"))
    mgr.save(1, {"w": live})
    live.fill_(9.0)
    mgr.save(2, {"w": live})
    mgr.wait()
    assert mgr.all_steps() == [1, 2]
    assert torch.equal(load_state_dict(mgr.step_path(1))["w"],
                       torch.zeros(3))


# ------------------------------------------------------------- integrity
def test_bit_flip_ckpt_is_refused_and_restore_walks_back(tmp_path):
    root = str(tmp_path)
    before = metric_total("paddle_tpu_integrity_failures_total")
    clean = CheckpointManager(root, keep_last_n=5)
    clean.save(1, {"w": torch.arange(64.0), "step": 1})
    flip = CheckpointManager(root, keep_last_n=5,
                             fault_plan=FaultPlan("bit-flip-ckpt:times=1"))
    flip.save(2, {"w": torch.arange(64.0) + 1, "step": 2})
    assert flip.all_steps() == [1, 2]  # committed, but corrupt
    assert ckpt.verify_contents(flip.step_path(1)) == 2
    with pytest.raises(IntegrityError):
        ckpt.verify_contents(flip.step_path(2))
    with pytest.raises(IntegrityError, match="digest mismatch"):
        load_state_dict(flip.step_path(2))
    with pytest.raises(IntegrityError):
        flip.restore(step=2)
    step, state = flip.restore()
    assert step == 1 and torch.equal(state["w"], torch.arange(64.0))
    assert metric_total("paddle_tpu_integrity_failures_total") > before
    # a tampered marker is refused by its self-digest
    meta = os.path.join(flip.step_path(1), "metadata.p0.json")
    with open(meta) as f:
        m = json.load(f)
    m["objects"]["step"] = 99
    with open(meta, "w") as f:
        json.dump(m, f)
    with pytest.raises(IntegrityError, match="self-digest"):
        load_state_dict(flip.step_path(1))
    with pytest.raises(FileNotFoundError, match="failed content"):
        flip.restore()


# ------------------------------------------------- the reference's format
def test_f32_checkpoints_cross_load_exactly(tmp_path):
    r = np.random.default_rng(2)
    w = r.standard_normal((5, 7)).astype(np.float32)
    i = r.integers(-9, 9, (4,)).astype(np.int64)
    save_state_dict({"model/w": torch.from_numpy(w),
                     "model/i": torch.from_numpy(i), "train/step": 3,
                     "opt/LR_Scheduler": {"last_epoch": 2}},
                    str(tmp_path / "port"))
    got = jckpt.load_state_dict(str(tmp_path / "port"))
    np.testing.assert_array_equal(np.asarray(got["model/w"]), w)
    np.testing.assert_array_equal(np.asarray(got["model/i"]), i)
    assert got["train/step"] == 3
    assert got["opt/LR_Scheduler"] == {"last_epoch": 2}
    assert jckpt.verify_contents(str(tmp_path / "port")) == 3
    jckpt.save_state_dict({"w": jnp.asarray(w), "i": jnp.asarray(i),
                           "step": 5}, str(tmp_path / "ref"))
    back = load_state_dict(str(tmp_path / "ref"))
    assert back["w"].dtype == torch.float32 and back["step"] == 5
    np.testing.assert_array_equal(back["w"].numpy(), w)
    np.testing.assert_array_equal(back["i"].numpy(), i)
    assert ckpt.verify_contents(str(tmp_path / "ref")) == 3
    # a chunked tensor (as a sharded reference save writes) reassembles
    meta_path = os.path.join(str(tmp_path / "ref"), "metadata.p0.json")
    with open(meta_path) as f:
        meta = json.load(f)
    info = meta["tensors"]["w"]
    base = info["chunks"][0]["file"]
    halves = []
    for k, rows in enumerate(((0, 3), (3, 5))):
        name = base.replace(".c0.", f".c{k}.")
        np.save(os.path.join(str(tmp_path / "ref"), name), w[rows[0]:rows[1]])
        halves.append({"offset": [rows[0], 0], "shape": [rows[1] - rows[0],
                                                         7], "file": name})
    info["chunks"] = halves
    meta.pop("self_digest")
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    np.testing.assert_array_equal(
        load_state_dict(str(tmp_path / "ref"))["w"].numpy(), w)


def test_bf16_chunks_without_ml_dtypes(tmp_path):
    """The port writes bf16 as its uint16 bits and reads them back
    bitwise; it also reads the reference's bf16 chunks (``V2`` words),
    which the reference's own loader cannot cast back."""
    x = torch.randn(6, 5).bfloat16()
    save_state_dict({"x": x}, str(tmp_path / "port"))
    assert torch.equal(load_state_dict(str(tmp_path / "port"))["x"], x)
    with open(os.path.join(str(tmp_path / "port"), "metadata.p0.json")) as f:
        assert json.load(f)["tensors"]["x"]["dtype"] == "bfloat16"
    bits = x.view(torch.int16).numpy()
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    jckpt.save_state_dict({"x": jx}, str(tmp_path / "ref"))
    back = load_state_dict(str(tmp_path / "ref"))["x"]
    np.testing.assert_array_equal(back.view(torch.int16).numpy(), bits)
    with pytest.raises(ValueError):
        jckpt.load_state_dict(str(tmp_path / "ref"))


def test_pack_unpack_and_rng_stream(tmp_path):
    pt.seed(21)
    for _ in range(3):
        prandom.next_generator()
    snap = prandom.rng_state_snapshot()
    a = [torch.rand(4, generator=prandom.next_generator()) for _ in range(2)]
    flat = pack_train_state({"w": torch.ones(2)}, {"step": 4}, epoch=1,
                            step=2, global_step=6)
    assert flat["rng/seed"] == 21 and flat["rng/counter"] == 5
    save_state_dict(flat, str(tmp_path / "s"))
    u = unpack_train_state(load_state_dict(str(tmp_path / "s")))
    assert u["progress"] == {"epoch": 1, "step": 2, "global_step": 6}
    assert u["optimizer"] == {"step": 4} and u["rng"]["counter"] == 5
    prandom.rng_state_restore(snap)
    b = [torch.rand(4, generator=prandom.next_generator()) for _ in range(2)]
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_failed_save_keeps_the_previous_file(tmp_path, monkeypatch):
    import pickle

    target = str(tmp_path / "m.pdparams")
    pt.save({"w": torch.ones(3)}, target)
    orig = open(target, "rb").read()

    def boom(*a, **k):
        raise OSError("disk died mid-pickle")

    monkeypatch.setattr(pickle, "dump", boom)
    with pytest.raises(OSError):
        pt.save({"w": torch.zeros(3)}, target)
    assert open(target, "rb").read() == orig
    assert [f for f in os.listdir(tmp_path) if ".tmp-" in f] == []


# ------------------------------------------------------------ exact resume
def test_preempt_signal_resume_is_bitwise(tmp_path):
    """preempt-signal at a chosen step: the stitched losses and the final
    parameters (and batch-norm buffers) equal an uninterrupted run's
    bitwise; the resumed model started from other weights."""
    kill_at = int(np.random.default_rng(11).integers(2, 7))
    clean = []
    ma = _build_model()
    _fit(ma, tmp_path / "a", callbacks=[_LossRec(clean)])
    stitched = []
    mb = _build_model()
    with pytest.raises(TrainingPreempted) as ei:
        _fit(mb, tmp_path / "b", callbacks=[_LossRec(stitched)],
             fault_plan=f"preempt-signal:at={kill_at}")
    assert ei.value.step == kill_at
    assert ckpt.is_complete(ei.value.checkpoint_path)
    mc = _build_model(seed=99)
    _fit(mc, tmp_path / "b", callbacks=[_LossRec(stitched)], resume="auto")
    assert stitched == clean and len(clean) == 8
    pa, pc = _params(ma), _params(mc)
    assert sorted(pa) == sorted(pc)
    for k in pa:
        np.testing.assert_array_equal(pa[k], pc[k], err_msg=k)


def test_resume_after_ckpt_io_error(tmp_path):
    """A checkpoint I/O fault kills fit mid-epoch; latest still names the
    last good commit and resuming from it is exact."""
    clean = []
    ma = _build_model()
    _fit(ma, tmp_path / "a", callbacks=[_LossRec(clean)])
    files = os.listdir(CheckpointManager(str(tmp_path / "a")).step_path(8))
    checks = len([f for f in files if f.endswith(".npy")]) + 1
    stitched = []
    mb = _build_model()
    with pytest.raises(OSError):
        _fit(mb, tmp_path / "b", callbacks=[_LossRec(stitched)],
             fault_plan=f"ckpt-io-error:at={checks + 2}")
    last_good = CheckpointManager(str(tmp_path / "b")).latest_step()
    assert last_good == 2
    stitched = stitched[:last_good]
    mc = _build_model(seed=123)
    _fit(mc, tmp_path / "b", callbacks=[_LossRec(stitched)], resume="auto")
    assert stitched == clean
    for k, v in _params(mc).items():
        np.testing.assert_array_equal(v, _params(ma)[k], err_msg=k)


def test_resume_auto_fresh_root_and_pinned_step(tmp_path):
    m = _build_model()
    h = _fit(m, tmp_path / "fresh", epochs=1, resume="auto")
    assert len(h["loss"]) == 1
    root = tmp_path / "r"
    _fit(_build_model(), root, epochs=1, keep_last_n=10)
    steps = CheckpointManager(str(root)).all_steps()
    assert steps == [2, 4]
    _fit(_build_model(seed=42), root, epochs=1, resume=steps[0],
         keep_last_n=10)
    with pytest.raises(FileNotFoundError):
        _fit(_build_model(seed=43), root, epochs=1, resume=9999)


# ------------------------------------------------------ the loop's guards
def test_nan_loss_rolls_back_and_skips(tmp_path):
    before = metric_total("paddle_tpu_train_rollbacks_total")
    m = _build_model()
    h = _fit(m, tmp_path, shuffle=False, fault_plan="train-nan-loss:at=5")
    assert metric_total("paddle_tpu_train_rollbacks_total") == before + 1
    assert all(np.isfinite(h["loss"]))
    for v in _params(m).values():
        assert np.isfinite(v).all()


def test_step_retry_trajectory_equals_clean():
    clean, faulty = [], []
    ma = _build_model()
    ma.fit(_Data(), batch_size=4, epochs=1, shuffle=False, verbose=0,
           callbacks=[_LossRec(clean)])
    before = metric_total("paddle_tpu_train_step_retries_total")
    mb = _build_model()
    mb.fit(_Data(), batch_size=4, epochs=1, shuffle=False, verbose=0,
           callbacks=[_LossRec(faulty)], max_step_retries=2,
           retry_backoff=0.001, fault_plan="train-step-exception:times=2")
    assert faulty == clean
    assert metric_total("paddle_tpu_train_step_retries_total") == before + 2
    for k, v in _params(mb).items():
        np.testing.assert_array_equal(v, _params(ma)[k], err_msg=k)
    with pytest.raises(RuntimeError, match="injected train-step"):
        _build_model().fit(_Data(), batch_size=4, epochs=1, verbose=0,
                           max_step_retries=1, retry_backoff=0.001,
                           fault_plan="train-step-exception")
    text = render_prometheus()
    for name in ("paddle_tpu_train_rollbacks_total",
                 "paddle_tpu_train_checkpoints_total",
                 "paddle_tpu_train_step_retries_total",
                 "paddle_tpu_faults_injected_total"):
        assert name in text


# --------------------------------------------- a real SIGTERM, in processes
_KILL_WORKER = textwrap.dedent("""
    import json, os, signal, sys
    sys.path.insert(0, __REPO__)
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.nn as nn
    import paddle_tpu_torch.optimizer as popt
    from paddle_tpu_torch.distributed import TrainingPreempted
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.io import TensorDataset

    mode, ckpt_dir, out_path, kill_step = sys.argv[1:5]
    kill_step = int(kill_step)
    r = np.random.default_rng(3)
    data = TensorDataset([r.standard_normal((16, 3, 8, 8)).astype(np.float32),
                          r.integers(0, 3, (16,)).astype(np.int64)])
    seed = 7 if mode != "resume" else 1234
    pt.seed(seed)
    gen = torch.Generator().manual_seed(seed)
    net = nn.Sequential(nn.Conv2D(3, 4, 3, padding=1, generator=gen),
                        nn.BatchNorm2D(4), nn.ReLU(), nn.AdaptiveAvgPool2D(1),
                        torch.nn.Flatten(), nn.Linear(4, 3))
    with torch.no_grad():
        net[5].weight.normal_(0.0, 0.5, generator=gen)
    m = pt.Model(net)
    m.prepare(optimizer=popt.Momentum(learning_rate=0.05, momentum=0.9,
                                      parameters=net.parameters()),
              loss=nn.CrossEntropyLoss())
    losses, done = [], [0]

    class Rec(Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(float(logs["loss"]))
            done[0] += 1
            if mode == "kill" and done[0] == kill_step:
                os.kill(os.getpid(), signal.SIGTERM)

    status = "done"
    try:
        m.fit(data, batch_size=4, epochs=2, shuffle=True, verbose=0,
              callbacks=[Rec()], ckpt_dir=ckpt_dir, ckpt_freq=3,
              resume="auto" if mode == "resume" else None)
    except TrainingPreempted as e:
        status = "preempted:%d" % e.step
    np.savez(out_path + ".npz", **{k: v.numpy() for k, v in
                                   m.network.state_dict().items()})
    with open(out_path, "w") as f:
        json.dump({"status": status, "losses": losses}, f)
""")


def test_real_sigterm_kill_and_resume_bitwise(tmp_path):
    """Three processes: clean; killed by a real SIGTERM at a chosen step
    (the step drains, a checkpoint commits, TrainingPreempted); resumed.
    Stitched losses and final parameters equal the clean run's."""
    script = tmp_path / "worker.py"
    script.write_text(_KILL_WORKER.replace("__REPO__", repr(REPO)))
    kill_step = int(np.random.default_rng(5).integers(3, 7))

    def start(mode, tag):
        ck = tmp_path / f"ck_{'a' if tag == 'a' else 'b'}"
        return subprocess.Popen(
            [sys.executable, str(script), mode, str(ck),
             str(tmp_path / f"out_{tag}"), str(kill_step)], cwd=REPO,
            env=dict(os.environ, OMP_NUM_THREADS="1"))

    def result(proc, tag):
        assert proc.wait(timeout=240) == 0, tag
        out = tmp_path / f"out_{tag}"
        with open(out) as f:
            return json.load(f), np.load(str(out) + ".npz")

    runs = [start("clean", "a"), start("kill", "b")]  # at once
    clean, p_clean = result(runs[0], "a")
    killed, _ = result(runs[1], "b")
    assert killed["status"] == f"preempted:{kill_step}"
    assert killed["losses"] == clean["losses"][:kill_step]
    resumed, p_res = result(start("resume", "c"), "c")
    assert resumed["status"] == "done"
    assert killed["losses"] + resumed["losses"] == clean["losses"]
    assert sorted(p_clean.files) == sorted(p_res.files)
    for k in p_clean.files:
        np.testing.assert_array_equal(p_clean[k], p_res[k], err_msg=k)


def test_new_modules_import_without_jax_or_the_reference():
    """A fresh interpreter imports every module this slice added, and
    ``chip_smoke.py``, and finds neither jax nor paddle_tpu loaded."""
    mods = ["paddle_tpu_torch", "paddle_tpu_torch.nn.functional.conv",
            "paddle_tpu_torch.nn.functional.pooling",
            "paddle_tpu_torch.nn.functional.norm", "paddle_tpu_torch.nn.conv",
            "paddle_tpu_torch.nn.pooling", "paddle_tpu_torch.nn.norm",
            "paddle_tpu_torch.nn.activation", "paddle_tpu_torch.nn.layer",
            "paddle_tpu_torch.nn.loss", "paddle_tpu_torch.vision.models",
            "paddle_tpu_torch.convert", "paddle_tpu_torch.io",
            "paddle_tpu_torch.metric", "paddle_tpu_torch.framework.random",
            "paddle_tpu_torch.serialization",
            "paddle_tpu_torch.distributed.checkpoint",
            "paddle_tpu_torch.distributed.ckpt_manager",
            "paddle_tpu_torch.hapi", "paddle_tpu_torch.hapi.model",
            "chip_smoke"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "clean"


# ------------------------------------------- saved by two processes
def _zero1_run(rank, sub):
    """A ZeRO-1 (``os``) MLP on this rank after two AdamW steps on its
    half of the batch."""
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.nn import functional as F

    torch.manual_seed(0)  # the same start on both ranks
    model = nn.Sequential(nn.Linear(6, 8, device="cpu"), nn.ReLU(),
                          nn.Linear(8, 3, device="cpu"))
    opt = popt.AdamW(learning_rate=0.01, parameters=model.named_parameters())
    wrapped, opt, _ = group_sharded_parallel(model, opt, "os", group=sub)
    r = np.random.default_rng(3)
    for _ in range(2):
        x = torch.from_numpy(r.standard_normal((4, 6)).astype(np.float32))
        y = torch.from_numpy(r.integers(0, 3, (4,)))
        F.cross_entropy(wrapped(x[2 * rank:2 * rank + 2]),
                        y[2 * rank:2 * rank + 2]).backward()
        opt.step()
        opt.clear_grad()
    return model, opt


def _ckpt_worker(rank, world, init_file, out_dir):
    import _torch_world as W

    from paddle_tpu_torch.distributed import get_group

    W.init_world(rank, world, init_file)
    group = get_group()
    model, opt = _zero1_run(rank, group)
    sd = {f"model.{k}": v for k, v in model.state_dict().items()}
    sd.update({f"opt.{k}": v for k, v in opt.sharded_state_dict().items()})
    path = os.path.join(out_dir, "step-2")
    save_state_dict(sd, path, group=group)
    own = {k: v.clone() for k, v in opt.state_dict().items()
           if isinstance(v, torch.Tensor)}
    # loaded back in two processes: a fresh run takes the whole state and
    # keeps its own slices
    loaded = load_state_dict(path)
    model2, opt2 = _zero1_run(rank, group)
    model2.load_state_dict({k[6:]: v for k, v in loaded.items()
                            if k.startswith("model.")})
    opt2.set_state_dict({k[4:]: v for k, v in loaded.items()
                         if k.startswith("opt.")})
    back = opt2.state_dict()
    res = dict(
        gathered={k: v.numpy().copy() for k, v in
                  opt.gathered_state_dict().items()
                  if isinstance(v, torch.Tensor)},
        step=opt.state_dict()["step"],
        params={k: v.detach().numpy().copy()
                for k, v in model.state_dict().items()},
        reloaded=all(torch.equal(own[k], back[k]) for k in own),
        slice_shapes={k: tuple(v.shape) for k, v in own.items()})
    # a save that one member fails before its marker is refused on both
    bad = os.path.join(out_dir, "step-3")
    plan = FaultPlan("ckpt-io-error:at=1") if rank == 1 else None
    try:
        save_state_dict(sd, bad, group=group, fault_plan=plan)
        res["bad"] = "committed"
    except (OSError, RuntimeError) as e:
        res["bad"] = type(e).__name__
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()


@pytest.fixture(scope="module")
def zero1_ckpt(tmp_path_factory):
    import _torch_world as W

    tmp = tmp_path_factory.mktemp("ckpt_world")
    return tmp, W.run_world(_ckpt_worker, 2, tmp)


def test_two_process_zero1_save_loads_whole_in_one_process(zero1_ckpt):
    """Each rank wrote its slices of the optimizer state and its own
    marker (rank 0 the replicated parameters); one process loads the
    gathered state and the parameters bitwise."""
    tmp, ranks = zero1_ckpt
    path = os.path.join(tmp, "step-2")
    metas = [json.load(open(os.path.join(path, f"metadata.p{i}.json")))
             for i in range(2)]
    assert [(m["process_index"], m["process_count"]) for m in metas] == [
        (0, 2), (1, 2)]
    assert not any(k.startswith("model.") for k in metas[1]["tensors"])
    assert ckpt.is_complete(path) and ckpt.verify_contents(path) > 2
    assert not os.path.exists(os.path.join(path, "COMMIT.claim"))
    got = load_state_dict(path)
    assert got["opt.step"] == ranks[0]["step"] == 2
    for k, want in ranks[0]["gathered"].items():
        assert np.array_equal(got[f"opt.{k}"].numpy(), want), k
        assert np.array_equal(ranks[1]["gathered"][k], want), k
    for k, want in ranks[0]["params"].items():
        assert np.array_equal(got[f"model.{k}"].numpy(), want), k
    # the slices really are halves: [6, 8] -> [3, 8], [3] stays whole
    shapes = ranks[0]["slice_shapes"]
    assert shapes["0.weight.moment1"] == (3, 8)
    assert shapes["2.bias.moment1"] == (3,)


def test_two_process_zero1_save_loads_in_two_processes(zero1_ckpt):
    _, ranks = zero1_ckpt
    assert all(r["reloaded"] for r in ranks)


def test_a_missing_marker_is_refused_as_incomplete(zero1_ckpt):
    tmp, ranks = zero1_ckpt
    assert ranks[0]["bad"] == "RuntimeError"  # the commit never came
    assert ranks[1]["bad"] == "OSError"       # the injected write error
    assert not os.path.exists(os.path.join(tmp, "step-3"))
    stage = os.path.join(tmp, ckpt.STAGE_PREFIX + "shared-step-3")
    assert os.path.exists(os.path.join(stage, "metadata.p0.json"))
    assert not ckpt.is_complete(stage)
    with pytest.raises(FileNotFoundError, match="incomplete"):
        load_state_dict(stage)
    assert ckpt.list_steps(str(tmp)) == [2]
