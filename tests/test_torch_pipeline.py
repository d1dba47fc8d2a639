"""Pipeline parallelism of the port (``fleet/meta_parallel/pp_layers.py``,
``pipeline_engine.py``, ``interleave_schedule.py``, ``pp_utils``) against
the JAX package's, on the same numpy weights and batches.

In process: the segmentation and the reference's refusals, a pipeline of
one stage trained against the reference's at pp = 1,
``pipeline_schedule_stats`` and ``build_interleaved_schedule`` equal to
the reference's over a grid of (pp, M, vpp), and the gloo branch of the
point-to-point collectives (host buffers) in a two-rank world.

In ONE world of four gloo processes at pp = 4 (``tests/_torch_world.py``),
each scenario is a ``fleet.distributed_model(PipelineLayer(...))`` trained
by ``train_batch`` for three steps of a global batch of 8 x 8 tokens in
four microbatches (the reference's ``tests/test_pipeline_parallel.py``,
``test_pipeline_1f1b.py``, ``test_pipeline_interleave.py`` and
``test_pipeline_stash.py`` name the cases), against the reference's
``PipelineParallel`` on its 8-device CPU mesh (pp = 4):

- 1F1B with recompute (the default) and without (the stash), GPipe, and
  the interleaved 1F1B at vpp = 2 (eight blocks), AdamW(1e-2);
- ``eval_batch``'s loss;
- a tied head (``SharedLayerDesc`` on the first and the last stage) under
  SGD with an active global-norm clip: the clip counts the tied weight
  once, and both copies step alike;
- ``freeze_buffers`` (BatchNorm blocks in eval mode): the buffers never
  move;
- the clip through the fleet wrapper (SGD, ``ClipGradByGlobalNorm(0.05)``);
- a planted fault: one microbatch's gradient left out (its loss value
  kept) must fail the parameter check.

Tolerances (f32): losses within 1e-5 relative (``test_torch_data_parallel``'s
``1e-5``: sums in another order). SGD parameters within 1e-5. AdamW
parameters, whose steps sit at rounding level where a gradient is near
zero (Adam divides each gradient by its own scale, so such an element
steps +-lr either way): each element within 2 lr a step, and the
difference's norm within 1e-3 of the norm of what the steps moved them
(``chip_smoke.py``'s dp rule).
"""
import os

import numpy as np
import pytest
import torch
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

import _torch_world as W

PP, M, STEPS = 4, 4, 3
H, VOCAB, SEQ, BATCH = 16, 37, 8, 8
LOSS_RTOL = 1e-5
SGD_ATOL = 1e-5
ADAM_LR = 1e-2
ADAM_REL = 1e-3

# name -> (model kind, pipeline_configs, vpp, optimizer)
SCENARIOS = {
    "1f1b": ("plain", {"schedule": "1F1B"}, 1, "adamw"),
    "stash": ("plain", {"schedule": "1F1B", "recompute": False}, 1, "adamw"),
    "gpipe": ("plain", {"schedule": "gpipe"}, 1, "adamw"),
    "interleave": ("deep", {"schedule": "1F1B"}, 2, "adamw"),
    "tied": ("tied", {"schedule": "1F1B"}, 1, "sgd_clip"),
    "freeze": ("bn", {"schedule": "1F1B"}, 1, "adamw"),
    "clip": ("plain", {"schedule": "1F1B"}, 1, "sgd_clip"),
    "fault": ("plain", {"schedule": "1F1B"}, 1, "adamw"),
}
SGD_LR, CLIP = 0.5, 0.05


# ---------------------------------------------------------------- port
def _port_classes():
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F

    class EmbedPipe(nn.Layer):
        def __init__(self):
            super().__init__()
            self.word = nn.Embedding(VOCAB, H)

        def forward(self, x):
            return self.word(x)

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.ln = nn.LayerNorm(H)
            self.fc1 = nn.Linear(H, 4 * H)
            self.fc2 = nn.Linear(4 * H, H)

        def forward(self, x):
            return x + self.fc2(F.gelu(self.fc1(self.ln(x))))

    class BNBlock(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(H, H)
            self.bn = nn.BatchNorm1D(H)

        def forward(self, x):
            b, s, h = x.shape
            y = self.bn(self.fc(x).reshape([b * s, h])).reshape([b, s, h])
            return x + y

    class HeadPipe(nn.Layer):
        def __init__(self):
            super().__init__()
            self.ln = nn.LayerNorm(H)
            self.proj = nn.Linear(H, VOCAB)

        def forward(self, x):
            return self.proj(self.ln(x))

    return EmbedPipe, Block, BNBlock, HeadPipe


def _port_ce(logits, labels):
    lg = logits.float()
    gold = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    return torch.logsumexp(lg, dim=-1) - gold


def _port_descs(kind):
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        LayerDesc, SharedLayerDesc)

    EmbedPipe, Block, BNBlock, HeadPipe = _port_classes()
    if kind == "tied":
        def head_fwd(master, x):
            return x @ master.word.weight.t()

        return [SharedLayerDesc("emb", EmbedPipe, shared_weight_attr="word"),
                *[LayerDesc(Block) for _ in range(4)],
                SharedLayerDesc("emb", EmbedPipe, forward_func=head_fwd,
                                shared_weight_attr="word")]
    block = BNBlock if kind == "bn" else Block
    n = 8 if kind == "deep" else 4
    return ([LayerDesc(EmbedPipe)] + [LayerDesc(block) for _ in range(n)]
            + [LayerDesc(HeadPipe)])


def _port_opt(kind, model):
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm

    if kind == "adamw":
        return optimizer.AdamW(learning_rate=ADAM_LR,
                               parameters=model.parameters())
    return optimizer.SGD(learning_rate=SGD_LR,
                         parameters=model.parameters(),
                         grad_clip=ClipGradByGlobalNorm(CLIP))


def _faulty_loss(M_):
    """The loss with one microbatch's gradient left out: every M_-th call
    from the second keeps its value and drops its gradient."""
    calls = {"n": 0}

    def loss(logits, labels):
        out = _port_ce(logits, labels)
        calls["n"] += 1
        if calls["n"] % M_ == 2:
            out = out.detach() + 0.0 * out
        return out

    return loss


def _scenario(name, arrays, batches):
    from paddle_tpu_torch.convert import pipeline_stage_from_numpy
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        PipelineLayer, PipelineParallel)

    kind, pcfg, vpp, opt_kind = SCENARIOS[name]
    st = fleet.fleet_state.strategy
    st.pipeline_configs = dict(pcfg, accumulate_steps=M)
    loss_fn = _faulty_loss(M) if name == "fault" else _port_ce
    model = PipelineLayer(_port_descs(kind), num_stages=PP, loss_fn=loss_fn,
                          num_virtual_pipeline_stages=vpp,
                          freeze_buffers=kind == "bn")
    pipeline_stage_from_numpy(model, arrays[kind])
    if kind == "bn":
        model.eval()
    engine = fleet.distributed_model(model)
    assert isinstance(engine, PipelineParallel)
    opt = fleet.distributed_optimizer(_port_opt(opt_kind, model))

    def snap():
        return {n: p.detach().numpy().copy()
                for n, p in model.named_parameters()}

    out = dict(loss=[], params=[], init=snap(),
               names=sorted(n for n, _ in model.named_parameters()))
    if kind == "bn":
        out["buffers0"] = {n: b.detach().numpy().copy()
                           for n, b in model.named_buffers()}
    for x, y in batches:
        loss = engine.train_batch([torch.from_numpy(x),
                                   torch.from_numpy(y)], opt)
        out["loss"].append(float(loss))
        out["params"].append(snap())
    if kind == "bn":
        out["buffers"] = {n: b.detach().numpy().copy()
                          for n, b in model.named_buffers()}
    if name == "1f1b":
        x, y = batches[0]
        out["eval"] = float(engine.eval_batch([torch.from_numpy(x),
                                               torch.from_numpy(y)]))
        out["stats"] = dict(engine.last_stats)
    if name == "tied":
        out["firstly"] = [bool(getattr(p, "is_firstly_shared", True))
                          for n, p in model.named_parameters()
                          if n.startswith("run_function.0.")]
    return out


def _worker(rank, world, init_file, out_dir, data_file):
    W.init_world(rank, world, init_file)
    from paddle_tpu_torch.distributed import fleet

    data = dict(np.load(data_file))
    arrays = {}
    for k, v in data.items():
        if k.startswith("w:"):
            _, kind, name = k.split(":", 2)
            arrays.setdefault(kind, {})[name] = v
    batches = [(data[f"x{i}"], data[f"y{i}"]) for i in range(STEPS)]
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"pp_degree": PP, "mp_degree": 1}
    fleet.init(is_collective=True, strategy=st, device="cpu")
    res = {name: _scenario(name, arrays, batches) for name in SCENARIOS}
    res["stage"] = fleet.get_hybrid_communicate_group().get_stage_id()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()


# ----------------------------------------------------------- reference
def _jax_classes():
    import jax
    import jax.numpy as jnp

    from paddle_tpu import nn
    from paddle_tpu.framework.tensor import Tensor

    class EmbedPipe(nn.Layer):
        def __init__(self):
            super().__init__()
            self.word = nn.Embedding(VOCAB, H)

        def forward(self, x):
            return self.word(x)

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.ln = nn.LayerNorm(H)
            self.fc1 = nn.Linear(H, 4 * H)
            self.fc2 = nn.Linear(4 * H, H)

        def forward(self, x):
            import paddle_tpu.nn.functional as F

            return x + self.fc2(F.gelu(self.fc1(self.ln(x))))

    class BNBlock(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(H, H)
            self.bn = nn.BatchNorm1D(H)

        def forward(self, x):
            b, s, h = x.shape
            y = self.bn(self.fc(x).reshape([b * s, h])).reshape([b, s, h])
            return x + y

    class HeadPipe(nn.Layer):
        def __init__(self):
            super().__init__()
            self.ln = nn.LayerNorm(H)
            self.proj = nn.Linear(H, VOCAB)

        def forward(self, x):
            return self.proj(self.ln(x))

    def ce(logits, labels):
        lg = logits._data if isinstance(logits, Tensor) else logits
        yy = labels._data if isinstance(labels, Tensor) else labels
        logz = jax.nn.logsumexp(lg, axis=-1)
        gold = jnp.take_along_axis(lg, yy[..., None], axis=-1)[..., 0]
        return Tensor._wrap(jnp.mean(logz - gold))

    return EmbedPipe, Block, BNBlock, HeadPipe, ce


def _jax_descs(kind):
    from paddle_tpu.distributed.fleet.meta_parallel import (LayerDesc,
                                                            SharedLayerDesc)
    from paddle_tpu.framework.tensor import Tensor

    EmbedPipe, Block, BNBlock, HeadPipe, _ = _jax_classes()
    if kind == "tied":
        def head_fwd(master, x):
            xd = x._data if isinstance(x, Tensor) else x
            return Tensor._wrap(xd @ master.word.weight._data.T)

        return [SharedLayerDesc("emb", EmbedPipe, shared_weight_attr="word"),
                *[LayerDesc(Block) for _ in range(4)],
                SharedLayerDesc("emb", EmbedPipe, forward_func=head_fwd,
                                shared_weight_attr="word")]
    block = BNBlock if kind == "bn" else Block
    n = 8 if kind == "deep" else 4
    return ([LayerDesc(EmbedPipe)] + [LayerDesc(block) for _ in range(n)]
            + [LayerDesc(HeadPipe)])


def _jax_model(kind, arrays, vpp=1, loss=True, pp=PP):
    import jax.numpy as jnp

    from paddle_tpu.distributed.fleet.meta_parallel import PipelineLayer

    ce = _jax_classes()[-1]
    model = PipelineLayer(layers=_jax_descs(kind), num_stages=pp,
                          loss_fn=ce if loss else None,
                          num_virtual_pipeline_stages=vpp,
                          freeze_buffers=kind == "bn")
    for n, p in model.named_parameters():
        p._data = jnp.asarray(arrays[n])
    return model


def _jax_fleet(pcfg, pp=PP):
    from paddle_tpu.distributed import fleet
    from paddle_tpu.distributed.fleet import DistributedStrategy

    st = DistributedStrategy()
    st.hybrid_configs = {"pp_degree": pp, "mp_degree": 1}
    st.pipeline_configs = dict(pcfg, accumulate_steps=M)
    fleet.init(is_collective=True, strategy=st)
    return fleet


def _jax_run(name, arrays, batches, pp=PP):
    import jax
    import jax.numpy as jnp

    import paddle_tpu as paddle
    from paddle_tpu import optimizer
    from paddle_tpu.nn.clip import ClipGradByGlobalNorm

    kind, pcfg, vpp, opt_kind = SCENARIOS[name]
    fleet = _jax_fleet(pcfg, pp)
    model = _jax_model(kind, arrays[kind], vpp, pp=pp)
    if kind == "bn":
        for n, b in model.named_buffers():
            b._data = jnp.asarray(arrays[kind][n])
        model.eval()
    engine = fleet.distributed_model(model)
    if opt_kind == "adamw":
        opt = optimizer.AdamW(learning_rate=ADAM_LR,
                              parameters=model.parameters())
    else:
        opt = optimizer.SGD(learning_rate=SGD_LR,
                            parameters=model.parameters(),
                            grad_clip=ClipGradByGlobalNorm(CLIP))
    opt = fleet.distributed_optimizer(opt)
    out = dict(loss=[], params=[],
               init={n: np.asarray(arrays[kind][n])
                     for n, _ in model.named_parameters()})
    for x, y in batches:
        loss = engine.train_batch([paddle.to_tensor(x), paddle.to_tensor(y)],
                                  opt)
        out["loss"].append(float(jax.device_get(loss._data)))
        engine._sync_to_model()
        out["params"].append({n: np.asarray(p._data)
                              for n, p in model.named_parameters()})
    return out


# ------------------------------------------------------------- fixtures
def _weights(kind):
    """Random f32 arrays for every parameter and buffer of the reference
    model ``kind`` (its global names), from a numpy seed."""
    from paddle_tpu.distributed.fleet.meta_parallel import PipelineLayer

    model = PipelineLayer(layers=_jax_descs(kind), num_stages=1)
    r = np.random.default_rng({"plain": 1, "deep": 2, "tied": 3,
                               "bn": 4}[kind])
    out = {}
    for n, p in model.named_parameters():
        shape = tuple(p.shape)
        if len(shape) > 1:
            v = 0.3 * r.standard_normal(shape)
        else:
            base = 1.0 if n.endswith("ln.weight") else 0.0
            v = base + 0.1 * r.standard_normal(shape)
        out[n] = v.astype(np.float32)
    for n, b in model.named_buffers():
        out[n] = r.uniform(0.5, 1.5, tuple(b.shape)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def arrays():
    return {k: _weights(k) for k in ("plain", "deep", "tied", "bn")}


@pytest.fixture(scope="module")
def batches():
    r = np.random.default_rng(7)
    return [(r.integers(0, VOCAB, (BATCH, SEQ)).astype(np.int32),
             r.integers(0, VOCAB, (BATCH, SEQ)).astype(np.int32))
            for _ in range(STEPS)]


@pytest.fixture(scope="module")
def ranks(arrays, batches, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp_world")
    data = {f"w:{kind}:{n}": v for kind, a in arrays.items()
            for n, v in a.items()}
    for i, (x, y) in enumerate(batches):
        data[f"x{i}"], data[f"y{i}"] = x, y
    np.savez(tmp / "data.npz", **data)
    return W.run_world(_worker, PP, tmp, str(tmp / "data.npz"))


@pytest.fixture(scope="module")
def ref(arrays, batches):
    return {name: _jax_run(name, arrays, batches)
            for name in SCENARIOS if name != "fault"}


def _merged(ranks, name, step):
    """The parameters after ``step`` over every stage (a tied weight's
    copies must agree)."""
    out = {}
    for r in ranks:
        for n, v in r[name]["params"][step].items():
            if n in out:
                np.testing.assert_array_equal(out[n], v, err_msg=n)
            out[n] = v
    return out


def _close(got, want, init, adam, steps, what):
    assert sorted(got) == sorted(want), what
    if not adam:
        for n in want:
            np.testing.assert_allclose(got[n], want[n], rtol=0,
                                       atol=SGD_ATOL, err_msg=f"{what} {n}")
        return
    diff2 = moved2 = 0.0
    for n in want:
        d = np.abs(got[n].astype(np.float64) - want[n])
        assert d.max() <= 2 * ADAM_LR * steps + 1e-6, \
            f"{what} {n}: an element {d.max():.3g} off"
        diff2 += float((d ** 2).sum())
        moved2 += float(((want[n].astype(np.float64) - init[n]) ** 2).sum())
    rel = (diff2 / moved2) ** 0.5
    assert rel <= ADAM_REL, f"{what}: difference {rel:.3g} of the movement"


def _check(ranks, ref, name):
    kind, _, _, opt_kind = SCENARIOS[name]
    want = ref[name]
    for r in ranks:
        np.testing.assert_allclose(r[name]["loss"], want["loss"],
                                   rtol=LOSS_RTOL, err_msg=name)
    for step in range(STEPS):
        _close(_merged(ranks, name, step), want["params"][step],
               want["init"], opt_kind == "adamw", step + 1,
               f"{name} step {step + 1}")


# ----------------------------------------------------------- in process
def test_segmentation_and_refusals():
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        LayerDesc, PipelineLayer)

    EmbedPipe, Block, BNBlock, HeadPipe = _port_classes()
    model = PipelineLayer(_port_descs("plain"), num_stages=4,
                          loss_fn=_port_ce, device="cpu")
    assert len(model.pre_layers) == 1
    assert len(model.body_layers) == 4
    assert len(model.post_layers) == 1
    assert model.layers_per_stage == 1
    assert "body[1:5]" in model.segment_describe()
    assert [model.chunk_range(d) for d in range(4)] == \
        [(0, 2), (2, 3), (3, 4), (4, 6)]
    assert model.stage_id is None  # no world: one process, every stage
    deep = PipelineLayer(_port_descs("deep"), num_stages=2,
                         num_virtual_pipeline_stages=2, device="cpu")
    assert deep.layers_per_chunk == 2
    assert [deep.get_stage_from_index(i) for i in range(10)] == \
        [0, 0, 0, 1, 1, 0, 0, 1, 1, 1]
    with pytest.raises(ValueError, match="not divisible"):
        PipelineLayer([LayerDesc(EmbedPipe), LayerDesc(Block),
                       LayerDesc(Block), LayerDesc(Block),
                       LayerDesc(HeadPipe)], num_stages=2, device="cpu")
    layered = PipelineLayer(_port_descs("plain"), num_stages=2,
                            seg_method="layer:Block", device="cpu")
    assert layered._body_range == (1, 5)


def test_shared_layer_in_body_and_buffers_refused():
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        LayerDesc, PipelineLayer, PipelineParallel, SharedLayerDesc)

    EmbedPipe, Block, BNBlock, HeadPipe = _port_classes()
    st = DistributedStrategy()
    st.pipeline_configs = {"accumulate_steps": 2}
    body_shared = PipelineLayer(
        [LayerDesc(EmbedPipe), SharedLayerDesc("b", Block),
         SharedLayerDesc("b", Block), LayerDesc(HeadPipe)],
        num_stages=1, device="cpu")
    with pytest.raises(NotImplementedError, match="SharedLayerDesc"):
        PipelineParallel(body_shared, None, st)
    bn = PipelineLayer(_port_descs("bn"), num_stages=1, device="cpu")
    with pytest.raises(NotImplementedError, match="freeze_buffers"):
        PipelineParallel(bn, None, st)
    no_loss = PipelineParallel(PipelineLayer(_port_descs("plain"),
                                             num_stages=1, device="cpu"),
                               None, st)
    x = torch.zeros((4, SEQ), dtype=torch.int64)
    with pytest.raises(ValueError, match="loss_fn"):
        no_loss.train_batch([x, x], None)
    st.pipeline_configs = {"schedule": "zigzag"}
    with pytest.raises(ValueError, match="schedule"):
        PipelineParallel(PipelineLayer(_port_descs("plain"), num_stages=1,
                                       device="cpu"), None, st)


def test_sequential_forward_matches_reference(arrays, batches):
    """The one-process model (every stage) against the reference's
    sequential forward on the same weights: logits within 1e-5."""
    from paddle_tpu_torch.convert import pipeline_stage_from_numpy
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        PipelineLayer

    import paddle_tpu as paddle

    x, _ = batches[0]
    port = PipelineLayer(_port_descs("plain"), num_stages=1, device="cpu")
    pipeline_stage_from_numpy(port, arrays["plain"])
    got = port(torch.from_numpy(x)).detach().numpy()
    jm = _jax_model("plain", arrays["plain"])
    want = np.asarray(jm(paddle.to_tensor(x))._data)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_one_stage_train_batch_matches_reference(arrays, batches):
    """A pipeline of one stage (no world: the stage passes activations and
    gradients to itself), three 1F1B steps of AdamW against the
    reference's ``PipelineParallel`` at pp = 1."""
    from paddle_tpu_torch.convert import pipeline_stage_from_numpy
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        PipelineLayer, PipelineParallel)

    st = DistributedStrategy()
    st.pipeline_configs = {"schedule": "1F1B", "accumulate_steps": M}
    model = PipelineLayer(_port_descs("plain"), num_stages=1,
                          loss_fn=_port_ce, device="cpu")
    pipeline_stage_from_numpy(model, arrays["plain"])
    engine = PipelineParallel(model, None, st)
    opt = _port_opt("adamw", model)
    got = dict(loss=[], params=[])
    for x, y in batches:
        got["loss"].append(float(engine.train_batch(
            [torch.from_numpy(x), torch.from_numpy(y)], opt)))
        got["params"].append({n: p.detach().numpy().copy()
                              for n, p in model.named_parameters()})
    want = _jax_run("1f1b", arrays, batches, pp=1)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    for step in range(STEPS):
        _close(got["params"][step], want["params"][step], want["init"],
               True, step + 1, f"one stage, step {step + 1}")


@pytest.mark.parametrize("pp,M_,vpp,schedule,recompute", [
    (2, 4, 1, "1f1b", True), (4, 8, 1, "1f1b", True),
    (4, 4, 1, "gpipe", True), (4, 4, 1, "1f1b", False),
    (2, 4, 2, "1f1b", True), (4, 8, 2, "1f1b", True),
    (2, 2, 3, "1f1b", True), (3, 6, 2, "1f1b", True)])
def test_schedule_stats_and_tables_equal_reference(pp, M_, vpp, schedule,
                                                   recompute):
    from paddle_tpu.distributed.fleet.meta_parallel import \
        interleave_schedule as jis
    from paddle_tpu.distributed.fleet.meta_parallel.pipeline_engine import \
        pipeline_schedule_stats as jstats

    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        interleave_schedule as tis
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        pipeline_schedule_stats

    assert pipeline_schedule_stats(pp, M_, vpp, schedule, recompute) == \
        jstats(pp, M_, vpp, schedule, recompute)
    if vpp > 1:
        got = tis.build_interleaved_schedule(pp, vpp, M_)
        want = jis.build_interleaved_schedule(pp, vpp, M_)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        for s in range(pp):
            assert tis._device_op_order(pp, vpp, M_, s) == \
                jis._device_op_order(pp, vpp, M_, s)


def _p2p_worker(rank, world, init_file, out_dir):
    """Both ranks exchange through the host-buffer branch (forced on CPU
    tensors): p2p_exchange, send / recv, and a p2p_batch with held sends
    whose two tagged messages are received in the other order, as the
    pipeline's channel tags activations and gradients."""
    W.init_world(rank, world, init_file)
    from paddle_tpu_torch.distributed import collective as C

    C._host_staged = lambda t, g: True
    peer = 1 - rank
    mine = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank
    got = torch.zeros(2, 3)[:, :3]
    C.p2p_exchange(mine, peer, got, peer)
    res = {"exchange": got.clone()}
    buf = torch.zeros(4, dtype=torch.int64)
    if rank == 0:
        C.send(torch.tensor([1, 2, 3, 4]), 1)
    else:
        C.recv(buf, 0)
    res["sendrecv"] = buf.clone()
    a, b = torch.zeros(3), torch.zeros(3)
    held = C.p2p_batch([(torch.full((3,), 1.0 + rank), peer, 1),
                        (torch.full((3,), 5.0 + rank), peer, 2)],
                       [(b, peer, 2), (a, peer, 1)], wait_sends=False)
    held.wait()
    res["batch"] = (a.clone(), b.clone())
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()


def test_gloo_host_buffer_branch(tmp_path):
    """``collective``'s gloo branch for CUDA tensors (send from a host
    copy, receive into a host buffer and copy back, sends held until
    waited), forced on CPU tensors in a two-rank gloo world; the card's
    ``pp`` phase runs the real branch."""
    res = W.run_world(_p2p_worker, 2, tmp_path)
    for r in range(2):
        peer = 1 - r
        want = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * peer
        assert torch.equal(res[r]["exchange"], want)
        a, b = res[r]["batch"]
        assert torch.equal(a, torch.full((3,), 1.0 + peer))
        assert torch.equal(b, torch.full((3,), 5.0 + peer))
    assert res[1]["sendrecv"].tolist() == [1, 2, 3, 4]


# ------------------------------------------------------------- the world
@pytest.mark.parametrize("name", ["1f1b", "stash", "gpipe", "interleave",
                                  "clip"])
def test_schedule_matches_reference(ranks, ref, name):
    _check(ranks, ref, name)
    assert [r["stage"] for r in ranks] == list(range(PP))


def test_each_rank_holds_its_stage_only(ranks):
    """Stage s holds the layers of its chunk(s) only, under their global
    names; the interleaved stage s holds chunks s and s + 4."""
    names = [{n.split(".")[1] for n in r["1f1b"]["names"]} for r in ranks]
    assert names == [{"0", "1"}, {"2"}, {"3"}, {"4", "5"}]
    deep = [{n.split(".")[1] for n in r["interleave"]["names"]}
            for r in ranks]
    assert deep == [{"0", "1", "5"}, {"2", "6"}, {"3", "7"},
                    {"4", "8", "9"}]


def test_eval_batch(ranks, batches):
    """``eval_batch`` after the three 1F1B steps against the reference's
    ``eval_batch`` of the same (the port's trained) parameters."""
    import jax

    import paddle_tpu as paddle

    fleet = _jax_fleet(SCENARIOS["1f1b"][1])
    model = _jax_model("plain", _merged(ranks, "1f1b", STEPS - 1))
    x, y = batches[0]
    loss = fleet.distributed_model(model).eval_batch(
        [paddle.to_tensor(x), paddle.to_tensor(y)])
    want = float(jax.device_get(loss._data))
    for r in ranks:
        np.testing.assert_allclose(r["1f1b"]["eval"], want, rtol=LOSS_RTOL)


def test_tied_head_counts_once(ranks, ref):
    """The tied embedding lives on stage 0 and as a copy on stage 3 under
    the same name; both step alike and match the reference, whose one
    parameter takes both uses' gradients and counts once in the clip."""
    _check(ranks, ref, "tied")
    assert ranks[0]["tied"]["firstly"] == [True]
    assert ranks[3]["tied"]["firstly"] == [False]
    assert "run_function.0.word.weight" in ranks[3]["tied"]["names"]
    for r in ranks[1:3]:
        assert "run_function.0.word.weight" not in r["tied"]["names"]


def test_freeze_buffers(ranks, ref):
    _check(ranks, ref, "freeze")
    for r in ranks:
        for n, b in r["freeze"]["buffers0"].items():
            np.testing.assert_array_equal(r["freeze"]["buffers"][n], b,
                                          err_msg=n)


def test_planted_fault_fails_the_parameter_check(ranks, ref):
    """One microbatch's gradient left out (its loss value kept): the
    losses still agree at step 1, and the parameter check fails."""
    for r in ranks:
        np.testing.assert_allclose(r["fault"]["loss"][0],
                                   ref["1f1b"]["loss"][0], rtol=LOSS_RTOL)
    with pytest.raises(AssertionError):
        _close(_merged(ranks, "fault", 0), ref["1f1b"]["params"][0],
               ref["1f1b"]["init"], True, 1, "fault step 1")


def test_point_to_point_stats(ranks):
    """Every stage sent and received through the channel: stage 0 and 3
    one way each, 1 and 2 both ways; a stage's count of calls is the same
    every step."""
    stats = [r["1f1b"]["stats"] for r in ranks]
    for s in stats:
        assert s["p2p_calls"] > 0 and s["p2p_bytes"] > 0
        assert s["microbatches"] == M
