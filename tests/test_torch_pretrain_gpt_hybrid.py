"""Config 4 on the port (``examples/pretrain_gpt_hybrid_torch.py``) against
the reference example (``examples/pretrain_gpt_hybrid.py``) at its tiny
mode: mp 2 x pp 2 x dp 2, hidden 64, 4 heads, 4 layers, vocab 128, global
batch 8 x 32 in 2 microbatches, AdamW(1e-4) with ClipGradByGlobalNorm(1.0)
through ``fleet``, on the same numpy weights and batches.

The port runs in ONE world of eight gloo processes
(``tests/_torch_world.py``): each rank ``build``s the example's stage
(``PipelineLayer`` of ``build_layers``, ``fleet.distributed_model`` /
``distributed_optimizer``) and trains five steps of ``train_batch``, then
saves ``--ckpt``'s checkpoint by every rank. The reference runs the same
``build_layers`` / ``ce_loss`` / ``train_batch`` on its 8-device CPU mesh.

- Every rank's five losses equal the reference's within 1e-5 relative
  (f32 sums in another order; ``test_torch_data_parallel``'s limit).
- The final parameters, assembled from the ranks' mp shards, against the
  reference's: each element within 2 lr a step, and the difference's norm
  within 1e-3 of the norm of what the five steps moved them (AdamW steps
  at rounding level; ``chip_smoke.py``'s dp rule). The dp replicas hold
  bitwise-equal parameters, and so do the two mp ranks' replicated ones.
- ``profiler.mfu``'s parameter count (summed over mp and pp) is the
  reference model's.
- The checkpoint that the eight ranks saved (each stage its own names,
  the mp shards as blocks) loads whole in this process, bitwise the
  assembled parameters; its commit claim is gone, and a copy that still
  holds one (the committing member died between the rename and the
  claim's removal) is complete and loads alike.
"""
import argparse
import os

import numpy as np
import pytest
import torch
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

import _torch_world as W

WORLD, STEPS = 8, 5
LOSS_RTOL = 1e-5
LR = 1e-4
PARAM_REL = 1e-3


def _example(name):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_ex_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _args(ckpt):
    return argparse.Namespace(real=False, steps=STEPS, ckpt=ckpt,
                              device="cpu", backend=None)


def _worker(rank, world, init_file, out_dir, arrays_file):
    W.init_world(rank, world, init_file)
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        sharded_state_dict

    ex = _example("pretrain_gpt_hybrid_torch")
    arrays = dict(np.load(arrays_file))
    rep = ex.train_in_world(_args(os.path.join(out_dir, "ckpt")), arrays,
                            log=lambda s: None)
    hcg = fleet.get_hybrid_communicate_group()
    shards = {}
    for n, v in sharded_state_dict(rep.pop("model")).items():
        if hasattr(v, "offset"):
            shards[n] = (v.data.detach().numpy().copy(), tuple(v.offset),
                         tuple(v.global_shape))
        else:
            shards[n] = (v.detach().numpy().copy(), None, None)
    rep.update(shards=shards, coords=dict(
        dp=hcg.get_data_parallel_rank(), pp=hcg.get_stage_id(),
        mp=hcg.get_model_parallel_rank()))
    torch.save(rep, os.path.join(out_dir, f"rank{rank}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()


def _jax_setup(arrays):
    import jax.numpy as jnp

    from paddle_tpu import nn, optimizer
    from paddle_tpu.distributed import fleet
    from paddle_tpu.distributed.fleet import DistributedStrategy
    from paddle_tpu.distributed.fleet.meta_parallel import PipelineLayer

    ex = _example("pretrain_gpt_hybrid")
    st = DistributedStrategy()
    st.hybrid_configs = {"mp_degree": 2, "pp_degree": 2,
                         "sharding_degree": 1}
    st.pipeline_configs = {"accumulate_steps": 2}
    st.recompute = False
    fleet.init(is_collective=True, strategy=st)
    model = PipelineLayer(ex.build_layers(64, 4, 4, 128), num_stages=2,
                          loss_fn=ex.ce_loss)
    if arrays is not None:
        for n, p in model.named_parameters():
            p._data = jnp.asarray(arrays[n])
    engine = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(optimizer.AdamW(
        learning_rate=LR, parameters=model.parameters(),
        grad_clip=nn.ClipGradByGlobalNorm(1.0)))
    return model, engine, opt


@pytest.fixture(scope="module", autouse=True)
def restore_jax_mesh():
    """``_jax_setup``'s ``fleet.init`` sets the JAX package's global mesh
    (dp 2 x pp 2 x mp 2); it is put back after the module, so no later
    test in this xdist worker runs its JAX model under an ``mp`` axis (the
    JAX GPT's ``loss`` would take the vocab-parallel cross entropy, whose
    bf16 compile aborted a worker: ROADMAP C5)."""
    from paddle_tpu.distributed import parallel as jparallel

    prev = jparallel._global_mesh
    yield
    jparallel.set_mesh(prev)


@pytest.fixture(scope="module")
def arrays():
    """Random f32 arrays for every parameter of the reference's tiny
    model (its global names), from a numpy seed."""
    model, _, _ = _jax_setup(None)
    r = np.random.default_rng(5)
    out = {}
    for n, p in model.named_parameters():
        shape = tuple(p.shape)
        if len(shape) > 1:
            v = 0.1 * r.standard_normal(shape)
        else:
            base = 1.0 if ".ln" in n and n.endswith("weight") else 0.0
            v = base + 0.05 * r.standard_normal(shape)
        out[n] = v.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def ranks(arrays, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hybrid_world")
    np.savez(tmp / "arrays.npz", **arrays)
    res = W.run_world(_worker, WORLD, tmp, str(tmp / "arrays.npz"))
    return res, tmp


@pytest.fixture(scope="module")
def ref(arrays):
    import jax

    import paddle_tpu as paddle

    ex = _example("pretrain_gpt_hybrid_torch")
    model, engine, opt = _jax_setup(arrays)
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(STEPS):
        ids, labels = ex.global_batch(rng, 128, 8, 32)
        loss = engine.train_batch([paddle.to_tensor(ids),
                                   paddle.to_tensor(labels)], opt)
        losses.append(float(jax.device_get(loss._data)))
    engine._sync_to_model()
    params = {n: np.asarray(p._data) for n, p in model.named_parameters()}
    return dict(losses=losses, params=params,
                n_params=sum(v.size for v in params.values()))


def _assembled(res):
    """The whole model's parameters from the dp-rank-0 ranks' shards."""
    full = {}
    for r in res:
        if r["coords"]["dp"] != 0:
            continue
        for n, (a, off, gshape) in r["shards"].items():
            if off is None:
                full[n] = a
                continue
            buf = full.setdefault(n, np.zeros(gshape, np.float32))
            buf[tuple(slice(o, o + s) for o, s in zip(off, a.shape))] = a
    return full


def test_losses_match_reference(ranks, ref):
    res, _ = ranks
    for r in res:
        np.testing.assert_allclose(r["losses"], ref["losses"],
                                   rtol=LOSS_RTOL)
    assert ref["losses"][-1] < ref["losses"][0]


def test_final_parameters_match_reference(ranks, ref, arrays):
    res, _ = ranks
    got = _assembled(res)
    assert sorted(got) == sorted(ref["params"])
    diff2 = moved2 = 0.0
    for n, want in ref["params"].items():
        d = np.abs(got[n].astype(np.float64) - want)
        assert d.max() <= 2 * LR * STEPS, f"{n}: {d.max():.3g}"
        diff2 += float((d ** 2).sum())
        moved2 += float(((want.astype(np.float64) - arrays[n]) ** 2).sum())
    assert (diff2 / moved2) ** 0.5 <= PARAM_REL


def test_replicas_equal_and_mfu_count(ranks, ref):
    res, _ = ranks
    by = {}
    for r in res:
        c = r["coords"]
        by[(c["dp"], c["pp"], c["mp"])] = r["shards"]
        assert r["n_params"] == ref["n_params"]
    for (dp, pp, mp), shards in by.items():
        other = by[(1 - dp, pp, mp)]  # the dp replica
        for n, (a, _, _) in shards.items():
            np.testing.assert_array_equal(a, other[n][0], err_msg=n)
        peer = by[(dp, pp, 1 - mp)]  # the mp peer: replicated ones equal
        for n, (a, off, _) in shards.items():
            if off is None:
                np.testing.assert_array_equal(a, peer[n][0], err_msg=n)


def test_checkpoint_loads_whole_bitwise(ranks):
    from paddle_tpu_torch.distributed import load_state_dict

    res, tmp = ranks
    got = load_state_dict(str(tmp / "ckpt"))
    want = _assembled(res)
    assert sorted(got) == sorted(want)
    for n, a in want.items():
        assert torch.equal(got[n], torch.from_numpy(a)), n


def test_checkpoint_with_a_leftover_claim_loads(ranks, tmp_path):
    import shutil

    from paddle_tpu_torch.distributed import checkpoint as ckpt

    res, tmp = ranks
    assert not (tmp / "ckpt" / ckpt._CLAIM).exists()
    stray = tmp_path / "ckpt"
    shutil.copytree(tmp / "ckpt", stray)
    (stray / ckpt._CLAIM).touch()
    assert ckpt.is_complete(str(stray))
    assert ckpt.verify_contents(str(stray)) == \
        ckpt.verify_contents(str(tmp / "ckpt"))
    got = ckpt.load_state_dict(str(stray))
    want = _assembled(res)
    assert sorted(got) == sorted(want)
    for n, a in want.items():
        assert torch.equal(got[n], torch.from_numpy(a)), n
