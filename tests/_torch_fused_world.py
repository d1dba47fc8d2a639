"""The rank side of the fused layers' tensor-parallel tests
(``test_torch_fused_transformer.py``): each of two gloo ranks builds the
port's fused layers at ``nranks=2`` from the full weights the test wrote
(``convert`` keeps the rank's shard) and runs them on the test's inputs;
it saves its outputs and its shards. Imports no JAX, so the spawned ranks
start quickly."""
import os

import numpy as np
import torch

import _torch_world as W

EMB, NH, FF, LAYERS = 32, 4, 64, 2
HD = EMB // NH
B, S0, SMAX, PS = 2, 6, 16, 8
KINDS = ["5d", "slab", "paged_kv", "paged_state"]


def x_of(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def port_caches(kind, nh=NH):
    """One cache a layer of ``kind`` holding ``nh`` heads."""
    from paddle_tpu_torch.ops.cuda.decode_attention import make_kv_slab
    from paddle_tpu_torch.ops.cuda.paged_attention import (PagedCacheState,
                                                           PagedKVCache)

    if kind == "5d":
        return [torch.zeros((2, B, nh, SMAX, HD)) for _ in range(LAYERS)]
    if kind == "slab":
        return [make_kv_slab(B, SMAX, nh, HD, device="cpu")
                for _ in range(LAYERS)]
    if kind == "paged_kv":
        return [PagedKVCache(num_pages=16, page_size=PS, batch_size=B,
                             num_kv_heads=nh, head_dim=HD,
                             max_pages_per_seq=SMAX // PS,
                             dtype=torch.float32, device="cpu")
                for _ in range(LAYERS)]
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    return [PagedCacheState(torch.zeros((8, PS, nh * HD)),
                            torch.zeros((8, PS, nh * HD)), None, tables,
                            torch.zeros((B,), dtype=torch.int32), PS)
            for _ in range(LAYERS)]


def generate(m, caches, x, tok, steps):
    """Context phase on ``x``, then ``steps`` decode steps each fed the
    previous output: the outputs in order (numpy)."""
    with torch.no_grad():
        y, caches = m(torch.from_numpy(x), caches=caches)
        outs = [y.numpy()]
        t_in = torch.from_numpy(tok)
        for t in range(S0, S0 + steps):
            t_in, caches = m(t_in, caches=caches, time_step=t)
            outs.append(t_in.numpy())
    return outs


def worker(rank, world, init_file, out_dir, arrays_file):
    import paddle_tpu_torch.incubate.nn.functional as IF
    from paddle_tpu_torch.convert import (fused_multi_transformer_from_numpy,
                                          shard_state_dict,
                                          state_dict_from_numpy)
    from paddle_tpu_torch.incubate.nn import (FusedFeedForward,
                                              FusedMultiHeadAttention)
    from paddle_tpu_torch.incubate.nn.layer.fused_transformer import _LISTS

    W.init_world(rank, world, init_file)
    a = dict(np.load(arrays_file))
    lists = {name: [a[f"fmt.{name}.{i}"] for i in range(LAYERS)]
             for name in _LISTS}
    res = {}
    tm = fused_multi_transformer_from_numpy(lists, device="cpu", nranks=2)
    res["fmt_shards"] = {n: p.detach().numpy().copy()
                         for n, p in tm.named_parameters()}
    with torch.no_grad():
        res["fmt_none"] = [tm(torch.from_numpy(x_of(2, (2, 8, EMB))))
                           .numpy()]
    x, tok = x_of(4, (B, S0, EMB)), x_of(5, (B, 1, EMB))
    for kind in KINDS:
        res[f"fmt_{kind}"] = generate(tm, port_caches(kind, NH // 2), x,
                                      tok, 3)

    def sharded(cls, prefix, *args, **kw):
        m = cls(*args, nranks=2, device="cpu", **kw)
        full = state_dict_from_numpy(
            {k[len(prefix):]: v for k, v in a.items()
             if k.startswith(prefix)}, device="cpu")
        m.load_state_dict(shard_state_dict(full, model=m, mp=2,
                                           mp_rank=rank), strict=True)
        return m.eval()

    mha = sharded(FusedMultiHeadAttention, "mha.", EMB, NH,
                  normalize_before=True)
    ffn = sharded(FusedFeedForward, "ffn.", EMB, FF, activation="gelu",
                  normalize_before=True)
    xm = torch.from_numpy(x_of(11, (2, 5, EMB)))
    with torch.no_grad():
        res["mha"] = [mha(xm).numpy()]
        res["ffn"] = [ffn(xm).numpy()]
        res["mha_op"] = [IF.fused_multi_head_attention(
            xm, mha.qkv_weight, mha.linear_weight, pre_layer_norm=True,
            pre_ln_scale=mha.pre_ln_scale, pre_ln_bias=mha.pre_ln_bias,
            qkv_bias=mha.qkv_bias, linear_bias=mha.linear_bias,
            dropout_rate=0.0, attn_dropout_rate=0.0, training=False,
            ring_id=0).numpy()]
        res["ffn_op"] = [IF.fused_feedforward(
            xm, ffn.linear1_weight, ffn.linear2_weight,
            linear1_bias=ffn.linear1_bias, linear2_bias=ffn.linear2_bias,
            ln1_scale=ffn.ln1_scale, ln1_bias=ffn.ln1_bias,
            dropout1_rate=0.0, dropout2_rate=0.0, activation="gelu",
            pre_layer_norm=True, training=False, ring_id=0).numpy()]
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()
