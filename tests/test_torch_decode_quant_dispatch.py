"""The rules that pick the body of the weight-only quant matmul (#12) and
the split of the decode kernels (#1, #4, #14, #15), and the arithmetic of
both new bodies, on the CPU.

``quant_body`` sends bf16 x at up to ``PALLAS_MAX_ROWS`` rows to the
tensor-core body and f32 x to the FMA body; ``split_plan`` cuts K into
whole stages of the body it serves. ``decode_splits`` cuts each
sequence's live window into chunks from host-known values only (the call
never reads ``lengths``), and ``decode_chunk`` is how each block cuts its
own chunk from the length on the card. These are pure shape rules, so they
run here.

``quant_matmul_tc_ref`` is the plain twin of the tensor-core body's
arithmetic (bf16 x, exact weights, f32 split partials summed in split
order, then scale, bias and the cast), held against the JAX
``quant_matmul_ref`` within one bf16 ulp of the output's largest entry
(both round f32 sums of the same exact products, in another order).
``decode_chunked_ref`` is the plain twin of the split decode (the chunks
as the card cuts them, each chunk's softmax, then the ordered log-space
merge), held on the three layouts against the JAX decode functions (the
slab pages' ``paged_slab_decode_attention``, which takes its plain branch
on the CPU; ``paged_decode_attention`` and ``decode_attention_pallas`` in
interpret mode) within 2e-5, the reference's own kernel-vs-twin bound.
"""
import functools
import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.quant_matmul import (quant_matmul_ref as
                                                jax_quant_matmul_ref)

from paddle_tpu_torch.ops.cuda import paged_attention as pa
from paddle_tpu_torch.ops.cuda import quant_matmul as qm
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)

# the modules, not the functions paddle_tpu.ops.pallas re-exports by the
# same names
JD = importlib.import_module("paddle_tpu.ops.pallas.decode_attention")
JP = importlib.import_module("paddle_tpu.ops.pallas.paged_attention")

SMS = 132  # the H100's SM count


# ------------------------------------------------------------ the rules
@pytest.mark.parametrize("dtype,rows,body", [
    (torch.bfloat16, 1, "tensor_core"),
    (torch.bfloat16, 8, "tensor_core"),      # a decode step
    (torch.bfloat16, 40, "tensor_core"),     # a spec-verify step
    (torch.bfloat16, 256, "tensor_core"),    # the routing limit
    (torch.bfloat16, 257, "fma"),
    (torch.float32, 8, "fma"),
    (torch.float32, 256, "fma"),
])
def test_quant_body_rule(dtype, rows, body):
    assert qm.quant_body(dtype, rows) == body


@pytest.mark.parametrize("rows", [1, 8, 40, 65, 256])
@pytest.mark.parametrize("k", [2, 130, 1030, 4096, 11008])
@pytest.mark.parametrize("n", [1, 129, 4096, 32000])
@pytest.mark.parametrize("int4", [False, True])
def test_tc_split_plan_cuts_whole_stages(rows, k, n, int4):
    """The tensor-core body's K splits are whole stages (64 k of int8, 128
    of int4), cover K with none past it, and stay within the grid's
    limit."""
    splits, kps = qm.split_plan(rows, k, n, int4, "tensor_core")
    assert kps % (128 if int4 else 64) == 0
    assert 1 <= splits <= 65535
    assert (splits - 1) * kps < k <= splits * kps


@pytest.mark.parametrize("rows", [8, 40])
@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 11008), (11008, 4096)])
@pytest.mark.parametrize("int4", [False, True])
def test_tc_split_plan_keeps_one_wave(rows, k, n, int4):
    """At the llama2_7b decode and spec-verify GEMMs the grid fits in one
    wave of the blocks the card holds at once and fills at least 75% of
    it, and a split is at least 256 deep."""
    splits, kps = qm.split_plan(rows, k, n, int4, "tensor_core")
    wave = qm.tc_blocks_per_sm(rows, int4) * SMS
    blocks = splits * -(-n // 128)
    assert 0.75 * wave <= blocks <= wave
    assert kps >= 256


def test_tc_blocks_per_sm_follow_the_tile():
    """More rows of x a block (more n8 tiles, registers and shared
    memory) never let an SM hold more blocks; int4's wider stages never
    more than int8's."""
    for int4 in (False, True):
        held = [qm.tc_blocks_per_sm(r, int4) for r in range(1, 65)]
        assert held == sorted(held, reverse=True)
        assert 2 <= held[-1] and held[0] <= 5
    assert all(qm.tc_blocks_per_sm(r, True) <= qm.tc_blocks_per_sm(r, False)
               for r in range(1, 65))


@pytest.mark.parametrize("B,H_,Hkv,cap,want", [
    (8, 32, 32, 4096, "split"),     # llama2_7b serving, 4096 positions
    (8, 32, 8, 4096, "split"),      # Mixtral GQA 32/8: 64 blocks
    (8, 32, 8, 1152, "split"),
    (1, 32, 32, 4096, "split"),
    (8, 32, 32, 1152, 1),           # every SM has a block, short windows
    (8, 32, 32, 2047, 1),
    (8, 12, 12, 640, 1),            # GPT-2 small generate: 96 blocks
    (1, 32, 32, 100, 1),            # too short to split
    (64, 32, 32, 4096, 1),          # a wide batch fills the card
    (256, 32, 8, 4096, 1),
    (8, 32, 32, 16, 1),             # one tile of capacity
])
def test_decode_splits_rule(B, H_, Hkv, cap, want):
    s = pa.decode_splits(B, H_, Hkv, cap, SMS)
    if want == "split":
        assert 1 < s <= 16
    else:
        assert s == want


def test_decode_splits_is_host_only():
    """The rule takes no tensor: nothing of lengths (a card tensor on the
    engine's path) is read to choose the chunks."""
    params = inspect.signature(pa.decode_splits).parameters
    assert list(params) == ["batch", "num_heads", "num_kv_heads",
                            "capacity", "sm_count"]
    assert pa.decode_splits(8, 32, 32, 4096, SMS) == pa.decode_splits(
        8, 32, 32, 4096, SMS)


@pytest.mark.parametrize("cap", [16, 17, 64, 100, 640, 1152, 4096, 32768])
@pytest.mark.parametrize("B,H_,Hkv", [(1, 32, 32), (8, 32, 32), (8, 32, 8),
                                      (8, 12, 12), (3, 8, 1)])
def test_decode_chunks_cover_each_window(cap, B, H_, Hkv):
    """With the rule's count, the chunks each block cuts from its row's
    length tile ``[0, length)`` in order, whole 16-row tiles but the last;
    the chunks past the last row hold none; at the capacity every chunk
    holds rows (none lies wholly past the window)."""
    s = pa.decode_splits(B, H_, Hkv, cap, SMS)
    floor = pa.decode_min_chunk(B, H_, Hkv, SMS)
    assert 1 <= s <= max(1, cap // 512)
    for n in sorted({0, 1, 15, 16, 17, 511, 512, 513, cap // 3, cap - 1,
                     cap}):
        chunk = pa.decode_chunk(n, s, floor)
        assert chunk % 16 == 0 and chunk >= floor
        covered, held = 0, []
        for sp in range(s):
            lo, hi = min(n, sp * chunk), min(n, sp * chunk + chunk)
            assert lo == covered
            covered = hi
            held.append(hi > lo)
        assert covered == n
        assert held == sorted(held, reverse=True)  # empty ones come last
        if n == cap:
            assert all(held)


@pytest.mark.parametrize("B,H_,Hkv,floor", [
    (8, 32, 8, 16),         # 64 blocks: every chunk fills an idle SM
    (8, 12, 12, 16),        # 96 blocks
    (8, 32, 32, 512),       # 256 blocks: only long windows are cut
    (64, 32, 8, 512),
])
def test_decode_min_chunk_rule(B, H_, Hkv, floor):
    """The chunk floor: one tile while the grid leaves SMs idle, 512 rows
    once every SM has a block; host-known values only."""
    assert pa.decode_min_chunk(B, H_, Hkv, SMS) == floor
    params = inspect.signature(pa.decode_min_chunk).parameters
    assert list(params) == ["batch", "num_heads", "num_kv_heads",
                            "sm_count"]
    # a window the floor holds is one chunk whatever the split count
    assert pa.decode_chunk(floor, 16, floor) == floor


def test_quant_cpu_path_ignores_the_rule():
    """On the CPU the wrapper takes the plain twin whatever the body rule
    says, and counts no launch."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((8, 64), generator=g).bfloat16()
    wq = torch.randint(-127, 128, (64, 24), generator=g, dtype=torch.int8)
    sc = torch.rand(24, generator=g) * 0.01
    before = (qm.quant_matmul.launches, qm.quant_matmul.tc_launches)
    got = qm.quant_matmul(x, wq, sc)
    assert (qm.quant_matmul.launches, qm.quant_matmul.tc_launches) == before
    assert torch.equal(got, qm.quant_matmul_ref(x, wq, sc))


# ------------------------------------------------- the #12 arithmetic
def _bf16_exact(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _ulp_close(got, want):
    """Within one bf16 ulp of want's largest entry."""
    top = float(np.abs(want).max())
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    np.testing.assert_allclose(got, want, atol=ulp, rtol=0)


@pytest.mark.parametrize("rows", [1, 8, 40, 256])
@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("k,n", [(1030, 129), (512, 300)])
@pytest.mark.parametrize("splits", [None, 3])
def test_quant_tc_twin_matches_jax_ref(rows, int4, k, n, splits):
    """The tensor-core body's arithmetic against the JAX reference on the
    same bf16 x, packed weights, scales and bias: K = 1030 is no multiple
    of a split (nor of a stage), N = 129 and 300 no multiple of the
    128-column tile; the rule's split count and a forced 3."""
    rng = np.random.default_rng(rows + 7 * k + int(int4))
    x = _bf16_exact(rng.standard_normal((rows, k))).copy()
    wq = rng.integers(-128, 128, (k // 2 if int4 else k, n)).astype(np.int8)
    sc = (rng.random(n) * 0.004 + 0.001).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    wd = "int4" if int4 else "int8"
    want = np.asarray(jax_quant_matmul_ref(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(wq), jnp.asarray(sc),
        jnp.asarray(bias), weight_dtype=wd).astype(jnp.float32))
    got = qm.quant_matmul_tc_ref(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(wq),
        torch.from_numpy(sc), torch.from_numpy(bias), weight_dtype=wd,
        splits=splits)
    assert got.dtype == torch.bfloat16 and got.shape == (rows, n)
    _ulp_close(got.float().numpy(), want)


# ------------------------------------------------- the decode arithmetic
B, H, HKV, D, PS, MAXP = 6, 4, 2, 32, 8, 8
CAP = PS * MAXP
# idle, one row, tile edges, mid-window, the capacity
LENS = np.array([0, 1, 16, 17, 40, CAP], np.int32)


def _rng_case(kind):
    rng = np.random.default_rng(len(kind))
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    return rng, q


def _tables(rng, p_total):
    return rng.permutation(np.arange(1, p_total, dtype=np.int32))[
        :B * MAXP].reshape(B, MAXP)


@functools.lru_cache(maxsize=None)
def _slab_case(kind):
    """Slab pages [P, PS, Hkv*D] (int8 with bf16 scale pages), the JAX
    output, and the windows gathered for the twin."""
    rng, q = _rng_case("slab" + kind)
    p_total = 1 + B * MAXP
    shape = (p_total, PS, HKV * D)
    sc = None
    if kind == "int8":
        kp = rng.integers(-127, 128, shape).astype(np.int8)
        vp = rng.integers(-127, 128, shape).astype(np.int8)
        sc = np.zeros((p_total, PS, 128), np.float32)
        sc[..., :2 * HKV] = _bf16_exact(
            rng.random((p_total, PS, 2 * HKV)) * 0.02 + 0.01)
    else:
        kp = rng.standard_normal(shape).astype(np.float32)
        vp = rng.standard_normal(shape).astype(np.float32)
    tables = _tables(rng, p_total)
    want = np.asarray(JP.paged_slab_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(LENS), H,
        scale_pages=None if sc is None else jnp.asarray(sc, jnp.bfloat16)))

    def window(pages, lanes):
        w = pages[tables].astype(np.float32).reshape(B, CAP, HKV, D)
        if sc is not None:
            w = w * sc[tables].reshape(B, CAP, 128)[..., lanes][..., None]
        return w.transpose(0, 2, 1, 3)  # [B, Hkv, CAP, D]

    return q, window(kp, slice(0, HKV)), window(vp, slice(HKV, 2 * HKV)), \
        want


@functools.lru_cache(maxsize=None)
def _head_major_case(kind):
    """Head-major pages [Hkv, P, PS, D] (int8 with f32 per-row scales),
    the JAX Pallas kernel's output in interpret mode, and the windows."""
    rng, q = _rng_case("head" + kind)
    p_total = 1 + B * MAXP
    shape = (HKV, p_total, PS, D)
    ks = vs = None
    if kind == "int8":
        kp = rng.integers(-127, 128, shape).astype(np.int8)
        vp = rng.integers(-127, 128, shape).astype(np.int8)
        ks, vs = (rng.random(shape[:3]).astype(np.float32) * 0.02 + 0.01
                  for _ in range(2))
    else:
        kp = rng.standard_normal(shape).astype(np.float32)
        vp = rng.standard_normal(shape).astype(np.float32)
    tables = _tables(rng, p_total)
    want = np.asarray(JP.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(LENS), k_scales=None if ks is None else jnp.asarray(ks),
        v_scales=None if vs is None else jnp.asarray(vs)))

    def window(pages, scales):
        w = pages[:, tables].astype(np.float32)  # [Hkv, B, MAXP, PS, D]
        if scales is not None:
            w = w * scales[:, tables][..., None]
        return w.transpose(1, 0, 2, 3, 4).reshape(B, HKV, CAP, D)

    return q, window(kp, ks), window(vp, vs), want


@functools.lru_cache(maxsize=None)
def _contiguous_case(kind):
    """Contiguous caches [B, Hkv, S, D] and the JAX Pallas kernel's output
    in interpret mode."""
    rng, q = _rng_case("contig" + kind)
    k = rng.standard_normal((B, HKV, CAP, D)).astype(np.float32)
    v = rng.standard_normal((B, HKV, CAP, D)).astype(np.float32)
    want = np.asarray(JD.decode_attention_pallas(q, k, v, LENS))
    return q, k, v, want


CASES = {("slab_pages", "f32"): _slab_case,
         ("slab_pages", "int8"): _slab_case,
         ("head_major", "f32"): _head_major_case,
         ("head_major", "int8"): _head_major_case,
         ("contiguous", "f32"): _contiguous_case}


@pytest.mark.parametrize("layout,kind", list(CASES))
@pytest.mark.parametrize("splits", range(1, 9))
@pytest.mark.parametrize("min_chunk", [16, 32])
def test_decode_chunked_twin_matches_jax(layout, kind, splits, min_chunk):
    """The split decode's chunks and ordered merge against the JAX decode
    of each layout, f32 within 2e-5, at chunks of at least one tile and
    at least two (a floor that keeps the 17- and 16-row windows whole).
    Rows of length 0 give exact zeros (the port's rule; the JAX slab twin
    and the Pallas #14 give the mean of V there, ROADMAP queue C)."""
    q, k, v, want = CASES[(layout, kind)](kind)
    got = pa.decode_chunked_ref(
        torch.from_numpy(q), torch.from_numpy(np.ascontiguousarray(k)),
        torch.from_numpy(np.ascontiguousarray(v)), torch.from_numpy(LENS),
        splits, min_chunk=min_chunk)
    assert got.dtype == torch.float32 and got.shape == (B, H, D)
    live = LENS > 0
    np.testing.assert_allclose(got.numpy()[live], want[live], atol=2e-5,
                               rtol=2e-5)
    assert not bool(got[~torch.from_numpy(live)].any())
