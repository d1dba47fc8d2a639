"""The port's serving benches (``paddle_tpu_torch.serving.loadgen``'s
``bench_slo_serving``, ``bench_trace_serving``, ``bench_failover_serving``
and ``bench_cluster_serving``) on the CPU at a tiny GPT: each returns the
reference's key set, read from ``paddle_tpu/serving/loadgen.py``'s own
source (the dict literals each bench returns or merges into its result),
and holds its correctness parts: no request fails, the failover bench
migrates the killed replica's streams, the cluster bench hands KV off.
Their times and rates are CPU numbers and are not checked here.
"""
import ast
import inspect

import pytest

import paddle_tpu.serving.loadgen as jax_loadgen

from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch.serving import loadgen
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)


def _reference_keys(name):
    """The keys of every dict literal that the reference's ``name`` returns,
    assigns to ``out`` or merges with ``out.update``, in its own body (not
    in the helpers nested inside it)."""
    fn = ast.parse(inspect.getsource(getattr(jax_loadgen, name))).body[0]
    keys = set()

    def visit(stmts):
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.ClassDef)):
                continue
            value = None
            if isinstance(st, ast.Return):
                value = st.value
            elif isinstance(st, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "out"
                    for t in st.targets):
                value = st.value
            elif isinstance(st, ast.Expr) and isinstance(st.value, ast.Call) \
                    and isinstance(st.value.func, ast.Attribute) \
                    and st.value.func.attr == "update":
                value = st.value.args[0]
            if isinstance(value, ast.Dict):
                keys.update(k.value for k in value.keys)
            for field in ("body", "orelse", "finalbody"):
                visit(getattr(st, field, []) or [])

    visit(fn.body)
    return keys


@pytest.fixture(scope="module")
def cfg():
    return GPTConfig(hidden_size=64, num_layers=2, num_heads=2,
                     max_position=128, vocab_size=97)


@pytest.mark.parametrize("name", ["bench_slo_serving", "bench_trace_serving",
                                  "bench_failover_serving",
                                  "bench_cluster_serving"])
def test_bench_returns_reference_keys(cfg, name):
    want = _reference_keys(name)
    assert len(want) >= 6, want
    out = getattr(loadgen, name)(cfg, False)
    assert set(out) == want
    if name == "bench_failover_serving":
        assert out["failover_zero_failures"]
        assert out["failover_completed"] == 3 * out[
            "failover_requests_per_run"]
        assert out["failover_migrated_streams"] >= 1
    elif name == "bench_cluster_serving":
        assert out["cluster_zero_failures"]
        assert out["cluster_handoffs"] + out["cluster_fallbacks"] >= 1
    elif name == "bench_trace_serving":
        assert out["trace_bench_spans"] > 0
    else:
        assert out["multistep_max_steps_per_roundtrip"] >= 2
