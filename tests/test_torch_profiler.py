"""The port's profiler facade (``paddle_tpu_torch/profiler``) against the
JAX package's (``paddle_tpu/profiler``).

- ``make_scheduler``'s state of every step equals the reference's over a
  grid of windows (closed, ready, record, repeat, skip_first).
- ``mfu`` at an explicit peak equals the reference's for the same
  arguments (exactly: the same f64 arithmetic); without a peak it reads
  the card's name, so with no card it raises and asks for one.
- ``dot_flops_of`` of a torch callable equals the reference's
  ``dot_flops_of`` of its JAX twin for the same shapes, exactly: a matmul,
  a linear with bias, a batched einsum, three layers in a loop (the
  reference's ``lax.scan``: its body times the trip count), and a forward
  with its backward (the reference's ``jax.grad``); convolutions count
  nothing on either side.
- ``Profiler`` follows the scheduler: a window that records writes one
  Chrome trace through ``export_chrome_tracing``, host spans
  (``RecordEvent``) appear in it, and ``summary`` reports every step.
"""
import json
import os

import numpy as np
import pytest
import torch
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("closed,ready,record,repeat,skip", [
    (1, 1, 2, 0, 0), (0, 0, 3, 1, 0), (2, 1, 1, 2, 3), (1, 0, 1, 0, 2),
    (3, 2, 4, 1, 1)])
def test_scheduler_states_equal_reference(closed, ready, record, repeat,
                                          skip):
    from paddle_tpu import profiler as jp

    from paddle_tpu_torch import profiler as tp

    js = jp.make_scheduler(closed=closed, ready=ready, record=record,
                           repeat=repeat, skip_first=skip)
    ts = tp.make_scheduler(closed=closed, ready=ready, record=record,
                           repeat=repeat, skip_first=skip)
    for step in range(40):
        assert ts(step).name == js(step).name, step
        assert ts(step).value == js(step).value, step


def test_mfu_at_explicit_peak_equals_reference():
    from paddle_tpu import profiler as jp

    from paddle_tpu_torch import profiler as tp

    for n, tps, peak, fpt in ((1.22e9, 1500.0, 67e12, None),
                              (124e6, 5.5e4, 989e12, None),
                              (7e9, 900.0, 989e12, 5e10)):
        assert tp.mfu(int(n), tps, peak_flops_per_chip=peak,
                      flops_per_token=fpt) == \
            jp.mfu(int(n), tps, peak_flops_per_chip=peak,
                   flops_per_token=fpt)


def test_mfu_without_a_peak_needs_one_off_the_card(monkeypatch):
    from paddle_tpu_torch import profiler as tp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="peak_flops_per_chip"):
        tp.mfu(1000, 10.0)


def _cases():
    """(name, JAX function and args, torch function and args)."""
    import jax
    import jax.numpy as jnp

    r = np.random.default_rng(3)
    x = r.standard_normal((8, 16)).astype(np.float32)
    w = r.standard_normal((16, 32)).astype(np.float32)
    b = r.standard_normal((32,)).astype(np.float32)
    a = r.standard_normal((3, 4, 5)).astype(np.float32)
    c = r.standard_normal((3, 5, 6)).astype(np.float32)
    ws = r.standard_normal((3, 16, 16)).astype(np.float32)
    img = r.standard_normal((1, 3, 8, 8)).astype(np.float32)
    ker = r.standard_normal((4, 3, 3, 3)).astype(np.float32)
    T = torch.from_numpy

    def j_loop(x, ws):
        def body(h, w_):
            return jnp.tanh(h @ w_), None
        return jax.lax.scan(body, x, ws)[0]

    def t_loop(x, ws):
        h = x
        for i in range(ws.shape[0]):
            h = torch.tanh(h @ ws[i])
        return h

    def j_grad(x, w):
        return jax.grad(lambda x_, w_: jnp.sum(jnp.tanh(x_ @ w_)),
                        argnums=(0, 1))(x, w)

    def t_grad(x, w):
        x = x.clone().requires_grad_(True)
        w = w.clone().requires_grad_(True)
        torch.tanh(x @ w).sum().backward()
        return x.grad, w.grad

    return [
        ("matmul", (lambda x, w: x @ w, (x, w)),
         (lambda x, w: x @ w, (T(x), T(w)))),
        ("linear", (lambda x, w, b: x @ w + b, (x, w, b)),
         (lambda x, w, b: torch.nn.functional.linear(x, w.t(), b),
          (T(x), T(w), T(b)))),
        ("einsum", (lambda a, c: jnp.einsum("bij,bjk->bik", a, c), (a, c)),
         (lambda a, c: torch.einsum("bij,bjk->bik", a, c), (T(a), T(c)))),
        ("loop", (j_loop, (x[:, :16], ws)), (t_loop, (T(x[:, :16]), T(ws)))),
        ("grad", (j_grad, (x, w)), (t_grad, (T(x), T(w)))),
        ("conv", (lambda i, k: jax.lax.conv(i, k, (1, 1), "SAME"),
                  (img, ker)),
         (lambda i, k: torch.nn.functional.conv2d(i, k, padding=1),
          (T(img), T(ker)))),
    ]


def test_dot_flops_equal_reference():
    from paddle_tpu.profiler.flops import dot_flops_of as jflops

    from paddle_tpu_torch.profiler import count_torch_dot_flops, dot_flops_of

    for name, (jf, jargs), (tf, targs) in _cases():
        want = jflops(jf, *jargs)
        assert dot_flops_of(tf, *targs) == want, name
        if name == "conv":
            assert want == 0.0
        else:
            assert want > 0
    flops, rep = count_torch_dot_flops(lambda x: x @ x, torch.ones(4, 4))
    assert flops == 2 * 4 * 4 * 4 and rep["by_op"] == {"mm": 128}
    assert torch.equal(rep["result"], torch.full((4, 4), 4.0))


def test_profiler_windows_export_and_summary(tmp_path):
    from paddle_tpu_torch import profiler as tp

    prof = tp.Profiler(
        scheduler=tp.make_scheduler(closed=1, ready=1, record=2, repeat=1),
        on_trace_ready=tp.export_chrome_tracing(str(tmp_path), "w0"))
    states = []
    prof.start()
    for _ in range(6):
        states.append(prof._state.name)
        with tp.RecordEvent("pp_span"):
            torch.ones(8, 8) @ torch.ones(8, 8)
        prof.step()
    prof.stop()
    assert states == ["CLOSED", "READY", "RECORD", "RECORD_AND_RETURN",
                      "CLOSED", "CLOSED"]
    files = os.listdir(tmp_path)
    assert files == ["w0_1.json"]
    with open(tmp_path / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "pp_span" in names
    text = prof.summary()
    assert "steps: 7" in text and "trace exported to" in text
