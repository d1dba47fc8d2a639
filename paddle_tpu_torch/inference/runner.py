"""Model-runner of the serving engine, after
``paddle_tpu/inference/runner.py`` on its single-device path (tp=None).

The reference jits every engine program (``jax.jit(...,
donate_argnums)``) and caches one compiled program per shape bucket. Here
the runner builds and caches the engine's callables per bucket, and its
compiled half is the CUDA graph: the chained decode and the spec-decode
verify step are each written as a capturable step over static device
buffers (one token step of the chain; one verify forward), captured at
the first use of its ``(nb, sampling)`` bucket and replayed after. A chain
of depth k replays its token step ``k * chunk_size`` times back to back,
one graph serving every depth. The bucketed prefill (classic, or the
prefix cache's suffix prefill) and chunked prefill's mixed step run
eagerly. Each new program key counts one
``paddle_serving_compiled_programs_total{kind}`` as the reference counts
its compiles (decode per ``(nb, k, sampling)``), so both engines report
the same program lattice. There is no mesh.

The host KV tier, the KV handoff and the integrity sentinel reach the
pool and the weights through three helpers: :meth:`ModelRunner.capture_pages`
(a gather of whole pages), :meth:`ModelRunner.restore_pages` (an in-place
``index_copy_`` into the pool's tensors, which the captured graphs hold)
and :meth:`ModelRunner.fetch_param_slice` (the bytes a program consumes).

:class:`GraphSet` and :class:`CapturedStep` carry the capture and the
replay; ``GenerationMixin.generate`` captures its decode step with them
too.
"""
from __future__ import annotations

import contextlib
import gc
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..kernels import build

__all__ = ["ModelRunner", "GraphSet", "CapturedStep", "int_words",
           "host_words"]

# the integer word of each element size: a tensor viewed as these words
# keeps its bytes, and numpy holds every one of them (it has no bf16)
_WORDS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def int_words(t: torch.Tensor) -> torch.Tensor:
    """``t`` viewed as signed integer words of its element size (a bf16
    tensor as int16): the same bytes, in a dtype every backend sums
    exactly and numpy can hold."""
    if not t.dtype.is_floating_point:
        return t
    return t.view(_WORDS[t.element_size()])


def host_words(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy of ``t``'s raw words (``int_words``): its bytes
    are the tensor's bytes, in the layout the reference's host copy of the
    same values has."""
    return int_words(t.detach()).contiguous().cpu().numpy()


class _CudaGraph:
    """``torch.cuda.CUDAGraph`` behind the three calls a step makes. The
    warm-up runs the body once eagerly on the capture stream: it builds and
    loads every kernel's library (never inside a capture) and allocates
    that stream's arrival counters (``kernels/build.py``) and cuBLAS
    workspace outside the graph. The capture runs in ``thread_local`` mode:
    the serving front end steps the engine on a thread of its own beside
    the asyncio server. No garbage collection runs inside a capture:
    freeing a graph there (an engine's that went out of use, or a failed
    capture's, both held in reference cycles) is an operation the
    capturing stream refuses, and the capture fails. A failed capture or
    replay raises; nothing falls back to eager."""

    def __init__(self, owner: "GraphSet"):
        self.graph = torch.cuda.CUDAGraph()
        self.pool = owner.pool
        self.stream = owner.stream

    def warm_up(self, body):
        cur = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            body()
        cur.wait_stream(self.stream)

    def capture(self, body):
        enabled = gc.isenabled()
        gc.disable()  # torch.cuda.graph collects once, before it begins
        try:
            with torch.cuda.graph(self.graph, pool=self.pool,
                                  stream=self.stream,
                                  capture_error_mode="thread_local"):
                body()
        finally:
            if enabled:
                gc.enable()

    def replay(self):
        self.graph.replay()


def _graph_factory(device: torch.device):
    """The graph type a step is captured into on ``device``: a CUDA graph
    on the card; none on the CPU, where the body runs eagerly. The CPU
    tests swap in a stand-in here to drive the capture bookkeeping."""
    return _CudaGraph if device.type == "cuda" else None


class CapturedStep:
    """A capturable step: ``body()`` reads its inputs from the static
    tensors of ``bufs`` and writes its results back into them in place, so
    runs chain with no host work and no copy between them. Given a
    ``graph``, the body is warmed up and captured here and :meth:`run`
    replays it. A replay calls no kernel wrapper, so the launch counters'
    deltas over the capture are recorded (the capture itself launches
    nothing and leaves them as they were) and added on every replay: they
    go on counting the kernels that ran. Without a graph (the CPU, or
    graphs off) :meth:`run` calls the body. ``keep`` (a context manager
    factory) wraps the warm-up and the capture, to put back what the
    warm-up's writes touch."""

    def __init__(self, body: Callable[[], None], bufs, graph=None,
                 keep=None):
        self.body = body
        self.bufs = bufs
        self.graph = None
        self.deltas: Tuple = ()
        self.capture_ms = 0.0
        if graph is not None:
            with (keep or contextlib.nullcontext)():
                self._capture(graph)

    def _capture(self, graph):
        t0 = time.perf_counter()
        graph.warm_up(self.body)
        # read after the warm-up, which imported every wrapper the body runs
        counters = tuple(build.LAUNCH_COUNTERS)
        before = [getattr(fn, attr) for fn, attr in counters]
        try:
            graph.capture(self.body)
            after = [getattr(fn, attr) for fn, attr in counters]
        finally:
            for (fn, attr), n in zip(counters, before):
                setattr(fn, attr, n)
        self.deltas = tuple((fn, attr, a - b) for (fn, attr), a, b
                            in zip(counters, after, before) if a != b)
        self.graph = graph
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def load(self, **inputs):
        """Copy each named input into its static buffer, in place."""
        for name, t in inputs.items():
            getattr(self.bufs, name).copy_(t)

    def run(self, n: int = 1):
        """Run the step ``n`` times back to back."""
        if self.graph is None:
            for _ in range(n):
                self.body()
            return
        for _ in range(n):
            self.graph.replay()
        for fn, attr, d in self.deltas:
            setattr(fn, attr, getattr(fn, attr) + n * d)


class GraphSet:
    """The captured steps of one owner (an engine's runner; a model's
    ``generate``), one a key, sharing one private memory pool
    (``torch.cuda.graph_pool_handle``) and one capture stream. Their bodies
    keep every result in static buffers allocated outside the captures, so
    the pool holds only scratch, and replays on one stream never overlap.

    ``enabled`` (default True) captures on the card; False keeps new steps
    eager (the key carries the flag), which ``chip_smoke.py`` sets to run
    the same bodies eagerly beside their graphs. ``limit`` bounds the steps
    kept, the least recently used going first, before a new step's
    buffers are made."""

    def __init__(self, device: torch.device, limit: Optional[int] = None):
        self.device = device
        self.enabled = True
        self.limit = limit
        self.steps: "OrderedDict[Tuple, CapturedStep]" = OrderedDict()
        self._pool = None
        self._stream = None

    @property
    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    @property
    def stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def get(self, key, make: Callable[[], Tuple[Callable, object]],
            keep=None) -> CapturedStep:
        """The step of ``key``; at its first use ``make()`` gives (body,
        static buffers) and the step is captured (``keep``: as in
        :class:`CapturedStep`)."""
        full = (key, self.enabled)
        step = self.steps.get(full)
        if step is not None:
            self.steps.move_to_end(full)
            return step
        # the step going out is dropped before the new one's buffers are
        # made, so the two are never held at once
        while self.limit is not None and len(self.steps) >= self.limit:
            self.steps.popitem(last=False)
        body, bufs = make()
        factory = _graph_factory(self.device) if self.enabled else None
        step = CapturedStep(body, bufs,
                            None if factory is None else factory(self), keep)
        self.steps[full] = step
        return step


class ModelRunner:
    """Builds and caches the engine's callables per shape bucket; owns the
    engine's captured steps (``_graphs``)."""

    def __init__(self, engine):
        self.engine = engine
        self.decode_fns: Dict[Tuple, Callable] = {}
        self.prefill_fns: Dict[Tuple, Callable] = {}
        self.mixed_fns: Dict[Tuple, Callable] = {}
        self.verify_fns: Dict[bool, Callable] = {}
        self._verify_shapes: Set[Tuple[int, bool]] = set()
        self._graphs = GraphSet(engine.device)

    def _count(self, kind: str):
        m = self.engine._m
        if m is not None:
            m.compiled.labels(kind=kind).inc()

    def get_decode(self, nb: int, k: int, sampling: bool) -> Callable:
        key = (nb, k, sampling)
        fn = self.decode_fns.get(key)
        if fn is None:
            self._count("decode")
            fn = self.decode_fns[key] = self._decode_chain(
                nb, k * self.engine.chunk_size, sampling)
        return fn

    def _decode_chain(self, nb: int, steps: int, sampling: bool):
        """The chained decode over ``nb`` rows: ``steps`` runs of the token
        step ``Engine._decode_step`` (one graph per ``(nb, sampling)``,
        whatever the depth) back to back, with no host sync. Returns
        (tokens [nb, steps], lengths, keys, bad) as copies made on the
        device, since the next chain overwrites the step's buffers; an MoE
        engine notes its router stats, summed on the card over the steps,
        once a chain (a copy too)."""
        eng = self.engine

        @torch.no_grad()
        def decode_chain(tables, lengths, last_tok, temps, keys):
            step = self._graphs.get(("decode", nb, sampling),
                                    lambda: eng._decode_step(nb, sampling),
                                    keep=eng._cache.trash_kept)
            b = step.bufs
            step.load(tables=tables, lengths=lengths, last=last_tok,
                      temps=temps, keys=keys)
            b.bad.zero_()
            b.idx.zero_()
            if b.mstat is not None:
                b.mstat.zero_()
            step.run(steps)
            if b.mstat is not None:
                eng._note_moe_stats([b.mstat.clone()])
            return (b.toks[:, :steps].clone(), b.lengths.clone(),
                    b.keys.clone(), b.bad.clone())

        return decode_chain

    def get_prefill(self, bucket: Tuple[int, int], sampling: bool,
                    suffix: bool = False) -> Callable:
        """``suffix=True``: the prefix cache's partial prefill, whose
        attention goes through the verify kernel over the cached prefix.
        Eager."""
        key = (bucket, sampling, suffix)
        fn = self.prefill_fns.get(key)
        if fn is None:
            self._count("prefill")
            fn = self.prefill_fns[key] = self.engine._make_prefill_raw(
                sampling, suffix)
        return fn

    def get_mixed(self, nb: int, sampling: bool) -> Callable:
        """Chunked prefill's mixed chunk+decode step. Eager."""
        key = (nb, sampling)
        fn = self.mixed_fns.get(key)
        if fn is None:
            self._count("mixed")
            from .engine import make_mixed_step_fn

            fn = self.mixed_fns[key] = make_mixed_step_fn(self.engine,
                                                          sampling)
        return fn

    def note_verify_shape(self, nb: int, sampling: bool):
        """Count a verify program the first time its padded batch ``nb``
        runs (the reference compiles one per shape)."""
        if (nb, sampling) not in self._verify_shapes:
            self._verify_shapes.add((nb, sampling))
            self._count("verify")

    # ------------------------------------------------- page and weight bytes
    @staticmethod
    def capture_pages(pages_flat: List[torch.Tensor],
                      idx: torch.Tensor) -> List[torch.Tensor]:
        """Gather pages ``idx`` out of every pool buffer (``pages_flat``
        order: k, v, scale per layer), on the current stream: fresh
        ``[len(idx), page_size, lanes]`` tensors, so later writes into the
        pages leave them as they were."""
        return [b.index_select(0, idx) for b in pages_flat]

    @staticmethod
    def restore_pages(pages_flat: List[torch.Tensor], idx: torch.Tensor,
                      payload: List[torch.Tensor]):
        """Write ``payload`` (one ``[len(idx), ...]`` tensor per buffer, on
        the pool's device) into pages ``idx`` of every pool buffer, in
        place: the captured graphs read these buffers by address."""
        for b, x in zip(pages_flat, payload):
            b.index_copy_(0, idx, x)

    @staticmethod
    def capture_page_row(pages_flat: List[torch.Tensor],
                         page: int) -> torch.Tensor:
        """One page of every pool buffer as one contiguous byte row
        (``uint8``, ``pages_flat`` order), gathered on the current stream
        in one concatenation: the host tier moves a page as one copy."""
        return torch.cat([b[int(page)].reshape(-1).view(torch.uint8)
                          for b in pages_flat])

    @classmethod
    def restore_page_rows(cls, pages_flat: List[torch.Tensor],
                          idx: torch.Tensor, rows: torch.Tensor):
        """Inverse of :meth:`capture_page_row` for ``len(idx)`` pages:
        ``rows`` (``uint8 [n, page bytes]``, on the pool's device) split
        into each buffer's views and written by :meth:`restore_pages`."""
        payload, off = [], 0
        for b in pages_flat:
            size = b[0].numel() * b.element_size()
            payload.append(rows[:, off:off + size].view(b.dtype)
                           .view((rows.shape[0],) + tuple(b.shape[1:])))
            off += size
        cls.restore_pages(pages_flat, idx, payload)

    def fetch_param_slice(self, i: int, start: int,
                          stop: Optional[int]) -> np.ndarray:
        """Host copy of elements ``[start, stop)`` (row-major flat order;
        ``stop=None``: to the end) of parameter ``i`` of
        ``Engine._params``, as raw words (``host_words``): the bytes the
        programs consume, in the reference's byte order."""
        flat = self.engine._params[i].detach().reshape(-1)
        return host_words(flat[int(start):None if stop is None
                               else int(stop)])

    def get_verify(self, sampling: bool) -> Callable:
        """The spec-decode verify step (one callable per sampling flag; it
        captures one graph per batch bucket its arguments bring)."""
        fn = self.verify_fns.get(sampling)
        if fn is None:
            from .spec.verifier import make_verify_fn

            fn = self.verify_fns[sampling] = make_verify_fn(self.engine,
                                                            sampling)
        return fn
