"""Model-runner of the serving engine, after
``paddle_tpu/inference/runner.py``.

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
the same program lattice.

**Tensor and expert parallelism** (``Engine(tp=, ep=)``). The reference
traces each program under a ``(tp, ep)`` mesh in one process. The port
runs one process per rank over ``torch.distributed`` and keeps the
reference's sharding plan and its validation messages:

==============================  ==================  ====================
tensor                          global shape        this rank keeps
==============================  ==================  ====================
q/k/v/gate/up projection w      [H, out]            columns ``(None, tp)``
o/down projection w             [in, H]             rows ``(tp, None)``
column-parallel bias            [out]               ``(tp,)``
expert stacks                   [E, ...]            ``(ep, None, None)``
embeddings, norms, router,      (any)               all (replicated)
lm_head
KV pages (per layer, k and v)   [P, ps, Hkv*D]      lanes ``(None, None,
                                                    tp)``
==============================  ==================  ====================

The ranks lay out ``(tp, ep)`` row-major, ep innermost, as the
reference's mesh. Each rank's attention runs its ``H/tp`` heads and the
Megatron all-reduce follows o_proj and down_proj (``models/llama.py``,
``_tp_reduce`` over the tp group); an MoE layer runs its ``E/ep``
experts between an ``all_to_all`` and an ``all_gather`` over the ep group.
Rank 0 owns the engine core (admission, tables, prefix cache, chunking,
the chain depth, deadlines, the watchdog, recovery). Every device
operation it performs on the programs or the pool is a :class:`_Program`
call, which first sends a command to the other ranks (:class:`_Channel`:
a broadcast header naming the kind and its key, then the packed host
operands) and then runs here; a follower's loop (:meth:`ModelRunner.follow`)
runs each command on its shard. A device tensor that an earlier command
made travels as a reference to that command's output, so chained decode
keeps its tokens on the device on every rank. No follower decides
anything itself: its operands are rank 0's decisions. Every rank samples
from bitwise-equal logits (the all-reduce gives every rank the same sum,
and ``lm_head`` is replicated), so every rank's streams are rank 0's.
Over NCCL the decode chain and the verify step stay CUDA graphs (NCCL
collectives capture); over gloo (two ranks sharing one card) they run
eagerly, and the runner logs so.

The host KV tier, the KV handoff and the integrity sentinel reach the
pool and the weights through these helpers, and
:meth:`ModelRunner.fetch_param_slice` (the bytes a program consumes). On
one device they read and write the engine's own pool; on a sharded engine
they keep the reference's global view, each as one command that every
rank runs on its shard:

* :meth:`ModelRunner.gather_pages` / :meth:`ModelRunner.gather_page_rows`
  give rank 0 whole pages in the global layout (``[page_size, Hkv*D]``
  rows, as the reference's assembled ``device_get``): at tp > 1 every rank
  gathers its lanes and one ``all_gather`` joins them; an ep-only engine
  holds the whole pool on every rank, so rank 0 reads its own.
* :meth:`ModelRunner.restore_rows` writes whole-page byte rows into the
  pool in place (an ``index_copy_`` into the tensors the captured graphs
  hold), each rank taking its lanes.
* :meth:`ModelRunner.page_sums`: the sentinel's exact page checksums. Each
  rank sums its lanes weighted at their positions in the whole page; the
  wrapping int64 sum has no order, so one all-reduce of the ranks' sums
  over the tp group (in two exact 32-bit halves) is the ``tp=None`` sum.
* :meth:`ModelRunner.audit_weight` / :meth:`ModelRunner.flip_weight`: the
  weight audit's blocks are the reference's ranges of the GLOBAL flat
  parameter; each rank digests the part of a block it holds
  (:meth:`ModelRunner.local_span`), and rank 0 learns every rank's verdict
  through one ``all_gather``. The ``bit-flip-weight`` point's element, a
  global index, is flipped by whichever ranks hold it.
* :meth:`ModelRunner.shadow`: the sentinel's contiguous forward, which
  enters the tp all-reduce, runs on every rank.

Commands run on the engine thread only, in order: the host tier's worker
thread never sends one (``kv_tier.py``).

:class:`GraphSet` and :class:`CapturedStep` carry the capture and the
replay; ``GenerationMixin.generate`` captures its decode step with them
too.
"""
from __future__ import annotations

import contextlib
import gc
import itertools
import logging
import pickle
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..kernels import build

__all__ = ["ModelRunner", "GraphSet", "CapturedStep", "ShardedEngineError",
           "serving_spec", "int_words", "host_words", "gc_paused",
           "collect_garbage"]

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


def flip_bit(t: torch.Tensor, elem: int, bit: int):
    """XOR bit ``bit`` of flat element ``elem`` of ``t``, in place (the
    captured graphs read ``t`` by address)."""
    words = int_words(t.detach()).view(-1)
    one = words[elem:elem + 1].cpu().numpy()
    raw = bytearray(one.tobytes())
    raw[bit // 8] ^= 1 << (bit % 8)
    words[elem:elem + 1].copy_(torch.from_numpy(
        np.frombuffer(raw, dtype=one.dtype).copy()))


class _CudaGraph:
    """``torch.cuda.CUDAGraph`` behind the three calls a step makes. The
    warm-up runs the body once eagerly on the capture stream: it builds and
    loads every kernel's library (never inside a capture) and allocates
    that stream's arrival counters (``kernels/build.py``) and cuBLAS
    workspace outside the graph. The capture runs in ``thread_local`` mode:
    the serving front end steps the engine on a thread of its own beside
    the asyncio server, and in-process replicas step several engines on
    threads of their own. No garbage collection runs inside a capture
    (:func:`gc_paused`): freeing a graph there (an engine's that went out
    of use, or a failed capture's, both held in reference cycles) is an
    operation the capturing stream refuses, and the capture fails. A
    failed capture or replay raises; nothing falls back to eager."""

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
        # torch.cuda.graph collects once, before it begins
        with gc_paused():
            with torch.cuda.graph(self.graph, pool=self.pool,
                                  stream=self.stream,
                                  capture_error_mode="thread_local"):
                body()

    def replay(self):
        self.graph.replay()


class _GcPause:
    """The process's garbage collector held off while any thread captures.
    ``gc.disable()`` is process-wide: two engines capturing on two threads
    must not let the first to finish turn collection back on under the
    other's capture, so the holds are counted and the last one out
    restores the collector's state. :meth:`collect` collects only while
    no capture holds it, and holds new captures off while it runs."""

    def __init__(self):
        self._cond = threading.Condition()
        self._holds = 0
        self._was_enabled = True

    @contextlib.contextmanager
    def held(self):
        with self._cond:
            if self._holds == 0:
                self._was_enabled = gc.isenabled()
                gc.disable()
            self._holds += 1
        try:
            yield
        finally:
            with self._cond:
                self._holds -= 1
                if self._holds == 0:
                    if self._was_enabled:
                        gc.enable()
                    self._cond.notify_all()

    def collect(self, timeout: float = 60.0) -> bool:
        """``gc.collect()`` once no capture runs (waiting up to
        ``timeout`` s); False, collecting nothing, if one still did."""
        with self._cond:
            if not self._cond.wait_for(lambda: self._holds == 0, timeout):
                return False
            gc.collect()
            return True


_GC = _GcPause()
gc_paused = _GC.held
collect_garbage = _GC.collect


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
    replays it. A replay calls no kernel wrapper, so the launches the
    capture records are tallied on the capturing thread
    (``build.tally_launches``: the capture launches nothing and leaves the
    counters as they were, whatever other threads launch meanwhile) and
    added on every replay: they go on counting the kernels that ran.
    Without a graph (the CPU, or graphs off) :meth:`run` calls the body.
    ``keep`` (a context manager factory) wraps the warm-up and the
    capture, to put back what the warm-up's writes touch."""

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
        # the capture's launches are tallied on this thread alone: another
        # engine's thread may launch, capture or replay meanwhile
        with build.tally_launches() as tally:
            graph.capture(self.body)
        # read after the warm-up, which imported every wrapper the body runs
        self.deltas = tuple((fn, attr, tally[(fn, attr)])
                            for fn, attr in build.LAUNCH_COUNTERS
                            if tally.get((fn, attr)))
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
        build.add_launches(self.deltas, n)


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


# projection layers by the attribute that owns them (duck-typed: any
# model family with the llama-style separate projections shards)
_COL_LAYERS = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
_ROW_LAYERS = ("o_proj", "down_proj")
# stacked expert weights ([E, ...], experts leading) shard over ep; the
# router stays replicated, so routing is the same on every rank
_EXPERT_LEAVES = ("experts_gate", "experts_up", "experts_down")

# the commands rank 0 sends its followers, by header code
_KINDS = ("stop", "prefill", "decode", "mixed", "verify", "handoff",
          "last_token", "copy_pages", "corrupt_page", "reset",
          "gather_pages", "restore_rows", "page_sums", "audit_weight",
          "flip_weight", "shadow")
_HEADER = 8   # code, key length, up to 5 key ints, payload bytes
_KEPT = 16    # commands whose outputs a later command may name

_log = logging.getLogger(__name__)
# sharded engines made so far, per process group: every member of a group
# makes that group's engines in one order, so the counts agree
_engines: Dict[str, "itertools.count"] = {}
_engines_lock = threading.Lock()


def _engine_id(group) -> str:
    import torch.distributed.distributed_c10d as c10d

    try:
        name = c10d._get_process_group_name(group.process_group)
    except Exception:  # noqa: BLE001 - an older torch: the ranks name it
        name = "-".join(map(str, group.ranks))
    with _engines_lock:
        n = next(_engines.setdefault(name, itertools.count()))
    return f"{name}/{n}"


def _local_count(shape, dim, start, length, g: int) -> int:
    """How many elements of a shard (``length`` entries from ``start`` of
    dim ``dim``, whole along every other dim) come before global flat
    index ``g`` of a ``shape`` tensor. The shard's flat order follows the
    global one, so a global range is a local range."""
    if dim is None:
        return g
    inner = int(np.prod(shape[dim + 1:], dtype=np.int64))
    outer, rem = divmod(int(g), shape[dim] * inner)
    x, r = divmod(rem, inner)
    n = outer * length * inner
    if x < start:
        return n
    if x >= start + length:
        return n + length * inner
    return n + (x - start) * inner + r


def serving_spec(name: str, shape, tp: int, ep: int) -> tuple:
    """The serving plan of one parameter, as the reference's sharding spec
    (its ``ModelRunner._spec_for``): one axis name (or None) a dim; ()
    keeps it whole. Raises the reference's errors for what the plan cannot
    split."""
    parts = name.split(".")
    layer = parts[-2] if len(parts) >= 2 else ""
    leaf = parts[-1]
    if leaf in _EXPERT_LEAVES:
        if ep == 1:
            return ()
        if shape[0] % ep:
            raise ValueError(
                f"{name}: expert dim {shape[0]} not divisible by "
                f"ep={ep}")
        return ("ep", None, None)
    if tp == 1:
        return ()  # ep only: dense weights replicate
    if "qkv_proj" in name:
        raise NotImplementedError(
            "tp > 1 over a packed-QKV projection (GPT's [H, 3H] "
            "weight interleaves q/k/v per head in a layout a "
            "contiguous column shard would split wrongly) — serve a "
            "model family with separate q/k/v projections (LLaMA) "
            "or tp=1")
    if layer in _COL_LAYERS:
        if leaf == "weight":
            if shape[-1] % tp:
                raise ValueError(
                    f"{name}: output dim {shape[-1]} not divisible "
                    f"by tp={tp}")
            return (None, "tp")
        return ("tp",)  # a column-parallel bias shards with its cols
    if layer in _ROW_LAYERS:
        if leaf != "weight":
            raise NotImplementedError(
                f"{name}: a row-parallel projection with a bias "
                "would double-count it through the psum — bias-free "
                "row layers only (the llama convention)")
        if shape[0] % tp:
            raise ValueError(
                f"{name}: input dim {shape[0]} not divisible by "
                f"tp={tp}")
        return ("tp", None)
    return ()


class ShardedEngineError(RuntimeError):
    """A sharded engine's ranks can no longer agree: a command failed after
    it went out (the ranks may be apart inside a collective), or a follower
    raised. Not recoverable by a step: the run fails. ``leader_stopped``:
    raised on a follower because rank 0 stopped the engine on a fault (the
    follower itself is sound)."""

    leader_stopped = False


class _Ref:
    """An operand naming output ``i`` of command ``seq``: a device tensor
    every rank holds its own copy of."""
    __slots__ = ("seq", "i")

    def __init__(self, seq: int, i: int):
        self.seq, self.i = seq, i

    def __reduce__(self):
        return (_Ref, (self.seq, self.i))


class _Channel:
    """Rank 0's commands to its followers over the engine's group: a
    broadcast ``int64[8]`` header (the kind, its key: bucket, ``(nb, k,
    sampling)``, ... and the payload's size), then the payload, the
    command's packed host operands (a pickle of numpy arrays and
    :class:`_Ref`s) as one ``uint8`` broadcast. Both sides number the
    commands in order, so a ``_Ref`` names the same command everywhere."""

    def __init__(self, group, device):
        self.group = group
        self.src = group.ranks[0]
        self.dev = device
        self.seq = 0

    def _bcast(self, t):
        from ..distributed.collective import broadcast

        broadcast(t, self.src, group=self.group)
        return t

    def send(self, kind: str, key: Tuple[int, ...], operands) -> int:
        payload = pickle.dumps(list(operands), protocol=5) \
            if operands else b""
        hdr = torch.zeros(_HEADER, dtype=torch.int64)
        hdr[0] = _KINDS.index(kind)
        hdr[1] = len(key)
        hdr[2:2 + len(key)] = torch.tensor([int(x) for x in key])
        hdr[_HEADER - 1] = len(payload)
        self._bcast(hdr.to(self.dev))
        if payload:
            buf = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
            self._bcast(buf.to(self.dev))
        self.seq += 1
        return self.seq

    def recv(self):
        hdr = self._bcast(torch.zeros(_HEADER, dtype=torch.int64,
                                      device=self.dev)).cpu()
        kind = _KINDS[int(hdr[0])]
        key = tuple(int(x) for x in hdr[2:2 + int(hdr[1])])
        n = int(hdr[_HEADER - 1])
        ops = []
        if n:
            buf = self._bcast(torch.empty(n, dtype=torch.uint8,
                                          device=self.dev))
            ops = pickle.loads(buf.cpu().numpy().tobytes())
        self.seq += 1
        return self.seq, kind, key, ops


class _Program:
    """One engine program (or pool operation) of kind ``kind`` and key
    ``key``. Called with host arrays (each copied to the engine's device)
    and device tensors. On rank 0 of a sharded engine the call first sends
    the command to the followers, then runs ``fn`` here; elsewhere it runs
    ``fn``."""

    def __init__(self, runner: "ModelRunner", kind: str, key, fn: Callable):
        self.runner, self.kind, self.key, self.fn = runner, kind, key, fn

    def __call__(self, *operands):
        r = self.runner
        if r.channel is not None and r.is_leader:
            return r._lead(self, operands)
        return self.fn(*r._materialize(operands))


class ModelRunner:
    """Builds and caches the engine's programs per shape bucket; owns the
    engine's captured steps (``_graphs``) and, at ``tp`` or ``ep`` > 1,
    the rank's shard of the model and pool and the command channel
    (see the module doc)."""

    def __init__(self, engine, tp: Optional[int] = None,
                 ep: Optional[int] = None, group=None):
        self.engine = engine
        self.tp = int(tp) if tp else 1
        self.ep = int(ep) if ep else 1
        self.decode_fns: Dict[Tuple, Callable] = {}
        self.prefill_fns: Dict[Tuple, Callable] = {}
        self.mixed_fns: Dict[Tuple, Callable] = {}
        self.verify_fns: Dict[bool, Callable] = {}
        self._verify_shapes: Set[Tuple[int, bool]] = set()
        self._graphs = GraphSet(engine.device)
        self.group = self.tp_group = self.ep_group = None
        self.rank = self.tp_rank = self.ep_rank = 0
        self.param_specs: Optional[Dict[str, tuple]] = None
        self.channel: Optional[_Channel] = None
        self._stopped = False
        # rank 0: id(output) -> (command, index); followers: command ->
        # outputs. The last _KEPT commands' outputs are held
        self._out_ids: Dict[int, Tuple[int, int]] = {}
        self._kept: "OrderedDict[int, tuple]" = OrderedDict()
        # rank 0: id(device tensor) -> (tensor, the host data it came from)
        self._host: "OrderedDict[int, tuple]" = OrderedDict()
        self._ops = {name: _Program(self, name, (), getattr(self, "_" + name))
                     for name in ("handoff", "last_token", "copy_pages",
                                  "corrupt_page", "reset", "gather_pages",
                                  "restore_rows", "page_sums",
                                  "audit_weight", "flip_weight", "shadow")}
        # per parameter of Engine._params: (global shape, split dim or
        # None, this rank's first index and length along it)
        self._layout: Optional[List[tuple]] = None
        if self.tp > 1 or self.ep > 1:
            self._validate_and_build_groups(group)

    # ------------------------------------------------------------ groups
    def _validate_and_build_groups(self, group):
        """The reference's checks, in its order and with its messages, then
        the rank layout: ``(tp, ep)`` row-major over the engine's group,
        ep innermost, as the reference's mesh; the tp group holds the
        ranks of one ep index, the ep group those of one tp index."""
        import torch.distributed as dist

        from ..distributed.parallel import subgroup
        from ..distributed.topology import Group

        eng = self.engine
        cfg = eng.cfg
        tp, ep = self.tp, self.ep
        if tp > 1 and eng.quantized:
            raise NotImplementedError(
                "tp > 1 with quantized_cache: the int8 scale pages pack "
                "k/v scales against the GLOBAL kv-head count in their "
                "128-lane layout, which a lane-sharded pool would split "
                "mid-field — serve bf16/f32 pages or tp=1")
        if group is None and dist.is_initialized():
            group = Group(list(range(dist.get_world_size())),
                          rank=dist.get_rank(),
                          process_group=dist.group.WORLD)
        have = group.nranks if group is not None else 1
        if have < tp * ep:
            raise ValueError(
                f"tp={tp} x ep={ep} needs {tp * ep} ranks (one process a "
                f"shard), found {have} in the engine's group (start the "
                "world first: distributed.init_parallel_env)")
        if tp > 1:
            n_kv = getattr(cfg, "num_kv_heads", cfg.num_heads)
            if cfg.num_heads % tp or n_kv % tp:
                raise ValueError(
                    f"tp={tp} must divide num_heads={cfg.num_heads} and "
                    f"num_kv_heads={n_kv} (the KV pool shards by head)")
            inter = getattr(cfg, "intermediate_size", 0)
            if inter and inter % tp:
                raise ValueError(
                    f"tp={tp} must divide intermediate_size={inter}")
        if ep > 1:
            n_exp = getattr(cfg, "num_experts", 0)
            if not n_exp:
                raise ValueError(
                    f"ep={ep} on a dense model: expert parallelism "
                    "shards the stacked expert weights, which this "
                    "config does not have (num_experts=0) — serve an "
                    "MoE config or ep=1")
            if n_exp % ep:
                raise ValueError(
                    f"ep={ep} must divide num_experts={n_exp} (each "
                    "shard owns a contiguous block of experts)")
        if have > tp * ep:
            raise ValueError(
                f"tp={tp} x ep={ep} runs on exactly {tp * ep} ranks; the "
                f"engine's group has {have} (pass group= of that size)")
        self.param_specs = {name: serving_spec(name, p.shape, tp, ep)
                            for name, p in eng.model.named_parameters()}
        self.group = group
        self.rank = group.rank
        self.tp_rank, self.ep_rank = divmod(self.rank, ep)
        ranks = group.ranks
        # every member makes every subgroup, in one order
        tp_groups = [[ranks[i * ep + j] for i in range(tp)]
                     for j in range(ep)]
        ep_groups = [[ranks[i * ep + j] for j in range(ep)]
                     for i in range(tp)]
        # an axis spanning the engine's whole group rides that group
        # itself: two engines over the same ranks (in-process replicas on
        # groups of their own) keep their collectives apart. The others
        # are the process's, one a rank set (so a replica at tp > 1 and
        # ep > 1 is refused: serving/replica.py)
        made = {tuple(rs): group if list(rs) == list(ranks)
                else subgroup(rs) for rs in tp_groups + ep_groups
                if len(rs) > 1}
        if tp > 1:
            self.tp_group = made[tuple(tp_groups[self.ep_rank])]
        if ep > 1:
            self.ep_group = made[tuple(ep_groups[self.tp_rank])]
        backend = dist.get_backend(group.process_group)
        dev = eng.device if backend == "nccl" else torch.device("cpu")
        self.channel = _Channel(group, dev)
        self._engine_id = _engine_id(group)
        if backend != "nccl" and eng.device.type == "cuda":
            # gloo's collectives cannot be captured into a CUDA graph
            self._graphs.enabled = False
            _log.warning(
                "tp=%d ep=%d over gloo: the decode chain and the verify "
                "step run eagerly (CUDA graphs capture NCCL collectives "
                "only)", tp, ep)

    @property
    def sharded(self) -> bool:
        return self.channel is not None

    @property
    def is_leader(self) -> bool:
        return self.rank == 0

    @property
    def coords(self) -> Dict[str, Tuple[int, int]]:
        """This rank's ``(index, size)`` along ``tp`` and ``ep``."""
        return {"tp": (self.tp_rank, self.tp), "ep": (self.ep_rank, self.ep)}

    @property
    def page_spec(self) -> tuple:
        """The pool's split: KV-head lanes over tp (an ep-only engine keeps
        the whole pool on every rank, each running full attention)."""
        return (None, None, "tp") if self.tp > 1 else ()

    def page_shape(self, shape) -> Tuple[int, ...]:
        """This rank's shard of a ``[pages, page_size, Hkv * D]`` pool
        buffer."""
        from ..distributed.fleet.meta_parallel.tensor_parallel import \
            shard_slices

        idx = shard_slices(shape, self.page_spec, self.coords)
        return tuple(len(range(*s.indices(n))) for s, n in zip(idx, shape))

    # -------------------------------------------------------- placement
    @torch.no_grad()
    def place_params(self):
        """Keep this rank's shard of every parameter, in place (the full
        tensors go, so the pools that follow have their room), and arm the
        local view. A model already sharded for this layout is taken as
        it is; one sharded otherwise raises."""
        if not self.sharded:
            return
        from ..distributed.fleet.meta_parallel.tensor_parallel import \
            shard_tensor

        model = self.engine.model
        layout = (self.tp, self.ep, self.tp_rank, self.ep_rank)
        done = getattr(model, "_serving_shard", None)
        if done is not None and done != layout:
            raise ValueError(f"the model is already sharded as (tp, ep, "
                             f"tp_rank, ep_rank)={done}, not {layout}")
        if done is None:
            for name, p in model.named_parameters():
                spec = self.param_specs[name]
                if spec:
                    p.data = shard_tensor(p.data, spec, self.coords)
            model._serving_shard = layout
        self.local_view()
        if self.engine.device.type == "cuda":
            torch.cuda.empty_cache()

    def local_view(self):
        """Arm this rank's model for its shard: attention modules take the
        local head counts (global / tp) and, with the MLPs, the tp group
        (``_tp_group``: the Megatron all-reduce after o_proj and
        down_proj); MoE layers take the ep group (``_ep_group``: the
        all_to_all dispatch and the all_gather combine). Idempotent."""
        for lyr in self.engine.model.modules():
            if hasattr(lyr, "router") and hasattr(lyr, "experts_gate"):
                lyr._ep_group = self.ep_group
            elif self.tp > 1 and hasattr(lyr, "o_proj") \
                    and hasattr(lyr, "num_heads"):
                if not getattr(lyr, "_tp_local", False):
                    lyr.num_heads //= self.tp
                    lyr.num_kv_heads //= self.tp
                    lyr._tp_local = True
                lyr._tp_group = self.tp_group
            elif self.tp > 1 and hasattr(lyr, "down_proj") \
                    and hasattr(lyr, "gate_proj"):
                lyr._tp_group = self.tp_group

    # ---------------------------------------------------------- commands
    def _materialize(self, operands):
        """Operands as the programs take them: host data on the engine's
        device, a :class:`_Ref` as this rank's tensor, tensors as they
        are."""
        eng = self.engine
        out = []
        for o in operands:
            if isinstance(o, _Ref):
                o = self._kept[o.seq][o.i]
            elif o is not None and not isinstance(o, torch.Tensor):
                o = eng._dev(np.asarray(o))
            out.append(o)
        return out

    def note_host(self, t: torch.Tensor, a):
        """Rank 0: ``t`` was made from host data ``a`` (``Engine._dev``);
        the last few are kept."""
        if self.is_leader:
            self._host[id(t)] = (t, np.asarray(a).astype(
                np.dtype(str(t.dtype).replace("torch.", "")), copy=False))
            while len(self._host) > 4 * _KEPT:
                self._host.popitem(last=False)

    def _encode(self, o):
        """An operand as a command carries it: a tensor an earlier command
        made as a reference to it, a tensor made from host data as that
        data, any other tensor as its fetched values."""
        if o is None or isinstance(o, np.ndarray):
            return o
        if isinstance(o, torch.Tensor):
            ref = self._out_ids.get(id(o))
            if ref is not None:
                return _Ref(*ref)
            held = self._host.get(id(o))
            if held is not None and held[0] is o:
                return held[1]
            return o.detach().cpu().numpy()
        return np.asarray(o)

    def _keep(self, seq: int, outputs):
        outs = tuple(outputs) if isinstance(outputs, (tuple, list)) \
            else (() if outputs is None else (outputs,))
        self._kept[seq] = outs
        if self.is_leader:
            for i, t in enumerate(outs):
                if isinstance(t, torch.Tensor):
                    self._out_ids[id(t)] = (seq, i)
        while len(self._kept) > _KEPT:
            _, old = self._kept.popitem(last=False)
            if self.is_leader:
                for t in old:
                    self._out_ids.pop(id(t), None)

    def _lead(self, prog: _Program, operands):
        """Rank 0's call of a program: the command goes out first, then the
        program runs here. A failure after the command went out leaves the
        ranks apart: it raises :class:`ShardedEngineError`."""
        if self._stopped:
            raise ShardedEngineError("the engine was closed: its followers "
                                     "have left their loops")
        enc = [self._encode(o) for o in operands]
        try:
            seq = self.channel.send(prog.kind, prog.key, enc)
            out = prog.fn(*self._materialize(operands))
        except Exception as e:
            raise ShardedEngineError(
                f"{prog.kind}{prog.key} failed on rank 0 after its command "
                f"went out: {e!r}{self._follower_errors()}") from e
        self._keep(seq, out)
        return out

    def _error_key(self, rank: int) -> str:
        """The store key of global ``rank``'s error in this engine (every
        rank of a group makes its sharded engines in one order, so the
        engines' counts agree)."""
        return f"paddle_tpu_torch/serving/{self._engine_id}/error/{rank}"

    def _store(self):
        import torch.distributed.distributed_c10d as c10d

        return c10d._get_default_store()

    def _follower_errors(self) -> str:
        """What a follower that raised left in the world's store."""
        try:
            store = self._store()
            msgs = [f"rank {r}: {store.get(self._error_key(r)).decode()}"
                    for r in self.group.ranks[1:]
                    if store.check([self._error_key(r)])]
        except Exception:  # noqa: BLE001 - the store may be gone too
            return ""
        return ("; followers: " + " | ".join(msgs)) if msgs else ""

    def _resolve(self, kind: str, key: Tuple[int, ...]) -> _Program:
        if kind == "prefill":
            nb, seq, sampling, suffix = key
            return self.get_prefill((nb, seq), bool(sampling), bool(suffix))
        if kind == "decode":
            nb, k, sampling = key
            return self.get_decode(nb, k, bool(sampling))
        if kind == "mixed":
            nb, sampling = key
            return self.get_mixed(nb, bool(sampling))
        if kind == "verify":
            return self.get_verify(bool(key[0]))
        return self._ops[kind]

    def follow(self):
        """A follower's loop: run every command rank 0 sends, on this
        rank's shard, until rank 0 stops. A command that raises here is
        written to the world's store for rank 0 to report, and raises
        :class:`ShardedEngineError`."""
        eng = self.engine
        while True:
            seq, kind, key, ops = self.channel.recv()
            if kind == "stop":
                self._kept.clear()
                if ops and ops[0] is not None:
                    err = ShardedEngineError(
                        f"rank 0 stopped on a fault: {ops[0]}")
                    err.leader_stopped = True
                    raise err
                return
            try:
                prog = self._resolve(kind, key)
                out = prog.fn(*self._materialize(ops))
            except Exception as e:
                me = self.group.ranks[self.rank]  # the global rank
                try:
                    self._store().set(self._error_key(me),
                                      f"{kind}{key}: {e!r}")
                except Exception:  # noqa: BLE001 - the report is best-effort
                    pass
                raise ShardedEngineError(
                    f"rank {me} failed running {kind}{key}: {e!r}") from e
            self._keep(seq, out)
            # rank 0 reads the router stats; the followers' copies go
            eng._moe_pending.clear()

    def stop(self, error: Optional[str] = None):
        """Rank 0: end the followers' loops (``error``: they raise with
        it). A no-op elsewhere."""
        if self.channel is not None and self.is_leader \
                and not self._stopped:
            self._stopped = True
            self.channel.send("stop", (), [error] if error else [])
            self._kept.clear()
            self._out_ids.clear()
            self._host.clear()

    # ------------------------------------------------------ pool commands
    def handoff(self, last, keys, dst, src, src_tok, src_keys):
        """The chain's first tokens and keys: the host rows ``last`` /
        ``keys`` with rows ``dst`` taken from rows ``src`` of an admission
        prefill's device outputs (no host round trip)."""
        return self._ops["handoff"](last, keys, dst, src, src_tok, src_keys)

    @staticmethod
    def _handoff(last, keys, dst, src, src_tok, src_keys):
        last[dst] = src_tok[src]
        keys[dst] = src_keys[src]
        return last, keys

    def last_token(self, toks):
        """Column -1 of a chain's tokens: the next chain's input."""
        return self._ops["last_token"](toks)

    @staticmethod
    def _last_token(toks):
        return toks[:, -1]

    def copy_pages(self, src, dst):
        """Copy-on-write: pages ``src`` into pages ``dst`` of every pool
        buffer, in place."""
        return self._ops["copy_pages"](np.asarray(src, np.int64),
                                       np.asarray(dst, np.int64))

    def _copy_pages(self, src, dst):
        c = self.engine._cache
        for pages in (c.k_pages, c.v_pages, c.scale_pages):
            for p in pages:
                if p is not None:
                    p[dst] = p[src]

    def corrupt_page(self, page: int):
        """The cache-corruption fault points' damage to one page (see
        ``CacheCoordinator.corrupt_page``), on every rank's shard."""
        return self._ops["corrupt_page"](np.asarray([int(page)], np.int64))

    def _corrupt_page(self, page):
        eng = self.engine
        eng._cache.k_pages[0].index_fill_(0, page,
                                          57 if eng.quantized else 1e3)

    def reset(self):
        """After a step fault: every rank forgets the outputs a later
        command could have named."""
        self._ops["reset"]()
        self._kept.clear()
        self._out_ids.clear()
        self._host.clear()

    def _reset(self):
        self._kept.clear()

    # ------------------------------------- the pool and weights, globally
    def _all_gather(self, t: torch.Tensor, group=None) -> List[torch.Tensor]:
        """Every member's ``t`` (one shape on every rank) in group-rank
        order, through the channel's device (a gloo group moves host
        tensors)."""
        from ..distributed.collective import all_gather

        return all_gather([], t.to(self.channel.dev),
                          group=self.group if group is None else group)

    def _lanes(self, width: int) -> Tuple[int, int]:
        """This rank's first lane and lane count of a pool buffer whose
        pages are ``width`` lanes wide here (all of them off tp)."""
        return self.tp_rank * width, width * self.tp

    def global_page_shape(self, buf: torch.Tensor) -> Tuple[int, ...]:
        """One page of pool buffer ``buf`` as the global pool holds it
        (``[page_size, Hkv * D]``; this rank holds ``1/tp`` of the
        lanes)."""
        return tuple(buf.shape[1:-1]) + (buf.shape[-1] * self.tp,)

    def page_row_bytes(self, pages_flat: List[torch.Tensor]) -> List[int]:
        """The bytes of one whole page of each buffer, ``pages_flat``
        order."""
        return [int(np.prod(self.global_page_shape(b))) * b.element_size()
                for b in pages_flat]

    def gather_pages(self, pages) -> List[torch.Tensor]:
        """Whole pages ``pages`` of every pool buffer (``pages_flat``
        order), each ``[len(pages), page_size, Hkv * D]`` in the global
        layout. At tp > 1 one command: every rank gathers its lanes and
        one ``all_gather`` joins them (rank 0 assembles them; the tensors
        lie on the channel's device); elsewhere rank 0's own pool, on the
        engine's device."""
        eng = self.engine
        if self.tp == 1:
            idx = torch.as_tensor(list(pages), dtype=torch.int64,
                                  device=eng.device)
            return self.capture_pages(eng._cache.pages_flat(), idx)
        parts = self._ops["gather_pages"](np.asarray(pages, np.int64))
        # the lanes of tp rank i lie with the ranks of ep index 0
        parts = [parts[i * self.ep] for i in range(self.tp)]
        out, off = [], 0
        n = len(pages)
        for b in eng._cache.pages_flat():
            size = b[0].numel() * b.element_size()
            lanes = [p[:, off:off + size].view(b.dtype)
                     .view((n,) + tuple(b.shape[1:])) for p in parts]
            out.append(torch.cat(lanes, dim=-1))
            off += size
        return out

    def _gather_pages(self, idx):
        """Every rank: its lanes of pages ``idx``, one byte row a page
        (``capture_page_row``'s layout), gathered from every rank."""
        flat = self.engine._cache.pages_flat()
        rows = torch.cat([b.index_select(0, idx).reshape(idx.shape[0], -1)
                          .view(torch.uint8) for b in flat], dim=1)
        return tuple(self._all_gather(rows))

    def gather_page_rows(self, pages) -> torch.Tensor:
        """Whole pages as byte rows (``uint8 [len(pages), bytes]``, every
        buffer's global page in ``pages_flat`` order: the host tier's slab
        row). See :meth:`gather_pages`."""
        if self.tp == 1:
            flat = self.engine._cache.pages_flat()
            rows = [self.capture_page_row(flat, p) for p in pages]
            return rows[0][None] if len(rows) == 1 else torch.stack(rows)
        n = len(pages)
        return torch.cat([t.reshape(n, -1).view(torch.uint8)
                          for t in self.gather_pages(pages)], dim=1)

    def restore_rows(self, pages, rows):
        """Write whole-page byte rows (``uint8 [len(pages), bytes]``, the
        layout of :meth:`gather_page_rows`) into pages ``pages`` of the
        pool, in place (the captured graphs read the pool by address). On
        one device ``rows`` is host data or a tensor on the engine's
        device; on a sharded engine it is one command, each rank taking
        its lanes of the host rows."""
        if isinstance(rows, torch.Tensor) and self.sharded:
            rows = rows.cpu().numpy()
        return self._ops["restore_rows"](np.asarray(pages, np.int64), rows)

    @torch.no_grad()
    def _restore_rows(self, idx, rows):
        flat = self.engine._cache.pages_flat()
        n, off = idx.shape[0], 0
        for b, size in zip(flat, self.page_row_bytes(flat)):
            whole = rows[:, off:off + size].view(b.dtype) \
                .view((n,) + self.global_page_shape(b))
            if self.tp > 1:
                lo, _ = self._lanes(b.shape[-1])
                whole = whole[..., lo:lo + b.shape[-1]]
            b.index_copy_(0, idx, whole)
            off += size

    def page_sums(self, pages) -> List[int]:
        """Rank 0: the integrity sentinel's exact checksums of whole pages
        ``pages`` (``integrity.page_checksums``), as Python ints."""
        from .integrity import page_checksums

        eng = self.engine
        if self.tp == 1:
            idx = torch.as_tensor(list(pages), dtype=torch.int64,
                                  device=eng.device)
            return page_checksums(eng._cache.pages_flat(), idx) \
                .cpu().tolist()
        halves = self._ops["page_sums"](np.asarray(pages, np.int64))
        lo, hi = halves.cpu().tolist()
        # the wrapping int64 sum, from the exact sums of its halves
        out = []
        for a, b in zip(lo, hi):
            v = (b * (1 << 32) + a) % (1 << 64)
            out.append(v - (1 << 64) if v >= 1 << 63 else v)
        return out

    @torch.no_grad()
    def _page_sums(self, idx):
        """Every rank: its lanes' share of each page's checksum, split into
        a low (unsigned) and a high (signed) 32-bit half so the tp group's
        sum of them is exact, summed over that group."""
        from .integrity import page_checksums

        flat = self.engine._cache.pages_flat()
        lane0, lanes = self._lanes(flat[0].shape[-1])
        s = page_checksums(flat, idx, lane0=lane0, lanes=lanes)
        halves = torch.stack([s & 0xFFFFFFFF, s >> 32])
        from ..distributed.collective import all_reduce

        return all_reduce(halves.to(self.channel.dev), group=self.tp_group)

    # weights ------------------------------------------------------------
    def _param_layout(self) -> List[tuple]:
        if self._layout is None:
            model = self.engine.model
            names = [n for n, _ in model.named_parameters()]
            names += [n for n, b in model.named_buffers() if b is not None]
            out = []
            for name, t in zip(names, self.engine._params):
                shape, dim, start, length = list(t.shape), None, 0, None
                for d, axis in enumerate((self.param_specs or {})
                                         .get(name, ())):
                    if axis:
                        r, n = self.coords[axis]
                        dim, start, length = d, r * shape[d], shape[d]
                        shape[d] *= n
                out.append((tuple(shape), dim, start, length))
            self._layout = out
        return self._layout

    def param_numel(self, i: int) -> int:
        """The GLOBAL element count of parameter ``i`` of
        ``Engine._params``."""
        return int(np.prod(self._param_layout()[i][0], dtype=np.int64))

    def local_span(self, i: int, start: int, stop: int) -> Tuple[int, int]:
        """The elements of global flat range ``[start, stop)`` of parameter
        ``i`` that this rank holds, as a range of its shard's flat order."""
        shape, dim, first, length = self._param_layout()[i]
        return (_local_count(shape, dim, first, length, start),
                _local_count(shape, dim, first, length, stop))

    def audit_weight(self, i: int, b: int) -> List[int]:
        """Rank 0: the ranks whose shard of weight-audit block ``b`` of
        parameter ``i`` no longer matches its load-time digest (on a
        sharded engine one command and one ``all_gather``)."""
        ok = self._ops["audit_weight"](np.asarray([i, b], np.int64))
        return [r for r, flag in enumerate(ok.cpu().tolist()) if not flag]

    def _audit_weight(self, ib):
        i, b = (int(x) for x in ib.cpu())
        ok = self.engine._integrity.block_ok(i, b)
        flag = torch.tensor([int(ok)], dtype=torch.int64)
        return flag if self.channel is None \
            else torch.cat(self._all_gather(flag))

    def flip_weight(self, i: int, flat: int, bit: int):
        """``bit-flip-weight``: XOR bit ``bit`` of global element ``flat``
        of parameter ``i`` in place, on every rank that holds it."""
        return self._ops["flip_weight"](np.asarray([i, flat, bit], np.int64))

    @torch.no_grad()
    def _flip_weight(self, args):
        i, flat, bit = (int(x) for x in args.cpu())
        lo, hi = self.local_span(i, flat, flat + 1)
        if hi > lo:
            flip_bit(self.engine._params[i], lo, bit)

    def shadow(self, ids: np.ndarray) -> torch.Tensor:
        """The integrity sentinel's contiguous forward of ``ids`` [S] on
        every rank: the last position's f32 logits [V]."""
        return self._ops["shadow"](np.asarray(ids, np.int64)[None, :])

    @torch.no_grad()
    def _shadow(self, ids):
        return self.engine.model(ids)[0, -1].float()

    # ---------------------------------------------------------- programs
    def _count(self, kind: str):
        m = self.engine._m
        if m is not None:
            m.compiled.labels(kind=kind).inc()

    def get_decode(self, nb: int, k: int, sampling: bool) -> Callable:
        key = (nb, k, sampling)
        fn = self.decode_fns.get(key)
        if fn is None:
            self._count("decode")
            fn = self.decode_fns[key] = _Program(
                self, "decode", (nb, k, int(sampling)),
                self._decode_chain(nb, k * self.engine.chunk_size, sampling))
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
            fn = self.prefill_fns[key] = _Program(
                self, "prefill", (bucket[0], bucket[1], int(sampling),
                                  int(suffix)),
                self.engine._make_prefill_raw(sampling, suffix))
        return fn

    def get_mixed(self, nb: int, sampling: bool) -> Callable:
        """Chunked prefill's mixed chunk+decode step. Eager."""
        key = (nb, sampling)
        fn = self.mixed_fns.get(key)
        if fn is None:
            self._count("mixed")
            from .engine import make_mixed_step_fn

            fn = self.mixed_fns[key] = _Program(
                self, "mixed", (nb, int(sampling)),
                make_mixed_step_fn(self.engine, sampling))
        return fn

    def note_verify_shape(self, nb: int, sampling: bool):
        """Count a verify program the first time its padded batch ``nb``
        runs (the reference compiles one per shape)."""
        if (nb, sampling) not in self._verify_shapes:
            self._verify_shapes.add((nb, sampling))
            self._count("verify")

    def get_verify(self, sampling: bool) -> Callable:
        """The spec-decode verify step (one callable per sampling flag; it
        captures one graph per batch bucket its arguments bring)."""
        fn = self.verify_fns.get(sampling)
        if fn is None:
            from .spec.verifier import make_verify_fn

            fn = self.verify_fns[sampling] = self.wrap_verify(
                make_verify_fn(self.engine, sampling), sampling)
        return fn

    def wrap_verify(self, raw: Callable, sampling: bool) -> Callable:
        """The verify step as a program: at tp/ep > 1, rank 0's call goes
        out as a command first."""
        return _Program(self, "verify", (int(sampling),), raw)

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
    def capture_page_row(pages_flat: List[torch.Tensor],
                         page: int) -> torch.Tensor:
        """One page of every pool buffer as one contiguous byte row
        (``uint8``, ``pages_flat`` order), gathered on the current stream
        in one concatenation: the host tier moves a page as one copy."""
        return torch.cat([b[int(page)].reshape(-1).view(torch.uint8)
                          for b in pages_flat])

    def fetch_param_slice(self, i: int, start: int,
                          stop: Optional[int]) -> np.ndarray:
        """Host copy of elements ``[start, stop)`` (row-major flat order;
        ``stop=None``: to the end) of parameter ``i`` of
        ``Engine._params``, as raw words (``host_words``): the bytes the
        programs consume, in the reference's byte order. On a sharded
        engine: of this rank's shard (:meth:`local_span` maps a global
        range onto it)."""
        flat = self.engine._params[i].detach().reshape(-1)
        return host_words(flat[int(start):None if stop is None
                               else int(stop)])
