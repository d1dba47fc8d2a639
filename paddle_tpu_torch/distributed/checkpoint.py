"""Checkpoints with an atomic commit, after
``paddle_tpu/distributed/checkpoint.py``, saved by one process or by
every rank of a group.

The on-disk format is the reference's, so a checkpoint written by either
package loads in the other: one ``.npy`` file a tensor
(``<name>.<hash>.p0.c0.npy``) and a ``metadata.p0.json`` marker that
records each tensor's global shape, dtype and chunks (offset, shape,
file, blake2b-128 digest of the file's bytes), the small Python values
under ``objects``, and a self-digest. The reader merges every
``metadata.p*.json`` and assembles each tensor from its chunks, so a
reference checkpoint of several chunks loads here too.

Across processes (``save_state_dict(..., group=g)``, every member
calling it), as the reference: member ``i`` of ``n`` writes its chunks
as ``<name>.<hash>.p<i>.c0.npy`` and its own marker
``metadata.p<i>.json`` (``process_index`` i, ``process_count`` n) into
one staging directory named after the final path
(``.tmp-shared-<name>``). A value that is a :class:`Shard` is this
rank's block of a larger tensor (its offset and the global shape); a
plain tensor is the same on every member and only member 0 writes it.
The member that sees all ``n`` markers and claims the commit (an
exclusive create, so exactly one does) renames the directory into
place. A synchronous save then waits for the whole group and raises on
every member unless the checkpoint committed, so a member that failed
before its marker leaves a staging directory the reader refuses as
incomplete.

bf16: numpy has no bfloat16 without ``ml_dtypes``. The port writes a bf16
tensor's chunk as its uint16 bits (``dtype`` ``"bfloat16"`` in the
marker) and reads 16-bit words back as bf16, the reference's ``V2``
chunks included. (The reference's own loader cannot cast such a chunk
into ``np.dtype("bfloat16")``.)

The commit protocol: every file is written into a sibling staging
directory ``.tmp-<uuid>`` and fsynced, the marker last (tmp + fsync +
``os.replace``), then the directory is renamed to its final path and
the parent fsynced. A crash at any point leaves the previous checkpoint
and an orphaned ``.tmp-*`` (``gc_staging`` reclaims it), or the new one
committed. ``load_state_dict`` re-hashes each file before using it and
raises the typed ``IntegrityError`` on a mismatch.

Fault points (``testing.faultinject``): ``ckpt-io-error`` raises
``OSError`` before each data file's write and before the marker;
``slow-ckpt-write`` sleeps ``delay_ms`` before the first write;
``bit-flip-ckpt`` flips one bit of one staged file after its digest was
taken and before the marker lands, so the checkpoint commits complete
but corrupt.
"""
from __future__ import annotations

import glob
import hashlib
import io
import json
import os
import shutil
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..serialization import BF16, _from_host, _host_array

__all__ = ["save_state_dict", "load_state_dict", "verify_contents", "Shard",
           "AsyncSaveHandle", "AsyncCheckpointer", "step_dir", "parse_step",
           "is_complete", "list_steps", "latest_step", "write_manifest",
           "read_manifest", "gc_staging", "retain_last", "STAGE_PREFIX",
           "MANIFEST_NAME"]

STAGE_PREFIX = ".tmp-"
_CLAIM = "COMMIT.claim"
TRASH_PREFIX = ".trash-"
MANIFEST_NAME = "MANIFEST.json"
_STEP_PREFIX = "step-"


def _sanitize(name: str) -> str:
    """Filesystem-safe, collision-free: separators become '_' and a short
    hash of the original name tells 'a/b' from 'a_b'."""
    safe = name.replace("/", "_").replace("\\", "_")
    tag = hashlib.sha1(name.encode()).hexdigest()[:8]
    return f"{safe}.{tag}"


class Shard(NamedTuple):
    """One rank's block of a tensor of ``global_shape``, at ``offset``
    (one int a dim)."""
    data: Any
    offset: Tuple[int, ...]
    global_shape: Tuple[int, ...]


def _jsonable(v):
    """numpy scalars as Python ones, through containers."""
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


def _fsync_fileobj(f):
    f.flush()
    os.fsync(f.fileno())


def _integrity_error(message: str):
    from ..inference.errors import IntegrityError

    return IntegrityError(message)


def _count_integrity(ok: bool, target: str = "checkpoint"):
    """``paddle_tpu_integrity_checks_total{target}`` and, on a mismatch,
    ``..._failures_total{target}``, as the reference counts them."""
    from ..observability import counter

    counter("paddle_tpu_integrity_checks_total",
            "data-integrity verifications performed, by audit target",
            labelnames=("target",)).labels(target=target).inc()
    if not ok:
        counter("paddle_tpu_integrity_failures_total",
                "data-integrity verifications that FAILED, by audit "
                "target", labelnames=("target",)).labels(
                    target=target).inc()


def _meta_digest(meta: Dict[str, Any]) -> str:
    """blake2b of the marker's canonical JSON without its own digest."""
    clean = {k: v for k, v in meta.items() if k != "self_digest"}
    return hashlib.blake2b(json.dumps(clean, sort_keys=True).encode(),
                           digest_size=16).hexdigest()


def _load_meta(path: str) -> Dict[str, Any]:
    """Read and verify one marker (one without a self-digest loads
    unverified)."""
    with open(path) as f:
        meta = json.load(f)
    want = meta.get("self_digest")
    if want is not None:
        got = _meta_digest(meta)
        _count_integrity(got == want)
        if got != want:
            raise _integrity_error(
                f"checkpoint metadata self-digest mismatch for {path} — "
                "the marker's content changed after commit")
    return meta


class _HashingWriter:
    """Digests every byte on its way to the file (npy header included),
    exactly what the loader re-hashes."""

    def __init__(self, f):
        self._f = f
        self._h = hashlib.blake2b(digest_size=16)

    def write(self, data):
        self._h.update(data)
        return self._f.write(data)

    def hexdigest(self) -> str:
        return self._h.hexdigest()


def _flip_staged_bit(plan, stage: str, files):
    """``bit-flip-ckpt``: XOR one bit of one staged file, chosen by the
    point's seeded stream (``offset=`` / ``bit=`` pin it)."""
    files = sorted(files)
    if not files:
        return
    victim = files[plan.draw("bit-flip-ckpt", len(files))]
    path = os.path.join(stage, victim)
    size = os.path.getsize(path)
    if size <= 0:
        return
    off = int(plan.param("bit-flip-ckpt", "offset", -1.0))
    if not 0 <= off < size:
        off = plan.draw("bit-flip-ckpt", size)
    bit = int(plan.param("bit-flip-ckpt", "bit", -1.0))
    if not 0 <= bit < 8:
        bit = plan.draw("bit-flip-ckpt", 8)
    with open(path, "r+b") as f:
        f.seek(off)
        byte = f.read(1)
        f.seek(off)
        f.write(bytes([byte[0] ^ (1 << bit)]))
        _fsync_fileobj(f)


def _fsync_dir(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_json_atomic(data, path: str):
    tmp = f"{path}.tmp-{uuid.uuid4().hex[:8]}"
    with open(tmp, "w") as f:
        json.dump(data, f)
        _fsync_fileobj(f)
    os.replace(tmp, path)


def _resolve_plan(fault_plan):
    from ..testing.faultinject import FaultPlan, plan_from_flags

    if fault_plan is not None:
        return FaultPlan.from_spec(fault_plan)
    return plan_from_flags()


def is_complete(path: str) -> bool:
    """The reader's commit predicate: every process's marker is present
    (the first marker records how many there are)."""
    markers = sorted(glob.glob(os.path.join(path, "metadata.p*.json")))
    if not markers:
        return False
    try:
        with open(markers[0]) as f:
            expect = int(json.load(f).get("process_count", 1))
    except (OSError, ValueError):
        return False
    return len(markers) >= expect


def _swap_into_place(stage: str, final: str):
    """Promote the complete staging dir to the final path (an older dir
    there goes to the trash first)."""
    trash = None
    if os.path.exists(final):
        trash = f"{final}{TRASH_PREFIX}{uuid.uuid4().hex[:8]}"
        os.rename(final, trash)
    os.rename(stage, final)
    if trash is not None:
        shutil.rmtree(trash, ignore_errors=True)
    _fsync_dir(os.path.dirname(os.path.abspath(final)) or ".")


def _marker_count(path: str) -> int:
    return len(glob.glob(os.path.join(path, "metadata.p*.json")))


def _claim_commit(stage: str) -> bool:
    """True for exactly one caller: the one whose exclusive create of the
    claim file succeeds."""
    try:
        fd = os.open(os.path.join(stage, _CLAIM),
                     os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return False
    os.close(fd)
    return True


def save_state_dict(state_dict: Dict[str, Any], path: str,
                    async_save: bool = False, fault_plan=None,
                    on_commit: Optional[Callable[[str], None]] = None,
                    group=None):
    """Write ``{name: tensor | ndarray | Shard | small value}`` as a
    checkpoint directory at ``path`` by the atomic commit. The tensors
    are copied to the host now, so later updates of the live ones do not
    leak in; with ``async_save`` the files are written on a thread.
    ``on_commit(path)`` runs in the writer that commits, right after the
    rename. ``group`` (a ``Group`` of more than one rank): every member
    calls this and writes its part (see the module doc); a synchronous
    save returns on every member once the checkpoint committed. Returns
    an :class:`AsyncSaveHandle` (already done unless ``async_save``)."""
    plan = _resolve_plan(fault_plan)
    pidx, pcount = (0, 1) if group is None else (group.rank, group.nranks)
    final = os.path.abspath(path)
    parent = os.path.dirname(final) or "."
    if pcount > 1:
        stage = os.path.join(parent, f"{STAGE_PREFIX}shared-"
                                     f"{os.path.basename(final)}")
        from .collective import barrier

        if pidx == 0:  # a crashed save's leftovers must not count
            shutil.rmtree(stage, ignore_errors=True)
        barrier(group)
    else:
        stage = os.path.join(parent, f"{STAGE_PREFIX}{uuid.uuid4().hex}")
    write_plan: List[Dict[str, Any]] = []
    meta: Dict[str, Any] = {"tensors": {}, "objects": {},
                            "format": "paddle_tpu.dist_ckpt.v1",
                            "process_index": pidx, "process_count": pcount}
    for name, v in state_dict.items():
        offset = gshape = None
        if isinstance(v, Shard):
            offset, gshape = list(v.offset), list(v.global_shape)
            v = v.data
        elif pidx and isinstance(v, (torch.Tensor, np.ndarray)):
            continue  # a replicated tensor: member 0 writes it
        if isinstance(v, torch.Tensor):
            data, dtype = _host_array(v)
        elif isinstance(v, np.ndarray):
            data, dtype = np.ascontiguousarray(v), str(v.dtype)
        else:
            meta["objects"][name] = _jsonable(v)
            continue
        fname = f"{_sanitize(name)}.p{pidx}.c0.npy"
        entry = {"offset": offset or [0] * data.ndim,
                 "shape": list(data.shape), "file": fname}
        write_plan.append({"file": fname, "data": data, "entry": entry})
        meta["tensors"][name] = {"global_shape": gshape or list(data.shape),
                                 "dtype": dtype, "chunks": [entry]}

    def _maybe_fault():
        if plan is not None and plan.fire("ckpt-io-error"):
            raise OSError("injected checkpoint I/O error (ckpt-io-error)")

    def _write():
        if plan is not None and plan.fire("slow-ckpt-write"):
            time.sleep(plan.param("slow-ckpt-write", "delay_ms", 20.0) / 1e3)
        os.makedirs(stage, exist_ok=True)
        for item in write_plan:
            _maybe_fault()
            with open(os.path.join(stage, item["file"]), "wb") as f:
                hw = _HashingWriter(f)
                np.save(hw, item["data"], allow_pickle=False)
                item["entry"]["digest"] = hw.hexdigest()
                _fsync_fileobj(f)
        if plan is not None and plan.fire("bit-flip-ckpt"):
            _flip_staged_bit(plan, stage, [it["file"] for it in write_plan])
        _maybe_fault()
        meta["self_digest"] = _meta_digest(meta)
        _write_json_atomic(meta, os.path.join(stage,
                                              f"metadata.p{pidx}.json"))
        if pcount > 1 and (_marker_count(stage) < pcount
                           or not _claim_commit(stage)):
            return  # another member commits
        if pcount > 1:
            os.remove(os.path.join(stage, _CLAIM))
        _fsync_dir(stage)
        _swap_into_place(stage, final)
        if on_commit is not None:
            on_commit(final)

    if async_save:
        handle = AsyncSaveHandle(None, path=final)
        t = threading.Thread(target=handle._run, args=(_write,),
                             daemon=True, name="ckpt-writer")
        handle._thread = t
        t.start()
        return handle
    if pcount <= 1:
        _write()
        return AsyncSaveHandle(None, path=final)
    from .collective import barrier

    try:
        _write()
    finally:
        barrier(group)  # every member's marker is down, or never will be
    if not is_complete(final):
        raise RuntimeError(
            f"checkpoint {final} did not commit: "
            f"{_marker_count(stage)}/{pcount} process markers in {stage}")
    return AsyncSaveHandle(None, path=final)


def _read_chunk(path: str, chunk: Dict[str, Any], tensor: str):
    """One chunk's array, its recorded digest verified before the bytes
    are parsed."""
    fp = os.path.join(path, chunk["file"])
    with open(fp, "rb") as f:
        raw = f.read()
    want = chunk.get("digest")
    if want is not None:
        got = hashlib.blake2b(raw, digest_size=16).hexdigest()
        _count_integrity(got == want)
        if got != want:
            raise _integrity_error(
                f"checkpoint content digest mismatch for tensor {tensor!r} "
                f"file {chunk['file']!r} under {path} (expected {want}, "
                f"file hashes to {got}) — silent data corruption between "
                "save and load; restore from an older step")
    return np.load(io.BytesIO(raw), allow_pickle=False)


def _markers(path: str) -> List[Dict[str, Any]]:
    metas = [_load_meta(mp) for mp in
             sorted(glob.glob(os.path.join(path, "metadata.p*.json")))]
    if not metas:
        raise FileNotFoundError(
            f"no metadata.p*.json under {path} — incomplete or not a "
            "checkpoint")
    return metas


def verify_contents(path: str) -> int:
    """Re-hash every data file of a committed checkpoint against its
    digest without building arrays; the number of files checked (markers
    included). Raises ``IntegrityError`` on the first mismatch."""
    metas = _markers(path)
    checked = len(metas)
    for m in metas:
        for name, info in m.get("tensors", {}).items():
            for c in info.get("chunks", ()):
                want = c.get("digest")
                if want is None:
                    continue
                with open(os.path.join(path, c["file"]), "rb") as f:
                    got = hashlib.blake2b(f.read(),
                                          digest_size=16).hexdigest()
                _count_integrity(got == want)
                if got != want:
                    raise _integrity_error(
                        f"checkpoint content digest mismatch for tensor "
                        f"{name!r} file {c['file']!r} under {path}")
                checked += 1
    return checked


def load_state_dict(path: str) -> Dict[str, Any]:
    """``{name: CPU tensor | value}`` of a checkpoint (of either package),
    every file's digest verified before use."""
    metas = _markers(path)
    expect = metas[0].get("process_count", 1)
    if len(metas) < expect:
        raise FileNotFoundError(
            f"checkpoint incomplete: {len(metas)}/{expect} process commit "
            f"markers present under {path}")
    out: Dict[str, Any] = {}
    tensors: Dict[str, Any] = {}
    for m in metas:
        out.update(m.get("objects", {}))
        for name, info in m.get("tensors", {}).items():
            slot = tensors.setdefault(name, {
                "global_shape": info["global_shape"],
                "dtype": info["dtype"], "chunks": []})
            slot["chunks"].extend(info["chunks"])
    for name, info in tensors.items():
        bf16 = info["dtype"] == BF16
        full = np.zeros(tuple(info["global_shape"]),
                        np.uint16 if bf16 else np.dtype(info["dtype"]))
        for c in info["chunks"]:
            sl = tuple(slice(o, o + s) for o, s in zip(c["offset"],
                                                       c["shape"]))
            data = _read_chunk(path, c, name)
            full[sl] = data.view(np.uint16) if bf16 else data
        out[name] = _from_host(full, info["dtype"])
    return out


# ---------------------------------------------------------------------------
# the checkpoint root: step-<N> dirs, MANIFEST.json, retention, GC
# ---------------------------------------------------------------------------

def step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"{_STEP_PREFIX}{int(step)}")


def parse_step(name: str) -> Optional[int]:
    base = os.path.basename(os.path.normpath(name))
    if not base.startswith(_STEP_PREFIX):
        return None
    try:
        return int(base[len(_STEP_PREFIX):])
    except ValueError:
        return None


def list_steps(root: str) -> List[int]:
    """Committed steps under ``root``, ascending (each dir's markers
    re-checked)."""
    try:
        entries = os.listdir(root)
    except OSError:
        return []
    steps = []
    for e in entries:
        s = parse_step(e)
        if s is not None and is_complete(os.path.join(root, e)):
            steps.append(s)
    return sorted(steps)


def latest_step(root: str) -> Optional[int]:
    steps = list_steps(root)
    return steps[-1] if steps else None


def write_manifest(root: str) -> Dict[str, Any]:
    """Rewrite ``MANIFEST.json`` (committed steps and the latest one) for
    tools that should not need the completeness predicate."""
    steps = list_steps(root)
    data = {"format": "paddle_tpu.ckpt_root.v1", "steps": steps,
            "latest": steps[-1] if steps else None}
    _write_json_atomic(data, os.path.join(root, MANIFEST_NAME))
    return data


def read_manifest(root: str) -> Optional[Dict[str, Any]]:
    try:
        with open(os.path.join(root, MANIFEST_NAME)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def gc_staging(root: str, in_flight: Optional[set] = None) -> List[str]:
    """Remove orphaned ``.tmp-*`` staging and ``.trash-*`` dirs under
    ``root``, sparing the ``in_flight`` ones."""
    in_flight = {os.path.abspath(p) for p in (in_flight or ())}
    try:
        entries = os.listdir(root)
    except OSError:
        return []
    removed = []
    for e in entries:
        if not (e.startswith(STAGE_PREFIX) or TRASH_PREFIX in e):
            continue
        full = os.path.abspath(os.path.join(root, e))
        if full in in_flight or not os.path.isdir(full):
            continue
        shutil.rmtree(full, ignore_errors=True)
        removed.append(full)
    return removed


def retain_last(root: str, n: int) -> List[int]:
    """Keep the newest ``n`` committed steps; older ones are renamed to the
    trash first, so discovery never sees a half-deleted one. Returns the
    dropped steps."""
    if n is None or n <= 0:
        return []
    steps = list_steps(root)
    drop = steps[:-n] if len(steps) > n else []
    for s in drop:
        src = step_dir(root, s)
        trash = f"{src}{TRASH_PREFIX}{uuid.uuid4().hex[:8]}"
        try:
            os.rename(src, trash)
        except OSError:  # gone already: nothing to drop
            continue
        shutil.rmtree(trash, ignore_errors=True)
    return drop


# ---------------------------------------------------------------------------
# async handles
# ---------------------------------------------------------------------------

class AsyncSaveHandle:
    """One background checkpoint write. A writer's exception is re-raised
    by every ``wait()``; ``done`` says only that the attempt is over,
    ``failed`` / ``succeeded`` / ``exception()`` say how."""

    def __init__(self, thread: Optional[threading.Thread],
                 path: Optional[str] = None):
        self._thread = thread
        self._error: Optional[BaseException] = None
        self.path = path

    def _run(self, fn):
        try:
            fn()
        except BaseException as e:  # surfaced by wait(), never swallowed
            self._error = e

    @property
    def done(self) -> bool:
        return self._thread is None or not self._thread.is_alive()

    @property
    def failed(self) -> bool:
        return self.done and self._error is not None

    @property
    def succeeded(self) -> bool:
        return self.done and self._error is None

    def exception(self) -> Optional[BaseException]:
        return self._error

    def wait(self):
        if self._thread is not None:
            self._thread.join()
        if self._error is not None:
            raise RuntimeError(
                "async checkpoint write failed") from self._error


class AsyncCheckpointer:
    """One background writer at a time: a new save joins the previous one
    first (re-raising its failure), so writes land in order and never
    interleave."""

    def __init__(self):
        self._inflight: Optional[AsyncSaveHandle] = None
        self._lock = threading.Lock()

    def save(self, state_dict, path, fault_plan=None,
             on_commit=None) -> AsyncSaveHandle:
        with self._lock:
            if self._inflight is not None:
                prev, self._inflight = self._inflight, None
                prev.wait()
            self._inflight = save_state_dict(
                state_dict, path, async_save=True, fault_plan=fault_plan,
                on_commit=on_commit)
            return self._inflight

    def wait(self):
        with self._lock:
            if self._inflight is not None:
                try:
                    self._inflight.wait()
                finally:
                    self._inflight = None
