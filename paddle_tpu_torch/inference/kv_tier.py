"""Host-memory spill tier under the paged KV pool, after
``paddle_tpu/inference/kv_tier.py``.

With the prefix cache on, idle cached pages are reclaimed under pool
pressure, and their reuse is lost exactly when the working set outgrows
the pool. With ``kv_host_pages=N`` reclamation DEMOTES instead: the
page's bytes move to a pinned host slab of N pages and the cache entry
survives; a later hash-chain hit PROMOTES them back, digest-verified.

* **Demote (device → host).** The allocator hands the victim's page to a
  new owner on the host, and that owner's prefill or graph replay may be
  enqueued right after. The reference can defer its gather to the one call
  every program reaches the pool through; the port's programs write the
  page buffers in place and its graphs replay over them by address, so
  there is no such choke point. Ordering comes from the stream instead:
  :meth:`HostTier.demote` enqueues the page's gather, every buffer's page
  concatenated into one contiguous byte row (``capture_page_row``), on the
  engine's current stream before ``alloc_page`` returns, so every later
  write into the page runs after it. Gathers collect into waves; a wave
  goes to the spill worker with an event recorded after its gathers. The
  worker's copy stream waits on that event and copies each row into its
  slab row (one copy a page); the worker blocks on the copy's own event
  (never on the device, which would wait for the engine's replays) and
  only then drops the staging rows, which the caching allocator may then
  hand out again. It then digests each page's row (blake2b over k, v,
  scale per layer, ``pages_flat`` order: the reference's bytes in its
  order), a wave's pages on a few threads at once, and posts the
  completion; the entry rides ``spilling → host``.
* **Promote (host → device).** A lookup that reaches demoted blocks cannot
  splice them: that admission recomputes the suffix (a miss, never a
  stall), but it queues a promote. The worker re-hashes the slab rows
  against the demotion digest (a byte flipped in host memory, the
  ``kv-spill-corrupt`` point, fails here and costs an invalidate and a
  recompute) and posts the verdict. At the next drain the engine thread
  allocates device pages and restores the verified rows: pinned rows to
  the device with ``non_blocking=True``, then ``index_copy_`` into the
  pool (``ModelRunner.restore_page_rows``), all on the engine's stream, so a
  promotion lands before the splice's suffix prefill reads it. A slab row
  returns to the free list only once its copy's event has fired. With the
  integrity sentinel on, the page's checksum travels with its bytes and
  is adopted on the new page.
* **Recompute as promote.** A demoted block recomputed before its
  promotion lands re-binds to the fresh page at registration, and the
  in-flight promotion dies by its job token: both paths give the same
  bytes, so streams are identical with the tier on and off.

The prefix cache and the allocator stay engine-thread only: the worker
talks through a job queue (in) and a completion deque (out, drained at
step and admission boundaries). The slab (pinned, allocated once here)
is written only by the spill job assigned a row and read by promote jobs;
jobs run in order, so no row is touched by two jobs at once. On the CPU
every copy is a plain synchronous one: the tensors lie there, and there
is no stream to order.

``reset()`` (pool reset after a step fault) drops the whole tier;
``stop()`` (front-end drain or shutdown, quarantine) ends the worker.

On the card every spill wave and every restore batch is timed by a pair of
CUDA events around its copies, on the stream that runs them
(``HostTier.copy_log``, the newest 256: direction, pages, bytes, ms); a
restore's time includes the gaps while the host enqueues its copies.
"""
from __future__ import annotations

import hashlib
import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["HostTier", "capture_handoff_spill", "page_bytes"]

# handoff captures gather at most this many pages at a time
_HANDOFF_COPY_WIDTH = 32


def page_bytes(a) -> memoryview:
    """The raw bytes of one page row (a torch tensor on the host, or a
    numpy array of the reference's payload), for a digest."""
    if isinstance(a, torch.Tensor):
        a = a.detach().contiguous()
        if a.dtype.is_floating_point:
            a = a.view(torch.uint8)
        return memoryview(a.numpy()).cast("B")
    return memoryview(np.ascontiguousarray(a)).cast("B")


def capture_handoff_spill(engine, tokens) -> Optional[dict]:
    """The prompt's cached KV pages as a handoff payload: per page its
    buffer rows in ``pages_flat`` order (host tensors), a blake2b digest per
    page (chain order from the root, so the importer can stop at the first
    mismatch) and the sentinel's checksums. Engine thread; it waits for the
    device-to-host copy (the front end runs it through ``call``). Only the
    HBM-resident chain prefix ships. None when nothing is cached."""
    coord = getattr(engine, "_cache", None)
    pc = getattr(engine, "_pcache", None)
    if coord is None or pc is None:
        return None
    pages, matched = pc.lookup(tokens, touch=False)
    if not pages:
        return None
    ig = getattr(engine, "_integrity", None)
    rows_per_page: List[List[torch.Tensor]] = []
    for off in range(0, len(pages), _HANDOFF_COPY_WIDTH):
        chunk = pages[off:off + _HANDOFF_COPY_WIDTH]
        idx = torch.as_tensor(chunk, dtype=torch.int64, device=engine.device)
        host = [h.cpu() for h in engine.runner.capture_pages(
            coord.pages_flat(), idx)]
        rows_per_page += [[h[j] for h in host] for j in range(len(chunk))]
    digests, nbytes = [], 0
    for rows in rows_per_page:
        d = hashlib.blake2b(digest_size=16)
        for a in rows:
            b = page_bytes(a)
            d.update(b)
            nbytes += b.nbytes
        digests.append(d.hexdigest())
    toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
    return {
        "tokens": [int(t) for t in toks[:matched]],
        "page_size": int(pc.page_size),
        "digests": digests,
        "pages": rows_per_page,
        "dev_sums": [None if ig is None else ig.sum_of_page(p)
                     for p in pages],
        "nbytes": int(nbytes),
    }


class HostTier:
    """The host spill tier of one engine (module docstring). Owned by the
    ``CacheCoordinator``; every method but the worker loop runs on the
    engine thread."""

    # pages a demotion wave or a restore batch moves at most
    COPY_WIDTH = 32
    # a splice may wait this long for in-flight promotions of its chain,
    # far below the recompute they save; a slower promote (a slow host,
    # the slow-host-copy point) degrades that admission to a miss
    PROMOTE_WAIT_S = 0.02

    def __init__(self, coord, host_pages: int):
        self.coord = coord
        self.engine = coord.engine
        self.host_pages = int(host_pages)
        self.device = self.engine.device
        self._cuda = self.device.type == "cuda"
        self._free_hslots: List[int] = list(range(self.host_pages - 1,
                                                  -1, -1))
        self._digest: Dict[int, bytes] = {}    # hslot -> blake2b digest
        self._dev_sum: Dict[int, int] = {}     # hslot -> sentinel checksum
        self._gen = 0                          # bumped by reset() / stop()
        # the slab: one pinned byte row a host page, made once (a pinned
        # allocation per job would be slow, and a driver call during a
        # graph capture); a row holds every pool buffer's page in
        # pages_flat order, the first buffer's bytes first
        flat = coord.pages_flat()
        self._first_bytes = flat[0][0].numel() * flat[0].element_size()
        self._slab = torch.empty(
            (self.host_pages, sum(b[0].numel() * b.element_size()
                                  for b in flat)),
            dtype=torch.uint8, pin_memory=self._cuda)
        # a wave's digests run on a few threads (blake2b lets go of the
        # interpreter lock): at 8 MiB a page one thread is the tier's limit
        self._hashers = ThreadPoolExecutor(
            max(1, min(8, os.cpu_count() or 1)),
            thread_name_prefix="paddle-kv-digest")
        self._copy_stream = torch.cuda.Stream(self.device) if self._cuda \
            else None
        self._q: "queue.Queue" = queue.Queue()
        self._done: deque = deque()            # worker -> engine thread
        self._done_evt = threading.Event()     # set on every completion
        self._wave: List = []                  # demotions gathered, unshipped
        self._wave_rows: List[List[torch.Tensor]] = []
        self._held: List = []                  # (event, hslots) of restores
        self._timed: List = []                 # restores whose ms are due
        # (direction "d2h" | "h2d", pages, bytes, device ms), card only
        self.copy_log: deque = deque(maxlen=256)
        self._stopped = False
        # plain-int telemetry, mirrored into the registry where recorded
        self.demotions = 0   # pages spilled device -> host
        self.promotions = 0  # pages restored host -> device
        self.hits = 0        # lookups that started promotions
        self.drops = 0       # demoted blocks lost (capacity, corruption)
        coord.pcache.owner_release = self.release_entry
        self._worker = threading.Thread(
            target=self._worker_loop, name="paddle-kv-spill", daemon=True)
        self._worker.start()

    # ------------------------------------------------------------ metrics
    @property
    def _m(self):
        return getattr(self.engine, "_m", None)

    def _update_occupancy(self):
        m = self._m
        if m is not None:
            m.kv_tier_pages.labels(tier="host").set(
                self.host_pages - len(self._free_hslots))
            m.kv_tier_pages.labels(tier="hbm").set(
                self.coord.pcache.n_pages)

    def _record(self, timing: bool = False, stream=None):
        """An event on ``stream`` (default the engine's current one); None
        on the CPU."""
        if not self._cuda:
            return None
        evt = torch.cuda.Event(enable_timing=timing)
        evt.record(stream or torch.cuda.current_stream(self.device))
        return evt

    # ----------------------------------------------------- engine thread
    def demote(self, page: int, ent) -> None:
        """Spill ``ent``, whose bytes still sit in device page ``page``,
        which the allocator is handing to a new owner: gather the page now,
        on the current stream (every later write into it runs after), and
        ship the wave once it is full. With the host full and nothing
        droppable, the block is dropped (the un-tiered eviction)."""
        hslot = self._alloc_hslot()
        if hslot is None:
            self.drops += 1
            if self._m is not None:
                self._m.kv_drops.inc()
            self._drop_entry(ent)
            return
        ig = getattr(self.engine, "_integrity", None)
        # read now: the allocator forgets the sum as the page re-homes
        dev_sum = None if ig is None else ig.sum_of_page(page)
        ent.hslot = hslot
        self.demotions += 1
        if self._m is not None:
            self._m.kv_demotions.inc()
        self._wave_rows.append(self.engine.runner.capture_page_row(
            self.coord.pages_flat(), page))
        self._wave.append((ent, ent.job, hslot, dev_sum))
        if len(self._wave) >= self.COPY_WIDTH:
            self.flush_captures()
        self._update_occupancy()

    def flush_captures(self) -> None:
        """Ship the gathered wave to the worker, with an event recorded
        after its gathers."""
        if not self._wave:
            return
        items, rows = self._wave, self._wave_rows
        self._wave, self._wave_rows = [], []
        self._q.put(("spill", self._gen, items, rows, self._record()))

    def request_promote(self, entries) -> None:
        """Queue promotions for the host-resident entries a lookup just
        matched (entries mid-spill or promoting already are left alone).
        Never blocks."""
        queued = False
        for ent in entries:
            if ent.tier != "host" or ent.hslot is None:
                continue
            ent.tier = "promoting"
            self._q.put(("promote", self._gen, ent, ent.job, ent.hslot,
                         self._digest.get(ent.hslot),
                         self._dev_sum.get(ent.hslot), time.perf_counter()))
            queued = True
        if queued:
            self.hits += 1
            if self._m is not None:
                self._m.kv_tier_hits.inc()

    def await_promotions(self, entries,
                         budget_s: Optional[float] = None) -> None:
        """Wait at most ``budget_s`` (default ``PROMOTE_WAIT_S``) for the
        in-flight promotions of ``entries``, draining as they complete; a
        promotion still in flight after it rides as a miss."""
        budget = self.PROMOTE_WAIT_S if budget_s is None else budget_s
        deadline = time.monotonic() + budget
        while any(e.tier == "promoting" for e in entries):
            left = deadline - time.monotonic()
            if left <= 0:
                return
            self._done_evt.wait(left)
            self._done_evt.clear()
            self.drain()

    def drain(self) -> None:
        """Apply the worker's completions (step and admission boundaries):
        landed spills become ``host`` entries, verified promotions restore
        into the pool in batches, failed ones are contained. Ships the
        open wave and returns the slab rows whose restores finished."""
        self.flush_captures()
        self._release_held()
        pc = self.coord.pcache

        def current(ent, token):
            return ent.job == token and pc._by_key.get(ent.key) is ent

        promotes = []
        while True:
            try:
                msg = self._done.popleft()
            except IndexError:
                break
            kind, gen = msg[0], msg[1]
            if gen != self._gen:
                continue  # predates a reset; owner_release cleaned up
            if kind == "spill":
                for ent, token, hslot, digest, dev_sum in msg[2]:
                    if not current(ent, token):
                        continue  # moved on (a recompute re-bound it)
                    ent.tier = "host"
                    self._digest[hslot] = digest
                    if dev_sum is not None:
                        self._dev_sum[hslot] = dev_sum
            elif kind == "promote":
                _, _, ent, token, hslot, dev_sum, dt = msg
                if current(ent, token):
                    promotes.append((ent, hslot, dev_sum, dt))
            else:  # "promote-bad" / "fault": doubt the block
                ent, token = msg[2], msg[3]
                if current(ent, token):
                    self._contain_bad(ent)
        if promotes:
            self._land_promotions(promotes)
        self._update_occupancy()

    def _land_promotions(self, promotes) -> None:
        """Restore a drain's verified promotions into fresh pool pages, on
        the engine's stream: the rows go to the device from the pinned
        slab, then into the pool in place."""
        pc = self.coord.pcache
        landed = []
        for ent, hslot, dev_sum, dt in promotes:
            page = self.coord.alloc_page()
            if page is None:
                ent.tier = "host"  # pool full: a later lookup asks again
                continue
            landed.append((ent, int(page), hslot, dev_sum, dt))
        if not landed:
            return
        pages_flat = self.coord.pages_flat()
        start = self._record(timing=True)
        w = self.COPY_WIDTH
        for off in range(0, len(landed), w):
            chunk = landed[off:off + w]
            rows = torch.empty((len(chunk), self._slab.shape[1]),
                               dtype=torch.uint8, device=self.device)
            for j, lan in enumerate(chunk):
                rows[j].copy_(self._slab[lan[2]], non_blocking=True)
            idx = torch.as_tensor([lan[1] for lan in chunk],
                                  dtype=torch.int64, device=self.device)
            self.engine.runner.restore_page_rows(pages_flat, idx, rows)
        # the rows are read by copies still in flight: their slots return
        # once the event after them has fired
        end = self._record(timing=True)
        self._held.append((end, [lan[2] for lan in landed]))
        if end is not None:
            self._timed.append((start, end, len(landed),
                                len(landed) * self._slab.shape[1]))
        ig = getattr(self.engine, "_integrity", None)
        for ent, page, hslot, dev_sum, dt in landed:
            self.coord.page_ref[page] = 0  # the entry owns it, idle
            self._digest.pop(hslot, None)
            self._dev_sum.pop(hslot, None)
            ent.hslot = None
            if not pc.promote(ent, page):
                self.coord.free_pages.append(page)  # raced out: no leak
                continue
            if ig is not None and dev_sum is not None:
                ig.adopt_page_sum(page, dev_sum)
            self.promotions += 1
            if self._m is not None:
                self._m.kv_promotions.inc()
                self._m.kv_promote_seconds.observe(dt)
        self._release_held()

    def _release_held(self):
        """Return the slab rows whose restore copies have finished (and log
        the finished restores' times)."""
        keep = []
        for evt, hslots in self._held:
            if evt is None or evt.query():
                self._free_hslots.extend(hslots)
            else:
                keep.append((evt, hslots))
        self._held = keep
        timed = []
        for start, end, n, nbytes in self._timed:
            if end.query():
                self.copy_log.append(("h2d", n, nbytes,
                                      start.elapsed_time(end)))
            else:
                timed.append((start, end, n, nbytes))
        self._timed = timed

    def _contain_bad(self, ent):
        """A promotion failed its digest (or the worker faulted on the
        job): the entry and its descendants drop, later lookups recompute.
        The damaged bytes never reached the pool."""
        self.drops += 1
        if self._m is not None:
            self._m.kv_drops.inc()
        self._drop_entry(ent)

    def _drop_entry(self, ent):
        """Remove ``ent`` and its descendants from the index; a device page
        a descendant still held goes back by its refcount."""
        ig = getattr(self.engine, "_integrity", None)
        for p in self.coord.pcache.invalidate_entry(ent):
            if ig is not None:
                ig.forget_page(p)
            if int(self.coord.page_ref[p]) == 0:
                self.coord.free_pages.append(p)

    # hooks -----------------------------------------------------------
    def release_entry(self, ent) -> None:
        """``PrefixCache.owner_release``: the entry left the index or
        re-bound to a device page; its host slot comes back (its in-flight
        jobs die by token, and jobs run in order, so a stale write to the
        row lands before any later owner's)."""
        if ent.hslot is not None:
            self._free_hslot(ent.hslot)
            ent.hslot = None
            self._update_occupancy()

    def _alloc_hslot(self) -> Optional[int]:
        self._release_held()
        if self._free_hslots:
            return self._free_hslots.pop()
        victim = self.coord.pcache.evict_host_lru()
        if victim is not None:
            # _remove fired release_entry, so the free list has a slot
            self.drops += 1
            if self._m is not None:
                self._m.kv_drops.inc()
        return self._free_hslots.pop() if self._free_hslots else None

    def _free_hslot(self, hslot: int):
        self._digest.pop(hslot, None)
        self._dev_sum.pop(hslot, None)
        self._free_hslots.append(hslot)

    def idle(self) -> bool:
        """Whether the worker has finished every job queued so far (its
        completions may still await a :meth:`drain`)."""
        return self._q.unfinished_tasks == 0

    # lifecycle -------------------------------------------------------
    def reset(self):
        """Pool reset: drop the whole tier. Its copies came from a pool
        that died mid-fault; recompute re-earns them."""
        self._gen += 1
        self._free_hslots = list(range(self.host_pages - 1, -1, -1))
        self._digest.clear()
        self._dev_sum.clear()
        self._done.clear()
        self._wave, self._wave_rows = [], []
        # restores in flight still read their rows: they finish before any
        # later spill's copy, which waits for an event recorded after them
        self._held = []
        self._timed = []
        self._update_occupancy()

    def stop(self, timeout: float = 5.0):
        """End the worker thread. Idempotent; pending jobs are abandoned
        (the tier holds recomputable bytes only)."""
        if self._stopped:
            return
        self._stopped = True
        self._gen += 1
        self._q.put(None)
        self._worker.join(timeout=timeout)
        self._hashers.shutdown(wait=False)

    # ----------------------------------------------------- worker thread
    def _worker_loop(self):
        """The spill worker: the serving stack's waits on host copies run
        here, off the engine thread, so a slow host (the
        ``slow-host-copy`` point) turns hits into misses instead of
        stalling the schedule."""
        while True:
            job = self._q.get()
            if job is None:
                return
            fi = self.engine._fi
            if fi is not None and fi.fire("slow-host-copy"):
                time.sleep(fi.param("slow-host-copy", "delay_ms", 25.0)
                           / 1e3)
            try:
                self._worker_job(job)
            except Exception:  # noqa: BLE001 - the block is doubted
                self._post_fault(job)
            # a spill job holds its staging tensors: let them go now
            job = None
            self._q.task_done()
            self._done_evt.set()

    def _post_fault(self, job):
        """A failed job doubts its blocks: one ``fault`` completion per
        entry (a spill job carries a wave), contained on the engine
        thread."""
        if job[0] == "spill":
            for ent, token, _hslot, _dev_sum in job[2]:
                self._done.append(("fault", job[1], ent, token))
        else:
            self._done.append(("fault", job[1], job[2], job[3]))

    def _worker_job(self, job):
        fi = self.engine._fi
        if fi is not None and fi.fire("racey-worker-write"):
            # the reference's deliberate ownership violation: the worker
            # writes an engine-owned counter outside the job channel. The
            # port has no runtime ownership guard to catch it, so it stays
            # a value-identical write, as in the reference with its guard
            # off
            setattr(self, "demotions", self.demotions + 0)
        if job[0] == "spill":
            self._spill(job)
        else:
            self._promote(job)

    def _row_digest(self, hslot: int) -> bytes:
        return hashlib.blake2b(page_bytes(self._slab[hslot]),
                               digest_size=16).digest()

    def _spill(self, job):
        _, gen, items, rows, gathered = job
        hslots = [hslot for _, _, hslot, _ in items]
        if self._cuda:
            # the copy stream starts after the gathers; the worker waits
            # for its own copies only, then lets the staging go
            self._copy_stream.wait_event(gathered)
            start = self._record(True, self._copy_stream)
            with torch.cuda.stream(self._copy_stream):
                for hslot, row in zip(hslots, rows):
                    self._slab[hslot].copy_(row, non_blocking=True)
            copied = self._record(True, self._copy_stream)
            copied.synchronize()
            self.copy_log.append(("d2h", len(items),
                                  len(items) * self._slab.shape[1],
                                  start.elapsed_time(copied)))
        else:
            for hslot, row in zip(hslots, rows):
                self._slab[hslot].copy_(row)
        digests = list(self._hashers.map(self._row_digest, hslots))
        # the engine thread stores the digests at drain, so a stale
        # completion cannot poison a reassigned row
        self._done.append(("spill", gen, [
            (ent, token, hslot, d, dev_sum)
            for (ent, token, hslot, dev_sum), d in zip(items, digests)]))

    def _promote(self, job):
        from .integrity import count_integrity_check

        _, gen, ent, token, hslot, want, dev_sum, t0 = job
        fi = self.engine._fi
        if fi is not None and fi.fire("kv-spill-corrupt"):
            # silent host-memory damage: one seed-chosen byte of the page's
            # first buffer flips; only the digest stands in its way
            view = self._slab[hslot][:self._first_bytes].numpy()
            view[fi.draw("kv-spill-corrupt", view.size)] ^= 0xFF
        ok = want is not None and self._row_digest(hslot) == want
        count_integrity_check("kv_tier", ok)
        if ok:
            self._done.append(("promote", gen, ent, token, hslot, dev_sum,
                               time.perf_counter() - t0))
        else:
            self._done.append(("promote-bad", gen, ent, token))
