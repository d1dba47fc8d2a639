"""The point-to-point channel between pipeline stages (after upstream
Paddle's ``pp_utils/p2p_communication.py``).

Activations go to the next stage and their gradients come back, each
between the same ranks of the neighbouring stages (the ``pp`` group is a
ring: under the interleaved schedule the last stage's chunk feeds the
first stage's next chunk). Every send is posted without waiting
(``collective.p2p_batch(wait_sends=False)``) and held until
:meth:`P2PChannel.finish`; a receive waits. A send followed at once by a
receive from the same peer (the 1F1B steady state's send-forward /
receive-backward and send-backward / receive-forward) is posted as one
batched exchange. Activations and gradients travel under tags of their
own, so the two streams between a pair of ranks never cross.

The shape handshake (upstream's ``SendRecvMeta``): a receiving stage
learns an activation's shape and dtype from a small int64 message that
the sender posts before the first activation of each boundary, once per
batch shape: both sides key it on the global batch's shape and dtype and
the microbatch count, which every rank is given alike. Gradients take the
shape of the activation the receiver sent.
"""
from __future__ import annotations

import time
from typing import Dict, Tuple

import torch

from ....collective import p2p_batch

__all__ = ["P2PChannel", "LocalChannel"]

TAG_FORWARD, TAG_BACKWARD = 1, 2
_META_LEN = 16
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32)


def _meta(t: torch.Tensor, device) -> torch.Tensor:
    if t.dim() > _META_LEN - 2:
        raise ValueError(f"an activation of {t.dim()} dims is more than "
                         f"the handshake carries")
    if t.dtype not in _DTYPES:
        raise TypeError(f"a pipeline activation of dtype {t.dtype}")
    words = [t.dim(), _DTYPES.index(t.dtype)] + list(t.shape)
    words += [0] * (_META_LEN - len(words))
    return torch.tensor(words, dtype=torch.int64, device=device)


def _unmeta(m: torch.Tensor) -> Tuple[Tuple[int, ...], torch.dtype]:
    words = m.tolist()
    return tuple(words[2:2 + words[0]]), _DTYPES[words[1]]


class P2PChannel:
    """This rank's links to the stages before and after it. ``ranks``:
    the ``pp`` group's global ranks in stage order; ``stage``: this
    rank's. ``stats`` counts the calls, the bytes sent and received and
    the host seconds spent in the calls (a receive's wait for its peer
    included)."""

    def __init__(self, ranks, stage: int, device):
        self.ranks = list(ranks)
        self.stage = int(stage)
        self.pp = len(self.ranks)
        self.device = device
        self.next_rank = self.ranks[(self.stage + 1) % self.pp]
        self.prev_rank = self.ranks[(self.stage - 1) % self.pp]
        self._sent_meta: set = set()
        self._meta: Dict[tuple, Tuple[tuple, torch.dtype]] = {}
        self._pending = []
        self.stats = {"calls": 0, "bytes": 0, "s": 0.0}

    def reset_stats(self):
        self.stats = {"calls": 0, "bytes": 0, "s": 0.0}

    # ------------------------------------------------------------- posting
    def _post(self, sends, recvs):
        t0 = time.perf_counter()
        pending = p2p_batch(sends, recvs, wait_sends=False)
        self._pending.append(pending)
        self.stats["calls"] += 1
        self.stats["bytes"] += sum(t.numel() * t.element_size()
                                   for t, *_ in list(sends) + list(recvs))
        self.stats["s"] += time.perf_counter() - t0

    def _forward_sends(self, out, key):
        sends = []
        if key not in self._sent_meta:
            self._sent_meta.add(key)
            sends.append((_meta(out, self.device), self.next_rank,
                          TAG_FORWARD))
        sends.append((out.detach(), self.next_rank, TAG_FORWARD))
        return sends

    def _forward_buffer(self, key):
        if key not in self._meta:
            m = torch.empty(_META_LEN, dtype=torch.int64, device=self.device)
            self._post((), [(m, self.prev_rank, TAG_FORWARD)])
            self._meta[key] = _unmeta(m)
        shape, dtype = self._meta[key]
        return torch.empty(shape, dtype=dtype, device=self.device)

    # ------------------------------------------------------------- the API
    def send_forward(self, out: torch.Tensor, key):
        """``out`` to the next stage. ``key``: (the batch key, the
        sending virtual stage)."""
        self._post(self._forward_sends(out, key), ())

    def recv_forward(self, key) -> torch.Tensor:
        """The activation the previous stage sent under ``key`` (the
        batch key and the sending virtual stage)."""
        buf = self._forward_buffer(key)
        self._post((), [(buf, self.prev_rank, TAG_FORWARD)])
        return buf

    def send_backward(self, grad: torch.Tensor):
        self._post([(grad.detach(), self.prev_rank, TAG_BACKWARD)], ())

    def recv_backward(self, like: torch.Tensor) -> torch.Tensor:
        buf = torch.empty_like(like, memory_format=torch.contiguous_format)
        self._post((), [(buf, self.next_rank, TAG_BACKWARD)])
        return buf

    def send_forward_recv_backward(self, out: torch.Tensor,
                                   key) -> torch.Tensor:
        """``out`` to the next stage and, in the same batched exchange,
        the gradient of an earlier activation from it (its shape is
        ``out``'s)."""
        buf = torch.empty_like(out, memory_format=torch.contiguous_format)
        self._post(self._forward_sends(out, key),
                   [(buf, self.next_rank, TAG_BACKWARD)])
        return buf

    def send_backward_recv_forward(self, grad: torch.Tensor,
                                   key) -> torch.Tensor:
        """``grad`` to the previous stage and the next activation from it
        under ``key``, batched. A boundary whose shape is not known yet
        posts the send first and takes the handshake before the
        activation."""
        send = [(grad.detach(), self.prev_rank, TAG_BACKWARD)]
        if key not in self._meta:
            self._post(send, ())
            return self.recv_forward(key)
        buf = self._forward_buffer(key)
        self._post(send, [(buf, self.prev_rank, TAG_FORWARD)])
        return buf

    def finish(self):
        """Wait until every posted send has left (end of a batch)."""
        t0 = time.perf_counter()
        for p in self._pending:
            p.wait()
        self._pending = []
        self.stats["s"] += time.perf_counter() - t0


class LocalChannel:
    """:class:`P2PChannel`'s interface for a pipeline of one stage, whose
    chunks pass activations and gradients to themselves: two queues, in
    the order they were sent."""

    def __init__(self):
        from collections import deque

        self._fwd, self._bwd = deque(), deque()
        self.stats = {"calls": 0, "bytes": 0, "s": 0.0}

    def reset_stats(self):
        self.stats = {"calls": 0, "bytes": 0, "s": 0.0}

    def send_forward(self, out, key):
        self._fwd.append(out.detach())

    def recv_forward(self, key):
        return self._fwd.popleft().clone()

    def send_backward(self, grad):
        self._bwd.append(grad.detach())

    def recv_backward(self, like):
        return self._bwd.popleft()

    def send_forward_recv_backward(self, out, key):
        self.send_forward(out, key)
        return self.recv_backward(out)

    def send_backward_recv_forward(self, grad, key):
        self.send_backward(grad)
        return self.recv_forward(key)

    def finish(self):
        pass
