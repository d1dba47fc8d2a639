"""Meta-parallel layers of the port (after
``paddle_tpu/distributed/fleet/meta_parallel``): context parallelism."""
from .context_parallel import (  # noqa: F401
    RingAttention,
    ring_attention,
    ring_attention_op,
    ulysses_attention,
    zigzag_indices,
)

__all__ = ["ring_attention", "ring_attention_op", "ulysses_attention",
           "zigzag_indices", "RingAttention"]
