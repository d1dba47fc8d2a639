"""``paddle.distributed.communication`` (after
``paddle_tpu/distributed/communication``): the collectives of
``distributed.collective`` under the reference's module layout, and their
``stream`` forms."""
from ..collective import (  # noqa: F401
    ReduceOp,
    all_gather,
    all_gather_object,
    all_reduce,
    all_to_all,
    barrier,
    broadcast,
    recv,
    reduce,
    reduce_scatter,
    scatter,
    send,
)
from . import stream  # noqa: F401
