"""Fleet utilities of the port (after
``paddle_tpu/distributed/fleet/utils``): the hybrid-parallel gradient and
parameter sync, the rank-0 logger and main-grad mixed precision.
(``sequence_parallel_utils.py`` is not ported.)"""
from . import log_util  # noqa: F401
from . import mix_precision_utils  # noqa: F401
from .hybrid_parallel_util import (  # noqa: F401
    broadcast_dp_parameters,
    broadcast_mp_parameters,
    broadcast_sharding_parameters,
    fused_allreduce_gradients,
)
