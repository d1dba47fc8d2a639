"""Meta-parallel layers of the port (after
``paddle_tpu/distributed/fleet/meta_parallel``): context parallelism, the
tensor-parallel layers, the model-parallel RNG tracker, the
``TensorParallel`` wrapper, and pipelines (``LayerDesc``,
``SharedLayerDesc``, ``PipelineLayer``, ``PipelineParallel``)."""
from .context_parallel import (  # noqa: F401
    RingAttention,
    ring_attention,
    ring_attention_op,
    ulysses_attention,
    zigzag_indices,
)
from .meta_parallel_base import MetaParallelBase  # noqa: F401
from .pipeline_engine import (  # noqa: F401
    PipelineParallel,
    pipeline_schedule_stats,
)
from .pp_layers import LayerDesc, PipelineLayer, SharedLayerDesc  # noqa: F401
from .mp_layers import (  # noqa: F401
    ColumnParallelLinear,
    ParallelCrossEntropy,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from .random import (  # noqa: F401
    MODEL_PARALLEL_RNG,
    RNGStatesTracker,
    determinate_seed,
    get_rng_state_tracker,
    model_parallel_random_seed,
)
from .tensor_parallel import (  # noqa: F401
    TensorParallel,
    apply_dist_specs,
    param_shardings,
    shard_slices,
    shard_tensor,
    sharded_state_dict,
)

__all__ = ["ring_attention", "ring_attention_op", "ulysses_attention",
           "zigzag_indices", "RingAttention", "MetaParallelBase",
           "LayerDesc", "SharedLayerDesc", "PipelineLayer",
           "PipelineParallel", "pipeline_schedule_stats",
           "ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy",
           "RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed", "determinate_seed",
           "MODEL_PARALLEL_RNG", "TensorParallel", "apply_dist_specs",
           "param_shardings", "shard_slices", "shard_tensor",
           "sharded_state_dict"]
