"""Fleet meta-optimizers of the port (after
``paddle_tpu/distributed/fleet/meta_optimizers``): the hybrid-parallel
optimizer glue and the gradient-merge, LocalSGD and DGC wrappers."""
from .dygraph_optimizer import (  # noqa: F401
    DGCMomentumOptimizer,
    DygraphShardingOptimizer,
    GradientMergeOptimizer,
    HybridParallelClipGrad,
    HybridParallelGradScaler,
    HybridParallelOptimizer,
    LocalSGDOptimizer,
)

__all__ = [
    "HybridParallelOptimizer",
    "HybridParallelClipGrad",
    "HybridParallelGradScaler",
    "DygraphShardingOptimizer",
    "GradientMergeOptimizer",
    "LocalSGDOptimizer",
    "DGCMomentumOptimizer",
]
