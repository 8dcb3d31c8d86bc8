"""ParallelPlan: the strategy that holds the mesh's 'model' dim.

In the JAX package a plan exists only for the ``shard_map`` programs of the
model axis (the GPipe pipeline, ring attention, BASE mixture of experts);
tensor parallelism needs none there, being parameter shardings.  The port
has none of those programs yet (ROADMAP.md A.9b): ``plan_from_config``
returns None for a config without them, as the JAX package's does, and
raises for one that asks for them.
"""

from dataclasses import dataclass
from typing import Optional

from .mesh import ProcessMesh, model_axis_size


@dataclass(frozen=True)
class ParallelPlan:
    mesh: ProcessMesh
    context_parallel: int = 1
    pipeline_parallel: int = 1
    pipeline_chunks: int = 0  # 0 -> pipeline_parallel
    moe_experts: int = 0
    moe_freq: int = 2
    moe_assignment: str = "sinkhorn"
    axis: str = "model"

    @property
    def chunks(self) -> int:
        return self.pipeline_chunks or self.pipeline_parallel


def plan_from_config(dist_cfg, mesh: ProcessMesh) -> Optional[ParallelPlan]:
    """None: the port runs tensor, data and fully sharded data parallelism
    without a plan, and has no ``shard_map`` strategy to plan for."""
    model_axis_size(dist_cfg)  # validates exclusivity
    if (max(getattr(dist_cfg, "pipeline_parallel", 1), 1) > 1
            or max(getattr(dist_cfg, "context_parallel", 1), 1) > 1
            or getattr(dist_cfg, "moe_experts", 0) > 1):
        raise NotImplementedError(
            "pipeline, context and expert parallelism are not ported (ROADMAP.md A.9b)")
    return None
