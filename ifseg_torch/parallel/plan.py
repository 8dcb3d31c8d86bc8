"""ParallelPlan: the strategy that holds the mesh's 'model' dim.

As in the JAX package, a plan exists only for the programs of the model
axis: the GPipe pipeline (``parallel/pipeline.py``), ring attention
(``parallel/context.py``) and the BASE mixture of experts
(``parallel/moe.py``, ``models/moe_ffn.py``).  Tensor parallelism needs
none (``parallel/tensor.py`` rewires the modules).  The model is built with
the plan (``SegOFA(cfg, plan)``): it decides which layers hold experts, and
the encoder, decoder and self-attention read it at every forward.  The plan
is shared, never copied, by a deep copy of the model (the evaluator's
serving copy), since it holds the process groups.
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

    @property
    def group(self):
        """The process group of the model axis."""
        return self.mesh.group(self.axis)

    @property
    def index(self) -> int:
        """This rank's place on the model axis: its stage, ring position or
        expert."""
        return self.mesh.index(self.axis)

    def __deepcopy__(self, memo):
        return self


def plan_from_config(dist_cfg, mesh: ProcessMesh) -> Optional[ParallelPlan]:
    """A plan when any model-axis program is asked for (a pipeline or ring of
    more than one rank, more than one expert), else None, as the JAX
    package's ``plan_from_config``.  At most one strategy holds the model
    axis (``model_axis_size`` raises otherwise)."""
    size = model_axis_size(dist_cfg)  # validates exclusivity
    if (max(getattr(dist_cfg, "pipeline_parallel", 1), 1) == 1
            and max(getattr(dist_cfg, "context_parallel", 1), 1) == 1
            and getattr(dist_cfg, "moe_experts", 0) <= 1):
        return None
    if mesh.size("model") != size:
        raise ValueError(f"the model axis's program needs {size} ranks on the mesh's 'model' "
                         f"dim, the mesh has {mesh.size('model')}")
    return ParallelPlan(
        mesh=mesh,
        context_parallel=max(dist_cfg.context_parallel, 1),
        pipeline_parallel=max(dist_cfg.pipeline_parallel, 1),
        pipeline_chunks=getattr(dist_cfg, "pipeline_chunks", 0),
        moe_experts=max(dist_cfg.moe_experts, 0),
        moe_freq=max(getattr(dist_cfg, "moe_freq", 2), 1),
        moe_assignment=getattr(dist_cfg, "moe_assignment", "sinkhorn"),
    )
