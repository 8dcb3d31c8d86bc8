from .registry import register_task, setup_task, TASK_REGISTRY
from .segmentation import SegmentationTask

__all__ = ["register_task", "setup_task", "TASK_REGISTRY", "SegmentationTask"]
