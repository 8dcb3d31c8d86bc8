"""Task registry: a name -> class map with a ``setup_task`` entry point,
the counterpart of the JAX package's ``tasks/registry.py`` (fairseq's
decorator registries, custom_fairseq/fairseq/registry.py,
tasks/__init__.py:19-44).  A third-party task imports this module and
registers itself with ``register_task`` when it is imported.
"""

from typing import Callable, Dict, Type

TASK_REGISTRY: Dict[str, Type] = {}


def register_task(name: str) -> Callable:
    """Class decorator: register the class as task ``name`` (a second class
    under the same name raises) and set its ``task_name``."""
    def wrap(cls):
        if name in TASK_REGISTRY and TASK_REGISTRY[name] is not cls:
            raise ValueError(f"duplicate task registration: {name}")
        TASK_REGISTRY[name] = cls
        cls.task_name = name
        return cls

    return wrap


def setup_task(name: str, cfg):
    """The registered task ``name`` built from ``cfg`` by its ``setup_task``."""
    if name not in TASK_REGISTRY:
        raise KeyError(f"unknown task {name}; known: {sorted(TASK_REGISTRY)}")
    return TASK_REGISTRY[name].setup_task(cfg)
