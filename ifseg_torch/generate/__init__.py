from .search import (
    BeamSearch,
    DiverseBeamSearch,
    DiverseSiblingsSearch,
    LengthConstrainedBeamSearch,
    PrefixConstrainedBeamSearch,
    Sampling,
)
from .sequence_generator import SequenceGenerator

__all__ = [
    "BeamSearch",
    "Sampling",
    "DiverseBeamSearch",
    "DiverseSiblingsSearch",
    "LengthConstrainedBeamSearch",
    "PrefixConstrainedBeamSearch",
    "SequenceGenerator",
]
