"""Fast stream-generation tier (counterpart of
``nbody_streams_tpu/fast_sims``).  Ported so far: the King models
(``king.py``); the orbit integrators, spray and restricted N-body are
ROADMAP.md Queue 1 item 9."""
from .king import KingModel, make_king_potential, sample_king

__all__ = ["KingModel", "make_king_potential", "sample_king"]
