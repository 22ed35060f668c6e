"""Roofline analysis of counted steps (``roofline``, ``cost``, ``probes``, read by
``launch/dryrun.py``) and the symbolic per-round load model that backs the static
verifier's ``load-bound`` rule (a copy of the reference package's ``loadmodel``)."""

from .loadmodel import (
    DATA_ROUNDS,
    MODEL_CONSTANT,
    RoundBound,
    ideal_load,
    predicted_load,
    round_bounds,
    round_bounds_by_name,
)
from .roofline import collective_bytes, roofline_terms, HW
