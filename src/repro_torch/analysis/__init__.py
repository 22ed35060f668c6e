"""The symbolic per-round load model that backs the static verifier's
``load-bound`` rule (a copy of the reference package's ``loadmodel``)."""

from .loadmodel import (
    DATA_ROUNDS,
    MODEL_CONSTANT,
    RoundBound,
    ideal_load,
    predicted_load,
    round_bounds,
    round_bounds_by_name,
)
