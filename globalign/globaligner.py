"""Shim for ``globalign.globaligner`` (reference globaligner.py:23-821).

The DP-internal symbols (``make_dp_array`` .. ``take_*``) are
list-of-lists compatibility adapters — see :mod:`globalign.dp_compat`
for their contract and documented deterministic divergences."""

from globalign_jax.api import find_global_alignment  # noqa: F401
from globalign_jax.cli import main  # noqa: F401

from .dp_compat import (  # noqa: F401
    dp_array_backward,
    dp_array_forward,
    get_next_best_costs,
    make_dp_array,
    take_gap_in_seq_1,
    take_gap_in_seq_2,
    take_match,
    take_mismatch,
)
