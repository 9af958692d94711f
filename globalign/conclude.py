"""Shim for ``globalign.conclude`` (reference conclude.py)."""

from globalign_jax.ops.transforms import (  # noqa: F401
    final_cost_to_score,
    final_score_to_cost,
)
from globalign_jax.results import (  # noqa: F401
    AlignmentResults,
    prettify_mat,
    print_nested_list_aligned,
)
