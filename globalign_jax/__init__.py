"""globalign_jax — a JAX/XLA global sequence-alignment engine.

A from-scratch JAX/XLA re-design with the capabilities of
`globalign <https://github.com/iamgiddyaboutgit/globalign>`_: optimal global
(Needleman-Wunsch) alignment with affine gap penalties via the Gotoh
three-level recurrence in cost space, scoring and costing schemes unified by
the Akulov/Groot-Koerkamp score<->cost transform, BLOSUM/custom/simple
substitution matrices, FASTA input, and the reference's human-readable
alignment report — plus capabilities the reference lacks: a vectorized
device fill, batched length-bucketed many-pair alignment, and
data-parallel sharding over device meshes.

Public surface::

    find_global_alignment(...)   # reference-parity single-pair entry point
    align_pairs(...)             # batched many-pair engine
    AlignmentResults             # report object (same 10 fields as reference)
"""

try:  # installed: the git-tag-derived version (setuptools-scm)
    from importlib.metadata import version as _pkg_version

    __version__ = _pkg_version("globalign-jax")
except Exception:  # running from a source tree
    __version__ = "0.2.0"

from .api import find_global_alignment
from .batch import align_pairs
from .config import (
    ResolvedScheme,
    SimpleCostingSettings,
    SimpleScoringSettings,
    resolve_scheme,
    validate_and_transform_args,
)
from .models.gotoh import GotohAligner
from .ops.transforms import (
    costing_mat_to_scoring_mat,
    final_cost_to_score,
    final_score_to_cost,
    scoring_mat_to_costing_mat,
)
from .ops.traceback import alignment_to_cigar
from .results import AlignmentResults, prettify_mat
from .runner import BatchRunner
from .utils.fasta import read_first_2_seqs_from_fasta, read_seq_from_fasta
from .utils.matrices import (
    SubstitutionMatrix,
    check_big_main_diag,
    check_symmetric,
    create_costing_mat,
    create_scoring_mat,
    get_max_val,
    load_bundled_matrix,
    read_scoring_mat,
    validate_scoring_mat_keys,
)
from .utils.random_seqs import draw_random_seq, draw_two_random_seqs
from .utils.tokenize import Alphabet

__all__ = [
    "__version__",
    "find_global_alignment",
    "align_pairs",
    "BatchRunner",
    "AlignmentResults",
    "alignment_to_cigar",
    "GotohAligner",
    "ResolvedScheme",
    "SimpleScoringSettings",
    "SimpleCostingSettings",
    "resolve_scheme",
    "validate_and_transform_args",
    "scoring_mat_to_costing_mat",
    "costing_mat_to_scoring_mat",
    "final_cost_to_score",
    "final_score_to_cost",
    "prettify_mat",
    "SubstitutionMatrix",
    "Alphabet",
    "read_scoring_mat",
    "load_bundled_matrix",
    "create_scoring_mat",
    "create_costing_mat",
    "check_symmetric",
    "check_big_main_diag",
    "validate_scoring_mat_keys",
    "get_max_val",
    "read_seq_from_fasta",
    "read_first_2_seqs_from_fasta",
    "draw_random_seq",
    "draw_two_random_seqs",
]
