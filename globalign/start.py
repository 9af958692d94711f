"""Shim for ``globalign.start`` — reference signatures, nested-dict matrices.

Every function keeps the reference's signature and dict-of-dicts matrix
format (reference start.py); matrix-valued operations convert through
:class:`globalign_jax.SubstitutionMatrix` and back.
"""

from __future__ import annotations

from pathlib import Path

from globalign_jax.config import (  # noqa: F401
    SimpleCostingSettings,
    SimpleScoringSettings,
)
from globalign_jax.config import check_seq_lengths  # noqa: F401
from globalign_jax.config import (
    validate_and_transform_args as _validate_and_transform_args,
)
from globalign_jax.ops import transforms as _transforms
from globalign_jax.utils import matrices as _matrices
from globalign_jax.utils.fasta import (  # noqa: F401
    read_first_2_seqs_from_fasta,
    read_seq_from_fasta,
)
from globalign_jax.utils.matrices import (  # noqa: F401
    check_big_main_diag,
    check_symmetric,
    get_max_val,
    validate_scoring_mat_keys,
)
from globalign_jax.utils.random_seqs import (  # noqa: F401
    draw_random_seq,
    draw_two_random_seqs,
)
from globalign_jax.utils.tokenize import Alphabet as _Alphabet


def get_common_alphabet(seq_1, seq_2):
    """Sorted union of the sequences' characters (reference start.py:355-358)."""
    return sorted(set(seq_1).union(set(seq_2)))


def read_scoring_mat(scoring_mat_path: Path) -> dict:
    """Whitespace-format matrix file -> nested dict (reference start.py:378-428)."""
    return _matrices.read_scoring_mat(scoring_mat_path).to_nested_dict()


def create_scoring_mat(
    common_alphabet: list,
    match_score: int,
    mismatch_score: int,
    gap_extension_score: int,
) -> dict:
    """Nested-dict scoring matrix over alphabet + '-' (reference start.py:431-449).

    Mutates ``common_alphabet`` by appending "-", like the reference.
    """
    common_alphabet.append("-")
    return {
        outer: {
            inner: (
                match_score
                if outer == inner
                else gap_extension_score
                if "-" in (outer, inner)
                else mismatch_score
            )
            for inner in common_alphabet
        }
        for outer in common_alphabet
    }


def create_costing_mat(
    common_alphabet: list, mismatch_cost: int, gap_extension_cost: int
) -> dict:
    """Nested-dict costing matrix (reference start.py:451-468); mutates input."""
    common_alphabet.append("-")
    return {
        outer: {
            inner: (
                0
                if outer == inner
                else gap_extension_cost
                if "-" in (outer, inner)
                else mismatch_cost
            )
            for inner in common_alphabet
        }
        for outer in common_alphabet
    }


def _dict_transform(fn, mat: dict, max_score, delta_d, delta_i) -> dict:
    sub = _matrices.SubstitutionMatrix.from_nested_dict(mat)
    out = fn(sub, max_score, delta_d, delta_i)
    return out.to_nested_dict()


def scoring_mat_to_costing_mat(
    scoring_mat: dict, max_score, delta_d=None, delta_i=None
) -> dict:
    """Similarity -> distance matrix (reference start.py:500-557)."""
    return _dict_transform(
        _transforms.scoring_mat_to_costing_mat,
        scoring_mat,
        max_score,
        delta_d,
        delta_i,
    )


def costing_mat_to_scoring_mat(
    costing_mat: dict, max_score, delta_d=None, delta_i=None
) -> dict:
    """Distance -> similarity matrix (reference start.py:559-612)."""
    return _dict_transform(
        _transforms.costing_mat_to_scoring_mat,
        costing_mat,
        max_score,
        delta_d,
        delta_i,
    )


def validate_and_transform_args(**kwargs):
    """Reference-contract validation returning the canonical 7-tuple
    (seq_1, seq_2, scoring_mat, costing_mat, gap_open_score, gap_open_cost,
    output) with nested-dict matrices (reference start.py:150-353,
    return contract at :171-179).  Drop-in semantics include the
    reference's hard m*n < 2e7 input cap (start.py:213) — the native
    engine lifts it (config.DEFAULT_MAX_SEQ_LEN_PROD), but code written
    against the reference must see the reference's envelope and error."""
    v = _validate_and_transform_args(max_seq_len_prod=20_000_000, **kwargs)
    scheme = v.scheme
    return (
        v.seq_1,
        v.seq_2,
        scheme.scoring.to_nested_dict(),
        scheme.costing.to_nested_dict(),
        scheme.gap_open_score,
        scheme.gap_open_cost,
        v.output,
    )


def make_matrix(num_rows: int, num_cols: int, fill_val) -> list:
    """List-of-lists allocator (reference start.py:869-876)."""
    return [[fill_val] * num_cols for _ in range(num_rows)]


def make_3d_array(dim_1: int, dim_2: int, dim_3: int, fill_val) -> list:
    """3-D list allocator (reference start.py:878-880; unused helper kept
    for API parity)."""
    return [
        [[fill_val] * dim_3 for _ in range(dim_2)] for _ in range(dim_1)
    ]


_ = _Alphabet  # re-exported building block for advanced users
