"""Costing schemes of the test grid: DNA with several gap costs,
BLOSUM62/BLOSUM50, an odd-``b`` custom matrix (Δd ≠ Δi) and random
alphabets of 27-31 symbols with the gap at any position."""

import numpy as np

from globalign_jax.config import resolve_scheme
from globalign_jax.ops.transforms import scoring_mat_to_costing_mat
from globalign_jax.utils.matrices import SubstitutionMatrix, create_scoring_mat
from globalign_jax.utils.tokenize import Alphabet

DNA = "ACGT"
PROTEIN = "ARNDCQEGHILKMFPSTWYV"
WIDE = "ABCDEFGHIJKLMNOPQRSTUVWXYZ*#$%&"


def _random_costing(A: int, gap_pos: int, seed: int) -> SubstitutionMatrix:
    """Random non-negative costing over A symbols, gap at ``gap_pos``."""
    rng = np.random.default_rng(seed)
    letters = list(WIDE[: A - 1])
    letters.insert(gap_pos, "-")
    vals = rng.integers(0, 23, (A, A)).astype(np.int32)
    vals = np.minimum(vals, vals.T)
    vals[gap_pos, gap_pos] = 0
    return SubstitutionMatrix(Alphabet.from_letters(letters), vals)


def scheme(name: str):
    """(letters, costing SubstitutionMatrix, gap_open) of a grid scheme."""
    if name == "dna_default":
        s = resolve_scheme(DNA, DNA)
        return DNA, s.costing, s.gap_open_cost
    if name.startswith("dna_"):
        mmc, go, ge = (int(v) for v in name.split("_")[1:])
        s = resolve_scheme(
            DNA, DNA, mismatch_cost=mmc, gap_open_cost=go,
            gap_extension_cost=ge,
        )
        return DNA, s.costing, s.gap_open_cost
    if name in ("BLOSUM62", "BLOSUM50"):
        s = resolve_scheme(PROTEIN, PROTEIN, scoring_mat_name=name)
        return PROTEIN, s.costing, s.gap_open_cost
    if name == "odd_b":
        alpha = Alphabet.from_letters(tuple(DNA) + ("-",))
        costing = scoring_mat_to_costing_mat(
            create_scoring_mat(alpha, 3, -2, -2), max_score=3
        )
        v = costing.values
        assert v[alpha.gap_id, 0] != v[0, alpha.gap_id]  # Δd != Δi
        return DNA, costing, 5
    A, gap_pos = (int(v) for v in name.split("_")[1:])  # "alpha_A_gappos"
    costing = _random_costing(A, gap_pos, seed=A * 7 + gap_pos)
    letters = "".join(c for c in costing.alphabet.letters if c != "-")
    return letters, costing, 3


SCHEMES = [
    "dna_default", "dna_5_0_3", "dna_1_7_1", "dna_9_2_6", "BLOSUM62",
    "BLOSUM50", "odd_b", "alpha_27_26", "alpha_29_0", "alpha_31_13",
]
