"""Native C++ runtime vs pure-Python fallbacks: identical outputs.

The native layer (native/runtime.cpp via utils/native.py) accelerates the
host-side serial work (FASTA parsing, traceback walk, bucketizer); these
tests pin it bit-for-bit to the Python implementations on the same inputs,
and are skipped wholesale if no C++ toolchain is present.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from globalign_jax.utils import native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable"
)


def test_fasta_native_matches_python(tmp_path, monkeypatch):
    fa = tmp_path / "x.fasta"
    fa.write_text(
        ">first record\nacgt\nACGTT\n\n>second\ntttt\n>third desc here\nGG\ncc\n"
    )
    from globalign_jax.utils.fasta import read_seq_from_fasta

    native_records = list(read_seq_from_fasta(fa))
    monkeypatch.setattr(native, "_load_failed", True)
    monkeypatch.setattr(native, "_lib", None)
    python_records = list(read_seq_from_fasta(fa))
    assert native_records == python_records
    assert native_records[0] == (">first record", "ACGTACGTT")
    assert native_records[2] == (">third desc here", "GGCC")


@pytest.mark.parametrize(
    "content",
    ["acgt\n>desc\nACGT\n", ">only desc\n", ">a\nACGT\n>b\n>c\nGG\n"],
)
def test_fasta_native_errors_match_python(tmp_path, monkeypatch, content):
    fa = tmp_path / "bad.fasta"
    fa.write_text(content)
    from globalign_jax.utils.fasta import read_seq_from_fasta

    with pytest.raises(RuntimeError) as native_err:
        list(read_seq_from_fasta(fa))
    monkeypatch.setattr(native, "_load_failed", True)
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError) as python_err:
        list(read_seq_from_fasta(fa))
    assert str(native_err.value) == str(python_err.value)


def test_traceback_native_matches_python(monkeypatch):
    from globalign_jax.ops import fill_rows
    from globalign_jax.ops.traceback import traceback_moves
    from globalign_jax.ops.transforms import scoring_mat_to_costing_mat
    from globalign_jax.utils.matrices import create_scoring_mat
    from globalign_jax.utils.tokenize import Alphabet, encode_padded

    alpha = Alphabet.from_letters(("A", "C", "G", "T", "-"))
    costing = scoring_mat_to_costing_mat(
        create_scoring_mat(alpha, 2, -3, -2), max_score=2
    )
    cm = jnp.asarray(costing.values)
    gid = jnp.int32(alpha.gap_id)
    go = jnp.int32(4)
    rng = np.random.default_rng(23)
    for _ in range(8):
        m = int(rng.integers(1, 120))
        n = int(rng.integers(1, 120))
        s1 = "".join(rng.choice(list("ACGT"), m))
        s2 = "".join(rng.choice(list("ACGT"), n))
        ta = jnp.asarray(encode_padded(alpha, s1, m))
        tb = jnp.asarray(encode_padded(alpha, s2, n))
        r = fill_rows.row_fill(ta, tb, cm, gid, go, want_moves=True)
        moves = np.asarray(r.moves)
        final3 = np.asarray(r.final3)
        t_native = traceback_moves(moves, s1, s2, final3, "row")
        with monkeypatch.context() as mp:
            mp.setattr(native, "_load_failed", True)
            mp.setattr(native, "_lib", None)
            t_python = traceback_moves(moves, s1, s2, final3, "row")
        assert t_native == t_python


def test_bucketizer_matches_python():
    import ctypes

    from globalign_jax.batch import bucket_length

    lib = native.load()
    lengths = np.array([1, 31, 32, 33, 1000, 7], dtype=np.int64)
    out = np.empty_like(lengths)
    lib.ga_bucket_lengths(
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(lengths),
        32,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    assert out.tolist() == [bucket_length(int(x), 32) for x in lengths]


def test_tokenize_native():
    import ctypes

    lib = native.load()
    char_map = np.full(256, -1, dtype=np.int32)
    for i, c in enumerate("ACGT"):
        char_map[ord(c)] = i
    out = np.empty(6, dtype=np.int32)
    bad = lib.ga_tokenize(
        b"ACGTT",
        5,
        char_map.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    assert bad == -1
    assert out.tolist() == [0, 0, 1, 2, 3, 3]
    bad = lib.ga_tokenize(
        b"ACXT",
        4,
        char_map.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    assert bad == 2
