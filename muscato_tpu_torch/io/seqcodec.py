"""Sequence byte<->code conversion.

muscato_tpu represents sequences as small-integer code arrays instead of the
reference's byte strings:

    A=0, C=1, G=2, T=3, X=4

The code order is chosen to be *monotone in ASCII* ('A'<'C'<'G'<'T'<'X'),
so sorting coded rows reproduces the reference's C-locale string sorts
(LC_ALL=C is forced at /root/reference/cmd/muscato/main.go:907).

Behavioral contract carried over from the reference:
  - every letter other than A/T/G/C becomes X ("subx",
    /root/reference/cmd/muscato_prep_targets/main.go:69-80), and X compares
    equal to X during verification (byte equality in cdiff,
    /root/reference/cmd/muscato_confirm/main.go:151-159);
  - reverse complement maps A<->T, C<->G, X->X
    (/root/reference/cmd/muscato_prep_targets/main.go:48-66).
"""

from __future__ import annotations

import numpy as np

A, C, G, T, X = 0, 1, 2, 3, 4
NBASE = 5
LETTERS = b"ACGTX"

# byte -> code; all non-ACGT bytes code as X (the subx rule).
_B2C = np.full(256, X, dtype=np.uint8)
for _i, _ch in enumerate(LETTERS[:4]):
    _B2C[_ch] = _i

# code -> byte
_C2B = np.frombuffer(LETTERS, dtype=np.uint8).copy()

# reverse complement over codes
_RC = np.array([T, G, C, A, X], dtype=np.uint8)


def encode(seq: bytes) -> np.ndarray:
    """bytes -> (len,) uint8 codes, applying the subx rule."""
    b = np.frombuffer(seq, dtype=np.uint8)
    return _B2C[b]


def decode(codes: np.ndarray) -> bytes:
    """(len,) uint8 codes -> bytes."""
    return _C2B[codes].tobytes()


def subx_bytes(seq: bytes) -> bytes:
    """Apply the subx rule at the byte level (non-ACGT -> 'X')."""
    return decode(encode(seq))


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    return _RC[codes][::-1].copy()


def revcomp_bytes(seq: bytes) -> bytes:
    return decode(revcomp_codes(encode(seq)))


def encode_rows(seqs: list[bytes], width: int, pad: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Encode a list of byte strings into a dense (N, width) uint8 matrix.

    Rows shorter than `width` are padded with `pad`; lengths returned
    separately.  Sequences longer than `width` must not occur (caller
    truncates first).
    """
    n = len(seqs)
    out = np.full((n, width), pad, dtype=np.uint8)
    lens = np.empty(n, dtype=np.int32)
    for i, s in enumerate(seqs):
        e = encode(s)
        out[i, : len(e)] = e
        lens[i] = len(e)
    return out, lens


def dinucleotide_count(codes: np.ndarray) -> int:
    """Number of distinct adjacent-pair codes over the 5-letter alphabet.

    Matches utils.CountDinuc (/root/reference/utils/entropy.go:5-40): pairs
    are formed over consecutive positions; a length-<2 sequence has 0
    distinct dinucleotides.
    """
    if len(codes) < 2:
        return 0
    pairs = codes[:-1].astype(np.int32) * NBASE + codes[1:]
    return int(np.unique(pairs).size)
