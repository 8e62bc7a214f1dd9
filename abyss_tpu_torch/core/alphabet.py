"""DNA alphabet: 2-bit base codes and ASCII maps.

Base coding follows the reference convention A=0, C=1, G=2, T=3
(cf. Common/Sequence.cpp baseToCode); complement(code) is
3 - code.  Code 4 (`BAD`) marks non-ACGT characters (N, etc.); padded
positions also use BAD.
"""

from __future__ import annotations

import numpy as np

A, C, G, T = 0, 1, 2, 3
BAD = 4  # non-ACGT / padding sentinel
NUM_BASES = 4

BASES = np.frombuffer(b"ACGTN", dtype=np.uint8)

# ASCII → code table (case-insensitive); everything non-ACGT → BAD.
ASCII_TO_CODE = np.full(256, BAD, dtype=np.uint8)
for _i, _ch in enumerate("ACGT"):
    ASCII_TO_CODE[ord(_ch)] = _i
    ASCII_TO_CODE[ord(_ch.lower())] = _i

CODE_TO_ASCII = np.frombuffer(b"ACGTN", dtype=np.uint8)


def encode(seq: str | bytes) -> np.ndarray:
    """ASCII DNA string → uint8 code array (BAD for non-ACGT)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return ASCII_TO_CODE[np.frombuffer(seq, dtype=np.uint8)]


def decode(codes: np.ndarray) -> str:
    """uint8 code array → ASCII DNA string (BAD → 'N')."""
    codes = np.asarray(codes, dtype=np.uint8)
    return CODE_TO_ASCII[np.minimum(codes, BAD)].tobytes().decode("ascii")


def complement_codes(codes: np.ndarray) -> np.ndarray:
    """Complement 2-bit codes; BAD stays BAD."""
    codes = np.asarray(codes)
    out = (3 - codes.astype(np.int16)).astype(np.uint8)
    return np.where(codes >= BAD, np.uint8(BAD), out)


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement along the last axis."""
    return complement_codes(codes)[..., ::-1]


def revcomp(seq: str) -> str:
    return decode(revcomp_codes(encode(seq)))


# ---------------------------------------------------------------------------
# Colour space (SOLiD / AB two-base encoding).
#
# Reference: Common/Sequence.cpp:13-18 cstont[][] — which is exactly the
# XOR of the 2-bit base codes — and colourToNucleotideSpace /
# nucleotideToColourSpace (Common/Sequence.cpp:113-138).  A colour-space
# read is an anchor base followed by colours '0123'; the decoded base at
# position i+1 has code = code(base_i) XOR colour_i.

def is_colour_space(seq: str) -> bool:
    """True when seq looks like a colour-space read: [ACGT] then digits
    (FastaReader's detection, DataLayer/FastaReader.cpp)."""
    if len(seq) < 2:
        return False
    return seq[0].upper() in "ACGT" and all(c in "0123." for c in seq[1:])


def colour_to_nucleotide(anchor: str, colours: str) -> str:
    """colourToNucleotideSpace(anchor, seq): decode colours to bases,
    anchor base not included in the output (Common/Sequence.cpp:119-130)."""
    seed = int(ASCII_TO_CODE[ord(anchor)])
    out = []
    for c in colours:
        if c in "0123":
            seed = seed ^ int(c)
            out.append("ACGT"[seed])
        else:  # '4'/'.'/'N': undecodable; resync is impossible downstream
            seed = 0
            out.append("N")
    return "".join(out)


def nucleotide_to_colour(seq: str) -> str:
    """nucleotideToColourSpace over a whole read: first base kept as the
    anchor, then one colour per adjacent base pair
    (Common/Sequence.cpp:133-138)."""
    codes = encode(seq)
    bad = (codes[:-1] >= BAD) | (codes[1:] >= BAD)
    cols = codes[:-1] ^ codes[1:]
    body = "".join("." if b else "0123"[c] for c, b in zip(cols, bad))
    ok = codes[0] < BAD
    return (seq[0].upper() if ok else "N") + body
