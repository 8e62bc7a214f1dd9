"""FASTA/FASTQ reading and writing with batched device-ready output.

Covers the capability of the reference's DataLayer
(DataLayer/FastaReader.{h,cpp}): FASTA and FASTQ input,
transparent gzip decompression (cf. Common/Uncompress.cpp — the
reference forks a decompressor; we use the gzip module), chastity
filtering, and quality trimming (`q` option, DataLayer/Options.h).

The device-facing API yields fixed-shape padded batches of base codes —
the device-batch equivalent of the reference's 1 MB OpenMP read chunks
(BloomDBG/BloomIO.h:62-95).
"""

from __future__ import annotations

import gzip
import io
import os
from dataclasses import dataclass
from typing import Iterable, Iterator, Sequence

import numpy as np

from ..core import alphabet


@dataclass
class FastxRecord:
    id: str
    seq: str
    qual: str | None = None
    comment: str = ""


def _open_text(path: str):
    """Transparent decompression (the Uncompress role,
    Common/Uncompress.cpp:38-51): gz/bz2/xz in-process, BAM/CRAM through
    `samtools view -h` when available, tar members via tarfile."""
    if path == "-":
        import sys
        return sys.stdin
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"))
    if path.endswith(".bz2"):
        import bz2
        return io.TextIOWrapper(bz2.open(path, "rb"))
    if path.endswith((".xz", ".lzma")):
        import lzma
        return io.TextIOWrapper(lzma.open(path, "rb"))
    if path.endswith((".bam", ".cram")):
        import shutil
        import subprocess
        if shutil.which("samtools") is None:
            raise ValueError(f"{path}: BAM/CRAM input needs samtools "
                             "on PATH (Uncompress.cpp pipes through it)")
        p = subprocess.Popen(["samtools", "view", "-h", path],
                             stdout=subprocess.PIPE, text=True)
        return p.stdout
    if path.endswith((".tar", ".tar.gz", ".tgz")):
        import tarfile
        tf = tarfile.open(path)

        def lines():
            for member in tf:
                fh = tf.extractfile(member)
                if fh is None:
                    continue
                for line in io.TextIOWrapper(fh):
                    # a member's unterminated final line must not merge
                    # with the next member's first line (tar members are
                    # independent files, Uncompress.cpp pipes them
                    # through `tar -xOf` which concatenates bytes — but
                    # FASTA records are line-oriented, so terminate)
                    yield line if line.endswith("\n") else line + "\n"
        # present the concatenated members as one stream
        return _IterStream(lines())
    return open(path, "r")


class _IterStream:
    """File-like over an iterator of lines: read(n)/readline()/__iter__
    with a shared pushback buffer (the FASTA parser mixes single-char
    reads with line reads)."""

    def __init__(self, it):
        self._it = it
        self._buf = ""

    def _fill(self) -> bool:
        if not self._buf:
            self._buf = next(self._it, "")
        return bool(self._buf)

    def read(self, n):
        self._fill()
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def readline(self):
        if not self._fill():
            return ""
        if "\n" in self._buf:
            i = self._buf.index("\n") + 1
            out, self._buf = self._buf[:i], self._buf[i:]
            return out
        out, self._buf = self._buf, ""
        return out

    def __iter__(self):
        while True:
            line = self.readline()
            if not line:
                return
            yield line


def _read_sam_as_reads(f, first_line: str) -> Iterator[FastxRecord]:
    """SAM input treated as a read source (FastaReader.cpp:325 parses
    SAM records into reads; flag 0x10 reads are reverse-complemented
    back, secondary alignments skipped)."""
    from ..core.alphabet import revcomp

    def records():
        if not first_line.startswith("@") or "\t" in first_line:
            yield first_line
        yield from f
    for line in records():
        if not line.strip() or line.startswith("@") and "\t" not in line:
            continue
        fields = line.rstrip("\n").split("\t")
        if len(fields) < 11:
            continue
        qname, flag, _, _, _, _, _, _, _, seq, qual = fields[:11]
        flag = int(flag)
        if flag & 0x100 or seq == "*":
            continue
        if flag & 0x10:
            seq = revcomp(seq)
            qual = qual[::-1] if qual != "*" else None
        if flag & 0x40:
            qname += "/1"
        elif flag & 0x80:
            qname += "/2"
        yield FastxRecord(qname, seq, None if qual == "*" else qual)


def read_fastx(path) -> Iterator[FastxRecord]:
    """Iterate records of a FASTA/FASTQ/SAM file or file-like object
    (format auto-detected, like DataLayer/FastaReader.cpp)."""
    if hasattr(path, "read"):
        f = path
        path = "-"
    else:
        f = _open_text(path)
    try:
        first = f.read(1)
        if not first:
            return
        if first == ">":
            yield from _read_fasta(f)
        elif first == "@":
            # FASTQ or SAM-with-header: peek at the first line
            line = first + next(iter(f), "")
            if "\t" in line:  # SAM header line like "@HD\t..."
                yield from _read_sam_as_reads(f, line)
            else:
                yield from _read_fastq(f, first_header=line)
        else:
            # headerless SAM body (rare) or qseq/export tab format
            line = first + next(iter(f), "")
            if "\t" in line:
                fields = line.rstrip("\n").split("\t")
                # qseq/export: field 8 is the sequence, trailing 0/1
                # chastity flag (FastaReader.cpp's qseq branch); SAM has
                # the CIGAR in field 5 and the sequence in field 9
                is_qseq = (len(fields) >= 10 and
                           set(fields[8]) <= set("ACGTN.acgtn") and
                           fields[-1] in ("0", "1"))
                if is_qseq:
                    yield from _read_qseq(f, line)
                elif len(fields) >= 11:
                    yield from _read_sam_as_reads(f, line)
                else:
                    yield from _read_qseq(f, line)
            else:
                raise ValueError(
                    f"{path}: unrecognized format (starts {first!r})")
    finally:
        if f is not None and path != "-" and hasattr(f, "close"):
            f.close()


def _read_qseq(f, first_line: str) -> Iterator[FastxRecord]:
    """Illumina qseq/export tab format (FastaReader.cpp qseq branch):
    machine run lane tile x y index read seq qual [filter]."""
    def records():
        yield first_line
        yield from f
    for line in records():
        fields = line.rstrip("\n").split("\t")
        if len(fields) < 10:
            continue
        name = "_".join(fields[0:6]) + "/" + fields[7]
        seq = fields[8].replace(".", "N")
        qual = fields[9]
        chaste = fields[10] if len(fields) > 10 else "1"
        yield FastxRecord(name, seq, qual, comment=chaste)


def _split_header(line: str) -> tuple[str, str]:
    line = line.rstrip("\n")
    if " " in line:
        i = line.index(" ")
        return line[:i], line[i + 1:]
    if "\t" in line:
        i = line.index("\t")
        return line[:i], line[i + 1:]
    return line, ""


def _read_fasta(f) -> Iterator[FastxRecord]:
    header = f.readline()  # rest of first header line (">" consumed)
    while header:
        rid, comment = _split_header(header)
        chunks = []
        line = f.readline()
        while line and not line.startswith(">") and \
                not line.startswith("@"):
            chunks.append(line.strip())
            line = f.readline()
        yield FastxRecord(rid, "".join(chunks), None, comment)
        if line.startswith("@"):
            # per-record format switch (FastaReader handles mixed
            # FASTA/FASTQ streams, e.g. concatenated tar members)
            yield from _read_fastq(f, first_header=line)
            return
        header = line[1:] if line else ""


def _read_fastq(f, first_header: str | None = None) -> Iterator[FastxRecord]:
    if first_header is not None:
        header = first_header[1:]  # strip the "@"
    else:
        header = f.readline()  # rest of first header ("@" consumed)
    while header:
        rid, comment = _split_header(header)
        seq = f.readline().strip()
        plus = f.readline()
        if not plus.startswith("+"):
            raise ValueError("malformed FASTQ: expected '+' line")
        qual = f.readline().strip()
        yield FastxRecord(rid, seq, qual, comment)
        line = f.readline()
        if line.startswith(">"):
            # symmetric per-record format switch back to FASTA
            yield from _read_fasta(_PushbackLine(f, line[1:]))
            return
        header = line[1:] if line else ""


class _PushbackLine:
    """Wrap a line-oriented stream with one pushed-back first line."""

    def __init__(self, f, first: str):
        self._f = f
        self._first = first

    def readline(self):
        if self._first is not None:
            out, self._first = self._first, None
            return out
        return self._f.readline()


def is_chaste(comment: str) -> bool:
    """Illumina chastity filter (FastaReader::isChaste,
    DataLayer/FastaReader.cpp): CASAVA 1.8 '<read>:<N|Y>:...' — Y means
    filtered out; pre-1.8 qseq-style trailing 0/1 field — 1 is chaste."""
    if not comment:
        return True
    fields = comment.split()
    for fld in fields:
        parts = fld.split(":")
        if len(parts) >= 2 and parts[0] in ("1", "2", "3") and \
                parts[1] in ("Y", "N"):
            return parts[1] == "N"
    last = fields[-1]
    if last in ("0", "1"):
        return last == "1"
    return True


def trim_quality(seq: str, qual: str | None, q: int, ascii_offset: int = 33,
                 ) -> str:
    """Trim low-quality bases (< q) from both ends of the read, like the
    reference's -q option (DataLayer/FastaReader.cpp quality trimming)."""
    if not qual or q <= 0:
        return seq
    lo, hi = 0, len(seq)
    while lo < hi and ord(qual[lo]) - ascii_offset < q:
        lo += 1
    while hi > lo and ord(qual[hi - 1]) - ascii_offset < q:
        hi -= 1
    return seq[lo:hi]


@dataclass
class ReadBatch:
    """Fixed-shape batch of encoded reads.

    codes: uint8[B, L] base codes, BAD(4)-padded.
    lengths: int32[B] true lengths (0 for padding rows).
    ids: read names (len == number of real rows).
    """

    codes: np.ndarray
    lengths: np.ndarray
    ids: list
    comments: list | None = None  # header comments (e.g. BX:Z: barcodes)

    @property
    def num_reads(self) -> int:
        return len(self.ids)


def read_batches(paths: Sequence[str] | str, batch_size: int = 16384,
                 max_len: int = 512, q: int = 0, chastity: bool = True,
                 ) -> Iterator[ReadBatch]:
    """Stream fixed-shape batches of encoded reads from FASTA/FASTQ files.

    Reads longer than max_len are split into max_len-sized pieces with a
    (max_len // 2)-overlap so every k-mer (k <= max_len/2) is still seen.
    """
    if isinstance(paths, str):
        paths = [paths]

    buf_codes = np.full((batch_size, max_len), alphabet.BAD, np.uint8)
    buf_len = np.zeros(batch_size, np.int32)
    ids: list = []
    comments: list = []

    def flush():
        nonlocal buf_codes, buf_len, ids, comments
        out = ReadBatch(buf_codes, buf_len, ids, comments)
        buf_codes = np.full((batch_size, max_len), alphabet.BAD, np.uint8)
        buf_len = np.zeros(batch_size, np.int32)
        ids = []
        comments = []
        return out

    def add(rid: str, codes: np.ndarray, comment: str = ""):
        nonlocal ids
        n = len(ids)
        L = min(len(codes), max_len)
        buf_codes[n, :L] = codes[:L]
        buf_len[n] = L
        ids.append(rid)
        comments.append(comment)

    for path in paths:
        for rec in read_fastx(path):
            if chastity and not is_chaste(rec.comment):
                continue
            seq = trim_quality(rec.seq, rec.qual, q)
            if not seq:
                continue
            codes = alphabet.encode(seq)
            if len(codes) <= max_len:
                pieces = [(rec.id, codes)]
            else:
                step = max_len // 2
                pieces = [
                    (f"{rec.id}:{off}", codes[off:off + max_len])
                    for off in range(0, len(codes) - max_len // 2, step)]
            for rid, piece in pieces:
                add(rid, piece, rec.comment)
                if len(ids) == batch_size:
                    yield flush()
    if ids:
        yield flush()


def write_fasta(path_or_file, records: Iterable[tuple[str, str]],
                wrap: int = 0):
    """Write (header, seq) records as FASTA. wrap=0 → single-line seqs
    (matching the reference's FastaWriter output used by assembly stages)."""
    own = isinstance(path_or_file, (str, os.PathLike))
    f = open(path_or_file, "w") if own else path_or_file
    try:
        for header, seq in records:
            f.write(f">{header}\n")
            if wrap and wrap > 0:
                for i in range(0, len(seq), wrap):
                    f.write(seq[i:i + wrap] + "\n")
            else:
                f.write(seq + "\n")
    finally:
        if own:
            f.close()
