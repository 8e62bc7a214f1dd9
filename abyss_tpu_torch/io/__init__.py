"""IO: FASTA/FASTQ readers (native C++ or pure Python) + graph formats.

`read_batches` prefers the native zlib/C++ reader (native/fastx.cpp)
and silently falls back to the Python implementation when no toolchain
is available — both produce identical batches (tests/test_native_io.py).
"""

from ..utils import trace
from . import fastx


def read_batches(*args, **kwargs):
    """Each batch is read inside its own `io.fastq_batch` span."""
    from . import native_fastx
    if native_fastx.available():
        batches = native_fastx.read_batches(*args, **kwargs)
    else:
        batches = fastx.read_batches(*args, **kwargs)
    return trace.each("io.fastq_batch", batches)
