"""Host-side IO: sequence codecs, snappy streams, fastq/fasta parsing."""

from . import reads, seqcodec, sz, targets  # noqa: F401
