from .fastq import FastqReader, read_fastq, write_fastq  # noqa: F401
from .reads import PackedReads  # noqa: F401
from .fasta import write_fasta, read_fasta  # noqa: F401
