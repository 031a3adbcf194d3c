from .kmer_store import KmerCountStore, FinalTable  # noqa: F401
