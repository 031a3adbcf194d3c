"""Device ops: bit-packed k-mers, counting, joins, and the CUDA kernels of
the contigging path.

Re-exports the names of mhm2_proxy_tpu/ops/__init__.py from the port's
modules. Signatures that differ from the reference's:
- read_kmer_records(codes, qual_ok, lens, k, depth=None, n_shards=1) takes
  no minimizer length m (it follows from k, constants.minimizer_len_for_k)
  and no use_pallas;
- k-mer words are int32 tensors holding u32 bits (ops/u32.py), and lex_less
  compares them in u32 order.
"""
from .bitkmer import (  # noqa: F401
    kmer_words_from_codes,
    revcomp_words,
    canonicalize_words,
    lex_less,
    minimizers_from_codes,
    quick_hash_u64,
    forward_base_words,
    backward_base_words,
    ascii_to_codes,
    codes_to_ascii,
    words_to_strings,
    strings_to_words,
)
from .count import (  # noqa: F401
    read_kmer_records,
    aggregate_records,
    merge_aggregates,
    finalize_table,
)
from .lookup import table_lookup  # noqa: F401
