"""Compile-time constants of the pipeline.

These mirror the reference's CMake-injected definitions
(reference CMakeDefinitions.txt:46-69) so that assembly output is
comparable; they are plain Python constants here and become static arguments
baked into jitted kernels.
"""

# Base codes. A=0, C=1, G=2, T=3 exactly as the reference's 2-bit packing
# (reference src/kmer.cpp:298-320: x = ((c&4)>>1); code = x + ((x ^ (c&2))>>1)).
BASE_A = 0
BASE_C = 1
BASE_G = 2
BASE_T = 3
# Sentinel for N/invalid bases in our uint8 base-code arrays (not packed).
BASE_N = 4
# Sentinel for "no extension" (reference uses char '0' for low-quality exts,
# cf. src/kcount/kcount_cpu.cpp:321-324). Code 5 in ext one-hot space is
# ignored by the counters.
EXT_NONE = 5

BASE_CHARS = "ACGTN"

# Quality threshold: bases with phred < 20 only contribute kmer presence, not
# extensions (reference CMakeDefinitions.txt KCOUNT_QUAL_CUTOFF=20,
# src/kcount/kcount.cpp:80-85).
QUAL_CUTOFF = 20

# Dynamic minimum-depth fraction for extension calls
# (reference CMakeDefinitions.txt DYN_MIN_DEPTH=0.9, used in
# src/kcount/kcount_cpu.cpp:173-182).
DYN_MIN_DEPTH = 0.9

# Default minimum count threshold for a distinct high-count extension
# (reference src/options.hpp:96 dmin_thres=2).
DEFAULT_DMIN_THRES = 2

# k-mer counts saturate at uint16 (reference kmer_dht.hpp:54 kmer_count_t).
MAX_KMER_COUNT = 0xFFFF

# Minimizer length: clamp(2k/3+1, 15, 27) (reference src/kcount/kmer_dht.cpp:114-116).
MINIMIZER_LEN_MIN = 15
MINIMIZER_LEN_MAX = 27


def minimizer_len_for_k(k: int) -> int:
    m = k * 2 // 3 + 1
    return max(MINIMIZER_LEN_MIN, min(MINIMIZER_LEN_MAX, m))


# Default contigging k progression (reference src/options.cpp:372-377).
DEFAULT_KMER_LENS = (21, 33, 55, 77, 99)

# Default qual offset (reference src/options.hpp:91).
DEFAULT_QUAL_OFFSET = 33

# Minimum contig length printed in final assembly (reference src/options.hpp:109).
DEFAULT_MIN_CTG_PRINT_LEN = 500

# Extension call codes produced by the counting stage: 0..3 = A,C,G,T,
# 4 = 'F' (fork), 5 = 'X' (deadend / below depth).
EXT_F = 4
EXT_X = 5
EXT_CALL_CHARS = "ACGTFX"


def words32_for_k(k: int) -> int:
    """Number of uint32 words for a k-mer key.

    The reference packs 2 bits/base MSB-first into uint64 words
    (N_LONGS = (MAX_K+31)/32, src/kmer.hpp:64). We use uint32 words in
    [hi0, lo0, hi1, lo1, ...] order so that lexicographic comparison over the
    uint32 array equals the reference's uint64-array comparison; trailing bits
    beyond k are zero. Each uint64 long is always materialized as 2 uint32
    words (even if k <= 16 bases would fit in one).
    """
    n_longs = (k + 31) // 32
    return 2 * n_longs


def max_k_bucket(k: int) -> int:
    """Template dispatch bucket, mirroring main.cpp:170 (kmer_len/32+1)*32."""
    return (k // 32 + 1) * 32
