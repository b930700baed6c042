"""Alphabet codes and fixed parameters of the SegAlign data model.

The 8-letter alphabet mirrors the reference's nucleotide coding
(reference/common/parameters.h:3-13): A,C,G,T are the 2-bit bases used
for k-mer packing; L marks soft-masked (lower-case) bases; N ambiguous; X any
other character (fill); E the '&' separator inserted between chromosomes,
which acts as an impassable wall for extension (scored -10*xdrop).
"""

TRANSITION_MASK = 2  # XOR of a 2-bit base code with 0b10 == transition (A<->G, C<->T)

NUC = 8
NUC2 = NUC * NUC

A_NT = 0
C_NT = 1
G_NT = 2
T_NT = 3
L_NT = 4  # lower-case (soft-masked) acgt
N_NT = 5  # n / N
X_NT = 6  # anything else
E_NT = 7  # '&' inter-chromosome separator

# k-mer sentinel for windows containing any non-uppercase-ACGT character
# (reference/common/ntcoding.h:1)
INVALID_KMER = 1 << 31

# Work granularity of the pipeline (reference/src/graph.h:10-14 and
# reference/repeat_masker_src/graph.h:10-12).
DEFAULT_SEQ_BLOCK_SIZE = 500_000_000
DEFAULT_SEQ_BLOCK_SIZE_RM = 1_000_000_000
DEFAULT_LASTZ_INTERVAL = 10_000_000
DEFAULT_WGA_CHUNK = 250_000
BUFFER_DEPTH = 2

VERSION = "0.1.0"
