"""Byte-level sequence encoding into the 8-letter alphabet.

TPU-first layout: sequences are encoded ONCE on the host into uint8 code
arrays (numpy LUT at memory bandwidth); devices only ever see code arrays.
This replaces the reference's on-GPU compress_string /
compress_string_rev_comp kernels (reference/src/seed_filter.cu:110-155)
— on TPU there is no reason to ship raw ASCII to the device.
"""

from __future__ import annotations

import numpy as np

from ..constants import A_NT, C_NT, G_NT, T_NT, L_NT, N_NT, X_NT, E_NT

# char -> code, mirroring compress_string_rev_comp's forward map
# (reference/src/seed_filter.cu:120-152): everything not explicitly
# listed becomes X.
ENCODE_LUT = np.full(256, X_NT, dtype=np.uint8)
ENCODE_LUT[ord("A")] = A_NT
ENCODE_LUT[ord("C")] = C_NT
ENCODE_LUT[ord("G")] = G_NT
ENCODE_LUT[ord("T")] = T_NT
for c in b"acgt":
    ENCODE_LUT[c] = L_NT
for c in b"nN":
    ENCODE_LUT[c] = N_NT
ENCODE_LUT[ord("&")] = E_NT

# code -> complement code: A<->T, C<->G; L,N,E map to themselves and anything
# else to X, matching the reverse map of compress_string_rev_comp and
# rev_comp_string (reference/repeat_masker_src/seed_filter.cu:137-167).
COMPLEMENT_LUT = np.array(
    [T_NT, G_NT, C_NT, A_NT, L_NT, N_NT, X_NT, E_NT], dtype=np.uint8)


def encode(seq_bytes: np.ndarray | bytes) -> np.ndarray:
    """ASCII bytes -> uint8 codes."""
    arr = np.frombuffer(seq_bytes, dtype=np.uint8) if isinstance(
        seq_bytes, (bytes, bytearray, memoryview)) else seq_bytes
    return ENCODE_LUT[arr]


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement in code space.

    Equivalent to RevComp on chars followed by encode
    (reference/common/ntcoding.cpp:63-105): byte-wise complement of the
    reversed array; separators and masks are preserved.
    """
    return COMPLEMENT_LUT[codes[::-1]]
