"""HuffmanCoder facade over the canonical codebook + native/device engines.

Reference parity: ``ivclab/entropy/huffman.py:5-52`` (train/encode/decode/
is_prefix_free over a contiguous ``lower_bound``-offset alphabet, returning
``(u32 word array, bitrate_bits)``). The reference loops Python->Rust per
symbol; here encode is a vectorized table gather + serial C++ pack on host
(or fully on device via ``ivclab_tpu.ops.bitpack`` in the codec hot path),
and decode is the serial C++ canonical decoder.

The stream format is this framework's own canonical MSB-first format —
losslessness (decode o encode = id) and optimal code lengths are the
contract, not stream equality with constriction.
"""

from __future__ import annotations

import itertools

import numpy as np

from ivclab_tpu.entropy.codebook import CanonicalCode, build_canonical_code
from ivclab_tpu.runtime import native


class HuffmanCoder:
    def __init__(self, lower_bound: int = 0):
        self.lower_bound = int(lower_bound)
        self.pmf = None
        self.code: CanonicalCode | None = None

    # Back-compat alias used by reference callers (IntraCodecAdaptive
    # serializes self.huffman.pmf, ivclab/image/intracodec.py:252-256)
    @property
    def probs(self):
        return self.pmf

    def train(self, probs):
        probs = np.asarray(probs, dtype=np.float64)
        if np.any(probs == 0):
            raise ValueError(
                "Zero-probability symbols found in PMF. All symbols must have "
                "non-zero probability."
            )
        self.pmf = probs
        self.code = build_canonical_code(probs, lower_bound=self.lower_bound)
        return self

    def _require_trained(self) -> CanonicalCode:
        if self.code is None:
            raise RuntimeError("Train the Huffman coder before encoding/decoding.")
        return self.code

    def encode(self, message):
        """Encode a symbol array -> (u32 word array, bitrate in bits)."""
        code = self._require_trained()
        msg = np.asarray(message).reshape(-1).astype(np.int64)
        max_symbol = code.n - 1 + self.lower_bound
        if msg.size and (msg.min() < self.lower_bound or msg.max() > max_symbol):
            raise ValueError("Message contains symbols outside the trained range.")
        idx = (msg - self.lower_bound).astype(np.int64)
        words, total_bits = native.pack_bits(code.codes[idx], code.lengths[idx])
        return words, float(total_bits)

    def decode(self, compressed, message_length: int):
        """Decode ``message_length`` symbols from a u32 word array."""
        code = self._require_trained()
        words = np.asarray(compressed, dtype=np.uint32)
        idx = native.decode_symbols(words, int(message_length), code)
        return idx.astype(np.int64) + self.lower_bound

    def is_prefix_free(self) -> bool:
        """Pairwise prefix check (canonical codes are prefix-free by
        construction; this verifies it like ivclab/entropy/huffman.py:46-52).
        """
        code = self._require_trained()
        strs = [
            format(int(c), f"0{int(l)}b") for c, l in zip(code.codes, code.lengths)
        ]
        for a, b in itertools.combinations(strs, 2):
            if a.startswith(b) or b.startswith(a):
                return False
        return True

    def get_code(self, symbol_index: int):
        """Bit tuple of the codeword for a 0-based alphabet index."""
        code = self._require_trained()
        l = int(code.lengths[symbol_index])
        c = int(code.codes[symbol_index])
        return tuple((c >> (l - 1 - b)) & 1 for b in range(l))

    def mean_code_length(self) -> float:
        """Expected bits/symbol under the trained pmf."""
        code = self._require_trained()
        return float(np.sum(self.pmf * code.lengths) / np.sum(self.pmf))
