"""PARSEQ output tokenizer: token ids -> strings.

Own copy of `tuatara_tpu/tokenizer.py` for the PyTorch port (the port imports
nothing of the JAX package). Vocabulary layout matches the reference
(tuatara.cpp:36-39): index 0 is EOS, then the charset, then BOS, then PAD.

Charset: the reference's literal (tuatara.cpp:32-34) holds a stray backslash
between '&' and "'"; the default here is the standard 94-char PARSEQ charset,
and ``reference_charset=True`` selects the bug-compatible 95-char table.
EOS handling: ``mode="truncate"`` stops at the first true EOS (id 0), the
reference's observable behavior; ``mode="reference"`` also reproduces its
deletion of the charset ']' slot (tuatara.cpp:108-116).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

# Standard PARSEQ 94-char charset: digits, lowercase, uppercase, punctuation.
STANDARD_CHARSET = (
    "0123456789abcdefghijklmnopqrstuvwxyz"
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    "!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~"
)
assert len(STANDARD_CHARSET) == 94

# Bug-compatible reference charset: extra backslash between '&' and "'"
# (tuatara.cpp:33-34 decodes `"...%&" "\\'()..."` to this 95-char string).
REFERENCE_CHARSET = (
    "0123456789abcdefghijklmnopqrstuvwxyz"
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    "!\"#$%&\\'()*+,-./:;<=>?@[\\]^_`{|}~"
)
assert len(REFERENCE_CHARSET) == 95

# Extended charset: standard + space. The reference README lists "retrain
# PARSEQ to support a larger character set; the current model does not
# support the space character" as TODO (README.md:42); the training stack
# of the JAX package supports it with this charset and
# ParseqConfig(charset_size=95).
EXTENDED_CHARSET = STANDARD_CHARSET + " "


class Tokenizer:
    """Maps PARSEQ vocab ids to characters and decodes greedy predictions."""

    BOS = "["
    EOS = "]"
    PAD = "P"

    def __init__(self, reference_charset: bool = False, charset: str | None = None):
        """`charset` overrides the character table (e.g. EXTENDED_CHARSET for
        the space-aware retrain); `reference_charset` selects the
        bug-compatible 95-char table and is ignored when `charset` given."""
        if charset is None:
            charset = REFERENCE_CHARSET if reference_charset else STANDARD_CHARSET
        self.charset = charset
        # itos = [EOS] + charset + [BOS] + [PAD]  (tuatara.cpp:36-39)
        self.itos: str = self.EOS + charset + self.BOS + self.PAD
        # Later entries win on duplicate chars, matching std::map assignment
        # overwrite in the reference (tuatara.cpp:41-43).
        self.stoi = {c: i for i, c in enumerate(self.itos)}
        self.eos_id = 0
        self.bos_id = len(self.itos) - 2
        self.pad_id = len(self.itos) - 1

    @property
    def vocab_size(self) -> int:
        return len(self.itos)

    # ---- encoding (used by the trainer; the reference never encodes) ----

    def encode(
        self, text: str, max_length: int, on_oov: str = "error"
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Encode to ``[BOS, chars..., EOS, PAD...]`` ids of length max_length+2.

        Returns (ids, length) where length counts chars + EOS (the label
        positions a training loss should cover).

        Out-of-charset characters raise by default — silently mapping them
        (e.g. to PAD) would make the training loss optimize toward a wrong
        class. Pass on_oov="skip" to drop them instead (the reference model's
        no-space behavior), or use EXTENDED_CHARSET to cover space.
        """
        ids = [self.bos_id]
        for ch in text:
            if len(ids) > max_length:
                break
            idx = self.stoi.get(ch)
            if idx is None:
                if on_oov == "skip":
                    continue
                raise ValueError(
                    f"character {ch!r} not in charset; use "
                    "Tokenizer(charset=EXTENDED_CHARSET) or on_oov='skip'"
                )
            ids.append(idx)
        ids.append(self.eos_id)
        n = len(ids) - 1  # label positions: chars + EOS
        while len(ids) < max_length + 2:
            ids.append(self.pad_id)
        return np.asarray(ids, dtype=np.int32), np.asarray(n, dtype=np.int32)

    # ---- decoding ----

    def ids_to_text(self, ids: Sequence[int], mode: str = "truncate") -> str:
        """Convert one sequence of vocab ids to a string.

        mode="truncate": stop at the first true EOS (id 0) — upstream PARSEQ
        semantics, and the reference's observable behavior (its break at the
        ']' character is live; see module docstring).
        mode="reference": full bug-compat — positions whose id equals the
        *collapsed* stoi[']'] slot (the charset ']', id 87 in the standard table — what the
        reference's filter() mistakes for eos_id) are deleted, then the
        sequence truncates at the first id decoding to ']' (true EOS).
        """
        if mode == "reference":
            collapsed_eos = self.stoi[self.EOS]  # charset ']' slot, not 0
            out = []
            for i in ids:
                i = int(i)
                if i == collapsed_eos:
                    continue  # filter() deletion (tuatara.cpp:108-116)
                ch = self.itos[i]
                if ch == self.EOS:
                    break  # live char break (tuatara.cpp:497-501)
                out.append(ch)
            return "".join(out)
        out = []
        for i in ids:
            i = int(i)
            if i == self.eos_id:
                break
            out.append(self.itos[i])
        return "".join(out)

    def decode(
        self,
        token_dists: np.ndarray,
        raw: bool = False,
        mode: str = "truncate",
    ) -> List[str]:
        """Decode a batch of probability distributions, shape [N, L, C].

        Mirrors `Tokenizer::decode` (tuatara.cpp:61-78): per-position argmax,
        then EOS handling per `mode`. With raw=True, ids map straight through
        with no EOS handling (tuatara.cpp:69-74 raw path).
        """
        token_dists = np.asarray(token_dists)
        ids_batch = token_dists.argmax(axis=-1)
        return self.decode_ids(ids_batch, raw=raw, mode=mode)

    def decode_ids(
        self,
        ids_batch: np.ndarray,
        raw: bool = False,
        mode: str = "truncate",
    ) -> List[str]:
        """Decode a batch of argmax'd vocab ids, shape [N, L]."""
        out = []
        for ids in np.asarray(ids_batch):
            if raw:
                out.append("".join(self.itos[int(i)] for i in ids))
            else:
                out.append(self.ids_to_text(ids, mode=mode))
        return out
