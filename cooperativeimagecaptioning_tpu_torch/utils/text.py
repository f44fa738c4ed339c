"""Text utilities (ref: misc/utils.py:23-37); the port's own copy of the JAX
package's utils/text.py."""

from __future__ import annotations

import numpy as np


def decode_sequence(ix_to_word: dict, seq) -> list:
    """IDs -> sentences; stop at the first 0 (ref: misc/utils.py:23-37)."""
    seq = np.asarray(seq)
    out = []
    for row in seq:
        words = []
        for ix in row:
            if int(ix) > 0:
                words.append(ix_to_word[str(int(ix))])
            else:
                break
        out.append(" ".join(words))
    return out
