"""PTB-style tokenizer (replaces the Stanford CoreNLP PTBTokenizer jar,
ref: coco-caption/pycocoevalcap/tokenizer/ptbtokenizer.py).

The reference invokes `PTBTokenizer -preserveLines -lowerCase` over one caption
per line and then strips a fixed punctuation list (ptbtokenizer.py:23-24,77-84).
For caption text (no URLs/abbrev-heavy prose) PTB tokenization reduces to:
lowercase, split off punctuation, expand contractions — implemented here with the
core PTB rules.  The port's own copy of the JAX package's metrics/tokenizer.py:
the C++ tokenizer of native/ (same contract) is used once it is built, and
this module is the pure-Python tier otherwise.
"""

from __future__ import annotations

import re

# punctuation removed *after* tokenization (ptbtokenizer.py:23-24)
PUNCTUATIONS = ["''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
                ".", "?", "!", ",", ":", "-", "--", "...", ";"]

_RULES = [
    (re.compile(r"^\""), r"`` "),
    (re.compile(r"([ (\[{<])\""), r"\1 `` "),
    (re.compile(r"\.\.\."), r" ... "),
    (re.compile(r"([,;:@#$%&])"), r" \1 "),
    (re.compile(r"([^.])(\.)([\]\)}>\"']*)\s*$"), r"\1 \2\3 "),
    (re.compile(r"([?!])"), r" \1 "),
    (re.compile(r"([\]\[(){}<>])"), r" \1 "),
    (re.compile(r"\("), "-LRB-"),
    (re.compile(r"\)"), "-RRB-"),
    (re.compile(r"\["), "-LSB-"),
    (re.compile(r"\]"), "-RSB-"),
    (re.compile(r"\{"), "-LCB-"),
    (re.compile(r"\}"), "-RCB-"),
    (re.compile(r"--"), r" -- "),
    (re.compile(r"\""), r" '' "),
    (re.compile(r"([^'])' "), r"\1 ' "),
    (re.compile(r"'([sSmMdD]) "), r" '\1 "),
    (re.compile(r"('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) "), r" \1 "),
]


def ptb_tokenize_line(line: str) -> list:
    s = " " + line.lower().strip() + " "
    for pat, repl in _RULES:
        s = pat.sub(repl, s)
    return s.split()


def tokenize(captions_for_image: dict) -> dict:
    """Same contract as PTBTokenizer.tokenize: {id: [{'caption': str}, ...]} ->
    {id: [tokenized strings]} with the punctuation list stripped."""
    from cooperativeimagecaptioning_tpu_torch.native import bindings
    if bindings.available():
        return bindings.ptb_tokenize(captions_for_image)
    out = {}
    for k, caps in captions_for_image.items():
        out[k] = []
        for c in caps:
            toks = [t for t in ptb_tokenize_line(c["caption"])
                    if t not in PUNCTUATIONS]
            out[k].append(" ".join(toks))
    return out
