"""Language metrics: BLEU, ROUGE-L, METEOR and the PTB tokenizer (CIDEr-D is
rewards/cider_d.py).

The port's own copies of the JAX package's pure-Python scorers: host code,
no torch.  That package's C++ tier (native/) and SPICE are not ported yet
(ROADMAP.md queue 1)."""
