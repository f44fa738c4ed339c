"""Language metrics: BLEU, ROUGE-L, METEOR, SPICE-lite and the PTB tokenizer
(CIDEr-D is rewards/cider_d.py).

The port's own copies of the JAX package's scorers: host code, no torch.
The tokenizer, METEOR and SPICE-lite run on the C++ tier of native/ once it
is built, and in pure Python otherwise."""
