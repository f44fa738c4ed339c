"""Native (C++) host components of the port: PTB tokenizer, METEOR, Porter
stemmer, the npy/npz feature reader and SPICE-lite.

Copies of the JAX package's native/*.cpp (host code that depends on no
framework), built by bindings.py into build/native/ of the checkout."""
