"""Evaluation stack: eval_split and the language metrics."""
