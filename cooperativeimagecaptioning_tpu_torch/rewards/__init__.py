"""Reward engines: the host CIDEr-D scorer and the self-critical reward
over it."""
