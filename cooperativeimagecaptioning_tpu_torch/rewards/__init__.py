"""Reward engines: the host CIDEr-D scorer."""
