"""Training stack of the port: the three training phases and their turns
(`loop.Trainer`), their loss (`joint`), the per-agent Adam (`optim`), the
grad-isolation audit (`audit`), the schedules (`schedules`, shared with the
JAX package), and the pickled-numpy checkpoint format (`checkpoint`)."""
