"""Training stack of the port: phase-2 MLE training of the speaker
(`loop.Trainer`), its loss (`joint`), the per-agent Adam (`optim`), the
schedules (`schedules`, shared with the JAX package), and the pickled-numpy
checkpoint format (`checkpoint`)."""
