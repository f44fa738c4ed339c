"""Training schedules: the JAX package's `training.schedules`, shared as is.

They are pure functions of (epoch, iteration) over the run options, and
that module imports only numpy and the standard library, never JAX (a
subprocess test keeps the port's trainer free of JAX)."""

from cooperativeimagecaptioning_tpu.training.schedules import (  # noqa: F401
    anneal_gumbel_temp, current_lr, polynomial_decay,
    retrieval_reward_weight, scheduled_sampling_prob, should_anneal,
    soft_sampling_probs, vse_max_violation_w)
