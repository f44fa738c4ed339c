"""Training schedules as pure functions of (epoch, iteration) (ref: train.py).

All schedules feed the `Hyper` bundle of one iteration.  The port's own copy
of the JAX package's training/schedules.py: host code on numpy, no torch."""

from __future__ import annotations

import numpy as np


def polynomial_decay(epoch, decay_factor, power, initial_rate=1.0):
    """ref: train.py:26-29."""
    return float(np.minimum(
        initial_rate,
        initial_rate * 1.0 / (decay_factor * (1 + epoch)) ** power))


def soft_sampling_probs(opt, epoch, epoch_start):
    """Softmax cooling of the partial-sampling probabilities toward 1
    (ref: train.py:32-46).  Returns (prob_gumbel_softmax, prob_multinomial_soft)."""
    pg, pm = opt.prob_gumbel_softmax, opt.prob_multinomial_soft
    if opt.softmax_cooling_decay_factor > 0:
        cooled = 1.0 - polynomial_decay(
            epoch - epoch_start, opt.softmax_cooling_decay_factor, power=0.5)
        if opt.retrieval_reward == "multinomial_soft":
            pm = cooled
        elif opt.retrieval_reward == "gumbel_softmax":
            pg = cooled
    return pg, pm


def current_lr(opt, epoch):
    """Epoch-step LR decay (ref: train.py:50-77)."""
    if epoch > opt.learning_rate_decay_start >= 0:
        frac = (epoch - opt.learning_rate_decay_start) // \
            opt.learning_rate_decay_every
        return opt.learning_rate * (opt.learning_rate_decay_rate ** frac)
    return opt.learning_rate


def scheduled_sampling_prob(opt, epoch):
    """ref: train.py:80-85."""
    if epoch > opt.scheduled_sampling_start >= 0:
        frac = (epoch - opt.scheduled_sampling_start) // \
            opt.scheduled_sampling_increase_every
        return min(opt.scheduled_sampling_increase_prob * frac,
                   opt.scheduled_sampling_max_prob)
    return 0.0


def vse_max_violation_w(opt, iteration):
    """Effective max-violation weight for the contrastive hinge at this
    iteration.  Extension (not in the reference): the VSE++ hardest-negative
    hinge can fail to escape random init (all hinge terms saturated at margin,
    gradient from one random negative per row); the standard recipe warms up
    with the mean hinge, then switches.  With vse_hinge_warmup_iters=0 this
    is constantly opt.vse_max_violation — reference behavior
    (VSEFCModel.py:149-207)."""
    if iteration < int(getattr(opt, "vse_hinge_warmup_iters", 0) or 0):
        return 0.0
    return float(opt.vse_max_violation)


def retrieval_reward_weight(opt, epoch):
    """ref: train.py:88-92."""
    if epoch > opt.retrieval_reward_weight_decay_start >= 0:
        frac = (epoch - opt.retrieval_reward_weight_decay_start) // \
            opt.retrieval_reward_weight_decay_every
        return opt.retrieval_reward_weight * \
            (opt.retrieval_reward_weight_decay_rate ** frac)
    return opt.retrieval_reward_weight


def anneal_gumbel_temp(gumbel_temp, opt, iteration, iteration_start=177000):
    """Multiplicative exponential annealing, floor factor 0.5
    (ref: train.py:399-414).  Stateful: caller feeds back the returned temp."""
    frac = max(0.5, float(np.exp(
        -opt.gumbel_temperature_annealing_factor * (iteration - iteration_start))))
    return gumbel_temp * frac


def should_anneal(opt, iteration):
    """ref: train.py:432-434."""
    return (opt.gumbel_temperature_annealing_factor > 0 and
            iteration % opt.num_iteration_for_annealing == 0)
