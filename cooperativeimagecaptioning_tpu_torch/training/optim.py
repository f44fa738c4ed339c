"""Per-agent optimizers (counterpart of the JAX package's
training/optim.py; ref optimizer.py).

One Adam per agent ('speaker', 'listener'), with the JAX package's update
rule, in this order (optim.py:25-35, an optax chain there):
  * element-wise gradient clamp to +/- grad_clip (ref misc/utils.py:65-69);
  * coupled L2: weight_decay * param added to the clamped gradient;
  * Adam: b1 = optim_alpha, b2 = optim_beta, bias-corrected moments, eps
    outside the square root (optax.scale_by_adam);
  * times -lr, added to the params.
Here it is a functional Adam over the param tree, updating params and
moments in place.  The non-finite guard stays on the device: one
all(isfinite) over the updated agents' gradients selects, through
torch.where, between the new and the old params *and* moments, and a
device counter counts the skipped steps; nothing forces a host sync.
"""

from __future__ import annotations

import torch

from cooperativeimagecaptioning_tpu_torch.parallel import collectives
from cooperativeimagecaptioning_tpu_torch.utils.tree import leaves


def effective_turns(opt):
    """Turn list after the reference's listener-nesting rule
    (optimizer.py:90-96)."""
    if not opt.is_alternating:
        return ["optimizer"]
    turns = list(opt.alternating_turn or ["speaker"])
    if opt.retrieval_reward != "reinforce" and "listener" in turns and \
            "speaker" in turns:
        turns.remove("listener")
    return turns


def agents_to_update(opt, turn: str):
    """Which param subtrees step this iteration."""
    if opt.is_alternating:
        if opt.retrieval_reward == "reinforce":
            return ("speaker",) if turn == "speaker" else ("listener",)
        return ("speaker", "listener")
    if opt.phase == 1:
        return ("listener",)
    return ("speaker",)


def adam_init(tree):
    """Adam state of one agent: step count and the two moments, zeros."""
    first = leaves(tree)[0][1]
    zeros = [torch.zeros_like(x, memory_format=torch.contiguous_format)
             for _, x in leaves(tree)]
    return {"count": torch.zeros((), dtype=torch.int32, device=first.device),
            "mu": zeros,
            "nu": [torch.zeros_like(z) for z in zeros]}


def guarded_update(opt, params, grads, states, agents, lr, group=None):
    """Apply one guarded Adam step to each agent in `agents`, in place.

    A NaN or inf in any gradient of an updated agent leaves params and
    moments (and the step count) untouched.  `lr` is a Python float, or a
    0-d tensor on the params' device (a fused chunk's staged rate, which
    its CUDA graph reads); params, moments and counts are written in place,
    so a graph that captured the update keeps its buffers.  With `group` (a mesh run's
    world) the flag is the MIN over the group, so every rank takes or skips
    the step together, as the JAX package's single GSPMD flag does
    (optim.py:102-123).  Returns `ok`, a 0-d bool tensor on the device."""
    grads_of = {a: [g for _, g in leaves(grads[a])] for a in agents}
    ok = torch.stack([torch.isfinite(g).all()
                      for a in agents for g in grads_of[a]]).all()
    if group is not None:
        ok = collectives.all_reduce(ok.to(torch.int32), group, "min").bool()
    b1, b2, eps = opt.optim_alpha, opt.optim_beta, opt.optim_epsilon
    with torch.no_grad():
        for agent in agents:
            st = states[agent]
            count = st["count"] + 1
            # bias corrections in float32, as optax computes decay**count
            c = count.to(torch.float32)
            bc1 = 1 - torch.pow(torch.full((), b1, device=c.device), c)
            bc2 = 1 - torch.pow(torch.full((), b2, device=c.device), c)
            params_of = [p for _, p in leaves(params[agent])]
            for p, g, mu, nu in zip(params_of, grads_of[agent], st["mu"],
                                    st["nu"]):
                g = torch.clamp(g, -opt.grad_clip, opt.grad_clip)
                if opt.weight_decay:
                    g = g + opt.weight_decay * p
                mu_new = (1 - b1) * g + b1 * mu
                nu_new = (1 - b2) * (g * g) + b2 * nu
                upd = (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + eps)
                p.copy_(torch.where(ok, p + (-lr) * upd, p))
                mu.copy_(torch.where(ok, mu_new, mu))
                nu.copy_(torch.where(ok, nu_new, nu))
            # in place: a captured graph holds this tensor's address
            st["count"].copy_(torch.where(ok, count, st["count"]))
    return ok


class OptimizerManager:
    """One Adam state per agent; applies per-turn guarded updates.  On a
    mesh (`group`: its world) each rank keeps the moments of its own slices
    and the non-finite flag is taken over the group."""

    def __init__(self, opt, params, group=None):
        self.opt = opt
        self.group = group
        self.states = {agent: adam_init(tree)
                       for agent, tree in params.items()}
        # each agent's leaf paths, in the order of its moment lists
        self.paths = {agent: [k for k, _ in leaves(tree)]
                      for agent, tree in params.items()}
        self.lr = float(opt.learning_rate)
        first = leaves(params)[0][1]
        self._skipped = torch.zeros((), dtype=torch.int32,
                                    device=first.device)
        self.last_step_ok = None

    def set_lr(self, lr: float):
        self.lr = float(lr)

    def step(self, params, grads, turn: str, lr=None):
        """Update `params` in place for the agents of this turn, at `lr`
        (a 0-d tensor: a fused chunk's staged rate) or the current rate."""
        agents = tuple(a for a in agents_to_update(self.opt, turn)
                       if a in params)
        ok = guarded_update(self.opt, params, grads, self.states, agents,
                            self.lr if lr is None else lr, self.group)
        self.last_step_ok = ok
        self._skipped += (~ok).to(torch.int32)
        return params

    def state_dict(self):
        """The live Adam states, {agent: {'count', 'mu': [...], 'nu':
        [...]}} (JAX optim.py:95-99); the moment lists follow
        `self.paths[agent]`."""
        return self.states

    def load_state_dict(self, states):
        """Copy `states` (the layout of state_dict, tensors or numpy
        arrays; any subset of the agents) into the live states, onto each
        leaf's device and dtype."""
        with torch.no_grad():
            for agent, st in states.items():
                cur = self.states[agent]
                cur["count"].copy_(torch.as_tensor(st["count"]))
                for key in ("mu", "nu"):
                    if len(st[key]) != len(cur[key]):
                        raise ValueError(
                            f"{agent} {key}: {len(st[key])} leaves, the "
                            f"params have {len(cur[key])}")
                    for dst, src in zip(cur[key], st[key]):
                        dst.copy_(torch.as_tensor(src))

    def skipped_steps(self) -> int:
        """Steps the non-finite guard rejected so far (a host sync: call at
        log or checkpoint time, not per iteration)."""
        return int(self._skipped)
