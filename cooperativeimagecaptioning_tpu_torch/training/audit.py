"""Runtime gradient-isolation audit (counterpart of the JAX package's
training/audit.py; ref AlternatingJointModel.py:571-686
changeModelUpdateStatus / UpdateError).

After an optimizer step, compare each agent's leaves with a copy taken
before it, and raise:

  * UpdateError when an agent's updated/frozen status contradicts the
    turn's expected agent set (the reference's whole-model check,
    :625-634/:672-681);
  * a warning (like the reference's caught-and-printed per-layer error,
    :615-623) when leaves within one agent disagree -- legitimate zero
    gradients (an unused head) can cause this, so it is not fatal.

The port's Adam updates in place, so the Trainer clones the params before
the step (`snapshot`), and only with --audit_grad_isolation 1: nothing is
copied when it is off.  The per-leaf flags any(old != new) are computed on
the device and moved to the host in one transfer.
"""

from __future__ import annotations

import warnings

import torch

from cooperativeimagecaptioning_tpu_torch.utils.tree import leaves


class UpdateError(Exception):
    """An agent was (not) updated against the turn's expectations."""


def snapshot(params):
    """A copy of the joint tree's leaves, {agent: [(path, tensor)]}."""
    with torch.no_grad():
        return {agent: [(k, x.detach().clone()) for k, x in leaves(tree)]
                for agent, tree in params.items()}


def _changed_flags(prev, new_tree):
    """Per leaf any(old != new): one stacked flag tensor, one transfer."""
    new = dict(leaves(new_tree))
    with torch.no_grad():
        flags = torch.stack([(old != new[k]).any() for k, old in prev])
    return flags.tolist()


def audit_update(prev_params, new_params, expected_agents):
    """Verify per-agent update isolation for one optimizer step.

    prev_params: `snapshot` of the joint tree before `optim.step`;
    new_params: the tree after it; expected_agents: the agents that were
    supposed to step this turn.
    Returns {agent: {'updated': bool, 'consistent': bool}}.
    """
    report = {}
    for agent in prev_params:
        flags = _changed_flags(prev_params[agent], new_params[agent])
        updated = any(flags)
        consistent = all(f == flags[0] for f in flags)
        report[agent] = {"updated": updated, "consistent": consistent}
        expected = agent in expected_agents
        if updated != expected:
            raise UpdateError(
                f"{agent} update status was supposed to be {expected} "
                f"but in fact was {updated}")
        if not consistent:
            warnings.warn(
                f"{agent} had inconsistent update status across its "
                f"parameters (some leaves changed, some did not — zero "
                f"gradients or a masked update)", stacklevel=2)
    return report
