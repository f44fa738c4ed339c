"""Checkpoints and run dirs in the JAX package's format and taxonomy
(counterpart of its training/checkpoint.py, the .pth tier; ref
train.py:95-159, 299-347, optimizer.py:149-221).

Per run dir (opt.checkpoint_path):
  model.pth / alternatingModel.pth (+ -<iter>, -best, model_vse-best)
      -> pickled nested dicts of numpy arrays (params); such a file written
         by either package loads in both;
  optimizer.pth / {speaker,listener}_optimizer.pth
      -> the port writes its own plain layout, {'count', 'mu': [...], 'nu':
         [...], 'paths': [...]} of numpy arrays (the moment lists in sorted
         leaf-path order); it reads that and the JAX package's pickled optax
         state, mapped by sorted leaf path, through a restricted unpickler
         that never imports optax (a JAX run reading a port-written file
         keeps a fresh state: its structure check fails);
  infos_<id>.pkl (+ -<iter>, -best), histories_<id>.pkl
      -> the reference's keys.
The orbax tier is not ported: orbax imports JAX, which the port never
imports.  A run whose options name it, and a model file that exists only as
its `.orbax` directory, raise NotImplementedError (`refuse_orbax`) instead
of training, evaluating or serving from initial weights.

Unpickling a params file runs code from it: load only checkpoints this
project wrote.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from cooperativeimagecaptioning_tpu_torch import config as config_mod
from cooperativeimagecaptioning_tpu_torch.utils.tree import (
    leaves, to_numpy, to_torch)


ORBAX = ("the orbax checkpoint tier is not ported: orbax imports JAX, which "
         "the port never imports (write the run with checkpoint_backend "
         "'pth')")


def orbax_sibling(path):
    """The `.orbax` directory the JAX package writes in place of a `.pth`
    under checkpoint_backend 'orbax' (JAX checkpoint.py:55-61), or None."""
    if path.endswith(".pth"):
        opath = path[:-4] + ".orbax"
        if os.path.isdir(opath):
            return opath
    return None


def refuse_orbax(path=None, opt=None):
    """Raise NotImplementedError when `opt` names the orbax backend, or when
    `path` is missing and its `.orbax` sibling stands in its place."""
    if opt is not None and \
            (getattr(opt, "checkpoint_backend", "pth") or "pth") == "orbax":
        raise NotImplementedError(f"checkpoint_backend 'orbax': {ORBAX}")
    if path is not None and not os.path.isfile(path):
        opath = orbax_sibling(path)
        if opath is not None:
            raise NotImplementedError(f"{opath}: {ORBAX}")


def save_params(params, path):
    """Write a tree of tensors (or numpy arrays) as pickled numpy."""
    with open(path, "wb") as f:
        pickle.dump(to_numpy(params), f)


def load_params(path, device="cpu"):
    """Read a pickled numpy tree into tensors on `device`."""
    refuse_orbax(path)
    with open(path, "rb") as f:
        return to_torch(pickle.load(f), device)


def load_params_into(params, path, strict=False):
    """Lenient merge like ref misc/utils.py:89-107 (JAX checkpoint.py:63-105):
    copy the leaves the checkpoint shares with `params` (onto each leaf's
    device and dtype), report the others, keep the rest.  A leaf of another
    shape is copied flat, as far as it reaches.  A `.pth` that exists only
    as its `.orbax` sibling raises (`refuse_orbax`)."""
    refuse_orbax(path)
    with open(path, "rb") as f:
        loaded = pickle.load(f)

    def merge(cur, new, prefix=""):
        if isinstance(cur, dict):
            out = {}
            for k, v in cur.items():
                if isinstance(new, dict) and k in new:
                    out[k] = merge(v, new[k], prefix + k + ".")
                else:
                    if strict:
                        raise KeyError(
                            f"missing key {prefix + k} in checkpoint")
                    print(f"key {prefix + k} not in loaded checkpoint")
                    out[k] = v
            for k in (new or {}):
                if k not in cur:
                    print(f"key {prefix + k} in checkpoint not in model")
            return out
        new = to_torch(new, cur.device).to(cur.dtype)
        if new.shape != cur.shape:
            print(f"key {prefix[:-1]} size mismatch {tuple(new.shape)} vs "
                  f"{tuple(cur.shape)}; flatten-copy")
            flat = cur.detach().clone().reshape(-1)
            n = min(flat.numel(), new.numel())
            flat[:n] = new.reshape(-1)[:n]
            new = flat.reshape(cur.shape)
        return new

    with torch.no_grad():
        return merge(params, loaded)


# ---------------------------------------------------------------------------
# the run dir (JAX checkpoint.py:107-312, the .pth tier)
# ---------------------------------------------------------------------------

def model_filename(opt, iteration=None, best=False, vse_best=False):
    kind = "alternatingModel" if opt.is_alternating else "model"
    if vse_best:
        return "model_vse-best.pth"
    if best:
        return "model-best.pth"
    if iteration is not None:
        return f"{kind}-{iteration}.pth"
    return f"{kind}.pth"


def save_pkl(checkpoint_path, run_id, file_name, payload, iteration=None,
             best=False):
    """ref train.py:95-118."""
    assert not (iteration is not None and best)
    ext = f"-{iteration}" if iteration is not None else (
        "-best" if best else "")
    path = os.path.join(checkpoint_path, f"{file_name}_{run_id}{ext}.pkl")
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    return path


def load_pkl(path):
    """An infos or histories pickle of either package
    (config.load_infos)."""
    return config_mod.load_infos(path)


class _OptaxState(tuple):
    """Stand-in for an optax state NamedTuple: keeps the positional fields
    and the class name."""

    def __new__(cls, *fields):
        return tuple.__new__(cls, fields)


_OPTAX_STANDINS = {}
_NUMPY_NAMES = {("numpy", "ndarray"), ("numpy", "dtype"),
                ("numpy.core.multiarray", "_reconstruct"),
                ("numpy._core.multiarray", "_reconstruct"),
                ("numpy.core.multiarray", "scalar"),
                ("numpy._core.multiarray", "scalar")}


class _OptimizerUnpickler(pickle.Unpickler):
    """Reads an optimizer.pth of either package without importing optax
    (and so JAX): optax.* classes become stand-ins by name, numpy arrays
    load, anything else is refused."""

    def find_class(self, module, name):
        if module == "optax" or module.startswith("optax."):
            if name not in _OPTAX_STANDINS:
                _OPTAX_STANDINS[name] = type(name, (_OptaxState,), {})
            return _OPTAX_STANDINS[name]
        if (module, name) in _NUMPY_NAMES:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"optimizer file: refusing to load {module}.{name}")


def read_optimizer_file(path):
    with open(path, "rb") as f:
        return _OptimizerUnpickler(f).load()


def _find_adam(node):
    """The ScaleByAdamState (count, mu, nu) inside an optax state tree."""
    if isinstance(node, _OptaxState) and \
            type(node).__name__ == "ScaleByAdamState":
        return node
    if isinstance(node, (tuple, list)):
        for x in node:
            found = _find_adam(x)
            if found is not None:
                return found
    return None


def adam_state_from_file(st, paths, shapes):
    """The port's {'count', 'mu': [...], 'nu': [...]} (numpy) from an
    optimizer file's state `st` -- the port's own layout, or an optax
    state mapped by sorted leaf path -- for params whose sorted leaf paths
    and shapes are `paths` / `shapes`; None if the structures differ."""
    if isinstance(st, dict) and "mu" in st:
        count, mu, nu = st["count"], list(st["mu"]), list(st["nu"])
        got_paths = list(st.get("paths", paths))
    else:
        adam = _find_adam(st)
        if adam is None or not isinstance(adam[1], dict):
            return None
        count = adam[0]
        mu_leaves, nu_leaves = leaves(adam[1]), leaves(adam[2])
        got_paths = [k for k, _ in mu_leaves]
        if got_paths != [k for k, _ in nu_leaves]:
            return None
        mu = [x for _, x in mu_leaves]
        nu = [x for _, x in nu_leaves]
    if got_paths != list(paths) or len(mu) != len(paths) or \
            len(nu) != len(paths):
        return None
    for shape, m, v in zip(shapes, mu, nu):
        if tuple(np.shape(m)) != tuple(shape) or \
                tuple(np.shape(v)) != tuple(shape):
            return None
    return {"count": np.asarray(count, np.int32), "mu": mu, "nu": nu}


class CheckpointManager:
    """The run dir of one training run (JAX checkpoint.py:124-312, the .pth
    tier; the orbax tier raises, `refuse_orbax`)."""

    def __init__(self, opt, writer=True):
        """`writer`: whether this process writes the run dir (a mesh run's
        global rank 0); only the writer creates it."""
        refuse_orbax(opt=opt)
        self.opt = opt
        if writer:
            os.makedirs(opt.checkpoint_path, exist_ok=True)

    def _path(self, name):
        return os.path.join(self.opt.checkpoint_path, name)

    def save_model(self, params, iteration=None):
        """ref train.py:121-129: the latest, plus a per-iteration copy."""
        save_params(params, self._path(model_filename(self.opt)))
        if iteration is not None:
            save_params(params, self._path(
                model_filename(self.opt, iteration=iteration)))

    def save_best(self, params, vse=False):
        save_params(params, self._path(
            model_filename(self.opt, best=not vse, vse_best=vse)))

    def _trained_agent(self):
        return "listener" if self.opt.phase == 1 else "speaker"

    def save_optimizers(self, optim_manager):
        """ref optimizer.py:191-221 naming: one file per agent when
        alternating, else optimizer.pth with the phase's trained agent."""
        def plain(agent):
            st = to_numpy(optim_manager.state_dict()[agent])
            st["paths"] = list(optim_manager.paths[agent])
            return st

        agents = list(optim_manager.state_dict())
        if self.opt.is_alternating:
            named = [(f"{a}_optimizer.pth", a) for a in agents]
        else:
            agent = self._trained_agent()
            named = [("optimizer.pth",
                      agent if agent in agents else agents[0])]
        for name, agent in named:
            with open(self._path(name), "wb") as f:
                pickle.dump(plain(agent), f)

    def _load_agent(self, optim_manager, agent, path, what):
        """Restore one agent's Adam state from `path`; False (and the fresh
        state kept) when its structure differs."""
        try:
            st = read_optimizer_file(path)
        except pickle.UnpicklingError as e:
            print(f"{what}: {e}; keeping fresh state")
            return False
        cur = optim_manager.state_dict()[agent]
        mapped = adam_state_from_file(st, optim_manager.paths[agent],
                                      [m.shape for m in cur["mu"]])
        if mapped is None:
            print(f"{what} has a different structure; keeping fresh state")
            return False
        optim_manager.load_state_dict({agent: mapped})
        return True

    def load_optimizers(self, optim_manager):
        """Restore the per-agent Adam states of start_from (ref
        optimizer.py:149-188).  Lenient: an agent without a file (or with
        one of another structure) keeps its fresh state."""
        sf = self.opt.start_from
        if not sf:
            return False
        restored = False
        for agent in list(optim_manager.state_dict()):
            cands = [f"{agent}_optimizer.pth"]
            if not self.opt.is_alternating and \
                    agent == self._trained_agent():
                # the non-alternating optimizer.pth holds the phase's
                # trained agent only (as save_optimizers writes it)
                cands.append("optimizer.pth")
            for name in cands:
                path = os.path.join(sf, name)
                if os.path.isfile(path):
                    restored |= self._load_agent(
                        optim_manager, agent, path,
                        f"optimizer state for {agent} in {name}")
                    break
        return restored

    def load_agent_optimizer(self, optim_manager, agent, path):
        """Seed one agent's Adam state from a saved optimizer file (the
        reference's --speaker_stage_2_optimizer_path, optimizer.py:49-96).
        Lenient on a structure mismatch."""
        if not os.path.isfile(path) or \
                agent not in optim_manager.state_dict():
            return False
        return self._load_agent(optim_manager, agent, path,
                                f"stage-2 optimizer state at {path} for "
                                f"{agent}")

    def save_infos(self, infos, iteration):
        args = (self.opt.checkpoint_path, self.opt.id)
        save_pkl(*args, "infos", infos)
        save_pkl(*args, "infos", infos, iteration=iteration)

    def save_histories(self, histories):
        save_pkl(self.opt.checkpoint_path, self.opt.id, "histories",
                 histories)

    def save_best_infos(self, infos, vse=False):
        save_pkl(self.opt.checkpoint_path, self.opt.id,
                 "infos_vse" if vse else "infos", infos, best=True)

    # -- resume ---------------------------------------------------------------
    def try_load_model(self, params, iteration=None):
        """(params, restored): start_from's model file merged into `params`
        (lenient), or `params` unchanged."""
        sf = self.opt.start_from
        if not sf:
            return params, False
        kind = "alternatingModel" if self.opt.is_alternating else "model"
        name = f"{kind}-{iteration}.pth" if iteration is not None \
            else f"{kind}.pth"
        path = os.path.join(sf, name)
        refuse_orbax(path)
        if not os.path.isfile(path):
            return params, False
        return load_params_into(params, path), True

    def load_infos(self):
        """ref train.py:143-159, with the opt-compatibility asserts."""
        sf = self.opt.start_from
        if not sf:
            return {}
        path = os.path.join(sf, f"infos_{self.opt.id}.pkl")
        if not os.path.isfile(path):
            return {}
        infos = load_pkl(path)
        saved = infos.get("opt")
        if saved is not None:
            for k in ("caption_model", "rnn_type", "rnn_size", "num_layers"):
                assert vars(saved)[k] == vars(self.opt)[k], \
                    f"Command line argument and saved model disagree on '{k}'"
        return infos

    def load_histories(self):
        sf = self.opt.start_from
        if not sf:
            return {}
        path = os.path.join(sf, f"histories_{self.opt.id}.pkl")
        return load_pkl(path) if os.path.isfile(path) else {}
