"""Checkpoints and run dirs in the JAX package's format and taxonomy
(counterpart of its training/checkpoint.py, both tiers; ref
train.py:95-159, 299-347, optimizer.py:149-221).

Per run dir (opt.checkpoint_path):
  model.pth / alternatingModel.pth (+ -<iter>, -best, model_vse-best)
      -> pickled nested dicts of numpy arrays (params); such a file written
         by either package loads in both;
  under checkpoint_backend 'orbax' the same names with an `.orbax`
  directory suffix in their place (model.orbax, model-best.orbax, ...),
      -> read and written without orbax (training/orbax_tier.py); saved
         asynchronously (the tree snapshot to host numpy on the caller's
         thread, one background writer) and committed atomically, as the
         JAX package's orbax tier does (JAX checkpoint.py:15-20, 141-179);
  optimizer.pth / {speaker,listener}_optimizer.pth
      -> the JAX package's pickled optax state (optim.py:25-34:
         inject_hyperparams over chain(clip, [add_decayed_weights],
         scale_by_adam, scale)), written without importing optax; read
         through a restricted unpickler that never imports optax, mapped by
         sorted leaf path, as is the port's own older plain layout
         {'count', 'mu': [...], 'nu': [...], 'paths': [...]};
  infos_<id>.pkl (+ -<iter>, -best), histories_<id>.pkl
      -> the reference's keys.
Optimizer states, infos and histories stay pickles in both tiers.

Unpickling a params file runs code from it: load only checkpoints this
project wrote.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from cooperativeimagecaptioning_tpu_torch import config as config_mod
from cooperativeimagecaptioning_tpu_torch.training import orbax_tier
from cooperativeimagecaptioning_tpu_torch.utils.tree import (
    from_leaves, leaves, to_numpy, to_torch)

BACKENDS = ("pth", "orbax")


def orbax_path(pth_path):
    """The `.orbax` directory that stands for `pth_path` under
    checkpoint_backend 'orbax' (JAX checkpoint.py:141-143)."""
    return os.path.abspath(pth_path[:-4] + ".orbax")


def orbax_sibling(path):
    """The `.orbax` directory the JAX package writes in place of a `.pth`
    under checkpoint_backend 'orbax' (JAX checkpoint.py:55-61), or None.
    A write of this process to it commits first."""
    if path.endswith(".pth"):
        opath = orbax_path(path)
        orbax_tier.wait_for(opath)
        if os.path.isdir(opath):
            return opath
    return None


def model_exists(path):
    """Whether a model tree is at `path`: the `.pth`, or its `.orbax`
    sibling."""
    return os.path.isfile(path) or orbax_sibling(path) is not None


def save_params(params, path):
    """Write a tree of tensors (or numpy arrays) as pickled numpy."""
    with open(path, "wb") as f:
        pickle.dump(to_numpy(params), f)


def read_tree(path):
    """The numpy tree of a `.pth`, or of its `.orbax` sibling where the
    `.pth` is missing (JAX checkpoint.py:63-76)."""
    opath = None if os.path.isfile(path) else orbax_sibling(path)
    if opath is not None:
        return orbax_tier.read(opath)
    with open(path, "rb") as f:
        return pickle.load(f)


def load_params(path, device="cpu"):
    """Read a params tree (`read_tree`) into tensors on `device`."""
    return to_torch(read_tree(path), device)


def load_params_into(params, path, strict=False):
    """Lenient merge like ref misc/utils.py:89-107 (JAX checkpoint.py:63-105):
    copy the leaves the checkpoint shares with `params` (onto each leaf's
    device and dtype), report the others, keep the rest.  A leaf of another
    shape is copied flat, as far as it reaches.  A `.pth` that exists only
    as its `.orbax` sibling reads from that directory, through the same
    merge: a speaker-only tree merges into speaker and listener params."""
    return merge_tree(params, read_tree(path), strict)


def merge_tree(params, loaded, strict=False):
    """`load_params_into`'s merge of the numpy tree `loaded` into
    `params`."""
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
# the run dir (JAX checkpoint.py:107-312)
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
    and the class name; `_optax_module` is the module optax defines it in.
    It pickles as a NamedTuple does (NEWOBJ with the fields)."""

    __slots__ = ()
    _optax_module = None

    def __new__(cls, *fields):
        return tuple.__new__(cls, fields)

    def __getnewargs__(self):
        return tuple(self)


_OPTAX_STANDINS = {}


def optax_class(module, name):
    """The stand-in for optax's class `module.name` (one per name)."""
    key = (module, name)
    if key not in _OPTAX_STANDINS:
        _OPTAX_STANDINS[key] = type(name, (_OptaxState,), {
            "__slots__": (), "_optax_module": module})
    return _OPTAX_STANDINS[key]


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
            return optax_class(module, name)
        if (module, name) in _NUMPY_NAMES:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"optimizer file: refusing to load {module}.{name}")


def read_optimizer_file(path):
    with open(path, "rb") as f:
        return _OptimizerUnpickler(f).load()


class _OptaxPickler(pickle._Pickler):
    """pickle's Python pickler, which writes a stand-in class under its
    optax module and name.  pickle's own `save_global` imports a class's
    module to check the name, and the port never imports optax."""

    def save_global(self, obj, name=None):
        module = getattr(obj, "_optax_module", None) \
            if isinstance(obj, type) else None
        if module is None:
            return super().save_global(obj, name)
        self.save(module)
        self.save(obj.__name__)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def optax_state(opt, state, paths, lr):
    """One agent's Adam state (the port's {'count', 'mu': [...], 'nu':
    [...]}, moments in `paths` order) in the JAX package's optax layout:
    `optax.inject_hyperparams(build)` over chain(clip,
    [add_decayed_weights], scale_by_adam, scale) (JAX optim.py:25-34).
    The names and fields are those of optax 0.2.6:
    InjectStatefulHyperparamsState(count, hyperparams, hyperparams_states,
    inner_state) of optax.schedules._inject, whose inner_state holds
    optax._src.base.EmptyState for clip, add_decayed_weights and scale,
    and optax._src.transform.ScaleByAdamState(count, mu, nu); the moments
    are nested dicts, as the params."""
    count = np.asarray(to_numpy(state["count"]), np.int32)
    mu, nu = (from_leaves(zip(paths, to_numpy(list(state[k]))))
              for k in ("mu", "nu"))
    empty = optax_class("optax._src.base", "EmptyState")
    adam = optax_class("optax._src.transform", "ScaleByAdamState")(
        count, mu, nu)
    inner = (empty(),) + ((empty(),) if opt.weight_decay else ()) + \
        (adam, empty())
    return optax_class("optax.schedules._inject",
                       "InjectStatefulHyperparamsState")(
        count.copy(), {"learning_rate": np.asarray(lr, np.float32)}, {},
        inner)


def write_optimizer_file(path, st):
    """Pickle an optimizer state whose optax classes are stand-ins."""
    with open(path, "wb") as f:
        _OptaxPickler(f, protocol=4).dump(st)


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
    """The run dir of one training run (JAX checkpoint.py:124-312).  Model
    trees go to `.pth` files or, under checkpoint_backend 'orbax', to
    `.orbax` directories written by one background writer."""

    def __init__(self, opt, writer=True):
        """`writer`: whether this process writes the run dir (a mesh run's
        global rank 0); only the writer creates it."""
        self.opt = opt
        self.backend = getattr(opt, "checkpoint_backend", "pth") or "pth"
        if self.backend not in BACKENDS:
            raise ValueError(f"checkpoint_backend {self.backend!r}: one of "
                             f"{BACKENDS}")
        self.writer = orbax_tier.AsyncWriter() \
            if self.backend == "orbax" else None
        if writer:
            os.makedirs(opt.checkpoint_path, exist_ok=True)

    def _path(self, name):
        return os.path.join(self.opt.checkpoint_path, name)

    # -- the orbax tier (JAX checkpoint.py:134-179) ---------------------------
    def _save_tree(self, params, pth_path):
        """Save a model tree under the backend: a `.pth`, or its `.orbax`
        directory asynchronously.  The snapshot to host numpy is taken here,
        on the caller's thread: the Adam step updates the params in place
        and a fused chunk replays into static buffers."""
        if self.backend == "orbax":
            self.writer.save(to_numpy(params), orbax_path(pth_path))
        else:
            save_params(params, pth_path)

    def _try_restore_tree(self, params, pth_path):
        """The saved tree merged into `params`'s structure (onto its
        devices and dtypes); None if absent.  Under the orbax backend the
        `.orbax` directory first, every leaf required; else the `.pth`, or
        its `.orbax` sibling where it is missing, through the lenient
        merge (where the JAX package would start from fresh params at the
        resumed iteration)."""
        opath = orbax_path(pth_path)
        self.sync()
        if self.backend == "orbax" and os.path.isdir(opath):
            return merge_tree(params, orbax_tier.read(opath), strict=True)
        if model_exists(pth_path):
            return load_params_into(params, pth_path)
        return None

    def sync(self):
        """Wait until the pending `.orbax` write has committed; raise its
        error if it failed."""
        if self.writer is not None:
            self.writer.sync()

    def save_model(self, params, iteration=None):
        """ref train.py:121-129: the latest, plus a per-iteration copy."""
        self._save_tree(params, self._path(model_filename(self.opt)))
        if iteration is not None:
            self._save_tree(params, self._path(
                model_filename(self.opt, iteration=iteration)))

    def save_best(self, params, vse=False):
        self._save_tree(params, self._path(
            model_filename(self.opt, best=not vse, vse_best=vse)))

    def _trained_agent(self):
        return "listener" if self.opt.phase == 1 else "speaker"

    def save_optimizers(self, optim_manager):
        """ref optimizer.py:191-221 naming: one file per agent when
        alternating, else optimizer.pth with the phase's trained agent; each
        in the JAX package's optax layout (`optax_state`)."""
        def optax_layout(agent):
            return optax_state(self.opt, optim_manager.state_dict()[agent],
                               optim_manager.paths[agent], optim_manager.lr)

        agents = list(optim_manager.state_dict())
        if self.opt.is_alternating:
            named = [(f"{a}_optimizer.pth", a) for a in agents]
        else:
            agent = self._trained_agent()
            named = [("optimizer.pth",
                      agent if agent in agents else agents[0])]
        for name, agent in named:
            write_optimizer_file(self._path(name), optax_layout(agent))

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
        """(params, restored): start_from's model tree merged into `params`
        (`_try_restore_tree`), or `params` unchanged."""
        sf = self.opt.start_from
        if not sf:
            return params, False
        kind = "alternatingModel" if self.opt.is_alternating else "model"
        name = f"{kind}-{iteration}.pth" if iteration is not None \
            else f"{kind}.pth"
        restored = self._try_restore_tree(params, os.path.join(sf, name))
        if restored is not None:
            return restored, True
        return params, False

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
