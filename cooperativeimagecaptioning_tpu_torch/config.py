"""Configuration system: the full reference flag surface (ref: opts.py:3-270) as an
argparse-compatible registry plus a programmatic `Options` namespace.

Every reference flag keeps its name and default so shell scripts written against the
reference CLI keep working.  The project's own additions are grouped at the bottom and
are all optional (defaults reproduce reference behavior).

The port's own copy of the JAX package's config.py (standard library only): the same
flags, types and defaults, so a command line or a run dir of either package works in
both.  `load_infos` reads a run dir's infos pickle, which names its `Options` by the
module that wrote it, into this module's class.
"""

from __future__ import annotations

import argparse
import copy
import os
import pickle


# (name, type, default, help) — one entry per reference flag, same defaults.
# Reference: opts.py lines cited per group.
_FLAGS = [
    # Data input settings (opts.py:6-29)
    ("input_json", str, "data/coco.json", "path to dataset info/vocab json"),
    ("input_fc_dir", str, "data/cocotalk_fc", "dir (or .lmdb) of fc feats"),
    ("input_att_dir", str, "data/cocotalk_att", "dir (or .lmdb) of att feats"),
    ("input_label_h5", str, "data/coco_label.h5", "preprocessed label h5"),
    ("start_from", str, None, "resume checkpoint dir"),
    ("initialize_retrieval", str, None, "listener init checkpoint path"),
    ("cached_tokens", str, "corpus", "cached df tokens for CIDEr-D reward"),
    ("cider_optimization", float, 0, "weight of self-critical CIDEr loss"),
    # Model settings (opts.py:36-58)
    ("caption_model", str, "show_tell", "fc | att2in2"),
    ("rnn_size", int, 512, "rnn hidden size"),
    ("num_layers", int, 1, "rnn layers"),
    ("rnn_type", str, "lstm", "rnn | gru | lstm"),
    ("input_encoding_size", int, 512, "token/image encoding size"),
    ("att_hid_size", int, 512, "attention MLP hidden size"),
    ("fc_feat_size", int, 2048, "fc feature dim"),
    ("att_feat_size", int, 2048, "att feature dim"),
    ("use_bn", int, 0, "batch-norm first in att_embed"),
    ("decoding_constraint", int, 0, "1: no same word twice in a row"),
    # Optimization general (opts.py:61-72)
    ("max_epochs", int, -1, "number of epochs (-1 = forever)"),
    ("batch_size", int, 16, "minibatch size"),
    ("grad_clip", float, 0.1, "element-wise gradient clamp"),
    ("drop_prob_lm", float, 0.5, "LM dropout"),
    ("seq_per_img", int, 1, "captions sampled per image"),
    ("beam_size", int, 1, "beam size for sample_max decoding"),
    # Cooperative-training knobs (opts.py:75-119)
    ("is_alternating", int, 0, "alternate speaker/listener turns"),
    ("alternating_turn", "append", None, "append-list of turns (speaker/listener)"),
    ("use_gen_cider_scores", int, 0, "use raw generated cider scores as reward"),
    ("rank_on_gen_captions", "store_true", False, "rank metrics on generated captions"),
    ("continue_from_existing_models", "store_false", True, "seed joint run from stages 1/2"),
    ("speaker_stage_2_optimizer_path", str, "", "stage-2 speaker optimizer path"),
    ("speaker_stage_2_model_path", str, "", "stage-2 speaker model path"),
    ("listener_stage_1_model_path", str, "", "stage-1 listener model path"),
    ("gumbel_temp", float, 10.0, "gumbel temperature"),
    ("multinomial_temp", float, 1.0, "multinomial temperature"),
    ("phase", float, None, "1 listener pretrain, 2 speaker MLE, 3 finetune"),
    ("prob_gumbel_softmax", float, 0.25, "partial-sampling ST fraction (gumbel)"),
    ("prob_multinomial_soft", float, 0.25, "partial-sampling ST fraction (multinomial)"),
    ("gumbel_temperature_annealing_factor", float, 0, "exp annealing factor"),
    ("gumbel_temperature_annealing_rate", int, 15, "annealing rate (epochs)"),
    ("num_iteration_for_annealing", int, 500, "anneal every N iterations"),
    # Optimizer (opts.py:122-157)
    ("optim", str, "adam", "optimizer kind"),
    ("learning_rate", float, 4e-4, "learning rate"),
    ("learning_rate_decay_start", int, -1, "epoch to start lr decay (-1 = never)"),
    ("learning_rate_decay_every", int, 3, "decay period (epochs)"),
    ("learning_rate_decay_rate", float, 0.8, "decay factor"),
    ("optim_alpha", float, 0.9, "adam beta1"),
    ("optim_beta", float, 0.999, "adam beta2"),
    ("optim_epsilon", float, 1e-8, "adam epsilon"),
    ("weight_decay", float, 0, "weight decay"),
    ("softmax_cooling_decay_factor", float, 0, "cooling of prob_*_soft toward 1"),
    ("scheduled_sampling_start", int, -1, "epoch to start scheduled sampling"),
    ("scheduled_sampling_increase_every", int, 5, "ss ramp period (epochs)"),
    ("scheduled_sampling_increase_prob", float, 0.05, "ss ramp step"),
    ("scheduled_sampling_max_prob", float, 0.25, "ss max prob"),
    ("retrieval_reward_weight_decay_start", int, -1, "epoch to start disc-weight decay"),
    ("retrieval_reward_weight_decay_every", int, 15, "disc-weight decay period"),
    ("retrieval_reward_weight_decay_rate", float, 0.8, "disc-weight decay factor"),
    ("gate_type", str, "softmax", "sigmoid or softmax"),
    ("closest_num", int, 10, "closest-captions count"),
    ("closest_file", str, "data/closest.pkl", "closest-captions pickle"),
    # Evaluation / checkpointing (opts.py:168-189)
    ("val_images_use", int, 3200, "images for periodic val (-1 = all)"),
    ("save_checkpoint_every", int, 2500, "checkpoint cadence (iterations)"),
    ("checkpoint_path", str, "save", "checkpoint dir"),
    ("language_eval", int, 0, "run BLEU/CIDEr/METEOR/ROUGE eval"),
    ("rank_eval", int, 0, "run vse retrieval-rank eval"),
    ("losses_log_every", int, 1000, "loss-history cadence (iterations)"),
    ("load_best_score", int, 1, "restore best score on resume"),
    ("id", str, "", "run id"),
    ("train_only", int, 0, "1: 80k train split, 0: +restval 110k"),
    ("start_with_checkpoint", int, 0, "evaluate at start of training"),
    # VSE / listener (opts.py:192-213)
    ("vse_model", str, "None", "fc | None"),
    ("vse_rnn_type", str, "gru", "listener rnn type"),
    ("vse_margin", float, 0.2, "rank-loss margin"),
    ("vse_embed_size", int, 1024, "joint embedding dim"),
    ("vse_num_layers", int, 1, "listener rnn layers"),
    ("vse_max_violation", int, 1, "max (vs sum) in rank loss"),
    ("vse_hinge_warmup_iters", int, 0,
     "extension: iterations of mean-hinge warm-up before vse_max_violation "
     "engages (VSE++ warm-start recipe; 0 = reference behavior)"),
    ("vse_measure", str, "cosine", "similarity measure"),
    ("vse_use_abs", int, 0, "abs() on embeddings"),
    ("vse_no_imgnorm", int, 0, "skip image-embedding l2norm"),
    ("vse_loss_type", str, "contrastive", "contrastive or pair"),
    ("vse_pool_type", str, "last", "last | mean | max"),
    # Retrieval reward (opts.py:216-234)
    ("retrieval_reward", str, "gumbel",
     "gumbel | gumbel_softmax | multinomial | multinomial_soft | reinforce"),
    ("retrieval_reward_weight", float, 0, "discriminative loss weight"),
    ("only_one_retrieval", str, "off", "image | caption | off"),
    ("share_embed", int, 0, "share speaker/listener word embedding"),
    ("caption_loss_weight", float, 1, "MLE loss weight"),
    ("vse_loss_weight", float, 0, "contrastive loss weight"),
    ("vse_eval_criterion", str, "rsum", "retrieval model-selection criterion"),
    ("reinforce_baseline_type", str, "greedy", "no | greedy | gt"),
    # Soft cider (opts.py:238-245)
    ("soft_cider", int, 0, "use differentiable soft CIDEr"),
    ("df", str, "coco-val", "'corpus' or cached doc-freq name"),
    # Dataset (opts.py:248-249)
    ("dataset", str, "coco", "coco | flickr8k | flickr30k | conceptual"),
    # Feature-pipeline options (ref: dataloader.py:78-84 getattr defaults)
    ("use_box", int, 0, "append normalized box geometry to att feats"),
    ("norm_att_feat", int, 0, "L2-normalize att features"),
    ("norm_box_feat", int, 0, "L2-normalize box features"),
    ("input_box_dir", str, "data/cocobu_box", "dir of box features"),
    # ---- the project's additions (not in reference; defaults keep ref behavior) ----
    ("max_att_len", int, 0, "static att-feature padding length (0 = batch max; "
                            "set >0 to keep one static shape)"),
    ("compute_dtype", str, "float32", "serving/decode dtype: float32 | "
                                      "bfloat16 (training stays f32)"),
    ("att_quant", str, "", "decode-time attention-context quantization: "
                           "'' (off) | int8 (per-row scales; halves the "
                           "context's footprint in device memory against "
                           "bfloat16, for larger serving batches)"),
    ("att_kmajor", int, 0, "decode-time K-major attention-context layout: "
                           "the context stored [K, B, *] (extension; "
                           "0 = b-major)"),
    ("mesh_data_axis", int, 0, "data-parallel mesh size: 0/1 = single-device, "
                               ">1 = shard batches over a (data, model) mesh"),
    ("mesh_model_axis", int, 1, "model (vocab) parallel mesh size; shards the "
                                "logit head and embedding table"),
    ("on_device_cider", int, 0, "hashed n-gram CIDEr-D reward fully on device"),
    ("audit_grad_isolation", int, 0, "debug: verify per-agent update "
                                     "isolation after every optimizer step "
                                     "(ref UpdateError machinery)"),
    ("remat", int, 1, "rematerialize the teacher-forced scan (fused CE, no "
                      "[B,T,V] residual): the same gradients from less "
                      "memory; 0 restores the plain scan"),
    ("checkpoint_backend", str, "pth", "pth (reference pickle taxonomy) | "
                                       "orbax (async atomic writes, restores "
                                       "honor live shardings)"),
    ("prefetch_batches", int, 2, "host-side prefetch depth"),
    ("device_feature_cache", int, 0, "keep ALL images' fc/att features "
                                     "HBM-resident (gathers use global image "
                                     "index, so train+val+test are cached; "
                                     "size accordingly) and gather train "
                                     "batches on device by index — removes "
                                     "the per-step host->device feature "
                                     "stream"),
    ("fused_steps", int, 1, "fuse K training iterations into one compiled "
                            "program (one dispatch + one stacked host "
                            "transfer per K steps instead of per step).  "
                            "Requires "
                            "--device_feature_cache 1; falls back to "
                            "per-step execution (with a one-time notice) "
                            "for host-reward SCST, reinforce turn "
                            "alternation, use_bn, the grad-isolation audit "
                            "and the profiler window.  1 = off"),
    ("feature_cache_dtype", str, "f32", "storage dtype of the HBM att-feature "
                                        "cache: f32 | bf16 (halves HBM; "
                                        "batches are cast back to f32 after "
                                        "the device gather)"),
    ("meteor_data_dir", str, "", "dir with the METEOR 1.5 jar's data files "
                                 "(function.words / synonyms.txt / "
                                 "paraphrase-en.gz); activates the METEOR "
                                 "synonym + paraphrase stages and SPICE-lite "
                                 "synset tuple matching (exported as "
                                 "CIC_METEOR_DATA)"),
    ("seed", int, 123, "global PRNG seed"),
    ("profile_dir", str, "", "profiler trace dir (empty = off)"),
    ("profile_start", int, 10, "iteration to start the profiler trace"),
    ("profile_steps", int, 5, "number of iterations to trace"),
]


class Options(argparse.Namespace):
    """Namespace covering the full reference flag surface with programmatic overrides.

    `Options(caption_model='att2in2', ...)` gives the parse_opt() defaults plus
    overrides — handy for tests and library use.
    """

    def __init__(self, **overrides):
        super().__init__()
        for name, kind, default, _help in _FLAGS:
            if kind == "store_true":
                setattr(self, name, bool(default))
            elif kind == "store_false":
                setattr(self, name, bool(default))
            else:
                setattr(self, name, default)
        # Derived runtime fields (ref: train.py:352-354, misc/utils.py:15-20)
        self.vocab_size = 0
        self.seq_length = 16
        self.use_att = True
        self.current_lr = self.learning_rate
        self.ss_prob = 0.0
        for k, v in overrides.items():
            if not hasattr(self, k):
                raise AttributeError(f"unknown option {k!r}")
            setattr(self, k, v)
        self.current_lr = self.learning_rate
        _export_env(self)

    def replace(self, **overrides) -> "Options":
        new = copy.deepcopy(self)
        for k, v in overrides.items():
            if not hasattr(new, k):  # same strictness as __init__
                raise AttributeError(f"unknown option {k!r}")
            setattr(new, k, v)
        _export_env(new)
        return new


def _export_env(opt) -> None:
    """Flag side-effects that ride process env. Called from EVERY Options
    construction path (__init__ kwargs, replace(), parse_opt) — the CLI path
    setattr's parsed flags onto a default Options, so an __init__-only export
    silently misses `train.py --meteor_data_dir ...`."""
    if getattr(opt, "meteor_data_dir", ""):
        # metrics/meteor.py default_resources() reads this env once
        os.environ["CIC_METEOR_DATA"] = opt.meteor_data_dir


def parse_set_overrides(pairs):
    """'k=v' strings (the run scripts' repeatable --set flag) -> an Options
    override dict; values parse as int, then float, then string."""
    out = {}
    for s in pairs or []:
        k, sep, v = s.partition("=")
        if not sep:
            raise ValueError(f"--set expects k=v, got {s!r}")
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                pass
        out[k] = v
    return out


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="cooperativeimagecaptioning_tpu_torch trainer/evaluator")
    for name, kind, default, help_ in _FLAGS:
        flag = "--" + name
        if kind == "append":
            parser.add_argument(flag, action="append", help=help_)
        elif kind == "store_true":
            parser.add_argument(flag, action="store_true", help=help_)
        elif kind == "store_false":
            parser.add_argument(flag, action="store_false", help=help_)
        else:
            parser.add_argument(flag, type=kind, default=default, help=help_)
    return parser


def validate(opt) -> None:
    """Argument sanity asserts (ref: opts.py:255-267)."""
    assert opt.rnn_size > 0, "rnn_size should be greater than 0"
    assert opt.num_layers > 0, "num_layers should be greater than 0"
    assert opt.input_encoding_size > 0, "input_encoding_size should be greater than 0"
    assert opt.batch_size > 0, "batch_size should be greater than 0"
    assert 0 <= opt.drop_prob_lm < 1, "drop_prob_lm should be in [0, 1)"
    assert opt.seq_per_img > 0, "seq_per_img should be greater than 0"
    assert opt.beam_size > 0, "beam_size should be greater than 0"
    assert opt.save_checkpoint_every > 0, "save_checkpoint_every should be > 0"
    assert opt.losses_log_every > 0, "losses_log_every should be > 0"
    assert opt.language_eval in (0, 1), "language_eval should be 0 or 1"
    assert opt.load_best_score in (0, 1), "load_best_score should be 0 or 1"
    assert opt.train_only in (0, 1), "train_only should be 0 or 1"


def parse_opt(argv=None) -> Options:
    """CLI-compatible option parsing (ref: opts.py:3-270)."""
    args = build_parser().parse_args(argv)
    opt = Options()
    for k, v in vars(args).items():
        setattr(opt, k, v)
    opt.current_lr = opt.learning_rate
    _export_env(opt)
    validate(opt)
    return opt


def if_use_att(opt) -> bool:
    """Whether attention features are needed (ref: misc/utils.py:15-20)."""
    if opt.caption_model in ("show_tell", "all_img", "fc") and \
            opt.vse_model in ("fc", "fc2"):
        return False
    return True


_JAX_CONFIG = "cooperativeimagecaptioning_tpu.config"


class _InfosUnpickler(pickle.Unpickler):
    """A run dir written by the JAX package pickles its `Options` under that
    package's module name.  Resolve that one module to this one, so such a run
    dir loads whether or not the JAX package can be imported, and without
    importing it."""

    def find_class(self, module, name):
        if module == _JAX_CONFIG:
            return globals()[name]
        return super().find_class(module, name)


def load_infos(path):
    """Read an `infos_<id>.pkl` (or `histories_<id>.pkl`) of either package.
    Unpickling runs code from the file: load only files this project wrote."""
    with open(path, "rb") as f:
        return _InfosUnpickler(f).load()
