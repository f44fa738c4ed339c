"""The port's own copies of the JAX package's host modules (config, the
data layer, the schedules, decode_sequence, the language metrics and the
CIDEr-D scorer) behave as the originals, and the port imports nothing of the
JAX package: a run dir that package wrote still loads, in a process that
afterwards holds neither `jax`, nor any module of that package, nor orbax,
optax or tensorstore (the orbax tier's .orbax directories and optax-layout
optimizer files are read and written without them)."""

import ast
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "cooperativeimagecaptioning_tpu_torch"
JAXPKG = "cooperativeimagecaptioning_tpu"

from cooperativeimagecaptioning_tpu_torch import config as tconfig  # noqa: E402
from cooperativeimagecaptioning_tpu_torch import data as tdata  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.evaluation import coco_eval as tcoco  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.metrics import (  # noqa: E402
    bleu as tbleu, meteor as tmeteor, porter as tporter, rouge as trouge,
    tokenizer as ttok)
from cooperativeimagecaptioning_tpu_torch.native import bindings as tbindings  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.rewards import cider_d as tcider  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.training import schedules as tsched  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.utils import text as ttext  # noqa: E402

# help texts that quoted a TPU measurement or a TPU mechanism are reworded in
# the port; everything else of the registry is equal
REWORDED_HELP = {"max_att_len", "att_quant", "att_kmajor", "remat",
                 "device_feature_cache", "fused_steps", "profile_dir"}


@pytest.fixture(scope="module")
def jx():
    """The JAX package's host modules (skips where that package cannot be
    imported, as on a machine with a card)."""
    pytest.importorskip("jax")
    from cooperativeimagecaptioning_tpu import config, data
    from cooperativeimagecaptioning_tpu.evaluation import coco_eval
    from cooperativeimagecaptioning_tpu.metrics import (
        bleu, meteor, porter, rouge, tokenizer)
    from cooperativeimagecaptioning_tpu.native import bindings
    from cooperativeimagecaptioning_tpu.rewards import cider_d
    from cooperativeimagecaptioning_tpu.training import schedules
    from cooperativeimagecaptioning_tpu.utils import text
    return dict(config=config, data=data, coco_eval=coco_eval, bleu=bleu,
                meteor=meteor, porter=porter, rouge=rouge,
                tokenizer=tokenizer, bindings=bindings, cider_d=cider_d,
                schedules=schedules, text=text)


def test_flag_registry_equals_the_jax_packages(jx):
    want, got = jx["config"]._FLAGS, tconfig._FLAGS
    assert [f[:3] for f in got] == [f[:3] for f in want]
    differing = {g[0] for w, g in zip(want, got) if w[3] != g[3]}
    assert differing <= REWORDED_HELP
    for name, _, _, help_ in got:
        for word in ("v5e", "TPU", "tunnel", "XLA", "lax.scan", "jax"):
            assert word not in help_, (name, word)
    assert vars(tconfig.Options()) == vars(jx["config"].Options())


def test_parse_opt_and_overrides_agree(jx):
    argv = ["--caption_model", "att2in2", "--batch_size", "7",
            "--att_quant", "int8", "--att_kmajor", "1", "--beam_size", "2"]
    assert vars(tconfig.parse_opt(argv)) == vars(jx["config"].parse_opt(argv))
    assert tconfig.parse_set_overrides(["a=1", "b=0.5", "c=x"]) == \
        jx["config"].parse_set_overrides(["a=1", "b=0.5", "c=x"])
    with pytest.raises(AssertionError, match="batch_size"):
        tconfig.parse_opt(["--batch_size", "0"])
    with pytest.raises(AttributeError, match="unknown option"):
        tconfig.Options(no_such_flag=1)
    for cm, vse, want in (("att2in2", "fc", True), ("fc", "fc", False),
                          ("fc", "None", True)):
        o = tconfig.Options(caption_model=cm, vse_model=vse)
        assert tconfig.if_use_att(o) is want is jx["config"].if_use_att(o)


def _loader(data, **kw):
    opt_kw = dict(caption_model="att2in2", batch_size=3, seq_per_img=2,
                  seed=7)
    opt_kw.update(kw)
    return opt_kw, data.SyntheticDataset(
        num_images=20, vocab_size=25, seq_length=8, fc_feat_size=10,
        att_feat_size=12, max_K=6, seed=3)


def _assert_batches_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if k in ("bounds", "infos"):
            assert a[k] == b[k], k
        elif k == "gts":
            assert len(a[k]) == len(b[k])
            for x, y in zip(a[k], b[k]):
                np.testing.assert_array_equal(x, y)
        elif a[k] is None:
            assert b[k] is None, k
        else:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("max_att_len", [0, 6])
def test_loader_batches_equal_the_jax_packages(jx, max_att_len):
    loaders = []
    for cfg, data in ((jx["config"], jx["data"]), (tconfig, tdata)):
        kw, ds = _loader(data, max_att_len=max_att_len)
        loaders.append(data.DataLoader(cfg.Options(**kw), dataset=ds))
    jl, tl = loaders
    assert tl.vocab_size == jl.vocab_size and tl.seq_length == jl.seq_length
    assert tl.get_vocab() == jl.get_vocab()
    assert {s: list(v) for s, v in tl.split_ix.items()} == \
        {s: list(v) for s, v in jl.split_ix.items()}
    # train wraps (and reshuffles) within these batches
    for split, n in (("train", 6), ("val", 3), ("test", 2)):
        for _ in range(n):
            _assert_batches_equal(jl.get_batch(split), tl.get_batch(split))
    jl.reset_iterator("val")
    tl.reset_iterator("val")
    _assert_batches_equal(jl.get_batch("val"), tl.get_batch("val"))
    for ix in (0, 5, 19):
        np.testing.assert_array_equal(jl.ds.get_refs(ix), tl.ds.get_refs(ix))


def test_schedules_agree_on_a_grid(jx):
    js = jx["schedules"]
    kw = dict(learning_rate=5e-4, learning_rate_decay_start=2,
              learning_rate_decay_every=3, learning_rate_decay_rate=0.8,
              scheduled_sampling_start=1,
              scheduled_sampling_increase_every=2,
              scheduled_sampling_increase_prob=0.05,
              scheduled_sampling_max_prob=0.25,
              softmax_cooling_decay_factor=2.0,
              retrieval_reward="gumbel_softmax", retrieval_reward_weight=0.5,
              retrieval_reward_weight_decay_start=1,
              retrieval_reward_weight_decay_every=2,
              retrieval_reward_weight_decay_rate=0.9,
              gumbel_temperature_annealing_factor=1e-5,
              num_iteration_for_annealing=100, vse_hinge_warmup_iters=100)
    jopt, topt = jx["config"].Options(**kw), tconfig.Options(**kw)
    names = [n for n in dir(js) if not n.startswith("_") and
             callable(getattr(js, n)) and n != "annotations"]
    assert sorted(n for n in dir(tsched) if not n.startswith("_") and
                  callable(getattr(tsched, n))) == sorted(names)
    for epoch in range(0, 12):
        for fn in ("current_lr", "scheduled_sampling_prob",
                   "retrieval_reward_weight"):
            assert getattr(tsched, fn)(topt, epoch) == \
                getattr(js, fn)(jopt, epoch), (fn, epoch)
        assert tsched.soft_sampling_probs(topt, epoch + 1, 1) == \
            js.soft_sampling_probs(jopt, epoch + 1, 1)
        assert tsched.polynomial_decay(epoch, 2.0, 0.5) == \
            js.polynomial_decay(epoch, 2.0, 0.5)
    for it in (0, 1, 99, 100, 1000, 12345):
        assert tsched.should_anneal(topt, it) == js.should_anneal(jopt, it)
        assert tsched.vse_max_violation_w(topt, it) == \
            js.vse_max_violation_w(jopt, it)
        assert tsched.anneal_gumbel_temp(5.0, topt, it) == \
            js.anneal_gumbel_temp(5.0, jopt, it)


def test_decode_sequence_agrees(jx):
    vocab = {str(i): f"w{i}" for i in range(1, 10)}
    seq = np.array([[3, 4, 0, 5], [0, 1, 2, 3], [9, 8, 7, 6]])
    assert ttext.decode_sequence(vocab, seq) == \
        jx["text"].decode_sequence(vocab, seq) == \
        ["w3 w4", "", "w9 w8 w7 w6"]


def _corpus(seed=0, n=12):
    rng = np.random.RandomState(seed)
    words = ("a man riding a wave on top of surfboard the dog runs running "
             "quickly two people's plates , . cat sat").split()
    gts, res = {}, {}
    for i in range(n):
        gts[i] = [{"caption": " ".join(rng.choice(words, rng.randint(4, 10)))}
                  for _ in range(3)]
        res[i] = [{"caption": " ".join(rng.choice(words, rng.randint(3, 9)))}]
    res[0] = [{"caption": gts[0][0]["caption"]}]  # one exact match
    return gts, res


def _same_tier(jx, monkeypatch, tier):
    """Both packages on their pure-Python tier, or both on their C++ tier
    (skips where that cannot be built)."""
    if tier == "python":
        monkeypatch.setattr(jx["bindings"], "available", lambda: False)
        monkeypatch.setattr(tbindings, "available", lambda: False)
    elif not (tbindings.available() and jx["bindings"].available()):
        pytest.skip("the C++ host tier cannot be built here")


@pytest.mark.parametrize("tier", ["python", "native"])
def test_language_metrics_agree(jx, monkeypatch, tier):
    """Tokenizer, BLEU, ROUGE-L, METEOR, CIDEr-D and the Porter stemmer:
    the port's copies against the originals, tier against tier."""
    _same_tier(jx, monkeypatch, tier)
    gts, res = _corpus()
    tg, tr = ttok.tokenize(gts), ttok.tokenize(res)
    assert tg == jx["tokenizer"].tokenize(gts)
    assert tr == jx["tokenizer"].tokenize(res)
    for w in ("running", "plates", "quickly", "relational", "caresses"):
        assert tporter.stem(w) == jx["porter"].stem(w)
    for mine, theirs, fn in ((tbleu, jx["bleu"], "compute_bleu"),
                             (trouge, jx["rouge"], "compute_rouge"),
                             (tmeteor, jx["meteor"], "compute_meteor")):
        got, want = getattr(mine, fn)(tg, tr), getattr(theirs, fn)(tg, tr)
        np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(np.asarray(got[1], dtype=float),
                                   np.asarray(want[1], dtype=float),
                                   rtol=0, atol=1e-12)
    ids = sorted(tr)
    hyp = [{"image_id": i, "caption": tr[i]} for i in ids]
    got = tcider.CiderD(df="corpus").compute_score(tg, hyp)
    want = jx["cider_d"].CiderD(df="corpus").compute_score(tg, hyp)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("tier", ["python", "native"])
def test_coco_eval_agrees(jx, monkeypatch, tier):
    _same_tier(jx, monkeypatch, tier)
    gts, res = _corpus(seed=1)
    anns = [{"image_id": i, "caption": c["caption"], "id": 10 * i + j}
            for i, caps in gts.items() for j, c in enumerate(caps)]
    dataset = {"annotations": anns, "images": [{"id": i} for i in gts]}
    preds = [{"image_id": i, "caption": res[i][0]["caption"]} for i in res]
    out = []
    for mod in (jx["coco_eval"], tcoco):
        coco = mod.CocoAnnotations(dataset=dataset)
        ev = mod.CocoEvalCap(coco, coco.load_res(preds))
        out.append((ev.evaluate(), ev.img_to_eval))
    (want, want_img), (got, got_img) = out
    assert set(got) == {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR",
                        "ROUGE_L", "CIDEr"} == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, k
    assert got_img == want_img


# ---------------------------------------------------------------------------
# the port imports nothing of the JAX package
# ---------------------------------------------------------------------------

def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    return names


def _port_files():
    files = [os.path.join(REPO, f) for f in
             ("chip_smoke.py", "serve_breakdown.py", "train_breakdown.py",
              "att_stream_bench.py", "cell_bench.py", "head_bench.py",
              "tests/torch_mesh_ranks.py")]
    for root, _, names in os.walk(os.path.join(REPO, PORT)):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_no_file_of_the_port_imports_the_jax_package():
    files = _port_files()
    assert len(files) > 30
    names = {os.path.relpath(f, os.path.join(REPO, PORT)) for f in files}
    assert {"models/vse.py", "models/fc_model.py", "evaluation/retrieval.py",
            "evaluation/caption_retrieval.py", "parallel/mesh.py",
            "parallel/collectives.py", "parallel/launch.py",
            "parallel/train_step.py", "parallel/vocab.py",
            "ops/kernels/head_merge.py", "../tests/torch_mesh_ranks.py",
            "training/audit.py", "utils/profiling.py",
            "rewards/ngram_device.py", "rewards/cider_diff.py",
            "preprocess/__init__.py", "preprocess/ngrams.py",
            "training/fused.py", "preprocess/resnet.py",
            "preprocess/feats.py", "preprocess/labels.py",
            "evaluation/harvest.py", "scripts/__init__.py",
            "training/orbax_tier.py", "native/zstd.py",
            "scripts/run_fc_con.py", "scripts/run_att.py",
            "scripts/run_joint.py", "scripts/reproduce_coco.py",
            "scripts/showcase_full_scale.py", "scripts/fixed_listener_rank.py",
            "scripts/mode_grid.py", "scripts/mode_grid_report.py",
            "scripts/time_eval_protocol.py", "utils/torch_interop.py",
            "native/__init__.py", "native/bindings.py",
            "metrics/spice.py"} <= names
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "orbax",
                               "tensorstore", JAXPKG), \
                (path, name)
        # nor by name at run time (importlib, __import__)
        src = open(path).read()
        assert f'"{JAXPKG}.' not in src.replace(f'"{JAXPKG}.config"', ""), \
            path


def _code_of(path):
    """A module's AST dump without its docstrings."""
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and \
                isinstance(body[0], ast.Expr) and \
                isinstance(getattr(body[0], "value", None), ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:]
    return ast.dump(tree)


def test_the_ngrams_copy_equals_the_jax_packages():
    """preprocess/ngrams.py (the df pickles of the cached-df reward) is the
    JAX package's module as it is, but for its docstring; the pickles it
    writes are held to the original's in test_torch_device_rewards.py."""
    want = _code_of(os.path.join(REPO, JAXPKG, "preprocess", "ngrams.py"))
    got = _code_of(os.path.join(REPO, PORT, "preprocess", "ngrams.py"))
    assert got == want


def test_the_labels_copy_equals_the_jax_packages():
    """preprocess/labels.py is the JAX package's module as it is, but for
    its docstring; what it writes is held to the original's in
    test_torch_preprocess.py."""
    want = _code_of(os.path.join(REPO, JAXPKG, "preprocess", "labels.py"))
    got = _code_of(os.path.join(REPO, PORT, "preprocess", "labels.py"))
    assert got == want


def test_the_unpickler_maps_only_the_config_module(tmp_path):
    """`load_infos` resolves the JAX package's config module to the port's,
    and nothing else of that package."""
    import io
    u = tconfig._InfosUnpickler(io.BytesIO(b""))
    assert u.find_class(JAXPKG + ".config", "Options") is tconfig.Options
    assert u.find_class("collections", "OrderedDict").__name__ == \
        "OrderedDict"
    src = open(os.path.join(REPO, PORT, "config.py")).read()
    assert src.count(JAXPKG + ".") == 1  # the one mapped module name


@pytest.fixture(scope="module")
def jax_run_dir(tmp_path_factory):
    """A run dir written by the JAX package: infos pickled with its Options,
    params saved by its checkpoint module."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from cooperativeimagecaptioning_tpu.config import Options
    from cooperativeimagecaptioning_tpu.training import checkpoint as jckpt
    from test_torch_att_model import jax_params
    d = tmp_path_factory.mktemp("jax_run_dir")
    opt = Options(caption_model="att2in2", vse_model="None", vocab_size=25,
                  rnn_size=16, input_encoding_size=12, att_hid_size=8,
                  fc_feat_size=20, att_feat_size=20, seq_length=8,
                  batch_size=4, seq_per_img=1, id="hc", language_eval=1,
                  max_att_len=6, phase=2, checkpoint_path=str(d))
    params = {"speaker": jax_params(opt, seed=5)}
    jckpt.save_params(params, str(d / "model-best.pth"))
    # a phase-2 model.pth and an optax optimizer.pth after one update, for
    # start_from
    from cooperativeimagecaptioning_tpu.training import optim as joptim
    jckpt.save_params(params, str(d / "model.pth"))
    jm = joptim.OptimizerManager(opt, jax.tree.map(jnp.asarray, params))
    jm.step(jax.tree.map(jnp.asarray, params), jax.tree.map(
        lambda x: jnp.full(x.shape, 1e-3, jnp.float32), params), "optimizer")
    jckpt.CheckpointManager(opt).save_optimizers(jm)
    vocab = {str(i): f"w{i}" for i in range(1, opt.vocab_size + 1)}
    with open(d / "infos_hc.pkl", "wb") as f:
        pickle.dump({"opt": opt, "vocab": vocab}, f)
    return str(d)


def test_a_jax_run_dir_loads_as_the_ports_options(jax_run_dir):
    infos = tconfig.load_infos(os.path.join(jax_run_dir, "infos_hc.pkl"))
    assert type(infos["opt"]) is tconfig.Options
    assert infos["opt"].rnn_size == 16 and infos["opt"].id == "hc"
    assert infos["vocab"]["3"] == "w3"
    # and a run dir the port writes loads in the port
    path = os.path.join(jax_run_dir, "infos_port.pkl")
    with open(path, "wb") as f:
        pickle.dump({"opt": infos["opt"], "vocab": infos["vocab"]}, f)
    again = tconfig.load_infos(path)
    assert vars(again["opt"]) == vars(infos["opt"])


# JAX, the JAX package, and what the orbax tier of that package imports
HIDDEN = ("jax", JAXPKG, "orbax", "optax", "tensorstore")
_CLEAN = (
    "leaked = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
    "assert not leaked, leaked\n" % (HIDDEN,))

_ENTRY_CODE = {
    "serving": (
        "from cooperativeimagecaptioning_tpu_torch import serving\n"
        "svc = serving.CaptioningService.from_run_dir(d, run_id='hc', "
        "beam_size=2, buckets=(4,), compute_dtype='float32', max_att_len=6, "
        "att_quant='int8', device='cpu')\n"
        "ids = svc.caption_ids(np.zeros((3, 20), np.float32), "
        "rng.randn(3, 6, 20).astype(np.float32))\n"
        "assert ids.shape == (3, 8)\n"),
    "training.loop": (
        "from cooperativeimagecaptioning_tpu_torch import config\n"
        "from cooperativeimagecaptioning_tpu_torch.training import loop\n"
        "opt = config.load_infos(os.path.join(d, 'infos_hc.pkl'))['opt']\n"
        "opt.save_checkpoint_every = 100\n"
        "tr = loop.train(opt, dataset=ds, max_iterations=2, device='cpu', "
        "verbose=False)\n"
        "assert tr.iteration == 2\n"),
    "training.scst": (
        "from cooperativeimagecaptioning_tpu_torch import config\n"
        "from cooperativeimagecaptioning_tpu_torch.training import loop\n"
        "opt = config.load_infos(os.path.join(d, 'infos_hc.pkl'))['opt']\n"
        "opt.start_from = d\n"
        "opt.checkpoint_path = os.path.join(os.getcwd(), 'scst')\n"
        "opt.cider_optimization, opt.caption_loss_weight = 1, 0\n"
        "opt.save_checkpoint_every, opt.language_eval = 2, 0\n"
        "tr = loop.train(opt, dataset=ds, max_iterations=2, device='cpu', "
        "verbose=False)\n"
        "assert int(tr.optim.states['speaker']['count']) == 3\n"
        "assert os.path.isfile(os.path.join('scst', 'optimizer.pth'))\n"),
    "training.phase1": (
        "from cooperativeimagecaptioning_tpu_torch import config\n"
        "from cooperativeimagecaptioning_tpu_torch.training import loop\n"
        "opt = config.load_infos(os.path.join(d, 'infos_hc.pkl'))['opt']\n"
        "opt = opt.replace(caption_model='fc', vse_model='fc', phase=1, "
        "vse_embed_size=16, vse_loss_weight=1, caption_loss_weight=0, "
        "rank_eval=1, language_eval=0, save_checkpoint_every=2, "
        "checkpoint_path=os.path.join(os.getcwd(), 'fc_con'))\n"
        "tr = loop.train(opt, dataset=ds, max_iterations=2, device='cpu', "
        "verbose=False)\n"
        "assert int(tr.optim.states['listener']['count']) == 2\n"
        "assert os.path.isfile(os.path.join('fc_con', "
        "'model_vse-best.pth'))\n"),
    "training.joint": (
        "from cooperativeimagecaptioning_tpu_torch import config\n"
        "from cooperativeimagecaptioning_tpu_torch.training import loop\n"
        "opt = config.load_infos(os.path.join(d, 'infos_hc.pkl'))['opt']\n"
        "opt = opt.replace(vse_model='fc', vse_embed_size=16, phase=3, "
        "is_alternating=1, alternating_turn=['speaker', 'listener'], "
        "retrieval_reward='gumbel', retrieval_reward_weight=0.5, "
        "cider_optimization=0.5, caption_loss_weight=0, language_eval=0, "
        "rank_eval=1, rank_on_gen_captions=True, save_checkpoint_every=2, "
        "cached_tokens='corpus', "
        "speaker_stage_2_model_path=os.path.join(d, 'model.pth'), "
        "speaker_stage_2_optimizer_path=os.path.join(d, 'optimizer.pth'), "
        "checkpoint_path=os.path.join(os.getcwd(), 'joint'))\n"
        "tr = loop.train(opt, dataset=ds, max_iterations=2, device='cpu', "
        "verbose=False)\n"
        "assert int(tr.optim.states['speaker']['count']) == 3\n"
        "assert os.path.isfile(os.path.join('joint', "
        "'listener_optimizer.pth'))\n"),
    "training.reinforce": (
        "from cooperativeimagecaptioning_tpu_torch import config\n"
        "from cooperativeimagecaptioning_tpu_torch.training import loop\n"
        "opt = config.load_infos(os.path.join(d, 'infos_hc.pkl'))['opt']\n"
        "opt = opt.replace(vse_model='fc', vse_embed_size=16, phase=3, "
        "is_alternating=1, alternating_turn=['speaker', 'listener'], "
        "retrieval_reward='reinforce', reinforce_baseline_type='greedy', "
        "retrieval_reward_weight=0.5, cider_optimization=0.5, "
        "vse_loss_weight=1, caption_loss_weight=0, language_eval=0, "
        "save_checkpoint_every=100, cached_tokens='corpus', "
        "audit_grad_isolation=1, profile_dir='prof', profile_start=1, "
        "profile_steps=1, "
        "speaker_stage_2_model_path=os.path.join(d, 'model.pth'), "
        "checkpoint_path=os.path.join(os.getcwd(), 'reinforce'))\n"
        "tr = loop.train(opt, dataset=ds, max_iterations=2, device='cpu', "
        "verbose=False)\n"
        "assert [int(tr.optim.states[a]['count']) for a in "
        "('speaker', 'listener')] == [1, 1]\n"
        "assert os.path.isfile(tr.last_trace)\n"),
    "training.fused": (
        "from cooperativeimagecaptioning_tpu_torch import config\n"
        "from cooperativeimagecaptioning_tpu_torch.training import loop\n"
        "opt = config.load_infos(os.path.join(d, 'infos_hc.pkl'))['opt']\n"
        "opt = opt.replace(start_from=d, phase=3, cider_optimization=1, "
        "caption_loss_weight=0, on_device_cider=1, device_feature_cache=1, "
        "fused_steps=3, max_att_len=6, save_checkpoint_every=100, "
        "checkpoint_path=os.path.join(os.getcwd(), 'fused'))\n"
        "tr = loop.train(opt, dataset=ds, max_iterations=5, device='cpu', "
        "verbose=False)\n"
        "assert tr._fused_gate() is None and tr._fused\n"
        "assert int(tr.optim.states['speaker']['count']) == 6\n"),
    "eval.listener": (
        "from cooperativeimagecaptioning_tpu_torch import config\n"
        "from cooperativeimagecaptioning_tpu_torch import eval as ev\n"
        "from cooperativeimagecaptioning_tpu_torch.training import "
        "checkpoint, joint\n"
        "opt = config.load_infos(os.path.join(d, 'infos_hc.pkl'))['opt']\n"
        "opt = opt.replace(vse_model='fc', vse_embed_size=16, rank_eval=1, "
        "initialize_retrieval='gt.pth')\n"
        "checkpoint.save_params(joint.init_params(3, opt), 'gt.pth')\n"
        "out = ev.eval(opt, os.path.join(d, 'model-best.pth'), "
        "os.path.join(d, 'infos_hc.pkl'), listener='gt', split='test', "
        "dataset=ds, device='cpu')\n"
        "assert 't2i_r1' in out['loss'] and 'gt_ranks' in out['loss']\n"),
    "evaluation.eval_split": (
        "from cooperativeimagecaptioning_tpu_torch import config, data\n"
        "from cooperativeimagecaptioning_tpu_torch.evaluation import "
        "eval_split\n"
        "from cooperativeimagecaptioning_tpu_torch.training import "
        "checkpoint\n"
        "opt = config.load_infos(os.path.join(d, 'infos_hc.pkl'))['opt']\n"
        "loader = data.DataLoader(opt, dataset=ds)\n"
        "params = checkpoint.load_params(os.path.join(d, 'model-best.pth'))\n"
        "out = eval_split.Evaluator(opt, device='cpu').eval_split(params, "
        "loader, {'split': 'val', 'beam_size': 2})\n"
        "assert len(out[1]) == 4 and 'CIDEr' in out[2]\n"),
    "preprocess.labels": (
        "from cooperativeimagecaptioning_tpu_torch.preprocess import labels\n"
        "from cooperativeimagecaptioning_tpu_torch.scripts import "
        "reproduce_coco\n"
        "raw, _ = reproduce_coco.fabricate_synthetic_raw('raw', 4, size=16)\n"
        "labels.main(['--input_json', raw, '--output_json', 'talk.json', "
        "'--output_h5', 'talk'])\n"
        "assert os.path.isfile('talk_label.h5')\n"),
    "preprocess.feats": (
        "from cooperativeimagecaptioning_tpu_torch.preprocess import feats\n"
        "from cooperativeimagecaptioning_tpu_torch.scripts import "
        "reproduce_coco\n"
        "raw, root = reproduce_coco.fabricate_synthetic_raw('raw', 2, "
        "size=16)\n"
        "feats.main(['--input_json', raw, '--output_dir', 'talk', "
        "'--images_root', root, '--batch_size', '2', '--device', 'cpu'])\n"
        "assert np.load('talk_att/1.npz')['feat'].shape == (14, 14, 2048)\n"),
    "evaluation.harvest": (
        "import pickle, shutil\n"
        "from cooperativeimagecaptioning_tpu_torch import config\n"
        "from cooperativeimagecaptioning_tpu_torch.evaluation import harvest\n"
        "shutil.copytree(d, 'run')\n"
        "hist = {'val_result_history': {}}\n"
        "for it, cider in ((3, 0.2), (5, 0.4)):\n"
        "    shutil.copy(os.path.join(d, 'model-best.pth'), "
        "f'run/model-{it}.pth')\n"
        "    hist['val_result_history'][it] = {'lang_stats': {'CIDEr': "
        "cider, 'Bleu_4': cider / 2}, 'loss': {}, 'predictions': []}\n"
        "pickle.dump(hist, open('run/histories_hc.pkl', 'wb'))\n"
        "out = harvest.main(['--dir', 'run', '--json_dir', 'js', "
        "'--device', 'cpu'])\n"
        "assert list(out.values()) == [os.path.join('js', 'run.json')]\n"
        "opt = config.load_infos('run/infos_hc.pkl')['opt']\n"
        "opt.checkpoint_path = 'run'\n"
        "harvest.create_dicts_and_json_after_training(opt, dataset=ds, "
        "json_dir='js', device='cpu')\n"
        "test = pickle.load(open('run/test_dict.pkl', 'rb'))\n"
        "assert 'CIDEr' in test['cider']['lang_stats']\n"
        "assert not os.path.isfile('run/model-3.pth')\n"),
    "scripts.reproduce_coco": (
        "from cooperativeimagecaptioning_tpu_torch.scripts import "
        "reproduce_coco\n"
        "reproduce_coco.main(['--synthetic', '8', '--device', 'cpu', "
        "'--workdir', 'rc'])\n"
        "assert os.listdir(os.path.join('rc', 'gumbel', 'json_dir'))\n"),
    "scripts.paper_drivers": (
        "import importlib, json\n"
        "for name in ('showcase_full_scale', 'fixed_listener_rank', "
        "'mode_grid', 'mode_grid_report', 'time_eval_protocol'):\n"
        "    importlib.import_module("
        "'cooperativeimagecaptioning_tpu_torch.scripts.' + name)\n"
        + "    " + _CLEAN.replace("\n", "\n    ").rstrip(" ") +
        "from cooperativeimagecaptioning_tpu_torch.scripts import "
        "mode_grid_report, time_eval_protocol\n"
        "json.dump({'modes': {'gumbel': {'flags': {"
        "'retrieval_reward_weight': 0.3}, 'rank_points': [{'iteration': "
        "'seed', 'condition': 'current-sample', 'CIDEr': 0.5, 'rsum': 9.0}, "
        "{'iteration': 4, 'condition': 'current-sample', 'CIDEr': 0.75, "
        "'rsum': 12.0}]}}}, open('grid.json', 'w'))\n"
        "assert mode_grid_report.main(['grid.json'])[0]['pair_rsum'] == "
        "{'seed': 9.0, 'last': 12.0, 'peak': 12.0}\n"
        "out = time_eval_protocol.main(['--images', '20', '--val-images', "
        "'6', '--batch', '3', '--vocab', '25', '--seq', '8', '--device', "
        "'cpu', '--workdir', 'tep', '--set', 'rnn_size=16', '--set', "
        "'input_encoding_size=12', '--set', 'att_hid_size=8', '--set', "
        "'vse_embed_size=16', '--set', 'fc_feat_size=20', '--set', "
        "'att_feat_size=20', '--set', 'max_att_len=6'])\n"
        "assert out['n_predictions'] == 6 and out['platform'] == 'cpu'\n"),
    "host_tier": (
        "import importlib\n"
        "for name in ('utils.torch_interop', 'native.bindings', "
        "'metrics.spice'):\n"
        "    importlib.import_module("
        "'cooperativeimagecaptioning_tpu_torch.' + name)\n"
        + "    " + _CLEAN.replace("\n", "\n    ").rstrip(" ") +
        "from cooperativeimagecaptioning_tpu_torch.evaluation import "
        "coco_eval\n"
        "from cooperativeimagecaptioning_tpu_torch.native import bindings\n"
        "from cooperativeimagecaptioning_tpu_torch.training import "
        "checkpoint\n"
        "from cooperativeimagecaptioning_tpu_torch.utils import "
        "torch_interop\n"
        "params = checkpoint.load_params(os.path.join(d, 'model-best.pth'))\n"
        "torch_interop.save_torch_checkpoint(params, 'ref.pth')\n"
        "back = torch_interop.load_torch_checkpoint('ref.pth')\n"
        "assert all(torch.equal(back['speaker']['logit'][k], "
        "params['speaker']['logit'][k]) for k in ('w', 'b'))\n"
        "assert bindings.available(), bindings.build_log()\n"
        "coco = coco_eval.CocoAnnotations(dataset={'annotations': [{"
        "'image_id': 0, 'caption': 'a man rides a bike', 'id': 0}], "
        "'images': [{'id': 0}]})\n"
        "ev = coco_eval.CocoEvalCap(coco, coco.load_res([{'image_id': 0, "
        "'caption': 'a man riding a red bike'}]), include_spice=True)\n"
        "assert 0 < ev.evaluate()['SPICE'] < 1\n"),
    "orbax": (
        "from cooperativeimagecaptioning_tpu_torch import config\n"
        "from cooperativeimagecaptioning_tpu_torch.training import "
        "checkpoint, loop, orbax_tier\n"
        "fixture = os.path.join(sys.argv[2], 'tests', 'data', "
        "'jax_orbax_run')\n"
        "want = np.load(os.path.join(fixture, 'expected.npz'))\n"
        "got = checkpoint.load_params(os.path.join(fixture, "
        "'model-best.pth'))\n"
        "assert torch.equal(got['speaker']['logit']['w'], "
        "torch.from_numpy(want['speaker.logit.w']))\n"
        "opt = config.load_infos(os.path.join(d, 'infos_hc.pkl'))['opt']\n"
        "opt = opt.replace(start_from=d, checkpoint_backend='orbax', "
        "save_checkpoint_every=2, language_eval=0, "
        "checkpoint_path=os.path.join(os.getcwd(), 'orbax'))\n"
        "tr = loop.train(opt, dataset=ds, max_iterations=2, device='cpu', "
        "verbose=False)\n"
        "back = orbax_tier.read(os.path.join('orbax', 'model-2.orbax'))\n"
        "assert np.array_equal(back['speaker']['logit']['w'], "
        "tr.params['speaker']['logit']['w'].detach().numpy())\n"
        "assert int(tr.optim.states['speaker']['count']) == 3\n"
        "st = checkpoint.read_optimizer_file(os.path.join('orbax', "
        "'optimizer.pth'))\n"
        "assert type(st).__name__ == 'InjectStatefulHyperparamsState'\n"),
    "eval": (
        "from cooperativeimagecaptioning_tpu_torch import eval as ev\n"
        "out = ev.eval(None, os.path.join(d, 'model-best.pth'), "
        "os.path.join(d, 'infos_hc.pkl'), split='test', dataset=ds, "
        "device='cpu')\n"
        "assert len(out['split_predictions']) == 4\n"
        "assert 'CIDEr' in out['lang_stats']\n"),
}


@pytest.mark.parametrize("hide_jax_package", [False, True])
@pytest.mark.parametrize("entry", sorted(_ENTRY_CODE))
def test_jax_run_dir_loads_without_the_jax_package(jax_run_dir, tmp_path,
                                                   entry, hide_jax_package):
    """Each entry point of the port loads a run dir the JAX package wrote and
    runs on it, in a fresh process that afterwards holds none of `HIDDEN`
    (`jax`, that package, orbax, optax, tensorstore) -- where they could be
    imported, and where they could not (an import hook refuses them)."""
    hide = (
        "import importlib.abc\n"
        "class Refuse(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in %r:\n"
        "            raise ImportError('hidden for this test: ' + name)\n"
        "sys.meta_path.insert(0, Refuse())\n" % (HIDDEN,))
    code = (
        "import os, sys\n"
        + (hide if hide_jax_package else "") +
        "import numpy as np\n"
        "import torch\n"
        "torch.set_num_threads(min(2, torch.get_num_threads()))\n"
        "d = sys.argv[1]\n"
        "rng = np.random.RandomState(0)\n"
        "from cooperativeimagecaptioning_tpu_torch.data import "
        "SyntheticDataset\n"
        "ds = SyntheticDataset(num_images=20, vocab_size=25, seq_length=8, "
        "fc_feat_size=20, att_feat_size=20, max_K=6)\n"
        + _ENTRY_CODE[entry] + _CLEAN + "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code, jax_run_dir, REPO],
                          cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("clean")


_RANK_CODE = (
    "from cooperativeimagecaptioning_tpu_torch import config\n"
    "from cooperativeimagecaptioning_tpu_torch import eval as ev\n"
    "from cooperativeimagecaptioning_tpu_torch.data import SyntheticDataset\n"
    "from cooperativeimagecaptioning_tpu_torch.training import loop\n"
    "ds = SyntheticDataset(num_images=20, vocab_size=25, seq_length=8, "
    "fc_feat_size=20, att_feat_size=20, max_K=6)\n"
    "opt = config.load_infos(os.path.join(d, 'infos_hc.pkl'))['opt']\n"
    "opt = opt.replace(mesh_data_axis=1, mesh_model_axis=2, language_eval=0, "
    "save_checkpoint_every=100, "
    "checkpoint_path=os.path.join(os.getcwd(), 'mesh'))\n"
    "tr = loop.train(opt, dataset=ds, max_iterations=2, device='cpu', "
    "verbose=False)\n"
    "assert tr.iteration == 2 and tr.mesh.shape == {'data': 1, 'model': 2}\n"
    "out = ev.eval(opt, os.path.join(d, 'model-best.pth'), "
    "os.path.join(d, 'infos_hc.pkl'), split='test', dataset=ds, "
    "device='cpu')\n"
    "assert len(out['split_predictions']) == 4\n")


def test_a_spawned_rank_imports_no_jax(jax_run_dir, tmp_path):
    """Two ranks of a (1, 2) mesh (spawned by the port's launcher from a
    process that cannot import the JAX package) train on a run dir that
    package wrote and evaluate it through the vocab-sharded heads; neither
    rank, nor the parent, holds `jax` or the JAX package after."""
    code = (
        "import importlib.abc, sys\n"
        "class Refuse(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', %r):\n"
        "            raise ImportError('hidden for this test: ' + name)\n"
        "sys.meta_path.insert(0, Refuse())\n"
        "import torch_mesh_ranks\n"
        "from cooperativeimagecaptioning_tpu_torch.parallel import launch\n"
        "leaked = launch.spawn(torch_mesh_ranks.clean_rank, "
        "(%r, sys.argv[1]), 2, 'cpu')\n"
        "assert leaked == [[], []], leaked\n" % (JAXPKG, _RANK_CODE)
        + _CLEAN + "print('clean')\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO,
                                                              "tests")]))
    proc = subprocess.run([sys.executable, "-c", code, jax_run_dir],
                          cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("clean")
