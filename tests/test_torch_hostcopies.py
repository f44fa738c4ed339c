"""The port's own copies of the JAX package's host modules (config, the
data layer, the schedules, decode_sequence, the language metrics and the
CIDEr-D scorer) behave as the originals, and the port imports nothing of the
JAX package: a run dir that package wrote still loads, in a process that
afterwards holds neither `jax` nor any module of that package."""

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


def test_language_metrics_agree(jx, monkeypatch):
    """Tokenizer, BLEU, ROUGE-L, METEOR, CIDEr-D and the Porter stemmer:
    the port's pure-Python copies against the originals' pure-Python tier."""
    monkeypatch.setattr(jx["bindings"], "available", lambda: False)
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


def test_coco_eval_agrees(jx, monkeypatch):
    monkeypatch.setattr(jx["bindings"], "available", lambda: False)
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
              "att_stream_bench.py", "cell_bench.py")]
    for root, _, names in os.walk(os.path.join(REPO, PORT)):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_no_file_of_the_port_imports_the_jax_package():
    files = _port_files()
    assert len(files) > 30
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", JAXPKG), \
                (path, name)
        # nor by name at run time (importlib, __import__)
        src = open(path).read()
        assert f'"{JAXPKG}.' not in src.replace(f'"{JAXPKG}.config"', ""), \
            path


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
    pytest.importorskip("jax")
    from cooperativeimagecaptioning_tpu.config import Options
    from cooperativeimagecaptioning_tpu.training import checkpoint as jckpt
    from test_torch_att_model import jax_params
    d = tmp_path_factory.mktemp("jax_run_dir")
    opt = Options(caption_model="att2in2", vse_model="None", vocab_size=25,
                  rnn_size=16, input_encoding_size=12, att_hid_size=8,
                  fc_feat_size=20, att_feat_size=20, seq_length=8,
                  batch_size=4, seq_per_img=1, id="hc", language_eval=1,
                  max_att_len=6, phase=2, checkpoint_path=str(d))
    jckpt.save_params({"speaker": jax_params(opt, seed=5)},
                      str(d / "model-best.pth"))
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


_CLEAN = (
    "leaked = sorted(m for m in sys.modules if m == 'jax' or "
    "m.startswith('jax.') or m == %r or m.startswith(%r))\n"
    "assert not leaked, leaked\n" % (JAXPKG, JAXPKG + "."))

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
    runs on it, in a fresh process that afterwards holds neither `jax` nor
    any module of that package -- where that package could be imported, and
    where it could not (an import hook refuses it)."""
    hide = (
        "import importlib.abc\n"
        "class Refuse(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', %r):\n"
        "            raise ImportError('hidden for this test: ' + name)\n"
        "sys.meta_path.insert(0, Refuse())\n" % JAXPKG)
    code = (
        "import os, sys\n"
        + (hide if hide_jax_package else "") +
        "import numpy as np\n"
        "d = sys.argv[1]\n"
        "rng = np.random.RandomState(0)\n"
        "from cooperativeimagecaptioning_tpu_torch.data import "
        "SyntheticDataset\n"
        "ds = SyntheticDataset(num_images=20, vocab_size=25, seq_length=8, "
        "fc_feat_size=20, att_feat_size=20, max_K=6)\n"
        + _ENTRY_CODE[entry] + _CLEAN + "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code, jax_run_dir],
                          cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("clean")
