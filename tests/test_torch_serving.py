"""Port parity of the serving path: the PyTorch CaptioningService (on the
CPU, float32, i.e. the plain versions of the kernels) against the JAX
service over one run dir written by the JAX package.  Ids must be exactly
equal, greedy and beam 2, across bucket padding, chunking, the zero-mask
guard and truncation."""

import io
import json
import os
import pickle
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from cooperativeimagecaptioning_tpu import serving as jserving  # noqa: E402
from cooperativeimagecaptioning_tpu.training import checkpoint as jckpt  # noqa: E402
from cooperativeimagecaptioning_tpu_torch import models as tmodels  # noqa: E402
from cooperativeimagecaptioning_tpu_torch import serving as tserving  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.training import checkpoint as tckpt  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.training import joint as tjoint  # noqa: E402
from test_torch_att_model import jax_params, tiny_opt  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKETS = (1, 8, 16)
K = 6


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_serving")
    opt = tiny_opt(checkpoint_path=str(d))
    jckpt.save_params({"speaker": jax_params(opt, seed=3)},
                      str(d / "model-best.pth"))
    vocab = {str(i): f"w{i}" for i in range(1, opt.vocab_size + 1)}
    with open(d / "infos_.pkl", "wb") as f:
        pickle.dump({"opt": opt, "vocab": vocab}, f)
    return str(d), opt


@pytest.fixture(scope="module")
def services(run_dir):
    d, _ = run_dir
    kw = dict(buckets=BUCKETS, compute_dtype="float32", max_att_len=K)
    return {m: (jserving.CaptioningService.from_run_dir(d, beam_size=m, **kw),
                tserving.CaptioningService.from_run_dir(
                    d, beam_size=m, device="cpu", **kw))
            for m in (0, 2)}


def request(opt, n, seed=0, k=K):
    rng = np.random.RandomState(seed)
    fc = rng.randn(n, opt.fc_feat_size).astype(np.float32)
    att = rng.randn(n, k, opt.att_feat_size).astype(np.float32)
    masks = np.ones((n, k), np.float32)
    masks[::3, k // 2:] = 0.0
    return fc, att, masks


@pytest.mark.parametrize("n", [0, 1, 5, 13])
@pytest.mark.parametrize("beam", [0, 2])
def test_caption_ids_match_jax_service(run_dir, services, beam, n):
    _, opt = run_dir
    jsvc, tsvc = services[beam]
    fc, att, masks = request(opt, n, seed=n + beam)
    got = tsvc.caption_ids(fc, att, masks)
    want = jsvc.caption_ids(fc, att, masks)
    assert got.dtype == np.int32 and got.shape == (n, opt.seq_length)
    np.testing.assert_array_equal(got, np.asarray(want))
    if n:
        assert tsvc.caption(fc, att, masks) == jsvc.caption(fc, att, masks)


def test_chunking_over_the_largest_bucket(run_dir, services):
    """40 images over buckets (1, 8, 16): chunks of 16, 16 and a re-bucketed
    remainder of 8; no mask given (all slots valid)."""
    _, opt = run_dir
    jsvc, tsvc = services[0]
    fc, att, _ = request(opt, 40, seed=9)
    np.testing.assert_array_equal(tsvc.caption_ids(fc, att),
                                  np.asarray(jsvc.caption_ids(fc, att)))


@pytest.mark.parametrize("beam", [0, 2])
def test_zero_mask_and_truncation_guards_match_jax(run_dir, services, beam):
    """Features with 8 slots truncated to max_att_len=6; some rows' valid
    slots all lie beyond 6, so their masks are all-zero after truncation
    and get their first key back.  The caller's mask is never changed."""
    _, opt = run_dir
    jsvc, tsvc = services[beam]
    fc, att, _ = request(opt, 5, seed=11, k=8)
    masks = np.ones((5, 8), np.float32)
    masks[1, :6] = 0.0
    masks[3, :6] = 0.0
    orig = masks.copy()
    got = tsvc.caption_ids(fc, att, masks)
    np.testing.assert_array_equal(masks, orig)
    np.testing.assert_array_equal(got, np.asarray(
        jsvc.caption_ids(fc, att, masks)))
    first_key = masks[:, :6].copy()
    first_key[[1, 3], 0] = 1.0
    np.testing.assert_array_equal(got, tsvc.caption_ids(fc, att[:, :6],
                                                        first_key))


def test_warmup_runs_every_bucket(services):
    _, tsvc = services[2]
    tsvc.warmup()


def test_http_endpoint_json_and_npz(run_dir, services):
    _, opt = run_dir
    jsvc, tsvc = services[0]
    srv = tserving.make_http_server(tsvc, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            hz = json.loads(r.read())
        assert hz["status"] == "ok" and hz["buckets"] == list(BUCKETS)
        fc, att, masks = request(opt, 3, seed=5)
        req = urllib.request.Request(
            base + "/caption",
            data=json.dumps({"fc": fc.tolist(), "att": att.tolist(),
                             "att_masks": masks.tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read())
        want = np.asarray(jsvc.caption_ids(fc, att, masks))
        np.testing.assert_array_equal(np.asarray(out["ids"]), want)
        assert out["captions"] == jsvc.caption(fc, att, masks)
        buf = io.BytesIO()
        np.savez(buf, fc=fc, att=att, att_masks=masks)
        req = urllib.request.Request(
            base + "/caption", data=buf.getvalue(),
            headers={"Content-Type": "application/x-npz"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert json.loads(r.read())["ids"] == out["ids"]
        bad = urllib.request.Request(
            base + "/caption", data=b"{}",
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad, timeout=30)
        assert e.value.code == 400
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
    assert not th.is_alive()


def test_cuda_device_without_a_gpu_raises(run_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present here")
    d, _ = run_dir
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserving.CaptioningService.from_run_dir(d)  # device defaults to cuda


@pytest.fixture(scope="module")
def layout_services(run_dir):
    d, _ = run_dir
    kw = dict(buckets=BUCKETS, compute_dtype="float32", max_att_len=K)
    return {(name, m): (
        jserving.CaptioningService.from_run_dir(d, beam_size=m, **kw, **lay),
        tserving.CaptioningService.from_run_dir(d, beam_size=m, device="cpu",
                                                **kw, **lay))
        for name, lay in (("int8", {"att_quant": "int8"}),
                          ("kmajor", {"att_kmajor": 1}))
        for m in (0, 2)}


@pytest.mark.parametrize("n", [5, 13])
@pytest.mark.parametrize("beam", [0, 2])
@pytest.mark.parametrize("layout", ["int8", "kmajor"])
def test_decode_layouts_match_jax_service(run_dir, layout_services, layout,
                                          beam, n):
    """att_quant="int8" and att_kmajor=1: ids bit-equal to the JAX service's,
    greedy and beam 2, across bucket padding."""
    _, opt = run_dir
    jsvc, tsvc = layout_services[layout, beam]
    fc, att, masks = request(opt, n, seed=n + beam)
    got = tsvc.caption_ids(fc, att, masks)
    np.testing.assert_array_equal(got, np.asarray(
        jsvc.caption_ids(fc, att, masks)))
    assert len(np.unique(got)) > 2


def test_decode_layout_precedence(run_dir, monkeypatch):
    """int8 wins over K-major; att_kmajor=None keeps the opt's value and an
    explicit value overrides it on a private copy of the opt (JAX
    serving.py:44-51, 110-116)."""
    d, opt = run_dir
    seen = []
    for name in ("quantize_ctx", "kmajor_ctx"):
        orig = getattr(tmodels.att_model.AttModel, name)
        monkeypatch.setattr(
            tmodels.att_model.AttModel, name,
            staticmethod(lambda ctx, name=name, orig=orig:
                         seen.append(name) or orig(ctx)))
    params = tckpt.load_params(os.path.join(d, "model-best.pth"))
    vocab = {str(i): f"w{i}" for i in range(1, opt.vocab_size + 1)}
    kw = dict(buckets=(4,), compute_dtype="float32", max_att_len=K,
              device="cpu")
    fc, att, masks = request(opt, 3)
    for svc_kw, opt_kw, want in (
            ({}, {}, []),
            ({"att_quant": "int8", "att_kmajor": 1}, {}, ["quantize_ctx"]),
            ({}, {"att_kmajor": 1}, ["kmajor_ctx"]),
            ({"att_kmajor": 0}, {"att_kmajor": 1}, []),
            ({"att_kmajor": 1}, {"att_quant": "int8"}, ["quantize_ctx"]),
            ({"att_kmajor": 1}, {}, ["kmajor_ctx"])):
        o = opt.replace(**opt_kw)
        before = vars(o).copy()
        svc = tserving.CaptioningService(o, params, vocab, **kw, **svc_kw)
        del seen[:]
        svc.caption_ids(fc, att, masks)
        assert seen == want, (svc_kw, opt_kw)
        assert vars(o) == before


@pytest.mark.parametrize("name,kind", [("fc", "caption_model"),
                                       ("fc", "vse_model")])
def test_unported_models_raise(run_dir, name, kind):
    """Both models are ported: setup returns the FC speaker and the VSE
    listener (unknown names still raise)."""
    from cooperativeimagecaptioning_tpu_torch.models import fc_model, vse
    _, opt = run_dir
    want = {"caption_model": fc_model.FCModel, "vse_model": vse.VSEModel}
    assert tmodels.setup(opt, name, kind) is want[kind]
    with pytest.raises(ValueError, match="not supported"):
        tmodels.setup(opt, "fc2", kind)


def test_checkpoints_load_in_both_packages(run_dir, tmp_path):
    d, opt = run_dir
    # JAX-written -> port
    jtree = jckpt.load_params(os.path.join(d, "model-best.pth"))
    ttree = tckpt.load_params(os.path.join(d, "model-best.pth"))
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(
            jax.tree.map(lambda t: t.numpy(), ttree))):
        np.testing.assert_array_equal(np.asarray(a), b)
    # port-written -> JAX
    path = str(tmp_path / "model-best.pth")
    tckpt.save_params(tjoint.init_params(5, opt), path)
    back = jckpt.load_params(path)
    again = tckpt.load_params(path)
    np.testing.assert_array_equal(np.asarray(back["speaker"]["logit"]["w"]),
                                  again["speaker"]["logit"]["w"].numpy())


def test_speaker_view_injects_the_shared_embedding(run_dir):
    _, opt = run_dir
    shared = opt.replace(share_embed=1)
    emb = torch.ones(3, 2)
    params = {"speaker": {"logit": {}}, "listener": {"txt_enc": {
        "embed": emb}}}
    assert tjoint.speaker_view(params, shared)["embed"] is emb
    assert "embed" not in tjoint.speaker_view(params, opt)


def test_bf16_service_casts_the_speaker(run_dir):
    d, opt = run_dir
    svc = tserving.CaptioningService.from_run_dir(
        d, buckets=BUCKETS, compute_dtype="bfloat16", max_att_len=K,
        device="cpu")
    assert {q.dtype for q in svc.speaker.parameters()} == {torch.bfloat16}
    ids = svc.caption_ids(*request(opt, 5, seed=9))
    assert ids.shape == (5, opt.seq_length) and ids.dtype == np.int32
    assert 0 <= ids.min() and ids.max() <= opt.vocab_size


def test_port_options_are_the_ports_own(run_dir):
    """Run dirs of the JAX package pickle Options under that package's
    name; the port reads them into its own class, not the JAX package's."""
    from cooperativeimagecaptioning_tpu import config as jconfig
    from cooperativeimagecaptioning_tpu_torch import config as tconfig
    assert tconfig.Options is not jconfig.Options
    d, opt = run_dir
    infos = tconfig.load_infos(os.path.join(d, "infos_.pkl"))
    assert type(infos["opt"]) is tconfig.Options and type(opt) is \
        jconfig.Options
    assert vars(infos["opt"]) == vars(opt)


@pytest.mark.parametrize("script", ["chip_smoke.py", "serve_breakdown.py",
                                    "train_breakdown.py", "att_stream_bench.py",
                                    "cell_bench.py"])
def test_card_scripts_import_nothing_of_jax(script):
    """The card's machine has no JAX: these scripts import the port, and
    nothing of the JAX package."""
    import ast
    tree = ast.parse(open(os.path.join(REPO, script)).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    top = {n.split(".")[0] for n in names}
    assert "jax" not in top and "cooperativeimagecaptioning_tpu" not in top
    assert "cooperativeimagecaptioning_tpu_torch" in top


def test_serving_imports_no_jax():
    code = ("import sys, cooperativeimagecaptioning_tpu_torch.serving; "
            "assert 'jax' not in sys.modules, 'jax was imported'; "
            "assert 'cooperativeimagecaptioning_tpu' not in sys.modules, "
            "'the JAX package was imported'")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
