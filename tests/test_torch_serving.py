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
    jckpt.save_params({"speaker": jax_params(opt, seed=4)},
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


@pytest.mark.parametrize("kw", [{"att_quant": "int8"}, {"att_kmajor": 1}])
def test_unported_decode_layouts_raise(run_dir, kw):
    d, _ = run_dir
    with pytest.raises(NotImplementedError):
        tserving.CaptioningService.from_run_dir(d, device="cpu", **kw)


@pytest.mark.parametrize("name,kind", [("fc", "caption_model"),
                                       ("fc", "vse_model")])
def test_unported_models_raise(run_dir, name, kind):
    _, opt = run_dir
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmodels.setup(opt, name, kind)


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


def test_port_options_are_the_jax_packages():
    """Run dirs pickle Options under the JAX package's name; the port's
    re-export must be that very class."""
    from cooperativeimagecaptioning_tpu import config as jconfig
    from cooperativeimagecaptioning_tpu_torch import config as tconfig
    assert tconfig.Options is jconfig.Options


@pytest.mark.parametrize("script", ["chip_smoke.py", "serve_breakdown.py",
                                    "train_breakdown.py"])
def test_card_scripts_import_nothing_of_jax(script):
    """The card's machine has no JAX: these scripts reach the JAX package
    only through the port."""
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
            "assert 'jax' not in sys.modules, 'jax was imported'")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
