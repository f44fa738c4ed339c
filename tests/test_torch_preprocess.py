"""The port's preprocessing against the JAX package's, on the CPU in float32:
the ResNet (carried across by `params_from_jax`, and from a torchvision
state_dict through both packages' loaders), its pooling, the host resize,
the labels pipeline and the feature dirs each package reads of the other.

Tolerances: features within 1e-5 of the reference's max |value| (random
weights at the He scale grow activations with depth; a relative bound on
the largest value is the f32 rounding of a deep sum); pools and the host
resize exactly or to f32 rounding."""

import json
import os

import numpy as np
import pytest
import torch

from cooperativeimagecaptioning_tpu_torch.data.sources import \
    DirFeatureSource as TDirSource
from cooperativeimagecaptioning_tpu_torch.preprocess import feats as tfeats
from cooperativeimagecaptioning_tpu_torch.preprocess import labels as tlabels
from cooperativeimagecaptioning_tpu_torch.preprocess import resnet as tresnet

FEAT_REL = 1e-5
# intra-op threads of this file's ResNet forwards: the tier-1 run shares the
# host's cores among its workers, and torch's default of one thread a core
# in each of them oversubscribes the host several times over
THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(THREADS, before))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's preprocessing (skips where JAX is missing)."""
    jax = pytest.importorskip("jax")
    from cooperativeimagecaptioning_tpu.data.sources import DirFeatureSource
    from cooperativeimagecaptioning_tpu.preprocess import feats, labels, resnet
    return dict(jax=jax, resnet=resnet, feats=feats, labels=labels,
                DirFeatureSource=DirFeatureSource)


def np_tree(jx, arch, seed):
    """JAX init_params as numpy (conv HWIO), with batch-norm statistics
    drawn from a numpy seed so that the norms are not the identity."""
    tree = jx["jax"].tree.map(np.asarray, jx["resnet"].init_params(
        jx["jax"].random.PRNGKey(seed), arch))
    rng = np.random.RandomState(seed)

    def fill(node):
        if isinstance(node, dict):
            if "var" in node:
                c = node["var"].shape[0]
                node.update(
                    scale=rng.uniform(0.5, 1.5, c).astype(np.float32),
                    bias=rng.uniform(-0.2, 0.2, c).astype(np.float32),
                    mean=rng.uniform(-0.2, 0.2, c).astype(np.float32),
                    var=rng.uniform(0.5, 2.0, c).astype(np.float32))
            else:
                for v in node.values():
                    fill(v)
        elif isinstance(node, list):
            for v in node:
                fill(v)
    fill(tree)
    return tree


def port_model(tree, arch):
    return tresnet.load_weights(tresnet.ResNet(tresnet._blocks_of(arch)),
                                tresnet.params_from_jax(tree))


def jax_features(jx, tree, x, att_size):
    jnp = jx["jax"].numpy
    params = jx["jax"].tree.map(jnp.asarray, tree)
    fn = jx["jax"].jit(jx["resnet"].features, static_argnums=2)
    fc, att = fn(params, jnp.asarray(x), att_size)
    return np.asarray(fc), np.asarray(att)


def assert_features_close(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        scale = float(np.abs(w).max())
        assert np.abs(g - w).max() <= FEAT_REL * scale, \
            (np.abs(g - w).max(), scale)


def images(seed, b, h, w):
    return np.random.RandomState(seed).randn(b, h, w, 3).astype(np.float32)


@pytest.mark.parametrize("arch,hw,att_size", [
    ((1, 1, 1, 1), (64, 64), 2),
    ((1, 1, 1, 1), (97, 81), 7),
    ((2, 1, 3, 1), (112, 112), 14),
    ((2, 1, 3, 1), (65, 100), 7),
])
def test_resnet_features_match_jax(jx, arch, hw, att_size):
    tree = np_tree(jx, arch, seed=sum(hw))
    x = images(att_size, 2, *hw)
    with torch.no_grad():
        model = port_model(tree, arch)
        got = tresnet.features(model, torch.from_numpy(x), att_size)
        fmap = model(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy()
    assert_features_close([t.numpy() for t in got],
                          jax_features(jx, tree, x, att_size))
    want = np.asarray(jx["jax"].jit(jx["resnet"].resnet_forward)(
        jx["jax"].tree.map(jx["jax"].numpy.asarray, tree),
        jx["jax"].numpy.asarray(x)))
    assert_features_close([fmap], [want])


@pytest.fixture(scope="module")
def resnet101(jx):
    """Full ResNet-101 carried across from the JAX package's init."""
    tree = np_tree(jx, "resnet101", seed=0)
    return tree, port_model(tree, "resnet101")


def test_resnet101_full_depth_matches_jax(jx, resnet101):
    """The whole depth at 64 x 64: the layer4 map is 2 x 2, so att_size 14
    pools past the map (every cell a copy of one map position, as JAX's
    cell rule and F.adaptive_avg_pool2d both say)."""
    tree, model = resnet101
    x = images(1, 2, 64, 64)
    with torch.no_grad():
        got = [t.numpy() for t in tresnet.features(model, torch.from_numpy(x),
                                                   14)]
    want = jax_features(jx, tree, x, 14)
    assert_features_close(got, want)
    assert np.abs(want[1]).max() > 1.0  # the depth's growth is exercised
    # every JAX leaf has its entry, and nothing else is in the model but fc
    sizes = [v.numel() for k, v in model.state_dict().items()
             if not k.startswith("fc.") and "num_batches" not in k]
    assert sum(sizes) == sum(np.size(v) for v in
                             jx["jax"].tree.leaves(tree))


def torchvision_state_dict(arch, seed):
    """A state_dict in torchvision's layout: OIHW convs, batch norms with
    running statistics and num_batches_tracked, and the classifier fc."""
    model = tresnet.init_model(torch.Generator().manual_seed(seed), arch)
    g = torch.Generator().manual_seed(seed + 1)
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith("running_var"):
            v = 0.5 + torch.rand(v.shape, generator=g)
        elif k.endswith(("running_mean", "bias")) or \
                (k.endswith("weight") and v.ndim == 1):
            v = 0.3 * torch.randn(v.shape, generator=g) + \
                (1.0 if k.endswith("weight") else 0.0)
        elif k == "fc.weight":
            v = torch.randn(v.shape, generator=g)
        elif k.endswith("num_batches_tracked"):
            v = torch.tensor(7)
        sd[k] = v.clone()
    return sd


def test_torchvision_state_dict_loads_in_both(jx):
    """The reference path for pretrained weights: JAX converts the dict
    (convert_torch_state_dict), the port loads it as it is."""
    arch = (2, 1, 3, 1)
    sd = torchvision_state_dict(arch, seed=3)
    assert {"fc.weight", "fc.bias", "layer1.0.bn1.num_batches_tracked"} <= \
        set(sd)
    model = tresnet.load_weights(tresnet.ResNet(arch), sd)
    x = images(2, 2, 80, 80)
    with torch.no_grad():
        got = [t.numpy() for t in tresnet.features(model, torch.from_numpy(x),
                                                   7)]
    params = jx["resnet"].convert_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()}, arch)
    tree = jx["jax"].tree.map(np.asarray, params)
    assert_features_close(got, jax_features(jx, tree, x, 7))
    # and params_from_jax of the converted tree is the dict itself
    back = tresnet.params_from_jax(tree)
    for k, v in back.items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    assert set(sd) - set(back) == {k for k in sd if k.startswith("fc.")
                                   or k.endswith("num_batches_tracked")}


def test_load_weights_refuses_a_foreign_dict():
    sd = tresnet.ResNet((1, 1, 1, 1)).state_dict()
    with pytest.raises(KeyError, match="missing"):
        tresnet.load_weights(tresnet.ResNet((1, 1, 2, 1)), sd)


def test_init_model_he_scale_and_identity_norms():
    model = tresnet.init_model(torch.Generator().manual_seed(0), (1, 1, 1, 1))
    w = model.layer3[0].conv2.weight  # 3x3, 256 out
    assert abs(float(w.std()) - np.sqrt(2.0 / (9 * 256))) < 2e-3
    bn = model.layer3[0].bn2
    assert float(bn.weight.min()) == float(bn.running_var.max()) == 1.0
    assert not model.training
    again = tresnet.init_model(torch.Generator().manual_seed(0), (1, 1, 1, 1))
    torch.testing.assert_close(again.conv1.weight, model.conv1.weight,
                               rtol=0, atol=0)


@pytest.mark.parametrize("H,W", [(7, 7), (8, 9), (9, 8), (112, 113),
                                 (113, 113)])
def test_max_pool_ceil_mode_matches_jax(jx, H, W):
    x = np.random.RandomState(H * W).randn(2, H, W, 4).astype(np.float32)
    pool = tresnet.ResNet((1, 1, 1, 1)).maxpool
    got = pool(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    want = np.asarray(jx["resnet"].max_pool_ceil(jx["jax"].numpy.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("H,W,out", [(2, 2, 14), (3, 5, 7), (14, 14, 14),
                                     (15, 29, 7), (1, 1, 3)])
def test_adaptive_pool_matches_jax(jx, H, W, out):
    """F.adaptive_avg_pool2d against JAX's cell rule, also where the map is
    smaller than the grid (cells repeat map positions)."""
    x = np.random.RandomState(H + W).randn(2, H, W, 8).astype(np.float32)
    got = torch.nn.functional.adaptive_avg_pool2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), (out, out)).permute(
        0, 2, 3, 1).numpy()
    want = np.asarray(jx["resnet"].adaptive_avg_pool(
        jx["jax"].numpy.asarray(x), (out, out)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("h,w,s", [(37, 53, 64), (64, 64, 32), (100, 40, 48),
                                   (480, 640, 448)])
def test_host_resize_equals_the_jax_packages(jx, h, w, s):
    for n_in, n_out in ((h, s), (w, s)):
        np.testing.assert_array_equal(tfeats._lin_weights(n_in, n_out),
                                      jx["feats"]._lin_weights(n_in, n_out))
    img = np.random.RandomState(h).rand(h, w, 3).astype(np.float32)
    np.testing.assert_array_equal(tfeats._resize_bilinear(img, s),
                                  jx["feats"]._resize_bilinear(img, s))
    gray = np.random.RandomState(w).randint(0, 255, (h, w), np.uint8)
    np.testing.assert_array_equal(tfeats._to_rgb_float(gray),
                                  jx["feats"]._to_rgb_float(gray))


def test_preprocess_images_matches_jax(jx):
    x = np.random.RandomState(0).randint(0, 255, (2, 5, 6, 3), np.uint8)
    got = tresnet.preprocess_images(torch.from_numpy(x)).numpy()
    want = np.asarray(jx["resnet"].preprocess_images(
        jx["jax"].numpy.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_f32_convolutions_switches_only_tf32():
    cudnn = torch.backends.cudnn
    before = (cudnn.enabled, cudnn.benchmark, cudnn.deterministic,
              cudnn.allow_tf32)
    with tresnet.f32_convolutions():
        assert (cudnn.enabled, cudnn.benchmark, cudnn.deterministic) == \
            before[:3]
        assert cudnn.allow_tf32 is False
    assert (cudnn.enabled, cudnn.benchmark, cudnn.deterministic,
            cudnn.allow_tf32) == before


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_the_extractor_raises_without_a_card():
    model = tresnet.ResNet((1, 1, 1, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfeats.make_extractor(model, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfeats.main(["--input_json", "missing.json"])


# ---------------------------------------------------------------------------
# labels
# ---------------------------------------------------------------------------

def karpathy_json(path, n_imgs=7, flickr=False):
    rng = np.random.RandomState(n_imgs)
    words = ["a", "man", "dog", "rides", "bike", "red", "park", "rareword1",
             "rareword2"]
    imgs = []
    for i in range(n_imgs):
        sents = []
        for _ in range(rng.randint(2, 4)):
            toks = list(rng.choice(words[:7], rng.randint(3, 20)))
            if rng.rand() < 0.3:
                toks.append(words[7 + rng.randint(2)])
            sents.append({"tokens": toks})
        sents.append({"tokens": words[:7]})
        img = {"sentences": sents, "split": ["train", "val", "test"][i % 3],
               "filename": f"img{i}.jpg"}
        if flickr:
            img["imgid"] = 7000 + i
        else:
            img.update(cocoid=1000 + i, filepath="val2014")
        imgs.append(img)
    with open(path, "w") as f:
        json.dump({"images": imgs}, f)
    return str(path)


@pytest.mark.parametrize("dataset,threshold", [("coco", 5), ("coco", 0),
                                               ("flickr30k", 5)])
def test_labels_write_what_the_jax_package_writes(jx, tmp_path, dataset,
                                                  threshold):
    h5py = pytest.importorskip("h5py")
    src = karpathy_json(tmp_path / "raw.json", flickr=dataset != "coco")
    outs = {}
    for name, mod in (("jax", jx["labels"]), ("port", tlabels)):
        d = tmp_path / name
        d.mkdir()
        info = mod.main(["--input_json", src,
                         "--output_json", str(d / "talk.json"),
                         "--output_h5", str(d / "talk"),
                         "--max_length", "16", "--dataset", dataset,
                         "--word_count_threshold", str(threshold)])
        with open(d / "talk.json") as f:
            written = json.load(f)
        with h5py.File(d / "talk_label.h5", "r") as f:
            h5 = {k: (f[k].dtype, f[k][...]) for k in f}
        outs[name] = (info, written, h5)
    (jinfo, jjson, jh5), (tinfo, tjson, th5) = outs["jax"], outs["port"]
    assert tinfo == jinfo and tjson == jjson
    assert set(th5) == set(jh5) == {"labels", "label_start_ix",
                                    "label_end_ix", "label_length"}
    for k in jh5:
        assert th5[k][0] == jh5[k][0]
        np.testing.assert_array_equal(th5[k][1], jh5[k][1])
    assert (threshold == 5) == ("UNK" in tjson["ix_to_word"].values())


def test_build_vocab_and_encode_match_jax(jx):
    imgs = [{"sentences": [{"tokens": ["common"] * 7 + ["rare"]},
                           {"tokens": ["common"] * 20}]}]
    jimgs = json.loads(json.dumps(imgs))
    assert tlabels.build_vocab(imgs, 5) == jx["labels"].build_vocab(jimgs, 5)
    assert imgs == jimgs
    wtoi = {"common": 1, "UNK": 2}
    for a, b in zip(tlabels.encode_captions(imgs, wtoi, 16),
                    jx["labels"].encode_captions(jimgs, wtoi, 16)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# feature dirs
# ---------------------------------------------------------------------------

ARCH = (1, 1, 1, 1)


@pytest.fixture(scope="module")
def small(jx):
    tree = np_tree(jx, ARCH, seed=11)
    return tree, port_model(tree, ARCH)


def raw_images(n, seed=0):
    rng = np.random.RandomState(seed)
    shapes = [(70, 90, 3), (50, 50), (64, 64, 3), (41, 77, 3), (90, 70, 3)]
    return [rng.randint(0, 255, shapes[i % len(shapes)], np.uint8)
            for i in range(n)]


def read_dir(source_cls, base, ids):
    fc = source_cls(base + "_fc", ".npy")
    att = source_cls(base + "_att", ".npz")
    return ([fc.get(str(k)) for k in ids], [att.get(str(k)) for k in ids])


@pytest.mark.parametrize("resize_to", [64, None])
def test_feature_dirs_read_across_the_packages(jx, small, tmp_path,
                                               resize_to):
    """Each package extracts the same images with the same weights; each
    reads the other's dirs; the features agree.  resize_to=None runs one
    image at a time at its own resolution (one grayscale)."""
    tree, model = small
    imgs, ids = raw_images(5), [101, 102, 103, 104, 105]
    params = jx["jax"].tree.map(jx["jax"].numpy.asarray, tree)
    jbase, tbase = str(tmp_path / "jax"), str(tmp_path / "port")
    jx["feats"].extract_to_dirs(params, imgs, ids, jbase, att_size=3,
                                batch_size=2, resize_to=resize_to)
    timings = {}
    dirs = tfeats.extract_to_dirs(model, imgs, ids, tbase, att_size=3,
                                  batch_size=2, resize_to=resize_to,
                                  device="cpu", timings=timings)
    assert dirs == (tbase + "_fc", tbase + "_att")
    assert timings["images"] == 5 and timings["forward"] > 0
    # no temporaries left behind
    assert sorted(os.listdir(tbase + "_att")) == [f"{i}.npz" for i in ids]
    for reader in (TDirSource, jx["DirFeatureSource"]):
        for base in (jbase, tbase):
            fcs, atts = read_dir(reader, base, ids)
            assert all(f.shape == (2048,) and f.dtype == np.float32
                       for f in fcs)
            assert all(a.shape == (3, 3, 2048) and a.dtype == np.float32
                       for a in atts)
    jfc, jatt = read_dir(TDirSource, jbase, ids)
    tfc, tatt = read_dir(jx["DirFeatureSource"], tbase, ids)
    for k in range(len(ids)):
        assert_features_close([tfc[k], tatt[k]], [jfc[k], jatt[k]])


def test_extraction_resumes_and_keeps_the_last_partial_batch(small,
                                                             tmp_path):
    _, model = small
    imgs, ids = raw_images(5, seed=1), [0, 1, 2, 3, 4]
    base = str(tmp_path / "talk")
    tfeats.extract_to_dirs(model, imgs[:2], ids[:2], base, att_size=2,
                           batch_size=2, resize_to=32, device="cpu")
    before = {f: os.path.getmtime(os.path.join(base + "_fc", f))
              for f in os.listdir(base + "_fc")}
    timings = {}
    tfeats.extract_to_dirs(model, imgs, ids, base, att_size=2, batch_size=2,
                           resize_to=32, device="cpu", timings=timings)
    assert timings["images"] == 3  # 2 already there; the last batch is 1
    assert {f: os.path.getmtime(os.path.join(base + "_fc", f))
            for f in before} == before
    assert sorted(os.listdir(base + "_fc")) == [f"{i}.npy" for i in ids]
    # the partial last batch computes what a batch of one computes
    one = str(tmp_path / "one")
    tfeats.extract_to_dirs(model, imgs[4:], ids[4:], one, att_size=2,
                           batch_size=1, resize_to=32, device="cpu")
    a = np.load(os.path.join(base + "_att", "4.npz"))["feat"]
    b = np.load(os.path.join(one + "_att", "4.npz"))["feat"]
    np.testing.assert_allclose(a, b, rtol=0, atol=FEAT_REL * np.abs(b).max())
    again = {}
    tfeats.extract_to_dirs(model, imgs, ids, base, att_size=2, batch_size=2,
                           resize_to=32, device="cpu", timings=again)
    assert again["images"] == 0


def test_prepro_feats_matches_jax_from_a_weights_file(jx, tmp_path):
    """prepro_feats end to end (json -> image files -> dirs) in both packages
    from one pickled torchvision state_dict."""
    import pickle
    pytest.importorskip("PIL")
    from cooperativeimagecaptioning_tpu_torch.scripts import reproduce_coco
    raw, root = reproduce_coco.fabricate_synthetic_raw(str(tmp_path), 3,
                                                       size=40)
    sd = torchvision_state_dict(ARCH, seed=5)
    weights = str(tmp_path / "w.pkl")
    with open(weights, "wb") as f:
        pickle.dump({k: v.numpy() for k, v in sd.items()}, f)
    kw = dict(model_weights=weights, arch=ARCH, att_size=2, batch_size=2,
              resize_to=64)
    jx["feats"].prepro_feats(raw, root, str(tmp_path / "j"), **kw)
    tfeats.prepro_feats(raw, root, str(tmp_path / "t"), device="cpu", **kw)
    jfc, jatt = read_dir(TDirSource, str(tmp_path / "j"), range(3))
    tfc, tatt = read_dir(TDirSource, str(tmp_path / "t"), range(3))
    for k in range(3):
        assert_features_close([tfc[k], tatt[k]], [jfc[k], jatt[k]])
