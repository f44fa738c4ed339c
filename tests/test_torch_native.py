"""The port's C++ host tier (native/: the PTB tokenizer, METEOR, the Porter
stemmer, the npy/npz readers, SPICE-lite) against the JAX package's native
tier and both packages' pure-Python tiers, on the cases of
tests/test_native.py; and the port's build (into build/native/, keyed on
its sources, the compiler's output kept when it fails)."""

import os
import random
import shutil
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from cooperativeimagecaptioning_tpu.metrics import meteor as jmeteor  # noqa: E402
from cooperativeimagecaptioning_tpu.metrics import porter as jporter  # noqa: E402
from cooperativeimagecaptioning_tpu.metrics import spice as jspice  # noqa: E402
from cooperativeimagecaptioning_tpu.metrics import tokenizer as jtok  # noqa: E402
from cooperativeimagecaptioning_tpu.native import bindings as jbind  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.data.sources import DirFeatureSource  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.metrics import meteor as tmeteor  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.metrics import porter as tporter  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.metrics import spice as tspice  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.metrics import tokenizer as ttok  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.native import bindings as tbind  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_native.py's cases
WORDS = ["caresses", "flies", "dies", "mules", "denied", "died", "agreed",
         "owned", "humbled", "sized", "meetings", "stating", "siezing",
         "itemization", "sensational", "traditional", "reference", "colonizer",
         "plotted", "riding", "rides", "horse", "happiness", "relational",
         "conditional", "rational", "valency", "hesitancy", "digitizer",
         "conformably", "radically", "differently", "vilely", "analogously"]
CAPTIONS = {
    0: [{"caption": "A man, riding; on the dog's back!"}],
    1: [{"caption": "Hello... (world)? It isn't -- really \"fine\"."}],
    2: [{"caption": "Two dogs play:  in the grass."}],
}
EMPTY_CAPTIONS = {0: [{"caption": ""}], 1: [{"caption": "a man"}],
                  2: [{"caption": ""}]}
TOKEN_PIECES = ["a", "man", "dog's", "isn't", "--", "...", "(hello)",
                "\"fine\"", "it;", "two,", "play:", "grass.", "world?",
                "don't", "U.S.", "Mr.", "50%", "$5", "3.14", "#1", "a-b",
                "x--y", "''", "``", "[ok]", "{no}", "he'll", "they're",
                "won't", "&", "@home", "*"]
METEOR_WORDS = ["a", "man", "rides", "riding", "dog", "park", "the", "on",
                "grass", "sits"]
METEOR_FUZZ_WORDS = METEOR_WORDS + [
    "cat", "running", "ran", "happily", "dogs", "parks", "walked", "walk",
    "jumps", "jumped"]
SPICE_CASES = [
    ("a young man riding a red bike in the park",
     ["a man rides a bicycle", "the man is on a red bike in a park"]),
    ("two dogs play in the green grass",
     ["dogs playing on grass", "a dog runs through a field"]),
    ("", ["a cat"]),
    ("a painting of the old building hanging on a wall",
     ["an old painting on the wall of a building"]),
    ("woman wearing a blue dress holding an umbrella",
     ["a woman in a blue dress holds an umbrella"]),
]
CATS = ("All", "Object", "Attribute", "Relation")


@pytest.fixture(scope="module")
def native():
    """Both packages' libraries, built (skips where there is no g++)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the C++ host tier cannot be built here")
    assert tbind.available(), tbind.build_log()
    assert jbind.available()
    return tbind


@pytest.fixture
def python_tier(monkeypatch):
    """Both packages' metric modules on their pure-Python tier."""
    monkeypatch.setattr(jbind, "available", lambda: False)
    monkeypatch.setattr(tbind, "available", lambda: False)


def _tokenize_python(mod, caps):
    return {k: [" ".join(t for t in mod.ptb_tokenize_line(c["caption"])
                         if t not in mod.PUNCTUATIONS) for c in cs]
            for k, cs in caps.items()}


def _token_fuzz():
    rng = random.Random(7)
    return [" ".join(rng.choices(TOKEN_PIECES, k=rng.randint(0, 10)))
            for _ in range(500)]


@pytest.mark.parametrize("case", ["cases", "empty", "fuzz"])
def test_tokenizer_tiers_agree(native, case):
    if case == "cases":
        corpora = [CAPTIONS]
    elif case == "empty":
        corpora = [EMPTY_CAPTIONS]
        assert native.ptb_tokenize(EMPTY_CAPTIONS) == \
            {0: [""], 1: ["a man"], 2: [""]}
    else:
        corpora = [{0: [{"caption": c}]} for c in _token_fuzz()]
        # and the whole fuzz set as one batch through the line protocol
        corpora.append({i: [{"caption": c}]
                        for i, c in enumerate(_token_fuzz())})
    for caps in corpora:
        want = _tokenize_python(jtok, caps)
        assert _tokenize_python(ttok, caps) == want
        assert native.ptb_tokenize(caps) == want
        assert jbind.ptb_tokenize(caps) == want
        assert ttok.tokenize(caps) == want  # the dispatch takes the C++ tier


def test_tokenizer_dispatch_python_tier(python_tier):
    for caps in (CAPTIONS, EMPTY_CAPTIONS):
        assert ttok.tokenize(caps) == jtok.tokenize(caps)


@pytest.mark.parametrize("word", WORDS)
def test_porter_tiers_agree(native, word):
    want = jporter.stem(word)
    assert tporter.stem(word) == want
    assert native.porter_stem(word) == want == jbind.porter_stem(word)


def _meteor_corpora(case):
    if case == "cases":
        rng = np.random.RandomState(0)
        gts, res = {}, {}
        for i in range(12):
            gts[i] = [" ".join(rng.choice(METEOR_WORDS, rng.randint(3, 9)))
                      for _ in range(3)]
            res[i] = [" ".join(rng.choice(METEOR_WORDS, rng.randint(3, 9)))]
        return [(gts, res)]
    rng = random.Random(11)
    out = []
    for _ in range(150):
        gts = [" ".join(rng.choices(METEOR_FUZZ_WORDS,
                                    k=rng.randint(1, 12))) for _ in range(3)]
        res = " ".join(rng.choices(METEOR_FUZZ_WORDS, k=rng.randint(1, 12)))
        out.append(({0: gts}, {0: [res]}))
    return out


@pytest.mark.parametrize("case", ["cases", "fuzz"])
def test_meteor_tiers_agree(native, case):
    for gts, res in _meteor_corpora(case):
        ids = sorted(gts, key=str)
        want = np.array([jmeteor.sentence_meteor(res[i][0], gts[i])
                         for i in ids])
        got_py = np.array([tmeteor.sentence_meteor(res[i][0], gts[i])
                           for i in ids])
        np.testing.assert_array_equal(got_py, want)
        corpus_t, per_t = native.meteor(gts, res)
        corpus_j, per_j = jbind.meteor(gts, res)
        np.testing.assert_allclose(per_t, want, rtol=0, atol=1e-12)
        np.testing.assert_array_equal(per_t, per_j)
        assert corpus_t == corpus_j
        # compute_meteor dispatches to the C++ tier
        assert tmeteor.compute_meteor(gts, res)[0] == corpus_t


def test_meteor_resources_wire_format(native):
    """MeteorResources.serialize (cic_meteor_configure's wire format) is the
    JAX package's, and both native tiers score with the pushed resources
    as the Python tier does."""
    groups = [["man", "person"], ["dog", "canine"]]
    para = [(["riding"], ["on", "top", "of"])]
    tres = tmeteor.MeteorResources(["the", "a"], groups, para)
    jres = jmeteor.MeteorResources(["the", "a"], groups, para)
    assert tres.serialize() == jres.serialize()
    gts = {0: ["a person riding a canine", "the man on top of a dog"],
           1: ["a dog in the park"]}
    res = {0: ["a man riding a dog"], 1: ["the canine in a park"]}
    want = [jmeteor.sentence_meteor(res[i][0], gts[i], jres) for i in (0, 1)]
    _, per_t = native.meteor(gts, res, tres)
    _, per_j = jbind.meteor(gts, res, jres)
    np.testing.assert_allclose(per_t, want, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(per_t, per_j)
    native.meteor(gts, res)  # back to the built-in resources


@pytest.mark.parametrize("member", ["npy", "npz_deflated", "npz_stored"])
def test_readers_agree(native, tmp_path, member):
    rng = np.random.RandomState(0)
    fc = rng.randn(2048).astype(np.float32)
    att = rng.randn(5, 7, 2048).astype(np.float32)
    if member == "npy":
        np.save(tmp_path / "101.npy", fc)
        path, want = str(tmp_path / "101.npy"), fc
        got, other = native.read_npy(path), jbind.read_npy(path)
    else:
        save = np.savez_compressed if member == "npz_deflated" else np.savez
        save(tmp_path / "101.npz", feat=att)
        path, want = str(tmp_path / "101.npz"), att
        got, other = native.read_npz_feat(path), jbind.read_npz_feat(path)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(other, want)


@pytest.mark.parametrize("tier", ["python", "native"])
def test_dir_feature_source_reads_as_np_load(native, tmp_path, monkeypatch,
                                             tier):
    if tier == "python":
        monkeypatch.setattr(tbind, "available", lambda: False)
    rng = np.random.RandomState(1)
    fc = rng.randn(64).astype(np.float32)
    att = rng.randn(3, 16).astype(np.float32)
    np.save(tmp_path / "7.npy", fc)
    np.savez_compressed(tmp_path / "7.npz", feat=att)
    src_fc = DirFeatureSource(str(tmp_path), ".npy")
    src_att = DirFeatureSource(str(tmp_path), ".npz")
    assert (src_fc._native is None) == (tier == "python")
    np.testing.assert_array_equal(src_fc.get("7"),
                                  np.load(tmp_path / "7.npy"))
    np.testing.assert_array_equal(src_att.get("7"),
                                  np.load(tmp_path / "7.npz")["feat"])


@pytest.mark.parametrize("i", range(len(SPICE_CASES)))
def test_spice_cpp_tier_agrees(native, i):
    hyp, refs = SPICE_CASES[i]
    want = jspice.sentence_spice(hyp, refs)
    assert tspice.sentence_spice(hyp, refs) == want
    for got in (native.spice_sentence(hyp, refs),
                jbind.spice_sentence(hyp, refs)):
        for cat in CATS:
            for k in ("p", "r", "f"):
                assert abs(got[cat][k] - want[cat][k]) < 1e-12, (hyp, cat, k)


def test_library_builds_under_build_native(native):
    """The library lands in build/native/ of the checkout under a name keyed
    on its sources, never beside the sources."""
    import subprocess
    version = subprocess.run(["g++", "--version"], capture_output=True,
                             text=True, check=True).stdout
    so = tbind.library_path(version)
    assert so.parent == tbind.BUILD_DIR
    assert tbind.BUILD_DIR == \
        Path(REPO).resolve() / "build" / "native"
    assert so.is_file()
    here = os.path.dirname(tbind.__file__)
    assert not [f for f in os.listdir(here) if f.endswith(".so")]
    assert sorted(p.name for p in tbind.SOURCES) == \
        ["cic_io.cpp", "cic_native.cpp", "cic_spice.cpp"]
    # the sources are the JAX package's, as they are
    for p in tbind.SOURCES:
        with open(os.path.join(REPO, "cooperativeimagecaptioning_tpu",
                               "native", p.name), "rb") as f:
            assert p.read_bytes() == f.read(), p.name


def test_failed_build_keeps_the_compilers_output(native, tmp_path,
                                                 monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(tbind, "SOURCES", [bad])
    monkeypatch.setattr(tbind, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(tbind, "_log", [""])
    assert tbind.build() is None
    assert "broken.cpp" in tbind.build_log()
    assert not list((tmp_path / "out").glob("*.so"))
