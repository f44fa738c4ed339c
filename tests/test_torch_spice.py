"""The port's SPICE-lite (metrics/spice.py and its C++ tier) against the
JAX package's on every case of tests/test_spice_golden.py and
tests/test_spice.py, with synonym matching off and on; and
`include_spice=True` through the port's CocoEvalCap and language_eval
against the JAX package's."""

import ast
import json
import os
import random
import shutil

import pytest

jax = pytest.importorskip("jax")

from cooperativeimagecaptioning_tpu.evaluation import coco_eval as jcoco  # noqa: E402
from cooperativeimagecaptioning_tpu.evaluation import language_eval as jlang  # noqa: E402
from cooperativeimagecaptioning_tpu.metrics import spice as jspice  # noqa: E402
from cooperativeimagecaptioning_tpu.native import bindings as jbind  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.evaluation import coco_eval as tcoco  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.evaluation import language_eval as tlang  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.metrics import spice as tspice  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.native import bindings as tbind  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CATS = ("All", "Object", "Attribute", "Relation")
SYNONYM_GROUPS = [["cat", "feline", "kitty"], ["bike", "bicycle"],
                  ["man", "person"]]  # test_spice_golden.py's fixture
GOLDEN_REFS = ["a giraffe standing on top of a green field",
               "the animal is a dog"]


def _golden_cases():
    """Every caption the two JAX test files parse or score, and every
    (hypothesis, references) pair they score, read from their source."""
    captions, pairs = set(), set()
    for name in ("test_spice_golden.py", "test_spice.py"):
        with open(os.path.join(HERE, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Constant) and \
                    isinstance(node.value.value, str):
                captions.add(node.value.value)  # a = "a young girl ..."
            if not isinstance(node, ast.Call):
                continue
            fn = getattr(node.func, "attr", getattr(node.func, "id", ""))
            try:
                args = [ast.literal_eval(a) for a in node.args]
            except ValueError:
                continue
            if fn in ("tuples", "parse_tuples") and args:
                captions.add(args[0])
            elif fn == "sentence_spice" and len(args) == 2:
                captions.add(args[0])
                captions.update(args[1])
                pairs.add((args[0], tuple(args[1])))
            elif fn == "parametrize" and len(args) == 2 and \
                    args[0] == "caption":
                captions.update(args[1])
            elif fn == "compute_spice" and len(args) == 2:
                for i in args[0]:
                    pairs.add((args[1][i][0], tuple(args[0][i])))
    pairs |= {(c, tuple(GOLDEN_REFS)) for c in captions}
    return sorted(captions), sorted(pairs)


CAPTIONS, PAIRS = _golden_cases()
FUZZ_VOCAB = [
    "a", "the", "two", "man", "woman", "dog", "cat", "photo", "table",
    "ball", "park", "street", "young", "old", "black", "white", "red",
    "and", "or", "'s", "that", "which", "who", "is", "are", "by", "in",
    "on", "of", "with", "next", "to", "top", "while", "there", "it",
    "parked", "thrown", "taken", "hung", "wearing", "standing", "holding",
    "running", "painted", "sitting", "walks", "has", "riding", "flying",
    "very", "slowly", "each", "other",
    "person", "feline", "kitty", "bike", "bicycle"]


@pytest.fixture(scope="module")
def native():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the C++ host tier cannot be built here")
    assert tbind.available(), tbind.build_log()
    return tbind


@pytest.fixture(params=["exact", "synonyms"])
def matching(request):
    """Both packages (and both C++ tiers) on exact matching, or on
    test_spice_golden.py's synset table; exact matching restored after."""
    groups = SYNONYM_GROUPS if request.param == "synonyms" else None
    for mod in (jspice, tspice):
        mod.configure_synonyms(groups)
    yield request.param
    for mod in (jspice, tspice):
        mod.configure_synonyms(None)


def assert_scores_equal(got, want, what):
    for cat in CATS:
        for k in ("p", "r", "f"):
            assert abs(got[cat][k] - want[cat][k]) < 1e-12, (what, cat, k)


def test_the_cases_were_found():
    assert len(CAPTIONS) >= 55 and len(PAIRS) > len(CAPTIONS)
    assert "a young girl standing on top of a tennis court" in CAPTIONS
    assert ("a cat on a mat", ("a feline on a mat",)) in PAIRS


@pytest.mark.parametrize("caption", CAPTIONS)
def test_parse_tuples_equal_the_jax_packages(caption):
    assert tspice.parse_tuples(caption) == jspice.parse_tuples(caption)


@pytest.mark.parametrize("pair", PAIRS)
def test_sentence_spice_equals_the_jax_packages(native, matching, pair):
    hyp, refs = pair[0], list(pair[1])
    want = jspice.sentence_spice(hyp, refs)
    assert tspice.sentence_spice(hyp, refs) == want
    assert_scores_equal(native.spice_sentence(hyp, refs), want,
                        (hyp, matching))


@pytest.mark.parametrize("trials,seed", [(400, 20260819), (200, 42)])
def test_fuzz_equals_the_jax_packages(native, matching, trials, seed):
    rng = random.Random(seed)
    for _ in range(trials):
        cap = " ".join(rng.choices(FUZZ_VOCAB, k=rng.randint(1, 14)))
        refs = [" ".join(rng.choices(FUZZ_VOCAB, k=rng.randint(1, 14)))
                for _ in range(2)]
        want = jspice.sentence_spice(cap, refs)
        assert tspice.sentence_spice(cap, refs) == want
        assert_scores_equal(native.spice_sentence(cap, refs), want,
                            (cap, refs))


def _corpus():
    gts = {i: [r for r in pair[1]] for i, pair in enumerate(PAIRS)}
    res = {i: [pair[0]] for i, pair in enumerate(PAIRS)}
    return gts, res


@pytest.mark.parametrize("tier", ["python", "native"])
def test_compute_spice_equals_the_jax_packages(native, matching, monkeypatch,
                                               tier):
    if tier == "python":
        monkeypatch.setattr(tbind, "available", lambda: False)
    monkeypatch.setattr(jbind, "available", lambda: False)
    gts, res = _corpus()
    mean_t, per_t = tspice.compute_spice(gts, res)
    mean_j, per_j = jspice.compute_spice(gts, res)
    assert abs(mean_t - mean_j) < 1e-12
    assert len(per_t) == len(per_j)
    for a, b in zip(per_t, per_j):
        assert_scores_equal(a, b, tier)


def test_synonyms_from_the_environment(native, tmp_path, monkeypatch):
    p = tmp_path / "syn.txt"
    p.write_text("dog canine\n")
    monkeypatch.setenv("CIC_SPICE_SYNONYMS", str(p))
    monkeypatch.setattr(tspice, "_SYNONYMS", None)
    try:
        assert tspice.sentence_spice("a dog", ["a canine"])["All"]["f"] == 1.0
        # the C++ tier was configured in lockstep
        assert native.spice_sentence("a dog", ["a canine"])["All"]["f"] == 1.0
    finally:
        tspice.configure_synonyms(None)
    monkeypatch.setenv("CIC_SPICE_SYNONYMS", str(tmp_path / "missing.txt"))
    monkeypatch.setattr(tspice, "_SYNONYMS", None)
    with pytest.raises(FileNotFoundError):
        tspice._synonyms()
    tspice.configure_synonyms(None)


def _annotations(mod, gts):
    anns = [{"image_id": i, "caption": c, "id": 10 * i + j}
            for i in gts for j, c in enumerate(gts[i])]
    return mod.CocoAnnotations(dataset={"annotations": anns,
                                        "images": [{"id": i} for i in gts]})


@pytest.mark.parametrize("tier", ["python", "native"])
def test_coco_eval_with_spice_equals_the_jax_packages(native, monkeypatch,
                                                      tier):
    """CocoEvalCap(include_spice=True): every corpus score and every image's
    scores, each package on the same tier (the C++ tiers, or both pure
    Python)."""
    if tier == "python":
        monkeypatch.setattr(tbind, "available", lambda: False)
        monkeypatch.setattr(jbind, "available", lambda: False)
    gts, res = _corpus()
    preds = [{"image_id": i, "caption": res[i][0]} for i in res]
    out = []
    for mod in (jcoco, tcoco):
        coco = _annotations(mod, gts)
        ev = mod.CocoEvalCap(coco, coco.load_res(preds), include_spice=True)
        out.append((ev.evaluate(), ev.img_to_eval))
    (want, want_img), (got, got_img) = out
    assert "SPICE" in got and set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-9, k
    assert set(got_img) == set(want_img)
    for i in want_img:
        for k, v in want_img[i].items():
            if k == "SPICE":
                assert_scores_equal(got_img[i][k], v, i)
            else:
                assert abs(got_img[i][k] - v) <= 1e-9, (i, k)


def test_language_eval_with_spice_equals_the_jax_packages(native, tmp_path):
    gts, res = _corpus()
    preds = [{"image_id": i, "caption": res[i][0]} for i in res]
    out = []
    for side, mod in (("jax", jlang), ("port", tlang)):
        ann = tmp_path / f"{side}_ann.json"
        with open(ann, "w") as f:
            json.dump({"annotations": [
                {"image_id": i, "caption": c, "id": 10 * i + j}
                for i in gts for j, c in enumerate(gts[i])],
                "images": [{"id": i} for i in gts]}, f)
        out.append(mod.language_eval(
            "coco", [dict(p) for p in preds], "sp", "val",
            ann_file=str(ann), out_dir=str(tmp_path / side),
            include_spice=True))
    want, got = out
    assert {"SPICE", "SPICE_Object", "SPICE_Attribute",
            "SPICE_Relation"} <= set(got)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-9, k
