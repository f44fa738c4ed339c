"""Port parity: the device tiers of the CIDEr-D reward -- the hashed n-gram
CIDEr-D (`rewards/ngram_device.py`) and the differentiable soft CIDEr
(`rewards/cider_diff.py`) -- and their place in a training step, the PyTorch
port against the JAX package on the CPU in float32, at tiny width.

Tolerances: the port's device tier against JAX's rtol 1e-5 (both f32, the
same arithmetic; the sums over positions run in another order); against
the port's host tier (dict-based, float64) rtol 2e-4 / atol 2e-5, JAX's
own (tests/test_ngram_device.py:45); the hashes bit for bit; soft CIDEr and
its gradient against jax.grad rtol 1e-5; a training step with a device
tier against JAX's on JAX's replayed noise at LOSS_TOL and the gradient
rule of the listener tests (test_torch_listener_training.py).
"""

import json
import pickle

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from cooperativeimagecaptioning_tpu.preprocess import ngrams as jngrams  # noqa: E402
from cooperativeimagecaptioning_tpu.rewards import cider_diff as jcd  # noqa: E402
from cooperativeimagecaptioning_tpu.rewards import ngram_device as jnd  # noqa: E402
from cooperativeimagecaptioning_tpu.rewards import self_critical as jsc  # noqa: E402
from cooperativeimagecaptioning_tpu.training import joint as jjoint  # noqa: E402
from cooperativeimagecaptioning_tpu.training import loop as jloop  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.preprocess import ngrams as tngrams  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.rewards import cider_d as tcider  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.rewards import cider_diff as tcd  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.rewards import ngram_device as tnd  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.rewards import self_critical as tsc  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.training import joint as tjoint  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.training import loop as tloop  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.models import att_model as tatt  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.ops import decoding as tdec  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.utils.tree import (  # noqa: E402
    detached, leaves)
from test_torch_listener_training import (  # noqa: E402
    GRAD_REL, assert_step_close, assert_trainer_matches_jax, disc_opt,
    joint_params, port_params, replay_streams)
from test_torch_training import (  # noqa: E402
    GRAD_TOL, LOSS_TOL, jax_batch, numpy_batch, port_batch, tiny_dataset,
    tiny_opt)

RTOL = dict(rtol=1e-5, atol=1e-6)
# the aux terms of a step's total loss and their weights' options
TERM_WEIGHTS = {"loss_cap": "caption_loss_weight",
                "loss_vse": "vse_loss_weight",
                "retrieval_loss": "retrieval_reward_weight",
                "loss_cider": "cider_optimization"}
HOST_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True)
def _fresh_scorers():
    """Both packages keep one process-wide CIDEr-D scorer."""
    for m in (jsc, tsc):
        m.reset_scorer()
        m.init_scorer("corpus")
    yield
    for m in (jsc, tsc):
        m.reset_scorer()


def make_data(seed=0, n_img=6, spi=2, L=10, R=4, vocab=30):
    """gts (a list of [n_i, L] id arrays), sampled and greedy ids [B, L]
    with row 0 an exact copy of a ref (tests/test_ngram_device.py's
    case)."""
    rng = np.random.RandomState(seed)
    gts = []
    for _ in range(n_img):
        n = rng.randint(2, R + 1)
        g = np.zeros((n, L), np.int64)
        for r in range(n):
            k = rng.randint(2, L + 1)
            g[r, :k] = rng.randint(1, vocab, k)
        gts.append(g)
    B = n_img * spi

    def sample():
        s = np.zeros((B, L), np.int64)
        for i in range(B):
            k = rng.randint(1, L + 1)
            s[i, :k] = rng.randint(1, vocab, k)
        return s
    gen, greedy = sample(), sample()
    gen[0] = gts[0][0]
    return gts, gen, greedy, spi


CASES = [dict(seed=0, spi=2), dict(seed=3, n_img=4, spi=1, L=6, R=3,
                                   vocab=8),
         dict(seed=5, spi=3, vocab=12)]


def both_rewards(gts, gen, greedy, spi, max_refs=None, jtable=None,
                 ttable=None):
    refs, rmask = jnd.pad_gts(gts)
    want = jnd.ciderd_rewards_device(jnp.asarray(gen), jnp.asarray(greedy),
                                     refs, rmask, seq_per_img=spi,
                                     df_table=jtable)
    trefs, tmask = tnd.pad_gts(gts, max_refs=max_refs)
    got = tnd.ciderd_rewards_device(torch.from_numpy(gen),
                                    torch.from_numpy(greedy), trefs, tmask,
                                    seq_per_img=spi, df_table=ttable)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


# ---------------------------------------------------------------------------
# the hashed n-gram tier against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_gram_hashes_equal_jax_bit_for_bit(n):
    """int64 hashes masked to 32 bits equal JAX's uint32 ones, the validity
    too; ids near the top of a large vocabulary wrap mod 2^32."""
    rng = np.random.RandomState(n)
    seq = rng.randint(0, 60000, size=(5, 3, 9))
    seq[0, 0, 4:] = 0
    seq[1, 2, :] = 0
    jh, jv = jnd._gram_hashes(jnp.asarray(seq, jnp.int32), n)
    th, tv = tnd._gram_hashes(torch.from_numpy(seq), n)
    np.testing.assert_array_equal(np.asarray(jh).astype(np.int64),
                                  th.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    if n > 1:  # the upper half of uint32 is reached
        assert int(th.max()) >= 2 ** 31
    np.testing.assert_array_equal(
        np.asarray(jnd._eff_len(jnp.asarray(seq))),
        tnd._eff_len(torch.from_numpy(seq)).numpy())
    assert tnd.hash_ngram(seq[2, 1, :n]) == jnd.hash_ngram(seq[2, 1, :n]) \
        == int(th[2, 1, 0])


@pytest.mark.parametrize("case", range(len(CASES)))
def test_corpus_rewards_match_jax(case):
    want, got = both_rewards(*make_data(**CASES[case]))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, **RTOL)
    assert got[1][0] >= got[1].max() - 1e-6  # the exact copy scores best


@pytest.mark.parametrize("df_mode", ["corpus", "table"])
def test_padded_refs_leave_the_scores_unchanged(df_mode):
    """Refs padded past every image's count (as the Trainer pads them, to
    the dataset's largest count) leave the scores of both packages as on
    the batch's own padding: masked refs add nothing to the similarity,
    n_refs or the df.  Within rtol 1e-6: the sum over refs then runs over
    more (zero) terms, in another order."""
    gts, gen, greedy, spi = make_data(seed=7)
    jt = tt = None
    if df_mode == "table":
        df = {(1,): 3.0, (1, 2): 2.0, (5,): 7.0, (4, 0): 1.0}
        jt, tt = jnd.build_df_table(df, 9), tnd.build_df_table(df, 9)
    want, tight = both_rewards(gts, gen, greedy, spi, None, jt, tt)
    _, loose = both_rewards(gts, gen, greedy, spi, 9, jt, tt)
    jrefs, jmask = jnd.pad_gts(gts, max_refs=9)
    jloose = jnd.ciderd_rewards_device(jnp.asarray(gen), jnp.asarray(greedy),
                                       jrefs, jmask, seq_per_img=spi,
                                       df_table=jt)
    assert jrefs.shape[1] == 9 > max(len(g) for g in gts)
    for w, jl, a, b in zip(want, jloose, tight, loose):
        np.testing.assert_allclose(a, w, **RTOL)
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(np.asarray(jl), w, rtol=1e-6, atol=1e-7)


def test_df_table_matches_jax(tmp_path):
    """A reference-format pickle (decimal-string tokens): the same sorted
    keys and dfs as JAX's table, colliding and unseen grams included, and
    the same rewards."""
    rng = np.random.RandomState(17)
    df = {}
    for _ in range(60):
        toks = [str(t) for t in rng.randint(0, 20, rng.randint(3, 9))]
        for n in (1, 2, 3, 4, 5):
            for i in range(len(toks) - n + 1):
                g = tuple(toks[i:i + n])
                df[g] = df.get(g, 0.0) + 1.0
    path = tmp_path / "df.p"
    with open(path, "wb") as f:
        pickle.dump({"ref_len": 60, "document_frequency": df}, f)
    jt, tt = jnd.load_df_table(str(path)), tnd.load_df_table(str(path))
    for a, b in zip(jt.keys, tt.keys):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                      b.numpy())
    for a, b in zip(jt.dfs, tt.dfs):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert float(jt.ref_len_log) == float(tt.ref_len_log)
    q = torch.tensor([[0, int(tt.keys[0][3]), 12345]])
    got = tnd._df_lookup(tt.keys[0], tt.dfs[0], q)
    assert got[0, 0] == 0.0 and got[0, 1] == tt.dfs[0][3]
    want, got = both_rewards(*make_data(seed=13, vocab=20), None, jt, tt)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, **RTOL)


# ---------------------------------------------------------------------------
# the device tier against the port's host tier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", range(len(CASES)))
def test_device_tier_matches_the_ports_host_tier(case):
    gts, gen, greedy, spi = make_data(**CASES[case])
    scores, cider_greedy = tsc.get_self_critical_reward(gts, gen, greedy)
    refs, rmask = tnd.pad_gts(gts, max_refs=6)
    got, _, got_greedy = tnd.ciderd_rewards_device(
        torch.from_numpy(gen), torch.from_numpy(greedy), refs, rmask,
        seq_per_img=spi)
    np.testing.assert_allclose(got.numpy(), scores, **HOST_TOL)
    np.testing.assert_allclose(float(got_greedy), cider_greedy, rtol=2e-4)


def test_cached_df_matches_the_ports_host_scorer(tmp_path):
    """The DfTable tier against the host CiderD in cached-df mode on the
    same pickle."""
    rng = np.random.RandomState(17)
    df = {}
    for _ in range(200):
        grams = set()
        for _r in range(3):
            toks = [str(t) for t in rng.randint(1, 20, rng.randint(3, 10))]
            toks.append("0")
            for n in (1, 2, 3, 4):
                grams.update(tuple(toks[i:i + n])
                             for i in range(len(toks) - n + 1))
        for g in grams:
            df[g] = df.get(g, 0.0) + 1.0
    path = tmp_path / "synth-df.p"
    with open(path, "wb") as f:
        pickle.dump({"ref_len": 200, "document_frequency": df}, f)
    gts, gen, greedy, spi = make_data(seed=13, vocab=20)
    scorer = tcider.CiderD(df="synth-df", df_path=str(path))
    B = gen.shape[0]
    both = np.concatenate([gen, greedy])
    res = [{"image_id": i, "caption": [tsc.array_to_str(both[i])]}
           for i in range(2 * B)]
    gts_map = {i: [tsc.array_to_str(g) for g in gts[i % B // spi]]
               for i in range(2 * B)}
    _, want = scorer.compute_score(gts_map, res)
    refs, rmask = tnd.pad_gts(gts)
    _, got_gen, got_greedy = tnd.ciderd_rewards_device(
        torch.from_numpy(gen), torch.from_numpy(greedy), refs, rmask,
        seq_per_img=spi, df_table=tnd.load_df_table(str(path)))
    np.testing.assert_allclose(got_gen.numpy(), want[:B], **HOST_TOL)
    np.testing.assert_allclose(float(got_greedy), want[B:].mean(),
                               rtol=2e-4)


# ---------------------------------------------------------------------------
# soft CIDEr
# ---------------------------------------------------------------------------

def soft_case(seed, B=3, R=3, Lr=8, T=6, V=10, partial=False):
    rng = np.random.RandomState(seed)
    refs = np.zeros((B, R, Lr), np.int64)
    for b in range(B):
        for r in range(R):
            k = rng.randint(2, Lr - 1)
            refs[b, r, :k] = rng.randint(1, V, k)
    res = rng.rand(B, T, V + 1).astype(np.float32) + 0.05
    res /= res.sum(-1, keepdims=True)
    mask = np.ones((B, R), np.float32)
    if partial:
        mask[0, 2] = mask[2, 1:] = 0.0
    return refs, mask, res


@pytest.mark.parametrize("seed,partial", [(0, False), (1, True), (2, True)])
def test_soft_cider_and_its_gradient_match_jax(seed, partial):
    refs, mask, res = soft_case(seed, partial=partial)

    def jscore(r):
        return jcd.soft_cider_scores(r, jnp.asarray(refs), jnp.asarray(mask))
    want = np.asarray(jscore(jnp.asarray(res)))
    weights = np.random.RandomState(seed).randn(len(want)).astype(np.float32)
    jgrad = np.asarray(jax.grad(lambda r: jnp.sum(
        jscore(r) * jnp.asarray(weights)))(jnp.asarray(res)))
    x = torch.from_numpy(res).requires_grad_()
    got = tcd.soft_cider_scores(x, torch.from_numpy(refs),
                                torch.from_numpy(mask))
    (got * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **RTOL)
    np.testing.assert_allclose(x.grad.numpy(), jgrad, rtol=1e-5,
                               atol=1e-5 * np.abs(jgrad).max())
    assert np.abs(jgrad).max() > 0


def test_soft_cider_loss_matches_jax():
    refs, mask, res = soft_case(4, B=2, T=5, V=7)
    soft = np.concatenate([res, np.zeros(res.shape[:2] + (1,), np.float32)],
                          axis=-1)
    want = float(jcd.soft_cider_loss(jnp.asarray(soft), jnp.asarray(refs),
                                     jnp.asarray(mask)))
    got = tcd.soft_cider_loss(torch.from_numpy(soft), torch.from_numpy(refs),
                              torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), want, **RTOL)


# ---------------------------------------------------------------------------
# the df pickles
# ---------------------------------------------------------------------------

def write_dataset_json(tmp_path, seed=0):
    """A Karpathy-format dataset json and its ix_to_word dict json."""
    rng = np.random.RandomState(seed)
    words = [f"w{i}" for i in range(1, 15)]
    images = []
    for i in range(12):
        sents = [{"tokens": list(rng.choice(words + ["oov"],
                                            rng.randint(2, 7)))}
                 for _ in range(rng.randint(1, 5))]
        images.append({"split": ["train", "val", "test", "restval"][i % 4],
                       "sentences": sents})
    (tmp_path / "data.json").write_text(json.dumps({"images": images}))
    itow = {str(i + 1): w for i, w in enumerate(words)}
    itow[str(len(words) + 1)] = "UNK"
    (tmp_path / "dict.json").write_text(json.dumps({"ix_to_word": itow}))
    return str(tmp_path / "data.json"), str(tmp_path / "dict.json")


@pytest.mark.parametrize("split", ["train", "val", "all"])
def test_ngram_pickles_equal_jax(tmp_path, split):
    data, dct = write_dataset_json(tmp_path)
    n_j = jngrams.prepro_ngrams(data, dct, str(tmp_path / "j"), split)
    n_t = tngrams.prepro_ngrams(data, dct, str(tmp_path / "t"), split)
    assert n_j == n_t > 0
    for kind in ("words", "idxs"):
        with open(tmp_path / f"j-{kind}.p", "rb") as f:
            want = pickle.load(f)
        with open(tmp_path / f"t-{kind}.p", "rb") as f:
            got = pickle.load(f)
        assert got["ref_len"] == want["ref_len"]
        assert dict(got["document_frequency"]) == \
            dict(want["document_frequency"])
    # the idxs pickle loads as the device table and as the host scorer
    table = tnd.load_df_table(str(tmp_path / "t-idxs.p"))
    assert all(len(k) > 0 for k in table.keys)
    tcider.CiderD(df="t-idxs", df_path=str(tmp_path / "t-idxs.p"))


# ---------------------------------------------------------------------------
# a training step with a device tier
# ---------------------------------------------------------------------------

def test_flags_of_the_tiers_match_jax():
    opts = [tiny_opt(phase=2), tiny_opt(cider_optimization=1),
            tiny_opt(cider_optimization=1, on_device_cider=1),
            tiny_opt(cider_optimization=1, soft_cider=1)]
    for mode in ("gumbel", "gumbel_softmax", "reinforce"):
        for kw in ({}, {"soft_cider": 1}, {"on_device_cider": 1},
                   {"soft_cider": 1, "on_device_cider": 1}):
            opts.append(disc_opt(mode, **kw))
    for opt in opts:
        assert tjoint.needs_device_refs(opt) == jjoint.needs_device_refs(opt)
        for turn in ("speaker", "listener", "optimizer"):
            assert tjoint.needs_reward(opt, turn) == \
                jjoint.needs_reward(opt, turn)
            assert tjoint.uses_soft_cider(opt, turn) == \
                bool(jjoint.uses_soft_cider(opt, turn))


def with_refs(data, jb, tb, max_refs=None, tables=(None, None)):
    """JAX's batch with its batch-padded refs, the port's with refs padded
    to `max_refs` (the Trainer pads to the dataset's largest count)."""
    jb["refs"], jb["ref_mask"] = jnd.pad_gts(data["gts"])
    tb["refs"], tb["ref_mask"] = tnd.pad_gts(data["gts"], max_refs=max_refs)
    if tables[0] is not None:
        jb["df_table"], tb["df_table"] = tables
    return jb, tb


def device_step(opt, turn, seed, max_refs=None, tables=(None, None),
                refs=True, with_scale=False):
    """JAX's and the port's loss and gradients of one step on one batch,
    the port replaying JAX's noise; with_scale adds `reward_scales` of the
    port's step."""
    data = numpy_batch(opt, seed=seed)
    p = joint_params(opt, seed=seed)
    key = jax.random.PRNGKey(40 + seed)
    jb, tb = jax_batch(data), port_batch(data)
    if refs:
        jb, tb = with_refs(data, jb, tb, max_refs, tables)
    B = data["labels"].shape[0]
    reward = np.zeros((B,), np.float32)
    _, jvg = jjoint.make_raw_fns(opt, turn)
    jout = jvg(jax.tree.map(jnp.asarray, p), jb, key,
               jjoint.Hyper.from_opt(opt), jnp.asarray(reward))
    sampled = {}
    tout = tjoint.value_and_grad(opt, turn)(
        port_params(p), tb, replay_streams(key, opt, B, turn),
        tjoint.Hyper.from_opt(opt), None, sampled)
    if with_scale:
        return jout, tout, sampled, reward_scales(
            opt, turn, p, tb, replay_streams(key, opt, B, turn))
    return jout, tout, sampled


def assert_tier_step_matches_jax(opt, turn, seed=0):
    """One step of `opt` with its refs in the batch against JAX's (a device
    tier's step; or, where no tier scores it, the CIDEr term on a zero
    reward, as on both sides when the caller passes none)."""
    jout, tout, _, scales = device_step(opt, turn, seed, max_refs=7,
                                        with_scale=True)
    assert_device_step_close(opt, jout, tout, scales)
    return tout


def reward_scales(opt, turn, p, tb, streams):
    """(sum_i |r_i| |sum_t logp_it m_it| / sum(m), mean_i |r_i|) of the
    port's SCST step: the surrogate `self_critical_loss` and the mean
    reward taken over the magnitudes of their terms.  The rewards of a
    batch have both signs, so the two sums cancel; the packages' rewards
    and log-probs differ by f32 rounding, and LOSS_TOL's rtol holds the
    surrogate and avg_reward relative to these sizes, the standard bound
    of a sum whose terms cancel (as REINFORCE's surrogate is held in
    test_torch_listener_training.py)."""
    tp = detached(port_params(p))
    L = opt.seq_length
    kw = tjoint._sample_kwargs(opt, tjoint.Hyper.from_opt(opt), False)
    with torch.no_grad():
        spk, r, ctx = tjoint._speaker({"speaker": tatt.AttModel}, tp, opt,
                                      tb, streams, False, 0.0)
        if tjoint._cider_reuses_disc(opt, turn):
            out = tdec.sample(spk, ctx, L, r["disc"], mode=tjoint._MODE_MAP.get(
                opt.retrieval_reward, "sample"), temperature=1.0, **kw)
        else:
            out = tdec.sample(spk, ctx, L, r["cider"], mode="sample",
                              temperature=1.0, **kw)
        greedy = tdec.sample(spk, ctx, L, None, mode="greedy").seq
        scores, cider_gen, _ = tnd.ciderd_rewards_device(
            out.seq, greedy, tb["refs"], tb["ref_mask"],
            seq_per_img=opt.seq_per_img, df_table=tb.get("df_table"))
        reward = cider_gen if opt.use_gen_cider_scores else scores
        m = tjoint.losses.masks_from_seq(out.seq)[:, 1:]
        surrogate = float((reward.abs() * (out.logprobs * m).sum(1).abs())
                          .sum() / m.sum())
    return surrogate, float(scores.abs().mean())


def assert_device_step_close(opt, jout, tout, scales):
    """assert_step_close with loss_cider and avg_reward held relative to
    `reward_scales`, and the total relative to the sum of its weighted
    terms' sizes."""
    (jloss, jaux), jgrads = jout
    (loss, aux), grads = tout
    assert set(aux) == set(jaux)
    rtol = LOSS_TOL["rtol"]
    size = {"loss_cider": scales[0], "avg_reward": scales[1]}
    total = 0.0
    for k in jaux:
        want, got = float(jaux[k]), float(aux[k])
        s = size.get(k, abs(want))
        if k in TERM_WEIGHTS:
            total += abs(getattr(opt, TERM_WEIGHTS[k])) * s
        assert abs(got - want) <= rtol * s, (k, got, want, s)
    assert abs(float(loss) - float(jloss)) <= rtol * total
    assert_agent_grads_close(jgrads, grads, per_leaf=True)


def assert_agent_grads_close(jtree, ttree, per_leaf=False):
    """Every gradient leaf within GRAD_REL of the largest entry of its
    leaf (per_leaf) or of its agent, with GRAD_TOL's atol as the floor.
    Soft CIDEr is held by agent: through a straight-through row its log
    meets exact zeros (log(0 + 1e-20)), so the speaker's gradients reach
    ~1e12, and a leaf whose true gradient is zero (the attention's
    alpha_net.b) holds f32 rounding noise of that scale in both packages
    (~1e4, 1e-8 of the agent's largest entry)."""
    want = {".".join(str(k.key) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_leaves_with_path(jtree)}
    got = {k: v.detach().numpy() for k, v in leaves(ttree)}
    assert set(want) == set(got)
    agent_max = {}
    for k, w in want.items():
        a = k.split(".")[0]
        agent_max[a] = max(agent_max.get(a, 0.0), float(np.abs(w).max()))
    for k, w in want.items():
        top = np.abs(w).max() if per_leaf else agent_max[k.split(".")[0]]
        bound = max(GRAD_REL * top, GRAD_TOL["atol"])
        assert np.abs(w - got[k]).max() <= bound, k


def scst_opt(**kw):
    base = dict(cider_optimization=1, caption_loss_weight=0, phase=3,
                on_device_cider=1)
    base.update(kw)
    return tiny_opt(**base)


@pytest.mark.parametrize("kw", [
    dict(), dict(use_gen_cider_scores=1), dict(remat=1),
    dict(caption_loss_weight=1, seq_per_img=2, batch_size=2, max_att_len=6)])
def test_scst_step_with_the_device_reward_matches_jax(kw):
    """One SCST step with on_device_cider: the CIDEr sample on JAX's noise,
    the greedy baseline and the hashed reward inside the step; the port's
    refs padded past the batch's."""
    opt = scst_opt(**kw)
    jout, tout, sampled, scales = device_step(opt, "optimizer", seed=2,
                                              max_refs=7, with_scale=True)
    assert {"avg_reward", "cider_greedy", "loss_cider"} <= set(tout[0][1])
    assert_device_step_close(opt, jout, tout, scales)
    assert len(np.unique(sampled["seq"].numpy())) > 3


def test_scst_step_with_a_cached_df_matches_jax():
    opt = scst_opt()
    df = {(3,): 5.0, (3, 4): 2.0, (7,): 9.0, (0,): 20.0}
    jout, tout, _, scales = device_step(opt, "optimizer", seed=4, tables=(
        jnd.build_df_table(df, 40), tnd.build_df_table(df, 40)),
        with_scale=True)
    assert_device_step_close(opt, jout, tout, scales)


@pytest.mark.parametrize("mode", ["gumbel", "gumbel_softmax",
                                  "multinomial_soft"])
def test_joint_step_with_soft_cider_matches_jax(mode):
    """-o <mode> with soft_cider: the soft CIDEr of DISC's relaxed rows
    replaces the REINFORCE CIDEr term; both agents' gradients."""
    opt = disc_opt(mode, soft_cider=1)
    jout, tout, sampled = device_step(opt, "speaker", seed=1, max_refs=6)
    (jloss, jaux), jgrads = jout
    (loss, aux), grads = tout
    assert "avg_reward" not in aux and "seq" not in sampled
    assert set(aux) == set(jaux)
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    for k in aux:
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), **LOSS_TOL)
    assert_agent_grads_close(jgrads, grads)
    assert abs(float(aux["loss_cider"])) > 0


@pytest.mark.parametrize("kw", [dict(on_device_cider=1), dict(soft_cider=1)])
def test_a_batch_without_refs_takes_a_zero_reward_as_jax(kw):
    """The eval loss: no refs in the batch, so the CIDEr term takes the
    zero reward the JAX Evaluator passes."""
    opt = disc_opt("gumbel", **kw)
    jout, tout, _ = device_step(opt, "speaker", seed=0, refs=False)
    assert_step_close(jout, tout)


@pytest.mark.parametrize("tier", ["on_device_cider", "soft_cider"])
def test_trainer_steps_with_a_device_tier_match_jax(tier):
    """Two Trainer iterations against the JAX steps on the same batches:
    no host stage, the refs in the batch padded to the dataset's count."""
    opt = disc_opt("gumbel", **{tier: 1})
    tr, _, _, turns = assert_trainer_matches_jax(opt, 2)
    assert turns == ["speaker", "speaker"] and tr.last_reward_seqs is None
    assert tr._max_refs == 5


def test_trainer_loads_the_cached_df_once(tmp_path, monkeypatch):
    """--cached_tokens <name> with on_device_cider loads data/<name>.p as a
    DfTable, equal to JAX's Trainer's, and trains through it."""
    df = {("1",): 40.0, ("2",): 25.0, ("1", "2"): 10.0, ("3",): 5.0}
    (tmp_path / "data").mkdir()
    with open(tmp_path / "data" / "synthdf.p", "wb") as f:
        pickle.dump({"ref_len": 100, "document_frequency": df}, f)
    monkeypatch.chdir(tmp_path)
    opt = scst_opt(cached_tokens="synthdf",
                   checkpoint_path=str(tmp_path / "ck"))
    jtr = jloop.Trainer(opt.replace(), dataset=tiny_dataset(opt),
                        verbose=False)
    tr = tloop.Trainer(opt, dataset=tiny_dataset(opt), device="cpu",
                       verbose=False)
    for a, b in zip(jtr._df_table.keys, tr._df_table.keys):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                      b.numpy())
    for _ in range(2):
        loss_dict, _, _ = tr.train_iteration()
        assert np.isfinite(float(loss_dict["loss"]))
        assert {"avg_reward", "cider_greedy"} <= set(loss_dict)
    jtr.close()
