"""The mesh's vocabulary split and data split, piece by piece, on the CPU
over gloo (ranks in tests/torch_mesh_ranks.py), against the single-device
port and the JAX package on the same inputs:

* the autograd all_gather over the data group (forward, the gradient
  summed over the group and sliced) and the gather of integer ids;
* `draws.ColShard` (a model rank's columns of the global noise; with
  `RowShard`, its block of it);
* over a model group of 2 at vocabulary 25 (V+1 = 26 logit columns
  split): the cross-slice arg-max (`head_merge` at m = 1, exact ties
  planted across the seam go to the lower id), the softmax and its
  gradient, the one-hot, the decoding constraint's penalty, the four
  relaxations (forward, ids, VJP) on JAX's noise;
* relaxed rows times an embedding table with either operand split
  (vocabulary 25: the rows; 24: the table's V+2 = 26 rows), the BOS row
  and column;
* the contrastive loss of a data group of 2 (both max_violation branches
  and the blended warm-up weight) against the whole batch's;
* soft CIDEr over split rows and a split vocabulary;
* `decoding.sample` in all seven modes, with and without the decoding
  constraint, on a vocab-split speaker: ids, log-probs and relaxed rows on
  JAX's noise, and the gradients of sum(logprobs) + <soft, w> at dropout
  0.5 against jax.grad; teacher forcing with scheduled sampling (its
  categorical draw over the slices) against the single-device port.

Worlds: (2, 1), (1, 2) and (2, 2), one each, every case in turn.
Tolerances (stated per check): values rtol 2e-5 (the mesh's loss
tolerance; the split sums change the summation order), relaxed rows atol
1e-6 and their VJPs 1e-5 (tests/test_torch_sampling.py's), gradients 1e-4
of the leaf's largest entry plus 1e-6 (the same file's), ids equal.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from cooperativeimagecaptioning_tpu.models import att_model as jatt  # noqa: E402
from cooperativeimagecaptioning_tpu.models import vse as jvse  # noqa: E402
from cooperativeimagecaptioning_tpu.ops import decoding as jdec  # noqa: E402
from cooperativeimagecaptioning_tpu.ops import relaxations as jrel  # noqa: E402
from cooperativeimagecaptioning_tpu.rewards import cider_diff as jcd  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.models import att_model as tatt  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.models import vse as tvse  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.ops import decoding as tdec  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.ops import draws  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.parallel import launch  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.rewards import cider_diff as tcd  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.utils.tree import to_torch  # noqa: E402
from test_torch_att_model import features  # noqa: E402
from test_torch_device_rewards import soft_case  # noqa: E402
from test_torch_sampling import (  # noqa: E402
    MODES, RELAXATIONS, SAMPLE_KW, jax_sample_noise, jax_select_noise,
    logprobs_np)
from test_torch_training import jax_params, tiny_opt  # noqa: E402

import torch_mesh_ranks as ranks  # noqa: E402

J = jax.random
RTOL = 2e-5
SOFT_TOL = dict(atol=1e-6, rtol=0)
VJP_TOL = dict(atol=1e-5, rtol=1e-5)
T_RELAX = 0.5
B = 6


# ---------------------------------------------------------------------------
# inputs, made whole in this process
# ---------------------------------------------------------------------------

def argmax_input():
    """[5, 26] rows with exact ties planted across the seam of two slices of
    13 columns (12 | 13), at both ends, and one random row."""
    x = np.random.RandomState(0).randn(5, 26).astype(np.float32)
    for row, ids in enumerate(((12, 13), (13, 25), (0, 25), (3, 20, 13))):
        x[row, list(ids)] = 9.0
    return x


def softmax_input():
    rng = np.random.RandomState(1)
    return {"x": (rng.randn(5, 26) * 2).astype(np.float32),
            "c": rng.randn(5, 26).astype(np.float32),
            "ids": np.array([0, 12, 13, 25, 7])}


def relax_inputs():
    out = {}
    for i, name in enumerate(sorted(RELAXATIONS)):
        lp = logprobs_np(B=B, C=26, seed=10 + i)
        key = J.PRNGKey(20 + i)
        noise = [np.asarray(a) for a in jax_select_noise(key, name, B, 26)]
        c = np.random.RandomState(30 + i).randn(B, 26).astype(np.float32)
        out[name] = (lp, noise, RELAXATIONS[name](T_RELAX), c, key)
    return out


def soft_embed_input(V):
    rng = np.random.RandomState(V)
    soft = rng.rand(3, 4, V + 2).astype(np.float32)
    soft[..., -1] = 0.0  # relaxed rows carry a zero BOS column
    return {"soft": soft, "table": rng.randn(V + 2, 5).astype(np.float32),
            "c": rng.randn(3, 4, 5).astype(np.float32)}


def contrastive_input():
    rng = np.random.RandomState(2)
    im, s = (rng.randn(4, 6).astype(np.float32) for _ in range(2))
    im /= np.linalg.norm(im, axis=1, keepdims=True)
    s /= np.linalg.norm(s, axis=1, keepdims=True)
    return {"im": im, "s": s,
            "weights": {"max": 1, "mean": 0, "blend": (0.3,)}}


def soft_cider_input(V=25):
    refs, mask, res = soft_case(3, B=4, T=6, V=V, partial=True)
    soft = np.concatenate([res, np.zeros(res.shape[:2] + (1,), np.float32)],
                          axis=-1)
    return {"soft": soft, "refs": refs, "mask": mask}


def gather_input():
    rng = np.random.RandomState(3)
    return {"x": rng.randn(4, 3).astype(np.float32),
            "c": rng.randn(2, 4, 3).astype(np.float32),
            "ids": rng.randint(0, 26, (4, 5)).astype(np.int32)}


def sample_case(V, mode, constraint=0, drop=0.0, grad=False, seed=0):
    """A speaker at vocabulary V, B=6 rows of features, and JAX's noise of
    `mode` (dropout masks at `drop`)."""
    opt = tiny_opt(vocab_size=V)
    p = jax_params(opt, seed=seed)["speaker"]
    p["logit"]["w"] = p["logit"]["w"] * 4.0  # ids that move between words
    att, masks = features(opt, B=B, seed=seed)
    key = J.PRNGKey(11 + seed)
    noise = jax_sample_noise(key, mode, B, V + 1, opt.seq_length,
                             D=opt.input_encoding_size, H=opt.rnn_size,
                             drop=drop)
    kw = dict(mode=mode, decoding_constraint=constraint, train=drop > 0,
              drop_prob=drop, **SAMPLE_KW)
    case = {"V": V, "params": p, "att": att, "masks": masks, "noise": noise,
            "L": opt.seq_length, "kw": kw, "key": key}
    if grad:
        case["grad_w"] = np.linspace(-1, 1, V + 2).astype(np.float32)
    return case


def tf_case(V, seed=0):
    """Teacher forcing at ss_prob 0.5 and dropout 0.5; its noise recorded
    from a generator on the single-device port (the JAX package draws its
    scheduled-sampling categorical along other keys)."""
    opt = tiny_opt(vocab_size=V)
    p = jax_params(opt, seed=seed)["speaker"]
    p["logit"]["w"] = p["logit"]["w"] * 4.0
    att, masks = features(opt, B=B, seed=seed)
    inputs = np.random.RandomState(seed).randint(1, V + 1, (B, 7))
    kw = dict(train=True, drop_prob=0.5, ss_prob=0.5)
    spk = tatt.AttModel(to_torch(p, "cpu"))
    rec = draws.Record(draws.Draws(torch.Generator().manual_seed(seed)))
    with torch.no_grad():
        ctx = spk.encode_features(None, torch.from_numpy(att),
                                  torch.from_numpy(masks))
        lp = tdec.teacher_forced_logprobs(spk, ctx, torch.from_numpy(inputs),
                                          rec, **kw)
    return {"V": V, "params": p, "att": att, "masks": masks, "tf": inputs,
            "noise": [x.numpy() for x in rec.taken], "kw": kw,
            "want": lp.numpy()}


def sample_specs(shape):
    """{case key: (builder, args)} of a world's sampling cases; a key is
    (V, mode, decoding_constraint, kind)."""
    specs = {}
    if shape[1] > 1:
        for mode in MODES:
            for constraint in (0, 1):
                specs[(25, mode, constraint, "ids")] = (
                    sample_case, (25, mode, constraint))
        for mode in ("gumbel_soft", "multinomial_soft", "gumbel_st"):
            specs[(24, mode, 0, "ids")] = (sample_case, (24, mode))
        for V, modes in ((25, MODES[2:]), (24, ("gumbel_soft",
                                                "multinomial_st"))):
            for mode in modes:
                specs[(V, mode, 0, "grad")] = (sample_case, (
                    V, mode, 0, 0.5, True, 4))
        specs[(25, "tf", 0, "tf")] = (tf_case, (25,))
    if shape[0] > 1:
        for mode in ("sample", "gumbel_soft"):
            specs[(25, mode, 1, "ids")] = (sample_case, (25, mode, 1, 0.5,
                                                         False, 2))
        specs[(25, "multinomial_soft", 0, "grad")] = (sample_case, (
            25, "multinomial_soft", 0, 0.5, True, 4))
    return specs


def sample_cases(shape):
    return {k: fn(*args) for k, (fn, args) in sample_specs(shape).items()}


def jobs(shape):
    if shape == (2, 1):
        return {"rows": (25, {"gather": gather_input(),
                              "contrastive": contrastive_input(),
                              "soft_cider": soft_cider_input()})}
    if shape == (1, 2):
        return {25: (25, {"argmax": argmax_input(),
                          "softmax": softmax_input(),
                          "relax": {k: v[:4]
                                    for k, v in relax_inputs().items()},
                          "soft_embed": soft_embed_input(25),
                          "soft_cider": soft_cider_input()}),
                24: (24, {"soft_embed": soft_embed_input(24),
                          "soft_cider": soft_cider_input(24)})}
    return {"both": (25, {"soft_cider": soft_cider_input(),
                          "contrastive": contrastive_input()})}


SHAPES = [(2, 1), (1, 2), (2, 2)]


@pytest.fixture(scope="module")
def worlds():
    """Every shape's world: its ranks' results, and the cases (whole)."""
    out = {}
    for shape in SHAPES:
        cases = sample_cases(shape)
        send = {k: {kk: vv for kk, vv in c.items()
                    if kk not in ("key", "want")}
                for k, c in cases.items()}
        got = launch.spawn(ranks.vocab_world_rank, (shape, jobs(shape), send),
                           shape[0] * shape[1], "cpu")
        out[shape] = (got, cases)
    return out


def units(worlds, shape, job, unit):
    got, _ = worlds[shape]
    return [r[0][job][unit] for r in got]


# ---------------------------------------------------------------------------
# draws
# ---------------------------------------------------------------------------

def test_col_shard_keeps_a_ranks_columns_of_the_global_draw():
    """ColShard asks its source for the whole width and keeps its columns;
    over RowShard a rank gets its block; a row draw passes through
    RowShard alone, as the sampler asks for it."""
    whole = torch.Generator().manual_seed(0)
    full = draws.Draws(whole).uniform((6, 26), "cpu")
    for j in range(2):
        src = draws.ColShard(draws.Draws(torch.Generator().manual_seed(0)),
                             2, j)
        got = src.uniform((6, 13), "cpu")
        assert torch.equal(got, full[:, 13 * j:13 * (j + 1)])
    g = draws.Draws(torch.Generator().manual_seed(1)).gumbel((6, 26), "cpu")
    for i in range(2):
        for j in range(2):
            src = draws.ColShard(draws.RowShard(
                draws.Draws(torch.Generator().manual_seed(1)), 2, i), 2, j)
            got = src.gumbel((3, 13), "cpu")
            assert torch.equal(got, g[3 * i:3 * (i + 1), 13 * j:13 * (j + 1)])
    replay = draws.ColShard(draws.Replay([np.arange(12.0).reshape(3, 4)]),
                            2, 1)
    np.testing.assert_array_equal(replay.uniform((3, 2), "cpu").numpy(),
                                  np.arange(12.0).reshape(3, 4)[:, 2:])


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def test_autograd_all_gather_and_the_id_gather(worlds):
    """Forward: the group's rows in rank order; backward: this rank's rows
    of the gradient summed over the group (each rank's loss reads every
    row); integer ids keep their dtype."""
    u = gather_input()
    for y, grad, ids, dtype in units(worlds, (2, 1), "rows", "gather"):
        np.testing.assert_array_equal(y, u["x"])
        np.testing.assert_allclose(grad, u["c"].sum(0), rtol=1e-6)
        np.testing.assert_array_equal(ids, u["ids"])
        assert dtype == "torch.int32"


# ---------------------------------------------------------------------------
# the vocabulary split
# ---------------------------------------------------------------------------

def test_cross_slice_argmax_takes_the_lower_id_across_the_seam(worlds):
    x = argmax_input()
    want = np.asarray(jnp.argmax(jnp.asarray(x), axis=-1))
    np.testing.assert_array_equal(want, torch.argmax(
        torch.from_numpy(x), dim=-1).numpy())
    assert list(want[:4]) == [12, 13, 0, 3]
    for got in units(worlds, (1, 2), 25, "argmax"):
        np.testing.assert_array_equal(got, want)


def test_softmax_one_hot_and_penalty_over_slices(worlds):
    u = softmax_input()
    x = torch.from_numpy(u["x"]).requires_grad_()
    y = torch.softmax(x, dim=-1)
    (y * torch.from_numpy(u["c"])).sum().backward()
    jy = np.asarray(jax.nn.softmax(jnp.asarray(u["x"]), axis=-1))
    ids = torch.from_numpy(u["ids"])
    for got_y, got_g, got_oh, got_pen in units(worlds, (1, 2), 25,
                                               "softmax"):
        np.testing.assert_allclose(got_y, jy, rtol=RTOL, atol=1e-7)
        np.testing.assert_allclose(got_y, y.detach().numpy(), rtol=RTOL,
                                   atol=1e-7)
        np.testing.assert_allclose(got_g, x.grad.numpy(), rtol=RTOL,
                                   atol=1e-6)
        np.testing.assert_array_equal(
            got_oh, torch.nn.functional.one_hot(ids, 26).float().numpy())
        pen = x.detach().clone()
        pen[torch.arange(5), ids] += -1e38
        np.testing.assert_array_equal(got_pen, pen.numpy())


@pytest.mark.parametrize("name", sorted(RELAXATIONS))
def test_relaxation_over_slices_matches_jax(worlds, name):
    """Forward, ids and the VJP of <y, c> on the rank's columns of JAX's
    noise (the row mask whole) against the JAX relaxation."""
    lp, _, args, c, key = relax_inputs()[name]
    jfn = getattr(jrel, name)
    want, vjp = jax.vjp(lambda x: jfn(key, x, *args)[0], jnp.asarray(lp))
    want_ind = jfn(key, jnp.asarray(lp), *args)[1]
    (jgrad,) = vjp(jnp.asarray(c))
    for y, ind, grad, done in (r[name] for r in units(worlds, (1, 2), 25,
                                                     "relax")):
        assert done
        np.testing.assert_array_equal(ind, np.asarray(want_ind))
        np.testing.assert_allclose(y, np.asarray(want), **SOFT_TOL)
        np.testing.assert_allclose(grad, np.asarray(jgrad), **VJP_TOL)


@pytest.mark.parametrize("V", [25, 24])
def test_soft_embed_with_either_operand_split(worlds, V):
    """V=25: the rows' logit columns split (the BOS column on the last
    rank), the table whole; V=24: the table's rows split.  The product,
    both gradients (the whole operand's summed over the group), the BOS
    row and the dropped BOS column against the whole computation."""
    u = soft_embed_input(V)
    soft = torch.from_numpy(u["soft"]).requires_grad_()
    table = torch.from_numpy(u["table"]).requires_grad_()
    y = soft @ table
    (y * torch.from_numpy(u["c"])).sum().backward()
    bos = np.zeros((1, V + 2), np.float32)
    bos[0, V + 1] = 1.0
    for got in units(worlds, (1, 2), V, "soft_embed"):
        np.testing.assert_allclose(got["y"], y.detach().numpy(), rtol=RTOL,
                                   atol=1e-6)
        np.testing.assert_allclose(got["soft_grad"], soft.grad.numpy(),
                                   rtol=RTOL, atol=1e-6)
        np.testing.assert_allclose(got["table_grad"], table.grad.numpy(),
                                   rtol=RTOL, atol=1e-6)
        np.testing.assert_array_equal(got["bos_row"], bos)
        np.testing.assert_array_equal(got["dropped"], u["soft"][..., :-1])


# ---------------------------------------------------------------------------
# the data split: contrastive matrix and soft CIDEr
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
@pytest.mark.parametrize("branch", ["max", "mean", "blend"])
def test_contrastive_loss_split_against_whole(worlds, shape, branch):
    """The data group's shares of the contrastive matrix: the loss summed
    over the group, the per-pair costs and both embeddings' gradients
    against JAX's whole-batch loss and jax.grad, and the port's."""
    u = contrastive_input()
    mv = u["weights"][branch]
    jw = mv if isinstance(mv, int) else jnp.float32(mv[0])
    tw = mv if isinstance(mv, int) else torch.tensor(mv[0])
    im, s = jnp.asarray(u["im"]), jnp.asarray(u["s"])
    jloss, (jgi, jgs) = jax.value_and_grad(
        lambda a, b: jvse.contrastive_loss(a, b, 0.2, jw), (0, 1))(im, s)
    jper = jvse.contrastive_loss(im, s, 0.2, jw, whole_batch=True)
    tper = tvse.contrastive_loss(torch.from_numpy(u["im"]),
                                 torch.from_numpy(u["s"]), 0.2, tw, True)
    job = "rows" if shape == (2, 1) else "both"
    for loss, per, gi, gs in (r[branch] for r in units(worlds, shape, job,
                                                       "contrastive")):
        np.testing.assert_allclose(loss, float(jloss), rtol=RTOL)
        np.testing.assert_allclose(per, np.asarray(jper), rtol=RTOL,
                                   atol=1e-7)
        np.testing.assert_allclose(per, tper.numpy(), rtol=RTOL, atol=1e-7)
        np.testing.assert_allclose(gi, np.asarray(jgi), rtol=RTOL,
                                   atol=1e-6)
        np.testing.assert_allclose(gs, np.asarray(jgs), rtol=RTOL,
                                   atol=1e-6)


@pytest.mark.parametrize("where", [((2, 1), "rows", 25), ((1, 2), 25, 25),
                                   ((1, 2), 24, 24), ((2, 2), "both", 25)])
def test_soft_cider_over_split_rows_and_vocabulary(worlds, where):
    """soft_cider_loss of the rank's rows (the df from the global batch's
    refs) and of its vocabulary share against JAX's whole-batch loss and
    jax.grad; the gradient within 1e-5 of its largest entry."""
    shape, job, V = where
    u = soft_cider_input(V)
    args = (jnp.asarray(u["refs"]), jnp.asarray(u["mask"]))
    jloss, jgrad = jax.value_and_grad(
        lambda x: jcd.soft_cider_loss(x, *args))(jnp.asarray(u["soft"]))
    tloss = tcd.soft_cider_loss(torch.from_numpy(u["soft"]),
                                torch.from_numpy(u["refs"]),
                                torch.from_numpy(u["mask"]))
    jgrad = np.asarray(jgrad)
    for loss, grad in units(worlds, shape, job, "soft_cider"):
        np.testing.assert_allclose(loss, float(jloss), rtol=RTOL)
        np.testing.assert_allclose(loss, tloss.item(), rtol=RTOL)
        np.testing.assert_allclose(grad, jgrad, rtol=0,
                                   atol=1e-5 * np.abs(jgrad).max())


# ---------------------------------------------------------------------------
# sampling on a vocab-split speaker
# ---------------------------------------------------------------------------

def jax_sample(case):
    p = jax.tree.map(jnp.asarray, case["params"])
    ctx = jatt.encode_features(p, None, jnp.asarray(case["att"]),
                               jnp.asarray(case["masks"]))
    return jdec.sample(jatt, p, ctx, case["L"], case["key"], **case["kw"])


def sample_keys(shape, kind):
    return [k for k in sample_specs(shape) if k[3] == kind]


@pytest.mark.parametrize("shape,key", [(s, k) for s in SHAPES
                                       for k in sample_keys(s, "ids")])
def test_sample_on_a_vocab_split_speaker_matches_jax(worlds, shape, key):
    """Every mode, with and without the decoding constraint: the ids equal
    JAX's, the log-probs within RTOL, the relaxed rows within SOFT_TOL, and
    every replayed draw taken."""
    got, cases = worlds[shape]
    case = cases[key]
    want = jax_sample(case)
    for r in got:
        out = r[1][key]
        assert out["used_all"]
        np.testing.assert_array_equal(out["seq"], np.asarray(want.seq))
        np.testing.assert_allclose(out["lp"], np.asarray(want.logprobs),
                                   rtol=RTOL, atol=1e-6)
        if want.soft is None:
            assert out["soft"] is None
        else:
            np.testing.assert_allclose(out["soft"], np.asarray(want.soft),
                                       **SOFT_TOL)
    if key[2]:
        seq = np.asarray(want.seq)
        live = (seq[:, 1:] > 0) & (seq[:, :-1] > 0)
        assert not np.any((seq[:, 1:] == seq[:, :-1]) & live)


@pytest.mark.parametrize("shape,key", [(s, k) for s in SHAPES
                                       for k in sample_keys(s, "grad")])
def test_sample_gradients_on_a_vocab_split_speaker_match_jax(worlds, shape,
                                                             key):
    """sum(logprobs) + <soft, w> at dropout 0.5 and every leaf's gradient
    (slices gathered, rows summed) against jax.grad of the JAX sample:
    the value within RTOL, each leaf within 1e-4 of its largest entry plus
    1e-6 (test_torch_sampling.py's rule)."""
    got, cases = worlds[shape]
    case = cases[key]
    w = jnp.asarray(case["grad_w"])

    def jloss(params):
        ctx = jatt.encode_features(params, None, jnp.asarray(case["att"]),
                                   jnp.asarray(case["masks"]))
        out = jdec.sample(jatt, params, ctx, case["L"], case["key"],
                          **case["kw"])
        loss = jnp.sum(out.logprobs)
        if out.soft is not None:
            loss = loss + jnp.sum(out.soft * w)
        return loss

    jval, jgrad = jax.value_and_grad(jloss)(
        jax.tree.map(jnp.asarray, case["params"]))
    want = {".".join(str(k.key) for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_leaves_with_path(jgrad)}
    for r in got:
        out = r[1][key]
        np.testing.assert_allclose(out["value"], float(jval), rtol=RTOL)
        grads = {k[len("speaker."):]: v for k, v in
                 ranks.leaves(out["grads"])}
        assert sorted(grads) == sorted(want)
        for k, g in want.items():
            np.testing.assert_allclose(grads[k], g, rtol=0, atol=1e-4 *
                                       np.abs(g).max() + 1e-6, err_msg=k)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_scheduled_sampling_over_slices_equals_the_single_device(worlds,
                                                                 shape):
    """Teacher forcing at ss_prob 0.5: each replaced input is the
    categorical draw over the model group's slices of the recorded global
    noise; the log-probs equal the single-device port's within RTOL."""
    got, cases = worlds[shape]
    key = (25, "tf", 0, "tf")
    case = cases[key]
    for r in got:
        out = r[1][key]
        assert out["used_all"]
        np.testing.assert_allclose(out["lp"], case["want"], rtol=RTOL,
                                   atol=1e-5)
