"""Self-critical CIDEr-D rewards on the host (counterpart of the JAX
package's rewards/self_critical.py; ref misc/rewards.py).

Sampled and greedy id sequences become the reference's strings
(`array_to_str`, misc/rewards.py:26-32) and are scored with CIDEr-D
(rewards/cider_d.py) against each image's ground-truth set; the reward of a
row is cider(sample) - cider(greedy)."""

from __future__ import annotations

import numpy as np

from cooperativeimagecaptioning_tpu_torch.rewards.cider_d import CiderD

_scorer = None


def init_scorer(cached_tokens: str = "corpus", df_path: str | None = None):
    """Create the process-wide CIDEr-D scorer once (ref
    misc/rewards.py:22-24)."""
    global _scorer
    if _scorer is None:
        _scorer = CiderD(df=cached_tokens, df_path=df_path)
    return _scorer


def reset_scorer():
    global _scorer
    _scorer = None


def array_to_str(arr) -> str:
    """Ids -> space-joined string, up to and including the first 0 (ref
    misc/rewards.py:26-32)."""
    out = []
    for x in arr:
        out.append(str(int(x)))
        if int(x) == 0:
            break
    return " ".join(out)


def get_self_critical_reward(gts_list, gen_result, greedy_res,
                             return_gen_scores: bool = False):
    """ref misc/rewards.py:34-72.

    gts_list: one array of reference id sequences per image; gen_result and
    greedy_res: [B, L] integer arrays, B = images * seq_per_img.  Returns
    (scores, cider_greedy), or (cider_gen, scores, cider_greedy)."""
    assert _scorer is not None, "call init_scorer() first"
    gen_result = np.asarray(gen_result)
    greedy_res = np.asarray(greedy_res)
    batch_size = gen_result.shape[0]
    seq_per_img = batch_size // len(gts_list)

    res = [array_to_str(r) for r in gen_result] + \
        [array_to_str(r) for r in greedy_res]
    gts_strs = [[array_to_str(g) for g in gts] for gts in gts_list]
    res_ = [{"image_id": i, "caption": [res[i]]}
            for i in range(2 * batch_size)]
    gts = {i: gts_strs[i % batch_size // seq_per_img]
           for i in range(2 * batch_size)}
    _, cider_scores = _scorer.compute_score(gts, res_)

    cider_gen = cider_scores[:batch_size]
    cider_greedy = float(cider_scores[batch_size:].mean())
    scores = cider_scores[:batch_size] - cider_scores[batch_size:]
    if not return_gen_scores:
        return scores, cider_greedy
    return cider_gen, scores, cider_greedy
