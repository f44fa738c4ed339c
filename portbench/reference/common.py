"""Plain building blocks of the reference speakers, written from the
published model (vgilad/CooperativeImageCaptioning, models/AttModel.py and
models/FCModel.py) in plain PyTorch.  Nothing here imports the program
under test or JAX.

Conventions of the published code: token 0 is EOS and padding, 1..V are
words, V + 1 is the decode-time BOS; the embedding has V + 2 rows and the
logit layer V + 1 outputs.  A linear layer is {'w': [in, out], 'b': [out]}
applied as `x @ w + b`.
"""

from __future__ import annotations

import contextlib
import hashlib

import torch

# the named random streams of one training iteration, in the order the
# program seeds them (a frozen copy of its stream arithmetic: stream i of
# an iteration is seeded with step_seed * len(STREAMS) + i)
STREAMS = ("xe", "disc", "cider", "greedy", "listener")
STEP_SEED_MULT = 1_000_003


def mix(seed: int, tag: str) -> int:
    """A 63-bit generator seed from the run's seed and a tag."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(mix(seed, tag))
    return g


def step_seed(program_seed: int, iteration: int) -> int:
    """The seed of iteration `iteration`'s streams in a run seeded with
    `program_seed` (iterations count from 0)."""
    return (program_seed + 1) * STEP_SEED_MULT + iteration


def stream(seed: int, name: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed * len(STREAMS) + STREAMS.index(name))
    return g


def schedule(opts, epoch):
    """(learning rate, scheduled-sampling probability) of an epoch, as the
    published train.py steps them: each starts at its `*_start` epoch (-1:
    never) and moves once every `*_every` epochs after it."""
    lr = opts["learning_rate"]
    if epoch > opts["learning_rate_decay_start"] >= 0:
        frac = (epoch - opts["learning_rate_decay_start"]) // \
            opts["learning_rate_decay_every"]
        lr = lr * opts["learning_rate_decay_rate"] ** frac
    ss = 0.0
    if epoch > opts["scheduled_sampling_start"] >= 0:
        frac = (epoch - opts["scheduled_sampling_start"]) // \
            opts["scheduled_sampling_increase_every"]
        ss = min(opts["scheduled_sampling_increase_prob"] * frac,
                 opts["scheduled_sampling_max_prob"])
    return lr, ss


def gumbel(gen, shape, device):
    """Standard Gumbel noise: -log(-log(U)), U on [tiny, 1)."""
    u = torch.rand(tuple(shape), generator=gen, device=device)
    u = u.clamp_min_(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def keep_mask(gen, shape, rate, device):
    """Dropout's keep mask: U[0, 1) < 1 - rate."""
    return torch.rand(tuple(shape), generator=gen, device=device) < 1.0 - rate


def dropout(x, keep, rate):
    """Inverted dropout with a given keep mask."""
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def linear(p, x):
    return x @ p["w"] + p["b"]


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Float32 products in full float32 (tf32 False) or in TF32."""
    cuda, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda
        torch.backends.cudnn.allow_tf32 = cudnn


def fp8(x):
    """x rounded to float8 e4m3 under one per-tensor scale (its largest
    magnitude maps to 448), returned in float32: the arithmetic of an fp8
    product's inputs."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = amax / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def make_weights(leaves, seed, device, dtype=torch.float32):
    """{path: tensor} from [(path, shape, scale)]: U(-scale, scale) from one
    draw on `device` seeded by (seed, 'weights'), cut into the leaves in
    order; scale 0 gives zeros."""
    sizes = [int(torch.Size(shape).numel()) for _, shape, _ in leaves]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    flat.uniform_(-1.0, 1.0, generator=generator(seed, "weights", device))
    out, pos = {}, 0
    for (path, shape, scale), n in zip(leaves, sizes):
        out[path] = (flat[pos:pos + n].view(shape) * scale).to(dtype)
        pos += n
    return out


def nest(flat):
    """{'a.b.c': x} -> {'a': {'b': {'c': x}}}."""
    tree = {}
    for path, leaf in flat.items():
        node = tree
        *parents, last = path.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def maxout_cell(p, xt, h, c, att_res=None, q=None):
    """The maxout LSTM of both speakers (AttModel.py Att2in2Core,
    FCModel.py LSTMCore): sums = i2h(xt) + h2h(h); i, f, o = sigmoid of the
    first 3H; g = max of the two H-halves of the last 2H (plus a2c(att_res)
    in Att2in2); c' = f c + i g; h' = o tanh(c').  `q` rounds each
    product's inputs (the lower-precision control)."""
    q = q or (lambda x: x)
    H = h.shape[-1]
    sums = (q(xt) @ q(p["i2h"]["w"]) + p["i2h"]["b"]) + \
        (q(h) @ q(p["h2h"]["w"]) + p["h2h"]["b"])
    sig = torch.sigmoid(sums[:, :3 * H])
    i, f, o = sig[:, :H], sig[:, H:2 * H], sig[:, 2 * H:]
    it = sums[:, 3 * H:]
    if att_res is not None:
        it = it + (q(att_res) @ q(p["a2c"]["w"]) + p["a2c"]["b"])
    g = torch.maximum(it[:, :H], it[:, H:])
    c = f * c + i * g
    return o * torch.tanh(c), c


def adam(params, grads, state, lr, clip, b1, b2, eps, count):
    """One Adam step (element-wise clamp at +/- clip, bias-corrected
    moments, eps outside the square root), in place; `count` is the step's
    number (1 for the first)."""
    c = torch.tensor(float(count), dtype=torch.float32)
    bc1 = float(1 - torch.pow(torch.tensor(b1, dtype=torch.float32), c))
    bc2 = float(1 - torch.pow(torch.tensor(b2, dtype=torch.float32), c))
    with torch.no_grad():
        for k, p in params.items():
            g = torch.clamp(grads[k], -clip, clip)
            mu, nu = state.setdefault(k, (torch.zeros_like(p),
                                          torch.zeros_like(p)))
            mu = (1 - b1) * g + b1 * mu
            nu = (1 - b2) * (g * g) + b2 * nu
            state[k] = (mu, nu)
            p.add_(-lr * ((mu / bc1) / (torch.sqrt(nu / bc2) + eps)))
