"""Fused additive attention for the Att2in2 step, in three context layouts.

Counterpart of the JAX package's ops/pallas/att_step.py.  Each `fused_*`
wrapper launches its hand-written kernel of csrc/att_step.cu for CUDA
tensors and takes its plain version (`attention_reference*`) for CPU
tensors:

    fused_attention         b-major context  att_emb [B,K,H], p_att [B,K,A]
    fused_attention_q       int8 context from `quantize_features`
                            (per-(b,k) symmetric scales), dequantized inside
                            the kernel
    fused_attention_kmajor  K-major context  att_emb_t [K,B,H], p_att_t
                            [K,B,A]; masks stay [B,K]; decode only

    att_h  = h @ W_h2att + b                         [B, A]
    scores = tanh(p_att + att_h[:, None]) @ w_alpha + b_alpha   [B, K]
    w      = softmax(scores); masked: w * mask, renormalized (ref
             AttModel.py:480-483 -- not -inf masking; no mask, no
             renormalization)
    out    = sum_k w_k * att_emb_k                   [B, H]

All versions compute in float32 and return h's dtype, as the Pallas kernels
did (f32 accumulation, bf16 or f32 in and out).

Under autograd `fused_attention` and `fused_attention_q` go through
`Attention`, a torch.autograd.Function standing in for the JAX custom_vjps
(att_step.py:247-286): its forward is the kernel (or the plain version on
the CPU), its backward recomputes the call's plain version
(`attention_reference` or `attention_reference_q`) and differentiates
that, as JAX `_bwd` / `_bwd_q` do.  There is no backward kernel, as there
was none on the TPU.  `masks` gets no gradient, and of the quantized call
only h and the weights do.  `fused_attention_kmajor` has no gradient (JAX
att_step.py:383-387) and refuses inputs that require one.
"""

from __future__ import annotations

import torch

from cooperativeimagecaptioning_tpu_torch.ops.kernels import _build, _dispatch

MAX_K = 64  # attention slots the kernel's softmax stage holds (kMaxK)
Q_ALIGN = 16  # the int8 kernel loads 16 values (16 bytes) a lane


def attention_reference(h, att_emb, p_att, w_h2att, b_h2att, w_alpha, b_alpha,
                        masks):
    """Plain PyTorch version (the CPU path, the kernel's oracle and the
    backward's recompute).  Computes in float32, or in float64 for float64
    inputs (the gradient checks)."""
    f = torch.promote_types(h.dtype, torch.float32)
    att_h = h.to(f) @ w_h2att.to(f) + b_h2att.to(f)
    dot = torch.tanh(p_att.to(f) + att_h[:, None, :])
    scores = (dot @ w_alpha.to(f)).squeeze(-1) + b_alpha.to(f)
    w = torch.softmax(scores, dim=-1)
    if masks is not None:
        w = w * masks.to(f)
        w = w / w.sum(dim=1, keepdim=True)
    out = torch.einsum("bk,bkh->bh", w, att_emb.to(f))
    return out.to(h.dtype)


def _quantize(x):
    """One float32 temporary of x's shape: the division, the rounding and
    the clip run in place on it.  The 127 is a tensor on x's device: PyTorch
    divides a CUDA tensor by a Python number as a product with its rounded
    reciprocal, which moves some scales by an ulp and with them a few int8
    values; a tensor divisor is a true division, the same on every device."""
    q = x.to(torch.float32, copy=True)
    scale = torch.clamp(torch.linalg.vector_norm(q, float("inf"), dim=-1),
                        min=1e-12) / q.new_full((), 127.0)
    q.div_(scale[..., None]).round_().clamp_(-127, 127)
    return q.to(torch.int8), scale


def quantize_features(att_emb, p_att):
    """Per-(b,k) symmetric int8 quantization of the attention context (JAX
    att_step.py:56-68), run once per decode on the context's device.

    Returns (emb_q int8 [B,K,H], emb_scale f32 [B,K],
             p_q int8 [B,K,A], p_scale f32 [B,K]).  The relative error of an
    element is at most 1/254 of its row's largest magnitude."""
    eq, se = _quantize(att_emb)
    pq, sp = _quantize(p_att)
    return eq, se, pq, sp


def dequantize_features(emb_q, emb_scale, p_q, p_scale):
    emb = emb_q.float() * emb_scale[..., None]
    p_att = p_q.float() * p_scale[..., None]
    return emb, p_att


def attention_reference_q(h, emb_q, emb_scale, p_q, p_scale, w_h2att, b_h2att,
                          w_alpha, b_alpha, masks):
    """Plain version of the int8 kernel: dequantize, then the reference."""
    emb, p_att = dequantize_features(emb_q, emb_scale, p_q, p_scale)
    return attention_reference(h, emb, p_att, w_h2att, b_h2att, w_alpha,
                               b_alpha, masks)


def attention_reference_kmajor(h, att_emb_t, p_att_t, w_h2att, b_h2att,
                               w_alpha, b_alpha, masks):
    """Plain version on the transposed layout (masks stay [B, K])."""
    return attention_reference(h, att_emb_t.movedim(0, 1),
                               p_att_t.movedim(0, 1), w_h2att, b_h2att,
                               w_alpha, b_alpha, masks)


class Attention(torch.autograd.Function):
    """A fused attention call with a gradient.  `forward_impl` computes the
    forward (the kernel, or the plain version); the backward always
    differentiates `reference`, the call's plain version, with respect to
    its arguments before the masks, except those at the positions in
    `const` (the int8 context and its scales)."""

    @staticmethod
    def forward(ctx, forward_impl, reference, const, *args):
        ctx.save_for_backward(*args)
        ctx.reference, ctx.const = reference, const
        return forward_impl(*args)

    @staticmethod
    def backward(ctx, g):
        *xs, masks = ctx.saved_tensors
        needs = [n and i not in ctx.const
                 for i, n in enumerate(ctx.needs_input_grad[3:-1])]
        return (None, None, None, *_dispatch.reference_vjp(
            ctx.reference, xs, (masks,), needs, (g,)), None)


def fused_attention(h, att_emb, p_att, w_h2att, b_h2att, w_alpha, b_alpha,
                    masks):
    """h [B,H], att_emb [B,K,H], p_att [B,K,A], w_h2att [H,A], b_h2att [A],
    w_alpha [A,1], b_alpha [1], masks [B,K] float32 or None -> [B,H] in
    h's dtype."""
    impl = attention_kernel if _dispatch.use_kernel(h) else \
        attention_reference
    args = (h, att_emb, p_att, w_h2att, b_h2att, w_alpha, b_alpha)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return Attention.apply(impl, attention_reference, (), *args, masks)
    return impl(*args, masks)


def fused_attention_q(h, emb_q, emb_scale, p_q, p_scale, w_h2att, b_h2att,
                      w_alpha, b_alpha, masks):
    """Attention over an int8 context from `quantize_features`: h [B,H],
    emb_q int8 [B,K,H], emb_scale f32 [B,K], p_q int8 [B,K,A], p_scale f32
    [B,K], then the weights and masks as `fused_attention` -> [B,H] in h's
    dtype.  Gradients reach h and the weights only."""
    impl = attention_q_kernel if _dispatch.use_kernel(h) else \
        attention_reference_q
    live = (h, w_h2att, b_h2att, w_alpha, b_alpha)
    if torch.is_grad_enabled() and any(t.requires_grad for t in live):
        return Attention.apply(impl, attention_reference_q, (1, 2, 3, 4), h,
                               emb_q, emb_scale, p_q, p_scale, w_h2att,
                               b_h2att, w_alpha, b_alpha, masks)
    return impl(h, emb_q, emb_scale, p_q, p_scale, w_h2att, b_h2att, w_alpha,
                b_alpha, masks)


def fused_attention_kmajor(h, att_emb_t, p_att_t, w_h2att, b_h2att, w_alpha,
                           b_alpha, masks):
    """Attention over a K-major context: h [B,H], att_emb_t [K,B,H],
    p_att_t [K,B,A], masks [B,K] (b-major) or None -> [B,H].  Decode only:
    no gradient."""
    _dispatch.forward_only("fused_attention_kmajor", h, att_emb_t, p_att_t,
                           w_h2att, b_h2att, w_alpha, b_alpha)
    impl = attention_kmajor_kernel if _dispatch.use_kernel(h) else \
        attention_reference_kmajor
    return impl(h, att_emb_t, p_att_t, w_h2att, b_h2att, w_alpha, b_alpha,
                masks)


def _check_weights(name, h, K, w_h2att, b_h2att, w_alpha, b_alpha, masks):
    """Checks shared by the three kernels; returns (B, H, A)."""
    if h.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} kernel takes float32 or bfloat16, "
                        f"got {h.dtype}")
    B, H = h.shape
    A = w_h2att.shape[1]
    if not 1 <= K <= MAX_K:
        raise ValueError(f"{name} kernel takes 1..{MAX_K} slots, got {K}")
    if tuple(w_h2att.shape) != (H, A) or b_h2att.numel() != A \
            or w_alpha.numel() != A or b_alpha.numel() != 1:
        raise ValueError(f"{name} kernel: parameter shapes do not match "
                         f"h {tuple(h.shape)}, w_h2att "
                         f"{tuple(w_h2att.shape)}")
    _dispatch.check_cuda_inputs(
        name, {"h": h, "w_h2att": w_h2att, "b_h2att": b_h2att,
               "w_alpha": w_alpha, "b_alpha": b_alpha}, h.dtype)
    if masks is not None:
        if tuple(masks.shape) != (B, K):
            raise ValueError(f"masks {tuple(masks.shape)}, expected {(B, K)}")
        _dispatch.check_cuda_inputs(name, {"masks": masks}, torch.float32)
        if masks.device != h.device:
            raise ValueError(f"{name}: masks on another device than h")
    return B, H, A


def _launch_dense(name, entry, kmajor, h, emb, p_att, weights, masks):
    """Launch the b-major or the K-major kernel (no autograd)."""
    if emb.dim() != 3:
        raise ValueError(f"{name} kernel: context {tuple(emb.shape)} is not "
                         f"3-dimensional")
    K = emb.shape[0 if kmajor else 1]
    B, H, A = _check_weights(name, h, K, *weights, masks)
    want = [(K, B, n) if kmajor else (B, K, n) for n in (H, A)]
    if [tuple(emb.shape), tuple(p_att.shape)] != want:
        raise ValueError(f"{name} kernel: context {tuple(emb.shape)}, "
                         f"{tuple(p_att.shape)}, expected {want[0]}, "
                         f"{want[1]}")
    _dispatch.check_cuda_inputs(name, {"h": h, "att_emb": emb,
                                       "p_att": p_att}, h.dtype)
    out = torch.empty_like(h)
    lib = _build.library()
    code = getattr(lib, entry)(
        _build.ptr(h), _build.ptr(emb), _build.ptr(p_att),
        *(_build.ptr(w) for w in weights), _build.ptr(masks), _build.ptr(out),
        B, K, H, A, int(h.dtype == torch.bfloat16), _build.stream(h.device))
    _build.check(lib, code, name)
    _dispatch.count(name)
    return out


def attention_kernel(h, att_emb, p_att, w_h2att, b_h2att, w_alpha, b_alpha,
                     masks):
    """Launch the b-major kernel of csrc/att_step.cu on CUDA tensors (no
    autograd)."""
    return _launch_dense("attention", "cic_attention", False, h, att_emb,
                         p_att, (w_h2att, b_h2att, w_alpha, b_alpha), masks)


def attention_kmajor_kernel(h, att_emb_t, p_att_t, w_h2att, b_h2att, w_alpha,
                            b_alpha, masks):
    """Launch the K-major kernel of csrc/att_step.cu on CUDA tensors."""
    return _launch_dense("attention_kmajor", "cic_attention_kmajor", True, h,
                         att_emb_t, p_att_t,
                         (w_h2att, b_h2att, w_alpha, b_alpha), masks)


def attention_q_kernel(h, emb_q, emb_scale, p_q, p_scale, w_h2att, b_h2att,
                       w_alpha, b_alpha, masks):
    """Launch the int8 kernel of csrc/att_step.cu on CUDA tensors (no
    autograd)."""
    name = "attention_q"
    if emb_q.dim() != 3:
        raise ValueError(f"emb_q {tuple(emb_q.shape)} is not [B, K, H]")
    K = emb_q.shape[1]
    B, H, A = _check_weights(name, h, K, w_h2att, b_h2att, w_alpha, b_alpha,
                             masks)
    if tuple(emb_q.shape) != (B, K, H) or tuple(p_q.shape) != (B, K, A) \
            or tuple(emb_scale.shape) != (B, K) \
            or tuple(p_scale.shape) != (B, K):
        raise ValueError(f"{name} kernel: context {tuple(emb_q.shape)}, "
                         f"{tuple(p_q.shape)}, scales "
                         f"{tuple(emb_scale.shape)}, {tuple(p_scale.shape)} "
                         f"does not match h {tuple(h.shape)}, w_h2att "
                         f"{(H, A)}")
    _dispatch.check_cuda_inputs(name, {"emb_q": emb_q, "p_q": p_q},
                                torch.int8)
    _dispatch.check_cuda_inputs(name, {"emb_scale": emb_scale,
                                       "p_scale": p_scale}, torch.float32)
    if emb_q.device != h.device or emb_scale.device != h.device:
        raise ValueError(f"{name}: the context is on another device than h")
    # a lane loads 16 int8 values at once: rows must be 16-byte aligned
    if H % Q_ALIGN or A % Q_ALIGN or emb_q.data_ptr() % Q_ALIGN \
            or p_q.data_ptr() % Q_ALIGN:
        raise ValueError(f"{name} kernel: H={H} and A={A} must be multiples "
                         f"of {Q_ALIGN} and the int8 tensors {Q_ALIGN}-byte "
                         f"aligned")
    out = torch.empty_like(h)
    lib = _build.library()
    code = lib.cic_attention_q(
        _build.ptr(h), _build.ptr(emb_q), _build.ptr(emb_scale),
        _build.ptr(p_q), _build.ptr(p_scale), _build.ptr(w_h2att),
        _build.ptr(b_h2att), _build.ptr(w_alpha), _build.ptr(b_alpha),
        _build.ptr(masks), _build.ptr(out), B, K, H, A,
        int(h.dtype == torch.bfloat16), _build.stream(h.device))
    _build.check(lib, code, name)
    _dispatch.count(name)
    return out
