"""Fused additive attention for the Att2in2 step.

Counterpart of the JAX package's ops/pallas/att_step.py (b-major context).
`fused_attention` launches the hand-written kernel in csrc/att_step.cu for
CUDA tensors and takes `attention_reference` for CPU tensors.

    att_h  = h @ W_h2att + b                         [B, A]
    scores = tanh(p_att + att_h[:, None]) @ w_alpha + b_alpha   [B, K]
    w      = softmax(scores); masked: w * mask, renormalized (ref
             AttModel.py:480-483 -- not -inf masking; no mask, no
             renormalization)
    out    = sum_k w_k * att_emb_k                   [B, H]

Both versions compute in float32 and return h's dtype, as the Pallas kernel
did (f32 accumulation, bf16 or f32 in and out).

Under autograd the call goes through `Attention`, a torch.autograd.Function
standing in for the JAX custom_vjp (att_step.py:259-286): its forward is
the kernel (or the plain version on the CPU), its backward recomputes
`attention_reference` and differentiates that, as JAX `_bwd` does.  There
is no backward kernel, as there was none on the TPU.  `masks` gets no
gradient.
"""

from __future__ import annotations

import torch

from cooperativeimagecaptioning_tpu_torch.ops.kernels import _build, _dispatch

MAX_K = 64  # attention slots the kernel's softmax stage holds (kMaxK)


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


class Attention(torch.autograd.Function):
    """fused_attention with a gradient.  `forward_impl` computes the
    forward (the kernel, or the plain version); the backward always
    differentiates `attention_reference`."""

    @staticmethod
    def forward(ctx, forward_impl, h, att_emb, p_att, w_h2att, b_h2att,
                w_alpha, b_alpha, masks):
        ctx.save_for_backward(h, att_emb, p_att, w_h2att, b_h2att, w_alpha,
                              b_alpha, masks)
        return forward_impl(h, att_emb, p_att, w_h2att, b_h2att, w_alpha,
                            b_alpha, masks)

    @staticmethod
    def backward(ctx, g):
        *xs, masks = ctx.saved_tensors
        return (None, *_dispatch.reference_vjp(
            attention_reference, xs, (masks,), ctx.needs_input_grad[1:8],
            (g,)), None)


def fused_attention(h, att_emb, p_att, w_h2att, b_h2att, w_alpha, b_alpha,
                    masks):
    """h [B,H], att_emb [B,K,H], p_att [B,K,A], w_h2att [H,A], b_h2att [A],
    w_alpha [A,1], b_alpha [1], masks [B,K] float32 or None -> [B,H] in
    h's dtype."""
    impl = attention_kernel if _dispatch.use_kernel(h) else \
        attention_reference
    args = (h, att_emb, p_att, w_h2att, b_h2att, w_alpha, b_alpha)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return Attention.apply(impl, *args, masks)
    return impl(*args, masks)


def attention_kernel(h, att_emb, p_att, w_h2att, b_h2att, w_alpha, b_alpha,
                     masks):
    """Launch csrc/att_step.cu on CUDA tensors (no autograd)."""
    if h.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attention kernel takes float32 or bfloat16, "
                        f"got {h.dtype}")
    B, H = h.shape
    if att_emb.dim() != 3 or att_emb.shape[0] != B or att_emb.shape[2] != H:
        raise ValueError(f"att_emb {tuple(att_emb.shape)} does not match "
                         f"h {tuple(h.shape)}")
    K = att_emb.shape[1]
    A = w_h2att.shape[1]
    if not 1 <= K <= MAX_K:
        raise ValueError(f"attention kernel takes 1..{MAX_K} slots, got {K}")
    if tuple(p_att.shape) != (B, K, A) or tuple(w_h2att.shape) != (H, A) \
            or b_h2att.numel() != A or w_alpha.numel() != A \
            or b_alpha.numel() != 1:
        raise ValueError("attention kernel: parameter shapes do not match "
                         f"h {tuple(h.shape)}, att_emb "
                         f"{tuple(att_emb.shape)}, w_h2att "
                         f"{tuple(w_h2att.shape)}")
    _dispatch.check_cuda_inputs(
        "attention", {"h": h, "att_emb": att_emb, "p_att": p_att,
                      "w_h2att": w_h2att, "b_h2att": b_h2att,
                      "w_alpha": w_alpha, "b_alpha": b_alpha}, h.dtype)
    if masks is not None:
        if tuple(masks.shape) != (B, K):
            raise ValueError(f"masks {tuple(masks.shape)}, expected {(B, K)}")
        _dispatch.check_cuda_inputs("attention", {"masks": masks},
                                    torch.float32)
        if masks.device != h.device:
            raise ValueError("attention: masks on another device than h")
    out = torch.empty_like(h)
    lib = _build.library()
    code = lib.cic_attention(
        _build.ptr(h), _build.ptr(att_emb), _build.ptr(p_att),
        _build.ptr(w_h2att), _build.ptr(b_h2att), _build.ptr(w_alpha),
        _build.ptr(b_alpha), _build.ptr(masks), _build.ptr(out),
        B, K, H, A, int(h.dtype == torch.bfloat16), _build.stream(h.device))
    _build.check(lib, code, "attention")
    _dispatch.count("attention")
    return out
