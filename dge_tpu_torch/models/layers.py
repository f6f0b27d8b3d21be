"""Shared diffusion-model building blocks (NCHW modules, diffusers names).

JAX counterpart: ``dge_tpu/models/layers.py``. Architecture follows Stable
Diffusion 1.5's UNet/VAE family; every parameter carries its diffusers
name (``down_blocks.0.attentions.1.transformer_blocks.0.attn1.to_q.weight``),
so a diffusers state dict loads with ``load_state_dict``.

Cross-view modes of ``BasicTransformerBlock.attn1`` (the reference's
attention surgery, threestudio/utils/dge_utils.py:272-356, :369-610):

- ``"plain"``: per-frame self-attention (below timestep 100)
- ``"extended"``: K/V concatenated across the frames of each CFG chunk
- ``"pivot_record"``: extended, and the block's normed hidden states and
  attention output are written into ``pivot[block.pivot_key]``
- ``"pivot_reuse"``: epipolar-constrained cosine-argmax gather of the
  recorded pivot attention outputs (its argmax the span
  ``attn.reuse_match``, utils/tracing.py)

The pivot record is an explicit dict that the caller passes to the pivot
pass (which fills it) and to the reuse passes (which read it); JAX keeps
the same record in a flax ``"pivot"`` variable collection. The counter
group ``pivot_record_bytes`` counts the bytes written to it, by token
count.

Computation dtype. Every module takes the ``dtype`` its JAX twin carries
(``float32`` or ``bfloat16``) and follows flax's rules: ``Linear``,
``Conv2d`` and ``Embedding`` cast their input and weight to it and return
it (``store_compute_dtype`` casts the f32 weights once, after they are
drawn or loaded: the same bits as flax's cast in every call);
``GroupNorm`` and ``LayerNorm`` take their statistics, the normalisation
and the affine step in f32 with f32 scale and bias and return ``dtype``;
the timestep sinusoids are f32; attention logits, softmax and the online
softmax's accumulators are f32, the probabilities cast to the values'
dtype; the reuse gather's cosine similarity accumulates in f32. At f32
every cast is the identity, and the networks give the bits they gave
before they took a dtype.

Attention. On the CPU, ``attend`` runs the JAX package's two forms as torch
ops: a dense softmax when ``Sq·Sk <= 2^24``, else an online softmax over key
blocks of ``k_chunk``. On a CUDA device it runs
``F.scaled_dot_product_attention`` with the backend that ``sdpa_backend``
names: ``FLASH_ATTENTION`` for bf16 (and f16) at head widths up to 256
(the UNet's 40, 80 and 160), ``EFFICIENT_ATTENTION`` for f32 and for wider
heads (the VAE's 512); both never build the logits (the ``MATH`` backend
would build ``[3, 8, Sk, Sk]`` f32 logits in the pivot pass: 6.4 GB at
8,192 tokens). Other shapes go to the chunked form. A refused launch
raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from dge_tpu_torch.ops import cuda_build
from dge_tpu_torch.utils import tracing

# beyond this many logits entries per head-batch the plain path switches to
# the online-softmax loop (layers.py:118-121)
CHUNKED_LOGITS_THRESHOLD = 1 << 24


@dataclasses.dataclass
class CrossViewState:
    """Per-batch cross-view attention inputs, computed once per UNet call."""

    # long [F, n_key]: indices of the 1-2 closest key (pivot) cameras
    closest_cam: Optional[torch.Tensor] = None
    # f32 [F]: blend weight of the closest cam, sigmoid(d2/(d1+d2))
    # (make_dge_block, dge_utils.py:557-566); 1.0 when n_key == 1
    blend_w1: Optional[torch.Tensor] = None
    # dense oracle: seq_len -> bool [F, n_key, S, S] violation masks, pivot
    # frame rows cleared
    epipolar: Optional[Dict[int, torch.Tensor]] = None
    # banded form: seq_len -> f32 [F, n_key, S, 3] normalised epipolar lines
    # per query token in the key image's pixel space (pivot rows zero)
    epi_lines: Optional[Dict[int, torch.Tensor]] = None
    # seq_len -> f32 [S, 3] homogeneous key-token pixel coords (raster order)
    epi_pts: Optional[Dict[int, torch.Tensor]] = None
    n_key: int = 1
    # violation threshold in pixels (compute_epipolar_constrains' 1 px)
    epi_threshold: float = 1.0


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` (flax ``Dense(dtype=...)``):
    input, weight and bias cast to it, the output in it."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``dtype`` (flax ``Conv(dtype=...)``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, padding=padding)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt),
                                  self.bias.to(dt))


class Embedding(nn.Embedding):
    """``nn.Embedding`` whose table is read in ``dtype`` (flax
    ``Embed(dtype=...)``)."""

    def __init__(self, num: int, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__(num, dim)
        self.compute_dtype = dtype

    def forward(self, ids):
        return F.embedding(ids, self.weight.to(self.compute_dtype))


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` as flax's ``GroupNorm(dtype=...)``: statistics,
    normalisation and affine in f32 with f32 scale and bias, the output
    cast to ``dtype``."""

    def __init__(self, groups: int, channels: int, eps: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__(groups, channels, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x):
        return super().forward(x.float()).to(self.compute_dtype)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` as flax's ``LayerNorm(dtype=...)`` (see
    ``GroupNorm``)."""

    def __init__(self, dim: int, eps: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x):
        return super().forward(x.float()).to(self.compute_dtype)


def store_compute_dtype(model: nn.Module) -> nn.Module:
    """Casts the weights of every ``Linear``, ``Conv2d`` and ``Embedding``
    in ``model`` to the dtype it computes in, once; norms keep f32 scale and
    bias, and other parameters (the CLIP position table) stay as they are,
    as flax keeps them. Returns ``model``."""
    for m in model.modules():
        if isinstance(m, (Linear, Conv2d, Embedding)):
            m.to(m.compute_dtype)
    return model


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0) -> torch.Tensor:
    """Sinusoidal timestep embedding (diffusers get_timestep_embedding with
    SD's flip_sin_to_cos=True, freq_shift=0)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device)
        / (half - downscale_freq_shift))
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, out_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.linear_1 = Linear(in_dim, out_dim, dtype=dtype)
        self.linear_2 = Linear(out_dim, out_dim, dtype=dtype)

    def forward(self, sample):
        return self.linear_2(F.silu(self.linear_1(sample)))


def attend_dense(qh, kh, vh):
    """[B, H, Sq, D] x [B, H, Sk, D] -> [B, H, Sq, D], dense softmax in f32
    (layers.py:135-142), the probabilities cast to the values' dtype."""
    scale = 1.0 / math.sqrt(qh.shape[-1])
    logits = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kh.float()) * scale
    return torch.einsum("bhqk,bhkd->bhqd",
                        torch.softmax(logits, dim=-1).to(vh.dtype), vh)


def attend_chunked(qh, kh, vh, k_chunk: int = 512):
    """Online-softmax attention over key blocks (the flash recurrence of the
    JAX ``_attend_chunked``, layers.py:147-192): peak memory one
    ``[B, H, Sq, k_chunk]`` logits block, exact softmax semantics; f32
    logits and accumulators, each block's probabilities cast to the values'
    dtype, the result in the queries' dtype."""
    b, h, sq, d = qh.shape
    sk = kh.shape[2]
    scale = 1.0 / math.sqrt(d)
    k_chunk = min(k_chunk, sk)
    m = torch.full((b, h, sq), -math.inf, dtype=torch.float32,
                   device=qh.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=qh.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=qh.device)
    qf = qh.float()
    for off in range(0, sk, k_chunk):
        logits = torch.einsum("bhqd,bhkd->bhqk", qf,
                              kh[:, :, off:off + k_chunk].float()) * scale
        m_new = torch.maximum(m, logits.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(vh.dtype).float(),
            vh[:, :, off:off + k_chunk].float())
        m = m_new
    return (acc / l[..., None]).to(qh.dtype)


def sdpa_backend(head_dim: int, dtype: torch.dtype) -> Optional[str]:
    """The ``SDPBackend`` that attention at this head width and dtype runs
    on a card, or None for the chunked form: ``FLASH_ATTENTION`` for bf16
    and f16 up to head width 256, ``EFFICIENT_ATTENTION`` (the f32 backend,
    and the wider heads') otherwise; the head width a multiple of 8 (their
    GEMM alignment). On the H100, EFFICIENT took every head width of the
    f32 edit path (40, 80, 160; the VAE's 512; PERF.md §6)."""
    if head_dim % 8:
        return None
    if dtype in (torch.float16, torch.bfloat16) and head_dim <= 256:
        return "FLASH_ATTENTION"
    if dtype in (torch.float32, torch.float16, torch.bfloat16):
        return "EFFICIENT_ATTENTION"
    return None


def attend_heads(qh, kh, vh, k_chunk: int = 512):
    """[B, H, Sq, D] attention on the device of ``qh``: SDPA pinned to
    ``sdpa_backend``'s choice on a CUDA device; the JAX package's dense or
    chunked form otherwise."""
    backend = sdpa_backend(qh.shape[-1], qh.dtype) if qh.is_cuda else None
    if backend is not None:
        from torch.nn.attention import SDPBackend, sdpa_kernel

        with sdpa_kernel(getattr(SDPBackend, backend)):
            return F.scaled_dot_product_attention(qh, kh, vh)
    if qh.shape[2] * kh.shape[2] > CHUNKED_LOGITS_THRESHOLD:
        return attend_chunked(qh, kh, vh, k_chunk)
    return attend_dense(qh, kh, vh)


def attend(q, k, v, heads: int, k_chunk: int = 512):
    """q [B, Sq, H*D], k/v [B, Sk, H*D] -> [B, Sq, H*D]."""

    def split(x):
        b, s, inner = x.shape
        return x.reshape(b, s, heads, inner // heads).transpose(1, 2)

    out = attend_heads(split(q), split(k), split(v), k_chunk)
    b, h, s, d = out.shape
    return out.transpose(1, 2).reshape(b, s, h * d)


class Attention(nn.Module):
    """Multi-head attention (diffusers Attention): to_q/to_k/to_v/to_out.0."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.to_q = Linear(query_dim, inner, bias=False, dtype=dtype)
        self.to_k = Linear(context_dim or query_dim, inner, bias=False,
                           dtype=dtype)
        self.to_v = Linear(context_dim or query_dim, inner, bias=False,
                           dtype=dtype)
        self.to_out = nn.ModuleList([Linear(inner, query_dim, dtype=dtype),
                                     nn.Identity()])

    def forward(self, x, context=None, extended_frames: int = 0):
        """``extended_frames > 0``: x is ``[n_chunks * F, S, D]`` and every
        frame of a CFG chunk attends to the K/V of all F frames of that
        chunk (register_extended_attention, dge_utils.py:282-356): full
        self-attention over the chunk's concatenated tokens."""
        c = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(c), self.to_v(c)
        if extended_frames:
            if context is not None and context.shape[1] != x.shape[1]:
                raise ValueError(
                    "extended_frames requires self-attention (context seq "
                    f"len {context.shape[1]} != query seq len {x.shape[1]})")
            f = extended_frames
            b, s, d = q.shape
            chunks = b // f
            out = attend(q.reshape(chunks, f * s, d),
                         k.reshape(chunks, f * s, d),
                         v.reshape(chunks, f * s, d), self.heads,
                         k_chunk=1024).reshape(b, s, -1)
        else:
            out = attend(q, k, v, self.heads)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = Linear(dim, inner * 2, dtype=dtype)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        # diffusers GEGLU uses the exact (erf) gelu
        return h * F.gelu(gate)


class GEGLUFeedForward(nn.Module):
    """diffusers FeedForward: net.0 = GEGLU, net.1 = dropout, net.2."""

    def __init__(self, dim: int, mult: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult, dtype),
                                  nn.Identity(),
                                  Linear(dim * mult, dim, dtype=dtype)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


def epi_blockwise_argmax(img, piv_img, lines, pts, threshold: float,
                         block: int = 512):
    """Epipolar-masked cosine argmax over pivot tokens, without any
    ``[S, S]`` array (layers.py:246-313).

    img [F, S, D] and piv_img [F, K, S, D] normalised tokens, lines
    [F, K, S, 3], pts [S, 3]. Violating pairs count as similarity 0 (not
    -inf); query rows whose every pivot token violates take the unmasked
    argmax. An exact tie goes to the first index. The similarity
    accumulates in f32 whatever the tokens' dtype (layers.py:286). Returns
    long [F, K, S].

    On a CUDA device one launch of ``csrc/reuse_match.cu``
    (``_epi_argmax_kernel``; ``launch_counts["reuse_match"]``), which raises
    on what it does not take; on the CPU the blockwise torch loop over key
    blocks of ``block`` (``_epi_argmax_torch``)."""
    if img.device.type == "cuda":
        return _epi_argmax_kernel(img, piv_img, lines, pts, threshold)
    return _epi_argmax_torch(img, piv_img, lines, pts, threshold, block)


def _epi_argmax_torch(img, piv_img, lines, pts, threshold: float,
                      block: int = 512):
    """``epi_blockwise_argmax`` as torch ops over key blocks of ``block``:
    ties keep the first index inside a block and the earlier block across
    blocks."""
    f, k, s, _ = piv_img.shape
    block = min(block, s)
    dev = img.device
    bm_val = torch.full((f, k, s), -math.inf, device=dev)
    bm_idx = torch.zeros((f, k, s), dtype=torch.long, device=dev)
    br_val = torch.full((f, k, s), -math.inf, device=dev)
    br_idx = torch.zeros((f, k, s), dtype=torch.long, device=dev)
    all_bad = torch.ones((f, k, s), dtype=torch.bool, device=dev)
    img = img.float()
    for off in range(0, s, block):
        sim = torch.einsum("fsd,fktd->fkst", img,
                           piv_img[:, :, off:off + block].float())
        dist = torch.einsum("fksc,tc->fkst", lines,
                            pts[off:off + block]).abs()
        viol = dist > threshold
        for vals, best_val, best_idx in (
                (torch.where(viol, 0.0, sim), bm_val, bm_idx),
                (sim, br_val, br_idx)):
            v = vals.amax(dim=-1)
            ix = vals.argmax(dim=-1) + off
            better = v > best_val
            best_val.copy_(torch.where(better, v, best_val))
            best_idx.copy_(torch.where(better, ix, best_idx))
        all_bad &= viol.all(dim=-1)
    return torch.where(all_bad, br_idx, bm_idx)


def bf16_terms(img, piv_img):
    """f32 tokens as bf16 operands of three times the width whose product
    is hi·hi' + hi·lo' + lo·hi' (hi = the bf16 rounding, lo = the bf16
    rounding of the rest): each product keeps ~16 bits where bf16 alone
    keeps 8; the missing lo·lo' term and the rests are 2^-16 of it."""

    def split(x):
        hi = x.to(torch.bfloat16)
        return hi, (x - hi.float()).to(torch.bfloat16)

    img_hi, img_lo = split(img)
    piv_hi, piv_lo = split(piv_img)
    return (torch.cat([img_hi, img_hi, img_lo], dim=-1),
            torch.cat([piv_hi, piv_lo, piv_hi], dim=-1))


def _epi_argmax_kernel(img, piv_img, lines, pts, threshold: float):
    """``epi_blockwise_argmax`` on the card: one launch of
    ``csrc/reuse_match.cu`` on the current stream, no host read. bf16
    tokens go to the tensor cores as they are; f32 tokens as
    ``bf16_terms``. Raises, before any launch, on tokens that require a
    gradient in grad mode, a width that is not a multiple of 16, another
    dtype, a non-contiguous or misshapen tensor, or another device."""
    f, k, s, d = piv_img.shape
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (img, piv_img, lines, pts)):
        raise ValueError("epi_blockwise_argmax: the kernel takes no "
                         "gradient; call it under torch.no_grad()")
    if d % 16:
        raise ValueError(f"epi_blockwise_argmax: token width {d} is not a "
                         "multiple of 16 (the kernel's bf16 product depth)")
    dt = img.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"epi_blockwise_argmax: tokens must be bfloat16 or "
                         f"float32, got {dt}")
    f32 = torch.float32
    if cuda_build.check_tensors("reuse_match", [
            ("img", img, dt, (f, s, d)), ("piv_img", piv_img, dt, (f, k, s, d)),
            ("lines", lines, f32, (f, k, s, 3)), ("pts", pts, f32, (s, 3))]):
        raise ValueError(f"epi_blockwise_argmax: the kernel runs on a CUDA "
                         f"device, not {img.device}")
    if dt == f32:
        img, piv_img = bf16_terms(img, piv_img)
    out = torch.empty((f, k, s), dtype=torch.long, device=img.device)
    cuda_build.launch("reuse_match", "reuse_match", img.device, img, piv_img,
                      lines, pts, f, k, s, img.shape[-1], float(threshold),
                      out)
    return out


def _unit(x):
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-6)


# bytes written to pivot records (normed states and attention output), by
# the block's token count
pivot_record_bytes = tracing.group("pivot_record_bytes")


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        # torch LayerNorm default eps 1e-5 (diffusers BasicTransformerBlock)
        self.norm1 = LayerNorm(dim, 1e-5, dtype)
        self.attn1 = Attention(dim, heads, dim_head, dtype=dtype)
        self.norm2 = LayerNorm(dim, 1e-5, dtype)
        self.attn2 = Attention(dim, heads, dim_head, context_dim=context_dim,
                               dtype=dtype)
        self.norm3 = LayerNorm(dim, 1e-5, dtype)
        self.ff = GEGLUFeedForward(dim, dtype=dtype)
        # the key of this block's entry in a pivot record; the UNet sets it
        # to the block's module path
        self.pivot_key = ""

    def forward(self, x, context, *, mode: str = "plain",
                cross_view: Optional[CrossViewState] = None,
                pivot: Optional[dict] = None):
        """x [B, S, D], with B = 3·F (CFG chunks text / image / uncond) in
        the cross-view modes; context [B, S_ctx, D_ctx]."""
        norm_h = self.norm1(x)
        if mode == "plain":
            attn_out = self.attn1(norm_h)
        elif mode in ("extended", "pivot_record"):
            attn_out = self.attn1(norm_h, extended_frames=x.shape[0] // 3)
            if mode == "pivot_record":
                # the pivotal pass stores normed hidden states and attention
                # output (make_dge_block, dge_utils.py:400-405, 526-533)
                pivot[self.pivot_key] = (norm_h, attn_out)
                s = x.shape[1]
                pivot_record_bytes[s] = pivot_record_bytes.get(s, 0) + (
                    norm_h.nbytes + attn_out.nbytes)
        elif mode == "pivot_reuse":
            attn_out = self._pivot_reuse(norm_h, cross_view,
                                         *pivot[self.pivot_key])
        else:
            raise ValueError(f"unknown attention mode {mode}")
        x = x + attn_out
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))

    @staticmethod
    def _pivot_reuse(norm_h, cv: CrossViewState, piv_h, piv_attn):
        """Epipolar-constrained nearest-token gather of the pivot attention
        outputs (make_dge_block, dge_utils.py:407-571)."""
        b, s, d = norm_h.shape
        f = b // 3
        fk = piv_h.shape[0] // 3
        piv_h = piv_h.reshape(3, fk, s, d)
        piv_attn = piv_attn.reshape(3, fk, s, d)
        closest = cv.closest_cam  # [F, n_key]
        # cosine similarity on the image CFG chunk only (dge_utils.py:428)
        img = _unit(norm_h.reshape(3, f, s, d)[1])
        piv_img = _unit(piv_h[1][closest])  # [F, n_key, S, D]
        if cv.epi_lines is not None and s in cv.epi_lines:
            with tracing.span("attn.reuse_match", device=norm_h.device,
                              tokens=s):
                idx = epi_blockwise_argmax(img, piv_img, cv.epi_lines[s],
                                           cv.epi_pts[s], cv.epi_threshold)
        else:
            sim = torch.einsum("fsd,fktd->fkst", img.float(),
                               piv_img.float())
            if cv.epipolar is not None and s in cv.epipolar:
                violation = cv.epipolar[s]
                # rows where every pivot token violates are exempted
                violation = violation & ~violation.all(dim=-1, keepdim=True)
                sim = torch.where(violation, 0.0, sim)
            idx = sim.argmax(dim=-1)  # [F, n_key, S]
        # the pivot attention output at the matched tokens, all 3 chunks
        gathered = piv_attn[:, closest[..., None], idx]  # [3, F, n_key, S, D]
        if cv.n_key == 2:
            w1 = cv.blend_w1.reshape(1, f, 1, 1)
            out = w1 * gathered[:, :, 0] + (1.0 - w1) * gathered[:, :, 1]
        else:
            out = gathered[:, :, 0]
        return out.reshape(b, s, d).to(norm_h.dtype)


def to_tokens(x):
    """[B, C, H, W] -> [B, H·W, C] in raster (y-major) order, the JAX NHWC
    ``reshape(b, h*w, c)``."""
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c)


def from_tokens(x, h: int, w: int):
    b, _, c = x.shape
    return x.reshape(b, h, w, c).permute(0, 3, 1, 2)


class Transformer2DModel(nn.Module):
    """diffusers Transformer2DModel: ``depth`` transformer blocks between
    two projections of width ``heads * dim_head``. ``linear_projection``
    False (SD-1.5): 1x1 convolutions on the image; True (SDXL's
    ``use_linear_projection``): Linear layers on the tokens."""

    def __init__(self, channels: int, heads: int, dim_head: int,
                 context_dim: int, groups: int = 32,
                 dtype: torch.dtype = torch.float32, depth: int = 1,
                 linear_projection: bool = False):
        super().__init__()
        inner = heads * dim_head
        self.linear_projection = linear_projection
        self.norm = GroupNorm(groups, channels, 1e-6, dtype)
        if linear_projection:
            self.proj_in = Linear(channels, inner, dtype=dtype)
        else:
            self.proj_in = Conv2d(channels, inner, 1, dtype=dtype)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, heads, dim_head, context_dim, dtype)
            for _ in range(depth)])
        if linear_projection:
            self.proj_out = Linear(inner, channels, dtype=dtype)
        else:
            self.proj_out = Conv2d(inner, channels, 1, dtype=dtype)

    def forward(self, x, context, **kw):
        """x [B, C, H, W] -> same."""
        h, w = x.shape[2:]
        if self.linear_projection:
            y = self.proj_in(to_tokens(self.norm(x)))
        else:
            y = to_tokens(self.proj_in(self.norm(x)))
        for block in self.transformer_blocks:
            y = block(y, context, **kw)
        if self.linear_projection:
            return from_tokens(self.proj_out(y), h, w) + x
        return self.proj_out(from_tokens(y, h, w)) + x


class ResnetBlock2D(nn.Module):
    """diffusers ResnetBlock2D. ``eps``: the UNet builds its resnets with
    1e-5, the VAE with 1e-6."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int] = None, groups: int = 32,
                 eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_channels, eps, dtype)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1,
                            dtype=dtype)
        self.time_emb_proj = (Linear(temb_channels, out_channels,
                                     dtype=dtype)
                              if temb_channels else None)
        self.norm2 = GroupNorm(groups, out_channels, eps, dtype)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1,
                            dtype=dtype)
        self.conv_shortcut = (Conv2d(in_channels, out_channels, 1,
                                     dtype=dtype)
                              if in_channels != out_channels else None)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return h + x


class Downsample2D(nn.Module):
    """Stride-2 conv. ``padding=0``: the VAE's asymmetric (0,1,0,1) pad in
    forward; ``padding=1``: the UNet's symmetric pad. Same output shape on
    even inputs, different window alignment."""

    def __init__(self, channels: int, padding: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.padding = padding
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=padding,
                           dtype=dtype)

    def forward(self, x):
        if self.padding == 0:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1, dtype=dtype)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


def init_like_flax(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights as flax initialises the JAX modules: Dense and Conv
    kernels truncated-normal of variance 1/fan_in (``lecun_normal``), biases
    0, norms scale 1 and bias 0, embeddings normal of variance 1/dim (the
    ``nn.Embed`` default). ``generator`` lives on the model's device."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                fan_in = m.weight[0].numel()
                # the std of a normal truncated at +-2 std is 0.8796 of it
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.embedding_dim),
                                 generator=generator)
