"""Prefill attention: wrappers + plain versions, and the blockwise
``flash_attention`` reference the plain versions run.

Ports of ``repro/kernels/flash_prefill.py``: ``flash_prefill_attention``
(unquantized K/V; CUDA kernel ``csrc/flash_prefill_attention.cu``) and
``paged_flash_prefill_attention`` (a prompt chunk over the quantized pool,
int8 or int4 keys and fp8 or bf16 values; ``csrc/paged_prefill_attention.cu``).  ``FlashPrefillFunction`` runs the
dense kernel in a training forward, with autograd of its plain version as
the backward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import kv_cache as kvc
from repro_torch.core.precision import DEFAULT_POLICY, PrecisionPolicy
from repro_torch.kernels import loader
from repro_torch.kernels.quant_attention import gather_rows, kernel_variant

NEG_INF = -1e30
# the reference flash_attention's default K-block
FLASH_BK = 1024


def _pad_to(x: torch.Tensor, mult: int, dim: int) -> torch.Tensor:
    pad = (-x.shape[dim]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * (x.dim() - 1 - dim) + [0, pad]
    return F.pad(x, widths)


def flash_attention(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor, *,
                    causal: bool, window: int = 0, q_offset=0,
                    bq: int = 512, bk: int = FLASH_BK,
                    policy: PrecisionPolicy = DEFAULT_POLICY) -> torch.Tensor:
    """Blockwise attention with online softmax in float32 — the reference
    ``models.attention.flash_attention`` op for op.  qh [B, T, H, D]
    pre-scaled, kh/vh [B, S, Hkv, D]; ``q_offset`` is the absolute position
    of query 0, an int or a one-element device tensor.  With an int, K
    blocks that start past the block's last query are skipped: in the
    reference they are exact no-ops (p == 0, corr == 1).  With a tensor
    every block runs under device masks, as in the reference under jit, so
    the host never reads the offset (a CUDA graph can capture the call)."""
    B, T, H, D = qh.shape
    S, Hkv = kh.shape[1], kh.shape[2]
    G = H // Hkv
    cd = policy.compute_dtype
    bq = min(bq, max(T, 1))
    bk = min(bk, max(S, 1))
    qp = _pad_to(qh, bq, 1)
    kp = _pad_to(kh, bk, 1)
    vp = _pad_to(vh, bk, 1)
    Tp, Sp = qp.shape[1], kp.shape[1]
    nq, nk = Tp // bq, Sp // bk
    qp = qp.reshape(B, nq, bq, Hkv, G, D)
    kp = kp.reshape(B, nk, bk, Hkv, D)
    vp = vp.reshape(B, nk, bk, Hkv, D)
    dev = qh.device
    valid = torch.arange(Sp, device=dev) < S
    on_host = not torch.is_tensor(q_offset)
    if on_host:
        q_offset = int(q_offset)
    else:
        q_offset = q_offset.reshape(1).long()
    outs = []
    for qi in range(nq):
        qblk = qp[:, qi].to(cd).float()                  # [B,bq,Hkv,G,D]
        qpos = q_offset + qi * bq + torch.arange(bq, device=dev)
        m = torch.full((B, Hkv, G, bq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, Hkv, G, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Hkv, G, bq, D), dtype=torch.float32, device=dev)
        for j in range(nk):
            if on_host and causal and j * bk > q_offset + (qi + 1) * bq - 1:
                break
            kb = kp[:, j].to(cd).float()
            vb = vp[:, j].to(cd).float()
            s = torch.einsum("btkgd,bskd->bkgts", qblk, kb)
            kpos = j * bk + torch.arange(bk, device=dev)
            mask = valid[j * bk:(j + 1) * bk][None, :].expand(bq, bk)
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            if window:
                mask = mask & (qpos[:, None] - kpos[None, :] < window)
            s = torch.where(mask[None, None, None], s, torch.full_like(s, NEG_INF))
            m2 = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m2[..., None])
            corr = torch.exp(m - m2)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgts,bskd->bkgtd", p.to(cd).float(), vb)
            acc = acc * corr[..., None] + pv
            m = m2
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))          # [B,bq,Hkv,G,D]
    out = torch.stack(outs, dim=1).reshape(B, Tp, H, D)
    return out[:, :T].to(cd)


def flash_prefill_attention_plain(q_: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, *, causal: bool = True,
                                  window: int = 0,
                                  policy: PrecisionPolicy = DEFAULT_POLICY
                                  ) -> torch.Tensor:
    """The reference dispatcher's ``prefill_attention`` entry op for op: the
    blockwise ``flash_attention`` with query i at position i.  Returns f32
    [B, T, H, D] (values in the compute dtype)."""
    return flash_attention(q_, k, v, causal=causal, window=window,
                           policy=policy).float()


MAX_GRID_Y = 65535    # the kernel's blocks of 64 query-head rows run on grid y
HEAD_DIMS = (64, 128)  # the kernel's instantiations


def flash_prefill_attention(q_: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            *, causal: bool = True, window: int = 0
                            ) -> torch.Tensor:
    """Pre-scaled queries [B, T, H, D] (bf16 on the card) attend over keys
    and values [B, S, Hkv, D]: query i at position i, causal and/or within
    ``window`` (0 = unbounded).  Returns f32 [B, T, H, D]."""
    B, T, H, D = q_.shape
    S, Hkv = k.shape[1], k.shape[2]
    if H % Hkv:
        raise ValueError(f"H={H} not a multiple of Hkv={Hkv}")
    if k.shape != (B, S, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)}, v {tuple(v.shape)} for q "
                         f"{tuple(q_.shape)}")
    if window < 0:
        raise ValueError(f"window={window}")
    devs = {t.device for t in (q_, k, v)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")
    dev = q_.device
    if dev.type == "cpu":
        return flash_prefill_attention_plain(q_, k, v, causal=causal, window=window)
    if dev.type != "cuda":
        raise NotImplementedError(f"no prefill-attention kernel for {dev}")
    loader.refuse_grad("flash_prefill_attention", q_, k, v)
    if D not in HEAD_DIMS:
        raise NotImplementedError(f"D={D}: the kernel takes D in {HEAD_DIMS}")
    if {q_.dtype, k.dtype, v.dtype} != {torch.bfloat16}:
        raise TypeError(f"dtypes {q_.dtype}, {k.dtype}, {v.dtype}: the kernel "
                        "reads bf16 queries, keys and values")
    if -(-T * (H // Hkv) // 64) > MAX_GRID_Y:
        raise NotImplementedError(f"T={T}: past the kernel's grid limit")
    if not all(t.is_contiguous() for t in (q_, k, v)):
        raise ValueError("prefill-attention operands must be contiguous")
    out = torch.empty((B, T, H, D), dtype=torch.float32, device=dev)
    if B * T == 0:
        return out
    if S == 0:
        raise ValueError("no keys to attend over")
    lib = loader.build()
    code = lib.flash_prefill_attention_launch(
        q_.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, S, Hkv,
        H // Hkv, D, int(bool(causal)), int(window), loader.stream_ptr(dev))
    loader.check(code, "flash_prefill_attention")
    flash_prefill_attention.launches += 1
    return out


flash_prefill_attention.launches = 0


class FlashPrefillFunction(torch.autograd.Function):
    """``flash_prefill_attention`` under autograd (the training forward's
    causal GQA over bf16 K/V): the forward launches the kernel through the
    wrapper and saves q, k and v; the backward is autograd of
    ``flash_prefill_attention_plain`` recomputed from them
    (``loader.plain_vjp``), the reference's blockwise ``flash_attention``,
    which XLA differentiates.  ``apply(q, k, v, causal, window)`` -> f32
    [B, T, H, D]."""

    @staticmethod
    def forward(ctx, q_, k, v, causal, window):
        ctx.save_for_backward(q_, k, v)
        ctx.causal, ctx.window = causal, window
        return flash_prefill_attention(q_, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, grad):
        grads = loader.plain_vjp(
            lambda a, b, c: flash_prefill_attention_plain(a, b, c, causal=ctx.causal,
                                                          window=ctx.window),
            ctx.saved_tensors, ctx.needs_input_grad[:3], grad)
        return (*grads, None, None)


def paged_flash_prefill_attention_plain(
        q_: torch.Tensor, k_q: torch.Tensor, k_scale: torch.Tensor,
        k_zero: torch.Tensor, v: torch.Tensor, table: torch.Tensor,
        pos0: torch.Tensor, *, key_bits: int = 8,
        policy: PrecisionPolicy = DEFAULT_POLICY) -> torch.Tensor:
    """The reference paged prefill (``kv_pool.paged_prefill_attention_ref``)
    op for op, row by row: gather the row's pages, dequantize keys to the
    compute dtype, run the blockwise ``flash_attention`` with the chunk's
    query offset.  Returns f32 [B, C, H, D] (values in the compute dtype)."""
    outs = []
    for b in range(q_.shape[0]):
        tb = table[b:b + 1]
        k = kvc.dequantize_keys(gather_rows(k_q, tb), gather_rows(k_scale, tb),
                                gather_rows(k_zero, tb), policy.compute_dtype,
                                bits=key_bits)
        vv = gather_rows(v, tb).to(policy.compute_dtype)
        outs.append(flash_attention(q_[b:b + 1], k, vv, causal=True,
                                    q_offset=int(pos0[b]), policy=policy))
    return torch.cat(outs).float()


def paged_flash_prefill_attention(
        q_: torch.Tensor, k_q: torch.Tensor, k_scale: torch.Tensor,
        k_zero: torch.Tensor, v: torch.Tensor, table: torch.Tensor,
        pos0: torch.Tensor, *, key_bits: int = 8) -> torch.Tensor:
    """A chunk of C pre-scaled queries [B, C, H, D] (bf16 on the card) at absolute positions
    pos0[b] + arange(C) attends causally over its pool pages through
    ``table`` [B, n_pages] (the chunk's K/V already appended).  Returns
    f32 [B, C, H, D]."""
    B, C, H, D = q_.shape
    ps, Hkv = k_q.shape[1], k_q.shape[2]
    if H % Hkv:
        raise ValueError(f"H={H} not a multiple of Hkv={Hkv}")
    if table.shape[0] != B or pos0.shape != (B,):
        raise ValueError(f"table {tuple(table.shape)}, pos0 {tuple(pos0.shape)} "
                         f"for B={B}")
    devs = {t.device for t in (q_, k_q, k_scale, k_zero, v, table, pos0)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")
    dev = q_.device
    if dev.type == "cpu":
        return paged_flash_prefill_attention_plain(
            q_, k_q, k_scale, k_zero, v, table, pos0, key_bits=key_bits)
    if dev.type != "cuda":
        raise NotImplementedError(f"no prefill-attention kernel for {dev}")
    loader.refuse_grad("paged_flash_prefill_attention", q_, k_scale, k_zero, v)
    variant = kernel_variant(q_, k_q, k_scale, k_zero, v, key_bits, head_dims=HEAD_DIMS)
    if table.dtype != torch.int32 or pos0.dtype != torch.int32:
        raise TypeError("table/pos0 must be int32")
    operands = (q_, k_q, k_scale, k_zero, v, table, pos0)
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("prefill-attention operands must be contiguous")
    out = torch.empty((B, C, H, D), dtype=torch.float32, device=dev)
    if B * C == 0:
        return out
    lib = loader.build()
    code = lib.paged_prefill_attention_launch(
        q_.data_ptr(), k_q.data_ptr(), k_scale.data_ptr(), k_zero.data_ptr(),
        v.data_ptr(), table.data_ptr(), pos0.data_ptr(), out.data_ptr(),
        B, C, Hkv, H // Hkv, D, ps, table.shape[1], *variant, loader.stream_ptr(dev))
    loader.check(code, "paged_flash_prefill_attention")
    paged_flash_prefill_attention.launches += 1
    return out


paged_flash_prefill_attention.launches = 0
