"""flash_prefill — tiled attention forward (online softmax), causal or
bidirectional, for GQA.

  out[b, i, h] = softmax(q[b, i, h] . K[b, :, h // G] / sqrt(D)
                         [causal: keys after i masked]) @ V[b, :, h // G]

Port of ``repro/kernels/flash_prefill.py:flash_prefill_blocks``. Layouts
are the model's: q and the output (B, Sq, H, D), k and v (B, Skv, KV, D),
H = KV * G with query head h reading KV head h // G. The reference's
wrapper moves q to (B, KV, G, Sq, D) and pads Sq and Skv to its 512 blocks;
the CUDA kernel reads q in place and masks the tails instead. Causal
positions align from 0 (query i sees keys 0..i). Bidirectionally the
reference lets its zero-padded keys into the softmax, so the two agree
there only where Skv is a multiple of its kv block; this port masks them.
``lm.encode`` (hubert-xlarge: 16 heads of 80) is the path that takes the
bidirectional mode, at Skv = Sq, so no key row is padded.

On CUDA tensors ``flash_prefill_blocks`` launches ``csrc/flash_prefill.cu``
(its note says what bounds it and how the design answers): for bf16 a
tensor-core kernel (mma.sync for q . k and for p . v, with each f32 p
split into two bf16 terms), for f32 a plain FMA kernel. On CPU tensors it
computes ``flash_prefill_plain``, the same arithmetic (f32 scores with
1/sqrt(D) rounded in f32, p kept in f32, f32 accumulation, output divided
by max(l, 1e-30) and cast to q's dtype) in one dense softmax.
``flash_prefill_cost`` gives the work the function needs
(``kernels.counting``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.counting import counted, plain_device
from repro_torch.kernels.flash_decode import softmax_scale

_DTYPES = (torch.float32, torch.bfloat16)
_DIMS = (16, 32, 64, 80, 128)      # 80: zamba2's shared attention block
                                   # (causal) and hubert-xlarge (``encode``,
                                   # bidirectional)


def flash_prefill_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """The plain version of ``flash_prefill_blocks``."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, D).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * softmax_scale(D)
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Skv, device=q.device)[None, :])
    else:
        mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    s = s.masked_fill(~mask, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True)) * mask
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    l = p.sum(-1).permute(0, 3, 1, 2)[..., None]          # (B, Sq, KV, G, 1)
    return (out / l.clamp(min=1e-30)).reshape(B, Sq, H, D).to(q.dtype)


def flash_prefill_cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool = True) -> dict:
    """The work of one ``flash_prefill_blocks`` call: q, k, v read and the
    output written once; q . k and p . v once for each key a query sees,
    at the inputs' rate (whatever the kernel does within: its bf16 p . v
    runs as two products, p = hi + lo)."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    if not causal:
        keys = Sq * Skv
    elif Skv >= Sq:                     # query i sees keys 0..i
        keys = Sq * (Sq + 1) // 2
    else:
        keys = Skv * (Skv + 1) // 2 + (Sq - Skv) * Skv
    ops = float(4 * D * H * B * keys)
    bf16 = q.dtype == torch.bfloat16
    return {"flops": 0.0 if bf16 else ops, "bf16_flops": ops if bf16 else 0.0,
            "bytes_accessed": float((2 * q.numel() + 2 * k.numel())
                                    * q.element_size())}


def _check(q, k, v) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"q (B, Sq, H, D) and k/v (B, Skv, KV, D) expected, "
                         f"got {tuple(q.shape)} / {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of {_DTYPES}, got "
                        f"{q.dtype} / {k.dtype} / {v.dtype}")


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_prefill")
    fn = lib.flash_prefill_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, p, i, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


@counted(flash_prefill_cost, "flash_prefill", dots=True)
def flash_prefill_blocks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Skv, KV, D). Returns (B, Sq, H, D) in q's
    dtype. CPU tensors take ``flash_prefill_plain``; CUDA tensors launch
    the kernel or raise ("meta" tensors under ``counting.on_meta()``, the
    dry run's, the plain version too)."""
    _check(q, k, v)
    if plain_device(q.device):
        return flash_prefill_plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_prefill runs on cuda or cpu, not "
                           f"{q.device}")
    for t in (k, v):
        if t.device != q.device:
            raise RuntimeError(f"flash_prefill operands on {t.device} and "
                               f"{q.device}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if D not in _DIMS:
        raise ValueError(f"flash_prefill takes D in {_DIMS}, got {D}")
    if B > 65535 or H > 65535 or Sq > 64 * 65535:
        raise ValueError(f"flash_prefill grid too large for B={B}, H={H}, "
                         f"Sq={Sq}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_prefill copies q/k/v in 16-byte chunks: "
                         "they must be 16-byte aligned")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = _lib().flash_prefill_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        int(q.dtype == torch.bfloat16), out.data_ptr(), B, Sq, Skv, H, KV, D,
        int(causal), softmax_scale(D),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_prefill launch failed: cudaError {err}")
    flash_prefill_blocks.launches += 1
    return out


flash_prefill_blocks.launches = 0    # kernel launches (CUDA tensors only)
