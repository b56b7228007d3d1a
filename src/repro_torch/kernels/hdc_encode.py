"""Hopper kernel for HDC hypervector encoding (record-based, bipolar).

Each feature position ``f`` owns a *key* hypervector ``keys[f]`` and each
quantised level ``l`` a *level* hypervector ``levels[l]``; a sample is
the majority bundle over its features of their bind::

    enc[m, h] = sign( sum_f keys[f, h] * levels[q[m, f], h] )   tie -> +1

:func:`hdc_encode` launches the CUDA kernel (``csrc/hdc_encode.cu``,
built by :mod:`.build`), which computes that gather form directly with
int8 cells and int32 sums; it replaces the reference's
``hdc_encode_pallas``, whose one-hot matmuls exist only because the TPU's
matrix unit cannot gather.  Beside it, :func:`hdc_encode_reference` is
its plain PyTorch version: the one-hot matmul decomposition
``sum_l (q == l) @ keys * levels[l]``, chunked over queries so no
(M, F, H) tensor is built.

Contract: ``level_idx`` (M, F) int32; ``keys`` (F, H) and ``levels``
(L, H) with every value in {-1, 0, +1} (float32 or int8), where the sums
are small integers and both versions are exact, hence bit-identical.  An
id outside ``[0, L)`` contributes nothing, as in the reference kernel's
one-hot.  The wrapper runs the plain version for CPU tensors only; for
CUDA tensors it launches the kernel or raises.  Each launch adds one to
:data:`.cam_search.LAUNCHES` (``"hdc_encode"``).
"""

from __future__ import annotations

import torch

from . import build
from .cam_search import _args, _bind, _count, _raise_if_failed

__all__ = ["hdc_encode", "hdc_encode_reference", "hdc_sums_reference",
           "HDC_BLOCK_H", "HDC_SMEM_LIMIT"]

#: hypervector dims per block of the kernel
HDC_BLOCK_H = 128
#: shared memory of one block besides the level slice: the staged level
#: ids (64 queries x 64 features, int32) and keys (64 x 128, int8)
_HDC_STAGE_BYTES = 64 * 64 * 4 + 64 * HDC_BLOCK_H
#: the most shared memory a block can use on an H100 (227 KB)
HDC_SMEM_LIMIT = 232448
#: elements of one (queries, dims) accumulator chunk of the plain version
_REFERENCE_CHUNK_ELEMS = 1 << 26


def hdc_sums_reference(level_idx: torch.Tensor, keys: torch.Tensor,
                       levels: torch.Tensor) -> torch.Tensor:
    """The (M, H) float32 bundle sums before the sign, by the one-hot
    matmul decomposition (exact integers), chunked over queries so the
    accumulator stays near 256 MB at any width."""
    _check(level_idx, keys, levels)
    m = level_idx.shape[0]
    h = keys.shape[1]
    k = keys.to(torch.float32)
    lv = levels.to(torch.float32)
    out = torch.empty((m, h), dtype=torch.float32, device=keys.device)
    step = max(1, _REFERENCE_CHUNK_ELEMS // max(1, h))
    for s in range(0, m, step):
        q = level_idx[s:s + step]
        acc = out[s:s + step].zero_()
        for level in range(lv.shape[0]):
            onehot = (q == level).to(torch.float32)
            acc += (onehot @ k) * lv[level][None, :]
    return out


def hdc_encode_reference(level_idx: torch.Tensor, keys: torch.Tensor,
                         levels: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`hdc_encode`: the sign of
    :func:`hdc_sums_reference`, tie -> +1."""
    s = hdc_sums_reference(level_idx, keys, levels)
    return torch.where(s >= 0, 1.0, -1.0)


def _check(level_idx: torch.Tensor, keys: torch.Tensor,
           levels: torch.Tensor) -> None:
    ops = {"level_idx": level_idx, "keys": keys, "levels": levels}
    for what, t in ops.items():
        if not isinstance(t, torch.Tensor) or t.dim() != 2:
            raise ValueError(f"hdc_encode: {what} must be a 2-D tensor")
        if t.device != level_idx.device:
            raise ValueError(f"hdc_encode: {what} is on {t.device}, "
                             f"level_idx on {level_idx.device}")
    if level_idx.dtype != torch.int32:
        raise ValueError(f"hdc_encode: level_idx must be torch.int32, got "
                         f"{level_idx.dtype}")
    for what in ("keys", "levels"):
        if ops[what].dtype not in (torch.float32, torch.int8):
            raise ValueError(f"hdc_encode: {what} must be float32 or int8, "
                             f"got {ops[what].dtype}")
    if level_idx.device.type not in ("cpu", "cuda"):
        raise ValueError(f"hdc_encode: unsupported device "
                         f"{level_idx.device}")
    if keys.shape[0] != level_idx.shape[1]:
        raise ValueError(f"hdc_encode: {level_idx.shape[1]} features but "
                         f"{keys.shape[0]} key rows")
    if levels.shape[1] != keys.shape[1]:
        raise ValueError(f"hdc_encode: keys {tuple(keys.shape)} and levels "
                         f"{tuple(levels.shape)} differ in width")
    if levels.shape[0] == 0 or keys.shape[1] == 0:
        raise ValueError("hdc_encode: need at least one level and one dim")


def _smem_bytes(n_levels: int) -> int:
    """Shared memory of one block: the staged ids and keys, and the
    block's slice of the levels plus one zero row."""
    return _HDC_STAGE_BYTES + (n_levels + 1) * HDC_BLOCK_H


def _int8_cells(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` as contiguous int8 cells, zero-padded to ``width`` columns
    (a multiple of 4, so the kernel loads whole 32-bit words)."""
    x = x.to(torch.int8)
    if x.shape[1] != width:
        x = torch.nn.functional.pad(x, (0, width - x.shape[1]))
    return x.contiguous()


def hdc_encode(level_idx: torch.Tensor, keys: torch.Tensor,
               levels: torch.Tensor) -> torch.Tensor:
    """(M, H) float32 bipolar encodings of ``level_idx`` (M, F) int32
    with ``keys`` (F, H) and ``levels`` (L, H), values in {-1, 0, +1}.

    CPU tensors run :func:`hdc_encode_reference`; CUDA tensors launch the
    kernel (keys and levels are cast to int8 cells, which is exact on the
    contract's alphabet; the wrapper does not read them back to check).
    Raises when the block's slice of the levels does not fit in shared
    memory.
    """
    _check(level_idx, keys, levels)
    if level_idx.device.type == "cpu":
        return hdc_encode_reference(level_idx, keys, levels)
    n_levels = levels.shape[0]
    if _smem_bytes(n_levels) > HDC_SMEM_LIMIT:
        raise ValueError(
            f"hdc_encode: {n_levels} levels x {HDC_BLOCK_H} dims do not fit "
            f"in a block's shared memory ({_smem_bytes(n_levels)} > "
            f"{HDC_SMEM_LIMIT} bytes)")
    m, f = level_idx.shape
    h = keys.shape[1]
    if -(-m // 64) > 65535:
        raise ValueError(f"hdc_encode: {m} query rows exceed the launch "
                         f"grid; split the batch")
    width = 4 * -(-h // 4)
    q = level_idx.contiguous()
    k8 = _int8_cells(keys, width)
    l8 = _int8_cells(levels, width)
    out = torch.empty((m, h), dtype=torch.float32, device=q.device)
    if m == 0:
        return out
    lib = build.load("hdc_encode")
    launch = _bind(lib, "c4cam_hdc_encode", _args(4, 5))
    with torch.cuda.device(q.device):
        err = launch(q.data_ptr(), k8.data_ptr(), l8.data_ptr(),
                     out.data_ptr(), m, f, h, width, n_levels,
                     torch.cuda.current_stream(q.device).cuda_stream)
    _raise_if_failed(lib, "hdc_encode", err)
    _count("hdc_encode")
    return out

