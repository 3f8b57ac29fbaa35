"""Public wrappers of the port's kernels.

Each wrapper checks device, dtype, shape and contiguity, then dispatches
on the device of its tensors: a CPU tensor goes to the kernel's plain
PyTorch version, a CUDA tensor to the CUDA kernel, and anything else
raises. There is no flag and no fallback — a CUDA tensor never reaches a
plain version here, and a kernel that fails to build or launch raises.

``LAUNCHES`` counts kernel launches per wrapper (plain-version calls do
not count), so a run can show that its main path went through the
kernels; ``reset_launches`` zeroes the counts.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import haar2d as _haar
from repro_torch.kernels import jaccard_popcount as _jac
from repro_torch.kernels import mamba_scan as _ms
from repro_torch.kernels import minmax_hash as _mm
from repro_torch.kernels import stft_mag as _stft
from repro_torch.kernels.ref import haar_matrix

LAUNCHES = {"stft_mag": 0, "haar2d": 0, "minmax_hash": 0,
            "minmax_sig_buckets": 0, "jaccard_popcount": 0,
            "flash_attention": 0, "mamba_scan": 0}
_FLOATS = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(name: str, *tensors: torch.Tensor) -> bool:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {devs}")
    kind = next(iter(devs)).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {kind}")
    return kind == "cuda"


def _require(cond: bool, name: str, what: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {what}")


def _typed(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           label: str) -> None:
    _require(t.dtype == dtype, name, f"{label} must be {dtype}, got {t.dtype}")
    _require(t.dim() == ndim, name, f"{label} must be {ndim}-D, got "
             f"{tuple(t.shape)}")
    _require(t.is_contiguous(), name, f"{label} must be contiguous")


def stft_mag(wave: torch.Tensor, window: torch.Tensor, dft_r: torch.Tensor,
             dft_i: torch.Tensor, hop: int) -> torch.Tensor:
    """(R, T) waveforms → (R, n_frames, K) power spectrogram of the
    ``hop``-spaced, ``window``-weighted frames over the DFT columns."""
    name = "stft_mag"
    for t, label, nd in ((wave, "wave", 2), (window, "window", 1),
                         (dft_r, "dft_r", 2), (dft_i, "dft_i", 2)):
        _typed(name, t, torch.float32, nd, label)
    frame_len = window.shape[0]
    _require(dft_r.shape == dft_i.shape and dft_r.shape[0] == frame_len,
             name, "dft_r/dft_i must both be (frame_len, K)")
    _require(hop > 0 and wave.shape[1] >= frame_len, name,
             "need hop > 0 and at least one frame")
    if not _on_cuda(name, wave, window, dft_r, dft_i):
        return _stft.plain(wave, window, dft_r, dft_i, hop)
    nf = _stft.n_frames(wave.shape[1], frame_len, hop)
    out = torch.empty((wave.shape[0], nf, dft_r.shape[1]),
                      dtype=torch.float32, device=wave.device)
    _stft.launch(wave, window, dft_r, dft_i, hop, out)
    LAUNCHES[name] += 1
    return out


_HAAR_MATS: dict = {}


def haar_mats(h: int, w: int, device) -> tuple[torch.Tensor, ...]:
    """(T_H, T_W, T_Wᵀ) as fp32 tensors on ``device`` (cached)."""
    key = (h, w, str(device))
    mats = _HAAR_MATS.get(key)
    if mats is None:
        th = torch.as_tensor(haar_matrix(h), device=device)
        tw = torch.as_tensor(haar_matrix(w), device=device)
        mats = _HAAR_MATS[key] = (th, tw, tw.T.contiguous())
    return mats


def haar2d(imgs: torch.Tensor) -> torch.Tensor:
    """Standard-decomposition 2-D Haar transform of (N, H, W) images."""
    name = "haar2d"
    _typed(name, imgs, torch.float32, 3, "imgs")
    n, h, w = imgs.shape
    th, tw, tw_t = haar_mats(h, w, imgs.device)
    if not _on_cuda(name, imgs):
        return _haar.plain(imgs, th, tw)
    out = torch.empty_like(imgs)
    _haar.launch(imgs, th, tw_t, out)
    LAUNCHES[name] += 1
    return out


def minmax_hash(packed: torch.Tensor, mappings: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed (N, D/32) fingerprints × (D, H) mappings → the raw (mins,
    maxs) planes, each (N, H) int32: the min and max of each mapping
    column over the row's set bits (2**31 - 1 and 0 for an empty row)."""
    name = "minmax_hash"
    _typed(name, packed, torch.int32, 2, "packed")
    _typed(name, mappings, torch.int32, 2, "mappings")
    _require(mappings.shape[0] == 32 * packed.shape[1], name,
             "mappings rows must equal 32 * packed words")
    if not _on_cuda(name, packed, mappings):
        return _mm.plain_raw(packed, mappings)
    shape = (packed.shape[0], mappings.shape[1])
    mins = torch.empty(shape, dtype=torch.int32, device=packed.device)
    maxs = torch.empty(shape, dtype=torch.int32, device=packed.device)
    if mins.numel():
        _mm.launch_raw(packed, mappings, mins, maxs)
        LAUNCHES[name] += 1
    return mins, maxs


def minmax_sig_buckets(packed: torch.Tensor, mappings: torch.Tensor,
                       salts: torch.Tensor, *, use_minmax: bool,
                       n_buckets: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed (N, D/32) fingerprints × (D, T·f) mappings → (signatures
    (N, T) int32 holding uint32 patterns, bucket ids (N, T) int32).

    ``salts`` is the (T,) per-table bucket salt (int32 bit patterns);
    the T·f mapping columns are function-fastest, as ``hash_mappings``
    lays them out.
    """
    name = "minmax_sig_buckets"
    _typed(name, packed, torch.int32, 2, "packed")
    _typed(name, mappings, torch.int32, 2, "mappings")
    _typed(name, salts, torch.int32, 1, "salts")
    t = salts.shape[0]
    _require(mappings.shape[0] == 32 * packed.shape[1], name,
             "mappings rows must equal 32 * packed words")
    _require(t > 0 and mappings.shape[1] % t == 0, name,
             "mapping columns must be n_tables * funcs_per_table")
    _require(n_buckets > 0 and n_buckets & (n_buckets - 1) == 0, name,
             "n_buckets must be a power of two")
    f = mappings.shape[1] // t
    if not _on_cuda(name, packed, mappings, salts):
        return _mm.plain(packed, mappings, salts, f, use_minmax, n_buckets)
    n = packed.shape[0]
    sig = torch.empty((n, t), dtype=torch.int32, device=packed.device)
    bkt = torch.empty((n, t), dtype=torch.int32, device=packed.device)
    if n:
        _mm.launch(packed, mappings, salts, f, use_minmax, n_buckets, sig,
                   bkt)
        LAUNCHES[name] += 1
    return sig, bkt


def jaccard_popcount(pk: torch.Tensor, i1: torch.Tensor, i2: torch.Tensor,
                     valid: torch.Tensor | None = None) -> torch.Tensor:
    """Exact Jaccard of ring rows ``pk[s, i1[s, m] % P]`` and
    ``pk[s, i2[s, m] % P]`` (Python's modulo, so negative ids wrap too).

    pk (S, P, W) int32 packed words; i1/i2 (S, M) int32 ids, not reduced;
    valid (S, M) bool or None (all valid) → (S, M) fp32, 0 where the union
    is empty and where the slot is not valid (its ids may hold anything
    and neither row is read). One launch on the card, no host sync.
    """
    name = "jaccard_popcount"
    _typed(name, pk, torch.int32, 3, "pk")
    _typed(name, i1, torch.int32, 2, "i1")
    _typed(name, i2, torch.int32, 2, "i2")
    _require(i1.shape == i2.shape and i1.shape[0] == pk.shape[0], name,
             "i1/i2 must both be (S, M) with S = pk.shape[0]")
    _require(pk.shape[1] > 0 or i1.numel() == 0, name,
             "pk must hold at least one ring row")
    tensors = (pk, i1, i2)
    if valid is not None:
        _typed(name, valid, torch.bool, 2, "valid")
        _require(valid.shape == i1.shape, name, "valid must be (S, M)")
        tensors += (valid,)
    if not _on_cuda(name, *tensors):
        return _jac.plain(pk, i1, i2, valid)
    out = torch.empty(i1.shape, dtype=torch.float32, device=pk.device)
    if out.numel():
        _jac.launch(pk, i1, i2, valid, out)
        LAUNCHES[name] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """GQA attention, query head h reading kv head h // group: q (B, Hq,
    Sq, D), k / v (B, Hkv, Sk, D) → (B, Hq, Sq, D) in q's dtype; causal
    with offset Sk − Sq. fp32 or bf16, all one dtype; any strides with the
    last dim contiguous (the output takes q's layout). On the card, bf16
    tensors must also be 16-byte aligned with batch/head/seq strides that
    are multiples of 8 elements; others raise (no copy is made)."""
    name = "flash_attention"
    _require(q.dtype in _FLOATS and k.dtype == v.dtype == q.dtype, name,
             f"q, k, v must share one of {_FLOATS}")
    _require(q.dim() == k.dim() == v.dim() == 4, name, "q, k, v must be 4-D")
    _require(all(t.stride(-1) == 1 for t in (q, k, v)), name,
             "the last dim of q, k, v must be contiguous")
    b, hq, sq, d = q.shape
    _require(k.shape == v.shape and k.shape[0] == b and k.shape[3] == d
             and k.shape[1] > 0 and hq % k.shape[1] == 0, name,
             "k and v must be (B, Hkv, Sk, D) with Hq a multiple of Hkv")
    if not _on_cuda(name, q, k, v):
        return _fa.plain(q, k, v, causal)
    _require(d in _fa.HEAD_DIMS, name,
             f"the kernel takes head sizes {_fa.HEAD_DIMS}, not {d}")
    if q.dtype == torch.bfloat16:
        for t, label in ((q, "q"), (k, "k"), (v, "v")):
            _require(_fa.aligned(t), name,
                     f"the bf16 kernel loads 16 bytes a thread: {label} must "
                     "start on a 16-byte boundary and have batch/head/seq "
                     "strides that are multiples of 8 elements (offset "
                     f"{t.data_ptr() % 16} B, strides {t.stride()[:3]})")
    out = torch.empty_like(q)
    _fa.launch(q, k, v, out, causal)
    LAUNCHES[name] += 1
    return out


def mamba_scan(xdt: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, c: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba1 selective scan from h₀ = 0: xdt / dt (B, S, Di), a (Di, N)
    fp32, b / c (B, S, N) → (y (B, S, Di) in xdt's dtype, h_final (B, Di,
    N) fp32). xdt, dt, b, c share fp32 or bf16."""
    name = "mamba_scan"
    _require(xdt.dtype in _FLOATS, name, f"xdt must be one of {_FLOATS}")
    for t, label, nd in ((xdt, "xdt", 3), (dt, "dt", 3), (b, "b", 3),
                         (c, "c", 3)):
        _typed(name, t, xdt.dtype, nd, label)
    _typed(name, a, torch.float32, 2, "a")
    bsz, s, di = xdt.shape
    n = a.shape[1]
    _require(dt.shape == xdt.shape and a.shape[0] == di, name,
             "dt must match xdt and a must be (Di, N)")
    _require(b.shape == c.shape == (bsz, s, n), name, "b and c must be "
             "(B, S, N)")
    if not _on_cuda(name, xdt, dt, a, b, c):
        return _ms.plain(xdt, dt, a, b, c)
    _require(1 <= n <= _ms.MAX_STATE, name,
             f"the kernel takes 1 <= N <= {_ms.MAX_STATE}, not {n}")
    y = torch.empty_like(xdt)
    h_final = torch.empty((bsz, di, n), dtype=torch.float32,
                          device=xdt.device)
    _ms.launch(xdt, dt, a, b, c, y, h_final)
    LAUNCHES[name] += 1
    return y, h_final
