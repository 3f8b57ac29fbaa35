"""Public wrappers of the port's kernels.

Each wrapper checks device, dtype, shape and contiguity, then dispatches
on the device of its tensors: a CPU tensor goes to the kernel's plain
PyTorch version, a CUDA tensor to the CUDA kernel, a ``meta`` tensor to
the kernel's shape function, and anything else raises. There is no flag
and no fallback — a CUDA tensor never reaches a plain version here, and a
kernel that fails to build or launch raises. A ``meta`` call computes no
values and launches nothing: it returns ``meta`` outputs of the kernel's
shapes and dtypes and records the kernel's work (``kernels/cost.py``) for
the step analyzer that is recording (``launch/hlo_stats``), if one is.

``LAUNCHES`` counts kernel launches per wrapper (plain-version calls do
not count), so a run can show that its main path went through the
kernels; ``reset_launches`` zeroes the counts.

``flash_attention`` and ``mamba_scan`` are differentiable: on CUDA
tensors that require grad they go through ``FlashAttentionFn`` /
``MambaScanFn``, whose backward launches the hand-written backward
kernel (counted as ``flash_attention_bwd`` / ``mamba_scan_bwd``); on CPU
tensors autograd differentiates the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cost
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import haar2d as _haar
from repro_torch.kernels import jaccard_popcount as _jac
from repro_torch.kernels import mamba_scan as _ms
from repro_torch.kernels import minmax_hash as _mm
from repro_torch.kernels import stft_mag as _stft
from repro_torch.kernels.ref import haar_matrix

LAUNCHES = {"stft_mag": 0, "haar2d": 0, "minmax_hash": 0,
            "minmax_sig_buckets": 0, "jaccard_popcount": 0,
            "flash_attention": 0, "mamba_scan": 0,
            "flash_attention_bwd": 0, "mamba_scan_bwd": 0}
_FLOATS = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _route(name: str, *tensors: torch.Tensor) -> str:
    """The one device type of ``tensors``: "cpu", "cuda" or "meta"."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {devs}")
    kind = next(iter(devs)).type
    if kind not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{name}: unsupported device {kind}")
    return kind


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
    route = _route(name, wave, window, dft_r, dft_i)
    if route == "cpu":
        return _stft.plain(wave, window, dft_r, dft_i, hop)
    nf = _stft.n_frames(wave.shape[1], frame_len, hop)
    out = torch.empty((wave.shape[0], nf, dft_r.shape[1]),
                      dtype=torch.float32, device=wave.device)
    if route == "meta":
        cost.record(name, cost.stft_mag(*wave.shape, frame_len,
                                        dft_r.shape[1], hop))
        return out
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
    route = _route(name, imgs)
    if route == "meta":
        cost.record(name, cost.haar2d(n, h, w))
        return torch.empty_like(imgs)
    th, tw, tw_t = haar_mats(h, w, imgs.device)
    if route == "cpu":
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
    route = _route(name, packed, mappings)
    if route == "cpu":
        return _mm.plain_raw(packed, mappings)
    shape = (packed.shape[0], mappings.shape[1])
    mins = torch.empty(shape, dtype=torch.int32, device=packed.device)
    maxs = torch.empty(shape, dtype=torch.int32, device=packed.device)
    if route == "meta":
        cost.record(name, cost.minmax_hash(*packed.shape, shape[1]))
    elif mins.numel():
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
    route = _route(name, packed, mappings, salts)
    if route == "cpu":
        return _mm.plain(packed, mappings, salts, f, use_minmax, n_buckets)
    n = packed.shape[0]
    sig = torch.empty((n, t), dtype=torch.int32, device=packed.device)
    bkt = torch.empty((n, t), dtype=torch.int32, device=packed.device)
    if route == "meta":
        cost.record(name, cost.minmax_sig_buckets(
            *packed.shape, mappings.shape[1], t))
    elif n:
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
    route = _route(name, *tensors)
    if route == "cpu":
        return _jac.plain(pk, i1, i2, valid)
    out = torch.empty(i1.shape, dtype=torch.float32, device=pk.device)
    if route == "meta":
        cost.record(name, cost.jaccard_popcount(*pk.shape[:2],
                                                i1.shape[1], pk.shape[2]))
    elif out.numel():
        _jac.launch(pk, i1, i2, valid, out)
        LAUNCHES[name] += 1
    return out


def _check_attention(name: str, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> str:
    """Checks the inputs of the attention kernels; their device type. On
    the card and on ``meta`` the head size must be the kernel's; the
    card's alignment checks need storage, which ``meta`` has not."""
    _require(q.dtype in _FLOATS and k.dtype == v.dtype == q.dtype, name,
             f"q, k, v must share one of {_FLOATS}")
    _require(q.dim() == k.dim() == v.dim() == 4, name, "q, k, v must be 4-D")
    _require(all(t.stride(-1) == 1 for t in (q, k, v)), name,
             "the last dim of q, k, v must be contiguous")
    b, hq, sq, d = q.shape
    _require(k.shape == v.shape and k.shape[0] == b and k.shape[3] == d
             and k.shape[1] > 0 and hq % k.shape[1] == 0, name,
             "k and v must be (B, Hkv, Sk, D) with Hq a multiple of Hkv")
    route = _route(name, q, k, v)
    if route == "cpu":
        return route
    _require(d in _fa.HEAD_DIMS, name,
             f"the kernel takes head sizes {_fa.HEAD_DIMS}, not {d}")
    if route == "cuda" and q.dtype == torch.bfloat16:
        for t, label in ((q, "q"), (k, "k"), (v, "v")):
            _require(_fa.aligned(t), name,
                     f"the bf16 kernel loads 16 bytes a thread: {label} must "
                     "start on a 16-byte boundary and have batch/head/seq "
                     "strides that are multiples of 8 elements (offset "
                     f"{t.data_ptr() % 16} B, strides {t.stride()[:3]})")
    return route


def _attention_work(q, k, causal: bool, bwd: bool = False) -> cost.Work:
    b, hq, sq, d = q.shape
    fn = cost.flash_attention_bwd if bwd else cost.flash_attention
    return fn(b, hq, k.shape[1], sq, k.shape[2], d, q.dtype, causal)


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` on the card with its backward kernel: the
    forward also writes each row's log-sum-exp and saves q, k, v, the
    output and the log-sum-exp; the backward launches
    ``flash_attention_bwd``. The gradients come in the layouts of q, k, v
    (``empty_like``), so the model's transposed views cost no copy."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out = torch.empty_like(q)
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        if q.is_meta:
            cost.record("flash_attention", _attention_work(q, k, causal))
        else:
            _fa.launch(q, k, v, out, causal, lse)
            LAUNCHES["flash_attention"] += 1
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, out, lse, do, ctx.causal),
                None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """GQA attention, query head h reading kv head h // group: q (B, Hq,
    Sq, D), k / v (B, Hkv, Sk, D) → (B, Hq, Sq, D) in q's dtype; causal
    with offset Sk − Sq. fp32 or bf16, all one dtype; any strides with the
    last dim contiguous (the output takes q's layout). On the card, bf16
    tensors must also be 16-byte aligned with batch/head/seq strides that
    are multiples of 8 elements; others raise (no copy is made). On CUDA
    tensors that require grad it runs ``FlashAttentionFn``."""
    name = "flash_attention"
    route = _check_attention(name, q, k, v)
    if route == "cpu":
        return _fa.plain(q, k, v, causal)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, causal)
    out = torch.empty_like(q)
    if route == "meta":
        cost.record(name, _attention_work(q, k, causal))
        return out
    _fa.launch(q, k, v, out, causal)
    LAUNCHES[name] += 1
    return out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        causal: bool = True
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention``'s output o given its gradient
    ``do`` and the forward's log-sum-exp ``lse`` (fp32 (B, Hq, Sq)); dk
    and dv sum each kv head's group. Same shapes, dtypes and card limits
    as ``flash_attention``; ``do`` is copied to a contiguous tensor when
    the kernel cannot read it in place. One launch (three or four
    kernels), no atomics: the same bits run to run."""
    name = "flash_attention_bwd"
    _require(o.shape == do.shape == q.shape and o.dtype == do.dtype
             == q.dtype, name, "o and do must match q's shape and dtype")
    _require(lse.dtype == torch.float32 and lse.shape == q.shape[:3], name,
             "lse must be fp32 (B, Hq, Sq)")
    route = _check_attention(name, q, k, v)
    if route == "cpu":
        return _fa.plain_bwd(q, k, v, o, lse, do, causal)
    _route(name, q, o, lse, do)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if route == "meta":
        cost.record(name, _attention_work(q, k, causal, bwd=True))
        return dq, dk, dv
    if do.stride(-1) != 1 or (do.dtype == torch.bfloat16
                              and not _fa.aligned(do)):
        do = do.contiguous()
    _require(o.stride(-1) == 1 and lse.is_contiguous(), name,
             "o's last dim and lse must be contiguous")
    _fa.launch_bwd(q, k, v, o, lse, do, dq, dk, dv, causal)
    LAUNCHES[name] += 1
    return dq, dk, dv


def _check_scan(name: str, xdt, dt, a, b, c) -> str:
    """Checks the inputs of the scan kernels; their device type."""
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
    route = _route(name, xdt, dt, a, b, c)
    if route != "cpu":
        _require(1 <= n <= _ms.MAX_STATE, name,
                 f"the kernel takes 1 <= N <= {_ms.MAX_STATE}, not {n}")
    return route


def mamba_scan_chunks(xdt, dt, a, b, c) -> tuple[torch.Tensor, ...]:
    """``mamba_scan`` on the card that also returns the state entering
    each 32-step chunk, (B, ⌈S/32⌉, Di, N) fp32: the checkpoints
    ``mamba_scan_bwd`` recomputes from. CUDA (or ``meta``) tensors
    only."""
    name = "mamba_scan"
    route = _check_scan(name, xdt, dt, a, b, c)
    _require(route != "cpu", name, "mamba_scan_chunks runs on the card only")
    bsz, s, di = xdt.shape
    n = a.shape[1]
    y = torch.empty_like(xdt)
    h_final = torch.empty((bsz, di, n), dtype=torch.float32,
                          device=xdt.device)
    h_chunks = torch.empty((bsz, -(-s // _ms.CHUNK), di, n),
                           dtype=torch.float32, device=xdt.device)
    if route == "meta":
        cost.record(name, cost.mamba_scan(bsz, s, di, n, xdt.dtype,
                                          chunks=True))
        return y, h_final, h_chunks
    _ms.launch(xdt, dt, a, b, c, y, h_final, h_chunks)
    LAUNCHES[name] += 1
    return y, h_final, h_chunks


class MambaScanFn(torch.autograd.Function):
    """``mamba_scan`` on the card with its backward kernel: the forward
    also writes the chunk-boundary states and saves them with its inputs;
    the backward launches ``mamba_scan_bwd``. An unused h_final (as in
    training) has no gradient, which the kernel takes as zero."""

    @staticmethod
    def forward(ctx, xdt, dt, a, b, c):
        y, h_final, h_chunks = mamba_scan_chunks(xdt, dt, a, b, c)
        ctx.save_for_backward(xdt, dt, a, b, c, h_chunks)
        ctx.set_materialize_grads(False)
        return y, h_final

    @staticmethod
    def backward(ctx, dy, dh_final):
        xdt, dt, a, b, c, h_chunks = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(xdt)
        return mamba_scan_bwd(xdt, dt, a, b, c, dy, dh_final, h_chunks)


def mamba_scan(xdt: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, c: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba1 selective scan from h₀ = 0: xdt / dt (B, S, Di), a (Di, N)
    fp32, b / c (B, S, N) → (y (B, S, Di) in xdt's dtype, h_final (B, Di,
    N) fp32). xdt, dt, b, c share fp32 or bf16. On CUDA tensors that
    require grad it runs ``MambaScanFn``."""
    name = "mamba_scan"
    route = _check_scan(name, xdt, dt, a, b, c)
    if route == "cpu":
        return _ms.plain(xdt, dt, a, b, c)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xdt, dt, a, b, c)):
        return MambaScanFn.apply(xdt, dt, a, b, c)
    bsz, s, di = xdt.shape
    y = torch.empty_like(xdt)
    h_final = torch.empty((bsz, di, a.shape[1]), dtype=torch.float32,
                          device=xdt.device)
    if route == "meta":
        cost.record(name, cost.mamba_scan(bsz, s, di, a.shape[1],
                                          xdt.dtype))
        return y, h_final
    _ms.launch(xdt, dt, a, b, c, y, h_final)
    LAUNCHES[name] += 1
    return y, h_final


def mamba_scan_bwd(xdt: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor,
                   dh_final: torch.Tensor | None = None,
                   h_chunks: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, ...]:
    """(dxdt, ddt, da, db, dc) of ``mamba_scan``'s outputs given dy (B, S,
    Di) in xdt's dtype and dh_final (B, Di, N) fp32 or None (zero). On the
    card ``h_chunks`` (from ``mamba_scan_chunks``) is required. One launch
    (the backward kernel and its fixed-order partial sums), no atomics:
    the same bits run to run."""
    name = "mamba_scan_bwd"
    _require(dy.shape == xdt.shape and dy.dtype == xdt.dtype, name,
             "dy must match xdt")
    if dh_final is not None:
        _require(dh_final.dtype == torch.float32 and dh_final.shape ==
                 (xdt.shape[0], xdt.shape[2], a.shape[1]), name,
                 "dh_final must be fp32 (B, Di, N)")
    route = _check_scan(name, xdt, dt, a, b, c)
    if route == "cpu":
        return _ms.plain_bwd(xdt, dt, a, b, c, dy, dh_final)
    _require(h_chunks is not None, name, "the kernel needs h_chunks from "
             "mamba_scan_chunks")
    tensors = (dy, h_chunks) + (() if dh_final is None else (dh_final,))
    _route(name, xdt, *tensors)
    bsz, s, di = xdt.shape
    _typed(name, h_chunks, torch.float32, 4, "h_chunks")
    _require(h_chunks.shape == (bsz, -(-s // _ms.CHUNK), di, a.shape[1]),
             name, "h_chunks must be (B, ceil(S / 32), Di, N)")
    grads = (torch.empty_like(xdt), torch.empty_like(xdt),
             torch.empty_like(a), torch.empty_like(b), torch.empty_like(c))
    if route == "meta":
        cost.record(name, cost.mamba_scan_bwd(bsz, s, di, a.shape[1],
                                              xdt.dtype))
        return grads
    dy = dy.contiguous()
    dh_final = None if dh_final is None else dh_final.contiguous()
    _ms.launch_bwd(xdt, dt, a, b, c, dy, dh_final, h_chunks, grads)
    LAUNCHES[name] += 1
    return grads
