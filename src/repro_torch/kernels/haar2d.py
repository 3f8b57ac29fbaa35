"""Standard-decomposition 2-D Haar transform, Z = T_H · X · T_Wᵀ per image.

The CUDA kernel (``csrc/haar2d.cu``) replaces the Pallas kernel
``repro/kernels/haar2d.py:haar2d``. ``plain`` is the PyTorch version of
the same two dense products, in the reference kernel's order (rows, then
columns); ``kernels.ops.haar2d`` picks between them by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


def plain(imgs: torch.Tensor, th: torch.Tensor,
          tw: torch.Tensor) -> torch.Tensor:
    """imgs (N, H, W), th (H, H), tw (W, W) → (N, H, W)."""
    y = torch.matmul(imgs, tw.T)
    return torch.matmul(th, y)


def launch(imgs: torch.Tensor, th: torch.Tensor, tw_t: torch.Tensor,
           out: torch.Tensor) -> None:
    """Launch the CUDA kernel; ``tw_t`` is T_Wᵀ, contiguous."""
    lib = _build.load("haar2d")
    fn = lib.haar2d_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    n, h, w = imgs.shape
    rc = fn(imgs.data_ptr(), n, h, w, th.data_ptr(), tw_t.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(imgs.device).cuda_stream)
    _build.check(rc, "haar2d")
