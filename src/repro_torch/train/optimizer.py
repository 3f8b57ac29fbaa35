"""AdamW with mixed precision, on one device.

The counterpart of ``repro.train.optimizer``: parameters live in
``param_dtype`` (bf16 in production); the optimizer state carries an fp32
master copy and fp32 moments. The math is the reference's, in fp32 on the
parameters' device, with the step count held as a device tensor so that no
step reads a value back to the host. The update runs leaf by leaf and in
place, in slices of ``UPDATE_SLICE`` elements, so its transient memory is
a few slices and not a copy of the tree (qwen2.5-14b's head alone is 786 M
parameters). The ZeRO sharding rules (``zero_sharding_entry``,
``opt_state_sharding_rules``) are multi-device and wait for ROADMAP queue 1
item 3.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.utils import tree_leaves, tree_map

# elements of a leaf updated together: 64 MB of fp32 a temporary
UPDATE_SLICE = 1 << 24


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    accum_dtype: str = "bfloat16"   # gradient-accumulation dtype


def schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to min_lr_frac·lr (fp32, on step's
    device)."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def init_opt_state(params: dict) -> dict:
    """fp32 master (a copy, also of fp32 parameters), zero fp32 moments and
    a 0-d int32 step, on the parameters' device."""
    with torch.no_grad():
        master = tree_map(lambda x: x.detach().to(torch.float32, copy=True),
                          params)
        zeros = lambda: tree_map(  # noqa: E731
            lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                  device=x.device), params)
        device = next(tree_leaves(params))[1].device
        return {"master": master, "m": zeros(), "v": zeros(),
                "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: dict) -> torch.Tensor:
    """√(Σ leaf²) over the leaves in fp32, summed leaf by leaf in the
    reference's order."""
    total = None
    for _, x in tree_leaves(tree):
        sq = torch.linalg.vector_norm(x, dtype=torch.float32).square()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def apply_updates(params: dict, grads: dict, opt_state: dict,
                  cfg: OptimizerConfig) -> tuple[dict, dict, dict]:
    """One AdamW step; grads in any dtype, math in fp32. Updates the
    parameters, master copy and moments in place (the reference returns
    new trees) and returns (params, state with step + 1, {"lr",
    "grad_norm"} as 0-d device tensors)."""
    with torch.no_grad():
        step = opt_state["step"] + 1
        lr = schedule(cfg, step)
        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
        b1, b2 = cfg.beta1, cfg.beta2
        stepf = step.float()
        c1 = 1 - torch.pow(b1, stepf)
        c2 = 1 - torch.pow(b2, stepf)
        state = zip(*(tree_leaves(t) for t in (
            grads, opt_state["m"], opt_state["v"], opt_state["master"],
            params)))
        for (_, g), (_, m), (_, v), (_, master), (_, p) in state:
            flat = [g.reshape(-1)] + [t.view(-1) for t in (m, v, master, p)]
            for lo in range(0, g.numel(), UPDATE_SLICE):
                gs, ms, vs, ws, ps = (t[lo: lo + UPDATE_SLICE] for t in flat)
                gf = gs.float() * scale
                m_new = b1 * ms + (1 - b1) * gf
                v_new = b2 * vs + (1 - b2) * gf * gf
                delta = (m_new / c1) / (torch.sqrt(v_new / c2) + cfg.eps) \
                    + cfg.weight_decay * ws
                w_new = ws - lr * delta
                ms.copy_(m_new)
                vs.copy_(v_new)
                ws.copy_(w_new)
                ps.copy_(w_new)
        new_state = dict(opt_state, step=step)
        return params, new_state, {"lr": lr, "grad_norm": gnorm}
