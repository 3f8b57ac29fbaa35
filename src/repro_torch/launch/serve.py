"""Batched serving engine: static decode slots + continuous refill.

The counterpart of ``repro.launch.serve``: requests queue up, prefill
fills empty slots one sequence at a time, one decode step advances all
slots each tick, and finished sequences (max tokens or a full cache) are
evicted and replaced. Per-slot positions live in the decode cache's
``pos`` vector. Every LM architecture of the registry serves; prefill
goes through the ``flash_attention`` kernel once per attention layer (the
hybrid's shared blocks included) and ``mamba_scan`` once per Mamba1
layer, per request, on the card. Requests carry tokens only, as the
reference's engine takes them (the patch frontend's ``patch_embeds`` go
through ``models.prefill`` / ``forward``).

Usage (the card by default; ``--device cpu`` runs the plain versions;
``--arch`` takes the arch's smoke config):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smoke --requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b \
      --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import utils
from repro_torch.configs import LM_ARCHS, get_smoke_config
from repro_torch.models import (ModelConfig, decode_step, init_cache,
                                init_params, prefill)
from repro_torch.models.decoder import SEQ_CACHES


def default_smoke_model() -> ModelConfig:
    """The reference's ``launch.train.default_smoke_model``."""
    return ModelConfig(name="smoke", n_layers=2, d_model=128, n_heads=4,
                       n_kv_heads=2, d_ff=256, vocab_size=512,
                       attn_q_block=64, attn_kv_block=64, loss_seq_chunk=64,
                       param_dtype="float32", compute_dtype="float32",
                       remat="none")


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: list = field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Static-batch continuous serving over ``n_slots`` decode lanes.

    ``params`` (the nested dict of ``models.init_params`` or
    ``convert.lm_params``) defaults to ``init_params(cfg, seed)`` on
    ``device``; the engine runs where its parameters lie."""

    def __init__(self, cfg: ModelConfig, n_slots: int = 4,
                 max_len: int = 256, seed: int = 0, device=None,
                 params: dict | None = None):
        cfg = dataclasses.replace(cfg, uniform_decode_pos=False)
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        if params is None:
            params = init_params(cfg, seed, device)
        self.params = params
        self.device = params["embed"].device
        self.cache = init_cache(cfg, n_slots, max_len, self.device)
        self.slot_req: list[Request | None] = [None] * n_slots
        self.slot_limit = np.zeros(n_slots, np.int64)
        self.cur_tokens = np.zeros((n_slots, 1), np.int32)
        self.ticks = 0
        self.generated = 0
        self.prefill_s = 0.0

    def _prefill_slot(self, slot: int, req: Request):
        """Single-sequence prefill → copy KV/state into the slot: the
        sequence caches (``SEQ_CACHES``) into its first S positions with
        zeros after them, the SSM states whole."""
        t0 = time.perf_counter()
        toks = torch.as_tensor(req.prompt[None, :].astype(np.int32),
                               device=self.device)
        logits, cache1 = prefill(self.params, {"tokens": toks}, self.cfg)
        s = req.prompt.shape[0]
        for k, dst in self.cache.items():
            if k == "pos":
                dst[slot] = s
            elif k in SEQ_CACHES:          # (L, B, max_len, Hkv, hd)
                dst[:, slot, :s] = cache1[k][:, 0]
                dst[:, slot, s:] = 0
            else:                          # conv / ssm states
                dst[:, slot] = cache1[k][:, 0]
        nxt = int(torch.argmax(logits[0]))
        self.prefill_s += time.perf_counter() - t0
        self.cur_tokens[slot, 0] = nxt
        req.out.append(nxt)
        self.slot_req[slot] = req
        self.slot_limit[slot] = s + req.max_new

    def run(self, requests: list[Request]) -> dict:
        queue = list(requests)
        active = lambda: any(r is not None for r in self.slot_req)
        t0 = time.perf_counter()
        while queue or active():
            # refill empty slots
            for slot in range(self.n_slots):
                if self.slot_req[slot] is None and queue:
                    self._prefill_slot(slot, queue.pop(0))
            # one decode tick for all slots
            logits, self.cache = decode_step(
                self.params, self.cache,
                torch.as_tensor(self.cur_tokens, device=self.device),
                self.cfg)
            self.ticks += 1
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()
            pos = self.cache["pos"].cpu().numpy()
            for slot in range(self.n_slots):
                req = self.slot_req[slot]
                if req is None:
                    continue
                tok = int(nxt[slot])
                req.out.append(tok)
                self.generated += 1
                if pos[slot] >= min(self.slot_limit[slot],
                                    self.max_len - 1):
                    req.done = True
                    self.slot_req[slot] = None
                else:
                    self.cur_tokens[slot, 0] = tok
        dt = time.perf_counter() - t0
        return {"requests": len(requests), "ticks": self.ticks,
                "generated": self.generated, "wall_s": round(dt, 3),
                "prefill_s": round(self.prefill_s, 3),
                "tokens_per_s": round(self.generated / max(dt, 1e-9), 1)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smoke",
                    help=f"'smoke' or one of {LM_ARCHS} (its smoke config)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = default_smoke_model() if args.arch == "smoke" \
        else get_smoke_config(args.arch)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(
                        1, cfg.vocab_size,
                        size=rng.integers(4, args.prompt_len)).astype(
                            np.int32),
                    max_new=args.max_new)
            for i in range(args.requests)]
    eng = ServeEngine(cfg, n_slots=args.slots, max_len=args.max_len,
                      device=utils.resolve_device(args.device))
    stats = eng.run(reqs)
    if not all(r.done for r in reqs):
        raise RuntimeError("serve: a request was left unfinished")
    print("RESULT " + json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
