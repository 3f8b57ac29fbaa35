"""Training launcher: data pipeline → train step → checkpoint / restart.

The counterpart of ``repro.launch.train``, on one device (the card unless
``--device cpu``). Fault-tolerance contract:
  * checkpoints are atomic and include the data-iterator state;
  * ``--resume`` continues from the latest checkpoint, bit-exact against
    an uninterrupted run (the backward kernels have no atomics, and the
    launcher fixes cuBLAS's workspace so its products repeat);
  * ``--inject-failure-at N`` kills the process (``os._exit(42)``) after
    step N and before its checkpoint, as a node failure would; a later
    ``--resume`` run finishes;
  * the step watchdog flags stragglers and hangs.
Each step's loss, lr and grad norm are read back once, after the step.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smoke --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-14b \
      --smoke --steps 50 --ckpt-dir ckpt --resume
"""
from __future__ import annotations

import argparse
import json
import os

# cuBLAS picks its reduction order per workspace: fix the workspace so a
# resumed run repeats the uninterrupted run's products bit for bit (set
# before CUDA starts)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

from repro_torch import utils  # noqa: E402
from repro_torch.configs import (LM_ARCHS, get_config,  # noqa: E402
                                 get_smoke_config)
from repro_torch.data.pipeline import (DataConfig, IteratorState,  # noqa: E402
                                       TokenPipeline)
from repro_torch.launch.serve import default_smoke_model  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.loop import (init_train_state,  # noqa: E402
                                    make_train_step)
from repro_torch.train.optimizer import OptimizerConfig  # noqa: E402
from repro_torch.train.watchdog import StepWatchdog  # noqa: E402


def build_model_config(args) -> ModelConfig:
    if args.arch == "smoke":
        return default_smoke_model()
    return get_smoke_config(args.arch) if args.smoke else \
        get_config(args.arch)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smoke",
                    help=f"'smoke' or one of {LM_ARCHS}")
    ap.add_argument("--smoke", action="store_true",
                    help="use the arch's reduced smoke config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--inject-failure-at", type=int, default=-1)
    ap.add_argument("--no-dedup", action="store_true")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = utils.resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    cfg = build_model_config(args)
    opt_cfg = OptimizerConfig(lr=args.lr,
                              warmup_steps=max(2, args.steps // 10),
                              total_steps=args.steps,
                              accum_dtype="float32")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed,
                      dedup=not args.no_dedup)

    start_step = 0
    extra: dict = {}
    state = init_train_state(cfg, args.seed, dev)
    if args.resume and args.ckpt_dir and \
            ckpt.latest_step(args.ckpt_dir) is not None:
        state, extra = ckpt.restore_checkpoint(args.ckpt_dir, state)
        start_step = int(extra.get("step", 0))
        print(f"resumed from step {start_step}")

    it_state = IteratorState.from_dict(extra["iterator"]) \
        if "iterator" in extra else None
    pipe = TokenPipeline(dcfg, state=it_state, device=dev)
    batches = pipe.batches()
    step_fn = make_train_step(cfg, opt_cfg,
                              n_microbatches=args.microbatches)
    wd = StepWatchdog(on_straggler=lambda info: print(
        f"[watchdog] {json.dumps(info)}"))

    losses = []
    for step in range(start_step, args.steps):
        raw = next(batches)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
        wd.step_start()
        state, metrics = step_fn(state, batch)
        loss, lr, gnorm = (float(x) for x in torch.stack(
            [metrics["loss"], metrics["lr"], metrics["grad_norm"]]).cpu())
        wd.step_end()
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} lr {lr:.2e} "
                  f"gnorm {gnorm:.3f} "
                  f"dedup_dropped {pipe.dedup_stats['dropped']}")
        if args.inject_failure_at == step:
            # die before this step's checkpoint: the restart loses it
            print(f"[failure-injection] dying at step {step}", flush=True)
            os._exit(42)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save_checkpoint(
                args.ckpt_dir, step + 1, state,
                extra={"step": step + 1, "iterator": pipe.state.to_dict()})

    if args.ckpt_dir:
        ckpt.save_checkpoint(args.ckpt_dir, args.steps, state,
                             extra={"step": args.steps,
                                    "iterator": pipe.state.to_dict()})
    result = {"final_loss": losses[-1] if losses else None,
              "first_loss": losses[0] if losses else None,
              "steps_run": len(losses),
              "dedup": pipe.dedup_stats,
              "straggler_events": len(wd.events)}
    print("RESULT " + json.dumps(result))
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(result, f)
    return result


if __name__ == "__main__":
    main()
