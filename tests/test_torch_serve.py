"""The port's ``ServeEngine`` on the CPU against ``repro.launch.serve``'s,
on the fp32 variants of the launcher's smoke model and every LM arch's
smoke config, with the JAX engine's own parameters converted by
``convert.lm_params``: per-request token lists identical, ``ticks`` and
``generated`` equal.

Few requests (4), 2 slots and 6 new tokens, because the reference
compiles prefill anew for every request. Prompts are 4–16 tokens: the
reference's prefill needs a length that is at most, or a multiple of, its
attention block (32 in the smoke configs) and scan chunk (16 in the
falcon-mamba and zamba2 smoke configs).
"""
import _torch_threads  # noqa: F401  (one torch thread a process)
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import LM_ARCHS, get_smoke_config
from repro.launch.serve import Request as JRequest
from repro.launch.serve import ServeEngine as JServeEngine
from repro.launch.train import default_smoke_model
from repro_torch import convert
from repro_torch.launch import serve
from repro_torch.models.config import ModelConfig


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32",
                               cache_dtype="float32")


@pytest.mark.parametrize("arch", ["smoke", *LM_ARCHS])
def test_serve_engine_tokens_equal_reference(arch):
    jcfg = default_smoke_model() if arch == "smoke" else _f32(
        get_smoke_config(arch))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, jcfg.vocab_size, int(rng.integers(4, 17)))
               .astype(np.int32) for _ in range(4)]
    jeng = JServeEngine(jcfg, n_slots=2, max_len=64)
    jreqs = [JRequest(i, p, 6) for i, p in enumerate(prompts)]
    jstats = jeng.run(jreqs)
    eng = serve.ServeEngine(
        ModelConfig(**dataclasses.asdict(jcfg)), n_slots=2, max_len=64,
        params=convert.lm_params(jax.device_get(jeng.params), device="cpu"))
    reqs = [serve.Request(i, p, 6) for i, p in enumerate(prompts)]
    stats = eng.run(reqs)
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    assert all(r.done for r in reqs) and all(len(r.out) == 7 for r in reqs)
    assert (stats["ticks"], stats["generated"]) == (jstats["ticks"],
                                                    jstats["generated"])


def test_serve_main_on_the_cpu(capsys):
    stats = serve.main(["--arch", "falcon-mamba-7b", "--requests", "3",
                        "--slots", "2", "--max-new", "4", "--device",
                        "cpu"])
    assert stats["requests"] == 3 and stats["generated"] == 12
    assert "RESULT " in capsys.readouterr().out


def test_serve_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(serve.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.ServeEngine(serve.default_smoke_model())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--requests", "1"])
