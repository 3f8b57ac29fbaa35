"""The port's batch detection slice as a whole, on the CPU.

``repro_torch``'s ``detect_events(device="cpu")`` must reproduce
tests/golden/batch_detect.json exactly (stats, per-station pair triplets,
recall), as the JAX package does; the alignment stages are held bit-exact
against the reference on the golden's own pairs; the port must refuse to
run without CUDA unless the CPU is asked for, and must import nothing of
JAX or of the JAX package.
"""
import _torch_threads  # noqa: F401  (one torch thread a process)
import dataclasses
import json
import pathlib
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import fast_seismic as j_fast
from repro.core import align as jalign
from repro.core import synth as jsynth
from repro.core.lsh import LSHConfig as JLSHConfig
from repro.core.lsh import Pairs as JPairs
from repro.stream import engine as jengine
from repro.stream import ingest as jingest
from repro.stream.index import StreamIndexConfig as JIndexConfig
from repro_torch import convert as tconvert
from repro_torch import utils as tutils
from repro_torch.configs import fast_seismic as t_fast
from repro_torch.core import align as talign
from repro_torch.core import detect as tdetect
from repro_torch.core import lsh as tlsh
from repro_torch.core import synth as tsynth
from repro_torch.core.fingerprint import FingerprintConfig
from repro_torch.core.lsh import LSHConfig
from repro_torch.stream import engine as tengine
from repro_torch.stream import index as tidx
from repro_torch.stream import ingest as tingest
from repro_torch.stream.index import StreamIndexConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = json.loads((ROOT / "tests" / "golden" / "batch_detect.json")
                    .read_text())


def _cfg():
    """The configuration of tests/test_detect_e2e.py:_cfg."""
    fcfg = FingerprintConfig(img_time=32, img_hop=4, top_k=200,
                             mad_sample_rate=1.0)
    lcfg = LSHConfig(n_tables=100, n_funcs=4, n_matches=2, bucket_cap=8,
                     min_dt=fcfg.overlap_fingerprints, occurrence_frac=0.05)
    acfg = talign.AlignConfig(channel_threshold=3, min_cluster_sim=4,
                              min_cluster_size=1, min_stations=2,
                              onset_tol=int(10 * fcfg.fs / fcfg.lag_samples))
    return tdetect.DetectConfig(fingerprint=fcfg, lsh=lcfg, align=acfg)


@pytest.fixture(scope="module")
def dataset():
    syn = dict(GOLDEN["synth"])
    syn["repeating_noise_stations"] = tuple(syn["repeating_noise_stations"])
    return tsynth.make_dataset(tsynth.SynthConfig(**syn))


@pytest.fixture(scope="module")
def golden_run(dataset):
    return tdetect.detect_events(dataset.waveforms, _cfg(), keep_pairs=True,
                                 device="cpu")


def _triplets(p) -> list:
    v = p.valid.cpu().numpy()
    return sorted(zip(p.idx1.cpu().numpy()[v].tolist(),
                      p.idx2.cpu().numpy()[v].tolist(),
                      p.sim.cpu().numpy()[v].tolist()))


def test_detect_events_reproduces_batch_golden(dataset, golden_run):
    det, events, times, stats = golden_run
    stats = dict(stats)
    pairs = stats.pop("_station_pairs")
    qc = {k: stats.pop(k) for k in list(stats)
          if k == "drops" or k.endswith("_qc")}
    assert qc["drops"]["pairs_emitted"] > 0
    assert stats == GOLDEN["stats"]
    assert tdetect.recall_against_truth(det, events, dataset,
                                        _cfg().fingerprint) == \
        GOLDEN["recall"]
    for st, p in enumerate(pairs):
        assert _triplets(p) == [tuple(t) for t in GOLDEN["station_pairs"][st]]
    assert times.fused_step_s > 0
    assert times.total() >= times.fused_step_s


@pytest.mark.parametrize("dur,seed", [(420.0, 3), (300.0, 11)])
def test_synth_matches_reference(dur, seed):
    kw = dict(duration_s=dur, n_stations=3, n_sources=2, events_per_source=3,
              repeating_noise_stations=(0,), hum_stations=(2,), seed=seed)
    got = tsynth.make_dataset(tsynth.SynthConfig(**kw))
    want = jsynth.make_dataset(jsynth.SynthConfig(**kw))
    for name in ("waveforms", "event_times", "event_sources",
                 "arrival_delays"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


def _jpairs(p) -> JPairs:
    return JPairs(*(jnp.asarray(getattr(p, f).numpy())
                    for f in ("idx1", "idx2", "sim", "valid")))


def _same(port, ref) -> None:
    np.testing.assert_array_equal(port.cpu().numpy(), np.asarray(ref))


def test_merge_channels_bit_exact(golden_run):
    pairs = golden_run[3]["_station_pairs"]
    chans = [(p.dt, p.idx1, p.sim, p.valid) for p in pairs[:2]]
    got = talign.merge_channels(chans, 3)
    want = jalign.merge_channels(
        [tuple(jnp.asarray(x.numpy()) for x in c) for c in chans], 3)
    for f in ("idx1", "idx2", "sim", "valid"):
        _same(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("station", [0, 1, 2])
def test_cluster_station_bit_exact(golden_run, station):
    acfg = _cfg().align
    jcfg = jalign.AlignConfig(**dataclasses.asdict(acfg))
    p = golden_run[3]["_station_pairs"][station]
    merged = talign.merge_channels([(p.dt, p.idx1, p.sim, p.valid)], 3)
    got = talign.cluster_station(merged, acfg)
    want = jalign.cluster_station(_jpairs(merged), jcfg)
    for f in ("dt", "onset", "extent", "size", "score", "valid"):
        _same(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("max_group_extent", [0, 4])
def test_associate_network_bit_exact(golden_run, max_group_extent):
    acfg = dataclasses.replace(_cfg().align,
                               max_group_extent=max_group_extent)
    jcfg = jalign.AlignConfig(**dataclasses.asdict(acfg))
    events = golden_run[1]
    got = talign.associate_network(events, acfg, len(events))
    want = jalign.associate_network(
        [jalign.Events(*(jnp.asarray(getattr(e, f).numpy()) for f in
                         ("dt", "onset", "extent", "size", "score", "valid")))
         for e in events], jcfg, len(events))
    assert set(got) == set(want)
    for k in want:
        _same(got[k], want[k])


@pytest.mark.parametrize("base,limit", [(0, None), (100, 2)])
def test_host_occurrence_filter_bit_exact(rng, base, limit):
    tri = np.stack([rng.integers(base, base + 60, 300),
                    rng.integers(base + 60, base + 120, 300),
                    rng.integers(2, 9, 300)], axis=1)
    tri[:40, 0] = base + 5                        # one hot fingerprint
    jl, tl = JLSHConfig(occurrence_frac=0.05), LSHConfig(occurrence_frac=0.05)
    got, gex = tengine.host_occurrence_filter(
        tengine.pairs_from_triplets(tri, pad_to=256, device="cpu"), 120, tl, base=base,
        limit=limit)
    want, wex = jengine.host_occurrence_filter(
        jengine.pairs_from_triplets(tri, pad_to=256), 120, jl, base=base,
        limit=limit)
    for f in ("idx1", "idx2", "sim", "valid"):
        _same(getattr(got, f), getattr(want, f))
    _same(gex, wex)


def test_replay_knobs_keep_the_pair_set(dataset, golden_run):
    """A never-firing occurrence limiter, and emission compaction with the
    exact-Jaccard verify, leave the batch result unchanged."""
    cfg = _cfg()
    n_fp = cfg.fingerprint.n_fingerprints(dataset.waveforms.shape[1])
    base = tdetect.replay_config(cfg.lsh)
    knobbed = dataclasses.replace(
        base, occ_limit=10_000, max_pairs_per_block=4096,
        verify_jaccard=True,
        index=dataclasses.replace(base.index, occ_slots=n_fp, pk_slots=n_fp))
    _, _, _, stats = tdetect.detect_events(dataset.waveforms, cfg,
                                           scfg=knobbed, device="cpu")
    ref = {k: v for k, v in golden_run[3].items() if k != "_station_pairs"}
    assert stats == ref


def test_no_silent_cpu_fallback(monkeypatch, dataset):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdetect.detect_events(dataset.waveforms, _cfg())
    with pytest.raises(RuntimeError):
        tutils.resolve_device("cuda")
    assert tutils.resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("build", [
    lambda d: tlsh.hash_mappings(64, LSHConfig(n_tables=4), **d),
    lambda d: tlsh.bucket_salts(4, 1, **d),
    lambda d: tidx.init_index(LSHConfig(n_tables=4),
                              StreamIndexConfig(n_buckets=16), **d),
    lambda d: tengine.pairs_from_triplets(np.zeros((2, 3)), **d),
    lambda d: tconvert.med_mad(np.zeros(3), np.ones(3), **d),
], ids=["hash_mappings", "bucket_salts", "init_index", "pairs_from_triplets",
        "convert"])
def test_constructors_default_to_cuda(monkeypatch, build):
    """State built with the defaults lives on the card, so the block-level
    API (init_index -> init_pool_state -> pool_step_block) cannot slip onto
    the plain versions: without CUDA the default raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build({})
    out = build({"device": "cpu"})
    leaves = (out if isinstance(out, tuple) else
              [getattr(out, f.name) for f in dataclasses.fields(out)]
              if dataclasses.is_dataclass(out) else [out])
    assert all(t.device.type == "cpu" for t in leaves)


def test_configs_match_reference():
    for jf, tf in ((j_fast.config, t_fast.config),
                   (j_fast.smoke_config, t_fast.smoke_config)):
        j, t = jf(), tf()
        for part in ("fingerprint", "lsh", "align"):
            assert dataclasses.asdict(getattr(j, part)) == \
                dataclasses.asdict(getattr(t, part)), part


@pytest.mark.parametrize("kw", [
    {}, dict(verify_jaccard=True, max_pairs_per_block=64,
             index=dict(pk_slots=128)),
    dict(occ_limit=5), dict(verify_jaccard=True),
    dict(window_fingerprints=8, block_fingerprints=16),
    dict(verify_min_jaccard=0.5), dict(verify_pallas=True),
])
def test_stream_config_validation_matches(kw):
    def build(mod, icls):
        k = dict(kw)
        if "index" in k:
            k["index"] = icls(**k["index"])
        return mod.StreamConfig(**k)
    outcomes = []
    for mod, icls in ((jingest, JIndexConfig), (tingest, StreamIndexConfig)):
        try:
            c = build(mod, icls)
            outcomes.append((c.verify_code,
                             dataclasses.asdict(c.effective_index(1024))))
        except ValueError:
            outcomes.append("ValueError")
    assert outcomes[0] == outcomes[1]


def test_port_imports_nothing_of_jax():
    code = ("import sys; sys.path.insert(0, 'src'); sys.path.insert(0, '.');"
            "import chip_smoke, repro_torch.convert, repro_torch.core,"
            "repro_torch.configs.fast_seismic, repro_torch.stream.fused,"
            "repro_torch.stream.engine, repro_torch.obsv,"
            "repro_torch.data.dedup, repro_torch.core.theory,"
            "repro_torch.launch.serve, repro_torch.configs.qwen25_14b,"
            "repro_torch.configs.falcon_mamba_7b;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); assert not bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_a_card(tmp_path, alone):
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    cwd = tmp_path if alone else ROOT
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
