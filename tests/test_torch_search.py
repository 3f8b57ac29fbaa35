"""repro_torch's offline Min-Max LSH search against the JAX package on the
CPU: the raw Min-Max planes (``ops.minmax_hash``'s plain version against
the reference's jnp oracle and its Pallas kernel in interpret mode), the
signature fold, the sort-based candidate pairs fed the reference's own
signatures, ``bucket_stats``, ``search`` and ``partitioned_search`` (every
array and every statistic), exact verify, the §6.3 theory, the offline
golden of ``tests/golden/stream_pairs.json`` and the paper widths on a
20-minute trace. Integer results are bit-exact and float statistics equal
(tolerance 0: the same float32 divisions).
"""
import _torch_threads  # noqa: F401  (one torch thread a process)
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import fast_seismic as j_fast
from repro.core import fingerprint as jfp
from repro.core import lsh as jlsh
from repro.core import synth as jsynth
from repro.core import theory as jtheory
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.utils import pack_bits as j_pack_bits
from repro_torch import convert
from repro_torch import utils as tu
from repro_torch.configs import fast_seismic as t_fast
from repro_torch.core import fingerprint as tfp
from repro_torch.core import lsh as tlsh
from repro_torch.core import synth as tsynth
from repro_torch.core import theory as ttheory
from repro_torch.kernels import ops

ROOT = pathlib.Path(__file__).resolve().parents[1]
LKW = dict(n_tables=50, n_funcs=4, n_matches=2, bucket_cap=8, min_dt=1,
           occurrence_frac=0.0)
PAPER_SYNTH = dict(duration_s=1200.0, n_stations=1, n_sources=2,
                   events_per_source=4, repeating_noise_stations=(0,),
                   event_snr=6.0, seed=5)


def make_planted(rng, n=96, d=512, n_bits=40, n_pairs=8, overlap=0.9):
    """Random sparse fingerprints + planted near-duplicate pairs (the
    inputs of tests/test_lsh.py)."""
    fp = np.zeros((n, d), bool)
    for i in range(n):
        fp[i, rng.choice(d, n_bits, replace=False)] = True
    for p in range(n_pairs):
        i, j = 2 * p, n - 1 - 2 * p
        fp[j] = fp[i].copy()
        flip = rng.choice(d, int(n_bits * (1 - overlap) * 2), replace=False)
        fp[j, flip] = ~fp[j, flip]
    return fp


def make_hub(rng, n=80, d=512, nb=40):
    """40 near-identical 'repeating noise' rows, then clean rows with one
    planted pair (tests/test_lsh.py's occurrence-filter input)."""
    fp = np.zeros((n, d), bool)
    hub = rng.choice(d, nb, replace=False)
    for i in range(40):
        fp[i, hub] = True
        fp[i, rng.choice(d, 3)] = True
    for i in range(40, n):
        fp[i, rng.choice(d, nb, replace=False)] = True
    fp[n - 1] = fp[40].copy()
    return fp


def make_mega(rng, n=72, d=256):
    """Planted rows plus a run of 20 identical rows: buckets larger than
    the rank window, where the tie order decides which pairs exist."""
    fp = make_planted(rng, n=n, d=d, n_bits=30)
    fp[10:30] = fp[10]
    fp[3] = False                                  # an empty row
    return fp


INPUTS = {"planted": make_planted, "hub": make_hub, "mega": make_mega}


def _cfgs(**kw):
    kw = dict(LKW, **kw)
    return jlsh.LSHConfig(**kw), tlsh.LSHConfig(**kw)


def _packed(bits: np.ndarray) -> torch.Tensor:
    return tu.pack_bits(torch.from_numpy(np.ascontiguousarray(bits)))


def _eq(port: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    got = port.cpu().numpy()
    if ref.dtype == np.uint32:
        got = got.view(np.uint32)
    np.testing.assert_array_equal(got, ref)


def _pairs_eq(port, ref) -> None:
    for f in ("idx1", "idx2", "sim", "valid"):
        _eq(getattr(port, f), getattr(ref, f))


def _stats_eq(port: dict, ref: dict) -> None:
    assert port.keys() == ref.keys()
    for k, v in ref.items():
        want = np.asarray(v)
        got = np.asarray(port[k].cpu() if isinstance(port[k], torch.Tensor)
                         else port[k])
        assert got.dtype.kind == want.dtype.kind, k
        np.testing.assert_array_equal(got, want, err_msg=k)


def _valid_set(blocks) -> set:
    out = set()
    for p in blocks:
        v = np.asarray(p.valid)
        out |= set(zip(np.asarray(p.idx1)[v].tolist(),
                       np.asarray(p.idx2)[v].tolist()))
    return out


# ---------------------------------------------------------------------------
# the raw Min-Max planes and signatures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_minmax", [True, False],
                         ids=["H=t*f", "H=t*k"])
def test_minmax_hash_matches_reference_and_pallas(rng, use_minmax):
    bits = rng.random((21, 512)) < 0.08
    bits[[0, 7]] = False                           # empty rows
    jcfg, _ = _cfgs(use_minmax=use_minmax)
    mappings = np.array(jlsh.hash_mappings(512, jcfg))
    assert mappings.shape[1] == 50 * (2 if use_minmax else 4)
    ops.reset_launches()
    mins, maxs = ops.minmax_hash(_packed(bits), torch.from_numpy(mappings))
    assert ops.LAUNCHES["minmax_hash"] == 0
    for jm, jx in (jref.minmax_hash(jnp.asarray(bits), jnp.asarray(mappings)),
                   jops.minmax_hash(jnp.asarray(bits), jnp.asarray(mappings),
                                    use_pallas=True)):
        _eq(mins, jm)
        _eq(maxs, jx)
    assert (mins[0] == 2**31 - 1).all() and (maxs[0] == 0).all()


@pytest.mark.parametrize("use_minmax", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_signatures_match_reference_and_fused_kernel(rng, use_minmax,
                                                     masked):
    bits = make_mega(rng)
    jcfg, tcfg = _cfgs(use_minmax=use_minmax)
    mp = jlsh.hash_mappings(bits.shape[1], jcfg)
    valid = np.arange(bits.shape[0]) % 5 != 2 if masked else None
    want = jlsh.signatures(jnp.asarray(bits), mp, jcfg,
                           valid=None if valid is None else jnp.asarray(valid))
    tmp = torch.from_numpy(np.array(mp))
    tv = None if valid is None else torch.from_numpy(valid)
    got = tlsh.signatures(_packed(bits), tmp, tcfg, valid=tv)
    _eq(got, want)
    fused = tlsh.signatures_and_buckets(_packed(bits), tmp, tcfg, 1024, tv)[0]
    assert torch.equal(got, fused)


def test_minhash_baseline_bit_exact(rng):
    bits = make_planted(rng, n=40)
    jcfg, tcfg = _cfgs()
    _eq(tlsh.minhash_signatures_baseline(_packed(bits), tcfg),
        jlsh.minhash_signatures_baseline(jnp.asarray(bits), jcfg))


# ---------------------------------------------------------------------------
# candidate pairs and skew statistics, from the reference's signatures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("cap,min_dt", [(8, 1), (3, 5)])
def test_candidate_pairs_from_reference_signatures(name, cap, min_dt):
    bits = INPUTS[name](np.random.default_rng(7))
    jcfg, tcfg = _cfgs(bucket_cap=cap, min_dt=min_dt)
    sigs = jlsh.signatures(jnp.asarray(bits),
                           jlsh.hash_mappings(bits.shape[1], jcfg), jcfg)
    want = jlsh.candidate_pairs(sigs, jcfg)
    got = tlsh.candidate_pairs(convert.signatures(np.asarray(sigs), "cpu"),
                               tcfg)
    _pairs_eq(got, want)
    assert int(got.count()) > 0


@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("n_funcs", [2, 4])
def test_bucket_stats_equal(name, n_funcs):
    bits = INPUTS[name](np.random.default_rng(11))
    jcfg = jlsh.LSHConfig(n_tables=20, n_funcs=n_funcs, n_matches=1)
    sigs = jlsh.signatures(jnp.asarray(bits),
                           jlsh.hash_mappings(bits.shape[1], jcfg), jcfg)
    got = tlsh.bucket_stats(convert.signatures(np.asarray(sigs), "cpu"))
    want = jlsh.bucket_stats(sigs)
    assert got["selectivity"].dtype == torch.float32
    assert got["avg_lookups_per_query"].dtype == torch.float32
    _stats_eq(got, want)


def test_convert_signatures_keeps_the_bit_pattern():
    u = np.array([[0, 1, 2**31, 2**32 - 1]], np.uint32)
    t = convert.signatures(u, "cpu")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy().view(np.uint32), u)


# ---------------------------------------------------------------------------
# search and partitioned search
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,frac,masked", [
    ("planted", 0.0, False), ("planted", 0.0, True), ("hub", 0.2, False),
    ("mega", 0.1, False), ("mega", 0.1, True)])
def test_search_equals_reference(name, frac, masked):
    bits = INPUTS[name](np.random.default_rng(0))
    jcfg, tcfg = _cfgs(occurrence_frac=frac)
    valid = (np.arange(bits.shape[0]) % 7 != 5) if masked else None
    want, wstats = jlsh.search(jnp.asarray(bits), jcfg,
                               None if valid is None else jnp.asarray(valid))
    got, gstats = tlsh.search(_packed(bits), tcfg,
                              None if valid is None
                              else torch.from_numpy(valid))
    _pairs_eq(got, want)
    _stats_eq(gstats, wstats)
    assert int(gstats["pairs"]) > 0
    if name == "hub":
        assert int(gstats["excluded_fingerprints"]) >= 40


@pytest.mark.parametrize("n_partitions", [2, 4])
def test_partitioned_search_blocks_equal(rng, n_partitions):
    bits = make_planted(rng, n=64)
    jcfg, tcfg = _cfgs()
    want, wstats = jlsh.partitioned_search(jnp.asarray(bits), jcfg,
                                           n_partitions)
    got, gstats = tlsh.partitioned_search(_packed(bits), tcfg, n_partitions)
    assert gstats == wstats and len(got) == len(want)
    fields = ("idx1", "idx2", "sim", "valid")
    want_t = convert.pairs_list(
        [{f: np.asarray(getattr(w, f)) for f in fields} for w in want], "cpu")
    for g, w in zip(got, want_t):
        assert all(torch.equal(getattr(g, f), getattr(w, f)) for f in fields)
    assert _valid_set(got) == _valid_set(
        [tlsh.search(_packed(bits), tcfg)[0]])


def test_partitioned_search_reproduces_the_cross_block_min_dt_quirk(rng):
    """The reference applies ``min_dt`` to a cross block's local ids as well
    as to the global ids: rows 3 and 35 (identical, global distance 32)
    meet in block (0, 2) at local ids 3 and 19, distance 16 < min_dt 20,
    so both packages drop the pair there although the global search keeps
    it."""
    bits = make_planted(rng, n=64, n_pairs=0)
    bits[35] = bits[3]
    jcfg, tcfg = _cfgs(min_dt=20)
    want, _ = jlsh.partitioned_search(jnp.asarray(bits), jcfg, 4)
    got, _ = tlsh.partitioned_search(_packed(bits), tcfg, 4)
    for g, w in zip(got, want):
        _pairs_eq(g, w)
    assert (3, 35) in _valid_set([tlsh.search(_packed(bits), tcfg)[0]])
    assert (3, 35) in _valid_set([jlsh.search(jnp.asarray(bits), jcfg)[0]])
    assert (3, 35) not in _valid_set(got)
    assert (3, 35) not in _valid_set(want)


def test_partitioned_search_needs_equal_partitions(rng):
    with pytest.raises(ValueError):
        tlsh.partitioned_search(_packed(make_planted(rng, n=30)),
                                _cfgs()[1], 4)


# ---------------------------------------------------------------------------
# exact verify, the brute-force oracle, the theory
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_verify_jaccard_equals_reference(name):
    bits = INPUTS[name](np.random.default_rng(1))
    jcfg, tcfg = _cfgs()
    want_pairs, _ = jlsh.search(jnp.asarray(bits), jcfg)
    want = jlsh.verify_jaccard(j_pack_bits(jnp.asarray(bits)), want_pairs)
    pairs, _ = tlsh.search(_packed(bits), tcfg)
    ops.reset_launches()
    got = tlsh.verify_jaccard(_packed(bits), pairs)
    assert ops.LAUNCHES["jaccard_popcount"] == 0
    _eq(got, want)
    assert float(got.max()) > 0


def test_brute_force_pairs_equals_reference(rng):
    bits = make_planted(rng, n=48)
    for thr, min_dt in ((0.2, 1), (0.5, 4)):
        np.testing.assert_array_equal(
            tlsh.brute_force_pairs(torch.from_numpy(bits), thr, min_dt),
            jlsh.brute_force_pairs(bits, thr, min_dt))


def test_theory_equals_reference():
    s = np.linspace(0.0, 1.0, 41)
    for k, m, t in ((4, 2, 100), (8, 2, 100), (4, 8, 50), (6, 5, 100)):
        np.testing.assert_array_equal(
            ttheory.detection_probability(s, k, m, t),
            jtheory.detection_probability(s, k, m, t))
        assert ttheory.s_curve_threshold(k, m, t) == \
            jtheory.s_curve_threshold(k, m, t)
    for k_old, m_old, k_new in ((6, 5, 8), (4, 2, 8), (8, 2, 4)):
        assert ttheory.equivalent_m(k_old, m_old, k_new) == \
            jtheory.equivalent_m(k_old, m_old, k_new)


# ---------------------------------------------------------------------------
# entry points: devices, the offline golden, the paper widths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("entry", ["search", "partitioned_search"])
def test_entry_points_default_to_cuda(monkeypatch, rng, entry):
    bits = make_planted(rng, n=32)
    packed = _packed(bits).numpy().view(np.uint32)
    cfg = _cfgs()[1]
    run = {"search": lambda **d: tlsh.search(packed, cfg, **d)[0],
           "partitioned_search": lambda **d: tlsh.partitioned_search(
               packed, cfg, 2, **d)[0][0]}[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run()
    assert run(device="cpu").idx1.device.type == "cpu"


def test_search_reproduces_offline_golden():
    """The port alone (its synth, fingerprints and search, on the CPU)
    gives exactly the 17 ``offline_pairs`` of the streaming golden."""
    gold = json.loads((ROOT / "tests" / "golden" / "stream_pairs.json")
                      .read_text())
    cfg = t_fast.smoke_config()
    assert cfg.fingerprint.mad_sample_rate == 1.0
    ds = tsynth.make_dataset(tsynth.SynthConfig(**gold["synth"]))
    _, packed = tfp.fingerprints_from_waveform(
        torch.from_numpy(ds.waveforms[0]), cfg.fingerprint)
    pairs, _ = tlsh.search(packed, cfg.lsh)
    v = pairs.valid.numpy()
    got = sorted(zip(pairs.idx1.numpy()[v].tolist(),
                     pairs.idx2.numpy()[v].tolist()))
    assert [list(p) for p in got] == gold["offline_pairs"]
    assert len(got) == 17


@pytest.fixture(scope="module")
def paper_width_runs():
    """Both packages' search at ``fast_seismic.config()`` widths (D = 8192,
    t = 100, f = 4, H = 400, bucket_cap 4, 1% filter) on the reference's
    fingerprints of one station × 20 min (MAD rate 1.0). The reference
    hashes through its Pallas kernel in interpret mode: its jnp oracle
    needs GBs at these widths."""
    ds = jsynth.make_dataset(jsynth.SynthConfig(**PAPER_SYNTH))
    fcfg = dataclasses.replace(j_fast.config().fingerprint,
                               mad_sample_rate=1.0)
    coeffs = jfp.coeffs_from_waveform(jnp.asarray(ds.waveforms[0]), fcfg)
    med_mad = jfp.mad_stats(coeffs, 1.0, jax.random.PRNGKey(0))
    bits, packed = jfp.binarize_coeffs(coeffs, fcfg, med_mad)
    jcfg = dataclasses.replace(j_fast.config().lsh, use_pallas=True)
    want, wstats = jlsh.search(bits, jcfg)
    v = np.asarray(want.valid)
    # the reference scores every slot and masks: score the valid ones
    wv = jlsh.Pairs(idx1=want.idx1[v], idx2=want.idx2[v], sim=want.sim[v],
                    valid=want.valid[v])
    wjac = np.asarray(jlsh.verify_jaccard(packed, wv))
    tpacked = torch.from_numpy(np.array(packed).view(np.int32))
    got, gstats = tlsh.search(tpacked, t_fast.config().lsh)
    gjac = tlsh.verify_jaccard(tpacked, got)[got.valid]
    return want, wstats, wjac, got, gstats, gjac


def test_paper_width_search_equals_reference(paper_width_runs):
    want, wstats, wjac, got, gstats, gjac = paper_width_runs
    _pairs_eq(got, want)
    _stats_eq(gstats, wstats)
    assert int(gstats["pre_filter_pairs"]) > 0 and int(gstats["pairs"]) > 0


def test_paper_width_verify_equals_reference(paper_width_runs):
    *_, wjac, _, _, gjac = paper_width_runs
    _eq(gjac, wjac)
    assert len(wjac) > 0
