"""The port's device mesh of one process (`foremast_tpu_torch/parallel/`,
the judge's and arenas' placement hooks) against the JAX package's, held
to tests/test_parallel.py's single-process cases.

The JAX package's mesh is conftest's 8 virtual CPU devices; the port's is
`["cpu"] * 8` (or a (2, 4) grid for the model axis), so every partition,
pad, local-row gather and result gather runs as it would over 8 cards.
The same seeded numpy inputs go to both packages."""

from __future__ import annotations

import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from foremast_tpu import parallel as JP
from foremast_tpu import tenant as JT
from foremast_tpu.config import BrainConfig as JaxConfig
from foremast_tpu.engine import judge as jj
from foremast_tpu.engine import scoring as js
from foremast_tpu.engine.arena import StateArena as JaxArena
from foremast_tpu.engine.arena import TreeArena as JaxTreeArena
from foremast_tpu.ops.forecasters import fit_phase_means as jax_fit_phase_means
from foremast_tpu_torch import tenant as TT
from foremast_tpu_torch.config import BrainConfig
from foremast_tpu_torch.engine import scoring
from foremast_tpu_torch.engine.arena import StateArena, TreeArena, set_arena_budget
from foremast_tpu_torch.engine.judge import HealthJudge, MetricTask
from foremast_tpu_torch.engine.scoring import HEALTHY, UNHEALTHY
from foremast_tpu_torch.models.cache import ModelCache
from foremast_tpu_torch.ops.forecasters import ewma_levels, fit_phase_means
from foremast_tpu_torch.parallel import (
    Blocks,
    ShardedJudge,
    make_mesh,
    pad_batch,
    per_block,
    score_time_sharded,
    shard_batch,
    sharded_ewma,
    sharded_linear_scan,
    sharded_masked_moments,
    sharded_masked_stats,
    sharded_phase_means,
    throughput_batch,
)
from foremast_tpu_torch.parallel import mesh as meshlib

CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh(n_data=8, devices=CPU8)


@pytest.fixture(scope="module")
def mesh24():
    """(data 2, model 4): the model axis for the context-parallel scans."""
    return make_mesh(n_data=2, n_model=4, devices=CPU8)


@pytest.fixture(scope="module")
def jmesh8():
    return JP.make_mesh(n_data=8)


@pytest.fixture(scope="module")
def jmesh24():
    return JP.make_mesh(n_data=2, n_model=4)


def _np(x) -> np.ndarray:
    if isinstance(x, Blocks):
        x = x.gather("cpu")
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _jax_time_sharded(batch, mesh):
    """A JAX ScoreBatch with its history over (data, model), the rest
    over data (tests/test_parallel.py's placement)."""

    def place(leaf, spec):
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    return js.ScoreBatch(
        historical=jax.tree.map(lambda a: place(a, P("data", "model")), batch.historical),
        current=jax.tree.map(lambda a: place(a, P("data")), batch.current),
        baseline=jax.tree.map(lambda a: place(a, P("data")), batch.baseline),
        threshold=place(batch.threshold, P("data")),
        bound=place(batch.bound, P("data")),
        min_lower_bound=place(batch.min_lower_bound, P("data")),
        min_points=place(batch.min_points, P("data")),
    )


def _with_values(batch, hv, cv, thr, base_mask=None, torch_side=True):
    """A throughput batch with its history, current values and threshold
    replaced (and optionally its baseline masked off), in either package."""
    if torch_side:
        conv, full = torch.from_numpy, (lambda v: torch.full((len(thr),), v, dtype=torch.float32))
    else:
        conv, full = jnp.asarray, (lambda v: jnp.full((len(thr),), v, jnp.float32))
    out = dataclasses.replace(
        batch,
        historical=dataclasses.replace(batch.historical, values=conv(hv)),
        current=dataclasses.replace(batch.current, values=conv(cv)),
        threshold=full(float(thr[0])),
    )
    if base_mask is not None:
        out = dataclasses.replace(out, baseline=dataclasses.replace(out.baseline, mask=conv(base_mask)))
    return out


# -- the mesh -----------------------------------------------------------------


def test_mesh_shapes(mesh8, mesh24):
    assert mesh8.shape == {"data": 8, "model": 1}
    assert mesh24.shape == {"data": 2, "model": 4}
    assert dict(JP.make_mesh(n_data=8).shape) == mesh8.shape
    assert [str(d) for d in mesh24.devices[1]] == ["cpu"] * 4
    with pytest.raises(ValueError, match="needs 16 devices"):
        make_mesh(n_data=8, n_model=2, devices=CPU8)


def test_mesh_entry_points_raise_without_a_card(monkeypatch):
    """The default device list is every local card; without one, a mesh
    entry point raises (it never falls back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        meshlib.make_global_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedJudge(BrainConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        meshlib.worker_device_mesh({}, device="cuda")


def test_make_global_mesh_is_the_local_mesh(monkeypatch):
    """make_global_mesh over this process's cards (JAX's single-host
    case), with the model axis held to dividing the local count."""
    monkeypatch.setattr(meshlib, "local_devices", lambda: [torch.device("cpu")] * 8)
    mesh = meshlib.make_global_mesh()
    assert mesh.shape == {"data": 8, "model": 1}
    assert meshlib.make_global_mesh(n_model=2).shape == {"data": 4, "model": 2}
    with pytest.raises(ValueError, match="single host"):
        meshlib.make_global_mesh(n_model=16)
    with pytest.raises(ValueError, match="single host"):
        meshlib.make_global_mesh(n_model=3)


def test_device_mesh_spec_parsing():
    """Every spelling of tests/test_parallel.py, and the same answers as
    the JAX parser."""
    from foremast_tpu.parallel.mesh import device_mesh_spec as jax_spec
    from foremast_tpu_torch.parallel.mesh import device_mesh_spec

    cases = [
        {}, {"FOREMAST_DEVICE_MESH": "auto"}, {"FOREMAST_DEVICE_MESH": "0"}, {"FOREMAST_DEVICE_MESH": "off"},
        {"FOREMAST_DEVICE_MESH": "4"}, {"FOREMAST_DEVICE_MESH": "4x2"}, {"FOREMAST_DEVICE_MESH": "0x2"},
        {"FOREMAST_DEVICE_MESH": "4x0"}, {"FOREMAST_DEVICE_MESH": "auto", "FOREMAST_DEVICE_MESH_MODEL": "2"},
        {"FOREMAST_DEVICE_MESH": "garbage"}, {"FOREMAST_DEVICE_MESH": "4", "FOREMAST_DEVICE_MESH_MODEL": "bad"},
        {"FOREMAST_DEVICE_MESH": " 2X4 "}, {"FOREMAST_DEVICE_MESH": "disabled"},
    ]
    for env in cases:
        assert device_mesh_spec(env) == jax_spec(env), env
    assert device_mesh_spec({}) == (None, 1)
    assert device_mesh_spec({"FOREMAST_DEVICE_MESH": "4x2"}) == (4, 2)
    assert device_mesh_spec({"FOREMAST_DEVICE_MESH": "0x2"}) is None


def test_worker_device_mesh_resolution(monkeypatch):
    """auto spans every local card, never repeating one; 1-device
    resolutions, a CPU worker and a disabled knob resolve to None (the
    plain judge); infeasible grids fall back to the all-local mesh."""
    wdm = meshlib.worker_device_mesh
    monkeypatch.setattr(meshlib, "local_devices", lambda: [torch.device("cuda", i) for i in range(8)])
    monkeypatch.setattr(meshlib, "_multi_process", lambda: False)
    mesh = wdm({}, device="cuda")
    assert mesh.shape == {"data": 8, "model": 1}
    assert len({str(d) for d in mesh.devices.ravel()}) == 8  # no repeats
    assert wdm({}, device="cpu") is None  # a CPU worker keeps the plain judge
    assert wdm({"FOREMAST_DEVICE_MESH": "off"}, device="cuda") is None
    assert wdm({"FOREMAST_DEVICE_MESH": "1"}, device="cuda") is None
    assert wdm({"FOREMAST_DEVICE_MESH": "1x1"}, device="cuda") is None
    assert wdm({"FOREMAST_DEVICE_MESH": "4x2"}, device="cuda").shape == {"data": 4, "model": 2}
    assert wdm({"FOREMAST_DEVICE_MESH": "1024"}, device="cuda").shape == {"data": 8, "model": 1}
    assert wdm({"FOREMAST_DEVICE_MESH_MODEL": "32"}, device="cuda").shape == {"data": 8, "model": 1}
    monkeypatch.setattr(meshlib, "local_devices", lambda: [torch.device("cuda", 0)])
    assert wdm({}, device="cuda") is None  # one card: the plain judge


# -- sharded scoring ----------------------------------------------------------


def test_sharded_scoring_matches_single_device(mesh8, jmesh8):
    batch = throughput_batch(64, 128, 16, device="cpu")
    single = scoring.score(batch)
    res = per_block(scoring.score, shard_batch(pad_batch(batch, 8), mesh8))
    assert isinstance(res.verdict, Blocks) and len(res.verdict) == 8
    np.testing.assert_array_equal(_np(single.verdict), _np(res.verdict)[:64])
    assert _np(single.upper).tobytes() == _np(res.upper)[:64].tobytes()
    jres = js.score(JP.shard_batch(JP.pad_batch(JP.throughput_batch(64, 128, 16), 8), jmesh8))
    np.testing.assert_array_equal(_np(res.verdict), np.asarray(jres.verdict))
    np.testing.assert_allclose(_np(res.upper), np.asarray(jres.upper), rtol=1e-5)


@pytest.mark.parametrize("merge", [False, True])
def test_shard_rows_take_matches_jax(mesh8, jmesh8, merge):
    """Each block gathers its positions' LOCAL rows from its own capacity
    block, as JAX's `shard_rows_take` does; with `merge` a device's
    blocks share one buffer and the rows index it (`arena.device_rows`)."""
    cap_s, per = 6, 5
    rng = np.random.default_rng(21)
    tree = {"a": rng.standard_normal((8 * cap_s, 3)).astype(np.float32),
            "b": rng.integers(0, 99, 8 * cap_s).astype(np.int32)}
    local = rng.integers(0, cap_s, 8 * per).astype(np.int32)
    from foremast_tpu.parallel.mesh import shard_rows_take as jax_shard_rows_take

    want = jax_shard_rows_take(
        jax.tree.map(lambda a: jax.device_put(a, NamedSharding(jmesh8, P("data", *([None] * (a.ndim - 1))))), tree),
        jax.device_put(local, NamedSharding(jmesh8, P("data"))),
        jmesh8,
    )
    if merge:
        # the arena's layout on one device: the 8 blocks share the card's
        # one buffer, and a block's rows start at its rank times cap_s
        state = {k: Blocks([torch.from_numpy(v)] * 8) for k, v in tree.items()}
        rows = local + np.arange(8 * per) // per * cap_s
    else:
        state = meshlib.shard_leading({k: torch.from_numpy(v) for k, v in tree.items()}, mesh8)
        rows = local
    got = meshlib.shard_rows_take(state, meshlib.shard_leading(torch.from_numpy(rows.astype(np.int64)), mesh8),
                                  merge=merge)
    for k in tree:
        assert isinstance(got[k], Blocks) and len(got[k]) == 8
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]))


def test_sharded_daily_auto_screen_matches_single_device(mesh8, jmesh8):
    """The long-season auto screen partitions over the data axis like the
    mean model (m=96: the rolled/pooled code path)."""
    m = 96
    kw = dict(algorithm="auto_univariate", season_length=m)
    batch = throughput_batch(48, 4 * m, 16, device="cpu")
    single = scoring.score(batch, **kw)
    res = per_block(scoring.score, shard_batch(pad_batch(batch, 8), mesh8), **kw)
    np.testing.assert_array_equal(_np(single.verdict), _np(res.verdict)[:48])
    np.testing.assert_allclose(_np(single.upper), _np(res.upper)[:48], rtol=2e-5, atol=2e-5)
    jres = js.score(JP.shard_batch(JP.pad_batch(JP.throughput_batch(48, 4 * m, 16), 8), jmesh8), **kw)
    np.testing.assert_array_equal(_np(res.verdict)[:48], np.asarray(jres.verdict)[:48])
    np.testing.assert_allclose(_np(res.upper)[:48], np.asarray(jres.upper)[:48], rtol=2e-4, atol=2e-4)


def _tasks(n: int, spike: int, fit_keys: bool = False, seed: int = 0):
    rng = np.random.default_rng(seed)
    out = {"port": [], "jax": []}
    for i in range(n):
        hist = (0.5 + 0.05 * rng.standard_normal(200)).astype(np.float32)
        cur = (0.5 + 0.05 * rng.standard_normal(10)).astype(np.float32)
        if i == spike:
            cur[3] = 50.0
        t = 1_700_000_000 + 60 * np.arange(200, dtype=np.int64)
        kw = dict(
            job_id=f"j{i}", alias="m", metric_type="latency", hist_times=t, hist_values=hist,
            cur_times=t[:10], cur_values=cur, fit_key=f"fit{i}" if fit_keys else None,
        )
        out["port"].append(MetricTask(**kw))
        out["jax"].append(jj.MetricTask(**kw))
    return out


def test_sharded_judge_end_to_end(mesh8, jmesh8):
    tasks = _tasks(13, spike=7)  # deliberately not a multiple of 8
    vs = ShardedJudge(BrainConfig(), mesh=mesh8).judge(tasks["port"])
    assert len(vs) == 13
    assert vs[7].verdict == UNHEALTHY
    assert all(v.verdict == HEALTHY for i, v in enumerate(vs) if i != 7)
    jvs = JP.ShardedJudge(JaxConfig(), mesh=jmesh8).judge(tasks["jax"])
    assert [v.verdict for v in vs] == [v.verdict for v in jvs]
    assert [v.anomaly_pairs for v in vs] == [v.anomaly_pairs for v in jvs]
    single = HealthJudge(BrainConfig(), device="cpu").judge(tasks["port"])
    for a, b in zip(vs, single):
        assert (a.verdict, a.anomaly_pairs, a.upper.tobytes(), a.p_value) == (
            b.verdict, b.anomaly_pairs, b.upper.tobytes(), b.p_value
        )


def test_sharded_judge_actually_shards(mesh8):
    """_place spreads the batch over the data axis: 8 blocks of B/8 rows,
    one a device, and the in-run partition assert holds."""
    batch = pad_batch(throughput_batch(16, 64, 8, device="cpu"), 8)
    judge = ShardedJudge(BrainConfig(), mesh=mesh8)
    placed = judge._place(batch)
    v = placed.current.values
    assert isinstance(v, Blocks) and len(v) == 8 and [p.shape[0] for p in v.parts] == [2] * 8
    assert v.devices == mesh8.data_devices
    meshlib.assert_partitioned(v, 8)
    assert judge.mesh_stats["place_calls"] == 1
    with pytest.raises(AssertionError, match="not partitioned"):
        meshlib.assert_partitioned(Blocks([v.parts[0]] * 4), 8)


def test_sharded_judge_composes_with_fit_cache(mesh8):
    """ShardedJudge + fit_cache: identical verdicts cold and warm, and a
    warm tick runs NO fit, the mesh's pad rows included."""
    rng = np.random.default_rng(0)
    t = np.arange(24 * 10, dtype=np.float32)

    def task(i, spike=False):
        hist = (5 + 2 * np.sin(2 * np.pi * t / 24) + rng.normal(0, 0.1, len(t))).astype(np.float32)
        cur = (5 + 2 * np.sin(2 * np.pi * (len(t) + np.arange(10)) / 24)).astype(np.float32)
        if spike:
            cur[4] = 40.0
        ht = 1_700_000_000 + 60 * np.arange(len(t), dtype=np.int64)
        ct = ht[-1] + 60 + 60 * np.arange(10, dtype=np.int64)
        return MetricTask(
            job_id=f"j{i}", alias="m", metric_type=None, hist_times=ht, hist_values=hist,
            cur_times=ct, cur_values=cur, fit_key=f"a{i}|m|u{i}",
        )

    judge = ShardedJudge(BrainConfig(algorithm="holt_winters", season_steps=24), mesh=mesh8)
    judge.fit_cache = ModelCache(64)
    tasks = [task(i, spike=(i == 3)) for i in range(12)]  # 12 % 8 != 0: pads
    v1 = judge.judge(tasks)
    orig = scoring.fit_forecast

    def boom(*a, **k):  # pragma: no cover - failure path
        raise AssertionError("fit ran on a warm sharded tick")

    scoring.fit_forecast = boom
    try:
        v2 = judge.judge(tasks)
    finally:
        scoring.fit_forecast = orig
    assert [v.verdict for v in v1] == [v.verdict for v in v2]
    assert v1[3].verdict == UNHEALTHY
    assert all(v.verdict == HEALTHY for i, v in enumerate(v1) if i != 3)


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16_fit", "f32_fit"])
def test_sharded_fit_cache_matches_single_and_fits_per_block(mesh8, bf16):
    """The fit-cache path over the mesh: cold fits run block by block
    (every fit chunk split over the data axis) and the cached state and
    verdicts equal the single-device judge's bit for bit."""
    tasks = _tasks(21, spike=5, fit_keys=True, seed=3)["port"]
    scoring.set_bf16_delta(bf16)
    try:
        out = []
        for judge in (ShardedJudge(BrainConfig(), mesh=mesh8), HealthJudge(BrainConfig(), device="cpu")):
            judge.fit_cache = ModelCache(64)
            seen = []
            orig = scoring.fit_ma_from_bf16_delta if bf16 else scoring.fit_forecast
            name = "fit_ma_from_bf16_delta" if bf16 else "fit_forecast"

            def spy(*a, _orig=orig, **k):
                seen.append(a[0].shape[0])
                return _orig(*a, **k)

            setattr(scoring, name, spy)
            try:
                cold = judge.judge(tasks)
                warm = judge.judge(tasks)
            finally:
                setattr(scoring, name, orig)
            out.append((cold, warm, seen, sorted(judge.fit_cache.snapshot().items(), key=repr)))
        (sc, sw, s_seen, s_fits), (pc, pw, p_seen, p_fits) = out
        assert s_seen == [p_seen[0] // 8] * 8  # one fit chunk, 8 blocks
        for a, b in zip(sc + sw, pc + pw):
            assert (a.verdict, a.anomaly_pairs, a.upper.tobytes()) == (b.verdict, b.anomaly_pairs, b.upper.tobytes())
        real = [(k, e) for k, e in s_fits if "__pad__" not in repr(k)]
        assert [k for k, _ in real] == [k for k, _ in p_fits if "__pad__" not in repr(k)]
        for (_, a), (_, b) in zip(real, (x for x in p_fits if "__pad__" not in repr(x[0]))):
            assert repr(a) == repr(b)
    finally:
        scoring.set_bf16_delta(None)


def test_sharded_judge_phase_means_seasonal_detection(mesh8):
    """A sharp per-phase burst history judged with phase_means over the
    mesh: the burst recurring stays healthy; an off-burst spike flags."""
    rng = np.random.default_rng(6)
    m, n, tc = 96, 480, 12
    t = np.arange(n)
    hist = (5 + 3.0 * ((t % m) < 4) + rng.normal(0, 0.1, (12, n))).astype(np.float32)
    ht = 1_700_000_000 + 60 * np.arange(n, dtype=np.int64)
    ct = ht[-1] + 60 + 60 * np.arange(tc, dtype=np.int64)
    tcur = n + np.arange(tc)
    base_cur = (5 + 3.0 * ((tcur % m) < 4)).astype(np.float32)
    tasks = []
    for i in range(12):
        cur = base_cur + rng.normal(0, 0.05, tc).astype(np.float32)
        if i == 5:
            cur[8] += 2.0
        tasks.append(MetricTask(job_id=f"j{i}", alias="m", metric_type=None, hist_times=ht, hist_values=hist[i],
                                cur_times=ct, cur_values=cur))
    verdicts = ShardedJudge(BrainConfig(algorithm="phase_means", season_steps=m), mesh=mesh8).judge(tasks)
    assert verdicts[5].verdict == UNHEALTHY
    assert all(v.verdict == HEALTHY for i, v in enumerate(verdicts) if i != 5), [v.verdict for v in verdicts]


def test_sharded_judge_columnar_pads_to_data_axis(mesh8, jmesh8):
    """judge_columnar on a ShardedJudge rounds B up to a data-axis
    multiple, partitions the batch, places twice (the batch buffers in
    one call, the sharded arena's local rows in another), and returns
    byte-identical results vs the plain judge and JAX's mesh judge."""
    rng = np.random.default_rng(0)
    cfg = BrainConfig()
    b0, tc = 13, 10
    values = (0.5 + 0.05 * rng.standard_normal((b0, tc))).astype(np.float32)
    values[7, 3] = 50.0
    mask = np.ones((b0, tc), bool)
    keys = [(cfg.algorithm, cfg.season_steps, f"k{i}") for i in range(b0)]
    entries = [(0.5, 0.0, np.zeros(1, np.float32), 0, 0.05, 200)] * b0
    nidx = np.full(b0, tc - 1, np.int32)
    thr = np.full(b0, 3.0, np.float32)
    bound = np.ones(b0, np.int32)
    mlb = np.zeros(b0, np.float32)

    def run(judge):
        judge.fit_cache = ModelCache(256)
        judge.band_mode = "last"
        return judge.judge_columnar(values.copy(), mask.copy(), list(keys), list(entries), nidx, thr, bound, mlb)

    sharded = ShardedJudge(cfg, mesh=mesh8)
    sv, sa, su, sl, sp, _ = run(sharded)
    pv, pa, pu, pl, pp, _ = run(HealthJudge(cfg, device="cpu"))
    jv, ja, ju, jl, jp_, _ = run(JP.ShardedJudge(JaxConfig(), mesh=jmesh8))
    assert sp is None and pp is None and jp_ is None
    assert sharded.batch_rows_total == 16 and sharded.pad_rows_total == 3
    assert sharded.mesh_stats["place_calls"] == 2
    np.testing.assert_array_equal(sv, pv)
    np.testing.assert_array_equal(sa, pa)
    assert su.tobytes() == pu.tobytes() and sl.tobytes() == pl.tobytes()
    np.testing.assert_array_equal(sv, jv)
    np.testing.assert_array_equal(sa, ja)
    np.testing.assert_allclose(su, ju, rtol=1e-6)
    assert int(sv[7]) == UNHEALTHY
    arena = next(iter(sharded._arenas.values()))
    assert arena.shards == 8 and {k for k in arena.rows if str(k).startswith("__pad__")} == {
        "__pad__col__@6", "__pad__col__@7"
    }


def test_pad_fit_keys_never_journal(mesh8):
    """ShardedJudge's task-list pad writes its constant '__pad__*' fits
    into the in-memory cache (warm ticks stay fit-free) but the journal,
    its compaction and the RefineBook never record them."""
    from foremast_tpu_torch.jobs.refine import RefineBook
    from foremast_tpu_torch.models.cache import FitJournal, is_pad_fit_key

    assert is_pad_fit_key("__pad__@3") and is_pad_fit_key(("moving_average_all", 24, "__pad__@0"))
    assert is_pad_fit_key("__pad__col__@7")
    assert not is_pad_fit_key(("moving_average_all", 24, "app|m|url"))
    with tempfile.TemporaryDirectory() as d:
        journal = FitJournal(os.path.join(d, "fit-uni"))
        cache = ModelCache(64)
        journal.attach(cache)
        judge = ShardedJudge(BrainConfig(), mesh=mesh8)
        judge.fit_cache = cache
        tasks = _tasks(3, spike=-1, fit_keys=True)["port"]  # pads to 8
        assert len(judge.judge(tasks)) == 3
        assert any(is_pad_fit_key(k) for k in cache._d)
        restored = FitJournal(os.path.join(d, "fit-uni")).restore()
        assert restored and not any(is_pad_fit_key(k) for k in restored)
        journal.compact()
        restored = FitJournal(os.path.join(d, "fit-uni")).restore()
        assert restored and not any(is_pad_fit_key(k) for k in restored)
        journal.close()
    book = RefineBook()
    book.note_uni(("ma", 24, "__pad__@1"), "__pad__", "u", 5)
    assert len(book._recs) == 0


# -- context parallelism -------------------------------------------------------


def test_sharded_linear_scan_matches_local(mesh24, jmesh24):
    rng = np.random.default_rng(1)
    a = rng.uniform(0.5, 1.0, (8, 64)).astype(np.float32)
    b = rng.standard_normal((8, 64)).astype(np.float32)
    got = sharded_linear_scan(torch.from_numpy(a), torch.from_numpy(b), mesh24)
    assert len(got) == 2 and len(got.parts[0]) == 4 and got.parts[1].parts[3].shape == (4, 16)
    ref = np.zeros_like(b)
    level = np.zeros(8, np.float32)
    for t in range(64):
        level = a[:, t] * level + b[:, t]
        ref[:, t] = level
    np.testing.assert_allclose(_np(got), ref, rtol=2e-4, atol=2e-4)
    want = JP.sharded_linear_scan(jnp.asarray(a), jnp.asarray(b), jmesh24)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_sharded_ewma_matches_reference_op(mesh24, jmesh24):
    rng = np.random.default_rng(2)
    v = rng.standard_normal((8, 64)).astype(np.float32)
    mask = rng.uniform(size=(8, 64)) > 0.2
    got = _np(sharded_ewma(torch.from_numpy(v), torch.from_numpy(mask), 0.3, mesh24))
    np.testing.assert_allclose(got, ewma_levels(torch.from_numpy(v), torch.from_numpy(mask), 0.3).numpy(),
                               rtol=2e-4, atol=2e-4)
    want = JP.sharded_ewma(jnp.asarray(v), jnp.asarray(mask), 0.3, jmesh24)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-4)


def test_sharded_moments(mesh24, jmesh24):
    rng = np.random.default_rng(3)
    v = (rng.standard_normal((8, 64)) * 2 + 1).astype(np.float32)
    mask = rng.uniform(size=(8, 64)) > 0.3
    mean, var = sharded_masked_moments(torch.from_numpy(v), torch.from_numpy(mask), mesh24)
    n, _, _ = sharded_masked_stats(torch.from_numpy(v), torch.from_numpy(mask), mesh24)
    np.testing.assert_array_equal(_np(n), mask.sum(axis=1))
    for i in range(8):
        sel = v[i][mask[i]]
        np.testing.assert_allclose(_np(mean)[i], sel.mean(), rtol=1e-4)
        np.testing.assert_allclose(_np(var)[i], sel.var(), rtol=1e-3, atol=1e-4)
    jmean, jvar = JP.sharded_masked_moments(jnp.asarray(v), jnp.asarray(mask), jmesh24)
    np.testing.assert_allclose(_np(mean), np.asarray(jmean), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(var), np.asarray(jvar), rtol=1e-4, atol=1e-5)


def test_sharded_phase_means_matches_local_fit(mesh24, jmesh24):
    """The time-sharded phase-means fit reproduces the single-device
    fit's terminal state (interior gaps, a ragged tail, a series under
    two cycles) and JAX's time-sharded fit."""
    rng = np.random.default_rng(8)
    b, m, n = 8, 24, 24 * 16  # t_loc = 96 = 4 cycles per time block
    t = np.arange(n)
    v = (5 + 2.5 * ((t % m) < 3) + 0.004 * t + rng.normal(0, 0.1, (b, n))).astype(np.float32)
    mk = np.ones((b, n), bool)
    mk[2, 100:130] = False
    mk[5, 300:] = False
    mk[6, m + 10 :] = False
    ref = fit_phase_means(torch.from_numpy(v), torch.from_numpy(mk), m)
    season, level, trend, scale, phase, n_hist = (
        _np(x) for x in sharded_phase_means(torch.from_numpy(v), torch.from_numpy(mk), m, mesh24)
    )
    np.testing.assert_allclose(season, ref.season.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(level, ref.level.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(trend, ref.trend.numpy(), rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(scale, ref.scale.numpy(), rtol=2e-3, atol=2e-4)
    np.testing.assert_array_equal(phase, ref.season_phase.numpy())
    np.testing.assert_array_equal(n_hist, mk.sum(axis=1))
    assert float(np.abs(season[6]).max()) == 0.0 and float(trend[6]) == 0.0
    jref = JP.sharded_phase_means(
        jax.device_put(jnp.asarray(v), NamedSharding(jmesh24, P("data", "model"))),
        jax.device_put(jnp.asarray(mk), NamedSharding(jmesh24, P("data", "model"))),
        m,
        jmesh24,
    )
    for got, want, tol in zip((season, level, trend, scale), jref[:4], (2e-4, 2e-4, 1e-6, 2e-4)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-3, atol=tol)
    np.testing.assert_array_equal(phase, np.asarray(jref[4]))
    np.testing.assert_array_equal(n_hist, np.asarray(jref[5]))
    single = jax_fit_phase_means(jnp.asarray(v), jnp.asarray(mk), m)
    np.testing.assert_array_equal(phase, np.asarray(single.season_phase))
    with pytest.raises(ValueError, match="phase-aligned"):
        sharded_phase_means(torch.from_numpy(v[:, :200]), torch.from_numpy(mk[:, :200]), m, mesh24)


def test_score_time_sharded_matches_single(mesh24, jmesh24):
    """Context parallelism end to end (moving_average_all): the history
    over `model` reproduces the single-program judgment and JAX's
    time-sharded one."""
    batch = throughput_batch(32, 256, 16, device="cpu")
    ref = scoring.score(batch)
    res = score_time_sharded(batch, mesh24)
    np.testing.assert_array_equal(_np(ref.verdict), _np(res.verdict))
    np.testing.assert_array_equal(_np(ref.anomalies), _np(res.anomalies))
    np.testing.assert_allclose(_np(ref.upper), _np(res.upper), rtol=1e-4)
    np.testing.assert_allclose(_np(ref.p_value), _np(res.p_value), rtol=1e-5)
    jres = JP.score_time_sharded(_jax_time_sharded(JP.throughput_batch(32, 256, 16), jmesh24), jmesh24)
    np.testing.assert_array_equal(_np(res.verdict), np.asarray(jres.verdict))
    np.testing.assert_array_equal(_np(res.anomalies), np.asarray(jres.anomalies))
    np.testing.assert_allclose(_np(res.upper), np.asarray(jres.upper), rtol=1e-4)


def _burst_batch(b, m, th, tc, seed, gap=0, no_base=False, torch_side=True):
    rng = np.random.default_rng(seed)
    t = np.arange(th)
    hv = (5 + 2.0 * ((t % m) < 3) + rng.normal(0, 0.1, (b, th))).astype(np.float32)
    tcur = th + gap + np.arange(tc)
    cv = (5 + 2.0 * ((tcur % m) < 3) + rng.normal(0, 0.05, (b, tc))).astype(np.float32)
    if not gap:
        cv[3, 7] += 2.0
    base = throughput_batch(b, th, tc, device="cpu") if torch_side else JP.throughput_batch(b, th, tc)
    return _with_values(base, hv, cv, np.full(b, 4.0), np.zeros((b, tc), bool) if no_base else None, torch_side)


def test_score_time_sharded_phase_means_matches_single_chip(mesh24, jmesh24):
    b, m, th, tc = 16, 24, 24 * 16, 12
    batch = _burst_batch(b, m, th, tc, seed=10)
    cfg = BrainConfig(season_steps=m)
    ref = scoring.score(batch, algorithm="phase_means", season_length=m)
    res = score_time_sharded(batch, mesh24, cfg, algorithm="phase_means")
    np.testing.assert_array_equal(_np(ref.verdict), _np(res.verdict))
    np.testing.assert_array_equal(_np(ref.anomalies), _np(res.anomalies))
    np.testing.assert_allclose(_np(ref.upper), _np(res.upper), rtol=2e-4, atol=2e-4)
    assert int(_np(res.verdict)[3]) == UNHEALTHY and (_np(res.verdict) == HEALTHY).sum() == b - 1
    jb = _jax_time_sharded(_burst_batch(b, m, th, tc, seed=10, torch_side=False), jmesh24)
    jres = JP.score_time_sharded(jb, jmesh24, JaxConfig(season_steps=m), algorithm="phase_means")
    np.testing.assert_array_equal(_np(res.verdict), np.asarray(jres.verdict))
    np.testing.assert_allclose(_np(res.upper), np.asarray(jres.upper), rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="supports"):
        score_time_sharded(batch, mesh24, cfg, algorithm="holt_winters")


def test_score_time_sharded_phase_means_advances_gap(mesh24):
    """A drifted re-check window is judged at the advanced phase on the
    context-parallel path too."""
    b, m, th, tc, gap = 8, 24, 24 * 16, 12, 18
    batch = _burst_batch(b, m, th, tc, seed=12, gap=gap, no_base=True)
    cfg = BrainConfig(season_steps=m)
    with_gap = score_time_sharded(batch, mesh24, cfg, algorithm="phase_means",
                                  gap_steps=torch.full((b,), gap, dtype=torch.int32))
    stale = score_time_sharded(batch, mesh24, cfg, algorithm="phase_means")
    assert (_np(with_gap.verdict) == HEALTHY).all()
    assert (_np(stale.verdict) == UNHEALTHY).all()


# -- the LSTM-AE over the mesh ---------------------------------------------------


MESH_SHAPES = [(8, 1), (4, 2)]  # tests/test_parallel.py's mesh8 and mesh_2d


def _lstm_case(n_data, n_model):
    """Both packages' meshes of one shape, and the same LSTM-AE start:
    JAX's `init_many` params carried into the port, seeded windows."""
    from foremast_tpu.models import lstm_ae as JL
    from foremast_tpu_torch.interop import ae_params_from_numpy

    cfg = JL.LSTMAEConfig(features=3, hidden=8)
    s, w, t = 8, 4, 12
    jparams = JL.init_many(jax.random.key(0), s, cfg)
    jopt = jax.vmap(JL.make_optimizer(cfg).init)(jparams)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((s, w, t, 3)).astype(np.float32)
    mask = np.ones((s, w, t), bool)
    pparams = ae_params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    jmesh = JP.make_mesh(n_data=n_data, n_model=n_model)
    pmesh = make_mesh(n_data=n_data, n_model=n_model, devices=CPU8)
    return cfg, jparams, jopt, pparams, x, mask, jmesh, pmesh


@pytest.mark.parametrize("n_data,n_model", MESH_SHAPES)
def test_lstm_ae_shardings_match_jax_spec(n_data, n_model):
    """`models.lstm_ae_shardings` names JAX's placement of every param
    leaf: the service axis over `data`, the rest whole, except that the
    4H gate axis JAX splits over `model` stays whole on its card (the
    port's kernels keep a model's gate row in one warp; ROADMAP.md
    Queue 3's deliberate departure)."""
    from foremast_tpu.models import lstm_ae_shardings as jax_shardings
    from foremast_tpu_torch.models import lstm_ae_shardings
    from foremast_tpu_torch.models.lstm_ae import adam_init, leaves

    _, jparams, jopt, pparams, _, _, jmesh, pmesh = _lstm_case(n_data, n_model)
    jspec, _ = jax_shardings(jmesh, jparams, jopt)
    pspec, ospec = lstm_ae_shardings(pmesh, pparams, adam_init(pparams))
    want = [tuple(None if d == "model" else d for d in sp.spec) for sp in jax.tree.leaves(jspec)]
    assert any("model" in sp.spec for sp in jax.tree.leaves(jspec))  # JAX does split the gate axis
    assert [p.spec for p in leaves(pspec)] == want
    assert [m.spec for m in ospec.mu] == want and [v.spec for v in ospec.nu] == want
    assert all(p.mesh is pmesh for p in leaves(pspec))


@pytest.mark.parametrize("n_data,n_model", MESH_SHAPES)
def test_lstm_ae_train_step_sharded(n_data, n_model):
    """Stacked per-service params, Adam state and windows split over the
    data axis (`lstm_ae_shardings`); one train step a block equals JAX's
    `train_step_many` over its mesh of the same shape on the same start:
    losses within 1e-5 relative, every leaf within 1e-4 of its largest
    entry (tests/test_torch_lstm_ae.py's tolerances)."""
    from foremast_tpu.models import lstm_ae as JL
    from foremast_tpu.models import lstm_ae_shardings as jax_shardings
    from foremast_tpu_torch.models.lstm_ae import LSTMAEConfig, adam_init, leaves, train_step_many

    cfg, jparams, jopt, pparams, x, mask, jmesh, pmesh = _lstm_case(n_data, n_model)
    jspec, jospec = jax_shardings(jmesh, jparams, jopt)
    jp = jax.tree.map(jax.device_put, jparams, jspec)
    jo = jax.tree.map(jax.device_put, jopt, jospec)
    jx = jax.device_put(jnp.asarray(x), NamedSharding(jmesh, P("data", None, None, None)))
    jm = jax.device_put(jnp.asarray(mask), NamedSharding(jmesh, P("data", None, None)))
    jp2, _, jloss = JL.train_step_many(jp, jo, jx, jm, cfg)

    placed = meshlib.shard_leading((pparams, adam_init(pparams), torch.from_numpy(x), torch.from_numpy(mask)), pmesh)
    p2, o2, loss = per_block(lambda p, o, xs, ms: train_step_many(p, o, xs, ms, LSTMAEConfig(features=3, hidden=8)),
                             *placed)
    assert isinstance(loss, Blocks) and len(loss) == n_data
    assert o2.count == 1
    np.testing.assert_allclose(_np(loss), np.asarray(jloss), rtol=1e-5)
    moved = 0.0
    for got, want, before in zip(leaves(p2), jax.tree.leaves(jp2), leaves(pparams)):
        got, want = _np(got).astype(np.float64), np.asarray(want, np.float64)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max() + 1e-12
        moved = max(moved, float(np.abs(got - before.numpy()).max()))
    assert moved > 0  # params actually updated


# -- the sharded arenas ----------------------------------------------------------


def _key(i: int) -> str:
    return f"a{i}|m|u{i}"


def _key_sequences(seed: int, calls: int = 14, n_keys: int = 40):
    """Assign calls over a shifting key population: claim-order jitter
    (migrations), duplicates across blocks (transients), unkeyed rows,
    per-shard pad keys and forced rescatters."""
    rng = np.random.default_rng(seed)
    seq = []
    for c in range(calls):
        b = int(rng.choice([8, 16, 24, 32]))
        keys = [_key(int(k)) for k in rng.choice(n_keys, size=b, replace=False)]
        if c % 3 == 1:
            rng.shuffle(keys)
        if c % 4 == 2:
            keys[-1] = keys[0]  # the same key in two blocks
        if c % 5 == 3:
            keys[1] = None
        n_real = b - (c % 3)
        per = b // 8
        for j in range(n_real, b):
            keys[j] = f"__pad__col__@{j // per}"
        force = sorted({int(x) for x in rng.integers(0, n_real, size=2)}) if c % 2 else []
        seq.append((keys, force, n_real))
    return seq


def _drive(arena, seq) -> list:
    out = []
    for keys, force, n_real in seq:
        got = arena.assign(keys, force, n_real)
        out.append(None if got is None else (got[0].tolist(), list(got[1])))
        out.append((dict(arena.rows), list(arena.row_key), arena.stamp.tolist(), arena.counters()))
    return out


@pytest.fixture
def budgets():
    """Pin both packages' arena budgets per test: `set(soft, hard)`."""
    from foremast_tpu.engine.arena import set_arena_budget as jax_budget

    def pin(soft, hard):
        set_arena_budget(soft, hard)
        jax_budget(soft, hard)

    yield pin
    pin(None, None)


@pytest.mark.parametrize("seed,rows_per_shard", [(0, 64), (1, 8), (2, 8)], ids=["roomy", "evicting", "evicting2"])
def test_sharded_arena_row_maps_equal_jax(mesh8, jmesh8, budgets, seed, rows_per_shard):
    """The same key sequences give the port's and the JAX package's
    data-axis-sharded arenas the same rows, scatters, row maps, stamps
    and counters (hits, misses, evictions, shard moves): migrations,
    transients, pads and forced rescatters, with room or under eviction
    pressure at a fixed capacity; every scattered row lands in its
    shard's block."""
    m = 4
    budget = rows_per_shard * (20 + 4 * m)
    budgets(budget, budget)
    seq = _key_sequences(seed)
    port = StateArena(m, device="cpu", sharding=meshlib.data_sharding(mesh8, 1), shards=8)
    ref = JaxArena(m, sharding=NamedSharding(jmesh8, P("data")), shards=8)
    assert _drive(port, seq) == _drive(ref, seq)
    c = port.counters()
    assert c["shard_moves"] > 0 and port.cap_s == rows_per_shard
    assert (c["evictions"] > 0) == (rows_per_shard == 8)
    assert port.device_bytes() == ref.device_bytes() == rows_per_shard * (20 + 4 * m)
    keys, _, n_real = seq[-1]
    rows, scat = port.assign(keys, list(range(n_real)), n_real)
    first = [i if k is None else keys.index(k) for i, k in enumerate(keys)]  # one entry a key
    entries = [(float(i), 0.5, np.full(m, i, np.float32), i % m, 1.0 + i, 10 + i) for i in first]
    port.scatter(rows, scat, entries)
    lvl = port.state[0]
    # the 8 blocks all lie on the CPU: one buffer of their 8 shard blocks
    assert isinstance(lvl, Blocks) and all(p is lvl.parts[0] for p in lvl.parts)
    assert lvl.parts[0].shape[0] == 8 * port.cap_s
    per = len(keys) // 8
    local = port.device_rows(rows)
    for i in scat:
        s = int(rows[i]) // port.cap_s
        assert s == i // per and int(local[i]) == int(rows[i])
        assert float(lvl.parts[s][local[i]]) == float(first[i])
        assert int(port.state[5].parts[s][local[i]]) == 10 + first[i]


def test_sharded_arena_midcall_growth_keeps_rows_distinct(mesh8, jmesh8):
    """Growth in the middle of an assign call (the shortfall growth)
    renumbers every global row. The port reads the renumbered key map
    from there on, so no two keys ever share a row and every position's
    row lies in its block. The JAX arena keeps reading the map from
    before the growth on this sequence and hands one row to two keys
    (ROADMAP.md Queue 3): the one place the port's row maps leave JAX's."""
    seq = _key_sequences(4, calls=4)
    f32 = torch.float32
    port = TreeArena({"mean": ((2,), f32)}, device="cpu", sharding=meshlib.data_sharding(mesh8, 1), shards=8)
    ref = JaxTreeArena({"mean": jax.ShapeDtypeStruct((2,), jnp.float32)}, sharding=NamedSharding(jmesh8, P("data")),
                       shards=8)
    for keys, force, n_real in seq:
        cap_before = port.cap_s
        rows, _ = port.assign(keys, force, n_real)
        ref.assign(keys, force, n_real)
        assert len(set(port.rows.values())) == len(port.rows)
        per = len(keys) // 8
        assert all(int(r) // port.cap_s == i // per for i, r in enumerate(rows))
        seen = {}
        for k, r in zip(keys, rows.tolist()):
            assert seen.setdefault(r, k) == k  # one row, one key
    assert port.cap_s > cap_before == 8  # the last call grew mid-call
    assert len(set(ref.rows.values())) < len(ref.rows)  # the reference's fault


def test_sharded_arena_tenancy_equals_jax(mesh8, jmesh8):
    """With a tenant over its arena_rows envelope, the sharded arena
    recycles that tenant's own rows within each block, and the row maps,
    counters and per-tenant row counts equal the JAX arena's."""
    from foremast_tpu.metrics.promql import prometheus_url

    def key(t, i):
        url = prometheus_url({"endpoint": "http://p/api/v1/", "query": f'up{{app="a{i}",tenant="{t}"}}',
                              "start": 0, "end": 600, "step": 60})
        return f"a{i}|up|{url}"

    rng = np.random.default_rng(17)
    seq = [([key("quiet", i) for i in range(8)], [], 8)]
    for rnd in range(5):
        keys = [key("whale", rnd * 16 + i) for i in range(16)]
        seq.append((keys, [int(rng.integers(16))], 16))
        seq.append(([key("quiet", i) for i in range(8)], [], 8))

    def run(pkg, make):
        pkg.set_tenancy(pkg.TenantRegistry({"whale": pkg.TenantSpec(name="whale", arena_rows=8),
                                            "quiet": pkg.TenantSpec(name="quiet")}))
        try:
            arena = make()
            out = _drive(arena, seq)
            return out, dict(arena._qos.rows)
        finally:
            pkg.set_tenancy(None)

    got = run(TT, lambda: StateArena(4, max_bytes=1 << 14, device="cpu",
                                     sharding=meshlib.data_sharding(mesh8, 1), shards=8))
    want = run(JT, lambda: JaxArena(4, max_bytes=1 << 14, sharding=NamedSharding(jmesh8, P("data")), shards=8))
    assert got == want
    assert got[1]["quiet"] == 8 and got[1]["whale"] <= 16


def test_sharded_tree_arena_matches_jax(mesh8, jmesh8, budgets):
    """The joint TreeArena over the mesh: the same row maps as JAX's (at
    a fixed capacity), per-device blocks of every leaf, and scattered
    rows read back from their shard; the replicated layout writes every
    replica."""
    f32 = torch.float32
    tmpl = {"mean": ((2,), f32), "cov": ((2, 2), f32)}
    jtmpl = {"mean": jax.ShapeDtypeStruct((2,), jnp.float32), "cov": jax.ShapeDtypeStruct((2, 2), jnp.float32)}
    budgets(8 * 24, 8 * 24)  # 8 rows a shard: eviction, never growth
    seq = _key_sequences(4, calls=8)
    port = TreeArena(tmpl, device="cpu", sharding=meshlib.data_sharding(mesh8, 1), shards=8)
    ref = JaxTreeArena(jtmpl, sharding=NamedSharding(jmesh8, P("data")), shards=8)
    assert _drive(port, seq) == _drive(ref, seq)
    assert port.cap_s == 8 and port.counters()["evictions"] > 0
    keys, _, n_real = seq[-1]
    rows, scat = port.assign(keys, list(range(n_real)), n_real)
    # one entry a key (positions sharing a key share its entry)
    first = [i if k is None else keys.index(k) for i, k in enumerate(keys)]
    trees = [{"mean": np.full(2, v, np.float32), "cov": np.eye(2, dtype=np.float32) * v} for v in first]
    port.scatter(rows, scat, trees)
    per = len(keys) // 8
    local = port.device_rows(rows)
    for i in scat:
        s = int(rows[i]) // port.cap_s
        assert s == i // per
        assert float(port.state["mean"].parts[s][local[i], 0]) == float(first[i])
    rep = TreeArena(tmpl, device="cpu", sharding=meshlib.replicated(mesh8), shards=1)
    rows, scat = rep.assign(["x", "y"], [], 2)
    rep.scatter(rows, scat, [trees[3], trees[5]])
    for part in rep.state["cov"].parts:
        assert float(part[rows[1], 1, 1]) == 5.0


def test_sharded_arena_over_two_devices_keeps_each_shard_on_its_device():
    """A mesh whose blocks alternate between two devices (the CPU and
    the data-less `meta` device stand in for two cards): each device
    holds one buffer of its own shards' blocks, a global row maps to its
    device buffer's row (`device_rows`), and a scatter writes only the
    device that holds the row's shard."""
    mesh = make_mesh(n_data=4, devices=["cpu", "meta", "cpu", "meta"])
    arena = StateArena(2, device="cpu", sharding=meshlib.data_sharding(mesh, 1), shards=4)
    keys = [f"k{i}" for i in range(8)]
    rows, scat = arena.assign(keys, [], 8)
    assert [int(r) // arena.cap_s for r in rows] == [0, 0, 1, 1, 2, 2, 3, 3]
    lvl = arena.state[0]
    cpu_buf, meta_buf = lvl.parts[0], lvl.parts[1]
    assert lvl.parts[2] is cpu_buf and lvl.parts[3] is meta_buf
    assert cpu_buf.device.type == "cpu" and meta_buf.device.type == "meta"
    assert cpu_buf.shape[0] == meta_buf.shape[0] == 2 * arena.cap_s
    local = arena.device_rows(rows)
    # shard 2 is the CPU's second block: its rows start at cap_s there
    np.testing.assert_array_equal(local, [int(r) % arena.cap_s + (arena.cap_s if int(r) >= 2 * arena.cap_s else 0)
                                          for r in rows])
    entries = [(float(i + 1), 0.0, np.zeros(2, np.float32), 0, 1.0, 5) for i in range(8)]
    arena.scatter(rows, scat, entries)
    for i in (0, 1, 4, 5):  # the CPU's shards 0 and 2
        assert float(cpu_buf[local[i]]) == float(i + 1)
    assert arena.device_bytes() == arena.cap_s * arena.row_bytes
