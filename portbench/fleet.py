"""The cell's inputs: the fleet's series, made from `--seed`, and the one
traffic generator, which reads a mix's parameters.

Time is virtual. Sweep k judges at `now(k) = T0 + 60 * advance * k`: every
sweep moves each current and baseline window forward by `advance_points`
60 s points, so no re-check sees a window twice. A document's series are
rows of three host pools, made once at set-up:

  * `hist` [P, Th]: 7-day histories at a 60 s step;
  * `cont` [P, Tc + span]: the current windows and their continuation,
    grown between sweeps as far as the run's sweeps reach;
  * `base` [P, Tc + span]: the canaries' baseline windows, likewise.

Row `pool * A + a` serves alias `a` of every document whose `pool` is
that initial service: a newcomer reuses an initial service's series
under new series names (new app, new URLs), so its fit is cold. Nothing
in a run may key fits on content: two services with equal series are two
services.

The schedule of births, expiries, regressions and the correctness sample
is drawn from the seed and does not depend on what the program answers;
every seed gets the same counts in another order.
"""

from __future__ import annotations

import dataclasses
import time
import typing
import urllib.parse

import numpy as np

T0 = 1_760_000_040  # the virtual clock of sweep 0, a whole minute
STEP = 60  # seconds between points (metricsquery.go:73-78)
BASE_LAG = 3600  # a canary's baseline window lies an hour before its current one
FAR = 86_400 * 365  # the endTime of a document that never expires in the run

# rows generated per device call: 2,048 x 10,080 f32 is 83 MB
GEN_ROWS = 2048
# points the current and baseline pools grow by at a time
CONT_BLOCK = 64


def now_of(sweep: int, advance: int) -> int:
    return T0 + STEP * advance * sweep


def rfc3339(t: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(t))


@dataclasses.dataclass
class FleetShape:
    services: int
    aliases: tuple
    history_points: int
    current_points: int
    canary_every: int
    levels: np.ndarray  # [A] the typical level of each alias
    sds: np.ndarray  # [A] its point-to-point spread in the history
    level_spread: float  # services' levels are level * exp(level_spread * N(0, 1))
    current_sd: float  # a current or baseline point: level + current_sd * sd * N(0, 1) ...
    current_clip: float  # ... clipped to level +/- current_clip * sd

    @staticmethod
    def from_config(cfg: dict, services: int | None = None) -> "FleetShape":
        f = cfg["fleet"]
        series = cfg["series"]
        aliases = tuple(f["aliases"])
        return FleetShape(
            services=int(services or f["services"]),
            aliases=aliases,
            history_points=int(f["history_points"]),
            current_points=int(f["current_points"]),
            canary_every=int(f["canary_every"]),
            levels=np.asarray([series[a]["level"] for a in aliases], np.float64),
            sds=np.asarray([series[a]["sd"] for a in aliases], np.float64),
            level_spread=float(f["level_spread"]),
            current_sd=float(f["current_sd"]),
            current_clip=float(f["current_clip"]),
        )


@dataclasses.dataclass
class Pools:
    hist: np.ndarray  # [P, Th] float32
    cont: np.ndarray  # [P, Tc + span] float32
    base: np.ndarray  # [P, Tc + span] float32
    sd: np.ndarray  # [P] float64, each row's generating spread
    level: np.ndarray  # [P] float64, each row's level
    shape: FleetShape
    seed: int
    device: typing.Any

    def ensure(self, width: int) -> None:
        """Grow the current and baseline pools to at least `width` points,
        CONT_BLOCK points at a time. Block b is drawn from a generator of
        its own (the seed and b), so the series do not depend on how far
        or in how many steps a run grew them."""
        import torch

        while self.cont.shape[1] < width:
            b = self.cont.shape[1] // CONT_BLOCK
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(np.random.SeedSequence([self.seed, 2, b]).generate_state(1, np.uint64)[0]))
            grown = []
            for old in (self.cont, self.base):
                block = np.empty((old.shape[0], CONT_BLOCK), np.float32)
                for r0 in range(0, old.shape[0], GEN_ROWS):
                    r1 = min(old.shape[0], r0 + GEN_ROWS)
                    lv = torch.as_tensor(self.level[r0:r1, None], dtype=torch.float32, device=self.device)
                    s = torch.as_tensor(self.sd[r0:r1, None], dtype=torch.float32, device=self.device)
                    z = torch.randn((r1 - r0, CONT_BLOCK), generator=gen, device=self.device)
                    c = self.shape.current_clip * s
                    block[r0:r1] = (lv + (self.shape.current_sd * s * z).clamp(-c, c)).cpu().numpy()
                grown.append(np.concatenate([old, block], axis=1))
            self.cont, self.base = grown


def make_pools(shape: FleetShape, seed: int, device) -> Pools:
    """The series of the initial fleet, drawn on `device` by a torch
    Generator seeded with `seed`, in blocks of GEN_ROWS rows, and copied
    to host float32 pools. Histories are clamped at 0 (counts and
    latencies are never negative); current and baseline points stay
    within `current_clip` spreads of the level, inside every band the
    configuration's thresholds draw, so a healthy service stays healthy.
    The current and baseline pools start empty and grow on demand
    (`Pools.ensure`), as far as the run's sweeps reach."""
    import torch

    a = len(shape.aliases)
    p = shape.services * a
    rng = np.random.default_rng(seed)
    factor = np.exp(shape.level_spread * rng.standard_normal(p))
    level = np.tile(shape.levels, shape.services) * factor
    sd = np.tile(shape.sds, shape.services) * factor
    pools = Pools(
        hist=np.empty((p, shape.history_points), np.float32),
        cont=np.empty((p, 0), np.float32),
        base=np.empty((p, 0), np.float32),
        sd=sd, level=level, shape=shape, seed=seed, device=device,
    )
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for r0 in range(0, p, GEN_ROWS):
        r1 = min(p, r0 + GEN_ROWS)
        lv = torch.as_tensor(level[r0:r1, None], dtype=torch.float32, device=device)
        s = torch.as_tensor(sd[r0:r1, None], dtype=torch.float32, device=device)
        z = torch.randn((r1 - r0, shape.history_points), generator=gen, device=device)
        pools.hist[r0:r1] = (lv + s * z).clamp_min_(0.0).cpu().numpy()
    return pools


class Doc(typing.NamedTuple):
    """One job document of the schedule (a tuple of plain values, which
    the collector stops tracking: the harness's own objects should not
    lengthen the worker's garbage collections)."""

    n: int  # its number: id job-<n>, app app<n>
    birth: int  # the sweep before which it is created
    end: int | None  # the sweep at which its endTime has passed (None: never in the run)
    pool: int  # the initial service whose series rows it reads
    canary: bool
    spiked: bool  # its first window carries a regression
    sampled: bool  # its verdicts are held to the reference

    @property
    def id(self) -> str:
        return f"job-{self.n}"


@dataclasses.dataclass
class Traffic:
    """A mix's parameters (`traffic/<name>.json`)."""

    advance_points: int
    churn: float  # share of the open fleet whose endTime passes each sweep
    regressed_share: float  # share of newcomers whose first window carries a regression
    regression_alias: str
    regression_points: int
    regression_sds: float
    sample_docs: int  # initial documents held to the reference
    sample_newcomer_share: float  # newcomers held to the reference

    @staticmethod
    def from_dict(d: dict) -> "Traffic":
        return Traffic(
            advance_points=int(d["advance_points"]),
            churn=float(d["churn"]),
            regressed_share=float(d.get("regressed_share", 0.0)),
            regression_alias=str(d.get("regression_alias", "")),
            regression_points=int(d.get("regression_points", 0)),
            regression_sds=float(d.get("regression_sds", 0.0)),
            sample_docs=int(d["sample_docs"]),
            sample_newcomer_share=float(d.get("sample_newcomer_share", 0.0)),
        )


class Schedule:
    """Births, expiries, regressions and the sample, sweep by sweep.

    With churn c > 0 a document lives L = round(1 / c) sweeps: the
    initial fleet's expiries are staggered evenly over sweeps 1..L, and
    before every sweep as many newcomers are born as documents left at
    the one before (their endTime passed, or a regression completed
    them), so the open fleet keeps its size. Counts depend on the
    shape and the mix alone; the seed picks which."""

    def __init__(self, shape: FleetShape, traffic: Traffic, seed: int):
        self.shape = shape
        self.traffic = traffic
        self.rng = np.random.default_rng([seed, 1])
        n = shape.services
        self.life = round(1.0 / traffic.churn) if traffic.churn > 0 else 0
        order = self.rng.permutation(n)
        sampled = set(self.rng.choice(n, size=min(traffic.sample_docs, n), replace=False).tolist())
        self.docs: list[Doc] = []
        self.by_sweep: dict[int, list[Doc]] = {0: []}
        for i in range(n):
            end = 1 + int(order[i]) % self.life if self.life else None
            d = Doc(i, 0, end, i, i % shape.canary_every == 0, False, i in sampled)
            self.docs.append(d)
            self.by_sweep[0].append(d)
        self.planned = 0  # newcomers are planned up to this sweep

    def leaving(self, sweep: int) -> int:
        """Documents whose last verdict falls in `sweep`."""
        return sum(1 for d in self.by_sweep.get(sweep, ()) if d.spiked) + sum(
            1 for d in self.docs if d.end == sweep and not d.spiked
        )

    def newcomers(self, sweep: int) -> list[Doc]:
        """The documents born before `sweep` (planned once, in order)."""
        while self.planned < sweep:
            k = self.planned + 1
            self.by_sweep[k] = self._plan(k)
            self.planned = k
        return self.by_sweep.get(sweep, []) if sweep > 0 else []

    def _plan(self, k: int) -> list[Doc]:
        if not self.life:
            return []
        count = self.leaving(k - 1)
        t = self.traffic
        n_spiked = int(round(count * t.regressed_share))
        spiked = set(self.rng.choice(count, size=n_spiked, replace=False).tolist()) if count else set()
        pools = self.rng.integers(0, self.shape.services, size=count)
        sample = self.rng.random(count) < t.sample_newcomer_share
        out = []
        for j in range(count):
            n = len(self.docs)
            d = Doc(n, k, k + self.life, int(pools[j]), n % self.shape.canary_every == 0, j in spiked,
                    bool(sample[j]))
            self.docs.append(d)
            out.append(d)
        return out


class Urls:
    """The documents' query URLs and what each one answers."""

    HIST, CUR, BASE = 0, 1, 2

    def __init__(self, shape: FleetShape, traffic: Traffic):
        self.shape = shape
        self.advance = traffic.advance_points
        self.regression_alias = traffic.regression_alias
        self.table: dict[str, tuple] = {}  # url -> (kind, row, birth, spiked)

    def hist_times(self, birth: int) -> np.ndarray:
        """A history ends a point before its document's first window."""
        th, tc = self.shape.history_points, self.shape.current_points
        end = now_of(birth, self.advance) - STEP * (tc + 1)
        return end - STEP * (th - 1) + STEP * np.arange(th, dtype=np.int64)

    def document(self, d: Doc):
        from foremast_tpu_torch.jobs import Document

        a_n = len(self.shape.aliases)
        ht = self.hist_times(d.birth)
        parts = {"current": [], "historical": [], "baseline": []}
        for a, alias in enumerate(self.shape.aliases):
            row = d.pool * a_n + a
            sel = urllib.parse.quote(f'{alias}{{app="app{d.n}"}}')
            prom = "http://prometheus:9090/api/v1/query_range?query="
            cur = f"{prom}{sel}&step={STEP}"
            hist = f"{prom}{sel}&start={int(ht[0])}&end={int(ht[-1])}&step={STEP}"
            self.table[hist] = (self.HIST, row, d.birth, False)
            self.table[cur] = (self.CUR, row, d.birth, d.spiked and alias == self.regression_alias)
            parts["current"].append(f"{alias}== {cur}")
            parts["historical"].append(f"{alias}== {hist}")
            if d.canary:
                bsel = urllib.parse.quote(f'{alias}_baseline{{app="app{d.n}"}}')
                base = f"{prom}{bsel}&step={STEP}"
                self.table[base] = (self.BASE, row, d.birth, False)
                parts["baseline"].append(f"{alias}== {base}")
        end = now_of(d.end, self.advance) - STEP // 2 if d.end is not None else T0 + FAR
        return Document(
            id=d.id,
            app_name=f"app{d.n}",
            end_time=rfc3339(end),
            current_config=" ||".join(parts["current"]),
            historical_config=" ||".join(parts["historical"]),
            baseline_config=" ||".join(parts["baseline"]),
            strategy="canary" if d.canary else "continuous",
        )


def window_values(pools: Pools, traffic: Traffic, tc: int, kind: int, row: int, offset: int,
                  spiked: bool) -> np.ndarray:
    """The values a current (Urls.CUR) or baseline (Urls.BASE) URL
    answers at `offset` points past its document's birth; a regression
    lifts the last `regression_points` of the first current window by
    `regression_sds` spreads."""
    src = pools.cont if kind == Urls.CUR else pools.base
    if offset + tc > src.shape[1]:
        raise IndexError(f"offset {offset} past the pools' {src.shape[1]} points: Pools.ensure first")
    v = src[row, offset : offset + tc]
    if spiked and offset == 0 and traffic.regression_points:
        v = v.copy()
        v[-traffic.regression_points :] += np.float32(traffic.regression_sds * pools.sd[row])
    return v
