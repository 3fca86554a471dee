"""The device mesh of one process: a (data, model) grid of `torch.device`s.

The JAX package's `parallel/mesh.py` builds a `jax.sharding.Mesh` and lets
XLA partition each program over it. The port has no partitioner, so a
mesh here is placement made explicit:

  * `data`  — the (service x metric) batch axis. An array sharded over
    it is a `Blocks`: one contiguous row block per data-axis device, in
    the grid's order — block i lives on device i and covers rows
    [i*B/n, (i+1)*B/n), JAX's `P("data", ...)` layout and the arenas'
    block placement rule;
  * `model` — the sequence axis of the context-parallel scans
    (`parallel/seqparallel.py`): the time axis of a long history splits
    into contiguous blocks over it.

A sharded program is the single-device program called once per block
under `torch.cuda.device(block.device)`, on that device's current stream
(`per_block`); its outputs come back as `Blocks` again. Nothing here
synchronizes: uploads go through `ops.windows.to_device` (pinned,
non-blocking), device-to-device moves are non-blocking copies, and the
one copy of a result to the host is the judge's (`engine.judge._HostCopy`).

A caller may list a device more than once (`["cuda:0"] * 4`, or
`["cpu"] * 8` in the tests): every partition, pad, local-row gather and
result gather then runs as it would over distinct cards. The default
device list never repeats a device.

Pod mode (`init_distributed`, a mesh over several processes) is not
here: `make_global_mesh` is the local mesh, ROADMAP.md Queue 1 item 7c.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os

import numpy as np
import torch

from foremast_tpu_torch.ops.windows import resolve_device, to_device

DATA_AXIS = "data"
MODEL_AXIS = "model"

log = logging.getLogger("foremast_tpu_torch.mesh")


class Mesh:
    """An [n_data, n_model] grid of torch devices with axis names
    (`data`, `model`). `shape` is `{"data": n_data, "model": n_model}`,
    as a JAX mesh's is."""

    def __init__(self, grid):
        self.devices = np.empty((len(grid), len(grid[0])), dtype=object)
        for i, row in enumerate(grid):
            for j, d in enumerate(row):
                self.devices[i, j] = torch.device(d)

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.devices.shape[0], MODEL_AXIS: self.devices.shape[1]}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def data_devices(self) -> list:
        """The device of each data-axis block: the grid's first column."""
        return list(self.devices[:, 0])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.ravel()]})"


def local_devices() -> list:
    """Every local card once, in index order; raises without a card."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_data: int | None = None, n_model: int = 1, devices: list | None = None) -> Mesh:
    """A (data, model) mesh over `devices` (default: every local card,
    no repeats; raises without a card). An explicit list may name a
    device several times. `n_data=None` derives it from the device count
    and `n_model`."""
    devs = list(devices) if devices is not None else local_devices()
    if n_data is None:
        n_data = len(devs) // n_model
    need = n_data * n_model
    if need > len(devs) or need < 1:
        raise ValueError(f"mesh {n_data}x{n_model} needs {need} devices, have {len(devs)}")
    return Mesh([devs[i * n_model : (i + 1) * n_model] for i in range(n_data)])


def make_global_mesh(n_model: int = 1) -> Mesh:
    """The (data, model) mesh over this process's cards. A mesh over
    several processes is pod mode (ROADMAP.md Queue 1 item 7c); here the
    model axis must divide the local card count, as it must divide a
    host's in the JAX package."""
    local = local_devices()
    if n_model > 1 and (n_model > len(local) or len(local) % n_model != 0):
        raise ValueError(
            f"model axis {n_model} must evenly divide the {len(local)} devices of a single host"
        )
    return make_mesh(n_model=n_model, devices=local)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a mesh puts an array: `spec` names the mesh axis of each
    array axis (None = whole), as a JAX PartitionSpec does; () is a
    replica on every data-axis device."""

    mesh: Mesh
    spec: tuple


def data_sharding(mesh: Mesh, ndim: int) -> Placement:
    """Leading axis over `data`, the rest whole."""
    return Placement(mesh, (DATA_AXIS,) + (None,) * (ndim - 1))


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, ())


def pad_to_multiple(n: int, k: int) -> int:
    """Smallest multiple of k >= n."""
    return ((n + k - 1) // k) * k


# -- sharded arrays ----------------------------------------------------------


class Blocks:
    """One array held as per-device parts: contiguous blocks along `axis`
    (0: rows over the data axis; -1: time over the model axis), or, with
    `replicated`, a whole copy on each device. A part may itself be a
    `Blocks` (a history split over both axes)."""

    __slots__ = ("parts", "axis", "replicated")

    def __init__(self, parts, axis: int = 0, replicated: bool = False):
        self.parts = tuple(parts)
        self.axis = axis
        self.replicated = replicated

    def __len__(self) -> int:
        return len(self.parts)

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    @property
    def devices(self) -> list:
        return [p.device for p in self.parts]

    @property
    def shape(self) -> tuple:
        first = tuple(self.parts[0].shape)
        if self.replicated:
            return first
        ax = self.axis % len(first)
        return first[:ax] + (sum(p.shape[ax] for p in self.parts),) + first[ax + 1 :]

    def nbytes(self) -> int:
        return sum(
            p.nbytes() if isinstance(p, Blocks) else p.numel() * p.element_size() for p in self.parts
        )

    def gather(self, device=None) -> torch.Tensor:
        """The whole array on `device` (default: the first part's), one
        copy a part (blocking only into host memory) — for checks and
        tests; the judge's results reach the host through
        `engine.judge._HostCopy`."""
        dev = torch.device(device) if device is not None else None
        parts = [p.gather(dev) if isinstance(p, Blocks) else p for p in self.parts]
        dev = dev or parts[0].device
        if self.replicated:
            return parts[0].to(dev)
        return torch.cat([p.to(dev, non_blocking=dev.type != "cpu") for p in parts], dim=self.axis)

    def __repr__(self) -> str:
        return f"Blocks({len(self.parts)} x {tuple(self.parts[0].shape)}, axis={self.axis}, on {self.devices})"


@dataclasses.dataclass(frozen=True)
class Fill:
    """A constant operand of `shape`, made on the device it lands on
    (`torch.full` there): a host constant would be a copy."""

    shape: tuple
    value: float | int | bool
    dtype: torch.dtype

    def make(self, rows: int, dev: torch.device) -> torch.Tensor:
        return torch.full((rows, *self.shape[1:]), self.value, dtype=self.dtype, device=dev)


def _is_node(x) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, (type, Fill))


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of a tree and of trees shaped like it:
    dataclass instances by field, NamedTuples, tuples and lists by
    position, dicts by key. Tensors, arrays, `Blocks`, `Fill`, None and
    scalars are leaves."""
    if isinstance(tree, Blocks):
        return fn(tree, *rest)
    if _is_node(tree):
        return dataclasses.replace(
            tree,
            **{
                f.name: tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
                for f in dataclasses.fields(tree)
                if f.init
            },
        )
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(lambda x: out.append(x), tree)
    return out


def device_scope(dev: torch.device):
    """`torch.cuda.device(dev)` for a card; nothing for the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def stack_blocks(outs: list, axis: int = 0, replicated: bool = False):
    """Per-block results (one tree each) -> one tree whose tensor leaves
    are `Blocks`; None stays None, equal plain leaves stay plain."""

    def join(*parts):
        first = parts[0]
        if first is None:
            return None
        if isinstance(first, (torch.Tensor, Blocks)):
            return Blocks(parts, axis=axis, replicated=replicated)
        if all(p == first for p in parts[1:]):
            return first
        return Blocks(parts, axis=axis, replicated=replicated)

    return tree_map(join, outs[0], *outs[1:])


def _block_leaves(tree) -> list:
    return [x for x in tree_leaves(tree) if isinstance(x, Blocks)]


def device_runs(devices) -> list:
    """(start, stop) of each run of consecutive blocks on one device."""
    runs = []
    for i, d in enumerate(devices):
        if runs and devices[runs[-1][0]] == d:
            runs[-1][1] = i + 1
        else:
            runs.append([i, i + 1])
    return [tuple(r) for r in runs]


def device_slots(devices) -> tuple[list, list, list]:
    """(the distinct devices in first-seen order, each block's index into
    them, each block's rank among its device's blocks)."""
    uniq, part, rank = [], [], []
    for d in devices:
        if d not in uniq:
            uniq.append(d)
        p = uniq.index(d)
        rank.append(part.count(p))
        part.append(p)
    return uniq, part, rank


def join_rows(parts) -> torch.Tensor:
    """Row blocks of one device as one tensor: a view when they lie end to
    end in one buffer (as `shard_leading` and `per_block` leave them),
    else one concatenation."""
    p0 = parts[0]
    if len(parts) == 1:
        return p0
    rows = sum(p.shape[0] for p in parts)
    adjacent = all(p.is_contiguous() and p.dtype == p0.dtype for p in parts) and all(
        q.untyped_storage().data_ptr() == p0.untyped_storage().data_ptr()
        and q.storage_offset() == p.storage_offset() + p.numel()
        for p, q in zip(parts, parts[1:])
    )
    if adjacent:
        tail = tuple(p0.shape[1:])
        row = int(np.prod(tail, dtype=np.int64))
        return torch.as_strided(p0, (rows, *tail), (row, *p0.stride()[1:]), p0.storage_offset())
    return torch.cat(parts)


def per_block(fn, *args, merge: bool = False, **kwargs):
    """Run `fn` once per block: every `Blocks` leaf of the arguments is
    replaced by its i-th part and the call runs under that part's device
    (its current stream). Returns `fn`'s result with `Blocks` leaves —
    or `fn(*args, **kwargs)` itself when no argument is sharded, which
    is the plain judge's whole cost.

    `merge=True` (for row-wise `fn`: every output row depends only on the
    same rows of the row-split operands) makes ONE call per run of
    consecutive blocks on one device: their row parts joined
    (`join_rows`), a part every block of the run shares (a device's
    arena buffer, a replica) passed once, and the outputs split back
    into blocks. A device's launches then do not grow with its blocks."""
    blocks = _block_leaves((args, kwargs))
    if not blocks:
        return fn(*args, **kwargs)
    n = len(blocks[0])
    if any(len(b) != n for b in blocks):
        raise ValueError(f"per_block: operands split into {sorted({len(b) for b in blocks})} blocks")
    devices = [blocks[0].parts[i].device for i in range(n)]
    runs = device_runs(devices) if merge and blocks[0].axis == 0 else [(i, i + 1) for i in range(n)]
    outs = []
    for lo, hi in runs:
        if hi - lo == 1:
            a, kw = tree_map(lambda x: x.parts[lo] if isinstance(x, Blocks) else x, (args, kwargs))
            with device_scope(devices[lo]):
                outs.append(fn(*a, **kw))
            continue
        rowwise = [b for b in blocks if any(p is not b.parts[lo] for p in b.parts[lo:hi])]

        def pick(x):
            if not isinstance(x, Blocks):
                return x
            parts = x.parts[lo:hi]
            if all(p is parts[0] for p in parts):
                return parts[0]
            return join_rows(parts)

        a, kw = tree_map(pick, (args, kwargs))
        with device_scope(devices[lo]):
            out = fn(*a, **kw)
        if not rowwise:
            outs.extend([out] * (hi - lo))
            continue
        start = 0
        for p in rowwise[0].parts[lo:hi]:
            size = p.shape[0]
            outs.append(
                tree_map(lambda t, s=start, n=size: t.narrow(0, s, n) if isinstance(t, torch.Tensor) else t, out)
            )
            start += size
    return stack_blocks(outs, axis=blocks[0].axis, replicated=all(b.replicated for b in blocks))


def _put(x, dev: torch.device) -> torch.Tensor:
    """One part on `dev`: host data through `to_device` (pinned,
    non-blocking), device data by a non-blocking copy (none when it is
    there already)."""
    if isinstance(x, torch.Tensor) and x.device.type != "cpu":
        return x.to(dev, non_blocking=True)
    return to_device(x, dev)


def place(tree, device: torch.device):
    """Every host leaf of `tree` on one device (the plain judge's
    placement): numpy and CPU tensors through `to_device`, `Fill`s made
    there."""

    def put(a):
        if a is None or isinstance(a, (Blocks, int, float, bool, str)):
            return a
        if isinstance(a, Fill):
            return a.make(a.shape[0], device)
        return _put(a, device)

    return tree_map(put, tree)


def _split(a, devs: list):
    n = a.shape[0]
    k = len(devs)
    if n % k:
        raise ValueError(f"leading axis {n} is not a multiple of the data axis {k}")
    per = n // k
    if isinstance(a, Fill):
        parts = []
        for lo, hi in device_runs(devs):
            made = a.make((hi - lo) * per, devs[lo])
            parts.extend(made[(i - lo) * per : (i - lo + 1) * per] for i in range(lo, hi))
        return Blocks(parts)
    host = not isinstance(a, torch.Tensor) or a.device.type == "cpu"
    if host:
        # staged in pinned memory ONCE for the cards
        a = a.contiguous() if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
        if any(d.type == "cuda" for d in devs) and not a.is_pinned():
            a = a.pin_memory()
    parts = []
    for lo, hi in device_runs(devs):
        # one copy a run of blocks on one device (a host block bound for
        # the CPU is a copy that does not alias `a`), the blocks views of it
        d, rows = devs[lo], a[lo * per : hi * per]
        if host:
            on = rows.to(d, non_blocking=True) if d.type == "cuda" else rows.clone()
        else:
            on = rows.to(d, non_blocking=True)
        parts.extend(on[(i - lo) * per : (i - lo + 1) * per] for i in range(lo, hi))
    return Blocks(parts)


def shard_leading(tree, mesh: Mesh):
    """Every array leaf of `tree` with its leading axis over `data`: one
    contiguous row block per data-axis device (`Blocks`). Leaves already
    sharded, None and scalars pass through."""
    devs = mesh.data_devices

    def put(a):
        if a is None or isinstance(a, (Blocks, int, float, bool, str)):
            return a
        return _split(a, devs)

    return tree_map(put, tree)


def replicate(tree, mesh: Mesh):
    """A whole copy of every array leaf on each data-axis device (one a
    device, shared by the blocks a device holds)."""
    uniq, part, _ = device_slots(mesh.data_devices)

    def put(a):
        if a is None or isinstance(a, (Blocks, int, float, bool, str)):
            return a
        copies = [a.make(a.shape[0], d) if isinstance(a, Fill) else _put(a, d) for d in uniq]
        return Blocks([copies[p] for p in part], replicated=True)

    return tree_map(put, tree)


def shard_time(a, mesh: Mesh) -> Blocks:
    """A [B, T] array over both axes: row blocks over `data`, each split
    into contiguous time blocks over `model` (JAX's P("data", "model"))."""
    if isinstance(a, Blocks):
        return a
    n_data, n_model = mesh.devices.shape
    b, t = a.shape
    if b % n_data or t % n_model:
        raise ValueError(f"[{b}, {t}] does not split over a {n_data}x{n_model} mesh")
    pb, pt = b // n_data, t // n_model
    return Blocks(
        [
            Blocks(
                [_put(a[i * pb : (i + 1) * pb, j * pt : (j + 1) * pt], mesh.devices[i, j]) for j in range(n_model)],
                axis=-1,
            )
            for i in range(n_data)
        ]
    )


def shard_rows_take(tree, rows, merge: bool = False):
    """Device-local row gather from data-axis-sharded arena state: every
    leaf of `tree` is held as its shard blocks (`Blocks`) and `rows` [B]
    (sharded over the same axis) holds each block's LOCAL row indices —
    the arena's block placement rule puts position i's row on the device
    of batch position i, so each block gathers from its own rows and no
    row crosses a device. With `merge=True` a device's blocks share one
    buffer (`engine.arena`: [k * cap_s, ...] for its k blocks) and `rows`
    index that buffer (`arena.device_rows`)."""
    return per_block(lambda t, r: tree_map(lambda a: a.index_select(0, r.long()), t), tree, rows, merge=merge)


def assert_partitioned(arr, n_data: int) -> None:
    """In-run proof that the leading batch axis is partitioned: `n_data`
    blocks of exactly rows/n_data rows each. Reads block shapes only,
    no data."""
    if not isinstance(arr, Blocks) or arr.replicated:
        raise AssertionError(f"batch not sharded over the data axis: {type(arr).__name__}")
    rows = arr.shape[0]
    if rows % n_data != 0:
        raise AssertionError(f"batch rows {rows} not a multiple of the data axis {n_data}")
    want = rows // n_data
    got = [p.shape[0] for p in arr.parts]
    if len(got) != n_data or any(g != want for g in got):
        raise AssertionError(
            f"batch leading axis not partitioned over the mesh: {len(got)} blocks of rows "
            f"{got[:4]}..., want {n_data} of {want} (= {rows}/{n_data})"
        )


# -- the worker's device mesh ------------------------------------------------


def device_mesh_spec(env: dict | None = None) -> tuple[int | None, int] | None:
    """Parse `FOREMAST_DEVICE_MESH` (+ `FOREMAST_DEVICE_MESH_MODEL`).

    Returns (n_data, n_model) for `make_mesh`, or None when the device
    mesh is disabled. Spellings, as in the JAX package:

      * unset / "auto" — all local devices on the data axis;
      * "0" / "off" / "none" / "disabled" — no mesh;
      * "N"            — N devices on the data axis;
      * "NxM"          — an explicit (data, model) grid (zero on either
        axis disables; `FOREMAST_DEVICE_MESH_MODEL` sets M for the other
        spellings).

    Malformed values warn and fall back to "auto": a templated env must
    never kill worker startup."""
    e = os.environ if env is None else env
    raw = (e.get("FOREMAST_DEVICE_MESH") or "auto").strip().lower()
    n_model = 1
    raw_model = (e.get("FOREMAST_DEVICE_MESH_MODEL") or "").strip()
    if raw_model:
        try:
            n_model = max(1, int(raw_model))
        except ValueError:
            log.warning("FOREMAST_DEVICE_MESH_MODEL=%r unparseable; using 1", raw_model)
    if raw in ("0", "off", "none", "disabled"):
        return None
    if raw in ("auto", ""):
        return (None, n_model)
    try:
        if "x" in raw:
            d, _, m = raw.partition("x")
            di, mi = int(d), int(m)
            if di <= 0 or mi <= 0:
                return None
            return (di, mi)
        return (max(1, int(raw)), n_model)
    except ValueError:
        log.warning("FOREMAST_DEVICE_MESH=%r unparseable; using 'auto'", raw)
        return (None, n_model)


def _multi_process() -> bool:
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def worker_device_mesh(env: dict | None = None, device="cuda") -> Mesh | None:
    """The mesh a worker's judge should span, from the env, for a worker
    on `device`.

    None means the plain single-device judge: the mesh is disabled, the
    worker runs on the CPU, the grid resolves to one device (placement
    that changes nothing skips the wrapper), or the process is one of a
    process group (pod mode builds its mesh explicitly). The mesh never
    repeats a device; an infeasible grid warns and falls back to the
    all-local auto mesh."""
    spec = device_mesh_spec(env)
    if spec is None or torch.device(device).type != "cuda" or _multi_process():
        return None
    n_devs = len(local_devices())
    n_data, n_model = spec
    if n_data is None:
        n_data = max(1, n_devs // n_model)
    if n_data * n_model > n_devs:
        log.warning(
            "FOREMAST_DEVICE_MESH %dx%d needs %d devices, have %d; falling back to the all-local auto mesh",
            n_data, n_model, n_data * n_model, n_devs,
        )
        n_data, n_model = n_devs, 1
    if n_data * n_model <= 1:
        return None
    return make_mesh(n_data=n_data, n_model=n_model)
