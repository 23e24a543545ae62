"""The ``data`` and ``data x model`` meshes of a multi-process run, on
``torch.distributed``.

The counterpart of ``one_class_ffm_tpu/parallel/mesh.py``.  There the same
jitted epoch runs on one device or many, and GSPMD inserts the collectives:
sharding is pure data placement.  PyTorch has no GSPMD, so here the solver
is explicit.  A ``Mesh`` is ``size`` data ranks, one process each (times
``n_model`` ranks on a model axis, below); data rank ``r`` holds:

  * its slice of the rows (users m, items n, each ``rows / size`` long and
    contiguous), of the shard-aligned positive stream (``pad_labels
    shard_rows=``: every entry on its user's rank) and of both sides'
    orders: a blocked side's blocks (``blocked_bm`` divides the rows per
    rank, so blocks nest in ranks) and its head chunks (each chunk on the
    rank of the row that owns it), a COO side's list of the rank's stream
    slice (``layout.coo_list``); the caches P/Q, the side sums a/b and the
    residual carries are row-, block-, chunk- or stream-sliced the same
    way;
  * a full copy of the block tables W/H and the per-feature arrays (reg,
    colsq), as the JAX package replicates them.

Every rank runs the same CG on the replicated table-space variable; the
collectives sit where the JAX solver's are (``tests/test_sharding.py``
pins that budget in the compiled HLO): per half-solve one all-gather of the
other side's cache rows for the stream, the gradient's and the k x k Grams'
all-reduces, the carry's cross-order propagation; inside each CG iteration
exactly one all-reduce, of Hv's table-space output (a head tier's and a
COO side's partial sums are added into it first).

The 2-D mesh (``make_mesh2(N, M)``, ``--mesh NxM``) is one world of N x M
ranks: rank ``r`` sits at data index ``r // M`` and model index ``r % M``.
The data-axis collectives above run on the data group of the rank's model
index; every block table of at least ``model_min_rows`` rows (padded to a
multiple of M by ``d_multiple``) is row-sharded on the model axis, each
rank holding its model index's rows; smaller tables are replicated.  A
half-solve all-gathers its model-sharded table over the model group once,
runs CG as on the 1-D mesh and keeps its own rows of the new table.

``shard_data`` / ``shard_state`` cut a rank's slice from the full host
arrays, which every rank builds the same way from the seed (as
``multihost.py`` describes).  The collective helpers count their calls and
bytes per call site, scope and axis (``Mesh.census``): the tests and
chip_smoke read that census.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .distributed import rank_device


@dataclass
class Census:
    """Calls and bytes of each collective, by (op, call site, scope, axis):
    the scope is ``"cg"`` inside a CG loop, else ``"solve"``."""

    records: Dict[Tuple[str, str, str, str], list] = field(
        default_factory=dict)

    def add(self, op: str, site: str, scope: str, nbytes: int,
            axis: str = "data") -> None:
        rec = self.records.setdefault((op, site, scope, axis), [0, 0])
        rec[0] += 1
        rec[1] += int(nbytes)

    def reset(self) -> None:
        self.records.clear()

    def rows(self):
        """[(op, site, scope, calls, bytes)], sorted; a call on the model
        axis is named ``op@model``."""
        return sorted((o if ax == "data" else f"{o}@{ax}", site, s, c, b)
                      for (o, site, s, ax), (c, b) in self.records.items())


class Mesh:
    """``size`` data ranks of ``group`` (the default group when None), this
    process being data rank ``rank`` on ``device``; on a 2-D mesh also
    ``n_model`` ranks on the model axis of ``model_group``, this process
    being model rank ``model_rank``.  An axis of size 1 needs no group: its
    collectives return their input."""

    def __init__(self, size: int, rank: int, device: torch.device,
                 group=None, axis: str = "data", n_model: int = 1,
                 model_rank: int = 0, model_group=None):
        self.size, self.rank = int(size), int(rank)
        self.n_model, self.model_rank = int(n_model), int(model_rank)
        self.device = torch.device(device)
        self.group, self.model_group = group, model_group
        self.axis = axis
        self.census = Census()
        self._scope = "solve"
        # gloo reduces on the host: a card's tensors are staged there
        # explicitly (the transport, not the backend, changes)
        self._staged = (self.device.type == "cuda"
                        and max(self.size, self.n_model) > 1
                        and dist.get_backend(group) == "gloo")

    def rows(self, n: int) -> slice:
        """This rank's slice of ``n`` rows (``n`` divisible by the size)."""
        return _part(n, self.size, self.rank, self.axis)

    def model_rows(self, n: int) -> slice:
        """This rank's slice of a model-sharded table of ``n`` rows."""
        return _part(n, self.n_model, self.model_rank, "model")

    @contextlib.contextmanager
    def scope(self, name: str):
        """Record the collectives of the block under ``name``."""
        saved, self._scope = self._scope, name
        try:
            yield
        finally:
            self._scope = saved

    def _send(self, t: torch.Tensor) -> torch.Tensor:
        """A contiguous copy of ``t`` at a float32 floor (float inputs), on
        the host when gloo stages a card's tensors."""
        dt = (torch.promote_types(t.dtype, torch.float32)
              if t.is_floating_point() else t.dtype)
        buf = t.to(dtype=dt, copy=True).contiguous()
        return buf.cpu() if self._staged else buf

    def all_reduce_sum(self, t: torch.Tensor, site: str) -> torch.Tensor:
        """The sum of ``t`` over the data ranks, at a float32 floor,
        returned at ``t``'s dtype on its device."""
        buf = self._send(t) if self.size > 1 else t
        self.census.add("all_reduce", site, self._scope,
                        buf.numel() * buf.element_size())
        if self.size == 1:
            return t
        dist.all_reduce(buf, group=self.group)
        return buf.to(device=t.device, dtype=t.dtype)

    def all_gather(self, t: torch.Tensor, site: str,
                   dim: int = 0) -> torch.Tensor:
        """Every data rank's ``t`` (equal shapes) concatenated along ``dim``
        in rank order, at ``t``'s dtype on its device."""
        return self._gather(t, site, dim, self.size, self.group, "data")

    def model_all_gather(self, t: torch.Tensor, site: str) -> torch.Tensor:
        """Every model rank's rows of a model-sharded table, in row order."""
        return self._gather(t, site, 0, self.n_model, self.model_group,
                            "model")

    def _gather(self, t, site, dim, n, group, axis):
        buf = self._send(t) if n > 1 else t
        self.census.add("all_gather", site, self._scope,
                        buf.numel() * buf.element_size() * n, axis)
        if n == 1:
            return t
        parts = [torch.empty_like(buf) for _ in range(n)]
        dist.all_gather(parts, buf, group=group)
        return torch.cat(parts, dim=dim).to(device=t.device, dtype=t.dtype)


def _part(n: int, size: int, rank: int, axis: str) -> slice:
    if n % size:
        raise ValueError(f"{n} rows do not divide the {axis} axis of size "
                         f"{size}")
    per = n // size
    return slice(rank * per, (rank + 1) * per)


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _rank_device(world: int, device) -> torch.device:
    dev = torch.device(device) if device is not None else (
        rank_device() if world > 1 else torch.device("cpu"))
    if dev.type == "cuda" and dev.index is None:
        # this rank's card (torch.cuda.set_device under NCCL)
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _launch_hint(spec: str, n: int, world: int) -> ValueError:
    return ValueError(
        f"--mesh {spec} needs {n} ranks, this run has {world}: launch it "
        f"as torchrun --nproc-per-node {n} -m one_class_ffm_torch ... "
        f"--mesh {spec} --distributed (one process per rank)")


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              device: Optional[torch.device | str] = None) -> Mesh:
    """The 1-D mesh over every rank of the process group (one rank per
    process: ``n_devices`` must equal the world size).  ``device``: where
    this rank's tensors live (default: its card under NCCL, else the
    CPU)."""
    world, rank = _world()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise _launch_hint(str(n), n, world)
    return Mesh(n, rank, _rank_device(world, device), axis=axis)


def make_mesh2(n_data: int, n_model: int,
               device: Optional[torch.device | str] = None) -> Mesh:
    """The 2-D ``data x model`` mesh over the N x M ranks of the process
    group: rank ``r`` at data index ``r // M`` and model index ``r % M``.
    Every rank creates every group, in the same order (``dist.new_group``'s
    rule): first the data groups (the ranks of one model index), then the
    model groups (the ranks of one data index)."""
    world, rank = _world()
    N, M = int(n_data), int(n_model)
    if N * M != world:
        raise _launch_hint(f"{N}x{M}", N * M, world)
    data_groups = [dist.new_group([d * M + j for d in range(N)])
                   for j in range(M)] if N > 1 and M > 1 else None
    model_groups = [dist.new_group([d * M + j for j in range(M)])
                    for d in range(N)] if N > 1 and M > 1 else None
    data_group = data_groups[rank % M] if data_groups else None
    model_group = model_groups[rank // M] if model_groups else None
    return Mesh(N, rank // M, _rank_device(world, device), group=data_group,
                n_model=M, model_rank=rank % M, model_group=model_group)


def resolve_mesh(spec: Optional[str],
                 device: Optional[torch.device | str] = None
                 ) -> Optional[Mesh]:
    """A CLI mesh spec as a Mesh (the reference's thread knob, train.cpp:174
    omp_set_num_threads):

      None / ""  -> no mesh (one device)
      "auto"     -> the 1-D data mesh over every rank
      "N", "Nx1" -> the 1-D data mesh; N must equal the world size
      "NxM"      -> the 2-D data x model mesh; N x M must equal it
    """
    if not spec:
        return None
    spec = spec.strip().lower()
    if spec == "auto":
        return make_mesh(device=device)
    if "x" in spec:
        nd, nm = (int(t) for t in spec.split("x", 1))
        if nm == 1:
            return make_mesh(nd, device=device)
        return make_mesh2(nd, nm, device=device)
    return make_mesh(int(spec), device=device)


# ---------------------------------------------------------------------------
# placement: each rank's slice of the full host arrays
# ---------------------------------------------------------------------------

# keys of the solver's data dict, by how a rank holds them
_ROWS_U = ("xu_idx", "xu_val", "cnt_u")
_ROWS_V = ("xv_idx", "xv_val", "cnt_v")
_STREAM = ("pos_u", "pos_v", "pos_w")
_BLK = ("take", "src", "own", "runs", "w")
_REPLICATED = ("reg_u", "reg_v", "colsq_u", "colsq_v")


def _sliced(a, sl: slice, dev):
    if isinstance(a, tuple):
        return tuple(None if x is None else _sliced(x, sl, dev) for x in a)
    return a[sl].contiguous().to(dev)


def _moved(a, dev):
    if hasattr(a, "_asdict"):  # a feature-major list
        return a._replace(**{k: v.to(dev) for k, v in a._asdict().items()
                             if isinstance(v, torch.Tensor)})
    if isinstance(a, tuple):
        return tuple(None if x is None else _moved(x, dev) for x in a)
    return a.to(dev)


def _np(t) -> np.ndarray:
    return t.cpu().numpy()


class _Order:
    """One side's order of the stream entries across the ranks, each rank's
    part contiguous in the all-gather of the ranks' flat carries: a blocked
    side's blocks then its head chunks; a COO side's entries of the rank's
    rows in stream order (the u side's stream slice; the v side's entries
    of the rank's items, ``stride`` slots per rank, the pads last).
    ``remap`` takes
    a flat index of the full data's order (tail slots, then the head slots
    of every chunk, the JAX package's; a COO side's stream position) to
    that gathered order."""

    def __init__(self, data, s: str, S: int, rows: int):
        pre = f"blk_{s}_"
        self.coo = f"coo_{s}" in data
        self.head = pre + "hd_row" in data
        if self.coo:
            nnz = data["pos_w"].shape[0]
            self.stride, self.slot = nnz // S, None
            if s == "v":  # each real entry to the rank of its item
                real = _np(data["pos_w"]) > 0
                owner = np.where(real, _np(data["pos_v"]).astype(np.int64)
                                 // (rows // S), -1)
                self.parts = [np.nonzero(owner == r)[0] for r in range(S)]
                self.stride = max(8, -(-max(p.size for p in self.parts)
                                       // 8) * 8)
                self.slot = np.zeros(nnz, np.int64)
                for r, part in enumerate(self.parts):
                    self.slot[part] = r * self.stride + np.arange(part.size)
            return
        nb, maxc = data[pre + "own"].shape
        self.tail = nb * maxc
        self.tail_l = self.tail // S
        self.nch_l, self.chunk = 0, 0
        if self.head:
            # each real chunk to the rank of its row, in chunk order; every
            # rank the same count of chunks (a multiple of 8), pads last
            hd_row = _np(data[pre + "hd_row"]).astype(np.int64)
            real = _np(data[pre + "hd_w"] != 0).any(axis=1)
            owner = np.where(real, hd_row // (rows // S), -1)
            self.chunk = data[pre + "hd_w"].shape[1]
            self.owner = owner
            self.local = np.zeros(owner.size, np.int64)
            counts = [int((owner == r).sum()) for r in range(S)]
            for r in range(S):
                self.local[owner == r] = np.arange(counts[r])
            self.nch_l = max(8, -(-max(counts) // 8) * 8)
        self.stride = self.tail_l + self.nch_l * self.chunk

    def remap(self, g: np.ndarray) -> np.ndarray:
        g = np.asarray(g, np.int64)
        if self.coo:
            return g if self.slot is None else self.slot[g]
        out = (g // self.tail_l) * self.stride + g % self.tail_l
        if self.head:
            hd = g >= self.tail
            c = np.where(hd, (g - self.tail) // max(self.chunk, 1), 0)
            o = np.where(hd, (g - self.tail) % max(self.chunk, 1), 0)
            own = self.owner[c]
            at = (np.maximum(own, 0) * self.stride + self.tail_l
                  + self.local[c] * self.chunk + o)
            out = np.where(hd, np.where(own >= 0, at, 0), out)
        return out


def shard_data(data: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """A rank's part of the solver's data (``make_device_data(...,
    blocked_shards=mesh.size)``), on ``mesh.device``: its rows of each
    side's fields, its slice of the shard-aligned stream, copies of the
    per-feature arrays, and each side's order:

      * a blocked side: its blocks; on a two-tier side the head chunks of
        its own rows (rows local to the rank; every rank the same count of
        chunks, the pads last; a rank without a head row keeps one, its
        first row, with pad chunks only), the head rows' lists rebuilt;
      * a COO side: its entries of the rank's rows in stream order (the u
        side's stream slice; the v side's entries of the rank's items,
        padded to a common count) and its list of them
        (``layout.coo_list``): own ids local, the other side's global, read
        from its gathered cache; each row's sums are the one-process
        sums.

    Each non-identity field's feature-major list is rebuilt over the rank's
    rows (row ids local to it); the u side's stream-to-slot map
    ``blk_u_inv`` becomes local to the rank's (tail, head) slots, and the
    cross-order maps index the all-gather of the ranks' flat carries."""
    from ..solver.torch_solver import feature_list

    S, dev, rank = mesh.size, mesh.device, mesh.rank
    m, n = data["xu_idx"][0].shape[0], data["xv_idx"][0].shape[0]
    nnz = data["pos_w"].shape[0]
    for what, size in (("user rows", m), ("item rows", n),
                       ("stream entries", nnz)):
        if size % S:
            raise ValueError(f"{size} {what} do not divide the data axis of "
                             f"size {S}")
    su, sv, ss = mesh.rows(m), mesh.rows(n), mesh.rows(nnz)
    L = nnz // S
    w_sl = data["pos_w"][ss]
    out: Dict[str, Any] = {}
    for key in _ROWS_U:
        out[key] = _sliced(data[key], su, dev)
    for key in _ROWS_V:
        out[key] = _sliced(data[key], sv, dev)
    for key in _STREAM:
        out[key] = _sliced(data[key], ss, dev)
    for key in _REPLICATED:
        out[key] = _moved(data[key], dev)
    for s, rows in (("u", su), ("v", sv)):
        idx, val = data[f"x{s}_idx"], data[f"x{s}_val"]
        out["xf_" + s] = tuple(
            None if fm is None else feature_list(
                _np(idx[fi][rows]), _host_floats(val[fi][rows]),
                fm.feat_ptr.numel() - 1, val[fi].dtype, dev)
            for fi, fm in enumerate(data["xf_" + s]))
    order = {s: _Order(data, s, S, rows)
             for s, rows in (("u", m), ("v", n))}
    lo = {"u": su.start, "v": sv.start}
    for s, o in (("u", "v"), ("v", "u")):
        pre, od = f"blk_{s}_", order[s]
        if od.coo:
            _coo_part(data, out, s, od, mesh, dev)
        else:
            nb = data[pre + "own"].shape[0]
            for key in _BLK:
                out[pre + key] = _sliced(data[pre + key], mesh.rows(nb), dev)
            if od.head:
                _head_part(data, out, s, od, rank, lo[s], L, dev)
        # the cross-order map into the other side's gathered order
        if od.coo:
            cross = _np(data[f"{pre}from_{o}"])[_np(out[pre + "pos"])]
        else:
            cross = _np(data[f"{pre}from_{o}"][mesh.rows(
                data[pre + "own"].shape[0])])
        out[f"{pre}from_{o}"] = torch.from_numpy(
            order[o].remap(cross).astype(np.int64)).to(dev)
        if od.head:
            hd = _np(data[f"{pre}hd_from_{o}"])[out.pop("_glob_" + s)]
            out[f"{pre}hd_from_{o}"] = torch.from_numpy(
                order[o].remap(hd).astype(np.int64)
                * (out[pre + "hd_w"] != 0).cpu().numpy()).to(dev)
    # the u side's stream-to-slot map, local to the rank's (tail, head)
    # slots: its stream slice holds only entries of its own slots (pads,
    # weight 0, point at slot 0)
    od = order["u"]
    inv = od.remap(_np(data["blk_u_inv"][ss])) - rank * od.stride
    out["blk_u_inv"] = torch.from_numpy(
        np.where(_np(w_sl) > 0, inv, 0).astype(np.int32)).to(dev)
    return out


def _coo_part(data, out, s: str, od: _Order, mesh: Mesh, dev) -> None:
    """A COO side's keys on a rank, in its order there (``_Order``): own ids
    local to the rank's rows, the other side's global (the passes read its
    gathered cache), the weights, and the side's list of those entries
    (with their weights in list order)."""
    from ..ops.layout import FeatureMajor, coo_list

    pre = f"blk_{s}_"
    if od.slot is None:  # the u side: the rank's stream slice
        pos = np.arange(mesh.rows(data["pos_w"].shape[0]).start,
                        mesh.rows(data["pos_w"].shape[0]).stop)
    else:  # the v side: the entries of the rank's items, padded
        pos = np.zeros(od.stride, np.int64)
        pos[: od.parts[mesh.rank].size] = od.parts[mesh.rank]
    w = data["pos_w"].cpu()[torch.from_numpy(pos)]
    if od.slot is not None:
        w[od.parts[mesh.rank].size:] = 0
    keep = _np(w) > 0
    lo_u = mesh.rows(data["xu_idx"][0].shape[0]).start
    lo_v = mesh.rows(data["xv_idx"][0].shape[0]).start
    pu = _np(data["pos_u"])[pos].astype(np.int64)
    pv = _np(data["pos_v"])[pos].astype(np.int64)
    if s == "u":
        seg, take = pu - lo_u, pv
        rows, rows_o = data["xu_idx"][0].shape[0] // mesh.size, \
            data["xv_idx"][0].shape[0]
    else:
        seg, take = pv - lo_v, pu
        rows, rows_o = data["xv_idx"][0].shape[0] // mesh.size, \
            data["xu_idx"][0].shape[0]
    seg, take = np.where(keep, seg, 0), np.where(keep, take, 0)
    out[pre + "w"] = w.to(dev)
    out[pre + "seg"] = torch.from_numpy(seg.astype(np.int32)).to(dev)
    out[pre + "take"] = torch.from_numpy(take.astype(np.int32)).to(dev)
    out[pre + "src"] = torch.arange(pos.size, dtype=torch.int32, device=dev)
    # each slot's stream position in the full data (``shard_state`` cuts a
    # stream-order carry by it)
    out[pre + "pos"] = torch.from_numpy(pos).to(dev)
    lst = coo_list(seg, take, keep, rows, rows_o)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    out["coo_" + s] = FeatureMajor(
        row=t(lst.row), val=w[torch.from_numpy(lst.pos).long()].to(dev),
        chunk_ptr=t(lst.chunk_ptr), feat_ptr=t(lst.feat_ptr),
        n_rows=lst.n_rows, combine=t(lst.combine),
        chunk_dst=t(lst.chunk_dst), slot_feat=t(lst.slot_feat),
        pos=t(lst.pos))


def _head_part(data, out, s: str, od: _Order, rank: int, lo: int, L: int,
               dev) -> None:
    """A two-tier side's head keys on a rank: the chunks of its own rows in
    chunk order, then pad chunks up to the common count."""
    from ..ops.layout import head_chunk_table
    from ..solver.torch_solver import feature_list

    pre = f"blk_{s}_"
    mine = np.nonzero(od.owner == rank)[0]
    nch, C = od.nch_l, od.chunk
    glob = np.full(nch, -1, np.int64)
    glob[: mine.size] = mine
    hd_rows = _np(data[pre + "hd_rows"]).astype(np.int64)
    rows_l = hd_rows[np.isin(hd_rows, np.unique(
        _np(data[pre + "hd_row"])[mine]))] - lo
    if rows_l.size == 0:
        rows_l = np.zeros(1, np.int64)  # a row without real chunks
    real = glob >= 0
    g = np.where(real, glob, 0)

    def pick(key, fill=0):
        a = _np(data[pre + key])[g]
        shape = (-1,) + (1,) * (a.ndim - 1)
        return np.where(real.reshape(shape), a, fill)

    hd_row = np.where(real, pick("hd_row") - lo, rows_l[0])
    hd_loc = np.where(real, np.searchsorted(rows_l, hd_row), 0)
    g_t = torch.from_numpy(g)
    hd_w = (data[pre + "hd_w"].cpu().index_select(0, g_t)
            * torch.from_numpy(real)[:, None])
    out[pre + "hd_take"] = torch.from_numpy(
        pick("hd_take").astype(np.int32)).to(dev)
    # the u side's head entries lie in its rank's stream slice
    src = pick("hd_src").astype(np.int64) - (rank * L if s == "u" else 0)
    valid = (hd_w != 0).numpy()
    out[pre + "hd_src"] = torch.from_numpy(
        np.where(valid, src, 0).astype(np.int32)).to(dev)
    out[pre + "hd_row"] = torch.from_numpy(hd_row.astype(np.int32)).to(dev)
    out[pre + "hd_loc"] = torch.from_numpy(hd_loc.astype(np.int32)).to(dev)
    out[pre + "hd_w"] = hd_w.to(dev)
    out[pre + "hd_rows"] = torch.from_numpy(rows_l).to(dev)
    out[pre + "hd_tab"] = torch.from_numpy(head_chunk_table(
        hd_loc, valid, rows_l.size)).to(dev)
    out[pre + "hd_glob"] = torch.from_numpy(glob).to(dev)
    out["_glob_" + s] = g
    xh = data.get("xh_" + s)
    if xh is not None:
        idx, val = out[f"x{s}_idx"], out[f"x{s}_val"]
        rl = torch.from_numpy(rows_l).to(dev)
        out["xh_" + s] = tuple(
            None if pair is None else (idx[fi].index_select(0, rl),
                                       val[fi].index_select(0, rl))
            for fi, pair in enumerate(xh))
        out["xhf_" + s] = tuple(
            None if fm is None else feature_list(
                _np(out["xh_" + s][fi][0]),
                _host_floats(out["xh_" + s][fi][1]),
                fm.feat_ptr.numel() - 1, val[fi].dtype, dev)
            for fi, fm in enumerate(data["xhf_" + s]))


def _host_floats(t: torch.Tensor) -> np.ndarray:
    """A float tensor as numpy, bfloat16 widened to float32 (exact)."""
    return t.to(torch.promote_types(t.dtype, torch.float32)).cpu().numpy()


def replicate_params(params, mesh: Mesh):
    """A copy of every block table on this rank's device."""
    return {f12: {name: torch.as_tensor(t).to(mesh.device, copy=True)
                  for name, t in blk.items()}
            for f12, blk in params.items()}


def model_sharded(rows: int, mesh: Optional[Mesh],
                  min_rows: Optional[int]) -> bool:
    """True when a table of ``rows`` (padded) rows is row-sharded on the
    model axis: a 2-D mesh and at least ``min_rows`` rows."""
    return (mesh is not None and mesh.n_model > 1 and min_rows is not None
            and rows >= min_rows)


def model_part(t: torch.Tensor, mesh: Optional[Mesh],
               min_rows: Optional[int], name: str = "table",
               axis: str = "model") -> torch.Tensor:
    """A whole (padded) table as a state holds it: this rank's model rows
    when it is model-sharded (``model_sharded``), else the table itself.
    A large table whose rows do not divide the axis is an error naming
    ``d_multiple`` (the JAX package's rule: no silent replication)."""
    if not model_sharded(t.shape[0], mesh, min_rows):
        return t
    if t.shape[0] % mesh.n_model:
        raise ValueError(
            f"table {name} has {t.shape[0]} rows, not divisible by "
            f"{axis}-axis size {mesh.n_model}; create the solver with "
            f"d_multiple={mesh.n_model} (make_device_data) so table dims "
            f"are padded for even sharding")
    return t[mesh.model_rows(t.shape[0])].contiguous()


def shard_params_model(params, mesh: Mesh, min_rows: int = 4096,
                       axis: str = "model"):
    """Block tables on the model axis (``model_part``): every table of at
    least ``min_rows`` rows cut to this rank's model rows, the others
    copied."""
    return {f12: {name: model_part(torch.as_tensor(t), mesh, min_rows,
                                   f"{name}[{f12}]", axis).to(mesh.device,
                                                              copy=True)
                  for name, t in blk.items()}
            for f12, blk in params.items()}


def shard_state(state: Dict[str, Any], mesh: Mesh,
                axis: str = "data",
                model_min_rows: Optional[int] = None,
                data: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """A rank's part of a solver state built on the full data of the same
    layout: the tables replicated, or with ``model_min_rows`` the large
    ones cut to the rank's model rows (``shard_params_model``); its rows of
    P/Q and a/b, its blocks of the carries ``yt_u`` / ``yt_v``; a COO
    side's stream-order carry and a two-tier side's head carry ``yt_*_hd``
    by the rank's entries and head chunks, which its part of the data
    (``data``, from ``shard_data``) names."""
    dev = mesh.device
    out = dict(params=(replicate_params(state["params"], mesh)
                       if model_min_rows is None else
                       shard_params_model(state["params"], mesh,
                                          model_min_rows)))

    def part(t):
        t = torch.as_tensor(t)
        return t[mesh.rows(t.shape[0])].contiguous().to(dev)

    for key in ("P", "Q"):
        out[key] = {f12: part(t) for f12, t in state[key].items()}
    for key in ("a", "b"):
        out[key] = part(state[key])
    for s in ("u", "v"):
        if data is not None and f"blk_{s}_pos" in data:
            pos = data[f"blk_{s}_pos"].cpu()
            yt = torch.as_tensor(state["yt_" + s]).index_select(0, pos)
            out["yt_" + s] = (yt * (data[f"blk_{s}_w"].cpu() > 0)).to(dev)
        else:
            out["yt_" + s] = part(state["yt_" + s])
        if f"yt_{s}_hd" not in state:
            continue
        if data is None:
            raise ValueError("a head-tier carry is cut by the rank's head "
                             "chunks: pass the rank's data (shard_data)")
        glob = data[f"blk_{s}_hd_glob"].cpu()
        hd = torch.as_tensor(state[f"yt_{s}_hd"])
        rows = hd.index_select(0, glob.clamp(min=0))
        out[f"yt_{s}_hd"] = torch.where((glob >= 0)[:, None], rows,
                                        torch.zeros_like(rows)).to(dev)
    return out


def host_arrays(tree):
    """The tensors of a state or data tree as numpy arrays (to hand a state
    to ranks in other processes)."""
    if isinstance(tree, dict):
        return {k: host_arrays(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(host_arrays(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree
