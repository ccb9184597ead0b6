"""The transition-table form of a wave's expand stage.

The port's copy of ``stateright_tpu/tpu/matmul_wave.py``. A model is
*regular* when, for every action ``a`` and every output position ``o``
(each successor lane, and the action's validity at ``o == W``), the next
value depends only on a small *key tuple* of input lanes whose joint
domain (the product of the declared ``lane_bits()`` domains) can be
enumerated. ``classify`` finds the key tuples by probing the model's own
``step`` (each lane swept over its domain at a few random contexts, then
each pair of lanes over their joint domain), tabulates each key group
over its joint domain and verifies every table row at independent
contexts, adding the offending lane to a key set whenever a verification
fails. The probes draw from ``np.random.default_rng(0)`` in the
reference's order, so the reason strings and the plans equal the JAX
package's bit for bit.

``matmul_expand`` then computes what ``engine.expand_frontier`` computes
from the plan: every successor starts as its parent's row, each action's
constant outputs are written, and each group writes its columns from the
table row its key lanes pick, read from the untouched parent. The JAX
package multiplies a one-hot ``[B, D]`` by the table ``[D, 2n]`` of the
outputs' 16-bit halves in float32. The one-hot row picks exactly one
table row, so the product IS that row: here the table rows are indexed
(a gather of ``table_u32[kidx]``), the same function with no float
arithmetic, so no matmul precision setting (TF32 included) can change a
bit. The single-kernel wave and the sender kernel take the plan too
(``wave.py``, ``csrc/plan.cuh``), with this function as their plain
version.

Irregular models (undeclared ``lane_bits``, sentinel lanes, key domains
past the cap, probe budgets, unstable inference) keep the step: ``gate``
warns once per model type, and the engines report the reason through
``scheduler_stats()["wave_matmul"]``.
"""

from __future__ import annotations

import itertools
import os
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .engine import expand_frontier
from .packing import compile_layout

__all__ = [
    "KEY_DOMAIN_CAP", "LANE_DOMAIN_CAP", "MatmulClassification",
    "MatmulPlan", "classify", "expand", "gate", "matmul_expand",
    "plan_bytes", "wave_matmul_on",
]

#: Joint key-domain cap per output group: the product of 2^bits over the
#: key lanes.
KEY_DOMAIN_CAP = 4096
#: Single-lane domain cap for the probing sweep.
LANE_DOMAIN_CAP = 1 << 12
#: Baseline contexts for the dependence sweep, verification contexts for
#: the table build (independent draws, deterministic seed).
_N_BASELINES = 3
_N_VERIFY = 3
#: Key-set refinement rounds per output column before the inference is
#: declared unstable.
_MAX_REFINE_PER_COL = 8
#: Per-group probe-row budget for the closure verification.
_GROUP_PROBE_CAP = 1 << 19
#: Total row budget for the pairwise dependence sweep.
_PAIR_PROBE_CAP = 1 << 19
#: Rows a probe evaluates at once (the outputs are the same at any
#: chunking; this bounds the step's working set).
_CHUNK = 8192


class _Group:
    """One key tuple and every (action, output) column it drives.

    ``table`` is float32 ``[domain, 2*len(cols)]``: interleaved (lo, hi)
    16-bit halves of each column's uint32 output value, as the reference
    keeps it. ``strides`` maps a key assignment to its table row: ``row
    = sum(lane_value[k] * stride[k])``."""

    __slots__ = ("keys", "strides", "domain", "cols", "table", "_rows")

    def __init__(self, keys: Tuple[int, ...], strides: Tuple[int, ...],
                 domain: int, cols: List[Tuple[int, int]],
                 table: np.ndarray):
        self.keys = keys
        self.strides = strides
        self.domain = domain
        self.cols = cols
        self.table = table
        self._rows = {}

    def table_u32(self) -> np.ndarray:
        """The table's exact outputs, ``lo | hi << 16``, as int64
        ``[domain, len(cols)]`` (values in ``[0, 2^32)``)."""
        lo = self.table[:, 0::2].astype(np.int64)
        hi = self.table[:, 1::2].astype(np.int64)
        return lo | (hi << 16)

    def rows_on(self, device) -> torch.Tensor:
        """``table_u32()`` on ``device``, made once a device (a captured
        CUDA graph reads it for as long as the plan lives)."""
        key = str(torch.device(device))
        if key not in self._rows:
            self._rows[key] = torch.from_numpy(self.table_u32()).to(device)
        return self._rows[key]


class MatmulPlan:
    """A compiled transition-table expansion for one regular model.

    ``groups`` carry the tables; ``consts`` are ``(action, output,
    value)`` outputs with an empty key set; ``copies`` counts the columns
    that turned out to be the identity on their own lane (a successor
    starts as its parent's row, so they cost nothing). ``matmul_ops`` is
    the reference's per-row MAC count of its one-hot products, ``sum(D_g
    * 2 * n_g)``."""

    __slots__ = ("width", "fanout", "groups", "consts", "copies",
                 "matmul_ops", "table_bytes", "_derived")

    def __init__(self, width: int, fanout: int, groups: List[_Group],
                 consts: List[Tuple[int, int, int]], copies: int):
        self.width = width
        self.fanout = fanout
        self.groups = groups
        self.consts = consts
        self.copies = copies
        self.matmul_ops = sum(g.domain * g.table.shape[1]
                              for g in groups)
        self.table_bytes = sum(g.table.nbytes for g in groups)
        self._derived = {}

    def derived(self, key, make):
        """``make()``, made once for ``key`` and kept as long as the plan:
        its forms on a device (index tensors, the kernels' tables), which
        a captured CUDA graph reads for as long as the plan lives."""
        if key not in self._derived:
            self._derived[key] = make()
        return self._derived[key]

    def writes_on(self, device):
        """The scatter of ``matmul_expand`` on ``device``, made once a
        device: ``(lane_idx, lane_vals, valid_idx, valid_vals,
        const_vals)``. Every
        output column (the consts' and the groups' in order) is either a
        successor lane, at flat index ``a * W + o`` of ``[B, F * W]``, or
        an action's validity, at ``a`` of ``[B, F]``; ``*_vals`` index the
        concatenation of the consts' values and every group's gathered
        columns."""
        W = self.width

        def make():
            outs = [(a, o) for a, o, _ in self.consts]
            outs += [c for g in self.groups for c in g.cols]
            lane = [(a * W + o, j) for j, (a, o) in enumerate(outs) if o < W]
            val = [(a, j) for j, (a, o) in enumerate(outs) if o == W]

            def idx(values):
                return torch.tensor(values, dtype=torch.int64, device=device)

            return (idx([p[0] for p in lane]), idx([p[1] for p in lane]),
                    idx([p[0] for p in val]), idx([p[1] for p in val]),
                    idx([v for _, _, v in self.consts]))

        return self.derived(("writes", str(torch.device(device))), make)


class MatmulClassification:
    """The gate's verdict: ``regular``, a stable ``reason`` string and the
    :class:`MatmulPlan` when regular."""

    __slots__ = ("regular", "reason", "plan")

    def __init__(self, regular: bool, reason: str,
                 plan: Optional[MatmulPlan]):
        self.regular = regular
        self.reason = reason
        self.plan = plan


def plan_bytes(plan: Optional[MatmulPlan], batch: int) -> int:
    """The reference's VMEM term of the plan at ``batch`` rows: the
    widest one-hot block plus every table (0 without a plan)."""
    if plan is None:
        return 0
    widest = max((g.domain for g in plan.groups), default=0)
    return 4 * batch * widest + plan.table_bytes


def _irregular(reason: str) -> MatmulClassification:
    return MatmulClassification(False, reason, None)


class _StepProbe:
    """The model's own batch-first ``step`` on probe rows, on
    ``device``."""

    def __init__(self, dm, device):
        self._dm = dm
        self._device = device

    def __call__(self, rows: np.ndarray) -> np.ndarray:
        """``rows`` uint32 [N, W] -> ``_outputs`` of the step, uint32 [N,
        F, W+1]."""
        parts = []
        for i in range(0, rows.shape[0], _CHUNK):
            chunk = torch.from_numpy(
                rows[i:i + _CHUNK].astype(np.int64)).to(self._device)
            succ, valid = self._dm.step(chunk)
            parts.append(_outputs(succ.cpu().numpy().astype(np.uint32),
                                  valid.cpu().numpy()))
        return np.concatenate(parts, axis=0)


def _outputs(succ: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Successor lanes and the validity bit in one uint32 cube ``[N, F,
    W+1]``: column ``W`` is the action's validity (0/1)."""
    return np.concatenate(
        [succ, valid[..., None].astype(np.uint32)], axis=2)


def _random_contexts(rng, bits: Sequence[int], n: int) -> np.ndarray:
    """``n`` uniform in-domain probe rows (uint32 [n, W])."""
    cols = [rng.integers(0, 1 << b, size=n, dtype=np.uint32)
            for b in bits]
    return np.stack(cols, axis=1)


def _spread_contexts(rng, bits: Sequence[int], n: int) -> np.ndarray:
    """``n`` in-domain rows where every row past the first differs from
    row 0 in every lane (a nonzero per-lane offset mod the lane
    domain)."""
    rows = _random_contexts(rng, bits, n)
    for j in range(1, n):
        for lane, b in enumerate(bits):
            d = 1 << b
            off = rng.integers(1, d) if d > 1 else 0
            rows[j, lane] = (rows[0, lane] + off) % d
    return rows


def _find_offender(probe: _StepProbe, vec_a: np.ndarray,
                   vec_b: np.ndarray, keys: Tuple[int, ...],
                   a: int, o: int) -> Optional[int]:
    """Morphs ``vec_a`` into ``vec_b`` one non-key lane at a time and
    returns the first lane whose flip moves output ``(a, o)``: the lane
    the key set is missing."""
    lanes = [l for l in range(vec_a.shape[0]) if l not in keys]
    rows = np.empty((len(lanes) + 1, vec_a.shape[0]), np.uint32)
    rows[0] = vec_a
    cur = vec_a.copy()
    for j, lane in enumerate(lanes):
        cur[lane] = vec_b[lane]
        rows[j + 1] = cur
    out = probe(rows)[:, a, o]
    for j, lane in enumerate(lanes):
        if out[j + 1] != out[j]:
            return lane
    return None


#: Classification memo, keyed on the device model's type name and its
#: ``cuda_model()`` parameters (the port's models have no
#: ``native_form()``); a model without them classifies every time.
_CLASSIFY_CACHE: dict = {}


def _memo_key(dm):
    try:
        spec = dm.cuda_model()
    except Exception:
        return None
    if spec is None:
        return None
    name, params = spec
    return (type(dm).__name__, name, tuple(
        p.tobytes() if isinstance(p, np.ndarray) else int(p)
        for p in params))


def classify(dm, device="cpu") -> MatmulClassification:
    """Classifies ``dm`` and compiles its :class:`MatmulPlan` when
    regular, probing its ``step`` on ``device``. Deterministic: fixed
    probe seed, stable reason strings."""
    key = _memo_key(dm)
    if key is not None:
        hit = _CLASSIFY_CACHE.get(key)
        if hit is not None:
            return hit
    res = _classify(dm, device)
    if key is not None:
        _CLASSIFY_CACHE[key] = res
    return res


def _classify(dm, device) -> MatmulClassification:
    W, F = dm.state_width, dm.max_fanout
    lane_bits = getattr(dm, "lane_bits", lambda: None)()
    if lane_bits is None:
        return _irregular("undeclared lane_bits")
    layout = compile_layout(lane_bits, W)
    if any(lane.sentinel is not None for lane in layout.lanes):
        return _irregular("sentinel lane domains")
    bits = [lane.bits for lane in layout.lanes]
    for i, b in enumerate(bits):
        if (1 << b) > LANE_DOMAIN_CAP:
            return _irregular(
                f"lane domain too large (lane {i}: {b} bits)")

    probe = _StepProbe(dm, device)
    rng = np.random.default_rng(0)
    baselines = _spread_contexts(rng, bits, _N_BASELINES)
    base_out = probe(baselines)  # [R, F, W+1]

    # Dependence sweep: every lane over its full declared domain at every
    # baseline; one probe pass serves all F*(W+1) outputs.
    sweep_rows = []
    for lane in range(W):
        d = 1 << bits[lane]
        block = np.repeat(baselines, d, axis=0)  # [R*d, W]
        block[:, lane] = np.tile(
            np.arange(d, dtype=np.uint32), _N_BASELINES)
        sweep_rows.append(block)
    sweep_out = probe(np.concatenate(sweep_rows, axis=0))

    deps: List[List[set]] = [[set() for _ in range(W + 1)]
                             for _ in range(F)]
    offset = 0
    for lane in range(W):
        d = 1 << bits[lane]
        block = sweep_out[offset:offset + _N_BASELINES * d]
        block = block.reshape(_N_BASELINES, d, F, W + 1)
        moved = (block != base_out[:, None]).any(axis=(0, 1))  # [F, W+1]
        for a, o in zip(*np.nonzero(moved)):
            deps[int(a)][int(o)].add(lane)
        offset += _N_BASELINES * d

    # Pairwise joint sweep: a conjunctive dependence (2pc's TmCommit
    # validity) is invisible to every single-lane sweep from a context
    # where the other conjunct is false.
    pair_total = sum((1 << bits[l1]) * (1 << bits[l2])
                     for l1 in range(W) for l2 in range(l1 + 1, W))
    if pair_total > _PAIR_PROBE_CAP:
        return _irregular("probe budget exceeded (pair sweep)")
    base = baselines[0]
    for l1 in range(W):
        d1 = 1 << bits[l1]
        for l2 in range(l1 + 1, W):
            d2 = 1 << bits[l2]
            blk = np.tile(base, (d1 * d2, 1))
            v1 = np.repeat(np.arange(d1, dtype=np.uint32), d2)
            v2 = np.tile(np.arange(d2, dtype=np.uint32), d1)
            blk[:, l1] = v1
            blk[:, l2] = v2
            grid = probe(blk).reshape(d1, d2, F, W + 1)
            hit1 = (grid != grid[:1]).any(axis=(0, 1))  # [F, W+1]
            hit2 = (grid != grid[:, :1]).any(axis=(0, 1))
            for lane, hit in ((l1, hit1), (l2, hit2)):
                for a, o in zip(*np.nonzero(hit)):
                    deps[int(a)][int(o)].add(lane)

    # Tabulate by key set at independent verification contexts; a
    # disagreement means the sweeps missed a key lane: refine and retry.
    worklist = {}
    for a in range(F):
        for o in range(W + 1):
            worklist.setdefault(tuple(sorted(deps[a][o])),
                                []).append((a, o))
    groups: List[_Group] = []
    consts: List[Tuple[int, int, int]] = []
    copies = 0
    refines: dict = {}
    pending = sorted(worklist.items())
    while pending:
        keys, cols = pending.pop(0)
        domain = 1
        for k in keys:
            domain *= 1 << bits[k]
        if domain > KEY_DOMAIN_CAP:
            a, o = cols[0]
            what = "valid" if o == W else f"lane {o}"
            return _irregular(
                f"key domain too large (action {a}, {what}: "
                f"{domain} > {KEY_DOMAIN_CAP})")
        nonkey = [l for l in range(W) if l not in keys]
        sweep_n = sum(1 << bits[l] for l in nonkey)
        if domain * (_N_VERIFY + sweep_n) > _GROUP_PROBE_CAP:
            a, o = cols[0]
            what = "valid" if o == W else f"lane {o}"
            return _irregular(
                f"probe budget exceeded (action {a}, {what})")
        ctxs = _spread_contexts(rng, bits, _N_VERIFY)
        assigns = np.array(
            list(itertools.product(*((range(1 << bits[k]))
                                     for k in keys))),
            dtype=np.uint32).reshape(domain, len(keys))
        # Block A: the joint key domain at every spread context. Block B,
        # the closure sweep: every non-key lane over its full domain at
        # context 0, at every key assignment.
        rows_a = np.repeat(ctxs, domain, axis=0)  # [R*D, W]
        for j, k in enumerate(keys):
            rows_a[:, k] = np.tile(assigns[:, j], _N_VERIFY)
        blocks, bmeta = [rows_a], []
        for lane in nonkey:
            d = 1 << bits[lane]
            blk = np.tile(ctxs[0], (d * domain, 1))
            blk[:, lane] = np.repeat(
                np.arange(d, dtype=np.uint32), domain)
            for j, k in enumerate(keys):
                blk[:, k] = np.tile(assigns[:, j], d)
            blocks.append(blk)
            bmeta.append((lane, d))
        out = probe(np.concatenate(blocks, axis=0))
        out_a = out[:_N_VERIFY * domain].reshape(
            _N_VERIFY, domain, F, W + 1)
        vals = np.stack([out_a[:, :, a, o] for (a, o) in cols],
                        axis=2)  # [R, D, n_cols]
        agree = (vals == vals[:1]).all(axis=0)  # [D, n_cols]
        bad = None  # (column index, offending lane or None)
        if not agree.all():
            d_bad, c_bad = map(int, np.argwhere(~agree)[0])
            a, o = cols[c_bad]
            r_bad = int(np.nonzero(
                vals[:, d_bad, c_bad] != vals[0, d_bad, c_bad])[0][0])
            bad = (c_bad, _find_offender(
                probe, rows_a[d_bad].copy(),
                rows_a[r_bad * domain + d_bad].copy(), keys, a, o))
        else:
            off = _N_VERIFY * domain
            for lane, d in bmeta:
                blk = out[off:off + d * domain].reshape(
                    d, domain, F, W + 1)
                off += d * domain
                for ci, (a, o) in enumerate(cols):
                    if (blk[:, :, a, o]
                            != vals[0][:, ci][None, :]).any():
                        bad = (ci, lane)
                        break
                if bad is not None:
                    break
        if bad is not None:
            c_bad, offender = bad
            a, o = cols[c_bad]
            refines[(a, o)] = refines.get((a, o), 0) + 1
            if offender is None or \
                    refines[(a, o)] > _MAX_REFINE_PER_COL:
                what = "valid" if o == W else f"lane {o}"
                return _irregular(
                    f"inference unstable (action {a}, {what})")
            new_keys = tuple(sorted(keys + (offender,)))
            rest = [c for c in cols if c != (a, o)]
            if rest:
                pending.insert(0, (keys, rest))
            pending.insert(0, (new_keys, [(a, o)]))
            continue
        table_u32 = vals[0]  # [D, n_cols], exact step outputs
        if not keys:
            consts.extend((a, o, int(table_u32[0, j]))
                          for j, (a, o) in enumerate(cols))
            continue
        # Passthrough columns, the identity on the output's own single
        # key lane, ride the parent's row.
        live = []
        if len(keys) == 1:
            ident = assigns[:, 0]
            for j, (a, o) in enumerate(cols):
                if o == keys[0] and o < W and \
                        (table_u32[:, j] == ident).all():
                    copies += 1
                else:
                    live.append(j)
        else:
            live = list(range(len(cols)))
        if not live:
            continue
        cols = [cols[j] for j in live]
        table_u32 = table_u32[:, live]
        strides = []
        s = 1
        for k in reversed(keys):
            strides.append(s)
            s *= 1 << bits[k]
        strides = tuple(reversed(strides))
        table = np.empty((domain, 2 * len(cols)), np.float32)
        table[:, 0::2] = (table_u32 & 0xFFFF).astype(np.float32)
        table[:, 1::2] = (table_u32 >> 16).astype(np.float32)
        groups.append(_Group(tuple(keys), strides, domain, cols, table))

    plan = MatmulPlan(W, F, groups, consts, copies)
    return MatmulClassification(
        True,
        f"regular ({len(groups)} key groups, "
        f"{plan.matmul_ops} macs/row)", plan)


def matmul_expand(dm, plan: MatmulPlan, vecs: torch.Tensor,
                  valid: torch.Tensor):
    """``engine.expand_frontier`` on a regular model from its plan: the
    same signature and returns (``succ_flat [B*F, W]``, ``valid_flat
    [B*F]``, ``succ_count``, ``terminal [B]``), the same bits. Each
    group's table row is gathered at the key index of each parent row
    (the reference's one-hot product picks exactly that row); the keys
    are read from ``vecs``, never from a successor being written. No
    synchronisation."""
    B = vecs.shape[0]
    F, W = plan.fanout, plan.width
    dev = vecs.device
    lane_idx, lane_vals, valid_idx, valid_vals, const_vals = \
        plan.writes_on(dev)
    # Every output column: the consts', then each group's row of its
    # table (int64 lanes, the lo | hi << 16 rebuild done in int64).
    cols = [const_vals.expand(B, -1)]
    for g in plan.groups:
        kidx = torch.zeros(B, dtype=torch.int64, device=dev)
        for k, stride in zip(g.keys, g.strides):
            kidx = kidx + vecs[:, k] * stride
        # A key past the table (a lane outside its declared domain) reads
        # 0, as the reference's all-zero one-hot row does.
        inside = kidx < g.domain
        cols.append(g.rows_on(dev).index_select(
            0, kidx.clamp(max=g.domain - 1)) * inside[:, None])
    cols = torch.cat(cols, dim=1)
    succ = vecs[:, None, :].expand(B, F, W).reshape(B, F * W)
    succ = succ.index_copy(1, lane_idx, cols.index_select(1, lane_vals))
    sv = torch.zeros((B, F), dtype=torch.bool, device=dev)
    sv = sv.index_copy(1, valid_idx, cols.index_select(1, valid_vals) != 0)
    sv = sv & valid[:, None]
    succ_flat = succ.reshape(B * F, W)
    inside = dm.boundary(succ_flat)
    if inside is not None:
        sv = sv & inside.reshape(B, F)
    terminal = valid & ~sv.any(dim=1)
    return (succ_flat, sv.reshape(B * F), sv.sum(dtype=torch.int64),
            terminal)


def expand(dm, plan: Optional[MatmulPlan], rows: torch.Tensor,
           valid: torch.Tensor):
    """A wave's expand stage: ``matmul_expand`` under a plan, else
    ``expand_frontier`` (the model's step)."""
    if plan is None:
        return expand_frontier(dm, rows, valid)
    return matmul_expand(dm, plan, rows, valid)


def wave_matmul_on(wave_matmul) -> bool:
    """``spawn_cuda_bfs``'s ``wave_matmul`` resolved: ``None`` follows the
    ``STpu_WAVE_MATMUL`` environment variable, as the reference's
    does."""
    if wave_matmul is None:
        return os.environ.get("STpu_WAVE_MATMUL", "") not in ("", "0")
    return bool(wave_matmul)


#: Device-model type names whose gate rejection was already announced:
#: once per model type, not per spawn (the reference's
#: ``tpu/engine.py::_WAVE_MATMUL_GATE_WARNED``).
_WAVE_MATMUL_GATE_WARNED: set = set()


def gate(dm, device="cpu") -> MatmulClassification:
    """``classify(dm)`` for an engine that asked for the knob: an
    irregular model warns once per type, with the reference's text, and
    keeps the step."""
    cls = classify(dm, device)
    if not cls.regular:
        key = type(dm).__name__
        if key not in _WAVE_MATMUL_GATE_WARNED:
            _WAVE_MATMUL_GATE_WARNED.add(key)
            warnings.warn(
                f"wave_matmul requested but {key} is not "
                f"matmul-regular ({cls.reason}); using the "
                "vmapped step path", RuntimeWarning, stacklevel=3)
    return cls
