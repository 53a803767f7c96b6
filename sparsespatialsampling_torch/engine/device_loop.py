"""Tensor functions of the device-resident loops.

Port of the JAX package's device loops (``engine/tree.py:61-215``, the
body of ``_build_device_loop``, ``:1913-2100``, and that of
``_build_geometry_loop``, ``:2575-2695``).  There one ``lax.while_loop``
runs the adaptive iterations, another the geometry-refinement levels;
here :func:`loop_body` is one iteration and :func:`geometry_level_body`
one level, each a plain function of the state and the window's
parameters over fixed shapes.  It reads nothing back: every decision is
a device value, and an iteration that must not run (a guard fired, the
stop test said stop, the window is full) runs predicated — every scatter
goes to the sentinel row ``cap`` and every scalar keeps its value — so
the host may enqueue it before it knows.  The host side of a window
(``SamplingTree._device_adaptive_call``) reads one small scalar row per
iteration to decide whether to enqueue the next.  Both bodies update the
state in place, every scalar through ``copy_`` into the tensor it already
has, so the state keeps its addresses and a captured CUDA graph of an
iteration (``engine/graphs.py``) reads and writes it on every replay.

- :func:`_bsearch_eq`: exact lookup of ``(level, coords)`` keys in a
  lexicographically sorted set.  The JAX package runs a branchless binary
  search over key tuples; here the first two components are packed into
  one int64 and :func:`torch.searchsorted` does the search, and in 3D the
  third component is appended to the rank of the packed pair's group.
- :func:`_mdl_expand`: the transitive 2:1 closure of a selection.
- :func:`loop_body`: ramp, gain selection, 2:1 closure, guards, split,
  epoch, writes, captured metric and the per-iteration series.
- :func:`geometry_level_body`: frontier filter or 2:1 closure, level-cap
  guard, split, the children's (invalid, surface) flags and the next
  frontier.
"""
from types import SimpleNamespace

import torch

from ..ops.knn import _fma, _sqrt

# bits of a coordinate in a packed key: lattice coordinates of levels up
# to 22 (the loop's level cap) are below 2^22
_KEY_BITS = 22
# the sort key of a dead row in the 2:1 lookup, above every alive
# ``level << 22 | c0``
_DEAD_KEY = 2 ** 30

# why a window stopped iterating (bits of the state's ``why``)
WHY_BUDGET = 1      # the budget exceeds the selection width k_max
WHY_MDL = 2         # the 2:1 closure left the loop's exact case
WHY_LEVEL = 4       # a child would lie deeper than the f32 level cap
WHY_FILL = 8        # the children would not fit in the state
WHY_BAD = 16        # a cell's kNN is not provably exact (host escalation)
WHY_OVER = 32       # the geometry loop's next frontier outgrew its width


def _bucket(n: int, minimum: int = 512) -> int:
    """Round up to a power of two, at least ``minimum`` (bounds the number
    of distinct state and selection widths over a run)."""
    return max(minimum, 1 << int(n - 1).bit_length())


def _cell_size(width, level):
    """f32 cell edge ``width / 2^level``, exact: ``2^level`` is assembled
    from its exponent bits (XLA's CPU ``exp2`` is off by ulps from level 13
    on, and the division by a power of two rounds nothing)."""
    pow2 = ((level.to(torch.int32) + 127) << 23).view(torch.float32)
    return width / pow2


def _corner_nodes_f32(coords, level, lo, width, offsets):
    """f32 corner nodes ``[M, 2^d, d]`` of lattice cells, ``lo + (coords +
    offset)·h`` with one rounding (exact lattice while the coordinates stay
    below 2^23)."""
    h = _cell_size(width, level)
    return _fma(coords[:, None, :] + offsets[None, :, :], h[:, None, None],
                lo)


def _pack(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a << 22 | b`` in int64: monotone in ``(a, b)`` for ``0 <= a <
    2^41`` and ``0 <= b < 2^22``; -1 when both are -1 (a miss)."""
    return (a.long() << _KEY_BITS) | b.long()


def _bsearch_eq(keys: tuple, queries: tuple):
    """Exact lookup of query tuples in lexicographically sorted key tuples
    ``(level << 22 | c0, c1[, c2])`` (the JAX package's ``_bsearch_eq``
    layout).  Every component but the first lies in ``[0, 2^22)``; a
    query whose components are all -1 is a miss.  Returns ``(pos,
    found)``: where ``found``, ``pos`` is the matching index, the lower
    bound of the query, as in the JAX package."""
    n = keys[0].shape[0]
    s1, q1 = _pack(keys[0], keys[1]), _pack(queries[0], queries[1])
    pos = torch.searchsorted(s1, q1)
    if len(keys) == 3:
        # rank each key by the start of its packed pair's group: the pair
        # (rank, c2) is then a second sorted int64 key
        first = torch.searchsorted(s1, s1)
        s2 = _pack(first, keys[2])
        hit = pos.clamp(max=n - 1)
        in_group = (pos < n) & (s1[hit] == q1)
        pos = torch.where(in_group,
                          torch.searchsorted(s2, _pack(pos, queries[2])), pos)
    found = pos < n
    pos = pos.clamp(max=n - 1)
    for k, q in zip(keys, queries):
        found &= k[pos] == q
    return pos, found


def _first_rows(mask: torch.Tensor, r: int):
    """The first ``r`` rows where ``mask`` holds, in ascending order, then
    distinct rows where it does not: ``(rows [r], m [r])`` with ``m``
    marking the rows of the mask (a fixed-size pick, read by nothing on
    the host)."""
    n = mask.shape[0]
    ar = torch.arange(n, device=mask.device)
    key = torch.sort(torch.where(mask, ar, ar + n)).values[:min(r, n)]
    m = key < n
    return torch.where(m, key, key - n), m


def _sorted_keys(coords, level, alive, cap: int, d: int):
    """The alive rows' ``(level << 22 | c0, c1[, c2])`` sorted
    lexicographically (dead rows last) and the row of each."""
    key1 = torch.where(alive[:cap], (level[:cap] << _KEY_BITS)
                       | coords[:cap, 0], _DEAD_KEY)
    keys = (key1,) + tuple(coords[:cap, i] for i in range(1, d))
    pair = _pack(key1, keys[1])
    if d == 2:
        order = torch.sort(pair, stable=True).indices
    else:
        # least significant component first, then the packed pair, stably
        order = torch.sort(keys[2], stable=True).indices
        order = order[torch.sort(pair[order], stable=True).indices]
    return tuple(k[order] for k in keys), order


def _mdl_expand(coords, level, alive, seed, cap: int, d: int, k_sel: int,
                nbdirs, rounds: int, drop_seed_at=None):
    """Transitive 2:1 closure of the seed rows (reference ``_check_nb`` +
    ``_check_constraint``, s_cube.py:447-506), the JAX package's
    ``_mdl_expand``.

    Every iteration refines the transitive closure, so the 2:1 invariant
    holds globally and a coarser leaf next to a cell is exactly one level
    coarser: the violation test is membership of ``(level - 1, nb >> 1)``
    in the alive set.  A second probe at ``level - 2`` guards that
    assumption.  ``guard`` is set when the invariant is broken, a frontier
    was truncated to ``k_sel``, the last of the ``rounds`` still added
    rows, or the closure holds more than ``k_sel`` rows: the caller then
    changes nothing and the host's general walk takes over.

    :param seed: ``[k_seed]`` selected rows, sentinel ``cap``
    :param nbdirs: ``[3^d - 1, d]`` int64 neighbour directions
    :param drop_seed_at: the geometry loop's semantics: a seed row of a
        level of at least this is probed from but left out of the parents
        unless a probe found it as a coarser neighbour
    :return: ``(parents [k_sel] ascending, sentinel cap; pvalid [k_sel];
        guard)``
    """
    dev = coords.device
    skeys, srows = _sorted_keys(coords, level, alive, cap, d)

    def probe2(fr):
        """The level-1 lookup and the level-2 invariant probe of a
        frontier, as one search over both sets of queries."""
        fc, fl = coords[fr], level[fr]
        nb = fc[:, None, :] + nbdirs[None]                   # [w, nd, d]
        inb = ((nb >= 0) & (nb < (torch.ones_like(fl) << fl)[:, None, None])
               ).all(-1)

        def keys_for(shift):
            q_ok = (fr != cap)[:, None] & inb & (fl[:, None] >= shift)
            ql = fl[:, None] - shift
            qc = nb >> shift
            q1 = torch.where(q_ok, (ql << _KEY_BITS) | qc[..., 0], -1)
            return (q1.reshape(-1),) + tuple(
                torch.where(q_ok, qc[..., i], -1).reshape(-1)
                for i in range(1, d))

        qs1, qs2 = keys_for(1), keys_for(2)
        pos, found = _bsearch_eq(
            skeys, tuple(torch.cat([a, b]) for a, b in zip(qs1, qs2)))
        m = qs1[0].shape[0]
        orow = torch.where(found[:m], srows[pos[:m]], cap)
        return orow, found[m:]

    sentinel = torch.full((1,), cap, device=dev)

    def mark(mask, rows):
        """``mask[rows] = True`` but never the sentinel row (``index_fill_``
        takes its value as a kernel argument; an assigned Python scalar
        would be copied from host memory, which waits for the device)."""
        return mask.index_fill_(0, rows, True).index_fill_(0, sentinel, False)

    def mask_of(rows):
        return mark(torch.zeros(cap + 1, dtype=torch.bool, device=dev), rows)

    sel_mask = mask_of(seed)
    k_seed = seed.shape[0]
    fr = seed if k_seed == k_sel else torch.cat(
        [seed, torch.full((k_sel - k_seed,), cap, dtype=seed.dtype,
                          device=dev)])
    guard = torch.zeros((), dtype=torch.bool, device=dev)
    arange_i = torch.arange(cap, device=dev)
    n_round = torch.zeros((), dtype=torch.int64, device=dev)
    refound = torch.zeros(cap + 1, dtype=torch.bool, device=dev)
    for _ in range(rounds):
        orow, found2 = probe2(fr)
        guard |= found2.any()                   # invariant broken
        orow = orow.reshape(-1)
        mark(refound, orow)
        before = sel_mask[:cap].clone()
        mark(sel_mask, orow)
        newmask = sel_mask[:cap] & ~before
        n_round = newmask.sum()
        fr = torch.sort(torch.where(newmask, arange_i, cap)).values[:k_sel]
        guard |= n_round > k_sel                # frontier truncated
    # adds in the last round leave frontiers unchecked
    guard |= n_round > 0
    guard |= sel_mask[:cap].sum() > k_sel
    out_mask = sel_mask[:cap]
    if drop_seed_at is not None:
        out_mask = out_mask & ~(mask_of(seed)[:cap]
                                & (level[:cap] >= drop_seed_at)
                                & ~refound[:cap])
    parents = torch.sort(torch.where(out_mask, arange_i, cap)).values[:k_sel]
    return parents, parents < cap, guard


def loop_params(cap: int, k_max: int, k_sel: int, iters: int, d: int,
                metric_mode: bool, mdl: bool, lev_cap: int, rounds: int,
                offsets, nbdirs, scalars: dict) -> SimpleNamespace:
    """The fixed shapes and constants of one window: ``scalars`` are f32
    device scalars (``min_metric``, ``relTol``, ``reach``, ``ncmax``,
    ``cps_start``, ``cps_end``, ``tnorm``)."""
    dev = offsets.device
    return SimpleNamespace(
        cap=cap, k_max=k_max, k_sel=k_sel, iters=iters, d=d, n_ch=2 ** d,
        metric_mode=metric_mode, mdl=mdl, lev_cap=lev_cap, rounds=rounds,
        offsets=offsets, nbdirs=nbdirs,
        ar_k=torch.arange(k_max, device=dev),
        ar_ch=torch.arange(2 ** d, device=dev), **scalars)


def stop_continue(s: dict, p) -> torch.Tensor:
    """The host's ``_check_stopping_criteria`` in f32 on the device, as
    the JAX loop evaluates it; True means keep refining."""
    if p.metric_mode:
        armed = (s["m_count"] > 1) & (s["m_last"] / p.min_metric >= p.reach)
        nat = ((s["m_last"] < p.min_metric)
               & ((s["m_last"] - s["m_prev"]).abs() > p.relTol))
    else:
        n = s["n_alive"].to(torch.float32)
        armed = n / p.ncmax >= p.reach
        nat = ((n < p.ncmax)
               & ((s["cpi"].to(torch.float32) - s["cpi_last"]).abs()
                  / p.ncmax > p.relTol))
    return ~armed | nat


def may_run(s: dict, p) -> torch.Tensor:
    """Whether the next iteration runs: the stop test, room in the
    window's series and no flag."""
    return stop_continue(s, p) & (s["it"] < p.iters) & ~s["flag"]


def _at(t: torch.Tensor) -> torch.Tensor:
    """A 0-dim index as a one-element index tensor (a 0-dim tensor index
    would be read back to the host)."""
    return t.reshape(1)


def _select(s: dict, p, cpi2):
    """Gain selection: the ``k_max`` largest gains of the alive rows, ties
    to the lower row (a stable sort of the negated gains, the JAX
    package's ``k_max > 2048`` branch), then the 2:1 closure or the host's
    append order.  Returns ``(parents, pvalid, why)``."""
    cap, k_max = p.cap, p.k_max
    k_budget = torch.minimum(cpi2, s["fill"])
    masked = torch.where(s["alive"][:cap], s["gain"][:cap], float("-inf"))
    neg, srt = torch.sort(-masked, stable=True)
    topv, sel = -neg[:k_max], srt[:k_max]
    pvalid = (p.ar_k < k_budget) & (topv > float("-inf"))
    why = torch.where(k_budget > k_max, WHY_BUDGET, 0)
    if p.mdl:
        seed = torch.where(pvalid, sel, cap)
        parents, pvalid, gmdl = _mdl_expand(
            s["coords"], s["level"], s["alive"], seed, cap, p.d, p.k_sel,
            p.nbdirs, p.rounds)
        return parents, pvalid, why | torch.where(gmdl, WHY_MDL, 0)
    # the host's _select_top_k order: parents above the threshold gain
    # ascending by row, then those at it ascending; all alive rows in
    # plain ascending order when the budget covers them
    n_val = pvalid.sum()
    thr = topv[_at((n_val - 1).clamp(min=0))]
    all_mode = k_budget >= s["n_alive"]
    bump = torch.where(all_mode | (topv > thr), 0, cap + 1)
    key = torch.sort(torch.where(pvalid, sel + bump, 3 * (cap + 1))).values
    pvalid = key < 2 * (cap + 1)
    return torch.where(pvalid, key % (cap + 1), cap), pvalid, why


def loop_body(s: dict, p, epoch) -> None:
    """One adaptive iteration on the state ``s`` (in place), the JAX loop
    body's arithmetic.  ``epoch(coords_f32, level_f32, slot)`` returns the
    packed ``[M, 4]`` (gain, metric, invalid, bad) of the ``k_sel·2^d``
    child slots and ``[4]`` counts, kept in the series ``nbq``."""
    cap, d, n_ch, f32 = p.cap, p.d, p.n_ch, torch.float32
    active = may_run(s, p)
    if p.metric_mode:
        # the host ramps only once its metric list holds two entries
        do_ramp = s["m_count"] >= 2
        delta_x = p.min_metric - s["m_first"]
        new = p.cps_start - (p.cps_start - p.cps_end) / delta_x * s["m_last"]
        new_i = torch.where(new > 1.0, new.to(torch.int64), 1)
        cpi2 = torch.where(do_ramp, new_i, s["cpi"])
        cpi_last2 = torch.where(do_ramp, s["cpi"].to(f32), s["cpi_last"])
    else:
        cpi2, cpi_last2 = s["cpi"], s["cpi_last"]

    parents, pvalid, why = _select(s, p, cpi2)
    plevel = s["level"][parents]
    why = why | torch.where(torch.where(pvalid, plevel, 0).max() + 1
                            > p.lev_cap, WHY_LEVEL, 0)
    why = why | torch.where(s["fill"] + pvalid.sum() * n_ch > cap,
                            WHY_FILL, 0)
    guard = why != 0
    noop = guard | ~active

    # the split, predicated: a no-op iteration writes the sentinel row only
    pvalid = pvalid & ~noop
    s["alive"].index_fill_(0, torch.where(noop, cap, parents), False)
    j = torch.cumsum(pvalid.long(), 0) - 1
    rows = torch.where(pvalid[:, None],
                       s["fill"] + j[:, None] * n_ch + p.ar_ch[None, :], cap)
    rows_f = rows.reshape(-1)
    child = (s["coords"][parents][:, None, :] * 2
             + p.offsets[None]).reshape(-1, d)
    clevel = plevel + 1
    child_level = clevel.repeat_interleave(n_ch)
    s["coords"][rows_f] = child
    s["level"][rows_f] = child_level
    slot = pvalid.repeat_interleave(n_ch)

    # the epoch; an empty slot is evaluated on the root cell
    out, counts = epoch(torch.where(slot[:, None], child, 0).to(f32),
                        torch.where(slot, child_level, 0).to(f32), slot)
    ginv = out[:, 2] > 0.5
    galive = slot & ~ginv
    gbad = (out[:, 3] > 0.5) & galive
    s["alive"][rows_f] = galive
    s["gain"][rows_f] = torch.where(ginv, 0.0, out[:, 0])
    s["metric"][rows_f] = out[:, 1]
    s["bad"][rows_f] = gbad
    bad_any = gbad.any()

    n_alive = s["alive"][:cap].sum()
    s["fill"].copy_(s["fill"] + pvalid.sum() * n_ch)
    s["n_alive"].copy_(n_alive)
    s["why"].copy_(s["why"] | torch.where(
        active, why | torch.where(bad_any, WHY_BAD, 0), 0))
    s["flag"].copy_(s["flag"] | (active & (guard | bad_any)))
    s["maxlev"].copy_(torch.maximum(s["maxlev"],
                                    torch.where(pvalid, clevel, 0).max()))
    s["cpi"].copy_(torch.where(noop, s["cpi"], cpi2))
    s["cpi_last"].copy_(torch.where(noop, s["cpi_last"], cpi_last2))
    # a no-op iteration writes its series entries at the sentinel index
    it_w = _at(torch.where(noop, p.iters, s["it"]))
    if p.metric_mode:
        m = s["metric"][:cap]
        ratio = _sqrt(torch.where(s["alive"][:cap], m * m, 0.0).sum()) \
            / p.tnorm
        s["m_prev"].copy_(torch.where(noop, s["m_prev"], s["m_last"]))
        s["m_last"].copy_(torch.where(noop, s["m_last"], ratio))
        s["m_count"].copy_(s["m_count"] + (~noop).long())
        s["ms"][it_w] = ratio.reshape(1)
    s["ns"][it_w] = n_alive.reshape(1)
    s["nbq"][it_w] = counts.reshape(1, -1)
    s["it"].copy_(s["it"] + (~noop).long())


def geometry_params(cap: int, k_geo: int, levels: int, d: int, gmax: int,
                    mdl: bool, lev_cap: int, rounds: int, offsets, nbdirs,
                    lo, width, offsets_f) -> SimpleNamespace:
    """The fixed shapes and constants of one geometry window: ``k_geo``
    frontier rows, ``levels`` levels at most, the target level ``gmax``;
    ``lo``, ``width`` and ``offsets_f`` build the f32 corner nodes."""
    return SimpleNamespace(
        cap=cap, k_geo=k_geo, levels=levels, d=d, n_ch=2 ** d, gmax=gmax,
        mdl=mdl, lev_cap=lev_cap, rounds=rounds, offsets=offsets,
        nbdirs=nbdirs, lo=lo, width=width, offsets_f=offsets_f,
        ar_ch=torch.arange(2 ** d, device=offsets.device))


def geometry_may_run(s: dict, p) -> torch.Tensor:
    """Whether the next level runs (the JAX loop's ``cond``): below the
    target level, a frontier left, room in the window and no flag."""
    return ((s["gcur"] < p.gmax) & (s["n_fr"] > 0) & (s["it"] < p.levels)
            & ~s["flag"])


def geometry_level_body(s: dict, p, check_cells) -> None:
    """One geometry-refinement level on the state ``s`` (in place), the JAX
    loop body's arithmetic: the frontier's rows below the target level are
    split (with the 2:1 balance, the closure of the whole frontier, where a
    seed at the target level is split only if a probe found it as a
    coarser neighbour); the children get rows in ascending-parent order,
    ``2^d`` consecutive rows a parent, as the host's ``_split`` of the
    sorted parents; ``check_cells`` (the geometry's) tests their f32 corner
    nodes for removal and for the surface; the surviving surface children
    are the next frontier.  A level that must not run, or that a guard
    stops (level cap, the closure's guard), writes the sentinel row
    ``cap`` only and keeps every scalar; one whose next frontier outgrows
    ``k_geo`` still completes exactly, and clears ``fr_ok``."""
    cap, d, n_ch, k_geo = p.cap, p.d, p.n_ch, p.k_geo
    active = geometry_may_run(s, p)
    fr = s["fr"]
    if p.mdl:
        parents, pvalid, gmdl = _mdl_expand(
            s["coords"], s["level"], s["alive"], fr, cap, d, k_geo,
            p.nbdirs, p.rounds, drop_seed_at=p.gmax)
        why = torch.where(gmdl, WHY_MDL, 0)
    else:
        parents = torch.sort(torch.where(
            (fr != cap) & (s["level"][fr] < p.gmax), fr, cap)).values
        pvalid = parents < cap
        why = torch.zeros_like(s["why"])
    plevel = s["level"][parents]
    why = why | torch.where(torch.where(pvalid, plevel, 0).max() + 1
                            > p.lev_cap, WHY_LEVEL, 0)
    guard = why != 0
    noop = guard | ~active

    # the split, predicated: a no-op level writes the sentinel row only
    pvalid = pvalid & ~noop
    s["alive"].index_fill_(0, torch.where(noop, cap, parents), False)
    j = torch.cumsum(pvalid.long(), 0) - 1
    rows_f = torch.where(pvalid[:, None],
                         s["fill"] + j[:, None] * n_ch + p.ar_ch[None, :],
                         cap).reshape(-1)
    child = (s["coords"][parents][:, None, :] * 2
             + p.offsets[None]).reshape(-1, d)
    clevel = plevel + 1
    child_level = clevel.repeat_interleave(n_ch)
    s["coords"][rows_f] = child
    s["level"][rows_f] = child_level
    slot = pvalid.repeat_interleave(n_ch)

    # the flags w.r.t. this geometry only (reference s_cube.py:850) on one
    # set of nodes; an empty slot is tested on the root cell
    nodes = _corner_nodes_f32(
        torch.where(slot[:, None], child, 0).to(torch.float32),
        torch.where(slot, child_level, 0).to(torch.float32), p.lo, p.width,
        p.offsets_f)
    inv = check_cells(nodes, False)
    surf = check_cells(nodes, True)
    galive = slot & ~inv
    s["alive"][rows_f] = galive
    nxt = galive & surf
    n_fr2 = nxt.sum()
    fr2 = torch.sort(torch.where(nxt, rows_f, cap)).values[:k_geo]
    over = n_fr2 > k_geo

    adv = (~noop).long()
    # a no-op level writes its parents at the sentinel index
    s["psel"][_at(torch.where(noop, p.levels, s["it"]))] = parents.reshape(
        1, -1)
    s["fill"].copy_(s["fill"] + pvalid.sum() * n_ch)
    s["gcur"].copy_(s["gcur"] + adv)
    s["it"].copy_(s["it"] + adv)
    s["fr"].copy_(torch.where(noop, fr, fr2))
    s["n_fr"].copy_(torch.where(noop, s["n_fr"], n_fr2))
    s["fr_ok"].copy_(s["fr_ok"] & ~over)
    s["why"].copy_(s["why"] | torch.where(
        active, why | torch.where(over, WHY_OVER, 0), 0))
    s["flag"].copy_(s["flag"] | (active & (guard | over)))
    s["maxlev"].copy_(torch.maximum(s["maxlev"],
                                    torch.where(pvalid, clevel, 0).max()))
