"""Exact k nearest neighbours in plain PyTorch, float64.

The points are binned on a uniform grid of about ``occupancy`` points a
bin.  A query gathers the points of the (2r+1)^d bins around its own and
keeps the ``k + 1`` nearest; the answer is exact once the farthest of them
is no farther than the nearest point the gather could have missed, the
distance to the first bin layer outside the searched block.  Rows that are
not proven exact are searched again at r = 2 and 3, then against every
point.  Distances are ``Σ (q - p)²`` in float64; equal distances keep the
lower point index.
"""
import math

import torch


class ExactKNN:
    """``ExactKNN(points [N, d], values [N])`` on the points' device."""

    def __init__(self, points: torch.Tensor, values: torch.Tensor = None,
                 occupancy: float = 16.0):
        pts = points.to(torch.float64)
        self.device = pts.device
        self.n, self.d = pts.shape
        self.points = pts
        self.values = None if values is None else values.to(torch.float64)
        lo, hi = pts.min(0).values, pts.max(0).values
        extent = torch.clamp_min(hi - lo, 1e-12)
        volume = float(torch.prod(extent))
        side = (volume * occupancy / self.n) ** (1.0 / self.d)
        self.side = side
        self.lo = lo
        self.dims = torch.clamp_min(torch.ceil(extent / side), 1).long()
        self.dims_list = [int(x) for x in self.dims]
        bins = self._bin_of(pts)
        flat = self._flat(bins)
        order = torch.argsort(flat, stable=True)
        self.sorted_idx = order
        self.sorted_pts = pts[order]
        n_bins = math.prod(self.dims_list)
        self.counts = torch.bincount(flat, minlength=n_bins)
        self.starts = torch.cumsum(self.counts, 0) - self.counts
        self.max_count = int(self.counts.max())

    def _bin_of(self, x: torch.Tensor) -> torch.Tensor:
        b = torch.floor((x - self.lo) / self.side).long()
        return torch.minimum(torch.clamp_min(b, 0), self.dims - 1)

    def _flat(self, bins: torch.Tensor) -> torch.Tensor:
        flat = bins[:, 0]
        for a in range(1, self.d):
            flat = flat * self.dims_list[a] + bins[:, a]
        return flat

    def _offsets(self, r: int) -> torch.Tensor:
        rng = torch.arange(-r, r + 1, device=self.device)
        grids = torch.meshgrid(*([rng] * self.d), indexing="ij")
        return torch.stack([g.reshape(-1) for g in grids], dim=1)

    def _block(self, q: torch.Tensor, k: int, r: int):
        """``(d2 [Q, k], idx [Q, k], exact [Q])`` over the (2r+1)^d bins
        around each query's own."""
        home = self._bin_of(q)
        nb = home[:, None, :] + self._offsets(r)[None]          # [Q, R, d]
        inside = ((nb >= 0) & (nb < self.dims)).all(-1)         # [Q, R]
        nb = torch.minimum(torch.clamp_min(nb, 0), self.dims - 1)
        flat = nb[..., 0]
        for a in range(1, self.d):
            flat = flat * self.dims_list[a] + nb[..., a]
        start = self.starts[flat]
        count = torch.where(inside, self.counts[flat], 0)
        m = torch.arange(self.max_count, device=self.device)
        slot = start[..., None] + m                              # [Q, R, C]
        live = m < count[..., None]
        slot = torch.where(live, slot, 0).reshape(q.shape[0], -1)
        live = live.reshape(q.shape[0], -1)
        cand = self.sorted_pts[slot]                             # [Q, W, d]
        d2 = ((q[:, None, :] - cand) ** 2).sum(-1)
        d2 = torch.where(live, d2, math.inf)
        idx = torch.where(live, self.sorted_idx[slot], self.n)
        d2, idx = _smallest(d2, idx, k)
        # the nearest point the block could have missed: past its faces,
        # on the sides where bins remain
        lo_face = self.lo + (home - r) * self.side
        hi_face = self.lo + (home + r + 1) * self.side
        gap_lo = torch.where(home - r > 0, q - lo_face, math.inf)
        gap_hi = torch.where(home + r + 1 < self.dims, hi_face - q, math.inf)
        reach = torch.minimum(gap_lo, gap_hi).min(dim=1).values
        exact = d2[:, -1] <= torch.clamp_min(reach, 0.0) ** 2
        return d2, idx, exact

    def _scan(self, q: torch.Tensor, k: int, block: int = 1 << 24):
        """Every point against every query, in tiles."""
        best_d, best_i = None, None
        step = max(1, block // max(q.shape[0], 1))
        for lo in range(0, self.n, step):
            p = self.points[lo:lo + step]
            d2 = ((q[:, None, :] - p[None]) ** 2).sum(-1)
            idx = torch.arange(lo, lo + p.shape[0], device=self.device)
            idx = idx.expand(q.shape[0], -1)
            if best_d is not None:
                d2 = torch.cat([best_d, d2], 1)
                idx = torch.cat([best_i, idx], 1)
            best_d, best_i = _smallest(d2, idx, k)
        return best_d, best_i

    def query(self, q: torch.Tensor, k: int, budget: int = 1 << 25):
        """The ``k`` nearest points of each query: ``(d2 [Q, k] f64,
        idx [Q, k] int64)``, ascending by ``(d2, idx)``."""
        q = q.to(torch.float64)
        k = min(k, self.n)
        out_d = torch.empty((q.shape[0], k), dtype=torch.float64,
                            device=self.device)
        out_i = torch.empty((q.shape[0], k), dtype=torch.int64,
                            device=self.device)
        todo = torch.arange(q.shape[0], device=self.device)
        for r in (1, 2, 3):
            if todo.numel() == 0:
                break
            # about ``budget`` candidates a pass
            step = max(64, budget // ((2 * r + 1) ** self.d * self.max_count))
            left = []
            for lo in range(0, todo.numel(), step):
                rows = todo[lo:lo + step]
                d2, idx, exact = self._block(q[rows], k, r)
                out_d[rows], out_i[rows] = d2, idx
                left.append(rows[~exact])
            todo = torch.cat(left)
        for lo in range(0, todo.numel(), 1024):
            rows = todo[lo:lo + 1024]
            out_d[rows], out_i[rows] = self._scan(q[rows], k)
        return out_d, out_i


def idw(d2: torch.Tensor, vals: torch.Tensor, dtype=torch.float64):
    """``Σ w v / Σ w`` over the last axis with ``w = 1 / max(√d2, 1e-12)``,
    every operation in ``dtype``."""
    dist = torch.clamp_min(torch.sqrt(d2.to(dtype)), 1e-12)
    w = 1.0 / dist
    return (w * vals.to(dtype)).sum(-1) / w.sum(-1)


def _smallest(d2: torch.Tensor, idx: torch.Tensor, k: int):
    """The ``k`` smallest of each row by ``(d2, idx)``, ascending."""
    k = min(k, d2.shape[1])
    # four more than asked, so that a tie at the k-th place is settled by
    # the point index, then the (d2, idx) order by two stable sorts
    vals, pos = torch.topk(d2, min(k + 4, d2.shape[1]), dim=1,
                           largest=False)
    ids = torch.gather(idx, 1, pos)
    ids, o1 = torch.sort(ids, dim=1, stable=True)
    vals, o2 = torch.sort(torch.gather(vals, 1, o1), dim=1, stable=True)
    return vals[:, :k], torch.gather(ids, 1, o2)[:, :k]
