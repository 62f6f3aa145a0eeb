"""
Each grid column's observations under a 2-D product taper, for
observations at any 2-D coordinates: the weight of an observation is
``GC(|dx| / rx) GC(|dy| / ry)`` (``taper.gaspari_cohn``), cut to zero at or
below ``epsilon``, so that only observations with ``|dx| < 2 rx`` and ``|dy|
< 2 ry`` can carry weight. A block of columns gets the observations of
nonzero weight of each, compacted to the block's widest column with slots
that carry no weight.

The candidates of a column are the observations of its y-band ``|dy| < 2
ry``, found by a binary search over the observations sorted by y; the
x-cut and the weights are then computed for each candidate.
"""

import torch

from port_bench.reference.taper import gaspari_cohn


class Window2D:
    """The windows of ``grid_xy [g, 2]`` over ``obs_xy [o, 2]`` (x in
    column 0), in the dtype of ``obs_xy``; ``chunk`` columns at a time."""

    def __init__(self, obs_xy, grid_xy, radius, epsilon: float,
                 chunk: int = 8192):
        self.rx, self.ry = (float(r) for r in radius)
        self.epsilon = float(epsilon)
        self.grid = grid_xy
        self.order = torch.argsort(obs_xy[:, 1], stable=True)
        self.ox = obs_xy[self.order, 0].contiguous()
        self.oy = obs_xy[self.order, 1].contiguous()
        self.chunk = chunk

    def _weights(self, cols):
        """``(candidates [c, w], weights [c, w])`` of the columns ``cols``:
        the y-sorted positions of their y-bands' observations and their
        taper weights, zero at or below ``epsilon`` and past a band's
        end."""
        gx, gy = self.grid[cols, 0], self.grid[cols, 1]
        lo = torch.searchsorted(self.oy, gy - 2.0 * self.ry, right=True)
        hi = torch.searchsorted(self.oy, gy + 2.0 * self.ry)
        w = max(int((hi - lo).max()), 1)
        cand = lo[:, None] + torch.arange(w, device=lo.device)
        inside = cand < hi[:, None]
        cand = torch.clamp(cand, max=self.oy.numel() - 1)
        zx = torch.abs(self.ox[cand] - gx[:, None]) / self.rx
        zy = torch.abs(self.oy[cand] - gy[:, None]) / self.ry
        wt = gaspari_cohn(zx, 0.0) * gaspari_cohn(zy, 0.0)
        return cand, torch.where(inside & (wt > self.epsilon), wt, 0.0)

    def counts(self, cols=None) -> torch.Tensor:
        """Each column's count of observations of nonzero weight (every
        column with ``cols`` None)."""
        if cols is None:
            cols = torch.arange(self.grid.shape[0], device=self.grid.device)
        return torch.cat([
            (self._weights(cols[i:i + self.chunk])[1] > 0).sum(1)
            for i in range(0, cols.numel(), self.chunk)])

    def __call__(self, cols):
        """``(idx [c, m], sqrt_w [c, m])`` of the columns ``cols`` (an index
        tensor): their observations of nonzero weight, each column's in
        the order of its y-band, ``m`` the largest count over ``cols``."""
        parts = []
        for i in range(0, cols.numel(), self.chunk):
            cand, wt = self._weights(cols[i:i + self.chunk])
            keep = wt > 0
            first = torch.sort((~keep).to(torch.uint8), dim=1,
                               stable=True).indices
            parts.append((self.order[cand.gather(1, first)],
                          wt.gather(1, first), int(keep.sum(1).max())))
        m = max(max(p[2] for p in parts), 1)

        def fit(x):                  # to m slots; the padding carries none
            x = x[:, :m]
            return torch.nn.functional.pad(x, (0, m - x.shape[1]))

        idx = torch.cat([fit(p[0]) for p in parts])
        wt = torch.cat([fit(p[1]) for p in parts])
        return idx, torch.sqrt(wt)
