"""
COSMO 2-metre-temperature station operator (PyTorch port of
:mod:`tpu_assim.obs_ops.terrsysmp`): map a COSMO analysis state onto T2m
station observations by (1) nearest-neighbor station matching on
Earth-radius cartesian coordinates (cKDTree), (2) a model-derived lapse
rate between two model levels, and (3) COSMO's height correction
``T2m_station = T2m_model + lapse * (h_station - h_model)``.

Instead of the reference's pandas station DataFrame with German DWD column
names (cos_t2m.py:116-118 reads 'Breite'/'Länge'/'Stations-höhe'), stations
are passed as plain (lat, lon, alt) arrays; instead of MultiIndex ``.sel``
lookups the operator precomputes flat gather indices into the stacked
``(rlat, rlon, vgrid)`` grid, so ``torch_operator`` is a few gathers on the
state's device. The k-d tree lives on the host and runs once, at
construction; the gather indices and height differences become tensors on
a state's device the first time the operator meets that device and dtype,
and are reused after (a per-call host copy would make the class call
host-bound).
"""

from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from tpu_assim_torch.obs_ops.base_ops import BaseOperator

__all__ = ["CosmoT2mOperator", "EARTH_RADIUS"]

EARTH_RADIUS = 6371000.0  # (reference: cos_t2m.py:43)


def _get_cartesian(lat: np.ndarray, lon: np.ndarray, alt: np.ndarray
                   ) -> np.ndarray:
    """lat/lon (deg) + altitude (m) -> cartesian x, y, z
    (reference: cos_t2m.py:106-114 — altitude enters only the z component)."""
    lat_rad = np.deg2rad(lat)
    lon_rad = np.deg2rad(lon)
    x = EARTH_RADIUS * np.cos(lat_rad) * np.cos(lon_rad)
    y = EARTH_RADIUS * np.cos(lat_rad) * np.sin(lon_rad)
    z = EARTH_RADIUS * np.sin(lat_rad) + alt
    return np.stack([x, y, z], axis=-1)


class CosmoT2mOperator(BaseOperator):
    """T2m station operator over a stacked (rlat, rlon, vgrid) COSMO state.

    Parameters
    ----------
    station_lat / station_lon / station_alt : [n_station] arrays (deg, deg, m).
    cosmo_lat / cosmo_lon : [rlat, rlon] grid coordinates (deg).
    cosmo_hsurf : [rlat, rlon] surface height (m) — the reference reads HSURF
        from the COSMO constant file (cos_t2m.py:100-104).
    vgrid : [n_vgrid] merged vertical coordinate of the state (from
        :func:`~tpu_assim_torch.models.terrsysmp.preprocess_cosmo`).
    var_names : state variable order; must contain 'T' and 'T_2M'.
    lev_inds : two vgrid indices used for the lapse rate
        (reference default [40, 35], cos_t2m.py:79).
    t2m_level : vgrid value where T_2M lives (0.0 = the no_vgrid slot,
        matching the reference's ``height_lev=0`` in cos_t2m.py:205).
    """

    def __init__(
        self,
        station_lat: np.ndarray,
        station_lon: np.ndarray,
        station_alt: np.ndarray,
        cosmo_lat: np.ndarray,
        cosmo_lon: np.ndarray,
        cosmo_hsurf: np.ndarray,
        vgrid: np.ndarray,
        var_names: Sequence[str],
        lev_inds: Tuple[int, int] = (40, 35),
        t2m_level: float = 0.0,
    ):
        super().__init__(len_grid=int(np.size(cosmo_hsurf)))
        from scipy.spatial import cKDTree

        station_alt = np.asarray(station_alt, dtype=np.float64)
        vgrid = np.asarray(vgrid, dtype=np.float64)
        self.vgrid = vgrid
        self.var_names = tuple(str(v) for v in var_names)
        self.lev_inds = tuple(lev_inds)
        hsurf_flat = np.asarray(cosmo_hsurf, dtype=np.float64).reshape(-1)

        # nearest COSMO column per station, on cartesian coords
        # (reference: cos_t2m.py:116-131, 146-153)
        cosmo_xyz = _get_cartesian(
            np.asarray(cosmo_lat, dtype=np.float64).reshape(-1),
            np.asarray(cosmo_lon, dtype=np.float64).reshape(-1),
            hsurf_flat,
        )
        station_xyz = _get_cartesian(
            np.asarray(station_lat, dtype=np.float64),
            np.asarray(station_lon, dtype=np.float64),
            station_alt,
        )
        tree = cKDTree(cosmo_xyz)
        _, self.locs = tree.query(station_xyz, k=1)  # flat horizontal index

        # height correction (reference: cos_t2m.py:133-144)
        self.height_diff = station_alt - hsurf_flat[self.locs]

        n_vgrid = len(vgrid)
        t2m_ind = int(np.argmin(np.abs(vgrid - t2m_level)))
        # flat gathers into the stacked (rlat, rlon, vgrid) grid (C-order)
        self._t2m_gather = self.locs * n_vgrid + t2m_ind
        self._lev0_gather = self.locs * n_vgrid + self.lev_inds[0]
        self._lev1_gather = self.locs * n_vgrid + self.lev_inds[1]
        self._lapse_h_diff = vgrid[self.lev_inds[1]] - vgrid[self.lev_inds[0]]
        self._i_t = self.var_names.index("T")
        self._i_t2m = self.var_names.index("T_2M")
        self._on_device = {}

    def __str__(self) -> str:
        return "COSMO 2-metre-temperature observation operator"

    def _tensors(self, device, dtype) -> dict:
        """The gather indices and height differences as tensors on
        ``device`` (the differences in ``dtype``), made once for each."""
        key = (torch.device(device), dtype)
        if key not in self._on_device:
            as_index = (lambda a: torch.as_tensor(np.asarray(a, np.int64),
                                                  device=device))
            self._on_device[key] = {
                "t2m": as_index(self._t2m_gather),
                "lev0": as_index(self._lev0_gather),
                "lev1": as_index(self._lev1_gather),
                "h_diff": torch.as_tensor(self.height_diff, dtype=dtype,
                                          device=device),
            }
        return self._on_device[key]

    def get_lapse_rate(self, state_data: torch.Tensor) -> torch.Tensor:
        """Model lapse rate between the two configured levels at each
        station's column (reference: cos_t2m.py:179-188).

        state_data [var, time, ens, grid] -> [time, ens, n_station]."""
        on = self._tensors(state_data.device, state_data.dtype)
        temp = state_data[self._i_t]
        temp_1 = torch.index_select(temp, -1, on["lev1"])
        temp_0 = torch.index_select(temp, -1, on["lev0"])
        return (temp_1 - temp_0) / self._lapse_h_diff

    def obs_op(self, in_state, *args, **kwargs) -> torch.Tensor:
        """T2m equivalents [time, ens, n_station]
        (reference: cos_t2m.py:196-215)."""
        return self.torch_operator()(in_state.data)

    def torch_operator(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """The map [var, time, ens, grid] -> [time, ens, n_station] on
        tensors."""
        i_t2m = self._i_t2m

        def op(state_data: torch.Tensor) -> torch.Tensor:
            on = self._tensors(state_data.device, state_data.dtype)
            uncorr = torch.index_select(state_data[i_t2m], -1, on["t2m"])
            lapse = self.get_lapse_rate(state_data)
            return uncorr + on["h_diff"] * lapse

        return op
