"""
The Gaspari-Cohn taper C_0(z, 1/2, c) (Gaspari and Cohn 1999, QJRMS 125:
723, eq. 4.10), ``z = |dx| / c``, zero from ``z = 2``; weights at or below
``epsilon`` are cut to zero.
"""

import torch


def gaspari_cohn(z: torch.Tensor, epsilon: float) -> torch.Tensor:
    inner = (-0.25 * z**5 + 0.5 * z**4 + 0.625 * z**3
             - 5.0 / 3.0 * z**2 + 1.0)
    zo = torch.clamp(z, min=1.0)
    outer = (zo**5 / 12.0 - 0.5 * zo**4 + 0.625 * zo**3
             + 5.0 / 3.0 * zo**2 - 5.0 * zo + 4.0 - 2.0 / (3.0 * zo))
    w = torch.where(z < 1.0, inner, torch.where(z < 2.0, outer, 0.0))
    return torch.where(w > epsilon, w, 0.0)
