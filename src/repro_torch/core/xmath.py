"""float32 elementary functions as the reference's compiler evaluates them
on the CPU: ``exp``, ``log``, ``log1p`` and ``erf_inv`` by the same
polynomials, with the same multiply-adds contracted to one rounding.

Where a reference draw or table goes through one of these (the normal
draws of ``prng.normal``, the sinusoidal position tables), evaluating it
here gives the reference's numbers bit for bit, or within an ulp or two,
where the library functions of ``torch`` (correctly rounded, or nearly)
differ from them by an ulp in a few percent of the elements: enough, at
position 1500, to move a sinusoidal angle by 2e-4.
"""

from __future__ import annotations

import torch

_F32, _F64 = torch.float32, torch.float64
# erf_inv: Giles' single-precision polynomials in w = -log1p(-x^2), for
# w < 5 (in w - 2.5) and above (in sqrt(w) - 3)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
# log1p(y) for |y| < sqrt(2) - 1: y - y^2/2 + y^3 P(y)/Q(y) (Cephes)
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
            6.5787325942061044846969e0, 2.9911919328553073277375e1,
            6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.0, 1.5062909083469192198422e1, 8.3047565967967209469434e1,
            2.2176239823732856465394e2, 3.0909872225312059774938e2,
            2.1642788614495947685003e2, 6.0118660497603843919306e1)
# log(z) for larger |y|: Cephes logf on z's mantissa in [sqrt(1/2), sqrt(2))
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` of float32 numbers (Python constants rounded to
    float32 first) rounded once, as the reference's compiler contracts it
    (float64 holds the product of two float32 exactly)."""
    a, b, c = (torch.as_tensor(t, dtype=_F32).to(_F64) for t in (a, b, c))
    return (a * b + c).to(_F32)


def _poly(x: torch.Tensor, coeffs) -> torch.Tensor:
    p = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        p = fma(p, x, c)
    return p


def log(z: torch.Tensor) -> torch.Tensor:
    m, e = torch.frexp(z)                     # z = m * 2^e, m in [0.5, 1)
    e = e.to(_F32)
    low = m < 0.707106781186547524
    e = e - low.to(_F32)
    m = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    m2 = m * m
    m3 = m2 * m
    y0 = fma(fma(m, _LOG_P[0], _LOG_P[1]), m, _LOG_P[2])
    y1 = fma(fma(m, _LOG_P[3], _LOG_P[4]), m, _LOG_P[5])
    y2 = fma(fma(m, _LOG_P[6], _LOG_P[7]), m, _LOG_P[8])
    y = fma(fma(y0, m3, y1), m3, y2)
    y = fma(y, m3, e * -2.12194440e-4)
    return ((m - 0.5 * m2) + y) + e * 0.693359375


def log1p(y: torch.Tensor) -> torch.Tensor:
    y2 = y * y
    small = (y * y2) * (_poly(y, _LOG1P_P) / _poly(y, _LOG1P_Q))
    small = y + fma(-0.5, y2, small)
    return torch.where(y.abs() < 0.41421356237309504880, small,
                       log(y + 1.0))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 ``erf_inv`` as the reference computes it; ±1 → ±inf."""
    w = -log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = None
    for lo, hi in zip(_ERFINV_LT5, _ERFINV_GE5):
        c = torch.where(lt, torch.tensor(lo, dtype=_F32, device=x.device),
                        torch.tensor(hi, dtype=_F32, device=x.device))
        p = c if p is None else fma(p, w, c)
    return torch.where(x.abs() == 1.0, x * torch.finfo(_F32).max, p * x)


_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
          4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def exp(x: torch.Tensor) -> torch.Tensor:
    """float32 ``exp`` (Cephes expf: ``2^n · e^r`` with ``r`` reduced by
    ``ln 2`` in two parts)."""
    x = x.clamp(-87.8, 88.8)
    n = torch.floor(fma(x, 1.44269504088896341, 0.5))
    r = fma(n, 2.12194440e-4, fma(n, -0.693359375, x))
    y = fma(_poly(r, _EXP_P), r * r, r) + 1.0
    return torch.ldexp(y, n.to(torch.int32)).to(_F32)
