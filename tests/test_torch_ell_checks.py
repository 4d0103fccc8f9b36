"""The input checks of the ELL kernels' wrappers (solve/ellpack.py
_check_ell, run before every launch of ell_spmv.cu and ell_spmv_T.cu)
on CPU tensors: each bad input raises ValueError with a message that
names the argument, and a good input passes with (K, ndpn, n).  The
transposed kernel's cases also pass tr_T, its transposed slot map."""

import pytest
import torch

from calibr8_tpu_torch.solve.ellpack import _check_ell

K, NDPN, N, DIM = 3, 3, 5, 2


def good():
    A_T = torch.zeros(K, NDPN, NDPN, N, dtype=torch.float64)
    nbr_T = torch.full((K, N), N, dtype=torch.int32)
    x = torch.zeros(N * NDPN, dtype=torch.float64)
    return A_T, nbr_T, x, DIM


def good_T():
    return (*good(), torch.zeros(K, N, dtype=torch.int32))


def spoil(i, value, make=good):
    args = list(make())
    args[i] = value(args[i])
    return args


CASES = {
    "good": (good, None),
    "A_T not 4D": (lambda: spoil(0, lambda a: a[0]), "A_T"),
    "A_T blocks not square": (lambda: spoil(0, lambda a: a[:, :2]), "A_T"),
    "x shape": (lambda: spoil(2, lambda x: x[:-1]), "x"),
    "nbr_T int64": (lambda: spoil(1, lambda t: t.long()), "nbr_T"),
    "nbr_T shape": (lambda: spoil(1, lambda t: t[:, :-1]), "nbr_T"),
    "dtype mismatch": (lambda: spoil(0, lambda a: a.float()), "A_T"),
    "A_T not contiguous": (lambda: spoil(0, lambda a: a.transpose(1, 2)), "A_T"),
    "x not contiguous": (lambda: spoil(2, lambda x: torch.zeros(2 * x.numel(),
                                                                dtype=x.dtype)[::2]), "x"),
    "ndpn does not fit dim": (lambda: spoil(3, lambda d: d + 2), "dim"),
    "good with tr_T": (good_T, None),
    "tr_T int64": (lambda: spoil(4, lambda t: t.long(), good_T), "tr_T"),
    "tr_T shape": (lambda: spoil(4, lambda t: t[:-1], good_T), "tr_T"),
    "tr_T not contiguous": (lambda: spoil(4, lambda t: torch.zeros(N, K, dtype=torch.int32).T,
                                          good_T), "tr_T"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_check_ell(case):
    make, names = CASES[case]
    args = make()
    if names is None:
        assert _check_ell(*args) == (K, NDPN, N)
        return
    with pytest.raises(ValueError, match=names):
        _check_ell(*args)
